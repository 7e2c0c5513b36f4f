"""Training layer of the PyTorch port."""
