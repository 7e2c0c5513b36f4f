"""decode of the PyTorch port."""
