"""Parallel layer of the PyTorch port: the process group, the mesh and the placements."""
