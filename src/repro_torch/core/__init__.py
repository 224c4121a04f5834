"""Core DMS data structures of the PyTorch port (grid, gradient, sandwich
state)."""
