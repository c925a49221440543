"""opt layer of the PyTorch port."""
