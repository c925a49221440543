"""fields layer of the PyTorch port."""
