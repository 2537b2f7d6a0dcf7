"""Model zoo of the PyTorch port (dense decoder family so far)."""
