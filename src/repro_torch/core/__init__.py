"""Low-rank decomposition core of the PyTorch port (serving subset)."""
