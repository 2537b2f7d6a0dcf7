"""Entry points of the PyTorch port: parameter init, the serving steps, the
serving CLI."""
