"""core of the PyTorch port: its configuration tree."""
