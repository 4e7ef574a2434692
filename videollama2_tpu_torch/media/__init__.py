"""media of the PyTorch port: the frame wire format."""
