"""train of the PyTorch port: the stage-1 (projector-only) training path."""
