"""media of the PyTorch port: frame sampling, the still-image and container
readers, preprocessing, the frame wire format and the audio front end."""
