"""The serving plane of the PyTorch port: controller, model worker, dynamic batcher, OpenAI-compatible and web servers."""
