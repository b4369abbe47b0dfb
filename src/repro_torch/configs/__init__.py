"""Configuration dataclasses of the PyTorch port."""
