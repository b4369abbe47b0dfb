"""Synthetic video data of the PyTorch port."""
