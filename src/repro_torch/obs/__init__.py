"""Run profiling of the PyTorch port."""
