"""Launchers of the port (``train``: ``python -m
repro_torch.launch.train``)."""
