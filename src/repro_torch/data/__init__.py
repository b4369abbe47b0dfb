"""Synthetic data of the PyTorch port: video clips (``video_synth``) and
LM token batches (``tokens``)."""
