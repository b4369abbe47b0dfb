"""The LM train step of the PyTorch port (``step``)."""
from repro_torch.train.step import TrainStep, build_train_step  # noqa: F401
