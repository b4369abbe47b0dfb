"""The MultiScope pipeline modules of the PyTorch port.

Import the submodules directly (``repro_torch.core.pipeline``,
``repro_torch.core.executor``, ...); this package imports nothing.
"""
