"""Window gather kernels, cross-frame and single-frame; see ``ops``."""
from repro_torch.kernels.window_gather.ops import (  # noqa: F401
    window_gather, window_gather_batch, window_gather_batch_ref,
    window_gather_ref)
