"""Cross-frame window gather kernel; see ``ops``."""
from repro_torch.kernels.window_gather.ops import (  # noqa: F401
    window_gather_batch, window_gather_batch_ref)
