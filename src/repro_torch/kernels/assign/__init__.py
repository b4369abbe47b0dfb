"""Batched JV assignment kernel; see ``ops``."""
from repro_torch.kernels.assign.ops import (  # noqa: F401
    assign_batch, assign_batch_ref)
