"""Fused tracker-step kernel; see ``ops``."""
from repro_torch.kernels.track_step.ops import (  # noqa: F401
    LOG1P_TABLE_2D, PARAM_ORDER, pack_params, track_step, track_step_ref)
