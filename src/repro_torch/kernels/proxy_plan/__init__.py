"""Fused proxy plan kernel; see ``ops``."""
from repro_torch.kernels.proxy_plan.ops import (  # noqa: F401
    STATS_W, proxy_plan, proxy_plan_ref, span_matrix)
