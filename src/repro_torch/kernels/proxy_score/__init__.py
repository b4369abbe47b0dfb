"""Proxy head (score map) kernel; see ``ops``."""
from repro_torch.kernels.proxy_score.ops import (  # noqa: F401
    FLIP_ULPS, check_scores, proxy_score, proxy_score_ref)
