"""Mamba2 SSD chunked scan kernel; see ``ops``."""
from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    ssd_scan, ssd_scan_ref, ssd_scan_seq_ref, ssd_step)
