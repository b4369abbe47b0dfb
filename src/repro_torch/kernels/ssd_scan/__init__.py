"""Mamba2 SSD chunked scan kernel and its gradient; see ``ops``."""
from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    SSDScanFn, ssd_scan, ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_ref,
    ssd_scan_seq_ref, ssd_step)
