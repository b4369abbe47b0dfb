"""A short card probe of the SSD scan's backward kernels
(``csrc/ssd_scan_bwd.cu``): the first call to make on the card after
changing them, before the whole ``chip_smoke.py``.

It builds the source (nvcc for sm_90a, as ``chip_smoke.py`` does),
prints each kernel's registers, spills and ptxas warnings from the build
log, then runs ``chip_smoke.check_ssd_scan_bwd`` (every case in both
dtypes, the planted faults, both train calls checked and timed against
their bound) and prints its result.  ``ssd_scan`` under autograd is
checked by ``pytest -m cuda -k ssd_scan``.  It exits 1 if a check
failed, 2 without a CUDA card:

    PYTHONPATH=src python3 tools/ssd_bwd_probe.py
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build(["ssd_scan_bwd", "ssd_scan"])
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log("ssd_scan_bwd").splitlines():
        if any(w in line for w in ("Compiling", "Used", "spill", "warning")):
            print(line)
    try:
        print(json.dumps(chip_smoke.check_ssd_scan_bwd()), flush=True)
    except AssertionError as e:
        print("FAILED", e, flush=True)
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
