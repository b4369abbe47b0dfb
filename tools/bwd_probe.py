"""A short card probe of the flash-attention backward kernels
(``csrc/flash_attention_bwd.cu``): the first call to make on the card
after changing them, before the whole ``chip_smoke.py``.

It builds the source (nvcc for sm_90a, as ``chip_smoke.py`` does) and
prints each kernel's registers, spills and ptxas warnings from the build
log; holds the kernels to the plain backward over
``flash_check.BWD_CASES`` (both dtypes; bf16 twice, bits equal) and at
the train step's call (B 1, S 4096, 14 of 2 heads of 64, causal, bf16);
reads the planted faults at the S 500 case; and prints per-call ms by
CUDA events (20 calls, warm L2) and device ms by kernel from the
profiler (10 calls) at the train call and at S 500 in both dtypes.  It
exits 1 if a check failed.  It needs a CUDA card and imports torch
only:

    PYTHONPATH=src python3 tools/bwd_probe.py
"""
from __future__ import annotations

import json
import sys
import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check as fc
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)


def event_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(fn, reps: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in fc.BWD_KERNEL_NAMES:
            if name in ev.key and ev.count:
                total = getattr(ev, "device_time_total", None)
                if total is None:
                    total = getattr(ev, "cuda_time_total", 0.0)
                out[name] = total / reps / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build(["flash_attention_bwd", "flash_attention"])
    print(f"build {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log("flash_attention_bwd").splitlines():
        if any(w in line for w in ("Compiling", "Used", "spill",
                                   "warning", "C75")):
            print(line)
    failed = []
    for i, case in enumerate(fc.BWD_CASES):
        try:
            print("case", fc.case_id(case),
                  fc.check_bwd_case(case, "cuda", 50 + i), flush=True)
        except AssertionError as e:
            failed.append(fc.case_id(case))
            print("FAIL", fc.case_id(case), e, flush=True)
    for case in fc.BWD_CASES:
        if case[0] == "S500 causal":
            print("faults", fc.case_id(case),
                  fc.check_bwd_faults(case, "cuda", 0), flush=True)
    q, k, v, dout = fc.operands(
        [(1, 4096, 14, 64), (1, 4096, 2, 64), (1, 4096, 2, 64),
         (1, 4096, 14, 64)], torch.bfloat16, "cuda", 90)
    with torch.inference_mode():
        o = flash_attention(q, k, v)
    try:
        print("train call", fc.check_bwd(q, k, v, o.clone(), dout, True, 0,
                                         "train call"))
    except AssertionError as e:
        failed.append("train call")
        print("FAIL train call", e, flush=True)

    def train():
        return flash_attention_bwd(q, k, v, o, dout, causal=True)
    print("train call ms", event_ms(train),
          json.dumps(device_ms_by_kernel(train)), flush=True)
    for case in fc.BWD_CASES:
        if case[0] == "S500 causal":
            args = fc.bwd_case_operands(case, "cuda", 0)

            def s500():
                return flash_attention_bwd(*args, causal=True)
            print("S500", fc.case_id(case), event_ms(s500),
                  json.dumps(device_ms_by_kernel(s500)), flush=True)
    print(f"failed: {failed}" if failed else "all held",
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
