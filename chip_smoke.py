#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

It builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
per source, started together), holds each kernel against its plain
PyTorch version on the card at the main path's shapes and times both
(``assign`` and ``track_step`` bit for bit over their ``check`` modules'
cases, with the JV's steps counted on the host and ns a step;
``proxy_plan`` within the 8-ulp threshold band and ``window_gather_batch``
bit for bit over theirs, beside two yardsticks: the card's launch floor,
``zero_()`` on a one-element tensor, and a ``copy_`` of each gather's
bytes), then runs the main path —
one 64-frame clip through the streaming ``ClipExecutor`` at the
full-width MultiScope configuration (detector ssd-deep at 960x544, proxy
416x256, recurrent tracker, chunks of 16) with untrained weights drawn
from a seed — three times with the host tracker and twice with TRACK on
the device (``ExecutorOptions(device_tracker=True)`` and
``device_assign=True``), whose tracks must equal the host tracker's.
Then the per-frame engine (``run_clip(engine="frame")``: ``proxy_score``
at batch 1 and the single-frame ``window_gather``) twice, the unfused
proxy path (``ExecutorOptions(fused_plan=False)``), whose plans must be
the fused path's wherever no proxy cell lies in the flip band, both
engines again with a track refiner (refined tracks must contain the
unrefined ones), and the quality readout (MOTA with the host Hungarian
and with every frame in one ``assign`` launch, count accuracy).  It
checks that every kernel of each path was launched and that the output
is right, and profiles four more runs for the device's busy share.
Then the LM serving path (``run_lm``): ``flash_attention`` (bf16 and
f32 on tensor cores, f32 as 3xTF32) and ``decode_attention`` (the keys
split over a cluster of 16 blocks) against their plain versions on
their ``check`` modules' cases (f32 within 1e-5, bf16 one bf16 ulp
apart), their refusals, and timed at the serving shapes beside
``scaled_dot_product_attention``, then ``ServeEngine.generate`` at full
qwen2-0.5b width (24 layers, bf16 activations, weights from the seed) on
4 prompts of 61, 200, 384 and 500 tokens with 32 new tokens each: twice
(the same tokens, 24 ``flash_attention`` and 768 ``decode_attention``
launches each), timed, and once profiled.  The serve checks then hold
the logits, in bf16 and again with f32 activations, to a share of their
RMS: both attention wrappers swapped for their plain versions, each
prompt alone, the first and last decode step against a fresh prefill;
and four planted faults (decode attending kv_len = pos, decode one
position late, decode without rope, a prefill that is not causal) must
each break the check it targets.  Then Mamba2 serving (``run_ssm``):
``ssd_scan`` (bf16 and f32 on tensor cores, f32 as 3xTF32) against its
plain version (f32 within 1e-4 of max |plain|, bf16 within 2 bf16 ulps
of the f32 plain result) at the prefill's call (B 4, S 500, H 32, P 64,
N 128), B 1 at S 61, 512 and 2048, Q 100 and B 2 at S 130, timed, and
its refusals; then ``ServeEngine.generate`` at
full mamba2-370m width (48 layers, bf16 activations, weights from the
seed) on the same 4 prompts: twice (the same tokens, 48 ``ssd_scan``
launches each, all in the prefill), timed, profiled, and the same
serve checks in bf16 and f32 (the scan swapped for its plain version;
only the longest row alone and against a fresh prefill, since shorter
rows absorb the right padding into their state by the reference's
design), with three planted faults (decode without the state's decay,
decode with a zeroed conv tail, a prefill scan that drops the state
between chunks).  Last the fleet (``run_fleet``, after every phase that
reads the profiler, at the video cell's θ): caldot1 test clips 0-2 at 32
frames, round-robin over concurrent streams, each stream's tracks held
to its solo run: through one ``BatchBroker`` at 1, 4 and 16 streams on one
chunk clock (``on_clock``; fewer detector dispatches than the solo runs
at 4 and 16), the detector's batch drift read at every bucket the broker
formed (bit for bit where it is 0.0 everywhere and at 1 stream; else
every detector score within twice the drift of its solo value, a window
whose kept cells differ counted as a decision flip, and the tracks of
each stream without one held to the same decisions and boxes within
1e-4 / 2e-5), through one ``TrackBroker`` with ``device_assign`` at 4 and 16
streams (bit for bit; ``track_step`` launches equal the broker's
dispatches), and ``run_clips`` over the three clips on fresh frames with
the shared ``DecodePool`` at ``decode_workers`` 1 and 3 (bit for bit).
Every phase runs uncaught: any failure exits non-zero before the result
line.

The last three lines of standard output are the kernels' JSON record,
the card's name and power limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port (fails here, before any result, outside a checkout)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core.detector import (Detector, batch_drift,  # noqa: E402
                                       next_bucket)
from repro_torch.core.proxy import ProxyModel  # noqa: E402
from repro_torch.core.executor import (BatchBroker,  # noqa: E402
                                       ClipExecutor, ExecutorOptions,
                                       TrackBroker, run_clips,
                                       stage_proxy)
from repro_torch.core.metrics import clip_count_accuracy, mota  # noqa: E402
from repro_torch.core.refine import TrackRefiner  # noqa: E402
from repro_torch.core import tracker as trk_mod  # noqa: E402
from repro_torch.core.hungarian import (  # noqa: E402
    BIG, DEVICE_JV_GAP, optimality_gap)
from repro_torch.core.tracker import (RecurrentTracker,  # noqa: E402
                                      init_tracker)
from repro_torch.core.windows import plan_chunk, plan_from_mapped  # noqa: E402
from repro_torch.data.video_synth import make_clip  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.assign import (assign_batch,  # noqa: E402
                                        assign_batch_ref)
from repro_torch.kernels.assign import check as assign_check  # noqa: E402
from repro_torch.kernels.track_step import (  # noqa: E402
    LOG1P_TABLE_2D, track_step, track_step_ref)
from repro_torch.kernels.track_step import (  # noqa: E402
    check as track_check)
from repro_torch.kernels.proxy_plan import (  # noqa: E402
    plan_to_host, proxy_plan, proxy_plan_ref)
from repro_torch.kernels.proxy_plan.ops import (FLIP_ULPS,  # noqa: E402
                                                _spans_on, check_plan)
from repro_torch.kernels.proxy_score import (  # noqa: E402
    check_scores, proxy_score, proxy_score_ref)
from repro_torch.kernels.proxy_plan import check as plan_check  # noqa: E402
from repro_torch.kernels.window_gather import (  # noqa: E402
    window_gather, window_gather_batch, window_gather_batch_ref,
    window_gather_ref)
from repro_torch.kernels.window_gather import (  # noqa: E402
    check as gather_check)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    check as decode_check)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check as flash_check)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref  # noqa: E402
from repro_torch.obs import REGISTRY, interp_quantile  # noqa: E402
from repro_torch.query import (PackedTracks, Query,  # noqa: E402
                               QueryService, TimeRange, TrackStore,
                               compile_query)
from repro_torch.query.ref import reference_query  # noqa: E402
from repro_torch.stream import SegmentIngestor, StandingQuery  # noqa: E402
from repro_torch.kernels.ssd_scan import check as ssd_check  # noqa: E402
from repro_torch.models import attention as lm_attention  # noqa: E402
from repro_torch.models import ssm as lm_ssm  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

DEVICE = "cuda"
CFG = MULTISCOPE_PIPELINE       # full width
SEED = 0
N_FRAMES = 64
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
L2_FLUSH_BYTES = 128 << 20      # more than the H100's 50 MB L2
SIZES_CELLS = [(60, 34), (15, 9), (30, 17)]   # full frame + two windows
PROXY_QUANTILE = 0.85
DET_QUANTILE = 0.995
CONV_ATOL = 1e-4                # card vs CPU conv nets (TF32 off)
# the fleet phase: caldot1 test clips 0-2 at 32 frames (two chunks) a
# stream, round-robin over the streams; tracks of a brokered stream
# against its solo run: bit for bit, or (where the detector moved with
# the batch and no decision flipped) the same frames and ids and boxes
# within the slice's tolerances
FLEET_FRAMES = 32
FLEET_CLIPS = 3
FLEET_STREAMS = (1, 4, 16)
FLEET_TRACK_STREAMS = (4, 16)
FLEET_POOLS = (1, 3)
FLEET_JOIN_S = 300.0
# profiler traces that held none of their kernels: traced again after a
# pause, this many times in all
TRACE_TRIES = 8
TRACE_PAUSE_S = 1.0
# how far a brokered stream's host-tracker costs may move from its solo
# run's before their first differing assignment: the detector's drift
# carried through the GRU (1.2e-7 read on the card); a fault moves
# them by tenths
FLEET_COST_ATOL = 1e-5
# the live phase: caldot1 test clips 0-2 at 64 frames, in segments of
# one chunk (aligned: every chunk as in a batch ingest, so bit for bit)
# and of LIVE_ODD_SEG frames (other batches: held as the fleet holds a
# brokered stream)
LIVE_FRAMES = 64
LIVE_CLIPS = 3
LIVE_SEG = 16
LIVE_ODD_SEG = 5
LIVE_JOIN_S = 300.0
BOX_RTOL, BOX_ATOL = 1e-4, 2e-5
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
# f32 on tensor cores as 3xTF32: three tf32 products (495 TFLOP/s dense)
TF32X3_OPS_PER_S = 495e12 / 3
LM_CFG = get_config("qwen2-0.5b")   # full width
LM_PROMPT_LENS = (61, 200, 384, 500)
LM_MAX_LEN = 1024
LM_NEW_TOKENS = 32
# logits of two runs that differ in rounding only (the attention kernels
# against their plain versions, batch 1 against 4, a decode step against
# a fresh prefill), max |d| held to this share of the logits' RMS, by
# activation dtype; set between the rounding-only gaps and the planted
# faults' gaps that the serve checks print (PERF.md)
LM_LOGIT_TOL = {"bfloat16": 0.2, "float32": 1e-3}
# the device kernels each attention wrapper may launch, by name (both
# flash attention kernels run on tensor cores, f32 as 3xTF32)
FLASH_KERNEL_NAMES = flash_check.KERNEL_NAMES
DECODE_KERNEL_NAMES = ("decode_attention_kernel",)
# the JV kernels of assign_batch (by the matrix size)
ASSIGN_KERNEL_NAMES = ("assign_kernel", "assign_large_kernel")
SSM_CFG = get_config("mamba2-370m")  # full width
# the Mamba2 cell's serve checks, by the same rule: its 48 layers carry
# bf16 rounding further (rounding-only gaps up to 0.23 of the RMS, the
# smallest planted fault 0.79, PERF.md)
SSM_LOGIT_TOL = {"bfloat16": 0.4, "float32": 1e-3}


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Per-call time of ``fn`` between CUDA events over ``reps`` calls
    (host enqueue included, as the main path pays it)."""
    for _ in range(warmup):
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


def profiled_cold(fn, reps: int):
    """A profiler's record of ``reps`` calls of ``fn`` (after one
    untimed call), the L2 cache overwritten before each so that the
    inputs come from device memory, as the bound assumes."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return prof


def device_us(ev) -> float:
    """An averaged profiler event's total device time in us (the name
    of the field depends on the torch version)."""
    total = getattr(ev, "device_time_total", None)
    return getattr(ev, "cuda_time_total", 0.0) if total is None else total


def device_ms_by_kernel(fn, kernel_names, reps: int = 50):
    """Device time per call of ``fn`` of each CUDA kernel whose name
    contains one of ``kernel_names``, from the profiler's trace, with the
    L2 cache overwritten before each call so that the inputs come from
    device memory, as the bound assumes: the mean time of the launches
    the trace recorded, times the launches one call makes (the recorded
    launches over ``reps``, rounded).  The trace may drop launches, so
    its total over ``reps`` would read short.  {name: ms, or None if the
    profiler recorded no device time for it}."""
    prof = profiled_cold(fn, reps)
    out = {name: None for name in kernel_names}
    for ev in prof.key_averages():
        for name in kernel_names:
            if name in ev.key and ev.count and out[name] is None:
                total = device_us(ev)
                if total:
                    calls = max(1, round(ev.count / reps))
                    out[name] = total / ev.count * calls / 1e3  # us -> ms
    return out


def device_ms(fn, kernel_names, reps: int = 50):
    """Device time per call of ``fn`` of the CUDA kernels whose names
    contain ``kernel_names`` (a name or a tuple of names, every kernel the
    wrapper may launch), summed over those the trace holds
    (``device_ms_by_kernel``); None if it holds none."""
    if isinstance(kernel_names, str):
        kernel_names = (kernel_names,)
    found = [t for t in device_ms_by_kernel(fn, kernel_names, reps).values()
             if t is not None]
    return sum(found) if found else None


def grid_blocks(trace: dict, kernel_names) -> list:
    """Thread blocks (grid x * y * z) of each launch, in a profiler's
    Chrome trace, of a kernel whose name contains one of
    ``kernel_names``."""
    return [math.prod(ev["args"]["grid"])
            for ev in trace.get("traceEvents", [])
            if ev.get("cat") == "kernel" and "grid" in ev.get("args", {})
            and any(n in ev.get("name", "") for n in kernel_names)]


def launch_blocks(fn, kernel_names, seconds: float = 0.05) -> list:
    """The distinct ``grid_blocks`` of those kernels' launches over
    ``seconds`` of profiled calls of ``fn``, as the card recorded them.
    The trace can miss the launches of its first milliseconds (a
    one-call trace late in a long process held none), so it holds many
    calls.  [] if it holds none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
        torch.cuda.synchronize()
    path = _build.BUILD_DIR / "launch_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    path.unlink()
    return sorted(set(grid_blocks(trace, kernel_names)))


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def build_kernels() -> None:
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {len(secs)} kernels in {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc; per source {json.dumps(secs)})")
    for name in secs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")


def make_bank(dev: str):
    cfg = CFG
    pres = cfg.proxy.resolutions[0]                       # (416, 256)
    return pl.ModelBank(
        cfg, {"ssd-deep": Detector("ssd-deep", seed=SEED, device=dev)},
        {pres: ProxyModel(cfg.proxy.cell, cfg.proxy.base_channels, pres,
                          seed=SEED, device=dev)},
        tracker_params=init_tracker(cfg.tracker, seed=SEED, device=dev),
        sizes_cells=list(SIZES_CELLS), ref_grid=SIZES_CELLS[0],
        device=dev)


def set_up(bank, clip):
    """θ for the main path.  The proxy threshold and the detector
    confidence are quantiles of the untrained heads' scores on the first
    chunk; window times are measured, and seeded proportional to window
    area if the measured ones leave no sub-frame window (set-up, not
    the main path)."""
    cfg = bank.cfg
    det_res = cfg.detector.resolutions[0]                 # (960, 544)
    pres = cfg.proxy.resolutions[0]
    proxy = bank.proxies[pres]
    frames = np.stack([pl.render_frame(clip, f, *det_res)[0]
                       for f in range(16)])
    pframes = pl.downsample_chunk(frames, pres)
    feat = proxy.features(pframes)
    enc = proxy.encoder
    with torch.inference_mode():
        sig = torch.sigmoid(feat @ enc.head_w + enc.head_b)
        thr = float(torch.quantile(sig.flatten(), PROXY_QUANTILE))
        scores = torch.sigmoid(bank.detectors["ssd-deep"].net(
            torch.from_numpy(frames).to(DEVICE))[..., 0])
        conf = float(torch.quantile(scores.flatten(), DET_QUANTILE))
    params = pl.PipelineParams("ssd-deep", det_res, conf, gap=1,
                               proxy_res=pres, proxy_threshold=thr,
                               tracker="recurrent", refine=False,
                               chunk_size=16)
    sizeset = pl.make_sizeset(bank, params)
    log(f"set-up: proxy threshold {thr!r} (q{PROXY_QUANTILE}), det_conf "
        f"{conf!r} (q{DET_QUANTILE}), measured window times (s) "
        f"{ {str(s): t for s, t in sizeset.times.items()} }")
    grids, stats = proxy.plan_batch(pframes, thr, pl.det_grid(det_res))

    def plan():
        return plan_from_mapped(grids, stats, pl.make_sizeset(bank, params),
                                cfg.windows.max_windows, chunk_size=16)

    full = sizeset.full
    if all(s == full for s in plan().by_size):
        t_full = sizeset.times[full]
        for s in sizeset.sizes:
            bank.win_times[("ssd-deep", s)] = \
                t_full * s[0] * s[1] / (full[0] * full[1])
        log("set-up: the measured window times leave no sub-frame window "
            "in the first chunk; seeded them proportional to window area "
            f"from the full frame's {t_full!r} s")
    first = plan()
    if all(s == full for s in first.by_size):
        raise RuntimeError("no sub-frame window planned: window_gather "
                           "would not run")
    log(f"set-up: first chunk plans {sum(map(len, first.windows))} windows"
        f" in size classes { {str(s): len(e) for s, e in first.by_size.items()} }")
    return params, frames, feat, first


def traced(trace, label: str, tries: int = TRACE_TRIES):
    """``trace()`` (one profiler trace, read down to a value: None or
    empty where the trace held none of its kernels) again, after a
    pause, up to ``tries`` times: a trace late in a long process may
    drop every launch, and did so three times in a row for one call.
    Logs any empty trace; raises if every trace was empty."""
    for k in range(tries):
        got = trace()
        if got is not None and got != set():
            if k:
                log(f"{label}: {k} empty profiler trace(s) before this one")
            return got
        torch.cuda.synchronize()
        time.sleep(TRACE_PAUSE_S)
    raise AssertionError(f"{label}: the profiler recorded none of the "
                         f"kernels in {tries} traces")


def traced_ms(fn, kernel_names, label: str) -> float:
    """``device_ms`` of ``fn``, from the first trace that holds its
    kernels (``traced``)."""
    return traced(lambda: device_ms(fn, kernel_names), label)


def traced_kernels(launched, label: str) -> set:
    """``launched()`` (a check module's ``kernels_launched``: the kernel
    names one profiler trace holds), from the first trace that holds
    any (``traced``)."""
    return traced(launched, label)


def check_kernel_of_each_dtype(label: str, check, launched) -> None:
    """Each dtype launches only its own kernel: ``launched(dtype)`` (a
    check module's ``kernels_launched``) holds ``check.F32_KERNEL`` alone
    for f32 and the rest of ``check.KERNEL_NAMES`` for bf16."""
    for dt in (torch.bfloat16, torch.float32):
        got = traced_kernels(lambda: launched(dt), f"{label} {dt}")
        want = ({check.F32_KERNEL} if dt == torch.float32 else
                set(check.KERNEL_NAMES) - {check.F32_KERNEL})
        if got != want:
            raise AssertionError(f"{label} {dt}: the trace holds "
                                 f"{sorted(got)}, expected {sorted(want)}")
        log(f"{label} {dt}: launches {sorted(got)} only")


def launch_floor_ms() -> float:
    """The card's launch floor: the device time of ``zero_()`` on a
    one-element CUDA tensor, read as ``device_ms`` reads a kernel (the
    flush fills f32, this fills int32, so the names differ)."""
    one = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    t = traced_ms(lambda: one.zero_(), "FillFunctor<int>", "launch floor")
    log(f"launch floor: zero_() on a one-element CUDA tensor, device (cold "
        f"L2) {t!r} ms")
    return t


def copy_device_ms(n_bytes: int) -> float:
    """The device time of ``out.copy_(src)`` over ``n_bytes`` of f32 (a
    device-to-device memcpy), read as ``device_ms`` reads a kernel."""
    src = torch.ones(n_bytes // 4, device=DEVICE)
    out = torch.empty_like(src)
    return traced_ms(lambda: out.copy_(src), "Memcpy DtoD", "copy_")


def check_window_gather(frames, plan):
    """The batch gather against its plain version over the cases of
    ``repro_torch.kernels.window_gather.check`` (the card-only tests'
    own), bit for bit: the first chunk's plan for each size class it
    holds (the set-up chunk's own frames and tables), seeded tables
    padded with zero rows (one out of range), 8 windows of (30, 17) and
    the scalar branch.  Each timed with its bound and the device time of
    a ``copy_`` of the same bytes.  -> (the main-path record: the first
    chunk's plan, the class with the most windows; every record)."""
    dev_frames = torch.from_numpy(frames).to(DEVICE)
    cases = list(gather_check.CASES)
    for size in SIZES_CELLS[1:]:
        if plan.by_size.get(size) and size != cases[0][2]:
            cases.insert(1, (f"first chunk's plan {size}", cases[0][1], size,
                             "plan"))
    rows = []
    for case in cases:
        name, shape, size, kind = case
        table = None
        entries = plan.by_size.get(size) if kind == "plan" else None
        if entries:
            table = np.zeros((next_bucket(len(entries)), 3), np.int32)
            for k, (slot, x, y, _) in enumerate(entries):
                table[k] = (slot, y, x)
        fr = dev_frames if shape == tuple(frames.shape) else None
        rec = gather_check.check_case(case, DEVICE, frames=fr, table=table)
        src, tbl, win_h, win_w = rec["operands"]

        def kern():
            return window_gather_batch(src, tbl, win_h=win_h, win_w=win_w,
                                       cell=pl.CELL_PX)

        def plain():
            return window_gather_batch_ref(src, tbl, win_h=win_h,
                                           win_w=win_w, cell=pl.CELL_PX)
        b_ms, b_by = bound(2 * rec["out_bytes"] + tbl.numel() * 4, 0)
        dev_ms = traced_ms(kern, gather_check.KERNEL_NAMES,
                           f"window_gather_batch {name}")
        row = dict(case=name, size=size, n=rec["n"],
                   src="first chunk's plan" if table is not None
                   else "seeded", max_abs_err=rec["max_abs_err"],
                   ms=event_ms(kern), plain_ms=event_ms(plain),
                   device_ms=dev_ms, copy_device_ms=copy_device_ms(
                       rec["out_bytes"]), bound_ms=b_ms, bound_by=b_by)
        log(f"window_gather_batch {name}: {rec['n']} rows of {size} cells "
            f"({row['src']} table), exact; kernel {row['ms']:.4f} ms/call "
            f"(device, cold L2 {dev_ms!r}), plain {row['plain_ms']:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}); copy_ of the same "
            f"{rec['out_bytes']} bytes, device {row['copy_device_ms']!r}")
        rows.append(row)
    # the main-path entry: the planned class with the most windows
    return max((r for r in rows if r["src"] == "first chunk's plan"),
               key=lambda r: r["n"]), rows


def check_proxy_plan(feat, w, b, thr, grid_hw):
    """The fused plan against its plain version over the cases of
    ``repro_torch.kernels.proxy_plan.check`` (the card-only tests'
    own: the main path's shapes at a threshold between cells and on a
    cell, an all-empty frame, B 1, the reduced config, an odd C), then
    on the set-up chunk's own features at the main path's threshold,
    timed there (device ms over ``KERNEL_NAMES``; the host's enqueue
    time of the wrapper).  -> the record."""
    hc, wc = grid_hw
    B, hp, wp, C = feat.shape
    flips = 0
    for case in plan_check.CASES:
        rec = plan_check.check_case(case, DEVICE)
        flips += rec["flips"]
        log(f"proxy_plan {case[0]} {rec['shape']}: {rec['flips']} flipped "
            f"grid cells, all within {FLIP_ULPS} ulp of the threshold "
            f"({rec['reach']} cells in the band's reach); stats equal "
            "wherever no flip touched")
    rec = plan_check.check_call(feat, w, b, thr, grid_hw,
                                "main path features")
    flips += rec["flips"]
    log(f"proxy_plan (main path features): {rec['flips']} flipped grid "
        f"cells, all within {FLIP_ULPS} ulp of threshold {thr!r} "
        f"({rec['reach']} cells in the band's reach)")
    sy, sx = _spans_on(feat.device, hc, hp, wc, wp)

    def kern():
        return proxy_plan(feat, w, b, thr, grid_hw=grid_hw)

    def plain():
        return proxy_plan_ref(feat, w, b, thr, sy, sx)
    n_bytes = (feat.numel() + w.numel() + 1 + sy.numel() + sx.numel()) * 4 \
        + B * hc * wc + B * 8 * 4
    n_ops = B * hp * wp * (2 * C + 4) + B * (hc * wp * hp + hc * wc * wp) * 2
    b_ms, b_by = bound(n_bytes, n_ops)
    with torch.inference_mode():
        dev_ms = traced_ms(kern, plan_check.KERNEL_NAMES, "proxy_plan")
        row = dict(max_abs_err=float(flips > 0), flips=flips,
                   ms=event_ms(kern), plain_ms=event_ms(plain),
                   host_us=host_us(kern), device_ms=dev_ms, bound_ms=b_ms,
                   bound_by=b_by)
        # the plan's way back to the host, as ProxyModel.plan_batch takes
        # it: one copy of the buffer that grid and stats share, against
        # a copy of each
        grid, stats = kern()
        row.update(copy_back_us=host_us(lambda: plan_to_host(grid, stats)),
                   copy_back_two_us=host_us(lambda: (grid.cpu().numpy(),
                                                     stats.cpu().numpy())))
    log(f"proxy_plan {tuple(feat.shape)} -> {(B, hc, wc)}: kernel "
        f"{row['ms']:.4f} ms/call (device, cold L2 {dev_ms!r}; host "
        f"enqueue {row['host_us']:.2f} us a call), plain "
        f"{row['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by}); the plan "
        f"to the host in one copy {row['copy_back_us']:.2f} us, in two "
        f"{row['copy_back_two_us']:.2f} us")
    return row


def host_us(fn, reps: int = 200) -> float:
    """Host time of one call of ``fn`` (its enqueue: no synchronise
    inside the loop), in us."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def check_window_gather_single(frame):
    """The single-frame gather against its plain version, exactly, on
    one 960x544 frame: for each sub-frame size, a table of 8 rows (6
    seeded windows, one at the far edge, one zero padding row)."""
    CELL_PX = pl.CELL_PX
    dev_frame = torch.from_numpy(np.ascontiguousarray(frame)).to(DEVICE)
    H, W, _ = frame.shape
    rng = np.random.default_rng(SEED)
    rows = []
    for size in SIZES_CELLS[1:]:
        tbl = np.zeros((8, 2), np.int32)
        tbl[:6] = np.stack([rng.integers(0, H // CELL_PX - size[1] + 1, 6),
                            rng.integers(0, W // CELL_PX - size[0] + 1, 6)],
                           1)
        tbl[6] = (H // CELL_PX - size[1], W // CELL_PX - size[0])
        win_h, win_w = size[1] * CELL_PX, size[0] * CELL_PX
        t_dev = torch.from_numpy(tbl).to(DEVICE)

        def kern():
            return window_gather(dev_frame, t_dev, win_h=win_h, win_w=win_w,
                                 cell=CELL_PX)

        def plain():
            return window_gather_ref(dev_frame, t_dev, win_h=win_h,
                                     win_w=win_w, cell=CELL_PX)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"window_gather {size}: kernel != plain "
                                 "version")
        if not torch.equal(got[7], dev_frame[:win_h, :win_w]):
            raise AssertionError(f"window_gather {size}: the padding row "
                                 "is not cell (0, 0)")
        err = float((got - want).abs().max())
        out_bytes = tbl.shape[0] * win_h * win_w * 3 * 4
        b_ms, b_by = bound(2 * out_bytes + tbl.nbytes, 0)
        row = dict(size=size, n=tbl.shape[0], max_abs_err=err,
                   ms=event_ms(kern), plain_ms=event_ms(plain),
                   device_ms=device_ms(kern, "window_gather_kernel"),
                   bound_ms=b_ms, bound_by=b_by)
        log(f"window_gather {size} cells, 8 rows (6 seeded, far edge, "
            f"padding) from one {H}x{W} frame: exact; kernel "
            f"{row['ms']:.4f} ms/call (device, cold L2 {row['device_ms']}), "
            f"plain {row['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        rows.append(row)
    # the scalar-copy branch (rows not 16-byte aligned)
    small = torch.randn((64, 48, 1), device=DEVICE)
    tbl = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32, device=DEVICE)
    if not torch.equal(
            window_gather(small, tbl, win_h=32, win_w=16, cell=16),
            window_gather_ref(small, tbl, win_h=32, win_w=16, cell=16)):
        raise AssertionError("window_gather scalar branch differs")
    return rows


def check_proxy_score(feat, w, b, thr):
    """The score-map head against its plain version on the encoder's
    real features of the set-up chunk, at the per-frame path's (1, 8,
    13, 64) and a chunk's (16, 8, 13, 64): scores to 1e-6, both held to
    float64 by ``check_scores`` (flips only in the 8-ulp band), at the
    main path's threshold and at one ON a cell's score."""
    rows = {}
    for B in (1, feat.shape[0]):
        f = feat[:B].contiguous()
        with torch.inference_mode():
            on_cell = float(torch.sigmoid(
                f[B // 2, f.shape[1] // 2, f.shape[2] // 2] @ w + b))
        err = 0.0
        flips = band = 0
        for t in (thr, on_cell):
            with torch.inference_mode():
                sk, pk = proxy_score(f, w, b, t)
                sp, pp = proxy_score_ref(f, w, b, t)
            torch.cuda.synchronize()
            band += check_scores(f, w, b, t, sk, pk)
            check_scores(f, w, b, t, sp, pp)
            d = float((sk - sp).abs().max())
            if d > 1e-6:
                raise AssertionError(f"proxy_score B={B}: |d score| {d!r} "
                                     "> 1e-6")
            err = max(err, d)
            flips += int((pk != pp).sum())

        def kern():
            return proxy_score(f, w, b, thr)

        def plain():
            return proxy_score_ref(f, w, b, thr)
        n_rows = f.numel() // f.shape[-1]
        C = f.shape[-1]
        n_bytes = (f.numel() + w.numel() + 1) * 4 + n_rows * (4 + 1)
        b_ms, b_by = bound(n_bytes, n_rows * (2 * C + 4))
        with torch.inference_mode():
            row = dict(shape=tuple(f.shape), max_abs_err=err, flips=flips,
                       band=band, ms=event_ms(kern),
                       plain_ms=event_ms(plain),
                       device_ms=device_ms(kern, "proxy_score_kernel"),
                       bound_ms=b_ms, bound_by=b_by)
        log(f"proxy_score {tuple(f.shape)}: max |d score| {err!r}, {flips} "
            f"flipped cells, all within {FLIP_ULPS} ulp ({band} cells in "
            f"the band, thresholds {thr!r} and {on_cell!r}); kernel "
            f"{row['ms']:.4f} ms/call (device, cold L2 {row['device_ms']}), "
            f"plain {row['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        rows[B] = row
    return rows


def host_ms(fn, reps: int = 2) -> float:
    """Per-call host time of ``fn`` (a plain version on a CPU copy)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def check_assign():
    """The JV kernel against its plain version over the cases of
    ``repro_torch.kernels.assign.check`` (the card-only tests' own), bit
    for bit: K = 4 at N = 8, 64, 128 and 128 restricted to eff_n 40 on
    costs quantised to 1/64, all-equal rows, minima 32 columns apart,
    zeros of either sign, N = 256 (rows past shared memory) and N = 2048
    (the large-matrix instance); then
    the batches that must raise (NaN costs, a row of +inf: a step with no
    finite free column).  Each case timed, with the JV's steps (counted
    on the host) and ns a step.  -> {case: record}."""
    rows = {}
    for case in assign_check.CASES:
        name, K, N, eff, _ = case
        row = assign_check.check_case(case, DEVICE)
        host = assign_check.case_costs(case)
        dev = host.to(DEVICE)
        big = N > 1024

        def kern():
            return assign_batch(dev, eff)
        # (K, N) int32 out, (K, N, N) f32 in: the solve is sequential, so
        # the bound is bytes only and far below what a solve can reach
        b_ms, b_by = bound(host.numel() * 4 + K * N * 4, 0)
        dev_ms = device_ms(kern, ASSIGN_KERNEL_NAMES, reps=2 if big else 50)
        steps = max(row["steps"])
        row.update(ms=event_ms(kern, reps=2 if big else 50,
                               warmup=1 if big else 5),
                   device_ms=dev_ms,
                   plain_ms=host_ms(lambda: assign_batch_ref(host, eff),
                                    reps=1),
                   bound_ms=b_ms, bound_by=b_by,
                   ns_per_step=None if dev_ms is None
                   else dev_ms * 1e6 / steps)
        log(f"assign_batch {name} ({K}, {N}, {N}) eff_n={eff}: exact "
            f"against the plain version on a CPU copy; kernel "
            f"{row['ms']:.4f} ms/call (device, cold L2 {dev_ms}), plain "
            f"(CPU) {row['plain_ms']:.2f} ms, bound {b_ms:.6f} ms ({b_by}: "
            f"matrices read once, columns written once); JV steps "
            f"{row['steps']} (hops {row['hops']}), {row['ns_per_step']} ns "
            "a step of the longest solve")
        rows[name] = row
    for case in assign_check.RAISE_CASES:
        msg = assign_check.check_raises(case, DEVICE)
        log(f"assign_batch on {case[0]} costs raises, as the plain version "
            f"does ({msg}), and with err= sets the flag instead")
    return rows


def check_track_step():
    """The fused step against its plain version over the cases of
    ``repro_torch.kernels.track_step.check`` (the card-only tests' own),
    bit for bit on all three outputs, the plain version on the card equal
    to the plain version on the CPU: at the main path's widths (Q = 128
    slots) one stream with 40 live tracks and 30 detections at the
    tracker's threshold, 16 streams at threshold 0.5, one live row, one
    valid column, Q = 256 on squares of 64 and 256, and Q = 512 (the
    large-matrix JV instance).  Each case
    timed by kernel part, with the JV's steps and ns a step.
    -> {case: record}."""
    heads_cpu = track_check.heads("cpu")
    heads = [p.to(DEVICE) for p in heads_cpu]
    table_cpu = torch.from_numpy(LOG1P_TABLE_2D)
    table = table_cpu.to(DEVICE)
    rows = {}
    for case in track_check.CASES:
        name, K, Q, _, _ = case
        row = track_check.check_case(case, DEVICE, heads_cpu)
        ops_cpu, thr_cpu = track_check.case_operands(case, heads_cpu)
        ops = [a.to(DEVICE) for a in ops_cpu]
        thr_dev = thr_cpu.to(DEVICE)

        def kern():
            return track_step(*ops, thr_dev, heads, table)

        def plain():
            return track_step_ref(*ops, thr_dev, heads, table)
        alive, dvalid = ops_cpu[2], ops_cpu[7]
        n = (dvalid > 0).sum(1)
        H = ops_cpu[0].shape[2]
        e = ops_cpu[5].shape[2]
        M = heads_cpu[8].shape[1]
        # operations this data needs: the match MLP and logit over the
        # live pairs, the match-time features of the valid columns, and
        # both GRU batches with their features over all 2Q rows; the JV
        # solve is sequential and outside the bound
        feat = (e + 6) * e * 2
        gru = 3 * (e + H) * H * 2
        pairs = row["live_pairs"]
        n_ops = (pairs * ((H + e + 6) * M * 2 + M * 2) + int(n.sum()) * feat
                 + 2 * Q * K * (feat + gru))
        n_bytes = (sum(a.numel() for a in ops_cpu) + 1
                   + sum(p.numel() for p in heads_cpu)
                   + table_cpu.numel()) * 4 + K * Q * (1 + 2 * H) * 4
        b_ms, b_by = bound(n_bytes, n_ops)
        q2_ms = K * (Q * Q * (H + e + 6) * M * 2 + Q * Q * M * 2) \
            / F32_OPS_PER_S * 1e3
        parts = {k: t for k, t in device_ms_by_kernel(
            kern, track_check.KERNEL_NAMES).items() if t is not None}
        jv_ms = parts.get("track_assign_kernel",
                          parts.get("track_assign_large_kernel"))
        main = name == track_check.CASES[0][0]
        row.update(ms=event_ms(kern, reps=20),
                   device_ms=sum(parts.values()) if parts else None,
                   device_ms_parts=parts,
                   plain_ms=event_ms(plain, reps=1, warmup=0) if main
                   else None,
                   bound_ms=b_ms, bound_by=b_by, bound_q2_ms=q2_ms,
                   ns_per_step=None if jv_ms is None
                   else jv_ms * 1e6 / max(max(row["steps"]), 1))
        log(f"track_step {name}: K={K} Q={Q} H={H} e={e} M={M}: {pairs} "
            f"live pairs, {row['matched']} rows matched, squares "
            f"{row['sides']}; kernel == plain on the card == plain on the "
            f"CPU, bit for bit on matched/h_upd/h_new; kernel "
            f"{row['ms']:.4f} ms/call (device, cold L2 {row['device_ms']}: "
            f"{json.dumps(parts)}), plain (card) {row['plain_ms']} ms, "
            f"bound {b_ms:.6f} ms ({b_by}: live-pair MLP + features + both "
            f"GRU batches at 67 TFLOP/s; JV sequential, outside it; all "
            f"Q^2 pairs would be {q2_ms:.6f} ms); JV steps {row['steps']} "
            f"(hops {row['hops']}), {row['ns_per_step']} ns a step of the "
            "longest solve")
        rows[name] = row
    return rows


def check_against_cpu(bank, frames, feat_cuda, pres):
    """Small-input agreement: the card's conv nets against the same
    weights on the CPU (TF32 off, so float32 on both), and the port's
    own cross-bucket drift on the card (reported, not asserted)."""
    import copy
    det = bank.detectors["ssd-deep"]
    enc = bank.proxies[pres].encoder
    x = torch.from_numpy(frames[:2])
    with torch.inference_mode():
        card = det.net(x.to(DEVICE)).cpu()
        cpu = copy.deepcopy(det.net).cpu()(x)
        d_det = float((card - cpu).abs().max())
        px = torch.from_numpy(np.ascontiguousarray(
            pl.downsample_chunk(frames[:2], pres)))
        d_proxy = float((feat_cuda[:2].cpu()
                         - copy.deepcopy(enc).cpu()(px)).abs().max())
        one = det.net(x[:1].to(DEVICE))
        sixteen = det.net(torch.from_numpy(frames).to(DEVICE))[:1]
        d_bucket = float((one - sixteen).abs().max())
        # the crop CNN embeds per frame (padded to 8 crops) on the
        # per-frame path and per chunk (padded to a bucket) on the
        # streaming one
        cnn = bank.tracker_params["crop_cnn"]
        crop = bank.cfg.tracker.crop
        crops = torch.from_numpy(np.random.default_rng(SEED).random(
            (64, crop, crop, 3), np.float32)).to(DEVICE)
        full = cnn(crops)
        d_embed = max(float((cnn(crops[:n]) - full[:n]).abs().max())
                      for n in (8, 16, 24, 40))
        # sub-frame windows: per frame at a bucket of that frame's
        # windows, per chunk at a bucket of the chunk's
        CELL_PX = pl.CELL_PX
        ph, pw = SIZES_CELLS[1][1] * CELL_PX, SIZES_CELLS[1][0] * CELL_PX
        wins = torch.from_numpy(np.ascontiguousarray(
            frames[:, :ph, :pw])).to(DEVICE)
        w16 = det.net(wins)
        d_window = max(float((det.net(wins[:n]) - w16[:n]).abs().max())
                       for n in (1, 2, 4, 8))
    log(f"card vs CPU, same weights, 2 frames of {frames.shape[1:3]}: "
        f"detector head "
        f"max |d| {d_det!r}, proxy features max |d| {d_proxy!r} "
        f"(tolerance {CONV_ATOL})")
    log(f"port's detector across buckets on the card (batch 1 vs 16): "
        f"max |d| {d_bucket!r}; detector on {pw}x{ph} windows (batch 1, 2,"
        f" 4, 8 vs 16): max |d| {d_window!r}; crop CNN (batch 8, 16, 24, 40"
        f" vs 64): max |d| {d_embed!r} (reported, not asserted)")
    if not (d_det < CONV_ATOL and d_proxy < CONV_ATOL):
        raise AssertionError("conv nets on the card disagree with the CPU")


def device_busy(bank, params, clip, options=None,
                label: str = "host tracker", engine: str = "streaming"
                ) -> None:
    """One more run of the main path (or, with ``engine="frame"``, of
    the per-frame engine) under the profiler, recording the device only:
    the card's busy time summed over every kernel and copy it ran,
    against the run's wall time, and the time of the track_step kernels.
    The profiler adds some host time, so the idle share is an upper
    bound."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if engine == "frame":
            res = pl.run_clip(bank, params, clip, engine="frame")
        else:
            res = ClipExecutor(bank, params, options).run(clip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    per_name = {}
    for ev in prof.events():          # the device's own events only
        if ev.device_type == DeviceType.CUDA:
            per_name[ev.name] = per_name.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us()
    busy_us = sum(per_name.values())
    track_us = sum(us for k, us in per_name.items() if "track_" in k
                   and "_kernel" in k)
    top = sorted(((us, k) for k, us in per_name.items()), reverse=True)
    stage = "" if res.stage_seconds is None else (
        f"TRACK stage {res.stage_seconds['track']['wall'] * 1e3:.1f} ms "
        "wall, ")
    log(f"device busy ({label}, profiled run, clip {clip.clip_id}): "
        f"{busy_us / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall = "
        f"{100 * busy_us / 1e6 / wall:.1f}% busy, "
        f"{100 - 100 * busy_us / 1e6 / wall:.1f}% idle; {stage}"
        f"track_step kernels {track_us / 1e3:.1f} ms; top device time: "
        + "; ".join(f"{k[:60]} {us / 1e3:.1f} ms" for us, k in top[:6]))


@contextlib.contextmanager
def wrapped(owner, name: str, wrap):
    """Replace ``owner.name`` by ``wrap(original)`` inside the block (an
    instrumented run), and restore the original after it."""
    fn = getattr(owner, name)
    setattr(owner, name, wrap(fn))
    try:
        yield
    finally:
        setattr(owner, name, fn)


def frame_breakdown(bank, params, clip) -> None:
    """Where one per-frame run's wall time goes: host clocks around the
    decode (``render_frame``), the proxy (``ProxyModel.scores``: encoder,
    ``proxy_score`` and the copy back), the detector
    (``Detector.detect_batch``, which synchronises on its outputs) and
    the tracker step (its crop CNN synchronises too), wrapped in place
    for this one measured run and restored after it.  The rest is host
    planning, the frame upload, ``window_gather`` and NMS."""
    spent = {"decode": 0.0, "proxy": 0.0, "detect": 0.0, "track": 0.0}

    def timed(phase):
        def wrap(fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spent[phase] += time.perf_counter() - t0
            return wrapper
        return wrap
    with contextlib.ExitStack() as hooks:
        for owner, name, phase in ((pl, "render_frame", "decode"),
                                   (ProxyModel, "scores", "proxy"),
                                   (Detector, "detect_batch", "detect"),
                                   (RecurrentTracker, "step", "track")):
            hooks.enter_context(wrapped(owner, name, timed(phase)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl.run_clip(bank, params, clip, engine="frame")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rest = wall - sum(spent.values())
    log(f"per-frame run by phase (clip {clip.clip_id}, host clocks): "
        f"{wall:.3f} s wall = "
        + ", ".join(f"{k} {v:.3f} s" for k, v in spent.items())
        + f", other (planning, frame upload, window_gather, NMS) "
        f"{rest:.3f} s")


def engine_drift(bank, params, clip) -> None:
    """Where the per-frame engine parts from the streaming engine on the
    same clip (reported, not asserted: the two run their conv nets at
    other batch sizes): the detections each feeds the host tracker,
    frame by frame, recorded around ``RecurrentTracker.step`` for these
    two runs only."""
    seen = {"streaming": {}, "frame": {}}

    def recording(store):
        def wrap(step):
            def wrapper(self, frame_idx, dets, frame, det_embeds=None):
                store[frame_idx] = np.array(dets, copy=True)
                return step(self, frame_idx, dets, frame, det_embeds)
            return wrapper
        return wrap
    with wrapped(RecurrentTracker, "step", recording(seen["streaming"])):
        a = pl.run_clip(bank, params, clip)
    with wrapped(RecurrentTracker, "step", recording(seen["frame"])):
        b = pl.run_clip(bank, params, clip, engine="frame")
    differ = []
    for f, d in sorted(seen["frame"].items()):
        o = seen["streaming"][f]
        if d.shape != o.shape or not np.array_equal(d, o):
            gap = float(np.abs(d - o).max()) if d.shape == o.shape else None
            differ.append((f, d.shape[0], o.shape[0], gap))
    log(f"engine drift (clip {clip.clip_id}): streaming {len(a.tracks)} "
        f"tracks, per-frame {len(b.tracks)}; detections fed to the tracker"
        f" differ on {len(differ)} of {len(seen['frame'])} frames"
        + ("" if not differ else
           f", first (frame, per-frame count, streaming count, max |d|): "
           f"{differ[:4]}"))


def compare_plans(bank, params, clip):
    """Both PROXY paths' plans for every chunk of ``clip``: fused
    (``plan_batch`` -> ``plan_from_mapped``) and unfused
    (``scores_batch`` -> ``map_proxy_grid`` -> ``plan_chunk``).  They
    must plan the same windows on every frame where ``check_scores``
    finds no proxy cell in the flip band.  Returns (frames compared,
    frames with a cell in the band)."""
    proxy = bank.proxies[params.proxy_res]
    enc = proxy.encoder
    sizeset = pl.make_sizeset(bank, params)
    grid = pl.det_grid(params.det_res)
    mw = bank.cfg.windows.max_windows
    thr = params.proxy_threshold
    ids = list(range(0, clip.n_frames, params.gap))
    compared = in_band = 0
    for c0 in range(0, len(ids), 16):
        frames = np.stack([pl.render_frame(clip, f, *params.det_res)[0]
                           for f in ids[c0:c0 + 16]])
        pframes = pl.downsample_chunk(frames, params.proxy_res)
        grids, stats = proxy.plan_batch(pframes, thr, grid)
        fused = plan_from_mapped(grids, stats, sizeset, mw, chunk_size=16)
        _, pos = proxy.scores_batch(pframes, thr)
        unfused = plan_chunk([pl.map_proxy_grid(p, grid) for p in pos],
                             sizeset, mw, chunk_size=16)
        feat = proxy.features(pframes)
        with torch.inference_mode():
            sc, ps = proxy_score(feat, enc.head_w, enc.head_b, thr)
        for k in range(len(frames)):
            if check_scores(feat[k:k + 1], enc.head_w, enc.head_b, thr,
                            sc[k:k + 1], ps[k:k + 1]):
                in_band += 1
                continue
            compared += 1
            if fused.windows[k] != unfused.windows[k]:
                raise AssertionError(f"frame {ids[c0 + k]}: fused and "
                                     "unfused plans differ with no cell "
                                     "in the flip band")
    return compared, in_band


def check_refined(refined, plain, label: str) -> int:
    """Every refined track contains its unrefined track's rows
    unchanged: refinement only prepends a start row and appends an end
    row.  Returns how many tracks it extended."""
    if len(refined.tracks) != len(plain.tracks):
        raise AssertionError(f"refined {label} run has another track count")
    extended = 0
    for r, u in zip(refined.tracks, plain.tracks):
        if not np.isfinite(r).all():
            raise AssertionError(f"refined {label} track not finite")
        if np.array_equal(r, u):
            continue
        if len(r) != len(u) + 2 or not np.array_equal(r[1:-1], u) \
                or r[0, 0] != u[0, 0] or r[-1, 0] != u[-1, 0]:
            raise AssertionError(f"refined {label} track does not contain "
                                 "its unrefined rows")
        extended += 1
    return extended


def same_tracks(a, b) -> bool:
    return len(a.tracks) == len(b.tracks) and all(
        np.array_equal(x, y) for x, y in zip(a.tracks, b.tracks))


def check_result(res, n_frames):
    if res.frames_processed != n_frames:
        raise AssertionError(f"{res.frames_processed} frames processed")
    if not (res.detector_windows >= res.full_frames
            and res.full_frames + res.skipped_frames <= n_frames):
        raise AssertionError("inconsistent RunResult counters")
    if not res.tracks:
        raise AssertionError("no tracks")
    for t in res.tracks:
        if t.ndim != 2 or t.shape[1] != 6 or not np.isfinite(t).all():
            raise AssertionError(f"bad track array {t.shape}")
        f = t[:, 0]
        if (np.diff(f) <= 0).any() or f.min() < 0 or f.max() >= n_frames \
                or len(np.unique(t[:, 5])) != 1:
            raise AssertionError("track frames not increasing in range")


# ---------------------------------------------------------------------------
# The fleet: many streams through the cross-stream brokers, and run_clips
# ---------------------------------------------------------------------------

def run_threads(fns, timeout: float = FLEET_JOIN_S) -> list:
    """Run each callable on its own thread; -> their results.  A thread
    still alive after its join's timeout, or any error, fails."""
    out = [None] * len(fns)
    errors = []

    def one(i):
        try:
            out[i] = fns[i]()
        except BaseException as exc:     # raised below, on this thread
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a stream did not finish in {timeout} s")
    if errors:
        raise errors[0]
    return out


def counters_agree(got, want, label: str) -> None:
    """A stream's run against its solo run: the same counters."""
    for k in ("frames_processed", "detector_windows", "full_frames",
              "skipped_frames"):
        if getattr(got, k) != getattr(want, k):
            raise AssertionError(f"{label}: RunResult.{k} "
                                 f"{getattr(got, k)} against "
                                 f"{getattr(want, k)}")


def tracks_agree(got, want, exact: bool, label: str) -> None:
    """A stream's run against its solo run: the same counters, and the
    same tracks bit for bit (``exact``) or with the same frames and ids
    and boxes within ``BOX_RTOL`` / ``BOX_ATOL``."""
    counters_agree(got, want, label)
    if len(got.tracks) != len(want.tracks):
        raise AssertionError(f"{label}: {len(got.tracks)} tracks against "
                             f"{len(want.tracks)}")
    for t, (x, y) in enumerate(zip(got.tracks, want.tracks)):
        if exact:
            if not np.array_equal(x, y):
                raise AssertionError(f"{label}: track {t} differs in its "
                                     "bits")
        elif x.shape != y.shape or not np.array_equal(x[:, [0, 5]],
                                                      y[:, [0, 5]]):
            raise AssertionError(f"{label}: track {t} has other frames "
                                 f"or ids ({x.shape} against {y.shape})")
        elif not np.allclose(x, y, rtol=BOX_RTOL, atol=BOX_ATOL):
            raise AssertionError(f"{label}: track {t}'s boxes differ by "
                                 f"{float(np.abs(x - y).max())!r}")


class ScoreLog:
    """The decisions of each stream's run, by stream, in the order the
    stream made them: every detector row's objectness scores (a solo
    run's ``detect_batch`` calls, or a brokered stream's requests: the
    flushing thread splits each consolidated batch back to its requests
    before any is marked done), and every host-tracker assignment (its
    cost matrix and pairs).  A stream thread names itself in
    ``tl.stream``."""

    def __init__(self):
        self.tl = threading.local()
        self.rows: Dict[int, list] = {}
        self.of_request: Dict[int, np.ndarray] = {}
        self.assigns: Dict[int, list] = {}

    def scores(self, fn):                      # detector.detect_scores
        def wrapper(net, frames):
            s, b = fn(net, frames)
            self.tl.last = s
            return s, b
        return wrapper

    def detect_batch(self, fn):                # Detector.detect_batch
        def wrapper(det, *args, **kwargs):
            out = fn(det, *args, **kwargs)
            rows = self.tl.last[:len(out)].cpu().numpy()
            reqs = getattr(self.tl, "reqs", None)
            if reqs is None:
                self.rows.setdefault(self.tl.stream, []).append(rows)
            else:
                ofs = 0
                for r in reqs:
                    self.of_request[id(r)] = rows[ofs:ofs + r.n]
                    ofs += r.n
            return out
        return wrapper

    def dispatch(self, fn):                    # BatchBroker._dispatch
        def wrapper(broker, reqs):
            self.tl.reqs = reqs
            try:
                return fn(broker, reqs)
            finally:
                self.tl.reqs = None
        return wrapper

    def submit(self, fn):                      # BatchBroker._submit
        def wrapper(broker, req):
            out = fn(broker, req)
            self.rows.setdefault(self.tl.stream, []).append(
                self.of_request.pop(id(req)))
            return out
        return wrapper

    def assign(self, fn):                      # tracker.hungarian_device_np
        def wrapper(cost):
            pairs = fn(cost)
            self.assigns.setdefault(self.tl.stream, []).append(
                (np.array(cost, np.float32), {(int(t), int(d))
                                              for t, d in pairs}))
            return pairs
        return wrapper

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.core import detector as det_mod
        with wrapped(det_mod, "detect_scores", self.scores), \
                wrapped(Detector, "detect_batch", self.detect_batch), \
                wrapped(BatchBroker, "_dispatch", self.dispatch), \
                wrapped(BatchBroker, "_submit", self.submit), \
                wrapped(trk_mod, "hungarian_device_np", self.assign):
            yield self


def decision(row: np.ndarray, conf: float) -> tuple:
    """The cells ``decode_detections`` keeps from one window's scores,
    in the order it takes them (score above ``conf``, by falling
    score)."""
    s = row.ravel()
    idx = np.flatnonzero(s > conf)
    return tuple(idx[np.argsort(-s[idx])][:256].tolist())


def score_flips(got: list, want: list, conf: float, label: str):
    """One stream's detector rows against its solo run's, row by row ->
    (max |Δ| of the scores, the rows whose decision differs: (call, row,
    the cells that crossed ``conf`` as (solo, brokered) scores, or the
    cells whose order changed))."""
    if len(got) != len(want) or any(g.shape != w.shape
                                    for g, w in zip(got, want)):
        raise AssertionError(f"{label}: detector rows "
                             f"{[g.shape for g in got]} against the solo "
                             f"run's {[w.shape for w in want]}")
    worst, flips = 0.0, []
    for k, (g, w) in enumerate(zip(got, want)):
        if g.size:
            worst = max(worst, float(np.abs(g - w).max()))
        for b in range(len(g)):
            dg, dw = decision(g[b], conf), decision(w[b], conf)
            if dg == dw:
                continue
            crossed = np.flatnonzero((g[b].ravel() > conf)
                                     != (w[b].ravel() > conf))
            flips.append((k, b, [(float(w[b].ravel()[c]),
                                  float(g[b].ravel()[c]))
                                 for c in crossed] or "order"))
    return worst, flips


def assignment_flip(got: list, want: list, thr: float, label: str):
    """One stream's host-tracker assignments against its solo run's ->
    None where every one has the same pairs, else the first that
    differs: ("tie", call, A(q) - A(p), its limit), where A is the solo
    run's costs, p its pairs and q the stream's, and the limit is the
    sum of |A - B| over the pairs of both (an exact solver of B cannot
    pick q unless the two assignments are tied within it); ("solver",
    call, A(q) - A(p), the limit, p's gap, q's gap) where they are not,
    but p and q each lie within ``DEVICE_JV_GAP`` of the exact
    optimum of its own costs (``optimality_gap``: the host's f32 JV is
    not exact, so a drift within ``FLEET_COST_ATOL`` can move it to
    another answer about as near the optimum); or ("gate", call, offsets)
    where an entry is gated on one side only, with each such entry's
    match probability off the threshold.  Raises where the costs before
    it moved by more than ``FLEET_COST_ATOL``, or where the flip is none
    of these."""
    for k, ((B, q), (A, p)) in enumerate(zip(got, want)):
        if A.shape != B.shape:
            raise AssertionError(f"{label}: assignment {k} over "
                                 f"{B.shape} against the solo run's "
                                 f"{A.shape}, with no window flip")
        both = (A < BIG / 2) & (B < BIG / 2)
        drift = float(np.abs(A - B)[both].max()) if both.any() else 0.0
        if drift > FLEET_COST_ATOL:
            raise AssertionError(f"{label}: assignment {k}'s costs moved "
                                 f"by {drift!r}")
        if p == q:
            continue
        gate = (A < BIG / 2) != (B < BIG / 2)
        if gate.any():
            off = np.abs(1.0 - np.where(A < BIG / 2, A, B)[gate] - thr)
            if off.max() > FLEET_COST_ATOL:
                raise AssertionError(f"{label}: assignment {k} gated "
                                     f"entries {off.max()!r} from the "
                                     "threshold")
            return ("gate", k, off.tolist())
        gap = sum(float(A[t, d]) for t, d in q) - \
            sum(float(A[t, d]) for t, d in p)
        limit = sum(abs(float(A[t, d]) - float(B[t, d])) for t, d in p | q)
        if gap <= limit:
            return ("tie", k, gap, limit)
        gp, gq = optimality_gap(A, p), optimality_gap(B, q)
        if max(gp, gq) > DEVICE_JV_GAP:
            raise AssertionError(f"{label}: assignment {k} took other "
                                 f"pairs {sorted(q - p)} for "
                                 f"{sorted(p - q)}, {gap!r} dearer at the "
                                 f"solo costs (limit {limit!r}); from the "
                                 f"exact optimum: the solo run's {gp!r}, "
                                 f"the stream's {gq!r} (limit "
                                 f"{DEVICE_JV_GAP!r})")
        return ("solver", k, gap, limit, gp, gq)
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} assignments against "
                             f"{len(want)}")
    return None


def largest_gap(*logs) -> Tuple[float, int]:
    """The host JV's largest ``optimality_gap`` over every assignment the
    logs hold -> (that gap, the assignments)."""
    gaps = [optimality_gap(cost, pairs) for lg in logs
            for per in lg.assigns.values() for cost, pairs in per]
    return max(gaps, default=0.0), len(gaps)


def stage_sums(results) -> dict:
    """Stage wall and thread-CPU seconds summed over the runs."""
    out = {}
    for r in results:
        for k, v in r.stage_seconds.items():
            w, p = out.get(k, (0.0, 0.0))
            out[k] = (round(w + v["wall"], 3), round(p + v["process"], 3))
    return out


def detector_buckets(bank, params, frames, shapes) -> dict:
    """``batch_drift`` of the detector at every pow2 bucket up to each
    crop shape's largest: (h, w) -> {bucket: max |Δ|}.  Rows are crops
    of the fleet's frames (full frames repeated to fill a bucket)."""
    net = bank.detectors[params.det_arch].net
    out = {}
    for (h, w), top in sorted(shapes.items()):
        rows = [frames[i % len(frames), (i * 16) % (frames.shape[1] - h + 1):
                       (i * 16) % (frames.shape[1] - h + 1) + h,
                       (i * 32) % (frames.shape[2] - w + 1):
                       (i * 32) % (frames.shape[2] - w + 1) + w]
                for i in range(top)]
        x = torch.from_numpy(np.ascontiguousarray(np.stack(rows))
                             ).to(DEVICE)
        buckets = [1 << k for k in range(top.bit_length())
                   if 1 << k <= top]
        out[(h, w)] = batch_drift(net, x, buckets)
        del x
    return out


def on_clock(meet: threading.Barrier) -> dict:
    """Stages that put a fleet's streams on one chunk clock, as cameras
    that hand over each chunk together: after each chunk's PROXY a stream
    registers with its ``BatchBroker`` and waits for every other stream,
    so their DETECT requests meet in the broker.  Free-running streams
    drift apart by whole TRACK stages (a 64-track clip's host tracker
    takes seconds, a sparse one's tenths), far beyond the broker's
    10 ms linger, and a stream that reaches DETECT first flushes alone
    while its peers have not registered; so their requests rarely meet.
    The wait counts in the PROXY stage's wall."""
    def proxy_then_meet(ctx, task):
        task = stage_proxy(ctx, task)
        ctx.broker()
        meet.wait(FLEET_JOIN_S)
        return task
    return {"proxy": proxy_then_meet}


def run_fleet(bank, params) -> dict:
    """The executor's multi-stream half at full width, at the video
    cell's θ: solo runs of the fleet's clips (the oracle), ``BatchBroker``
    at 1, 4 and 16 streams on one chunk clock (host tracker), the
    detector's batch drift at every bucket the broker formed,
    ``TrackBroker`` with ``device_assign`` at 4 and 16, and ``run_clips``
    over the clips on fresh frames with the shared ``DecodePool`` at each
    ``FLEET_POOLS`` size.

    A brokered window rides another batch than in its solo run, so its
    scores may move by the detector's batch drift.  Every stream's
    detector rows are logged beside its solo run's (``ScoreLog``): each
    must lie within twice the largest drift read against batch 1 (both
    runs' batches are within it of batch 1), and a window whose kept
    cells differ (a score crossing det_conf, or two scores trading
    places) is counted as a decision flip.  A stream with no flip holds
    its tracks to the solo run's, bit for bit where the drift read 0.0
    everywhere and at 1 stream, else within the tolerances; unless its
    host tracker's first assignment that differs from the solo run's is
    tied with it within the drift (``assignment_flip``), a decision flip
    too.  A stream with a flip holds its counters only (``held_to``).
    Launch counts
    are set to 0 just before each run and read just after every thread
    joined.
    -> the launches of each path."""
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    conf = params.det_conf
    pl.clear_render_cache()
    clips = [make_clip("caldot1", "test", SEED + i, n_frames=FLEET_FRAMES)
             for i in range(FLEET_CLIPS)]

    # the solo runs: once on fresh frames (decode paid), then the oracle
    # on cached frames with its detector rows logged
    fresh_wall = 0.0
    fresh = []
    for c in clips:
        r, _, wall = counted(lambda: ClipExecutor(bank, params).run(c))
        fresh.append(r)
        fresh_wall += wall
    solo_log = ScoreLog()
    solo, solo_wall = [], []
    with solo_log.recording():
        for i, c in enumerate(clips):
            solo_log.tl.stream = i
            r, _, wall = counted(lambda: ClipExecutor(bank, params).run(c))
            solo.append(r)
            solo_wall.append(wall)
    for i, r in enumerate(solo):
        check_result(r, FLEET_FRAMES)
        tracks_agree(r, fresh[i], True, f"solo run of clip {i}, cached "
                     "against fresh frames")

    def sequential_fps(n):
        """fps of the same n streams' runs one after another (solo walls,
        frames cached)."""
        return n * FLEET_FRAMES / sum(solo_wall[i % len(clips)]
                                      for i in range(n))

    log(f"fleet: caldot1 test clips 0-{len(clips) - 1}, {FLEET_FRAMES} "
        f"frames each, the video cell's det_conf {conf!r}; solo runs: "
        f"tracks {[len(r.tracks) for r in solo]}, detector dispatches "
        f"{[r.dispatches['detect'] for r in solo]}, walls {solo_wall} s "
        f"(frames cached; fresh: {fresh_wall:.3f} s for the three); "
        f"stage (wall, thread CPU) s summed {stage_sums(solo)}")

    def fleet_run(n, opts, score_log=None, clock=False):
        """n concurrent streams, clips round-robin, one executor each;
        with ``clock``, the streams on one chunk clock (``on_clock``);
        -> (results, launches, wall)."""
        meet = threading.Barrier(n)
        stages = on_clock(meet) if clock else None

        def stream(i):
            if score_log is not None:
                score_log.tl.stream = i
            try:
                return ClipExecutor(bank, params, opts, stages=stages).run(
                    clips[i % len(clips)])
            except BaseException:
                meet.abort()             # no peer waits out the clock
                raise
        return counted(lambda: run_threads([
            lambda i=i: stream(i) for i in range(n)]))

    # BatchBroker: record each detector batch's rows per crop shape
    formed = {}

    def recording(fn):
        def wrapper(self, frames, *args, **kwargs):
            shape = tuple(frames.shape[1:3])
            formed[shape] = max(formed.get(shape, 1), int(frames.shape[0]))
            return fn(self, frames, *args, **kwargs)
        return wrapper

    brokered, fleet_launches = {}, {}
    for n in FLEET_STREAMS:
        broker = BatchBroker()
        score_log = ScoreLog()
        with score_log.recording(), \
                wrapped(Detector, "detect_batch", recording):
            res, launches, wall = fleet_run(
                n, ExecutorOptions(batch_broker=broker), score_log,
                clock=True)
        broker.close()
        for name in ("proxy_plan", "window_gather_batch"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} was not launched by "
                                     f"{n} brokered streams")
        solo_disp = sum(solo[i % len(clips)].dispatches["detect"]
                        for i in range(n))
        if n > 1 and broker.dispatches >= solo_disp:
            raise AssertionError(
                f"BatchBroker at {n} streams: {broker.dispatches} "
                f"dispatches, the solo runs {solo_disp}")
        if broker.windows_in != sum(r.detector_windows for r in res):
            raise AssertionError("BatchBroker lost windows")
        brokered[n] = (res, score_log)
        fleet_launches[f"batch_broker_{n}"] = launches
        log(f"fleet BatchBroker, {n} streams x {FLEET_FRAMES} frames "
            f"(host tracker, one chunk clock; its waits count in proxy): "
            f"{n * FLEET_FRAMES} frames in {wall:.3f} s"
            f" wall = {n * FLEET_FRAMES / wall:.2f} fps aggregate (the "
            f"same runs one after another: {sequential_fps(n):.2f}); "
            f"detector dispatches {broker.dispatches} (solo runs "
            f"{solo_disp}), windows {broker.windows_in}, mean "
            f"batch_fill {float(np.mean(broker.batch_fill)):.4f}; "
            f"stage (wall, thread CPU) s summed over streams "
            f"{stage_sums(res)}; launches {launches}; card {smi}")

    frames = np.stack([pl.render_frame(c, f, *params.det_res)[0]
                       for c in clips for f in range(FLEET_FRAMES)])
    full = (params.det_res[1], params.det_res[0])
    shapes = {shape: max(64, next_bucket(rows))
              for shape, rows in formed.items()}
    shapes.setdefault(full, 64)
    drift = detector_buckets(bank, params, frames, shapes)
    del frames
    worst = max(d for per in drift.values() for d in per.values())
    exact = worst == 0.0
    bound = 2 * worst
    log("fleet: detector batch drift (max |d| of detect_scores against "
        "batch 1) at each bucket of each crop shape: "
        + "; ".join(f"{w}x{h}: " + ", ".join(f"{b} {d!r}"
                                              for b, d in per.items())
                    for (h, w), per in drift.items())
        + f"; largest batch formed per shape {formed}")
    thr = bank.cfg.tracker.match_threshold

    def described(i, kind, flip):
        """One stream's first decision flip, for the log."""
        head = f"; stream {i} (clip {i % len(clips)}): "
        if kind == "assignment":
            how, k = flip[:2]
            if how == "gate":
                return head + (f"assignment {k} gated entries {flip[2]} "
                               "off the match threshold")
            return head + (f"assignment {k} swapped pairs "
                           + ("tied within the drift" if how == "tie" else
                              f"each {flip[4]!r} / {flip[5]!r} from its "
                              "exact optimum (limit "
                              f"{DEVICE_JV_GAP!r})")
                           + f" (dearer by {flip[2]!r} at the solo costs, "
                           f"limit {flip[3]!r})")
        return head + ", ".join(
            f"window call {k} row {b} "
            + ("cells reordered" if cells == "order" else
               "crossed " + " ".join(
                   f"{w!r}->{g!r} ({w - conf:+.3e} from det_conf)"
                   for w, g in cells))
            for k, b, cells in flip)

    for n, (res, score_log) in brokered.items():
        # one stream's lone requests run what its solo run does
        rule = exact or n == 1
        limit = 0.0 if rule else bound
        moved, flipped = 0.0, {}
        for i, r in enumerate(res):
            c = i % len(clips)
            d, flip = held_to(r, solo[c], score_log, solo_log, (i, c), rule,
                              bound, conf, thr,
                              f"BatchBroker, {n} streams, stream {i}")
            moved = max(moved, d)
            if flip is not None:
                flipped[i] = flip
        kinds = [kind for kind, _ in flipped.values()]
        log(f"fleet BatchBroker, {n} streams: detector scores within "
            f"{moved!r} of the solo runs' (limit {limit!r}"
            + (")" if rule else ", twice the largest drift)")
            + f"; streams whose decisions flipped: {len(flipped)} of {n} "
            f"({kinds.count('window')} in a detector window, "
            f"{kinds.count('assignment')} in a host-tracker assignment)"
            + "".join(described(i, kind, fl)
                      for i, (kind, fl) in flipped.items())
            + "; every stream without a flip has its solo run's tracks "
            + ("bit for bit" if rule else
               f"within rtol {BOX_RTOL} / atol {BOX_ATOL} (same frames, "
               "ids and counters)"))

    gap, n_assigns = largest_gap(solo_log,
                                 *(lg for _, lg in brokered.values()))
    log(f"fleet: the host JV's largest gap from the exact optimum over the "
        f"{n_assigns} assignments of the solo and brokered runs {gap!r} "
        f"(limit {DEVICE_JV_GAP!r})")

    # TrackBroker: every stream's device steps ride shared launches
    for n in FLEET_TRACK_STREAMS:
        broker = TrackBroker()
        res, launches, wall = fleet_run(n, ExecutorOptions(
            device_assign=True, track_broker=broker))
        broker.close()
        for i, r in enumerate(res):
            tracks_agree(r, solo[i % len(clips)], True,
                         f"TrackBroker, {n} streams, stream {i}")
        if launches["track_step"] != broker.dispatches:
            raise AssertionError(
                f"TrackBroker at {n} streams: {launches['track_step']} "
                f"track_step launches, {broker.dispatches} dispatches")
        if broker.dispatches <= 0 or \
                sum(broker.stream_fill) != broker.steps_in:
            raise AssertionError("TrackBroker's ledger does not add up")
        fleet_launches[f"track_broker_{n}"] = launches
        log(f"fleet TrackBroker (device_assign), {n} streams x "
            f"{FLEET_FRAMES} frames: {n * FLEET_FRAMES} frames in "
            f"{wall:.3f} s wall = {n * FLEET_FRAMES / wall:.2f} fps "
            f"aggregate (the host tracker's solo runs one after another: "
            f"{sequential_fps(n):.2f}); track_step launches "
            f"{launches['track_step']} = dispatches, steps "
            f"{broker.steps_in}, K mean "
            f"{float(np.mean(broker.stream_fill)):.3f} max "
            f"{max(broker.stream_fill)}; stage (wall, thread CPU) s summed "
            f"over streams {stage_sums(res)}; tracks equal the solo host "
            f"runs' bit for bit; card {smi}")

    # run_clips on fresh frames with the shared decode pool
    for w in FLEET_POOLS:
        pl.clear_render_cache()
        (res, _), launches, wall = counted(lambda: run_clips(
            bank, params, clips, ExecutorOptions(decode_workers=w)))
        for i, (r, want) in enumerate(zip(res, solo)):
            tracks_agree(r, want, True, f"run_clips, clip {i}")
        fleet_launches[f"run_clips_{w}"] = launches
        log(f"fleet run_clips, decode_workers {w} (pool of {max(2, w)}), "
            f"{len(clips)} fresh clips x {FLEET_FRAMES} frames: "
            f"{len(clips) * FLEET_FRAMES} frames in {wall:.3f} s wall = "
            f"{len(clips) * FLEET_FRAMES / wall:.2f} fps (the solo runs "
            f"on fresh frames one after another: "
            f"{len(clips) * FLEET_FRAMES / fresh_wall:.2f}); decode "
            f"{stage_sums(res)['decode']} s (wall, thread CPU) summed over "
            f"the clips; stage sums {stage_sums(res)}; tracks equal the "
            f"per-clip runs' bit for bit; launches {launches}; card {smi}")
    log(f"fleet phase: {time.perf_counter() - t_phase:.1f} s wall")
    return fleet_launches


# ---------------------------------------------------------------------------
# Live ingest: the track store, segment appends and standing queries
# ---------------------------------------------------------------------------

def packed_equal(got, want, label: str) -> None:
    """Two packed clips bit for bit but for the timing field: rows,
    offsets, index arrays (all numpy), summary, counters, frame span."""
    for k in ("rows", "offsets", "hist", "track_bbox"):
        x, y = getattr(got, k), getattr(want, k)
        if type(x) is not np.ndarray or type(y) is not np.ndarray:
            raise AssertionError(f"{label}: {k} is {type(x).__name__}, "
                                 "not a numpy array")
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{label}: {k} differs")
    for k in ("summary", "counters", "n_frames", "fps", "watermark"):
        if getattr(got, k) != getattr(want, k):
            raise AssertionError(f"{label}: {k} {getattr(got, k)} against "
                                 f"{getattr(want, k)}")


def as_run(packed) -> Any:
    """A packed clip read as a ``RunResult`` (its tracks and counters),
    for the fleet's comparisons."""
    f, w, full, skip = packed.counters
    return pl.RunResult(packed.tracks(), packed.seconds, f, w, full, skip)


def rows_by_shape(rows: list) -> list:
    """One stream's logged detector rows, concatenated per crop shape in
    the order they came.  Within a size class windows come frame by
    frame whatever the chunks, so a clip appended in segments and the
    same clip in one run list each shape's rows in the same order."""
    out: Dict[tuple, list] = {}
    for r in rows:
        out.setdefault(r.shape[1:], []).append(r)
    return [np.concatenate(out[k]) for k in sorted(out)]


def held_to(got, want, got_log, want_log, streams, exact, bound, conf,
            thr, label, by_shape=False):
    """A brokered stream's run against its solo run, or a live clip
    against the batch-ingested one (both as ``RunResult``s), from their
    ``ScoreLog``s (``streams``: the stream's key there, the solo run's;
    ``by_shape``: detector rows grouped by crop shape, as segments move
    windows between calls).  Every detector score lies within ``bound``
    of its solo value, or equals it where ``exact`` (no drift read, or
    one stream's lone requests).  A window whose kept cells differ, each
    crossing score within ``bound`` of det_conf, or a first differing
    host-tracker assignment that ``assignment_flip`` explains, is a
    decision flip, and none may flip where ``exact``.  A run with a flip
    holds its counters only; the rest hold the solo run's tracks, bit
    for bit where ``exact``, else within the tolerances.  -> (the
    largest score difference, the flip or None)."""
    group = rows_by_shape if by_shape else list
    g, w = streams
    d, flips = score_flips(group(got_log.rows.get(g, [])),
                           group(want_log.rows.get(w, [])), conf, label)
    limit = 0.0 if exact else bound
    if d > limit:
        raise AssertionError(f"{label}: detector scores {d!r} from the "
                             f"solo run's, beyond {limit!r}")
    for k, b, cells in flips:
        if cells != "order" and any(abs(v - conf) > bound
                                    for v, _ in cells):
            raise AssertionError(f"{label}: call {k} row {b} flipped at "
                                 f"{cells}")
    flip = ("window", flips) if flips else None
    if flip is None:
        af = assignment_flip(got_log.assigns.get(g, []),
                             want_log.assigns.get(w, []), thr, label)
        flip = None if af is None else ("assignment", af)
    if flip is not None and exact:
        raise AssertionError(f"{label}: a decision flipped with no drift")
    if flip is None:
        tracks_agree(got, want, exact, label)
    else:
        counters_agree(got, want, label)
        check_result(got, want.frames_processed)
    return d, flip


def summed_dispatches(results) -> dict:
    """Device dispatches per stage, summed over runs or appends."""
    out: Dict[str, int] = {}
    for r in results:
        for k, n in r.dispatches.items():
            out[k] = out.get(k, 0) + n
    return out


def ms_quantiles(seconds: list) -> str:
    v = sorted(s * 1e3 for s in seconds)
    return (f"p50 {interp_quantile(v, 0.5):.3f} p95 "
            f"{interp_quantile(v, 0.95):.3f} ms (n {len(v)})")


def run_live(bank, params) -> dict:
    """Live ingest at full width, at the video cell's θ (``refine`` off,
    as live ingest requires): caldot1 test clips 0-2 at ``LIVE_FRAMES``
    frames, each store in its own temporary directory.

    1. batch: ``TrackStore.ingest`` through ``run_clips``; each stored
       clip is ``PackedTracks.pack`` of its own ``ClipExecutor`` run bit
       for bit (timing aside), and a second ingest calls no detector;
    2. live, aligned: a ``SegmentIngestor`` appends each clip in
       segments of one chunk (round robin over the clips), with two
       standing queries registered on the store's ``QueryService``; each
       sealed clip equals the batch one bit for bit;
    3. live, unaligned: clip 0 in segments of ``LIVE_ODD_SEG`` frames,
       held to the batch clip as the fleet holds a brokered stream
       (flips counted);
    4. resume: clip 1 checkpointed half way, the ingestor dropped, a
       new one resumes and seals, bit for bit; and a rollback to a stale
       checkpoint (``checkpoint_every=2``);
    5. TRACK on the device: clip 0 appended with ``device_assign`` equals
       its batch ingest under the same options bit for bit, and a host
       checkpoint resumes under ``device_tracker``;
    6. a live fleet: three feeds, an ingestor each on one store, one
       shared ``BatchBroker``, appending from their own threads in
       rounds of one segment a feed with a barrier between rounds; held
       as in step 3;
    7. queries: after sealing, each standing answer equals the ad-hoc
       ``QueryService.query`` on the store and ``reference_query``,
       exactly; the ad-hoc queries timed cold and warm.

    Launch counts are set to 0 just before each step and read just
    after.  -> the launches of each step."""
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    conf, thr = params.det_conf, bank.cfg.tracker.match_threshold
    clips = [make_clip("caldot1", "test", SEED + i, n_frames=LIVE_FRAMES)
             for i in range(LIVE_CLIPS)]
    n_all = LIVE_FRAMES * LIVE_CLIPS
    launches, walls = {}, {}
    formed: Dict[tuple, int] = {}

    def forming(fn):
        def wrapper(self, frames, *args, **kwargs):
            shape = tuple(frames.shape[1:3])
            formed[shape] = max(formed.get(shape, 1), int(frames.shape[0]))
            return fn(self, frames, *args, **kwargs)
        return wrapper

    def step(name, run):
        out, launches[name], walls[name] = counted(run)
        return out

    tmp = []

    def new_root() -> str:
        """A store's own temporary directory (removed at the end)."""
        tmp.append(tempfile.TemporaryDirectory())
        return tmp[-1].name

    try:
        # 1. batch ingest on fresh frames, then the per-clip oracle
        pl.clear_render_cache()
        A = TrackStore(new_root(), bank, params)
        rep = step("batch", lambda: A.ingest(clips))
        if rep.ingested != LIVE_CLIPS or rep.frames != n_all:
            raise AssertionError(f"batch ingest: {rep}")
        for name in ("proxy_plan", "window_gather_batch"):
            if launches["batch"][name] <= 0:
                raise AssertionError(f"{name} was not launched by the "
                                     "batch ingest")
        solo_log, solo = ScoreLog(), []
        with solo_log.recording():
            for i, c in enumerate(clips):
                solo_log.tl.stream = i
                solo.append(ClipExecutor(bank, params).run(c))
        for i, (c, r) in enumerate(zip(clips, solo)):
            check_result(r, LIVE_FRAMES)
            packed_equal(A.get(c), PackedTracks.pack(r.tracks, c, r),
                         f"batch ingest, clip {i}")
        calls = []

        def counting(fn):
            def wrapper(*args, **kwargs):
                calls.append(1)
                return fn(*args, **kwargs)
            return wrapper
        with wrapped(Detector, "detect_batch", counting):
            again = A.ingest(clips)
        if calls or again.ingested or again.cached != LIVE_CLIPS:
            raise AssertionError(f"re-ingest: {len(calls)} detector "
                                 f"calls, {again}")
        batch_fps = n_all / rep.wall_seconds
        log(f"live 1, batch: TrackStore.ingest of clips 0-"
            f"{LIVE_CLIPS - 1} x {LIVE_FRAMES} frames on fresh frames "
            f"(run_clips): {rep.wall_seconds:.3f} s = {batch_fps:.2f} fps; "
            f"store {rep.store_bytes} bytes; each clip equals its own "
            f"ClipExecutor run bit for bit (timing aside); tracks "
            f"{[len(r.tracks) for r in solo]}; a second ingest: 0 detector "
            f"calls, {again.cached} cached; launches {launches['batch']}")

        # 2. live, aligned, with standing queries on the store's service
        B = TrackStore(new_root(), bank, params)
        svc = QueryService(B)
        queries = {
            "region_count": Query.count_frames(
                region=(0.0, 0.4, 1.0, 1.0), min_count=2),
            "time_tracks": Query.count_tracks(
                min_track_len=3, time_range=TimeRange(8, LIVE_FRAMES - 8)),
        }
        standing = {k: svc.register_standing(StandingQuery(q, clips, k))
                    for k, q in queries.items()}
        ing = SegmentIngestor(B, service=svc)
        reports, rescan_rows = [], 0
        visible = [0] * LIVE_CLIPS

        def aligned():
            nonlocal rescan_rows
            for c in clips:
                ing.open(c)
            for _ in range(0, LIVE_FRAMES, LIVE_SEG):
                for i, c in enumerate(clips):
                    r = ing.append(c, LIVE_SEG)
                    reports.append(r)
                    visible[i] = r.rows_total
                    rescan_rows += sum(visible)
        pl.clear_render_cache()
        step("live_aligned", aligned)
        for i, c in enumerate(clips):
            packed_equal(B.get(c), A.get(c), f"live, {LIVE_SEG}-frame "
                         f"segments, clip {i}")
        if not all(r.sealed for r in reports[-LIVE_CLIPS:]):
            raise AssertionError("a live clip did not seal")
        live_fps = n_all / walls["live_aligned"]
        lag = [REGISTRY.gauge(f"stream.watermark_lag_seconds[caldot1/"
                              f"test{SEED + i}]").value
               for i in range(LIVE_CLIPS)]
        log(f"live 2, aligned: {len(reports)} appends of {LIVE_SEG} frames "
            f"(round robin) on fresh frames in {walls['live_aligned']:.3f} "
            f"s = {live_fps:.2f} fps (batch {batch_fps:.2f}); append wall "
            f"{ms_quantiles([r.wall_seconds for r in reports])}; store "
            f"{ms_quantiles([r.store_seconds for r in reports])}; standing "
            f"{ms_quantiles([r.standing_seconds for r in reports])}; "
            f"watermark lag of the last appends {lag} s; dispatches summed "
            f"over the appends {summed_dispatches(reports)} (the batch "
            f"runs' {summed_dispatches(solo)}); each sealed clip "
            f"equals the batch one bit for bit; launches "
            f"{launches['live_aligned']}; card {smi}")

        # 3. live, unaligned: other chunks, so other detector batches
        B3 = TrackStore(new_root(), bank, params)
        ing3 = SegmentIngestor(B3)
        odd_log, odd = ScoreLog(), []

        def unaligned():
            odd_log.tl.stream = 0
            ing3.open(clips[0])
            while not odd or not odd[-1].sealed:
                odd.append(ing3.append(clips[0], LIVE_ODD_SEG))
        with odd_log.recording(), wrapped(Detector, "detect_batch",
                                          forming):
            step("live_unaligned", unaligned)

        # 4. resume from a checkpoint, and roll back to a stale one
        mid = LIVE_FRAMES // 2

        def resume():
            root = new_root()
            first = SegmentIngestor(TrackStore(root, bank, params))
            first.open(clips[1])
            first.append(clips[1], mid)
            del first
            st = TrackStore(root, bank, params)
            second = SegmentIngestor(st)
            if second.open(clips[1]) != mid:
                raise AssertionError("resume: wrong watermark")
            second.seal(clips[1])
            packed_equal(st.get(clips[1]), A.get(clips[1]),
                         "resumed clip 1")
            # the checkpoint taken at open, then an append that writes
            # none: the store runs a segment ahead of its sidecar
            root = new_root()
            first = SegmentIngestor(TrackStore(root, bank, params),
                                    checkpoint_every=2)
            first.open(clips[1])
            first.checkpoint(clips[1])
            first.append(clips[1], LIVE_SEG)
            del first
            st = TrackStore(root, bank, params)
            if st.get(clips[1]).watermark != LIVE_SEG:
                raise AssertionError("rollback: the store is not ahead")
            second = SegmentIngestor(st)
            if second.open(clips[1]) != 0 or st.watermark(clips[1]) != 0:
                raise AssertionError("rollback: wrong watermark")
            second.seal(clips[1])
            packed_equal(st.get(clips[1]), A.get(clips[1]),
                         "clip 1 rolled back to a stale checkpoint")
        step("resume", resume)
        log(f"live 4, resume: clip 1 checkpointed at {mid} frames, resumed "
            f"by a new ingestor and sealed; and rolled back from "
            f"{LIVE_SEG} frames to the checkpoint taken at open "
            f"(checkpoint_every=2): both equal the batch clip bit for bit; "
            f"{walls['resume']:.3f} s; launches {launches['resume']}")

        # 5. TRACK on the device
        def device_track():
            dopts = ExecutorOptions(device_assign=True)
            D = TrackStore(new_root(), bank, params, dopts)
            D.ingest(clips[:1])
            L = TrackStore(new_root(), bank, params)
            di = SegmentIngestor(L, options=dopts)
            di.open(clips[0])
            while not di.append(clips[0], LIVE_SEG).sealed:
                pass
            packed_equal(L.get(clips[0]), D.get(clips[0]),
                         "device_assign live clip 0 against its batch")
            packed_equal(L.get(clips[0]), A.get(clips[0]),
                         "device_assign live clip 0 against the host's")
            root = new_root()
            hi = SegmentIngestor(TrackStore(root, bank, params))
            hi.open(clips[0])
            hi.append(clips[0], mid)
            del hi
            st = TrackStore(root, bank, params)
            dt = SegmentIngestor(st, options=ExecutorOptions(
                device_tracker=True))
            dt.open(clips[0])
            dt.seal(clips[0])
            packed_equal(st.get(clips[0]), A.get(clips[0]),
                         "host checkpoint resumed under device_tracker")
        step("device_track", device_track)
        if launches["device_track"]["track_step"] <= 0:
            raise AssertionError("track_step was not launched by the "
                                 "device-TRACK appends")
        log(f"live 5, TRACK on the device: clip 0 appended with "
            f"device_assign equals its device_assign batch ingest and the "
            f"host one bit for bit; a host checkpoint at {mid} "
            f"frames resumed under device_tracker equals the batch clip; "
            f"{walls['device_track']:.3f} s; launches "
            f"{launches['device_track']}")

        # 6. a live fleet through one BatchBroker
        F = TrackStore(new_root(), bank, params)
        broker = BatchBroker()
        opts = ExecutorOptions(batch_broker=broker)
        meet = threading.Barrier(LIVE_CLIPS)
        fleet_log = ScoreLog()

        def feed(i):
            fleet_log.tl.stream = i
            fi = SegmentIngestor(F, options=opts)
            fi.open(clips[i])
            reps = []
            try:
                while not reps or not reps[-1].sealed:
                    meet.wait(LIVE_JOIN_S)
                    reps.append(fi.append(clips[i], LIVE_SEG))
            except BaseException:
                meet.abort()             # no peer waits out the round
                raise
            return reps
        with fleet_log.recording(), wrapped(Detector, "detect_batch",
                                            forming):
            feeds = step("live_fleet", lambda: run_threads(
                [lambda i=i: feed(i) for i in range(LIVE_CLIPS)],
                LIVE_JOIN_S))
        broker.close()

        # one drift reading bounds steps 3 and 6
        frames = np.stack([pl.render_frame(c, f, *params.det_res)[0]
                           for c in clips for f in range(0, LIVE_FRAMES,
                                                         4)])
        full = (params.det_res[1], params.det_res[0])
        shapes = {shape: max(64, next_bucket(rows))
                  for shape, rows in formed.items()}
        shapes.setdefault(full, 64)
        drift = detector_buckets(bank, params, frames, shapes)
        del frames
        bound = 2 * max(d for per in drift.values() for d in per.values())
        d3, flip3 = held_to(as_run(B3.get(clips[0])), as_run(A.get(clips[0])),
                            odd_log, solo_log, (0, 0), bound == 0.0, bound,
                            conf, thr, f"live, {LIVE_ODD_SEG}-frame segments, "
                            "clip 0", by_shape=True)
        gap, n_assigns = largest_gap(solo_log, odd_log)
        log(f"live 3, unaligned: clip 0 in {len(odd)} appends of "
            f"{LIVE_ODD_SEG} frames (cached frames) in "
            f"{walls['live_unaligned']:.3f} s = "
            f"{LIVE_FRAMES / walls['live_unaligned']:.2f} fps; append wall "
            f"{ms_quantiles([r.wall_seconds for r in odd])}; detector "
            f"scores within {d3!r} of the batch run's (limit {bound!r}, "
            f"twice the largest drift at the buckets formed {formed}); "
            f"decision flips: {0 if flip3 is None else 1} "
            f"({'none' if flip3 is None else flip3}); the host JV's largest "
            f"gap from the exact optimum over the {n_assigns} assignments "
            f"of the batch and these runs {gap!r} (limit "
            f"{DEVICE_JV_GAP!r}); launches "
            f"{launches['live_unaligned']}")

        # 6's readout, held as step 3's
        flips, moved = {}, 0.0
        for i, c in enumerate(clips):
            d, fl = held_to(as_run(F.get(c)), as_run(A.get(c)), fleet_log,
                            solo_log, (i, i), bound == 0.0, bound, conf, thr,
                            f"live fleet, feed {i}", by_shape=True)
            moved = max(moved, d)
            if fl is not None:
                flips[i] = fl
        solo_disp = sum(r.dispatches["detect"] for r in solo)
        if broker.windows_in != sum(F.get(c).counters[1] for c in clips):
            raise AssertionError("the live fleet's BatchBroker lost "
                                 "windows")
        log(f"live 6, fleet: {LIVE_CLIPS} feeds x {LIVE_FRAMES // LIVE_SEG} "
            f"rounds of {LIVE_SEG} frames through one BatchBroker (cached "
            f"frames) in {walls['live_fleet']:.3f} s = "
            f"{n_all / walls['live_fleet']:.2f} fps aggregate; detector "
            f"dispatches {broker.dispatches} (the feeds' solo runs "
            f"{solo_disp}), windows {broker.windows_in}, mean batch_fill "
            f"{float(np.mean(broker.batch_fill)):.4f}; append wall "
            f"{ms_quantiles([r.wall_seconds for f in feeds for r in f])}; "
            f"scores within {moved!r} of the batch runs' (limit {bound!r});"
            f" feeds whose decisions flipped: {len(flips)} of {LIVE_CLIPS} "
            f"{flips}; the rest hold the batch tracks within rtol "
            f"{BOX_RTOL} / atol {BOX_ATOL}; launches "
            f"{launches['live_fleet']}")

        # 7. queries: standing answers against ad-hoc and the oracle
        t0 = time.perf_counter()
        tracks = [B.tracks(c) for c in clips]
        for k, q in queries.items():
            plan = compile_query(q)
            kw = {"time_range": (plan.time_range.start, plan.time_range.end)
                  } if plan.time_range is not None else {}
            if plan.region is not None:
                kw["region"] = (plan.region.x0, plan.region.y0,
                                plan.region.x1, plan.region.y1)
            oracle = reference_query(
                tracks, [c.profile.fps for c in clips], min_len=plan.min_len,
                min_count=plan.min_count, aggregate=q.aggregate, **kw)
            got, adhoc = standing[k].result(), svc.query(q, clips)
            if not (got.aggregates == adhoc.aggregates
                    == oracle["aggregates"]
                    and sorted(got.frames) == adhoc.frames
                    == oracle["frames"]):
                raise AssertionError(
                    f"standing query {k}: {got.aggregates} against ad-hoc "
                    f"{adhoc.aggregates} and the oracle "
                    f"{oracle['aggregates']}")
        cold_svc = QueryService(TrackStore(B.root, None, params))
        timed = {}
        for k, q in queries.items():
            t1 = time.perf_counter()
            cold = cold_svc.query(q, clips)
            t2 = time.perf_counter()
            warm = cold_svc.query(q, clips)
            t3 = time.perf_counter()
            if cold.aggregates != warm.aggregates or \
                    cold.stats.ingested_clips or warm.stats.ingested_clips:
                raise AssertionError(f"query {k}: cold and warm differ")
            timed[k] = ((t2 - t1) * 1e3, (t3 - t2) * 1e3,
                        cold.aggregates)
        walls["queries"] = time.perf_counter() - t0
        rows = sum(len(B.get(c).rows) for c in clips)
        log(f"live 7, queries: standing answers equal ad-hoc and "
            f"reference_query exactly ({ {k: timed[k][2] for k in timed} });"
            f" rows scanned by the standing queries "
            f"{ {k: sq.rows_scanned for k, sq in standing.items()} } "
            f"(skipped {({k: sq.rows_skipped for k, sq in standing.items()})}"
            f") against {rows} rows in the store and {rescan_rows} that an "
            f"ad-hoc re-scan at every watermark reads; ad-hoc query ms "
            f"cold (NPZs from disk), warm: "
            f"{ {k: (round(v[0], 3), round(v[1], 3)) for k, v in timed.items()} }")
    finally:
        for t in tmp:
            t.cleanup()
    wall = time.perf_counter() - t_phase
    log(f"live phase: {wall:.1f} s wall; steps (s) "
        f"{ {k: round(v, 3) for k, v in walls.items()} }; card {smi}")
    return launches


VIDEO_COUNTERS = (proxy_plan, window_gather_batch, track_step,
                  assign_batch, proxy_score, window_gather)
# the kernels the fleet's paths launch
FLEET_KERNELS = ("proxy_plan", "window_gather_batch", "track_step")


def counted(run):
    """Run ``run`` with every video kernel's launch count set to 0 just
    before it; -> (result, launches, wall seconds)."""
    for k in VIDEO_COUNTERS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in VIDEO_COUNTERS}, \
        time.perf_counter() - t0


def run_video() -> tuple:
    """The video paths: every check and run above but the fleet; -> (their
    six kernels' records, the bank, θ)."""
    bank = make_bank(DEVICE)
    clip = make_clip("caldot1", "test", SEED, n_frames=N_FRAMES)
    params, frames, feat, first_plan = set_up(bank, clip)
    pres = params.proxy_res
    grid_hw = pl.det_grid(params.det_res)[::-1]
    enc = bank.proxies[pres].encoder

    floor_ms = launch_floor_ms()
    wg, wg_rows = check_window_gather(frames, first_plan)
    wg1 = check_window_gather_single(frames[0])
    with torch.inference_mode():
        pp = check_proxy_plan(feat, enc.head_w, enc.head_b,
                              params.proxy_threshold, grid_hw)
    ps = check_proxy_score(feat, enc.head_w, enc.head_b,
                           params.proxy_threshold)
    check_against_cpu(bank, frames, feat, pres)

    asg = check_assign()
    ts = check_track_step()

    # the main path through its entry point, the launch counts set to 0
    # just before each run and read just after.  Run 1 is cold (cuDNN
    # and allocator warm-up at every shape); run 2, on another clip of
    # the same profile, is warm with decode paid in full (fps); run 3
    # repeats run 1's clip, which must give the same tracks.  Then TRACK
    # on the device, both flavours, on run 1's clip: the tracks must be
    # the host tracker's, array for array.
    clip2 = make_clip("caldot1", "test", SEED + 1, n_frames=N_FRAMES)
    runs = {}
    for label, c, opts in (
            ("cold", clip, None), ("warm", clip2, None),
            ("repeat", clip, None),
            ("device_tracker", clip, ExecutorOptions(device_tracker=True)),
            ("device_assign", clip, ExecutorOptions(device_assign=True))):
        res, launches, wall = counted(
            lambda: pl.run_clip(bank, params, c) if opts is None
            else ClipExecutor(bank, params, opts).run(c))
        check_result(res, N_FRAMES)
        on_path = ["proxy_plan", "window_gather_batch"]
        if launches["proxy_score"] or launches["window_gather"]:
            raise AssertionError("the fused streaming path launched a "
                                 "per-frame or unfused kernel")
        if opts is None:
            if launches["track_step"]:
                raise AssertionError("the host tracker launched track_step")
        else:
            on_path.append("track_step")
        for name in on_path:
            if launches[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"main path ({label} run)")
        runs[label] = (res, launches)
        log(f"main path ({label}, clip {c.clip_id}): {N_FRAMES} frames in "
            f"{wall:.3f} s wall = {N_FRAMES / wall:.2f} fps; windows "
            f"{res.detector_windows}, full frames {res.full_frames}, "
            f"skipped {res.skipped_frames}, tracks {len(res.tracks)}; "
            f"dispatches {res.dispatches}; launches {launches}")
        log(f"  stage_seconds {json.dumps(res.stage_seconds)}")
    res, launches = runs["cold"]
    res3, launches3 = runs["repeat"]
    if launches != launches3 or not same_tracks(res, res3):
        raise AssertionError("two runs of the main path differ")
    for label in ("device_tracker", "device_assign"):
        dres = runs[label][0]
        if not same_tracks(res, dres):
            raise AssertionError(f"{label}: tracks differ from the host "
                                 "tracker's on the same clip")
        for k in ("frames_processed", "detector_windows", "full_frames",
                  "skipped_frames"):
            if getattr(dres, k) != getattr(res, k):
                raise AssertionError(f"{label}: RunResult.{k} differs")
        for k in ("proxy", "detect"):
            if dres.dispatches[k] != res.dispatches[k]:
                raise AssertionError(f"{label}: dispatches[{k!r}] differs")
        log(f"{label}: {len(dres.tracks)} tracks identical to the host "
            "tracker's, array for array; counters equal (track dispatches "
            f"{dres.dispatches['track']} against {res.dispatches['track']})")

    # the per-frame engine on clip 0 (frames cached), twice: batch-1
    # proxy through proxy_score, crops through the single-frame gather
    frame_runs = []
    for i in range(2):
        fres, flaunch, fwall = counted(
            lambda: pl.run_clip(bank, params, clip, engine="frame"))
        check_result(fres, N_FRAMES)
        for name in ("proxy_score", "window_gather"):
            if flaunch[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     "per-frame path")
        for name in ("proxy_plan", "window_gather_batch", "track_step"):
            if flaunch[name]:
                raise AssertionError(f"the per-frame path launched {name}")
        frame_runs.append((fres, flaunch))
        log(f"per-frame engine (run {i + 1}, clip {clip.clip_id}, frames "
            f"cached): {N_FRAMES} frames in {fwall:.3f} s wall = "
            f"{N_FRAMES / fwall:.2f} fps; windows {fres.detector_windows}, "
            f"full frames {fres.full_frames}, skipped "
            f"{fres.skipped_frames}, tracks {len(fres.tracks)}; launches "
            f"{flaunch}; stage_seconds {fres.stage_seconds}")
    fres, flaunch = frame_runs[0]
    if flaunch != frame_runs[1][1] or not same_tracks(fres, frame_runs[1][0]):
        raise AssertionError("two per-frame runs differ")
    log(f"per-frame engine: both runs give the same {len(fres.tracks)} "
        "tracks and launch counts; the streaming repeat of the same clip "
        f"planned {res3.detector_windows} windows against "
        f"{fres.detector_windows}")

    engine_drift(bank, params, clip)

    # the unfused proxy path: one proxy_score launch per chunk
    ures, ulaunch, uwall = counted(lambda: ClipExecutor(
        bank, params, ExecutorOptions(fused_plan=False)).run(clip))
    check_result(ures, N_FRAMES)
    if ulaunch["proxy_score"] <= 0 or ulaunch["proxy_plan"]:
        raise AssertionError(f"fused_plan=False launches {ulaunch}")
    compared, in_band = compare_plans(bank, params, clip)
    log(f"fused_plan=False (clip {clip.clip_id}): {N_FRAMES} frames in "
        f"{uwall:.3f} s wall = {N_FRAMES / uwall:.2f} fps; launches "
        f"{ulaunch}; plans equal the fused path's on {compared} frames, "
        f"{in_band} frames with a proxy cell in the flip band")
    if in_band == 0:
        if not same_tracks(res, ures):
            raise AssertionError("fused_plan=False: tracks differ from the "
                                 "fused run's with no cell in the band")
        log(f"fused_plan=False: {len(ures.tracks)} tracks identical to the "
            "fused run's, array for array")

    # refinement: a refiner from the streaming run's tracks on a train
    # clip, then both engines on clip 0 with θ's refine on
    train = make_clip("caldot1", "train", SEED, n_frames=N_FRAMES)
    train_tracks = pl.run_clip(bank, params, train).tracks
    refiner = TrackRefiner(bank.cfg.refine, train_tracks,
                           frame_scale=1.0 / params.det_res[0])
    bank.refiner = refiner
    params_r = dataclasses.replace(params, refine=True)
    try:
        rs = pl.run_clip(bank, params_r, clip)
        rf = pl.run_clip(bank, params_r, clip, engine="frame")
    finally:
        bank.refiner = None
    ext_s = check_refined(rs, res, "streaming")
    ext_f = check_refined(rf, fres, "per-frame")
    log(f"refinement: {len(refiner.clusters)} path clusters from "
        f"{len(train_tracks)} tracks of the streaming run on caldot1 train "
        f"clip {SEED}; streaming run "
        f"extended {ext_s} of {len(rs.tracks)} tracks, per-frame run "
        f"{ext_f} of {len(rf.tracks)}; every refined track contains its "
        "unrefined rows unchanged")

    # quality readout (untrained weights: a readout, not a gate)
    quality = {}
    for label, r in (("streaming", res), ("frame", fres)):
        m_host = mota(r.tracks, clip, assign="host")
        assign_batch.launches = 0
        m_batch = mota(r.tracks, clip, assign="batch", device=DEVICE)
        torch.cuda.synchronize()
        n_asg = assign_batch.launches
        if n_asg <= 0:
            raise AssertionError("the batch MOTA did not launch assign")
        acc = clip_count_accuracy(r.tracks, clip)
        quality[label] = dict(mota_host=m_host, mota_batch=m_batch,
                              count_accuracy=acc, assign_launches=n_asg)
        log(f"quality ({label} run, clip {clip.clip_id}, untrained "
            f"weights): MOTA host {m_host!r} | batch {m_batch!r} "
            f"({n_asg} assign launch); count accuracy {acc!r}")

    clip3 = make_clip("caldot1", "test", SEED + 2, n_frames=N_FRAMES)
    device_busy(bank, params, clip3)
    device_busy(bank, params, clip3, ExecutorOptions(device_tracker=True),
                "device tracker, frames cached")
    device_busy(bank, params, clip3, ExecutorOptions(device_assign=True),
                "device assign, frames cached")
    # the per-frame engine on clip 0, where its fps runs were taken
    device_busy(bank, params, clip, label="per-frame engine, frames cached",
                engine="frame")
    frame_breakdown(bank, params, clip)

    src = "src/repro_torch/csrc/"
    dev_launches = runs["device_tracker"][1]
    a_main = asg["N128"]
    t_main = ts[track_check.CASES[0][0]]    # K = 1, the main path's shape
    kernels = [
        dict(name="proxy_plan", route="cuda", source=src + "proxy_plan.cu",
             replaces="src/repro/kernels/proxy_plan/kernel.py:67",
             design="one block of 512 per frame: the frame's features, w "
                    "and spans in one wave of bulk copies into shared "
                    "memory (ordinary loads where unaligned), head 4 "
                    "threads a cell, spans as bitmasks, grid by AND/OR, "
                    "plan stats; f32 cuda-core",
             launches=launches["proxy_plan"],
             max_abs_err=pp["max_abs_err"],
             ms=pp["ms"], plain_ms=pp["plain_ms"], bound_ms=pp["bound_ms"],
             bound_by=pp["bound_by"], library_ms=None,
             device_ms=pp["device_ms"], host_us=pp["host_us"],
             copy_back_us=pp["copy_back_us"],
             copy_back_two_us=pp["copy_back_two_us"],
             flips=pp["flips"], launch_floor_device_ms=floor_ms),
        dict(name="window_gather_batch", route="cuda",
             source=src + "window_gather.cu",
             replaces="src/repro/kernels/window_gather/kernel.py:76",
             design="one block per (window, band of rows), every 16-byte "
                    "load of the band issued before the first store; a "
                    "host table's rows carried by the launch as a kernel "
                    "parameter (scalar copies where unaligned)",
             launches=launches["window_gather_batch"],
             max_abs_err=wg["max_abs_err"], ms=wg["ms"],
             plain_ms=wg["plain_ms"], bound_ms=wg["bound_ms"],
             bound_by=wg["bound_by"], library_ms=None,
             device_ms=wg["device_ms"], copy_device_ms=wg["copy_device_ms"],
             launch_floor_device_ms=floor_ms,
             shape=f"{wg['n']} windows of {wg['size']} cells",
             cases={r["case"]: {f: r[f] for f in (
                 "n", "ms", "device_ms", "copy_device_ms", "bound_ms")}
                 for r in wg_rows}),
        dict(name="track_step", route="cuda", source=src + "track_step.cu",
             replaces="src/repro/kernels/track_step/kernel.py:160",
             design="feature, cost (a thread per pair and hidden unit), "
                    "JV (one warp per stream, state in registers) and GRU "
                    "kernels, f32 cuda-core, bit-matched (-fmad=false)",
             launches=dev_launches["track_step"],
             launches_device_assign=runs["device_assign"][1]["track_step"],
             max_abs_err=t_main["max_abs_err"], ms=t_main["ms"],
             plain_ms=t_main["plain_ms"], bound_ms=t_main["bound_ms"],
             bound_by=t_main["bound_by"], library_ms=None,
             device_ms=t_main["device_ms"],
             device_ms_parts=t_main["device_ms_parts"],
             jv_steps=t_main["steps"][0],
             jv_ns_per_step=t_main["ns_per_step"],
             shape=f"K=1 Q={t_main['Q']}, {t_main['live_pairs']} live pairs",
             cases={k: {f: r[f] for f in ("ms", "device_ms",
                                          "device_ms_parts", "steps",
                                          "ns_per_step", "bound_ms")}
                    for k, r in ts.items()}),
        dict(name="proxy_score", route="cuda", source=src + "proxy_score.cu",
             replaces="src/repro/kernels/proxy_score/kernel.py:40",
             design="one warp per cell row, f32 cuda-core",
             launches=flaunch["proxy_score"],
             launches_unfused=ulaunch["proxy_score"],
             max_abs_err=ps[1]["max_abs_err"], ms=ps[1]["ms"],
             plain_ms=ps[1]["plain_ms"], bound_ms=ps[1]["bound_ms"],
             bound_by=ps[1]["bound_by"], library_ms=None,
             device_ms=ps[1]["device_ms"], flips=ps[1]["flips"],
             shape=str(ps[1]["shape"]),
             chunk={k: ps[16][k] for k in ("shape", "max_abs_err", "flips",
                                           "ms", "device_ms", "plain_ms",
                                           "bound_ms")}),
        dict(name="window_gather", route="cuda",
             source=src + "window_gather.cu",
             replaces="src/repro/kernels/window_gather/kernel.py:40",
             design="one block per (window, window row), 16-byte copies",
             launches=flaunch["window_gather"],
             max_abs_err=wg1[0]["max_abs_err"], ms=wg1[0]["ms"],
             plain_ms=wg1[0]["plain_ms"], bound_ms=wg1[0]["bound_ms"],
             bound_by=wg1[0]["bound_by"], library_ms=None,
             device_ms=wg1[0]["device_ms"],
             shape=f"{wg1[0]['n']} windows of {wg1[0]['size']} cells",
             large={k: wg1[1][k] for k in ("size", "n", "ms", "device_ms",
                                           "plain_ms", "bound_ms")}),
        dict(name="assign_batch", route="cuda", source=src + "assign.cu",
             replaces="src/repro/kernels/assign/kernel.py:118",
             design="JV, one warp per matrix, state in registers (shared "
                    "memory past 287 columns), bit-matched (-fmad=false)",
             launches=quality["streaming"]["assign_launches"],
             launches_device_tracker=dev_launches["assign_batch"],
             launches_from="metrics.mota(assign='batch')",
             solve_runs_in="track_step (jv.cuh), once per launch",
             max_abs_err=a_main["max_abs_err"], ms=a_main["ms"],
             plain_ms=a_main["plain_ms"], plain_on="cpu",
             bound_ms=a_main["bound_ms"], bound_by=a_main["bound_by"],
             library_ms=None, device_ms=a_main["device_ms"],
             jv_steps=max(a_main["steps"]),
             jv_ns_per_step=a_main["ns_per_step"],
             shape=f"K=4 N={a_main['N']}",
             cases={k: {f: r[f] for f in ("ms", "device_ms", "steps",
                                          "ns_per_step")}
                    for k, r in asg.items()}),
    ]
    return kernels, bank, params


# ---------------------------------------------------------------------------
# LM serving: flash_attention (prefill) and decode_attention (decode)
# ---------------------------------------------------------------------------

def attn_bound(n_bytes, n_ops, dtype):
    """(bound ms, by) at the dtype's tensor-core peak (bf16; f32 as
    3xTF32, the way flash_attention and ssd_scan compute it), and the
    f32 CUDA-core line beside it."""
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32X3_OPS_PER_S
    b_ms, b_by = bound(n_bytes, n_ops, rate)
    return b_ms, b_by, bound(n_bytes, n_ops, F32_OPS_PER_S)[0]


def op_device_ms(fn, op_name: str, reps: int = 20):
    """Device time per call of every kernel that the host op ``op_name``
    (an ``aten::`` op, children included) launches within ``fn``, with
    the L2 overwritten before each call as in ``device_ms_by_kernel``;
    None if the profiler attributed no device time to it.  For a library
    call whose kernels' names vary with the dtype (SDPA's f32 path is
    not a flash kernel)."""
    for ev in profiled_cold(fn, reps).key_averages():
        if ev.key == op_name and ev.count:
            total = device_us(ev)
            return total / ev.count / 1e3 if total else None
    return None


def check_flash_attention():
    """The prefill kernel against its plain version on the card
    (``kernels.flash_attention.check``): the serving shape (B 4, S 512,
    Hq 14, Hkv 2, D 64, causal) in bf16 and f32, the prefill's own S 500
    (the ragged edge, masked in the kernel), Sq 128 < Skv 512 causal,
    non-causal, kv_valid 500, and Sq 512 > Skv 256 causal, whose first
    256 rows see no key (they must be 0); then the wrapper's refusals.
    Timed at S 512 and S 500 (the main path's call), both dtypes, beside
    SDPA (its device time: every kernel the call launches).  -> {case:
    record}."""
    timed = {(n, dt) for n in ("S512 causal", "S500 causal")
             for dt in (torch.bfloat16, torch.float32)}
    Hq = flash_check.HQ
    rows = {}
    for i, case in enumerate(flash_check.CASES):
        name, dt, Sq, Skv, causal, kv_valid = case
        q, k, v = flash_check.case_operands(case, DEVICE, SEED + i)
        label = f"flash_attention {name} {dt}"
        err = flash_check.check_flash(q, k, v, causal, kv_valid, label)
        row = dict(case=name, dtype=str(dt).split(".")[-1],
                   B=flash_check.B, Sq=Sq, Skv=Skv, causal=causal,
                   kv_valid=kv_valid, max_abs_err=err)
        if (name, dt) in timed:
            n_valid = kv_valid or Skv
            qpos = np.arange(Sq) + (Skv - Sq)
            seen = np.clip(np.minimum(qpos + 1, n_valid) if causal
                           else np.full(Sq, n_valid), 0, None)
            n_ops = q.shape[0] * Hq * 4 * flash_check.D * int(seen.sum())
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            b_ms, b_by, f32_ms = attn_bound(n_bytes, n_ops, dt)

            def kern():
                return flash_attention(q, k, v, causal=causal,
                                       kv_valid=kv_valid)

            def plain():
                return flash_attention_ref(q, k, v, causal=causal,
                                           kv_valid=kv_valid)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal, enable_gqa=True)
            with torch.inference_mode():
                row.update(ms=event_ms(kern, reps=20),
                           device_ms=device_ms(kern, FLASH_KERNEL_NAMES,
                                               reps=20),
                           plain_ms=event_ms(plain, reps=5),
                           library_ms=event_ms(sdpa, reps=20)
                           if Sq == Skv and not kv_valid else None,
                           library_device_ms=op_device_ms(
                               sdpa, "aten::scaled_dot_product_attention"),
                           bound_ms=b_ms, bound_by=b_by,
                           bound_f32_core_ms=f32_ms, flops=n_ops,
                           bytes=n_bytes)
            log(f"{label}: max |d| {err!r}; kernel {row['ms']:.4f} ms/call "
                f"(device, cold L2 {row['device_ms']}), plain "
                f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']} ms "
                f"(device {row['library_device_ms']}), "
                f"bound {b_ms:.5f} ms ({b_by}; {n_ops / 1e9:.3f} GFLOP, "
                f"{n_bytes / 1e6:.2f} MB; f32 CUDA-core line "
                f"{f32_ms:.5f} ms)")
        else:
            log(f"{label}: max |d| {err!r} (within tolerance)")
        rows[(name, row["dtype"])] = row
    check_kernel_of_each_dtype(
        "flash_attention", flash_check,
        lambda dt: flash_check.kernels_launched(
            next(c for c in flash_check.CASES if c[1] == dt), DEVICE,
            reps=20))
    flash_check.check_refusals(DEVICE)
    log("flash_attention: refuses head dim 32 in f32 and bf16")
    return rows


def check_decode_attention():
    """The decode kernel against its plain version on the card
    (``kernels.decode_attention.check``): B 4, S 1024, Hq 14, Hkv 2, D 64
    with kv_len (1, 61, S/2, S) (the serving call, timed) and (0, 64, 65,
    S - 1), and a 16-head group, in bf16 and f32; then the wrapper's
    refusals.  The timed case also records the thread blocks of its
    launch as the profiler's trace holds them (``launch_blocks``).
    -> {dtype: record of the timed case}."""
    rows = {}
    for ci, case in enumerate(decode_check.CASES):
        name, b, S, Hq, Hkv, D, _ = case
        for i, dt in enumerate(decode_check.DTYPES):
            q, k, v, lens = decode_check.case_operands(
                case, dt, DEVICE, SEED + 20 + 2 * ci + i)
            label = f"decode_attention {name} {dt}"
            err = decode_check.check_decode(q, k, v, lens, label)
            if ci:
                log(f"{label}: max |d| {err!r} (within tolerance)")
                continue

            def kern():
                return decode_attention(q, k, v, lens)

            def plain():
                return decode_attention_ref(q, k, v, lens)
            mask = (torch.arange(S, device=DEVICE)[None, :]
                    < lens[:, None])[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)
            keys = int(lens.sum())
            n_bytes = (2 * q.numel() + 2 * keys * Hkv * D) \
                * q.element_size() + lens.numel() * 4
            n_ops = 4 * D * Hq * keys
            b_ms, b_by, f32_ms = attn_bound(n_bytes, n_ops, dt)
            with torch.inference_mode():
                row = dict(dtype=str(dt).split(".")[-1], B=b, S=S,
                           kv_len=lens.tolist(), max_abs_err=err,
                           ms=event_ms(kern), device_ms=device_ms(
                               kern, DECODE_KERNEL_NAMES),
                           plain_ms=event_ms(plain, reps=20),
                           library_ms=event_ms(sdpa), bound_ms=b_ms,
                           bound_by=b_by, bound_f32_core_ms=f32_ms,
                           flops=n_ops, bytes=n_bytes,
                           blocks=launch_blocks(kern, DECODE_KERNEL_NAMES))
            log(f"{label}: max |d| {err!r}; kernel {row['ms']:.4f} ms/call "
                f"(device, cold L2 {row['device_ms']}; thread blocks a "
                f"launch, from the trace: {row['blocks']}), plain "
                f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} "
                f"ms, bound {b_ms:.6f} ms ({b_by}; {n_bytes / 1e6:.3f} MB)")
            rows[row["dtype"]] = row
    decode_check.check_refusals(DEVICE)
    log("decode_attention: refuses a 17-head group and head dim 32")
    err = decode_check.check_graph_replay(DEVICE, SEED + 30)
    log(f"decode_attention: captured in a CUDA graph and replayed after "
        f"kv_len changed in place, max |d| {err!r} (within tolerance)")
    return rows


def recording(store: dict, key: str):
    """A wrapper for ``Model.forward`` / ``Model.decode_step`` that keeps
    a copy of each call's logits under ``store[key]``."""
    def wrap(fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            store.setdefault(key, []).append(out[0].float().clone())
            return out
        return wrapper
    return wrap


@dataclasses.dataclass(frozen=True)
class ServeCell:
    """One LM serving cell: its config; the kernels a generate launches,
    by name, with their wrappers and launches a generate; the swap of
    each for its plain version; the rows held alone against the batch
    and against a fresh prefill (``None``: every row); the planted
    faults; the logit tolerance by activation dtype."""
    cfg: Any
    kernels: Dict[str, Tuple[Callable, int]]
    plain: Tuple[Tuple[Any, str, Callable], ...]
    rows: Optional[Tuple[int, ...]]
    faults: Tuple[Tuple[str, Any, str, Callable, str, bool], ...]
    tol: Dict[str, float]
    # the device kernels behind ``kernels``, by the names a trace gives
    device_names: Tuple[str, ...] = ()

    def counts(self) -> Dict[str, int]:
        return {n: fn.launches for n, (fn, _) in self.kernels.items()}

    def reset(self) -> None:
        for fn, _ in self.kernels.values():
            fn.launches = 0

    def want(self) -> Dict[str, int]:
        return {n: w for n, (_, w) in self.kernels.items()}


def served(eng, prompts, n_new, plain=()):
    """One generate with the prefill and decode logits recorded; each
    ``(owner, attr, plain_fn)`` of ``plain`` swaps a kernel's wrapper for
    its plain version for this run.  -> (tokens, {"prefill": [..],
    "decode": [..]})."""
    logs = {}
    with contextlib.ExitStack() as hooks:
        hooks.enter_context(wrapped(Model, "forward",
                                    recording(logs, "prefill")))
        hooks.enter_context(wrapped(Model, "decode_step",
                                    recording(logs, "decode")))
        for owner, attr, fn in plain:
            hooks.enter_context(wrapped(owner, attr, lambda _, f=fn: f))
        out = eng.generate(prompts, n_new)
    torch.cuda.synchronize()
    return out, logs


def logit_gap(got, want) -> float:
    """max |got - want| in units of the RMS of ``want`` (a row's logits
    spread about that much; its max |logit|, the echo of the input token
    under the tied random init, is an outlier several times larger)."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.pow(2).mean().sqrt())


def logits_close(got, want, label: str, tol: float) -> float:
    """``logit_gap`` held to ``tol``.  -> the gap."""
    gap = logit_gap(got, want)
    if gap > tol:
        raise AssertionError(f"{label}: logits differ by {gap!r} RMS > "
                             f"{tol!r}")
    return gap


def tokens_agree(a, b, lens, logits, tol: float) -> int:
    """Greedy tokens of two runs agree wherever the first run's top-2
    margin exceeds twice the logit tolerance (``tol`` of that row's
    RMS); after the first allowed disagreement in a row the contexts
    differ, so that row stops.  ``logits[s]`` are the logits that chose
    new token s.  -> tokens compared."""
    compared = 0
    for i, n in enumerate(lens):
        for s in range(len(a[i]) - n):
            lg = logits[s][i]
            top2 = torch.topk(lg, 2).values
            if a[i][n + s] != b[i][n + s]:
                margin = tol * float(lg.float().pow(2).mean().sqrt())
                if float(top2[0] - top2[1]) > 2 * margin:
                    raise AssertionError(f"row {i} token {s}: kernel and "
                                         "plain runs differ at a clear "
                                         "margin")
                break
            compared += 1
    return compared


def prefill_logits(model, params, seqs):
    """Logits at the last token of each of ``seqs`` from one fresh
    forward over them, right-padded."""
    width = max(map(len, seqs))
    logits, _, _ = model.forward(
        params, {"tokens": np.array([s + [0] * (width - len(s))
                                     for s in seqs])},
        logits_at=np.array([len(s) - 1 for s in seqs]))
    return logits.float()


def decode_gap(model, params, prompts, out, logs, rows) -> float:
    """The first and the last decode step's logits of ``rows`` against a
    fresh prefill over the same tokens: the larger ``logit_gap``."""
    gaps = []
    for s in (0, len(logs["decode"]) - 1):
        seqs = [out[i][:len(prompts[i]) + s + 1] for i in rows]
        gaps.append(logit_gap(logs["decode"][s][list(rows)],
                              prefill_logits(model, params, seqs)))
    return max(gaps)


def _decode_kv_len_is_pos(fn):
    def wrapper(q, k, v, kv_len, *args, **kwargs):
        return fn(q, k, v, kv_len - 1, *args, **kwargs)
    return wrapper


def _decode_one_late(fn):
    def wrapper(self, params, token, pos, cache):
        return fn(self, params, token, pos + 1, cache)
    return wrapper


def _decode_without_rope(fn):
    def wrapper(x, cos, sin):
        # decode's tables are (B, 1, D/2), the prefill's (S, D/2)
        return x if cos.ndim == 3 else fn(x, cos, sin)
    return wrapper


def _prefill_not_causal(fn):
    def wrapper(q, k, v, causal=True, **kwargs):
        return fn(q, k, v, causal=False, **kwargs)
    return wrapper


def _decode_without_decay(fn):
    def wrapper(state, x_t, dt_t, A, B_t, C_t, D):
        return fn(state, x_t, dt_t, torch.zeros_like(A), B_t, C_t, D)
    return wrapper


def _decode_zero_conv_tail(fn):
    def wrapper(self, x, state):
        state["conv"].zero_()
        return fn(self, x, state)
    return wrapper


def _prefill_drops_chunk_state(fn):
    def wrapper(x, dt, A, B, C, D, chunk=128):
        # each chunk scanned from a zero state
        parts = [fn(x[:, c:c + chunk], dt[:, c:c + chunk], A,
                    B[:, c:c + chunk], C[:, c:c + chunk], D, chunk=chunk)
                 for c in range(0, x.shape[1], chunk)]
        return torch.cat([y for y, _ in parts], dim=1), parts[-1][1]
    return wrapper


# Planted faults, each run through the serve checks, which must reject
# it: (name, owner, attribute, wrap, the check that must see it, whether
# the bf16 check is held to see it too: a dropped key of hundreds moves
# the logits too little above bf16's end-to-end rounding, PERF.md).
LM_FAULTS = (
    ("decode attends kv_len = pos", lm_attention, "decode_attention",
     _decode_kv_len_is_pos, "decode", False),
    ("decode writes and reads one position late", Model, "decode_step",
     _decode_one_late, "decode", True),
    ("decode without rope", lm_attention, "apply_rope",
     _decode_without_rope, "decode", True),
    ("prefill not causal", lm_attention, "flash_attention",
     _prefill_not_causal, "prefill", True),
)
SSM_FAULTS = (
    ("decode without the state's decay (a = 1)", lm_ssm, "ssd_step",
     _decode_without_decay, "decode", True),
    ("decode with a zeroed conv tail", lm_ssm.SSMBlock, "decode",
     _decode_zero_conv_tail, "decode", True),
    ("prefill drops the state carried between chunks", lm_ssm, "ssd_scan",
     _prefill_drops_chunk_state, "prefill", True),
)


def dense_cell(cfg) -> ServeCell:
    return ServeCell(
        cfg, {"flash_attention": (flash_attention, cfg.n_layers),
              "decode_attention": (decode_attention,
                                   cfg.n_layers * LM_NEW_TOKENS)},
        ((lm_attention, "flash_attention", flash_attention_ref),
         (lm_attention, "decode_attention", decode_attention_ref)),
        None, LM_FAULTS, LM_LOGIT_TOL,
        FLASH_KERNEL_NAMES + DECODE_KERNEL_NAMES)


def ssm_cell(cfg, prompts) -> ServeCell:
    """Rows shorter than the longest absorb the right padding into their
    state (the reference's design): only the longest row is held alone
    and against a fresh prefill."""
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    return ServeCell(cfg, {"ssd_scan": (ssd_scan, cfg.n_layers)},
                     ((lm_ssm, "ssd_scan", ssd_scan_ref),), (longest,),
                     SSM_FAULTS, SSM_LOGIT_TOL, ssd_check.KERNEL_NAMES)


def serve_checks(eng, prompts, cell: ServeCell) -> dict:
    """The serving path held to itself at ``eng``'s dtype: the kernels
    against their plain versions (prefill logits and greedy tokens),
    each of ``cell.rows`` alone against the batch (first-token logits),
    their first and last decode step against a fresh prefill, each
    within the cell's tolerance of the logits' RMS; then every planted
    fault through the check it targets, which must read more than the
    tolerance.  -> readings."""
    model, params = eng.model, eng.params
    n_new = LM_NEW_TOKENS
    lens = [len(p) for p in prompts]
    rows = cell.rows or tuple(range(len(prompts)))
    dt = model.cfg.dtype
    tol = cell.tol[dt]
    cell.reset()
    out_k, logs_k = served(eng, prompts, n_new)
    if cell.counts() != cell.want():
        raise AssertionError(f"serve checks ({dt}): launches "
                             f"{cell.counts()}, expected {cell.want()}")
    out_p, logs_p = served(eng, prompts, n_new, cell.plain)
    r = dict(dtype=dt, tol=tol, out=out_k)
    r["plain"] = logits_close(logs_k["prefill"][0], logs_p["prefill"][0],
                              f"{dt} prefill, kernels against plain "
                              "versions", tol)
    r["tokens_compared"] = tokens_agree(
        out_k, out_p, lens, logs_k["prefill"] + logs_k["decode"], tol)
    r["tokens_equal_plain"] = out_k == out_p
    r["min_top2_margin"] = min(
        float(torch.topk(lg, 2, dim=-1).values.diff(dim=-1).abs().min())
        for lg in logs_k["prefill"] + logs_k["decode"])
    r["batch1"] = 0.0
    for i in rows:
        _, logs1 = served(eng, [prompts[i]], 1)
        r["batch1"] = max(r["batch1"], logits_close(
            logs1["prefill"][0][0], logs_k["prefill"][0][i],
            f"{dt} prompt {i} served alone against in the batch", tol))
    r["decode_vs_prefill"] = decode_gap(model, params, prompts, out_k,
                                        logs_k, rows)
    if r["decode_vs_prefill"] > tol:
        raise AssertionError(f"{dt} decode step against a fresh prefill: "
                             f"logits differ by {r['decode_vs_prefill']!r}"
                             f" RMS > {tol!r}")
    if not all(torch.isfinite(lg).all()
               for lg in logs_k["prefill"] + logs_k["decode"]):
        raise AssertionError(f"{dt}: non-finite logits")
    name = model.cfg.name
    log(f"serve checks ({name}, {dt}, tolerance {tol} of the logits' RMS "
        f"{float(logs_k['prefill'][0].pow(2).mean().sqrt())!r}; max "
        f"|logit| {float(logs_k['prefill'][0].abs().max())!r}): kernels "
        f"against plain versions {r['plain']!r} RMS, "
        f"{r['tokens_compared']} of {len(lens) * n_new} greedy tokens "
        f"compared (all equal: {r['tokens_equal_plain']}; smallest top-2 "
        f"margin {r['min_top2_margin']!r}); rows {list(rows)} alone "
        f"{r['batch1']!r} RMS; their first and last decode step against "
        f"a fresh prefill {r['decode_vs_prefill']!r} RMS")
    r["faults"] = {}
    for fname, owner, attr, wrap, check, in_bf16 in cell.faults:
        with wrapped(owner, attr, wrap):
            out_f, logs_f = served(eng, prompts, n_new)
        gap = (decode_gap(model, params, prompts, out_f, logs_f, rows)
               if check == "decode" else
               logit_gap(logs_f["prefill"][0], logs_k["prefill"][0]))
        held = dt == "float32" or in_bf16
        r["faults"][fname] = gap
        log(f"serve checks ({name}, {dt}), planted fault '{fname}': "
            f"{check} check reads {gap!r} RMS against tolerance {tol} ("
            f"{'caught' if gap > tol else 'not caught'}; greedy tokens "
            f"{'unchanged' if out_f == out_k else 'changed'})")
        if held and not gap > tol:
            raise AssertionError(f"{dt}: the {check} check misses the "
                                 f"planted fault '{fname}'")
    return r


def serve_busy(eng, prompts, activities=None, kernel_names=()) -> dict:
    """One more generate under the profiler: the device's busy time
    summed over every kernel and copy it ran, against the wall time (an
    upper bound on the idle share: the profiler slows the host), the
    part of it in the kernels whose names contain ``kernel_names``, and
    the host's side: kernel launches a token step (prefill included,
    over ``LM_NEW_TOKENS + 1`` steps) and the host ops that took the
    most self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if activities is None:
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, LM_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            per_name[ev.name] = per_name.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us()
        elif ev.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            # cudaLaunchKernel, cudaLaunchKernelExC (a cluster launch),
            # cuLaunchKernel, cuLaunchKernelEx
            launches += 1
    busy = sum(per_name.values()) / 1e6
    kern = sum(us for k, us in per_name.items()
               if any(n in k for n in kernel_names)) / 1e6
    top = sorted(((us, k) for k, us in per_name.items()), reverse=True)
    host = sorted(((ev.self_cpu_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.key.startswith("aten::")), reverse=True)
    steps = LM_NEW_TOKENS + 1
    log(f"device busy (profiled generate, {eng.model.cfg.name}, "
        f"{eng.model.cfg.dtype}): "
        f"{busy * 1e3:.1f} ms of {wall * 1e3:.1f} ms wall = "
        f"{100 * busy / wall:.1f}% busy; top device time: "
        + "; ".join(f"{k[:60]} {us / 1e3:.2f} ms" for us, k in top[:6]))
    log(f"device time in {', '.join(kernel_names)} (same run): "
        f"{kern * 1e3:.4f} ms = {100 * kern / max(busy, 1e-12):.2f}% of "
        "busy")
    log(f"host (same run): {launches} kernel launches = "
        f"{launches / steps:.0f} a token step; top aten ops by self CPU "
        "time: " + "; ".join(f"{k} {us / 1e3:.1f} ms over {n} calls"
                             for us, k, n in host[:6]))
    return dict(busy_s=busy, wall_s=wall, busy_share=busy / wall,
                kernels_busy_s=kern, launches_per_step=launches / steps)


def lm_prompts(cfg):
    """The serving cells' 4 prompts (``LM_PROMPT_LENS`` tokens), seeded."""
    rng = np.random.default_rng(SEED)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
            for n in LM_PROMPT_LENS]


def run_serving(cfg, cell_of) -> dict:
    """``ServeEngine.generate`` of one cell at full width (bf16
    activations over f32 masters from ``SEED``) on ``lm_prompts``: cold
    and repeat (the same tokens, each kernel launched as the cell says,
    the counts set to 0 just before each), a timed run (prefill against
    decode), ``serve_checks``, a profiled run, then ``serve_checks``
    again on an f32-activation copy.  ``cell_of(cfg, prompts)`` gives
    the cell for a config.  -> {"launches": the cold run's counts}."""
    prompts = lm_prompts(cfg)
    cell = cell_of(cfg, prompts)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    log(f"lm: {cfg.name} ({model.param_count()} parameters, f32 masters, "
        f"{cfg.dtype} activations, {cfg.n_layers} layers) initialised on "
        f"the card from seed {SEED} in {time.perf_counter() - t0:.2f} s")
    lens = [len(p) for p in prompts]
    eng = ServeEngine(model, params, max_len=LM_MAX_LEN)
    n_new = LM_NEW_TOKENS

    runs = []
    for label in ("cold", "repeat"):
        cell.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cell.counts()
        if launches != cell.want():
            raise AssertionError(f"serve {cfg.name} ({label}): launches "
                                 f"{launches}, expected {cell.want()}")
        if [len(o) for o in out] != [n + n_new for n in lens] or any(
                not 0 <= t < cfg.vocab_size for o in out for t in o):
            raise AssertionError(f"serve {cfg.name} ({label}): malformed "
                                 "output")
        runs.append((out, launches))
        log(f"serve {cfg.name} ({label}): {len(prompts)} prompts of {lens}"
            f" tokens, {n_new} new each, max_len {LM_MAX_LEN}: {wall:.3f} "
            f"s wall; launches {launches}")
    if runs[0] != runs[1]:
        raise AssertionError(f"{cfg.name}: two generates of the same "
                             "prompts differ")

    # timed run: prefill (the one forward) against the decode steps
    spent = {"prefill": 0.0}

    def timed(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spent["prefill"] += time.perf_counter() - t
        return wrapper
    torch.cuda.reset_peak_memory_stats()
    with wrapped(Model, "forward", timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pre = spent["prefill"]
    dec = wall - pre
    perf = dict(prefill_s=pre, prefill_tok_s=sum(lens) / pre,
                prefill_padded_tok_s=len(lens) * max(lens) / pre,
                decode_ms_per_step=dec / n_new * 1e3,
                decode_tok_s=len(lens) * n_new / dec, generate_s=wall,
                peak_bytes=peak)
    log(f"serve {cfg.name} (timed): prefill {pre:.4f} s = "
        f"{perf['prefill_tok_s']:.0f} prompt tokens/s "
        f"({perf['prefill_padded_tok_s']:.0f} padded); decode {n_new} "
        f"steps in {dec:.4f} s = {perf['decode_ms_per_step']:.3f} ms/step "
        f"= {perf['decode_tok_s']:.1f} tokens/s at batch {len(lens)}; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")

    # the kernels against their plain versions, batch 1, decode against
    # prefill and the planted faults: in the config's bf16, then in f32,
    # where rounding is far below what each fault moves
    chk = serve_checks(eng, prompts, cell)
    if chk["out"] != runs[0][0]:
        raise AssertionError("recorded generate differs from the first")
    busy = serve_busy(eng, prompts, kernel_names=cell.device_names)
    del eng, params
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    eng32 = ServeEngine(model32, model32.init_params(seed=SEED,
                                                     device=DEVICE),
                        max_len=LM_MAX_LEN)
    chk32 = serve_checks(eng32, prompts, cell_of(cfg32, prompts))
    busy32 = serve_busy(eng32, prompts, kernel_names=cell.device_names)
    del eng32
    log(f"lm serving {cfg.name}: " + json.dumps(dict(
        perf, **busy, **{f"float32_{k}": v for k, v in busy32.items()},
        **{f"{c['dtype']}_{k}": c[k]
                         for c in (chk, chk32)
                         for k in ("plain", "batch1", "decode_vs_prefill",
                                   "faults")})))
    return dict(launches=runs[0][1])


def run_lm() -> list:
    """The LM serving path at full qwen2-0.5b width: both kernels against
    their plain versions, then the dense serving cell; -> the two
    kernels' records."""
    fa = check_flash_attention()
    da = check_decode_attention()
    served_run = run_serving(LM_CFG, lambda cfg, _: dense_cell(cfg))

    src = "src/repro_torch/csrc/"
    f_main = fa[("S500 causal", "bfloat16")]
    d_main = da["bfloat16"]
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_f32_core_ms", "max_abs_err")
    f_keys = keys + ("library_device_ms", "bound_by")
    return [
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:98",
             design="wgmma fed by TMA (producer warp, mbarrier ring, 128B "
                    "swizzle); bf16: m64n64k16, 2 stages, P split into "
                    "bf16 hi + lo; f32: 3xTF32 m64n64k8 (hi the raw f32 "
                    "word, lo written beside it), 1 stage and 2 blocks an "
                    "SM, S in two accumulators, V transposed with its keys "
                    "in the register operand's K order",
             launches=served_run["launches"]["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in fa.values()),
             ms=f_main["ms"], plain_ms=f_main["plain_ms"],
             bound_ms=f_main["bound_ms"], bound_by=f_main["bound_by"],
             library_ms=f_main["library_ms"], device_ms=f_main["device_ms"],
             library_device_ms=f_main["library_device_ms"],
             bound_f32_core_ms=f_main["bound_f32_core_ms"],
             shape="B 4, S 500, Hq 14, Hkv 2, D 64, causal, bf16",
             s512={dt: {k: fa[("S512 causal", dt)][k] for k in f_keys}
                   for dt in ("bfloat16", "float32")},
             s500_float32={k: fa[("S500 causal", "float32")][k]
                           for k in f_keys}),
        dict(name="decode_attention", route="cuda",
             source=src + "decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:76",
             design="keys split over a 16-block cluster per (KV head, "
                    "row), partial softmaxes merged through distributed "
                    "shared memory, one launch, f32 cuda-core",
             launches=served_run["launches"]["decode_attention"],
             blocks=d_main["blocks"],
             max_abs_err=max(r["max_abs_err"] for r in da.values()),
             ms=d_main["ms"], plain_ms=d_main["plain_ms"],
             bound_ms=d_main["bound_ms"], bound_by=d_main["bound_by"],
             library_ms=d_main["library_ms"], device_ms=d_main["device_ms"],
             bound_f32_core_ms=d_main["bound_f32_core_ms"],
             shape="B 4, S 1024, Hq 14, Hkv 2, D 64, kv_len "
                   "(1, 61, 512, 1024), bf16",
             float32={k: da["float32"][k] for k in keys}),
    ]


def check_ssd_scan():
    """The scan kernel against its plain version on the card
    (``kernels.ssd_scan.check``): the prefill's call (B 4, S 500, H 32, P
    64, N 128, Q 128), B 1 at S 61 (Q 61), 512 and 2048, Q 100 over S
    250, and B 2 at S 130, each in bf16 and f32 (no padding copy in
    either); then that each dtype runs its own kernel (the profiler's
    trace) and the wrapper's refusals.  Timed at the prefill's call, both
    dtypes.  -> {(case, dtype): record}."""
    rows = {}
    for i, (name, b, S, h, p, n, chunk) in enumerate(ssd_check.CASES):
        for dt in (torch.bfloat16, torch.float32):
            args = ssd_check.operands(b, S, h, p, n, dt, DEVICE,
                                      SEED + 40 + i)
            label = f"ssd_scan {name} {dt}"
            err = ssd_check.check_scan(args, chunk, label)
            row = dict(case=name, dtype=str(dt).split(".")[-1], B=b, S=S,
                       H=h, P=p, N=n, chunk=chunk, max_abs_err=err)
            if i == 0:
                Q = min(chunk, S)
                n_chunks = -(-S // Q)
                # only j <= t of a chunk: C B^T (head-independent with one
                # group, once a (row, chunk)) and the intra product M x;
                # C state^T and the state update are 2 Q P N each
                tri = Q * (Q + 1)
                n_ops = b * n_chunks * (tri * n + h * (tri * p
                                                       + 4 * Q * p * n))
                n_bytes = (2 * args[0].numel() + args[3].numel()
                           + args[4].numel()) * args[0].element_size() \
                    + (args[1].numel() + 2 * h + b * h * p * n) * 4

                def kern():
                    return ssd_scan(*args, chunk=chunk)

                def plain():
                    return ssd_scan_ref(*(a.float() for a in args),
                                        chunk=chunk)
                b_ms, b_by, f32_ms = attn_bound(n_bytes, n_ops, dt)
                with torch.inference_mode():
                    row.update(ms=event_ms(kern, reps=20),
                               device_ms=device_ms(
                                   kern, ssd_check.KERNEL_NAMES, reps=20),
                               plain_ms=event_ms(plain, reps=5),
                               library_ms=None, bound_ms=b_ms, bound_by=b_by,
                               bound_f32_core_ms=f32_ms, flops=n_ops,
                               bytes=n_bytes)
                if row["device_ms"] is None:
                    raise AssertionError(f"{label}: the profiler recorded "
                                         "no device time of "
                                         f"{ssd_check.KERNEL_NAMES}")
                log(f"{label}: max |d| {err!r}; kernel {row['ms']:.4f} "
                    f"ms/call (device, cold L2 {row['device_ms']}), plain "
                    f"{row['plain_ms']:.4f} ms, no one PyTorch call, bound "
                    f"{b_ms:.5f} ms ({b_by}; {n_ops / 1e9:.4f} GFLOP, "
                    f"{n_bytes / 1e6:.2f} MB; f32 CUDA-core line "
                    f"{f32_ms:.5f} ms)")
            else:
                log(f"{label}: max |d| {err!r} (within tolerance)")
            rows[(name, row["dtype"])] = row
    name, b, S, h, p, n, chunk = ssd_check.CASES[0]
    check_kernel_of_each_dtype(
        "ssd_scan", ssd_check,
        lambda dt: ssd_check.kernels_launched(
            ssd_check.operands(b, S, h, p, n, dt, DEVICE, SEED), chunk,
            reps=20))
    ssd_check.check_refusals(DEVICE)
    log("ssd_scan: refuses an unbuilt (P, N) and a chunk over 128")
    return rows


def run_ssm() -> list:
    """Mamba2 serving at full mamba2-370m width: the scan kernel against
    its plain version, then the ssm serving cell; -> its record."""
    sc = check_ssd_scan()
    served_run = run_serving(SSM_CFG, ssm_cell)
    main = sc[("prefill B4 S500", "bfloat16")]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_f32_core_ms", "max_abs_err")
    return [dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:85",
        design="one block per (head, row) walking the chunks, the f32 "
               "state in registers, S unpadded; bf16: wgmma (m64n64k16, "
               "m64n128k16) fed by TMA (2 stages behind mbarriers, 128B "
               "swizzle), two warpgroups, M, the state and x*w split into "
               "bf16 hi + lo, a warp-shuffle cumsum; f32: 3xTF32 wgmma "
               "(m64n64k8, m64n128k8) in 64-row steps, one TMA stage, x "
               "and (w B) transposed, the state's registers the A operand "
               "of C state^T",
        launches=served_run["launches"]["ssd_scan"],
        max_abs_err=max(r["max_abs_err"] for r in sc.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        device_ms=main["device_ms"],
        bound_f32_core_ms=main["bound_f32_core_ms"],
        shape=f"B {main['B']}, S {main['S']}, H {main['H']}, P "
              f"{main['P']}, N {main['N']}, chunk {main['chunk']}, bf16",
        float32={k: sc[("prefill B4 S500", "float32")][k] for k in keys})]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvcc: {nvcc}")
    build_kernels()
    video, bank, params = run_video()
    kernels = video + run_lm() + run_ssm()
    # the fleet last: after its stream threads, the profiler's traces
    # held no device kernel for the rest of the process (twice), and
    # every phase before it reads the profiler
    fleet = run_fleet(bank, params)
    # live ingest after the fleet: it starts threads and reads no trace
    live = run_live(bank, params)
    for k in kernels:
        if k["name"] in FLEET_KERNELS:
            k["launches_fleet"] = {path: n[k["name"]]
                                   for path, n in fleet.items()}
            k["launches_live"] = {path: n[k["name"]]
                                  for path, n in live.items()}
            if not sum(k["launches_live"].values()):
                raise AssertionError(f"{k['name']} was not launched by "
                                     "the live phase")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
