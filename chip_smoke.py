#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

It builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
per source, started together), holds each kernel against its plain
PyTorch version on the card at the main path's shapes and times both,
then runs the main path once — one 64-frame clip through the streaming
``ClipExecutor`` at the full-width MultiScope configuration (detector
ssd-deep at 960x544, proxy 416x256, recurrent tracker, chunks of 16) with
untrained weights drawn from a seed — and checks that every kernel of the
path was launched and that the output is right.  Every phase runs
uncaught: any failure exits non-zero before the result line.

The last three lines of standard output are the kernels' JSON record,
the card's name and power limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port (fails here, before any result, outside a checkout)
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core.detector import Detector, next_bucket  # noqa: E402
from repro_torch.core.proxy import ProxyModel  # noqa: E402
from repro_torch.core.tracker import init_tracker  # noqa: E402
from repro_torch.core.windows import plan_from_mapped  # noqa: E402
from repro_torch.data.video_synth import make_clip  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.proxy_plan import (proxy_plan,  # noqa: E402
                                            proxy_plan_ref)
from repro_torch.kernels.proxy_plan.ops import (FLIP_ULPS,  # noqa: E402
                                                _spans_on, check_plan)
from repro_torch.kernels.window_gather import (  # noqa: E402
    window_gather_batch, window_gather_batch_ref)

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


def device_ms(fn, kernel_name: str, reps: int = 50):
    """Mean device time of the CUDA kernel whose name contains
    ``kernel_name``, from the profiler's trace, with the L2 cache
    overwritten before each launch so that the inputs come from device
    memory, as the bound assumes; None if the profiler recorded no
    device time for it."""
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
    for ev in prof.key_averages():
        if kernel_name in ev.key and ev.count:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = getattr(ev, "cuda_time_total", 0.0)
            if total:
                return total / ev.count / 1e3       # us -> ms
    return None


def bound(n_bytes: float, n_ops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_OPS_PER_S * 1e3
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


def check_window_gather(frames, plan):
    CELL_PX = pl.CELL_PX
    dev_frames = torch.from_numpy(frames).to(DEVICE)
    B, H, W, _ = frames.shape
    rng = np.random.default_rng(SEED)
    rows = []
    for size in SIZES_CELLS[1:]:
        tables = []
        entries = plan.by_size.get(size)
        if entries:
            tbl = np.zeros((next_bucket(len(entries)), 3), np.int32)
            for k, (slot, x, y, _) in enumerate(entries):
                tbl[k] = (slot, y, x)
            tables.append(("first chunk's plan", tbl))
        # 5 windows padded to a bucket of 8 with zero rows, one of them
        # out of range (both versions clamp it into the chunk)
        tbl = np.zeros((8, 3), np.int32)
        tbl[:4] = np.stack([rng.integers(0, B, 4),
                            rng.integers(0, H // CELL_PX - size[1] + 1, 4),
                            rng.integers(0, W // CELL_PX - size[0] + 1, 4)],
                           1)
        tbl[4] = (B + 3, 99, 99)
        tables.append(("seeded padded table", tbl))
        win_h, win_w = size[1] * CELL_PX, size[0] * CELL_PX
        for src, tbl in tables:
            t_dev = torch.from_numpy(tbl).to(DEVICE)

            def kern():
                return window_gather_batch(dev_frames, t_dev, win_h=win_h,
                                           win_w=win_w, cell=CELL_PX)

            def plain():
                return window_gather_batch_ref(dev_frames, t_dev,
                                               win_h=win_h, win_w=win_w,
                                               cell=CELL_PX)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"window_gather_batch {size} ({src}): "
                                     "kernel != plain version")
            err = float((got - want).abs().max())
            n = tbl.shape[0]
            out_bytes = n * win_h * win_w * 3 * 4
            b_ms, b_by = bound(2 * out_bytes + tbl.nbytes, 0)
            row = dict(size=size, n=n, src=src, max_abs_err=err,
                       ms=event_ms(kern), plain_ms=event_ms(plain),
                       device_ms=device_ms(kern,
                                           "window_gather_batch_kernel"),
                       bound_ms=b_ms, bound_by=b_by)
            log(f"window_gather_batch {size} cells, table {n} rows ({src})"
                f": exact; kernel {row['ms']:.4f} ms/call (device, cold L2 "
                f"{row['device_ms']}), plain {row['plain_ms']:.4f} ms, "
                f"bound {b_ms:.5f} ms ({b_by})")
            rows.append(row)
    # the scalar-copy branch (rows not 16-byte aligned), off the main path
    small = torch.randn((2, 64, 48, 1), device=DEVICE)
    tbl = torch.tensor([[1, 1, 0], [0, 0, 1]], dtype=torch.int32,
                       device=DEVICE)
    if not torch.equal(
            window_gather_batch(small, tbl, win_h=32, win_w=16, cell=16),
            window_gather_batch_ref(small, tbl, win_h=32, win_w=16,
                                    cell=16)):
        raise AssertionError("window_gather_batch scalar branch differs")
    # the main-path entry: the planned class with the most windows
    return max(rows, key=lambda r: (r["src"] != "seeded padded table",
                                    r["n"]))


def check_proxy_plan(feat, w, b, thr, grid_hw):
    hc, wc = grid_hw
    B, hp, wp, C = feat.shape
    sy, sx = _spans_on(feat.device, hc, hp, wc, wp)
    cases = [("main path features", feat, thr)]
    rng = np.random.default_rng(SEED)
    rnd = torch.from_numpy(np.maximum(rng.standard_normal(
        tuple(feat.shape)), 0).astype(np.float32)).to(DEVICE)
    with torch.inference_mode():
        on_cell = float(torch.sigmoid(rnd[B // 2, hp // 2, wp // 2] @ w + b))
    cases.append(("random features, threshold on a cell", rnd, on_cell))
    flips = 0
    err = 0.0
    for name, f, t in cases:
        with torch.inference_mode():
            gk, sk = proxy_plan(f, w, b, t, grid_hw=grid_hw)
            gp, sp = proxy_plan_ref(f, w, b, t, sy, sx)
        torch.cuda.synchronize()
        reach = check_plan(f, w, b, t, gk, sk)
        check_plan(f, w, b, t, gp, sp)
        diff = (gk != gp)
        n_flip = int(diff.sum())
        frames_same = ~diff.any(dim=(1, 2))
        if not torch.equal(sk[frames_same], sp[frames_same]):
            raise AssertionError("proxy_plan stats differ on a frame no "
                                 "flip touched")
        flips += n_flip
        err = max(err, float((gk.int() - gp.int()).abs().max()))
        log(f"proxy_plan ({name}): {n_flip} flipped grid cells, all "
            f"within {FLIP_ULPS} ulp of threshold {t!r} ({reach} cells in "
            "the band's reach); stats equal wherever no flip touched")

    def kern():
        return proxy_plan(feat, w, b, thr, grid_hw=grid_hw)

    def plain():
        return proxy_plan_ref(feat, w, b, thr, sy, sx)
    n_bytes = (feat.numel() + w.numel() + 1 + sy.numel() + sx.numel()) * 4 \
        + B * hc * wc + B * 8 * 4
    n_ops = B * hp * wp * (2 * C + 4) + B * (hc * wp * hp + hc * wc * wp) * 2
    b_ms, b_by = bound(n_bytes, n_ops)
    with torch.inference_mode():
        row = dict(max_abs_err=err, flips=flips, ms=event_ms(kern),
                   plain_ms=event_ms(plain),
                   device_ms=device_ms(kern, "proxy_plan_kernel"),
                   bound_ms=b_ms, bound_by=b_by)
    log(f"proxy_plan {tuple(feat.shape)} -> {(B, hc, wc)}: kernel "
        f"{row['ms']:.4f} ms/call (device, cold L2 {row['device_ms']}), "
        f"plain {row['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return row


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
    log(f"card vs CPU, same weights, 2 frames of {frames.shape[1:3]}: "
        f"detector head "
        f"max |d| {d_det!r}, proxy features max |d| {d_proxy!r} "
        f"(tolerance {CONV_ATOL})")
    log(f"port's detector across buckets on the card (batch 1 vs 16): "
        f"max |d| {d_bucket!r} (reported, not asserted)")
    if not (d_det < CONV_ATOL and d_proxy < CONV_ATOL):
        raise AssertionError("conv nets on the card disagree with the CPU")


def device_busy(bank, params, clip) -> None:
    """One more run of the main path (a fresh clip, so decode is paid)
    under the profiler, recording the device only: the card's busy time
    summed over every kernel and copy it ran, against the run's wall
    time.  The profiler adds some host time, so the idle share is an
    upper bound."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pl.run_clip(bank, params, clip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    per_name = {}
    for ev in prof.events():          # the device's own events only
        if ev.device_type == DeviceType.CUDA:
            per_name[ev.name] = per_name.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us()
    busy_us = sum(per_name.values())
    top = sorted(((us, k) for k, us in per_name.items()), reverse=True)
    log(f"device busy (profiled run, clip {clip.clip_id}): "
        f"{busy_us / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall = "
        f"{100 * busy_us / 1e6 / wall:.1f}% busy, "
        f"{100 - 100 * busy_us / 1e6 / wall:.1f}% idle; top device "
        "time: " + "; ".join(f"{k[:60]} {us / 1e3:.1f} ms"
                             for us, k in top[:6]))


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

    bank = make_bank(DEVICE)
    clip = make_clip("caldot1", "test", SEED, n_frames=N_FRAMES)
    params, frames, feat, first_plan = set_up(bank, clip)
    pres = params.proxy_res
    grid_hw = pl.det_grid(params.det_res)[::-1]
    enc = bank.proxies[pres].encoder

    wg = check_window_gather(frames, first_plan)
    with torch.inference_mode():
        pp = check_proxy_plan(feat, enc.head_w, enc.head_b,
                              params.proxy_threshold, grid_hw)
    check_against_cpu(bank, frames, feat, pres)

    # the main path through its entry point, the launch counts set to 0
    # just before each run and read just after.  Run 1 is cold (cuDNN
    # and allocator warm-up at every shape); run 2, on another clip of
    # the same profile, is warm with decode paid in full (fps); run 3
    # repeats run 1's clip, which must give the same tracks.
    clip2 = make_clip("caldot1", "test", SEED + 1, n_frames=N_FRAMES)
    runs = []
    for label, c in (("cold", clip), ("warm", clip2), ("repeat", clip)):
        proxy_plan.launches = 0
        window_gather_batch.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pl.run_clip(bank, params, c)        # streaming executor
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"proxy_plan": proxy_plan.launches,
                    "window_gather_batch": window_gather_batch.launches}
        check_result(res, N_FRAMES)
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"main path ({label} run)")
        runs.append((res, launches))
        log(f"main path ({label}, clip {c.clip_id}): {N_FRAMES} frames in "
            f"{wall:.3f} s wall = {N_FRAMES / wall:.2f} fps; windows "
            f"{res.detector_windows}, full frames {res.full_frames}, "
            f"skipped {res.skipped_frames}, tracks {len(res.tracks)}; "
            f"dispatches {res.dispatches}; launches {launches}")
        log(f"  stage_seconds {json.dumps(res.stage_seconds)}")
    (res, launches), _, (res3, launches3) = runs
    if launches != launches3 or len(res.tracks) != len(res3.tracks) or \
            not all(np.array_equal(a, b)
                    for a, b in zip(res.tracks, res3.tracks)):
        raise AssertionError("two runs of the main path differ")
    device_busy(bank, params,
                make_clip("caldot1", "test", SEED + 2, n_frames=N_FRAMES))

    src = "src/repro_torch/csrc/"
    kernels = [
        dict(name="proxy_plan", route="cuda", source=src + "proxy_plan.cu",
             replaces="src/repro/kernels/proxy_plan/kernel.py:67",
             launches=launches["proxy_plan"], max_abs_err=pp["max_abs_err"],
             ms=pp["ms"], plain_ms=pp["plain_ms"], bound_ms=pp["bound_ms"],
             bound_by=pp["bound_by"], library_ms=None,
             device_ms=pp["device_ms"], flips=pp["flips"]),
        dict(name="window_gather_batch", route="cuda",
             source=src + "window_gather.cu",
             replaces="src/repro/kernels/window_gather/kernel.py:76",
             launches=launches["window_gather_batch"],
             max_abs_err=wg["max_abs_err"], ms=wg["ms"],
             plain_ms=wg["plain_ms"], bound_ms=wg["bound_ms"],
             bound_by=wg["bound_by"], library_ms=None,
             device_ms=wg["device_ms"],
             shape=f"{wg['n']} windows of {wg['size']} cells"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
