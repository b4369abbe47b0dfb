"""θ_best selection and the joint greedy parameter tuner (§3.3, §3.5).

The port of the JAX package's ``repro.core.tuner``.  Workflow (Figure 1):
  1.  detectors are pre-trained (the paper's pretrained-YOLO stand-in);
  2.  θ_best = best-accuracy configuration, found by greedy descent:
      start at max resolution / native rate with the SORT tracker, then
      keep reducing resolution (then sampling rate) while validation
      accuracy does not drop;
  3.  θ_best outputs on the TRAIN split become labels for the proxy models
      and the recurrent tracker, and the source for window-size selection
      and the start/end refiner (no ground truth anywhere);
  4.  caching phase: the detection module measures (arch x resolution)
      time/accuracy; the proxy module caches per-resolution score grids on
      the validation set and derives (resolution, threshold) ->
      (est. runtime, recall) tables; the tracking module is analytic;
  5.  greedy loop: from θ_1 = θ_best, each iteration asks all three
      modules for a ~S=30% faster candidate, evaluates each candidate's
      real validation accuracy, keeps the best, and emits the
      speed-accuracy curve Θ.

Everything trains and runs on one device (``setup(..., device=)``).  On
the card the tuner's own timers (detector, window and proxy seconds, and
the stage seconds of ``setup``) are wall time closed by a synchronise,
each over a batch of the executor's default chunk
(``pipeline.TIMING_BATCH``) divided by it; on the CPU they are the
reference's batch-1 process time.  ``_evaluate``'s seconds are
``RunResult.seconds`` in both, as in the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.configs.multiscope import PipelineConfig
from repro_torch.core import pipeline as pl
from repro_torch.core.metrics import clip_count_accuracy
from repro_torch.core.proxy import (ProxyModel, cells_from_detections,
                                    proxy_loss, sweep_candidates)
from repro_torch.core.refine import TrackRefiner
from repro_torch.core.tracker import build_examples, train_tracker
from repro_torch.core.train_models import _fit, train_detector
from repro_torch.core.windows import (detector_time_model, group_cells,
                                      select_window_sizes)
from repro_torch.data.video_synth import Clip


@dataclass
class TunerPoint:
    params: pl.PipelineParams
    val_accuracy: float
    val_seconds: float
    module: str = "init"


@dataclass
class TunedSystem:
    bank: pl.ModelBank
    theta_best: pl.PipelineParams
    curve: List[TunerPoint]
    setup_seconds: Dict[str, float] = field(default_factory=dict)


# shape classes already run once, per device (a card's first run of a
# class is never timed cold because a CPU bank warmed it)
_WARMED: set = set()


def _evaluate(bank: pl.ModelBank, params: pl.PipelineParams,
              clips: Sequence[Clip]) -> Tuple[float, float]:
    # warm caches (cuDNN algorithms, allocator) on the first clip so
    # first-run costs never pollute the measured runtime; memoized per
    # shape class (chunk size changes padded batch shapes, so it is part
    # of the class) and device
    key = (params.det_arch, params.det_res, params.proxy_res,
           params.tracker, params.chunk_size, str(bank.device))
    if key not in _WARMED:
        _WARMED.add(key)
        pl.run_clip(bank, params, clips[0])
    results, seconds = pl.run_split(bank, params, clips)
    accs = [clip_count_accuracy(r.tracks, c)
            for r, c in zip(results, clips)]
    return float(np.mean(accs)), seconds


def _measure_det_times(bank: pl.ModelBank, cfg: PipelineConfig) -> None:
    for arch, det in bank.detectors.items():
        for res in cfg.detector.resolutions:
            W, H = res
            bank.det_times[(arch, res)] = pl.detector_seconds(det, W, H)


def _stage_clock(dev: torch.device) -> Callable[[], float]:
    """setup's stage clock: wall closed by a synchronise on the card,
    process time on the CPU (the reference's)."""
    if dev.type != "cuda":
        return time.process_time

    def now() -> float:
        torch.cuda.synchronize(dev)
        return time.perf_counter()
    return now


def setup(cfg: PipelineConfig, train_clips: Sequence[Clip],
          val_clips: Sequence[Clip], *, detector_steps: int = 400,
          proxy_steps: int = 120, tracker_steps: int = 1500,
          log: Callable[[str], None] = print,
          device: Device = "cuda") -> TunedSystem:
    dev = resolve_device(device)
    clock = _stage_clock(dev)
    timings: Dict[str, float] = {}

    # -- 1. detector pre-training ----------------------------------------------
    t0 = clock()
    detectors = {}
    for arch in cfg.detector.archs:
        det, _ = train_detector(arch, train_clips,
                                list(cfg.detector.resolutions),
                                steps=detector_steps, device=dev)
        detectors[arch] = det
    bank = pl.ModelBank(cfg, detectors, device=dev)
    _measure_det_times(bank, cfg)
    timings["detector_train"] = clock() - t0
    log(f"[setup] detectors trained in {timings['detector_train']:.1f}s")

    # -- 2. θ_best selection (§3.3) ---------------------------------------------
    t0 = clock()
    arch = cfg.detector.archs[-1]          # deepest = most accurate start
    resolutions = list(cfg.detector.resolutions)
    conf = cfg.detector.confidences[1]   # 0.55
    EPS = 0.02           # eval-noise tolerance for "accuracy decreased"
    cur = pl.PipelineParams(det_arch=arch, det_res=resolutions[0],
                            det_conf=conf, gap=1, tracker="sort",
                            refine=False)
    best_cfg, best_acc_seen = cur, _evaluate(bank, cur, val_clips)[0]
    # resolution descent: stop at the first decrease, keep the ARGMAX
    # ("keep the resolution providing the best achieved accuracy", §3.3)
    acc = best_acc_seen
    for res in resolutions[1:]:
        cand = replace(cur, det_res=res)
        a, _ = _evaluate(bank, cand, val_clips)
        if a > best_acc_seen:
            best_cfg, best_acc_seen = cand, a
        if a < acc - EPS:
            break
        cur, acc = cand, a
    cur, acc = best_cfg, best_acc_seen
    # rate descent, same argmax semantics, capped at gap 2: θ_best is
    # also the LABELING configuration, and sparser labels starve the
    # trained modules
    for g in [g for g in cfg.tracker.gaps if 1 < g <= 2]:
        cand = replace(cur, gap=g)
        a, _ = _evaluate(bank, cand, val_clips)
        if a > best_acc_seen:
            best_cfg, best_acc_seen = cand, a
        if a < acc - EPS:
            break
        acc = a
    theta_best = best_cfg
    acc = best_acc_seen
    timings["theta_best"] = clock() - t0
    log(f"[setup] θ_best = {theta_best.describe()} acc={acc:.3f} "
        f"({timings['theta_best']:.1f}s)")

    # -- 3. θ_best outputs on the train split ------------------------------------
    t0 = clock()
    train_dets: List[Tuple[Clip, int, np.ndarray]] = []
    train_tracks: List[np.ndarray] = []
    tracks_by_clip: List[Tuple[Clip, List[np.ndarray]]] = []
    det = bank.detectors[theta_best.det_arch]
    for clip in train_clips:
        res = pl.run_clip(bank, theta_best, clip)
        train_tracks.extend(res.tracks)
        tracks_by_clip.append((clip, res.tracks))
        for f in range(0, clip.n_frames, theta_best.gap):
            frame = clip.render(f, *theta_best.det_res)
            dets = det.detect_batch(frame[None], theta_best.det_conf)[0]
            train_dets.append((clip, f, dets))
    timings["theta_best_labels"] = clock() - t0

    # -- 4. proxy training on θ_best detections ----------------------------------
    t0 = clock()
    for res in cfg.proxy.resolutions:
        W, H = res
        hc, wc = H // cfg.proxy.cell, W // cfg.proxy.cell
        proxy = ProxyModel(cfg.proxy.cell, cfg.proxy.base_channels, res,
                           device=dev)
        frames, labels = [], []
        for clip, f, dets in train_dets:
            if len(dets) == 0 and np.random.default_rng(f).random() > 0.3:
                continue                      # paper trains on |D|>0 frames
            frames.append(clip.render(f, W, H))
            labels.append(cells_from_detections(dets, hc, wc))
        if not frames:
            continue
        frames = np.stack(frames)
        labels = np.stack(labels)
        rng = np.random.default_rng(0)

        def batches():
            for _ in range(proxy_steps):
                idx = rng.integers(len(frames), size=16)
                yield frames[idx], labels[idx]

        _fit(proxy_loss, proxy.encoder, batches(), lr=3e-3)
        bank.proxies[res] = proxy
    timings["proxy_train"] = clock() - t0
    log(f"[setup] {len(bank.proxies)} proxies trained in "
        f"{timings['proxy_train']:.1f}s")

    # -- 5. window-size set selection (§3.3) --------------------------------------
    t0 = clock()
    grid = pl.det_grid(theta_best.det_res)
    grids = [cells_from_detections(d, grid[1], grid[0])
             for (_, _, d) in train_dets if len(d)]
    t_full = bank.det_times[(theta_best.det_arch, theta_best.det_res)]
    tm = detector_time_model(grid, t_full)
    bank.sizes_cells = select_window_sizes(
        grids[:60], grid, cfg.windows.k, tm,
        max_windows=cfg.windows.max_windows)
    bank.ref_grid = grid
    timings["window_sizes"] = clock() - t0
    log(f"[setup] window sizes S = {bank.sizes_cells} "
        f"({timings['window_sizes']:.1f}s)")

    # -- 6. recurrent tracker training (§3.4) -------------------------------------
    t0 = clock()

    def frame_getter_for(clip):
        # through the bounded LRU render cache
        def get(f):
            return pl.render_frame(clip, f, *theta_best.det_res)[0]
        return get

    examples = []
    for clip, tracks in tracks_by_clip:
        examples.extend(build_examples(
            tracks, frame_getter_for(clip), cfg.tracker.crop,
            clip_key=clip.clip_id))
    params, tr_losses = train_tracker(cfg.tracker, examples,
                                      steps=tracker_steps, device=dev)
    bank.tracker_params = params
    timings["tracker_train"] = clock() - t0
    log(f"[setup] tracker trained on {len(examples)} tracks in "
        f"{timings['tracker_train']:.1f}s")

    # -- 7. refiner ---------------------------------------------------------------
    bank.refiner = TrackRefiner(cfg.refine, train_tracks,
                                frame_scale=1.0 / theta_best.det_res[0])

    return TunedSystem(bank, theta_best, [], timings)


# ---------------------------------------------------------------------------
# Module proposal caches (§3.5.1-3.5.3)
# ---------------------------------------------------------------------------

@dataclass
class DetectionCache:
    entries: Dict[Tuple[str, Tuple[int, int]], Tuple[float, float]]
    # (arch, res) -> (runtime secs on val, accuracy)

    def propose(self, cur: pl.PipelineParams, speedup: float
                ) -> Optional[pl.PipelineParams]:
        t_cur = self.entries.get((cur.det_arch, cur.det_res))
        if t_cur is None:
            return None
        budget = (1.0 - speedup) * t_cur[0]
        best = None
        for (arch, res), (t, a) in self.entries.items():
            if t <= budget and (best is None or a > best[0]):
                best = (a, arch, res)
        if best is None:
            return None
        return replace(cur, det_arch=best[1], det_res=best[2])


@dataclass
class ProxyCache:
    # (res, threshold) -> (est frame seconds, recall)
    entries: Dict[Tuple[Tuple[int, int], float], Tuple[float, float]]
    t_frame_full: float          # detector-only full-frame seconds

    def propose(self, cur: pl.PipelineParams, speedup: float
                ) -> Optional[pl.PipelineParams]:
        if cur.proxy_res is None:
            t_cur = self.t_frame_full
        else:
            t_cur = self.entries.get(
                (cur.proxy_res, cur.proxy_threshold),
                (self.t_frame_full, 0))[0]
        budget = (1.0 - speedup) * t_cur
        best = None
        for (res, th), (t, recall) in self.entries.items():
            if t <= budget and (best is None or recall > best[0]):
                best = (recall, res, th)
        if best is None:
            return None
        return replace(cur, proxy_res=best[1], proxy_threshold=best[2])


def build_caches(sys: TunedSystem, val_clips: Sequence[Clip],
                 log=print) -> Tuple[DetectionCache, ProxyCache]:
    bank, cfg = sys.bank, sys.bank.cfg
    theta = sys.theta_best
    det_entries = {}
    for arch in cfg.detector.archs:
        for res in cfg.detector.resolutions:
            cand = replace(theta, det_arch=arch, det_res=res)
            a, secs = _evaluate(bank, cand, val_clips)
            det_entries[(arch, res)] = (secs, a)
    # proxy cache: score grids cached per resolution, swept over thresholds
    proxy_entries = {}
    det = bank.detectors[theta.det_arch]
    grid = pl.det_grid(theta.det_res)
    # θ_best detections on val frames (recall reference)
    val_frames = []
    for clip in val_clips[:4]:
        for f in range(0, clip.n_frames, max(theta.gap, 2)):
            frame = clip.render(f, *theta.det_res)
            dets = det.detect_batch(frame[None], theta.det_conf)[0]
            val_frames.append((frame, dets))
    for res, proxy in bank.proxies.items():
        t_proxy = _time_proxy(proxy)
        score_grids = [proxy.scores(pl._downsample(fr, res), 0.5)[0]
                       for fr, _ in val_frames]
        # the threshold sweep runs over these CACHED score grids: the
        # configured menu plus quantiles of the trained proxy's scores
        thresholds = sweep_candidates(score_grids,
                                      cfg.proxy.thresholds)
        for th in thresholds:
            covered = total = 0
            est_t = 0.0
            cand_params = replace(theta, proxy_res=res,
                                  proxy_threshold=th)
            sizeset = pl.make_sizeset(bank, cand_params)
            for (fr, dets), sg in zip(val_frames, score_grids):
                pos = (sg > th).astype(np.int8)
                cell_grid = pl.map_proxy_grid(pos, grid)
                windows = group_cells(cell_grid, sizeset,
                                      cfg.windows.max_windows)
                est_t += t_proxy + sizeset.est(windows)
                total += len(dets)
                covered += _covered(dets, windows, grid)
            recall = covered / max(total, 1)
            proxy_entries[(res, th)] = (est_t / max(len(val_frames), 1),
                                        recall)
    t_full = bank.det_times[(theta.det_arch, theta.det_res)]
    return (DetectionCache(det_entries),
            ProxyCache(proxy_entries, t_full))


def _covered(dets: np.ndarray, windows, grid) -> int:
    n = 0
    for d in dets:
        cx, cy = d[0], d[1]
        j = int(cx * grid[0])
        i = int(cy * grid[1])
        for (x, y, (w, h)) in windows:
            if x <= j < x + w and y <= i < y + h:
                n += 1
                break
    return n


def _time_proxy(proxy: ProxyModel) -> float:
    """Proxy seconds a frame through ``proxy_score``: on the CPU one
    frame from a host array (the reference's timing); on the card a
    batch of ``pipeline.TIMING_BATCH`` frames already on the device,
    divided by the batch, as ``pipeline.detector_seconds``."""
    W, H = proxy.resolution
    if proxy.device.type == "cuda":
        frames = torch.zeros((pl.TIMING_BATCH, H, W, 3), dtype=torch.float32,
                             device=proxy.device)
        return pl.seconds_per_call(lambda: proxy.scores_batch(frames, 0.5),
                                   proxy.device) / pl.TIMING_BATCH
    frame = np.zeros((H, W, 3), np.float32)
    return pl.seconds_per_call(lambda: proxy.scores(frame, 0.5),
                               proxy.device)


# ---------------------------------------------------------------------------
# The greedy loop (§3.5)
# ---------------------------------------------------------------------------

MAX_TUNED_CHUNK = 64      # B ceiling for the scheduler module


def propose_chunk(cur: pl.PipelineParams
                  ) -> Optional[pl.PipelineParams]:
    """Scheduler-module proposal: double the executor chunk size B.

    Sparse / skip-heavy θ (large gap, or proxy gating on) amortize the
    fixed per-chunk dispatch overhead over more frames; the candidate
    can only win the greedy iteration on the runtime tiebreak."""
    from repro_torch.core.executor import DEFAULT_CHUNK
    B = cur.chunk_size or DEFAULT_CHUNK
    if B >= MAX_TUNED_CHUNK:
        return None
    if cur.gap < 2 and cur.proxy_res is None:
        return None                 # dense full-frame θ: B=16 is ample
    return replace(cur, chunk_size=B * 2)


def tune(sys: TunedSystem, val_clips: Sequence[Clip],
         log=print) -> List[TunerPoint]:
    cfg = sys.bank.cfg
    S = cfg.tuner.speedup_per_iter
    det_cache, proxy_cache = build_caches(sys, val_clips, log)
    cand_r = replace(sys.theta_best, tracker="recurrent", refine=True)
    acc_r, secs_r = _evaluate(sys.bank, cand_r, val_clips)
    cand_s = replace(sys.theta_best, tracker="sort", refine=True)
    acc_s, secs_s = _evaluate(sys.bank, cand_s, val_clips)
    if acc_r >= acc_s:
        cur, acc, secs = cand_r, acc_r, secs_r
    else:
        cur, acc, secs = cand_s, acc_s, secs_s
    curve = [TunerPoint(cur, acc, secs, "init")]
    log(f"[tune] init {cur.describe()} acc={acc:.3f} t={secs:.1f}s")
    gaps = list(cfg.tracker.gaps)
    for it in range(cfg.tuner.max_iters):
        candidates: List[Tuple[str, pl.PipelineParams]] = []
        c = det_cache.propose(cur, S)
        if c is not None and c != cur:
            candidates.append(("detection", c))
        c = proxy_cache.propose(cur, S)
        if c is not None and c != cur:
            candidates.append(("proxy", c))
        # tracking module: g_new = next pow2 >= g / (1-S)
        target = cur.gap / (1.0 - S)
        bigger = [g for g in gaps if g >= target]
        if bigger:
            candidates.append(("tracking", replace(cur, gap=bigger[0])))
        # scheduler module: larger executor chunks for sparse θ
        c = propose_chunk(cur)
        if c is not None:
            candidates.append(("scheduler", c))
        if not candidates:
            log("[tune] no module can propose a faster config; stop")
            break
        evals = []
        for mod, cand in candidates:
            a, t = _evaluate(sys.bank, cand, val_clips)
            log(f"[tune]  iter {it} {mod:10s} {cand.describe()} "
                f"acc={a:.3f} t={t:.1f}s")
            if mod == "scheduler" and t >= secs * 0.95:
                # a scheduler candidate is accuracy-IDENTICAL to cur, so
                # admit it only on a clear (>5%) runtime win
                continue
            evals.append((a, t, mod, cand))
        if not evals:
            log("[tune] no candidate improved; stop")
            break
        # best accuracy first, measured runtime breaks ties
        evals.sort(key=lambda e: (-e[0], e[1]))
        a, t, mod, cur = evals[0]
        secs = t
        curve.append(TunerPoint(cur, a, t, mod))
    sys.curve = curve
    return curve
