"""The MultiScope execution pipeline (Figure 2): decode -> proxy ->
windows -> detector -> recurrent tracker -> refinement.

The port of the JAX package's ``repro.core.pipeline``.  One
``PipelineParams`` instance is one tuner configuration θ; ``run_clip``
executes θ over a clip through the stage-graph executor
(``repro_torch.core.executor``), or strictly frame by frame
(``run_clip_frames``), and returns the extracted tracks.

Cell grid convention: the canonical positive-cell grid is the DETECTOR
resolution divided by ``CELL_PX``.  Proxy models run at their own lower
resolution; their cell grids are mapped onto the detector grid with
max-pooling semantics, by the ``proxy_plan`` kernel on the fused path
and by ``map_proxy_grid`` on the host otherwise.  The window-size set S
is given in cell units at a reference detector grid and rescaled
fractionally to others.  The per-frame path crops windows through the
single-frame ``window_gather`` kernel.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.configs.multiscope import PipelineConfig
from repro_torch.core.detector import Detector, next_bucket, nms
from repro_torch.core.proxy import ProxyModel
from repro_torch.core.refine import TrackRefiner
from repro_torch.core.sort import SortTracker
from repro_torch.core.tracker import DeviceTracker, RecurrentTracker
from repro_torch.core.windows import SizeSet, Window, group_cells
from repro_torch.data.video_synth import Clip
from repro_torch.kernels.window_gather import window_gather

CELL_PX = 16      # detector-grid cell edge at detector resolution (px)

# bounded LRU render cache: decode cost is still CHARGED per run, so
# every call returns (frame, decode_seconds).  The executor's decode
# prefetch renders from a background thread, so access is locked and the
# recorded cost is THREAD CPU time.
_RENDER_CACHE: "OrderedDict[Tuple, Tuple[np.ndarray, float]]" = \
    OrderedDict()
_RENDER_CACHE_MAX = 4096
_RENDER_LOCK = threading.Lock()


def render_frame(clip: Clip, f: int, W: int, H: int
                 ) -> Tuple[np.ndarray, float]:
    """-> (frame, charged decode seconds).  The key holds the clip's
    length: a clip's objects (and so their colours) depend on it."""
    key = (clip.profile.name, clip.split, clip.clip_id, clip.n_frames, f,
           W, H)
    with _RENDER_LOCK:
        hit = _RENDER_CACHE.get(key)
        if hit is not None:
            _RENDER_CACHE.move_to_end(key)
            return hit
    t0 = time.thread_time()
    frame = clip.render(f, W, H)
    cost = time.thread_time() - t0
    with _RENDER_LOCK:
        _RENDER_CACHE[key] = (frame, cost)
        if len(_RENDER_CACHE) > _RENDER_CACHE_MAX:
            _RENDER_CACHE.popitem(last=False)
    return frame, cost


def clear_render_cache() -> None:
    """Drop every cached frame, so that the next runs decode afresh."""
    with _RENDER_LOCK:
        _RENDER_CACHE.clear()


@dataclass(frozen=True)
class PipelineParams:
    """One point θ in the tuner's search space."""
    det_arch: str
    det_res: Tuple[int, int]                  # (W, H)
    det_conf: float
    gap: int = 1
    proxy_res: Optional[Tuple[int, int]] = None    # None -> no proxy
    proxy_threshold: float = 0.5
    tracker: str = "recurrent"                     # recurrent | sort
    refine: bool = True
    # frames per executor chunk (B); None -> executor.DEFAULT_CHUNK
    chunk_size: Optional[int] = None

    def describe(self) -> str:
        p = "off" if self.proxy_res is None else \
            f"{self.proxy_res[0]}x{self.proxy_res[1]}@{self.proxy_threshold}"
        b = "" if self.chunk_size is None else f" B={self.chunk_size}"
        return (f"det={self.det_arch}@{self.det_res[0]}x{self.det_res[1]}"
                f" conf={self.det_conf} gap={self.gap} proxy={p}"
                f" trk={self.tracker}{b}")


@dataclass
class ModelBank:
    """Everything trained offline for one dataset, on one device.  Its
    models must live on that device (``Detector``/``ProxyModel`` take
    the same ``device=``).  With a ``refiner``, runs whose θ has
    ``refine`` extend each track's start and end (``refine.TrackRefiner``,
    host numpy)."""
    cfg: PipelineConfig
    detectors: Dict[str, Detector]
    proxies: Dict[Tuple[int, int], ProxyModel] = field(default_factory=dict)
    tracker_params: Optional[dict] = None
    sizes_cells: Optional[List[Tuple[int, int]]] = None  # S at ref grid
    ref_grid: Optional[Tuple[int, int]] = None           # (wc, hc) of ref
    win_times: Dict = field(default_factory=dict)        # (arch,size)->s
    device: Device = "cuda"
    refiner: Optional[TrackRefiner] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        models = list(self.detectors.values()) + list(self.proxies.values())
        for m in models:
            if m.device != self.device:
                raise ValueError(f"{type(m).__name__} on {m.device}, bank "
                                 f"on {self.device}")


def make_tracker(bank: ModelBank, params: PipelineParams,
                 device_assign: bool = False,
                 device_tracker: bool = False):
    """θ's tracker instance — THE selection rule: recurrent iff θ asks
    for it and the bank has tracker params, SORT otherwise.

    ``device_assign``/``device_tracker`` mirror ``ExecutorOptions``: the
    per-frame step as one ``track_step`` launch, or the whole chunk's
    recurrence on the device (``DeviceTracker``).  Both give tracks
    bit-identical to the host tracker, so they are scheduling knobs like
    the rest of the options, never part of θ."""
    if params.tracker == "recurrent" and bank.tracker_params is not None:
        if device_tracker:
            return DeviceTracker(bank.cfg.tracker, bank.tracker_params)
        return RecurrentTracker(
            bank.cfg.tracker, bank.tracker_params,
            assign="device" if device_assign else "host")
    return SortTracker()


def det_grid(res: Tuple[int, int]) -> Tuple[int, int]:
    W, H = res
    return W // CELL_PX, H // CELL_PX


def map_proxy_grid(pos: np.ndarray, grid: Tuple[int, int]) -> np.ndarray:
    """(hp, wp) proxy grid -> (hc, wc) detector grid, max-pool semantics.

    A detector cell (i, j) is positive iff ANY proxy cell in the
    (possibly overlapping) source span [ys_i, ye_i) x [xs_j, xe_j) is.
    Vectorized with a 2D integral image: span-any == span-count > 0."""
    wc, hc = grid
    hp, wp = pos.shape
    ys = np.minimum((np.arange(hc) * hp) // hc, hp - 1)
    ye = np.minimum(((np.arange(hc) + 1) * hp + hp - 1) // hc, hp)
    ye = np.maximum(ye, ys + 1)
    xs = np.minimum((np.arange(wc) * wp) // wc, wp - 1)
    xe = np.minimum(((np.arange(wc) + 1) * wp + wp - 1) // wc, wp)
    xe = np.maximum(xe, xs + 1)
    acc = np.zeros((hp + 1, wp + 1), np.int64)
    acc[1:, 1:] = np.cumsum(np.cumsum(pos != 0, axis=0), axis=1)
    cnt = acc[ye[:, None], xe[None, :]] - acc[ys[:, None], xe[None, :]] \
        - acc[ye[:, None], xs[None, :]] + acc[ys[:, None], xs[None, :]]
    return (cnt > 0).astype(np.int8)


def scale_sizes(sizes_cells: Sequence[Tuple[int, int]],
                ref_grid: Tuple[int, int], grid: Tuple[int, int]
                ) -> List[Tuple[int, int]]:
    """Rescale the cell-unit size set fractionally to another grid; the
    first entry is forced to the new full frame."""
    rw, rh = ref_grid
    wc, hc = grid
    out: List[Tuple[int, int]] = [(wc, hc)]
    for (w, h) in sizes_cells[1:]:
        sw = max(1, min(wc, int(round(w * wc / rw))))
        sh = max(1, min(hc, int(round(h * hc / rh))))
        if (sw, sh) not in out:
            out.append((sw, sh))
    return out


def measure_window_time(bank: ModelBank, arch: str,
                        size: Tuple[int, int]) -> float:
    """MEASURED detector seconds for one window size (cached in
    ``bank.win_times``).  On the card the launch is asynchronous, so the
    interval is wall time closed by a synchronise; on the CPU it is
    process time, as in the reference."""
    key = (arch, size)
    if key not in bank.win_times:
        det = bank.detectors[arch]
        frame = np.zeros((1, size[1] * CELL_PX, size[0] * CELL_PX, 3),
                         np.float32)
        det.detect_batch(frame, 0.5)          # warm-up
        cuda = det.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(det.device)
        clock = time.perf_counter if cuda else time.process_time
        t0 = clock()
        for _ in range(3):
            det.detect_batch(frame, 0.5)
        if cuda:
            torch.cuda.synchronize(det.device)
        bank.win_times[key] = (clock() - t0) / 3
    return bank.win_times[key]


def make_sizeset(bank: ModelBank, params: PipelineParams) -> SizeSet:
    """Size set + MEASURED per-size detector times for this θ."""
    grid = det_grid(params.det_res)
    if bank.sizes_cells is None:
        sizes = [grid]
    else:
        sizes = scale_sizes(bank.sizes_cells, bank.ref_grid, grid)
    times = {s: measure_window_time(bank, params.det_arch, s)
             for s in sizes}
    return SizeSet(sizes, times)


def _downsample_indices(shape_hw: Tuple[int, int], res: Tuple[int, int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-neighbor (ys, xs) index vectors — the ONE formula both
    the per-frame and chunked proxy paths share, so that both score the
    same pixels."""
    W, H = res
    ys = (np.arange(H) * shape_hw[0]) // H
    xs = (np.arange(W) * shape_hw[1]) // W
    return ys, xs


def _downsample(frame: np.ndarray, res: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor resize of one frame (host-side, cheap)."""
    ys, xs = _downsample_indices(frame.shape[:2], res)
    return frame[np.ix_(ys, xs)]


def downsample_chunk(frames: np.ndarray, res: Tuple[int, int]
                     ) -> np.ndarray:
    """Batched ``_downsample``: (B, H, W, 3) -> (B, h, w, 3) in one
    gather, identical per-frame values."""
    ys, xs = _downsample_indices(frames.shape[1:3], res)
    return frames[:, ys[:, None], xs[None, :]]


@dataclass
class RunResult:
    tracks: List[np.ndarray]
    seconds: float
    frames_processed: int
    detector_windows: int        # total windows run through the detector
    full_frames: int             # of which full-frame applications
    skipped_frames: int          # frames with zero windows
    # per-stage profile, filled by the executor (None on the per-frame
    # path): stage -> {"wall": s, "process": s}, where "process" is CPU
    # actually spent in the stage's thread(s)
    stage_seconds: Optional[Dict[str, Dict[str, float]]] = None
    # device dispatches per stage ("proxy" plan/score calls, "detect"
    # detector batches, "track" crop-CNN calls plus the tracker's own:
    # one per device step, one per chunk for the device tracker); None
    # on the per-frame path, as in the reference
    dispatches: Optional[Dict[str, int]] = None
    # per-frame proxy positive-cell fractions, collected by the executor
    # only while drift monitoring is on (``obs.enable_drift``); the
    # ingestor's per-stream ``DriftMonitor`` reads them
    proxy_fracs: Optional[List[float]] = None


def detect_with_windows(bank: ModelBank, params: PipelineParams,
                        frame: np.ndarray, sizeset: SizeSet,
                        proxy: Optional[ProxyModel],
                        max_windows: int) -> Tuple[np.ndarray, List[Window]]:
    """Proxy-gated detection on one frame.  Returns (dets, windows).

    The proxy scores the frame at batch 1 (``proxy_score``); windows of
    one size class are cropped from the frame's device copy through the
    single-frame ``window_gather`` kernel, their count zero-padded to a
    power-of-two bucket as the reference pads it (padding rows crop cell
    (0, 0) and are never decoded)."""
    detector = bank.detectors[params.det_arch]
    grid = det_grid(params.det_res)
    if proxy is None:
        dets = detector.detect_batch(frame[None], params.det_conf)[0]
        return dets, [(0, 0, (grid[0], grid[1]))]
    pframe = _downsample(frame, proxy.resolution)
    _, pos = proxy.scores(pframe, params.proxy_threshold)
    cell_grid = map_proxy_grid(pos, grid)
    windows = group_cells(cell_grid, sizeset, max_windows)
    if not windows:
        return np.zeros((0, 5), np.float32), []
    full = sizeset.full
    if len(windows) == 1 and windows[0][2] == full:
        dets = detector.detect_batch(frame[None], params.det_conf)[0]
        return dets, windows
    # batch windows by size class (the paper's fixed-size batching)
    by_size: Dict[Tuple[int, int], List[Window]] = {}
    for wdw in windows:
        by_size.setdefault(wdw[2], []).append(wdw)
    all_dets = []
    W, H = params.det_res
    frame_dev = torch.from_numpy(
        np.ascontiguousarray(frame, np.float32)).to(detector.device)
    for size, wins in by_size.items():
        pw, ph = size[0] * CELL_PX, size[1] * CELL_PX
        n = len(wins)
        tbl = np.zeros((next_bucket(n), 2), np.int32)
        for k, (x, y, _) in enumerate(wins):
            tbl[k] = (y, x)
        crops = window_gather(frame_dev, tbl, win_h=ph, win_w=pw,
                              cell=CELL_PX)
        origins = [(x * CELL_PX / W, y * CELL_PX / H)
                   for (x, y, _) in wins]
        scales = [(pw / W, ph / H)] * n
        # crops stay on the device: the detector takes them as is
        dets = detector.detect_batch(crops, params.det_conf,
                                     origins=origins, scales=scales,
                                     n_valid=n)
        all_dets.extend(dets)
    merged = np.concatenate(all_dets) if all_dets else \
        np.zeros((0, 5), np.float32)
    return nms(merged), windows


def run_clip(bank: ModelBank, params: PipelineParams, clip: Clip,
             engine: str = "streaming") -> RunResult:
    """Execute θ over a clip on the bank's device.  engine:

      * "streaming" (default) — the stage-graph executor with async
        decode prefetch and double-buffered device uploads;
      * "chunked"             — the same stage graph on the sequential
        scheduler (``engine.run_clip_chunked``);
      * "frame"               — the strictly per-frame path
        (``run_clip_frames``).

    The first two produce identical tracks and counters.  The per-frame
    path plans the same windows but runs its conv nets at other batch
    sizes, so it matches them only as far as those nets are
    batch-invariant (in the reference as in the port)."""
    if engine == "streaming":
        from repro_torch.core.executor import run_clip_streamed
        return run_clip_streamed(bank, params, clip)
    if engine == "chunked":
        from repro_torch.core.engine import run_clip_chunked
        return run_clip_chunked(bank, params, clip)
    if engine == "frame":
        return run_clip_frames(bank, params, clip)
    raise ValueError(f"unknown engine {engine!r} (expected "
                     "'streaming', 'chunked' or 'frame')")


def run_clip_frames(bank: ModelBank, params: PipelineParams, clip: Clip
                    ) -> RunResult:
    """The strictly per-frame path: one proxy launch and one detector
    dispatch per size class PER FRAME, the host tracker stepped frame by
    frame (its crop CNN runs per frame).  ``seconds`` is process time
    plus the charged decode cost, as in the reference."""
    cfg = bank.cfg
    W, H = params.det_res
    proxy = bank.proxies.get(params.proxy_res) \
        if params.proxy_res is not None else None
    sizeset = make_sizeset(bank, params)
    tracker = make_tracker(bank, params)
    n_windows = full_frames = skipped = processed = 0
    decode_charged = 0.0
    t0 = time.process_time()
    for f in range(0, clip.n_frames, params.gap):
        # thread_time brackets match render_frame's cost clock
        t_r = time.thread_time()
        frame, cost = render_frame(clip, f, W, H)   # decode @ det res
        decode_charged += cost - (time.thread_time() - t_r)
        dets, windows = detect_with_windows(
            bank, params, frame, sizeset, proxy, cfg.windows.max_windows)
        n_windows += len(windows)
        if len(windows) == 1 and windows[0][2] == sizeset.full:
            full_frames += 1
        if not windows:
            skipped += 1
        tracker.step(f, dets, frame)
        processed += 1
    tracks = tracker.result()
    if params.refine and bank.refiner is not None:
        tracks = [bank.refiner.refine(t) for t in tracks]
    seconds = time.process_time() - t0 + max(decode_charged, 0.0)
    return RunResult(tracks, seconds, processed, n_windows, full_frames,
                     skipped)
