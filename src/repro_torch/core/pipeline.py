"""The MultiScope execution pipeline (Figure 2): decode -> proxy ->
windows -> detector -> recurrent tracker.

The port of the JAX package's ``repro.core.pipeline``.  One
``PipelineParams`` instance is one tuner configuration θ; ``run_clip``
executes θ over a clip through the stage-graph executor
(``repro_torch.core.executor``) and returns the extracted tracks.

Cell grid convention: the canonical positive-cell grid is the DETECTOR
resolution divided by ``CELL_PX``.  Proxy models run at their own lower
resolution; the ``proxy_plan`` kernel maps their cell grids onto the
detector grid with max-pooling semantics.  The window-size set S is
given in cell units at a reference detector grid and rescaled
fractionally to others.
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
from repro_torch.core.detector import Detector
from repro_torch.core.proxy import ProxyModel
from repro_torch.core.sort import SortTracker
from repro_torch.core.tracker import DeviceTracker, RecurrentTracker
from repro_torch.core.windows import SizeSet
from repro_torch.data.video_synth import Clip

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
    """-> (frame, charged decode seconds)."""
    key = (clip.profile.name, clip.split, clip.clip_id, f, W, H)
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
    the same ``device=``).  Track refinement is not ported yet, so
    ``PipelineParams.refine`` has no effect."""
    cfg: PipelineConfig
    detectors: Dict[str, Detector]
    proxies: Dict[Tuple[int, int], ProxyModel] = field(default_factory=dict)
    tracker_params: Optional[dict] = None
    sizes_cells: Optional[List[Tuple[int, int]]] = None  # S at ref grid
    ref_grid: Optional[Tuple[int, int]] = None           # (wc, hc) of ref
    win_times: Dict = field(default_factory=dict)        # (arch,size)->s
    device: Device = "cuda"

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


def downsample_chunk(frames: np.ndarray, res: Tuple[int, int]
                     ) -> np.ndarray:
    """Nearest-neighbor resize of a chunk: (B, H, W, 3) -> (B, h, w, 3)."""
    W, H = res
    ys = (np.arange(H) * frames.shape[1]) // H
    xs = (np.arange(W) * frames.shape[2]) // W
    return frames[:, ys[:, None], xs[None, :]]


@dataclass
class RunResult:
    tracks: List[np.ndarray]
    seconds: float
    frames_processed: int
    detector_windows: int        # total windows run through the detector
    full_frames: int             # of which full-frame applications
    skipped_frames: int          # frames with zero windows
    # per-stage profile: stage -> {"wall": s, "process": s}, where
    # "process" is CPU actually spent in the stage's thread(s)
    stage_seconds: Optional[Dict[str, Dict[str, float]]] = None
    # device dispatches per stage ("proxy" plan calls, "detect" detector
    # batches, "track" crop-CNN calls plus the tracker's own: one per
    # device step, one per chunk for the device tracker)
    dispatches: Optional[Dict[str, int]] = None


def run_clip(bank: ModelBank, params: PipelineParams, clip: Clip,
             engine: str = "streaming") -> RunResult:
    """Execute θ over a clip on the bank's device.  engine:

      * "streaming" (default) — the stage-graph executor with async
        decode prefetch and double-buffered device uploads;
      * "chunked"             — the same stage graph on the sequential
        scheduler.

    Both produce identical tracks and counters."""
    from repro_torch.core.executor import ClipExecutor, ExecutorOptions
    if engine == "streaming":
        opts = ExecutorOptions()
    elif engine == "chunked":
        opts = ExecutorOptions(prefetch=False, double_buffer=False)
    else:
        raise ValueError(f"unknown engine {engine!r} (expected "
                         "'streaming' or 'chunked')")
    return ClipExecutor(bank, params, opts).run(clip)
