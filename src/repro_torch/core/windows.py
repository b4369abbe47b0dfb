"""Cell-grouping and fixed window-size-set selection (§3.3).

Host-side control logic (numpy), mirroring the paper's CPU-side grouping
next to the accelerator:

  * ``group_cells`` — positive cells -> rectangular windows drawn from the
    fixed size set S: connected components first (objects span cells), then
    density-based agglomerative merging that accepts a merge whenever the
    merged window is estimated FASTER than processing the parts separately;
  * ``plan_chunk`` / ``plan_from_mapped`` — a whole chunk's windows,
    grouped by size class for the detector's cross-frame batches;
  * ``select_window_sizes`` — the offline greedy choice of S over
    training grids, under the analytic ``detector_time_model``.

Window sizes and positions are in detector-grid CELL units, which is
what makes the ``window_gather`` kernel a copy of whole cell rows.  The
port's copy of the JAX package's ``repro.core.windows`` planner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Size = Tuple[int, int]          # (w_cells, h_cells)
Window = Tuple[int, int, Size]  # (x_cell, y_cell, size)


@dataclass
class SizeSet:
    """The fixed set S with per-size detector execution times (seconds)."""
    sizes: List[Size]            # sizes[0] is always the full frame
    times: Dict[Size, float]

    @property
    def full(self) -> Size:
        return self.sizes[0]

    def smallest_covering(self, w: int, h: int) -> Optional[Size]:
        """Smallest-area size covering (w, h) cells; None -> full frame."""
        best = None
        for s in self.sizes:
            if s[0] >= w and s[1] >= h:
                if best is None or s[0] * s[1] < best[0] * best[1]:
                    best = s
        return best

    def est(self, windows: Sequence[Window]) -> float:
        return sum(self.times[s] for _, _, s in windows)


def connected_components(grid: np.ndarray) -> List[np.ndarray]:
    """grid: (hc, wc) {0,1} -> list of (n, 2) [y, x] cell index arrays
    (4-connectivity)."""
    hc, wc = grid.shape
    seen = np.zeros_like(grid, bool)
    comps = []
    for y0, x0 in zip(*np.nonzero(grid)):
        if seen[y0, x0]:
            continue
        stack = [(y0, x0)]
        seen[y0, x0] = True
        cells = []
        while stack:
            y, x = stack.pop()
            cells.append((y, x))
            for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                yy, xx = y + dy, x + dx
                if 0 <= yy < hc and 0 <= xx < wc and grid[yy, xx] \
                        and not seen[yy, xx]:
                    seen[yy, xx] = True
                    stack.append((yy, xx))
        comps.append(np.asarray(cells, np.int64))
    return comps


def _bbox(cells: np.ndarray) -> Tuple[int, int, int, int]:
    y0, x0 = cells.min(axis=0)
    y1, x1 = cells.max(axis=0)
    return int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)


def group_cells(grid: np.ndarray, sizeset: SizeSet,
                max_windows: int = 8) -> List[Window]:
    """Positive-cell grid -> windows covering all positive cells.

    Returns [] for an empty grid (frame fully skipped).  Falls back to one
    full-frame window when a cluster exceeds every size in S or the window
    count exceeds ``max_windows`` (static per-frame capacity)."""
    return _group_components(_components(grid), sizeset, max_windows)


def _components(grid: np.ndarray):
    """-> (the grid's shape, its connected components, each one's
    centroid and bbox)."""
    comps = connected_components(grid)
    return (grid.shape, comps, [c.mean(axis=0) for c in comps],
            [_bbox(c) for c in comps])


def _group_components(components, sizeset: SizeSet,
                      max_windows: int) -> List[Window]:
    """``group_cells`` from ``_components(grid)`` (the reference's
    merging, with each cluster's centroid and bbox kept beside it
    instead of recomputed: centroids are means of integer cells and
    bboxes their extremes, so the numbers are the same)."""
    (hc, wc), comps, cents, boxes = components
    full = sizeset.full
    if not comps:
        return []

    def size_or_full(w: int, h: int) -> Size:
        s = sizeset.smallest_covering(w, h)
        return s if s is not None else full

    clusters: List[np.ndarray] = list(comps)
    cents, boxes = list(cents), list(boxes)
    # agglomerative merging: keep merging while some merge reduces est time
    merged_any = True
    while merged_any and len(clusters) > 1:
        merged_any = False
        i = 0
        while i < len(clusters):
            # closest neighbor by centroid distance
            cen = np.array(cents)
            d = np.linalg.norm(cen - cen[i], axis=1)
            d[i] = np.inf
            j = int(np.argmin(d))
            if not np.isfinite(d[j]):
                break
            prop = [i, j]
            x0, y0, w, h = _union(boxes[i], boxes[j])
            s_merged = size_or_full(w, h)
            # absorb any other cluster that fits without a larger window
            for k in range(len(clusters)):
                if k in prop:
                    continue
                tx, ty, tw, th = _union((x0, y0, w, h), boxes[k])
                if size_or_full(tw, th) == s_merged \
                        and tw <= s_merged[0] and th <= s_merged[1]:
                    x0, y0, w, h = tx, ty, tw, th
                    prop.append(k)
            t_merged = sizeset.times[s_merged]
            t_split = 0.0
            for k in prop:
                t_split += sizeset.times[size_or_full(*boxes[k][2:])]
            if t_merged < t_split:
                merged_cells = np.concatenate([clusters[k] for k in prop])
                keep = [k for k in range(len(clusters)) if k not in prop]
                clusters = [clusters[k] for k in keep] + [merged_cells]
                cents = [cents[k] for k in keep] + [merged_cells.mean(axis=0)]
                boxes = [boxes[k] for k in keep] + [(x0, y0, w, h)]
                merged_any = True
            else:
                i += 1

    windows: List[Window] = []
    for x, y, w, h in boxes:
        s = sizeset.smallest_covering(w, h)
        if s is None:
            return [(0, 0, full)]
        # place the window to cover the bbox, clamped inside the grid
        wx = min(x, wc - s[0])
        wy = min(y, hc - s[1])
        windows.append((max(wx, 0), max(wy, 0), s))
    if len(windows) > max_windows:
        return [(0, 0, full)]
    # estimated-cost sanity: never worse than one full frame
    if sizeset.est(windows) >= sizeset.times[full]:
        return [(0, 0, full)]
    return windows


def _union(a: Tuple[int, int, int, int], b: Tuple[int, int, int, int]
           ) -> Tuple[int, int, int, int]:
    """The bbox (x, y, w, h) of two bboxes' cells together."""
    x0, y0 = min(a[0], b[0]), min(a[1], b[1])
    x1 = max(a[0] + a[2], b[0] + b[2])
    y1 = max(a[1] + a[3], b[1] + b[3])
    return x0, y0, x1 - x0, y1 - y0


# ---------------------------------------------------------------------------
# Chunk planning (the staged engine's host-side stage 2->3 boundary)
# ---------------------------------------------------------------------------

@dataclass
class ChunkPlan:
    """Window plan for one chunk of frames.

    ``windows``  — per-frame planned windows, in ``group_cells`` order
                   (what the per-frame reference path would have run);
    ``by_size``  — size class -> [(frame_slot, x_cell, y_cell, win_idx)]
                   across the whole chunk, the detector's cross-frame
                   batch grouping.  ``win_idx`` is the window's index in
                   its frame's ``windows`` list, so per-frame detection
                   merge order can be reconstructed exactly.
    """
    windows: List[List[Window]]
    by_size: Dict[Size, List[Tuple[int, int, int, int]]]


def plan_chunk(grids: Sequence[np.ndarray], sizeset: SizeSet,
               max_windows: int = 8,
               chunk_size: Optional[int] = None) -> ChunkPlan:
    """Plan windows for a whole chunk of positive-cell grids on the host,
    grouping same-size windows across frames for batched execution.

    ``chunk_size`` is the executor's (tuner-visible) B: a plan never
    spans more frames than one chunk, and frame slots index into the
    chunk's (B, H, W, 3) buffer — passing it catches mismatched
    plumbing early instead of as a silent bad gather."""
    if chunk_size is not None and len(grids) > chunk_size:
        raise ValueError(f"planning {len(grids)} frames into a chunk "
                         f"of {chunk_size}")
    per_frame = [group_cells(g, sizeset, max_windows) for g in grids]
    return ChunkPlan(per_frame, _group_by_size(per_frame))


def _group_by_size(per_frame: List[List[Window]]
                   ) -> Dict[Size, List[Tuple[int, int, int, int]]]:
    by_size: Dict[Size, List[Tuple[int, int, int, int]]] = {}
    for slot, wins in enumerate(per_frame):
        for wi, (x, y, s) in enumerate(wins):
            by_size.setdefault(s, []).append((slot, x, y, wi))
    return by_size


def _single_rect_windows(grid_shape: Tuple[int, int], x: int, y: int,
                         w: int, h: int, sizeset: SizeSet) -> List[Window]:
    """``group_cells`` specialized to one filled-rectangle component:
    the merging loop is a no-op at one cluster, so only the placement +
    cost-sanity tail remains."""
    hc, wc = grid_shape
    full = sizeset.full
    s = sizeset.smallest_covering(w, h)
    if s is None:
        return [(0, 0, full)]
    wx = min(x, wc - s[0])
    wy = min(y, hc - s[1])
    windows: List[Window] = [(max(wx, 0), max(wy, 0), s)]
    if sizeset.est(windows) >= sizeset.times[full]:
        return [(0, 0, full)]
    return windows


def plan_from_mapped(grids: Sequence[np.ndarray],
                     stats: Sequence[np.ndarray], sizeset: SizeSet,
                     max_windows: int = 8,
                     chunk_size: Optional[int] = None) -> ChunkPlan:
    """Plan a chunk from the fused kernel's outputs: already-mapped
    detector grids plus per-frame stats rows [count, ymin, ymax, xmin,
    xmax, ...] (``repro_torch.kernels.proxy_plan``).

    Bit-identical to ``plan_chunk`` over host-mapped grids.  The stats
    enable two exact shortcuts — an empty frame skips grouping outright,
    and count == bbox area forces a single filled-rectangle component
    (every bbox cell positive => one 4-connected cluster), where
    ``group_cells`` provably reduces to ``_single_rect_windows``.  Any
    other support falls back to ``group_cells`` on the mapped grid."""
    if chunk_size is not None and len(grids) > chunk_size:
        raise ValueError(f"planning {len(grids)} frames into a chunk "
                         f"of {chunk_size}")
    per_frame: List[List[Window]] = []
    for grid, st in zip(grids, stats):
        count, ymin, ymax, xmin, xmax = (int(v) for v in st[:5])
        if count == 0:
            per_frame.append([])
            continue
        w, h = xmax - xmin + 1, ymax - ymin + 1
        if count == w * h:
            per_frame.append(_single_rect_windows(
                grid.shape, xmin, ymin, w, h, sizeset))
        else:
            per_frame.append(group_cells(np.asarray(grid), sizeset,
                                         max_windows))
    return ChunkPlan(per_frame, _group_by_size(per_frame))


def full_frame_plan(n_frames: int, sizeset: SizeSet) -> ChunkPlan:
    """The no-proxy plan: one full-frame window per frame."""
    full = sizeset.full
    wins: List[List[Window]] = [[(0, 0, full)] for _ in range(n_frames)]
    return ChunkPlan(wins, {full: [(slot, 0, 0, 0)
                                   for slot in range(n_frames)]})


# ---------------------------------------------------------------------------
# Offline size-set selection
# ---------------------------------------------------------------------------

def detector_time_model(full_size: Size, t_full: float,
                        overhead_frac: float = 0.25
                        ) -> Callable[[Size], float]:
    """Analytic per-size time: fixed dispatch overhead + pixel-linear
    term, calibrated so the full frame costs ``t_full``.  Used during size
    selection (measuring every candidate would need one run per size);
    the k CHOSEN sizes are then measured for real by the tuner cache."""
    area_full = full_size[0] * full_size[1]
    t0 = t_full * overhead_frac

    def t(size: Size) -> float:
        return t0 + (t_full - t0) * (size[0] * size[1]) / area_full
    return t


def select_window_sizes(grids: Sequence[np.ndarray], full_size: Size,
                        k: int, time_fn: Callable[[Size], float],
                        max_windows: int = 8) -> List[Size]:
    """Greedy S selection over training-frame positive grids (assumed
    perfect-proxy = cells of θ_best detections)."""
    wc_full, hc_full = full_size
    candidates = [(w, h)
                  for w in range(1, wc_full + 1)
                  for h in range(1, hc_full + 1)
                  if (w, h) != full_size]
    S: List[Size] = [full_size]

    # each grid's components once (group_cells would find them again
    # for every candidate)
    comps = [_components(g) for g in grids]

    def tot_time(sizes: List[Size]) -> float:
        ss = SizeSet(sizes, {s: time_fn(s) for s in sizes})
        return sum(ss.est(_group_components(c, ss, max_windows))
                   for c in comps)

    for _ in range(k - 1):
        best_s, best_t = None, tot_time(S)
        for cand in candidates:
            if cand in S:
                continue
            t = tot_time(S + [cand])
            if t < best_t - 1e-12:
                best_t, best_s = t, cand
        if best_s is None:
            break
        S.append(best_s)
    return S
