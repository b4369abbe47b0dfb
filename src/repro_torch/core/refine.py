"""Track start/end refinement (§3.4, Figure 4).

The port's copy of the JAX package's ``repro.core.refine`` (pure numpy,
bit-identical outputs on the same inputs).

Tracks captured at reduced rates first/last appear somewhere mid-path;
instead of Miris' extra detector passes, MultiScope estimates the true
start/end from SIMILAR TRACKS in the training set:

  1. θ_best training-set tracks are resampled to N evenly spaced points
     and clustered with DBSCAN under the mean point-to-point distance;
  2. cluster centers (average paths) go into a spatial grid index keyed by
     the cells their endpoints' neighborhoods touch;
  3. at inference, a track looks up centers passing near its first/last
     detection, takes the k nearest clusters (a cluster of n tracks counts
     n times), and extends itself to the size-weighted median start/end.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.multiscope import RefineConfig


def resample_track(boxes: np.ndarray, n: int) -> np.ndarray:
    """boxes: (m, >=2) rows with [cx, cy, ...] -> (n, 2) evenly spaced
    points along the polyline (arc length)."""
    pts = boxes[:, :2].astype(np.float64)
    if len(pts) == 1:
        return np.repeat(pts, n, axis=0)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    if total <= 0:
        return np.repeat(pts[:1], n, axis=0)
    targets = np.linspace(0.0, total, n)
    # per-target segment index: j = #{k in [1, len(seg)-1] : cum[k] < d}
    # (what the old scan loop computed), one vectorized searchsorted
    # over the cumulative arc length; outputs are bit-identical because
    # the interpolation arithmetic below is unchanged
    j = np.searchsorted(cum[1:len(seg)], targets, side="left")
    segj = seg[j]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.where(segj == 0.0, 0.0, (targets - cum[j]) / segj)
    return pts[j] * (1.0 - u)[:, None] + pts[j + 1] * u[:, None]


def track_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Mean euclidean distance between corresponding resampled points."""
    return float(np.linalg.norm(a - b, axis=1).mean())


def dbscan_tracks(paths: List[np.ndarray], eps: float, min_pts: int
                  ) -> List[List[int]]:
    """DBSCAN over resampled tracks (distance = track_distance).  Returns
    clusters as lists of indices; noise points become singletons."""
    n = len(paths)
    if n == 0:
        return []
    stacked = np.stack(paths)                      # (n, N, 2)
    # pairwise mean distances (n small: hundreds)
    diff = stacked[:, None] - stacked[None]        # (n, n, N, 2)
    dist = np.linalg.norm(diff, axis=-1).mean(-1)  # (n, n)
    neighbors = [np.flatnonzero(dist[i] <= eps) for i in range(n)]
    core = [len(nb) >= min_pts for nb in neighbors]
    labels = np.full(n, -1, np.int64)
    cid = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        labels[i] = cid
        stack = list(neighbors[i])
        while stack:
            j = stack.pop()
            if labels[j] == -1:
                labels[j] = cid
                if core[j]:
                    stack.extend(neighbors[j])
        cid += 1
    clusters = [list(np.flatnonzero(labels == c)) for c in range(cid)]
    clusters += [[i] for i in np.flatnonzero(labels == -1)]
    return clusters


@dataclass
class PathCluster:
    center: np.ndarray           # (N, 2)
    size: int


class TrackRefiner:
    def __init__(self, cfg: RefineConfig, train_tracks: Sequence[np.ndarray],
                 frame_scale: float = 1.0):
        """train_tracks: θ_best tracks as (m, 6) [frame, cx, cy, w, h, id]
        arrays, world units.  eps/grid_cell in cfg are in PIXELS of a
        reference frame; frame_scale converts to world units (1/width)."""
        self.cfg = cfg
        n = cfg.n_points
        eps = cfg.dbscan_eps * frame_scale
        paths = [resample_track(t[:, 1:3], n) for t in train_tracks
                 if len(t) >= 2]
        clusters = dbscan_tracks(paths, eps, cfg.dbscan_min_pts)
        self.clusters: List[PathCluster] = []
        for idxs in clusters:
            center = np.mean([paths[i] for i in idxs], axis=0)
            self.clusters.append(PathCluster(center, len(idxs)))
        # spatial grid index over cluster-center points
        self.cell = cfg.grid_cell * frame_scale
        self.index: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        for ci, c in enumerate(self.clusters):
            seen = set()
            for p in c.center:
                key = (int(p[0] // self.cell), int(p[1] // self.cell))
                if key not in seen:
                    seen.add(key)
                    self.index[key].append(ci)

    def _lookup(self, p: np.ndarray) -> List[int]:
        """Cluster ids whose center passes near point p (3x3 cells)."""
        kx, ky = int(p[0] // self.cell), int(p[1] // self.cell)
        out = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                out.extend(self.index.get((kx + dx, ky + dy), ()))
        return sorted(set(out))

    def refine(self, track: np.ndarray) -> np.ndarray:
        """track: (m, 6) — returns the track with an extrapolated start
        and end row prepended/appended (median of kNN cluster endpoints,
        weighted by cluster size)."""
        if len(track) < 2 or not self.clusters:
            return track
        path = resample_track(track[:, 1:3], self.cfg.n_points)
        cand = sorted(set(self._lookup(path[0]) + self._lookup(path[-1])))
        if not cand:
            return track
        dists = [(track_distance(path, self.clusters[ci].center), ci)
                 for ci in cand]
        dists.sort()
        starts, ends, weights = [], [], []
        total = 0
        for d, ci in dists:
            c = self.clusters[ci]
            # orient the cluster center along the track's direction
            if np.linalg.norm(c.center[0] - path[0]) <= \
                    np.linalg.norm(c.center[-1] - path[0]):
                s, e = c.center[0], c.center[-1]
            else:
                s, e = c.center[-1], c.center[0]
            starts.append(s)
            ends.append(e)
            weights.append(c.size)
            total += c.size
            if total >= self.cfg.knn:
                break
        w = np.asarray(weights, np.float64)
        start = _weighted_median(np.stack(starts), w)
        end = _weighted_median(np.stack(ends), w)
        first, last = track[0].copy(), track[-1].copy()
        first[1:3] = start
        last[1:3] = end
        return np.concatenate([first[None], track, last[None]], axis=0)


def _weighted_median(pts: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Per-dimension weighted median of (n, 2) points."""
    out = np.empty(2)
    for d in range(2):
        order = np.argsort(pts[:, d])
        cw = np.cumsum(w[order])
        idx = np.searchsorted(cw, cw[-1] / 2.0)
        out[d] = pts[order[min(idx, len(order) - 1)], d]
    return out
