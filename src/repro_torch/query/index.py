"""Secondary indexes over packed track arrays.

The port of the JAX package's ``repro.query.index``
(``src/repro/query/index.py``). The same code, host numpy.

The query plan's hot loop (``repro_torch.query.plan``) is a vectorized row
scan — O(rows) per clip per query.  The structures here let most
queries touch far fewer rows, or none at all, NoScope/Spatialyze style
(cheap filters in front of the expensive path, pushed into storage):

  * **Count histograms** — ``hist[b, f]`` is the number of surviving
    track points on frame ``f`` when the track-level predicate is
    ``len >= MIN_LEN_BUCKETS[b]``.  A count/limit/duration query whose
    predicate is indexed (min_len in the buckets, no class filter,
    region absent or provably a no-op) reads its per-frame counts
    straight from the histogram row — identical, by construction, to
    what the row scan's ``np.bincount`` would produce, so the answer is
    bit-identical with zero rows touched.
  * **Per-track bounding boxes** — ``track_bbox[t]`` is the
    ``(min_cx, min_cy, max_cx, max_cy)`` envelope of track ``t``'s
    detection centers.  Their per-bucket unions feed region pruning:
    a query region disjoint from the union skips the clip outright; a
    region CONTAINING the union makes the region predicate a no-op,
    unlocking the histogram path.
  * **``ClipSummary``** — the per-clip scalar digest
    (row/track totals, frame span, per-bucket max counts, union
    bboxes, and GRID x GRID occupancy bitmasks — the coarse spatial
    grid lets a ``Region`` skip clips whose union bbox overlaps the
    query but whose occupied cells don't).  Summaries are tiny,
    JSON-serializable, and persisted in
    the version's ``index.json`` SEPARATELY from the clip NPZ — so they
    survive eviction, and an evicted clip that the summary proves
    irrelevant to a query is skipped without being re-ingested.

All index content is derived deterministically from the packed rows,
so it never needs separate invalidation: same θ-fingerprint ⇒ same
tracks ⇒ same index.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

# Track-length floors that get a precomputed histogram row.  1 is the
# no-op filter, 2 is the paper's drop-single-detection-stubs default
# (§4.2), 3 covers the common "stable track" tightening.  Queries with
# other floors fall back to the row scan (still correct, just slower);
# skip tests use the largest bucket <= the query's floor, which stays
# sound because a higher floor only shrinks the surviving set.
MIN_LEN_BUCKETS: Tuple[int, ...] = (1, 2, 3)

# (x0, y0, x1, y1) with x1 < x0: the empty envelope, disjoint from
# every query region and contained in none.
EMPTY_BBOX: Tuple[float, float, float, float] = (
    math.inf, math.inf, -math.inf, -math.inf)

Bbox = Tuple[float, float, float, float]

# Coarse spatial occupancy grid: the unit frame split into GRID x GRID
# cells, one bit per cell (row-major, bit = y_cell * GRID + x_cell).  A
# bucket's mask has a bit set iff ANY surviving detection center falls
# in that cell — finer-grained than the union bbox, so a region that
# OVERLAPS the bbox (e.g. the empty middle between two highway lanes)
# can still prove the clip skippable when no occupied cell intersects
# it.
GRID = 4


def bbox_is_empty(bbox: Bbox) -> bool:
    return bbox[2] < bbox[0] or bbox[3] < bbox[1]


def _cell_clamp(v: np.ndarray) -> np.ndarray:
    return np.clip((v * GRID).astype(np.int64), 0, GRID - 1)


def occupancy_mask(cx: np.ndarray, cy: np.ndarray) -> int:
    """Bitmask of GRID x GRID cells containing >= 1 (cx, cy) center.
    Out-of-frame centers clamp to the border cells, which keeps the
    region test conservative (the region's cell range clamps the same
    way)."""
    if len(cx) == 0:
        return 0
    cells = _cell_clamp(np.asarray(cy)) * GRID + _cell_clamp(np.asarray(cx))
    return int(np.bitwise_or.reduce(1 << cells))


def grids_from_rows(rows: np.ndarray,
                    offsets: np.ndarray) -> Tuple[int, ...]:
    """Per-``MIN_LEN_BUCKETS`` occupancy masks derived from packed
    rows — THE definition of a clip's grids (``summarize`` and the
    stream's resume path both call this; the stream's incremental
    masks are differentially tested against it)."""
    lengths = np.diff(offsets)
    row_len = np.repeat(lengths, lengths) if len(rows) \
        else np.zeros(0, np.int64)
    out = []
    for b in MIN_LEN_BUCKETS:
        sel = row_len >= b
        out.append(occupancy_mask(rows[sel, 1], rows[sel, 2]))
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def region_mask(x0: float, y0: float, x1: float, y1: float) -> int:
    """Bitmask of cells a [x0,x1] x [y0,y1] region (bounds inclusive)
    can possibly touch.  Sound: every in-region center lies in one of
    these cells (floor is monotone and both sides clamp alike).
    Cached — a standing query re-tests the same region every
    watermark."""
    cx0 = max(0, min(GRID - 1, math.floor(x0 * GRID)))
    cx1 = max(0, min(GRID - 1, math.floor(x1 * GRID)))
    cy0 = max(0, min(GRID - 1, math.floor(y0 * GRID)))
    cy1 = max(0, min(GRID - 1, math.floor(y1 * GRID)))
    mask = 0
    for gy in range(cy0, cy1 + 1):
        for gx in range(cx0, cx1 + 1):
            mask |= 1 << (gy * GRID + gx)
    return mask


@dataclass(frozen=True)
class ClipSummary:
    """Scalar digest of one clip's index — everything the planner needs
    to decide skip / histogram / scan without the packed arrays.

    ``max_count[b]`` bounds the per-frame count under min_len bucket b
    (and therefore under ANY predicate at least as strict); ``bbox[b]``
    is the union envelope of the bucket's surviving tracks; ``grid[b]``
    is the bucket's GRID x GRID occupancy bitmask (``occupancy_mask``).
    All are per ``MIN_LEN_BUCKETS`` entry.  ``grid`` is None for
    summaries persisted before the grid existed — the planner then
    falls back to the bbox-only skip test.
    """
    n_rows: int
    n_tracks: int
    max_len: int                        # longest track, in rows
    min_frame: int                      # 0 / -1 sentinels when empty
    max_frame: int
    max_count: Tuple[int, ...]          # per MIN_LEN_BUCKETS entry
    bbox: Tuple[Bbox, ...]              # per MIN_LEN_BUCKETS entry
    grid: Optional[Tuple[int, ...]] = None   # per MIN_LEN_BUCKETS entry

    def to_json(self) -> dict:
        return {
            "n_rows": self.n_rows, "n_tracks": self.n_tracks,
            "max_len": self.max_len,
            "min_frame": self.min_frame, "max_frame": self.max_frame,
            "max_count": list(self.max_count),
            # empty envelopes serialize as null (inf is not JSON)
            "bbox": [None if bbox_is_empty(b)
                     else [float(v) for v in b] for b in self.bbox],
            "grid": None if self.grid is None else list(self.grid),
        }

    @classmethod
    def from_json(cls, d: dict) -> "ClipSummary":
        grid = d.get("grid")
        return cls(
            n_rows=int(d["n_rows"]), n_tracks=int(d["n_tracks"]),
            max_len=int(d["max_len"]),
            min_frame=int(d["min_frame"]), max_frame=int(d["max_frame"]),
            max_count=tuple(int(v) for v in d["max_count"]),
            bbox=tuple(EMPTY_BBOX if b is None else tuple(b)
                       for b in d["bbox"]),
            grid=None if grid is None else tuple(int(g) for g in grid))


def build_index(rows: np.ndarray, offsets: np.ndarray,
                n_frames: int) -> Tuple[np.ndarray, np.ndarray]:
    """(hist, track_bbox) for one clip's packed arrays.

    ``hist`` is ``(len(MIN_LEN_BUCKETS), W)`` int32 with
    ``W = max(n_frames, max_frame + 1)`` — exactly the length
    ``np.bincount(frames, minlength=n_frames)`` produces in the row
    scan, so histogram-served counts are bit-identical to scanned ones.
    ``track_bbox`` is ``(T, 4)`` float32 center envelopes, the empty
    sentinel for zero-length tracks.
    """
    n_tracks = len(offsets) - 1
    lengths = np.diff(offsets)
    frames = rows[:, 0].astype(np.int64) if len(rows) \
        else np.zeros(0, np.int64)
    width = max(int(n_frames), int(frames.max()) + 1 if len(frames)
                else 0)
    hist = np.zeros((len(MIN_LEN_BUCKETS), width), np.int32)
    track_bbox = np.empty((n_tracks, 4), np.float32)
    track_bbox[:, :2] = np.inf
    track_bbox[:, 2:] = -np.inf
    if len(rows):
        row_track = np.repeat(np.arange(n_tracks, dtype=np.int64),
                              lengths)
        row_len = lengths[row_track]
        for bi, b in enumerate(MIN_LEN_BUCKETS):
            hist[bi] = np.bincount(frames[row_len >= b],
                                   minlength=width)
        cx, cy = rows[:, 1], rows[:, 2]
        np.minimum.at(track_bbox[:, 0], row_track, cx)
        np.minimum.at(track_bbox[:, 1], row_track, cy)
        np.maximum.at(track_bbox[:, 2], row_track, cx)
        np.maximum.at(track_bbox[:, 3], row_track, cy)
    return hist, track_bbox


def summarize(rows: np.ndarray, offsets: np.ndarray, hist: np.ndarray,
              track_bbox: np.ndarray,
              grid: Optional[Tuple[int, ...]] = None) -> ClipSummary:
    """Fold one clip's index arrays into the scalar ``ClipSummary``.

    ``grid`` lets a caller supply precomputed occupancy masks (the
    stream path maintains them incrementally); by default they are
    derived from the rows here."""
    lengths = np.diff(offsets)
    frames = rows[:, 0] if len(rows) else None
    max_count = tuple(int(hist[bi].max()) if hist.shape[1] else 0
                      for bi in range(len(MIN_LEN_BUCKETS)))
    bboxes: List[Bbox] = []
    for b in MIN_LEN_BUCKETS:
        sel = lengths >= b
        if sel.any() and np.isfinite(track_bbox[sel, 0]).any():
            bb = track_bbox[sel]
            bboxes.append((float(bb[:, 0].min()), float(bb[:, 1].min()),
                           float(bb[:, 2].max()), float(bb[:, 3].max())))
        else:
            bboxes.append(EMPTY_BBOX)
    return ClipSummary(
        n_rows=int(len(rows)), n_tracks=int(len(offsets) - 1),
        max_len=int(lengths.max()) if len(lengths) else 0,
        min_frame=int(frames.min()) if frames is not None else 0,
        max_frame=int(frames.max()) if frames is not None else -1,
        max_count=max_count, bbox=tuple(bboxes),
        grid=grids_from_rows(rows, offsets) if grid is None
        else tuple(grid))
