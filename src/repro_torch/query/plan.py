"""Query compilation + two-phase vectorized execution over packed
track arrays.

The port of the JAX package's ``repro.query.plan``
(``src/repro/query/plan.py``). The same code, host numpy.

``compile_query`` folds a ``Query``'s operator conjunction into one
``CompiledPlan`` (regions intersect, time ranges intersect, track
filters merge, count thresholds take the max).  Execution is
two-phase, per clip, in scan order:

  **Phase 1 — consult the index** (``repro_torch.query.index``):

  1. skip test    — the clip's ``ClipSummary`` proves it cannot
     contribute (query region disjoint from the union track bbox, time
     window outside the frame span, ``min_count`` above the per-frame
     maximum, ``min_len`` above the longest track).  Skipped clips cost
     O(1), are never loaded (summaries survive eviction), and don't
     count toward ``scanned_clips``;
  2. histogram answer — when the predicate is indexed (min_len is a
     histogram bucket, no class filter, region absent or provably a
     no-op because it contains the bucket's union bbox), per-frame
     counts come straight from the precomputed histogram row — zero
     rows touched, bit-identical to the scan by construction.

  **Phase 2 — fall back to the row scan** (the PR-3 path):

  1. track mask   — ``lengths >= min_len`` (&& class membership);
  2. row mask     — track mask gathered onto rows, AND region bounds on
     the (cx, cy) columns, AND the frame-index window;
  3. frame counts — ``np.bincount`` of the surviving rows' frame
     column: per-frame object counts in one pass;

  then (either phase) matching frames are ``counts >= k`` via
  ``np.flatnonzero`` (ascending order for free), and limit queries run
  the greedy spacing filter per clip, early-exiting the clip loop the
  moment the n-th frame is found.

``run(..., use_index=False)`` disables phase 1 entirely — the
differential tests (tests/test_query_index.py) assert both modes give
bit-identical results on every query shape, and the benchmark's
indexed-vs-scan mode measures the gap.

Every step is O(rows) vectorized (O(1) when the index answers);
nothing at query time touches pixels, models, or per-track Python
loops, which is what makes warm queries run in milliseconds against
multi-clip stores (BENCH_query.json).

The limit-scan semantics replicate the original inline
``experiment.limit_query_experiment`` loop exactly (clips in order,
frames ascending, spacing enforced only within a clip), asserted by
tests/test_query.py.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.query.index import (MIN_LEN_BUCKETS, ClipSummary,
                                     bbox_is_empty, region_mask)
from repro_torch.query.ops import (CountAtLeast, Limit, Query, Region,
                                   TimeRange, TrackFilter)
from repro_torch.query.store import PackedTracks


@dataclass
class QueryResult:
    """What a plan returns.  ``frames`` is the matching
    (clip_index, frame) list (limit queries); ``aggregates`` carries the
    scalar results; ``scanned_clips``/``skipped_clips``/``indexed_clips``
    show the early-exit and the index at work."""
    frames: List[Tuple[int, int]] = field(default_factory=list)
    aggregates: Dict[str, float] = field(default_factory=dict)
    scanned_clips: int = 0      # clips that touched packed arrays
    skipped_clips: int = 0      # clips proven irrelevant by summary
    indexed_clips: int = 0      # clips answered from the histogram
    n_clips: int = 0
    stats: Optional[object] = None      # QueryStats, filled by the service


def _normalize(entry) -> Tuple[object, Optional[PackedTracks],
                               Optional[ClipSummary]]:
    """Entries are (clip, packed) or (clip, packed, summary)."""
    if len(entry) == 2:
        clip, packed = entry
        return clip, packed, None
    clip, packed, summary = entry
    return clip, packed, summary


@dataclass(frozen=True)
class CompiledPlan:
    """The folded conjunction, ready to scan packed arrays."""
    region: Optional[Region]
    time_range: Optional[TimeRange]
    min_len: int
    classes: Optional[Tuple[int, ...]]
    min_count: int
    limit: Optional[Limit]
    aggregate: str
    datasets: Optional[Tuple[str, ...]] = None      # service-level scope

    def describe(self) -> str:
        parts = [f"agg={self.aggregate}", f"count>={self.min_count}",
                 f"len>={self.min_len}"]
        if self.region is not None:
            r = self.region
            parts.append(f"region=[{r.x0},{r.y0},{r.x1},{r.y1}]")
        if self.time_range is not None:
            parts.append(f"t=[{self.time_range.start},"
                         f"{self.time_range.end})")
        if self.classes is not None:
            parts.append(f"classes={sorted(self.classes)}")
        if self.limit is not None:
            parts.append(f"limit={self.limit.n}"
                         f"@{self.limit.min_spacing}")
        if self.datasets is not None:
            parts.append(f"datasets={sorted(self.datasets)}")
        return " ".join(parts)

    # -- phase 1: index consultation ------------------------------------------

    def _floor_bucket(self) -> int:
        """Index of the largest bucket <= min_len.  Sound for pruning:
        the bucket's surviving set is a SUPERSET of the plan's, so its
        max_count/bbox bound the plan's from above."""
        bi = 0
        for i, b in enumerate(MIN_LEN_BUCKETS):
            if b <= self.min_len:
                bi = i
        return bi

    def can_skip(self, summary: Optional[ClipSummary]) -> bool:
        """True when the summary PROVES the clip contributes nothing to
        this plan (sound for every aggregate: no surviving row means no
        frame, no second, no track)."""
        if summary is None:
            return False
        if summary.n_rows == 0:
            return True
        if self.min_len > summary.max_len:
            return True                 # no track long enough
        bi = self._floor_bucket()
        if self.aggregate != "tracks" \
                and self.min_count > summary.max_count[bi]:
            # no frame can reach the count — but the "tracks" aggregate
            # ignores count predicates, so the test is unsound there
            return True
        if self.time_range is not None:
            t = self.time_range
            if t.start > summary.max_frame:
                return True
            if t.end is not None and t.end <= summary.min_frame:
                return True
        if self.region is not None \
                and self._region_disjoint(summary, bi):
            return True
        return False

    def _region_disjoint(self, summary: ClipSummary, bi: int) -> bool:
        """The region provably touches no surviving detection of bucket
        ``bi``: disjoint from the union bbox, or — finer — from the
        occupancy grid (a region can overlap the bbox yet intersect no
        occupied cell, e.g. the empty middle between two lanes)."""
        r = self.region
        if math.isnan(r.x0):
            return True                 # folded-disjoint sentinel region
        bb = summary.bbox[bi]
        if bbox_is_empty(bb):
            return True                 # no surviving track anywhere
        if r.x1 < bb[0] or bb[2] < r.x0 \
                or r.y1 < bb[1] or bb[3] < r.y0:
            return True                 # region disjoint from every track
        if summary.grid is not None and not (
                summary.grid[bi] & region_mask(r.x0, r.y0, r.x1, r.y1)):
            return True                 # bbox overlaps, occupied cells don't
        return False

    def row_disjoint(self, summary: Optional[ClipSummary]) -> bool:
        """True when the summary proves every row CURRENTLY visible
        fails a static row-level predicate (region / time) — a
        PERMANENT disqualification, unlike ``can_skip``'s count and
        track-length tests, which later appends can overturn.  Standing
        queries (``repro_torch.stream.standing``) use this to drop a
        watermark's delta outright: rows visible now and provably
        region- or time-disjoint can never match later, because row
        predicates never change."""
        if summary is None:
            return False
        if summary.n_rows == 0:
            return True
        if self.time_range is not None:
            t = self.time_range
            if t.start > summary.max_frame:
                return True
            if t.end is not None and t.end <= summary.min_frame:
                return True
        # bucket 0 (min_len floor 1) covers EVERY visible row; higher
        # buckets would be unsound here — a track below the plan's
        # min_len today can cross it tomorrow, its old rows with it
        if self.region is not None and self._region_disjoint(summary, 0):
            return True
        return False

    def _indexed_counts(self, packed: PackedTracks) -> Optional[np.ndarray]:
        """Per-frame counts straight from the histogram, or None when
        the predicate is not indexed (class filter, off-bucket min_len,
        region that actually filters rows)."""
        if self.classes is not None or packed.hist is None:
            return None
        if self.min_len not in MIN_LEN_BUCKETS:
            return None
        bi = MIN_LEN_BUCKETS.index(self.min_len)
        if self.region is not None:
            bb = packed.summary.bbox[bi]
            if not bbox_is_empty(bb):
                r = self.region
                if not (r.x0 <= bb[0] and r.y0 <= bb[1]
                        and bb[2] <= r.x1 and bb[3] <= r.y1):
                    return None         # region filters: needs the scan
            # empty bbox: every histogram row is zero, region moot
        counts = packed.hist[bi].astype(np.int64)   # astype = fresh copy
        if self.time_range is not None:
            t = self.time_range
            if t.start > 0:
                counts[:min(t.start, len(counts))] = 0
            if t.end is not None and t.end < len(counts):
                counts[t.end:] = 0
        return counts

    # -- phase 2: per-clip scan kernels ---------------------------------------

    def _row_mask(self, packed: PackedTracks, profile) -> np.ndarray:
        """(N,) rows surviving the track + region + time predicates."""
        tmask = packed.lengths >= self.min_len
        if self.classes is not None:
            tmask &= np.isin(packed.classes(profile),
                             np.asarray(self.classes, np.int64))
        mask = tmask[packed.row_track] if packed.n_tracks \
            else np.zeros(0, bool)
        rows = packed.rows
        if self.region is not None:
            r = self.region
            cx, cy = rows[:, 1], rows[:, 2]
            mask &= (cx >= r.x0) & (cx <= r.x1) \
                & (cy >= r.y0) & (cy <= r.y1)
        if self.time_range is not None:
            f = rows[:, 0]
            mask &= f >= self.time_range.start
            if self.time_range.end is not None:
                mask &= f < self.time_range.end
        return mask

    def _frame_counts(self, packed: PackedTracks, profile) -> np.ndarray:
        """(n_frames,) surviving track points per frame."""
        mask = self._row_mask(packed, profile)
        frames = packed.rows[mask, 0].astype(np.int64)
        return np.bincount(frames, minlength=packed.n_frames)

    # -- execution ------------------------------------------------------------

    def run(self, entries: Sequence, use_index: bool = True
            ) -> QueryResult:
        """entries: (clip, PackedTracks[, ClipSummary]) in scan order;
        clip provides ``profile`` (fps, pattern classification) only.
        ``packed`` may be None only for clips the summary can skip
        (evicted clips the planner proved irrelevant)."""
        res = QueryResult(n_clips=len(entries))
        n_match = 0
        seconds = 0.0
        total_tracks = 0
        for ci, entry in enumerate(entries):
            clip, packed, summary = _normalize(entry)
            if self.limit is not None \
                    and len(res.frames) >= self.limit.n:
                break                   # early-exit: clip never scanned
            if self.datasets is not None \
                    and clip.profile.name not in self.datasets:
                continue                # out of scope: contributes nothing
            if summary is None and packed is not None:
                summary = packed.summary
            if use_index and self.can_skip(summary):
                res.skipped_clips += 1
                continue
            if packed is None:
                raise RuntimeError(
                    f"clip {ci} is cold and the index cannot skip it")
            res.scanned_clips += 1
            if self.aggregate == "tracks":
                mask = self._row_mask(packed, clip.profile)
                if packed.n_tracks:
                    total_tracks += len(
                        np.unique(packed.row_track[mask]))
                continue
            counts = self._indexed_counts(packed) if use_index else None
            if counts is not None:
                res.indexed_clips += 1
            else:
                counts = self._frame_counts(packed, clip.profile)
            hits = np.flatnonzero(counts >= self.min_count)
            n_match += len(hits)
            seconds += len(hits) / max(packed.fps, 1)
            if self.limit is None:
                if self.aggregate == "frames":
                    res.frames.extend((ci, int(f)) for f in hits)
                continue
            picked: List[int] = []
            spacing = self.limit.min_spacing
            for f in hits:
                if len(res.frames) >= self.limit.n:
                    break
                f = int(f)
                if all(abs(f - g) >= spacing for g in picked):
                    res.frames.append((ci, f))
                    picked.append(f)
        if self.aggregate == "tracks":
            res.aggregates["tracks"] = total_tracks
        elif self.limit is None:
            # under a limit the early-exit makes these partial sums;
            # Query rejects limit+scalar-aggregate, and we don't expose
            # truncated totals as side-channel aggregates either
            res.aggregates["count"] = n_match
            res.aggregates["duration_seconds"] = seconds
        if self.aggregate in ("count", "duration"):
            res.frames = []
        return res


def compile_query(q: Query) -> CompiledPlan:
    """Fold the operator conjunction into one CompiledPlan."""
    region: Optional[Region] = None
    time_range: Optional[TimeRange] = None
    min_len = 1
    classes: Optional[Tuple[int, ...]] = None
    min_count = 1
    for op in q.where:
        if isinstance(op, Region):
            region = op if region is None else region.intersect(op)
        elif isinstance(op, TimeRange):
            if time_range is None:
                time_range = op
            else:
                start = max(time_range.start, op.start)
                end = op.end if time_range.end is None else (
                    time_range.end if op.end is None
                    else min(time_range.end, op.end))
                if end is not None and end < start:
                    end = start     # disjoint ranges: match nothing
                time_range = TimeRange(start, end)
        elif isinstance(op, TrackFilter):
            min_len = max(min_len, op.min_len)
            if op.classes is not None:
                classes = tuple(op.classes) if classes is None \
                    else tuple(set(classes) & set(op.classes))
        elif isinstance(op, CountAtLeast):
            min_count = max(min_count, op.k)
        else:                               # Query.__post_init__ rejects
            raise TypeError(f"unknown operator {op!r}")
    return CompiledPlan(region, time_range, min_len, classes, min_count,
                        q.limit, q.aggregate, q.datasets)
