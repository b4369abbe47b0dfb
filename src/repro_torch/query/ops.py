"""Composable query operators over materialized tracks.

The port of the JAX package's ``repro.query.ops``
(``src/repro/query/ops.py``). The same code, host numpy.

A ``Query`` is a conjunction of operators plus an optional limit and an
aggregation mode; ``repro_torch.query.plan.compile_query`` folds the operator
list into one vectorized scan over the store's packed track arrays.

Row-level operators (restrict which track points count):
  * ``Region(x0, y0, x1, y1)``  — detection center inside the box,
    world units, bounds inclusive (matching the paper's Table-2 query);
  * ``TimeRange(start, end)``   — frame index in ``[start, end)``
    (``end=None`` → clip end).

Track-level operators (restrict which tracks contribute at all):
  * ``TrackFilter(min_len, classes)`` — minimum number of track rows
    (``min_len=2`` drops single-detection stubs, §4.2) and an optional
    set of spatial-pattern classes (``metrics.classify_track`` ids).

Frame-level operators:
  * ``CountAtLeast(k)`` — a frame matches when at least ``k`` surviving
    track points land on it.

Scoping:
  * ``Query.datasets`` — an optional tuple of dataset (profile) names;
    a scoped query only considers clips of those datasets.  This is how
    one ``QueryService`` fronting several stores routes a query: clips
    outside the scope are dropped BEFORE the scan, preserving the
    remaining clips' scan order and their indices into the caller's
    clip list.  ``q.scoped("caldot1")`` derives a scoped copy.

Result shaping:
  * ``Limit(n, min_spacing)`` — stop after ``n`` matching frames,
    scanning clips in order and frames in ascending order, skipping
    frames closer than ``min_spacing`` to an already-returned frame of
    the SAME clip.  The plan early-exits: clips past the n-th hit are
    never scanned.
  * ``Query.aggregate`` — "frames" (the matching (clip, frame) list),
    "count" (matching-frame count), "duration" (matching seconds at the
    clip's fps), or "tracks" (distinct contributing tracks).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

AGGREGATES = ("frames", "count", "duration", "tracks")


@dataclass(frozen=True)
class Region:
    """Spatial predicate: detection center in [x0,x1] x [y0,y1]."""
    x0: float
    y0: float
    x1: float
    y1: float

    def __post_init__(self):
        if self.x1 < self.x0 or self.y1 < self.y0:
            raise ValueError(f"empty region {self}")

    @classmethod
    def full(cls) -> "Region":
        return cls(0.0, 0.0, 1.0, 1.0)

    def intersect(self, other: "Region") -> "Region":
        x0, y0 = max(self.x0, other.x0), max(self.y0, other.y0)
        x1, y1 = min(self.x1, other.x1), min(self.y1, other.y1)
        if x1 < x0 or y1 < y0:      # disjoint: a region matching nothing
            nan = float("nan")
            return Region(nan, nan, nan, nan)
        return Region(x0, y0, x1, y1)


@dataclass(frozen=True)
class TimeRange:
    """Temporal predicate: frame index in [start, end)."""
    start: int = 0
    end: Optional[int] = None

    def __post_init__(self):
        if self.end is not None and self.end < self.start:
            raise ValueError(f"empty time range {self}")


@dataclass(frozen=True)
class TrackFilter:
    """Track-level predicate: length floor + optional pattern classes."""
    min_len: int = 2
    classes: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class CountAtLeast:
    """Frame-level predicate: >= k surviving track points on the frame."""
    k: int = 1

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("CountAtLeast needs k >= 1")


@dataclass(frozen=True)
class Limit:
    """Return at most n frames, >= min_spacing apart within a clip."""
    n: int
    min_spacing: int = 0

    def __post_init__(self):
        if self.n < 1:
            raise ValueError("Limit needs n >= 1")


Op = object     # Region | TimeRange | TrackFilter | CountAtLeast


@dataclass(frozen=True)
class Query:
    """A conjunction of operators + limit + aggregation mode + an
    optional dataset scope."""
    where: Tuple[Op, ...] = field(default_factory=tuple)
    limit: Optional[Limit] = None
    aggregate: str = "frames"
    datasets: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.aggregate not in AGGREGATES:
            raise ValueError(f"unknown aggregate {self.aggregate!r} "
                             f"(expected one of {AGGREGATES})")
        if self.datasets is not None:
            if isinstance(self.datasets, str):
                raise TypeError("datasets must be a tuple of names, "
                                "not a bare string")
            object.__setattr__(self, "datasets", tuple(self.datasets))
            if not all(isinstance(d, str) for d in self.datasets):
                raise TypeError(f"dataset names must be strings: "
                                f"{self.datasets!r}")
        if self.limit is not None and self.aggregate != "frames":
            # the limit scan early-exits, so a scalar aggregate computed
            # under it would be a silently truncated count
            raise ValueError("limit only composes with "
                             "aggregate='frames'")
        for op in self.where:
            if not isinstance(op, (Region, TimeRange, TrackFilter,
                                   CountAtLeast)):
                raise TypeError(f"unknown operator {op!r}")

    def scoped(self, *datasets: str) -> "Query":
        """A copy of this query restricted to the named datasets."""
        return dataclasses.replace(self, datasets=tuple(datasets))

    # -- convenience constructors ---------------------------------------------

    @classmethod
    def limit_frames(cls, *, region=None, min_count: int = 1,
                     want: int = 10, min_spacing: int = 0,
                     min_track_len: int = 2,
                     time_range: Optional[TimeRange] = None) -> "Query":
        """The paper's Table-2 limit query: ``want`` frames with at
        least ``min_count`` objects inside ``region``."""
        where = [TrackFilter(min_len=min_track_len),
                 CountAtLeast(min_count)]
        if region is not None:
            where.append(Region(*region))
        if time_range is not None:
            where.append(time_range)
        return cls(tuple(where), Limit(want, min_spacing), "frames")

    @classmethod
    def count_frames(cls, *, region=None, min_count: int = 1,
                     min_track_len: int = 2,
                     time_range: Optional[TimeRange] = None) -> "Query":
        """How many frames match the predicate?"""
        q = cls.limit_frames(region=region, min_count=min_count,
                             min_track_len=min_track_len,
                             time_range=time_range)
        return cls(q.where, None, "count")

    @classmethod
    def duration(cls, *, region=None, min_count: int = 1,
                 min_track_len: int = 2) -> "Query":
        """For how many seconds does the predicate hold?"""
        q = cls.limit_frames(region=region, min_count=min_count,
                             min_track_len=min_track_len)
        return cls(q.where, None, "duration")

    @classmethod
    def count_tracks(cls, *, region=None, classes=None,
                     min_track_len: int = 2,
                     time_range: Optional[TimeRange] = None) -> "Query":
        """How many distinct tracks touch the region/time window?"""
        where = [TrackFilter(min_len=min_track_len,
                             classes=None if classes is None
                             else tuple(classes))]
        if region is not None:
            where.append(Region(*region))
        if time_range is not None:
            where.append(time_range)
        return cls(tuple(where), None, "tracks")
