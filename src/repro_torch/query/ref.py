"""Reference implementations for differential testing of the query
plan (the kernels' ``ref.py`` idiom, applied to the query subsystem).

The port of the JAX package's ``repro.query.ref``
(``src/repro/query/ref.py``). The same code, host numpy.

``reference_limit_scan`` is the original inline limit-query loop from
the pre-store ``experiment.limit_query_experiment`` — per-track Python,
dict-of-counts per frame — kept verbatim as the single source of truth
for what the compiled vectorized plan must reproduce.  Both
tests/test_query.py and benchmarks/query_bench.py assert against it.

``reference_query`` generalizes the same naive per-track/dict-of-counts
style to the full operator algebra (region × time × min_len × count ×
limit × every aggregate) so the two-phase indexed plan can be
differentially tested against an implementation that shares NO code
with it (tests/test_query_index.py): indexed answer == full-scan
answer == this inline loop, bit for bit.  Class filters are the one
operator not covered here (classification needs the clip profile);
they are tested indexed-vs-scan instead.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def reference_limit_scan(all_tracks: Sequence[Sequence[np.ndarray]],
                         want: int, min_count: int, region,
                         spacing: int) -> List[Tuple[int, int]]:
    """Find ``want`` (clip, frame) pairs with >= ``min_count`` track
    points inside ``region`` (x0, y0, x1, y1; bounds inclusive),
    >= ``spacing`` frames apart within a clip; single-detection stub
    tracks are ignored (§4.2)."""
    found: List[Tuple[int, int]] = []
    for ci, tracks in enumerate(all_tracks):
        per_frame: Dict[int, int] = {}
        for tr in tracks:
            if len(tr) < 2:
                continue
            for row in tr:
                cx, cy = row[1], row[2]
                if region[0] <= cx <= region[2] \
                        and region[1] <= cy <= region[3]:
                    per_frame[int(row[0])] = per_frame.get(
                        int(row[0]), 0) + 1
        for f, n in sorted(per_frame.items()):
            if n >= min_count and len(found) < want and not any(
                    c == ci and abs(f - g) < spacing for c, g in found):
                found.append((ci, f))
    return found


def reference_query(all_tracks: Sequence[Sequence[np.ndarray]],
                    fps: Sequence[int], *,
                    region=None,
                    time_range: Optional[Tuple[int, Optional[int]]] = None,
                    min_len: int = 1, min_count: int = 1,
                    limit: Optional[Tuple[int, int]] = None,
                    aggregate: str = "frames") -> dict:
    """The full query algebra as naive per-track Python: the oracle the
    compiled plan (indexed or not) must match exactly.

    ``region`` is (x0, y0, x1, y1) inclusive; ``time_range`` is
    (start, end) with end exclusive or None; ``limit`` is
    (want, min_spacing).  Returns ``{"frames": [(clip, frame), ...],
    "aggregates": {...}}`` shaped like ``plan.QueryResult``.
    """
    frames: List[Tuple[int, int]] = []
    n_match = 0
    seconds = 0.0
    total_tracks = 0
    for ci, tracks in enumerate(all_tracks):
        if limit is not None and len(frames) >= limit[0]:
            break
        per_frame: Dict[int, int] = {}
        clip_tracks = 0
        for tr in tracks:
            if len(tr) < min_len:
                continue
            touched = False
            for row in tr:
                f, cx, cy = int(row[0]), row[1], row[2]
                if region is not None and not (
                        region[0] <= cx <= region[2]
                        and region[1] <= cy <= region[3]):
                    continue
                if time_range is not None:
                    start, end = time_range
                    if f < start or (end is not None and f >= end):
                        continue
                touched = True
                per_frame[f] = per_frame.get(f, 0) + 1
            if touched:
                clip_tracks += 1
        total_tracks += clip_tracks
        hits = [f for f, n in sorted(per_frame.items())
                if n >= min_count]
        n_match += len(hits)
        seconds += len(hits) / max(fps[ci], 1)
        if limit is None:
            if aggregate == "frames":
                frames.extend((ci, f) for f in hits)
            continue
        picked: List[int] = []
        for f in hits:
            if len(frames) >= limit[0]:
                break
            if all(abs(f - g) >= limit[1] for g in picked):
                frames.append((ci, f))
                picked.append(f)
    aggregates: Dict[str, float] = {}
    if aggregate == "tracks":
        aggregates["tracks"] = total_tracks
    elif limit is None:
        aggregates["count"] = n_match
        aggregates["duration_seconds"] = seconds
    if aggregate in ("count", "duration"):
        frames = []
    return {"frames": frames, "aggregates": aggregates}
