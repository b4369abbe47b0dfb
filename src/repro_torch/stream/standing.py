"""Standing queries: register once, receive exact deltas per watermark.

The port of the JAX package's ``repro.stream.standing``
(``src/repro/stream/standing.py``). The same code, pure Python.

A ``StandingQuery`` wraps a regular ``repro_torch.query.ops.Query`` and is
re-evaluated INCREMENTALLY every time a segment append advances an open
clip's watermark.  The evaluation never rescans materialized rows:

  * the segment ingestor's index merge already computes, per watermark,
    exactly the visible rows never delivered before (``TrackDelta``);
    the standing evaluation scans ONLY those rows — each visible row of
    the stream is examined once, ever (counter-asserted by
    ``rows_scanned`` in tests and benchmarks/stream_bench.py);
  * rows of tracks still below the plan's ``min_len`` are pre-filtered
    (region/time) and parked per track as frame lists; when the track
    crosses the threshold the parked FRAMES are folded in — the raw
    rows are not touched again;
  * per-frame surviving counts are maintained as a running array, so a
    watermark's newly matching frames fall out of the same pass that
    updates the counts;
  * a clip whose post-append summary proves every visible row region-
    or time-disjoint (``CompiledPlan.row_disjoint`` — bbox, occupancy
    grid, frame span) drops its delta outright: those predicates are
    static, so rows failing them now fail them forever.

The fold is PURE PYTHON over the merge's shared per-delta lists
(``WatermarkDelta.finalize``): a delta is a few dozen rows, where each
numpy call costs more in dispatch than the whole loop costs in
arithmetic — the python fold is ~5x faster at delta scale and keeps
the per-watermark latency independent of how many clips (or how much
history) the store holds, which is what buys the >= 10x gap over
re-running the ad-hoc scan per watermark (BENCH_stream.json).

Why deltas are EXACT: with refinement banned on the stream path, raw
tracks are append-only, so a frame's surviving count under any fixed
(region, time, min_len) predicate is monotone non-decreasing in the
watermark — a frame that matches ``count >= k`` stays matched, and the
accumulated emissions at any watermark reconstruct bit-for-bit the
ad-hoc answer over the store at that watermark (differentially asserted
against ``plan.CompiledPlan.run`` and ``ref.reference_query`` at every
watermark, tests/test_stream.py).

Not supported (rejected at registration): ``Limit`` (its early-exit
answer is not monotone — a late-arriving earlier frame would displace
an already-emitted one) and class filters (a growing track can change
pattern class, so class membership is not monotone either).  Both still
work ad-hoc over open clips.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.data.video_synth import Clip
from repro_torch.query.ops import Query
from repro_torch.query.plan import CompiledPlan, QueryResult, compile_query
from repro_torch.query.store import ClipKey, PackedTracks, clip_key
from repro_torch.stream.state import WatermarkDelta

_ids = itertools.count()


@dataclass
class StandingDelta:
    """What one watermark advance changed for one standing query."""
    query_id: int
    key: ClipKey
    watermark: int
    new_frames: List[Tuple[int, int]] = field(default_factory=list)
    count_delta: int = 0
    duration_delta: float = 0.0
    tracks_delta: int = 0       # "tracks" aggregate only
    rows_scanned: int = 0       # raw delta rows examined (the counter)
    skipped: bool = False       # summary proved the delta irrelevant

    @property
    def empty(self) -> bool:
        return not self.new_frames and not self.tracks_delta


@dataclass
class _ClipState:
    """Per-(standing query, clip) incremental evaluation state.
    Plain-Python containers throughout — see the module docstring."""
    counts: List[int]                   # per-frame surviving counts
    emitted: Set[int]                   # frames already matched
    pending: Dict[int, List[int]] = field(default_factory=dict)
    qualified: Set[int] = field(default_factory=set)  # past min_len
    contributing: Set[int] = field(default_factory=set)
    delivered: Dict[int, int] = field(default_factory=dict)
    synced: int = 0     # watermark folded so far (fast-path sequencing)


class StandingQuery:
    """One registered query over a fixed clip list.  Thread-safe: the
    ingestor's notification and a reader's ``result()`` may race."""

    def __init__(self, q: Query, clips: Sequence[Clip],
                 name: str = "", history: int = 1024):
        plan = compile_query(q)
        if plan.limit is not None:
            raise ValueError(
                "standing queries do not compose with Limit: the "
                "limit scan's early-exit answer is not monotone under "
                "appends (run it ad-hoc instead)")
        if plan.classes is not None:
            raise ValueError(
                "standing queries do not support class filters: a "
                "growing track can change pattern class mid-stream")
        self.id = next(_ids)
        self.name = name or f"standing-{self.id}"
        self.q = q
        self.plan: CompiledPlan = plan
        self.clips = list(clips)
        self._pos: Dict[ClipKey, int] = {
            clip_key(c): i for i, c in enumerate(self.clips)}
        self._fps: Dict[ClipKey, int] = {
            clip_key(c): c.profile.fps for c in self.clips}
        self._frames: Dict[ClipKey, int] = {
            clip_key(c): c.n_frames for c in self.clips}
        self._scoped_out = {
            k for k, c in zip(self._pos, self.clips)
            if plan.datasets is not None
            and c.profile.name not in plan.datasets}
        self._state: Dict[ClipKey, _ClipState] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # lifetime counters: every delivered row is exactly one of
        # scanned / summary-skipped
        self.rows_scanned = 0           # guarded-by: _lock
        self.rows_skipped = 0           # guarded-by: _lock
        self.clips_skipped = 0          # guarded-by: _lock
        from repro_torch.obs.metrics import REGISTRY
        self._m_scanned = REGISTRY.counter("standing.rows_scanned")
        self._m_skipped = REGISTRY.counter("standing.rows_skipped")
        self._m_clips_skipped = REGISTRY.counter(
            "standing.clips_skipped")
        # recent per-watermark deltas — BOUNDED: the accumulated answer
        # lives in the per-clip counts/emitted state, so an always-on
        # stream must not grow memory per append (consumers wanting
        # every delta read them as they arrive from on_append)
        self.deltas: Deque[StandingDelta] = deque(maxlen=history)  # guarded-by: _lock

    # -- registration-time catch-up -------------------------------------------

    def bootstrap(self, service) -> List[StandingDelta]:
        """Catch up on clips already (partially) materialized when the
        query registers mid-stream: each clip's current packed rows are
        fed through the same delta path as one initial batch."""
        out = []
        for clip in self.clips:
            key = clip_key(clip)
            if key in self._scoped_out:
                continue
            try:
                store = service.store_for(clip)
            except KeyError:
                continue
            packed = store.get(clip)
            if packed is None:
                continue
            delta = WatermarkDelta(
                packed.watermark if packed.watermark is not None
                else packed.n_frames)
            from repro_torch.stream.state import TrackDelta
            for i in range(packed.n_tracks):
                tr = packed.track(i)
                if not len(tr):
                    continue
                delta.tracks.append(
                    TrackDelta(int(tr[0, 5]), 0, len(tr), tr))
                delta.rows_delivered += len(tr)
            out.append(self.on_append(clip, packed, delta))
        return out

    # -- the incremental evaluation -------------------------------------------

    def on_append(self, clip: Clip, packed: PackedTracks,
                  delta: WatermarkDelta) -> Optional[StandingDelta]:
        """Fold one watermark's track deltas in; returns this query's
        delta (None when the clip is not subscribed)."""
        key = clip_key(clip)
        pos = self._pos.get(key)
        if pos is None or key in self._scoped_out:
            return None
        with self._lock:
            sd = StandingDelta(self.id, key, delta.watermark)
            if self.plan.row_disjoint(packed.summary):
                # every visible row fails a STATIC row predicate —
                # including this delta's rows (they are visible in this
                # summary), so dropping them is permanent-safe
                sd.skipped = True
                self.clips_skipped += 1
                self.rows_skipped += delta.rows_delivered
                self._m_clips_skipped.inc()
                self._m_skipped.inc(delta.rows_delivered)
                self.deltas.append(sd)
                return sd
            st = self._state.get(key)
            if st is None:
                st = _ClipState([0] * self._frames[key], set())
                self._state[key] = st
            self._fold(st, delta, sd, pos)
            self.rows_scanned += sd.rows_scanned
            self._m_scanned.inc(sd.rows_scanned)
            self.deltas.append(sd)
            return sd

    def _fold(self, st: _ClipState, delta: WatermarkDelta,
              sd: StandingDelta, pos: int) -> None:
        """Fold the delta's rows into the running counts — one pure-
        Python pass (region/time filter, count update, match emission
        fused).  The sequential fast path consumes the merge's SHARED
        lists directly; the slow path (a registration racing an append)
        re-slices per track against ``delivered``."""
        if delta.rows_list is not None \
                and st.synced == delta.prev_watermark:
            rows = delta.rows_list
            tids, lens, ns = delta.tid_list, delta.len_list, delta.n_list
            if tids:
                st.delivered.update(zip(tids, lens))
        else:                           # overlap-safe slow path
            rows, tids, lens, ns = [], [], [], []
            for td in delta.tracks:
                already = st.delivered.get(td.track_id, 0)
                if td.new_len <= already:
                    continue            # bootstrap overlap guard
                seg = td.rows[max(0, already - td.prev_len):].tolist()
                st.delivered[td.track_id] = td.new_len
                rows.extend(seg)
                tids.append(td.track_id)
                lens.append(td.new_len)
                ns.append(len(seg))
        st.synced = delta.watermark
        if not rows:
            return
        sd.rows_scanned = len(rows)
        plan = self.plan
        min_len, min_count = plan.min_len, plan.min_count
        region, trange = plan.region, plan.time_range
        if region is not None:
            x0, y0, x1, y1 = region.x0, region.y0, region.x1, region.y1
        if trange is not None:
            t0, t1 = trange.start, trange.end
        track_agg = plan.aggregate == "tracks"
        counts, emitted = st.counts, st.emitted
        qualified, pending = st.qualified, st.pending
        contributing = st.contributing
        hits: List[int] = []
        # the unfiltered count/frames/duration query over mature tracks
        # is the steady-state workload: one tight loop, no per-row
        # branches (each delta row is a count bump + match test)
        plain = region is None and trange is None and not track_agg
        i = 0
        for k, tid in enumerate(tids):
            n = ns[k]
            end = i + n
            q = lens[k] >= min_len
            if q and tid not in qualified:
                qualified.add(tid)
                parked = pending.pop(tid, None)
                if parked:              # flushed frames count — and the
                    if track_agg and tid not in contributing:
                        contributing.add(tid)
                        sd.tracks_delta += 1
                    for f in parked:
                        c = counts[f] + 1
                        counts[f] = c
                        if c >= min_count and f not in emitted:
                            emitted.add(f)
                            hits.append(f)
            if plain and q:
                for row in rows[i:end]:
                    f = int(row[0])
                    c = counts[f] + 1
                    counts[f] = c
                    if c >= min_count and f not in emitted:
                        emitted.add(f)
                        hits.append(f)
                i = end
                continue
            for row in rows[i:end]:
                if region is not None and not (
                        x0 <= row[1] <= x1 and y0 <= row[2] <= y1):
                    continue
                f = int(row[0])
                if trange is not None and (
                        f < t0 or (t1 is not None and f >= t1)):
                    continue
                if not q:               # young track: park the frame
                    pending.setdefault(tid, []).append(f)
                    continue
                if track_agg and tid not in contributing:
                    contributing.add(tid)
                    sd.tracks_delta += 1
                c = counts[f] + 1
                counts[f] = c
                if c >= min_count and f not in emitted:
                    emitted.add(f)
                    hits.append(f)
            i = end
        if hits:
            hits.sort()
            sd.new_frames = [(pos, f) for f in hits]
            sd.count_delta = len(hits)
            sd.duration_delta = len(hits) / max(self._fps[sd.key], 1)

    # -- accumulated answer ---------------------------------------------------

    def result(self) -> QueryResult:
        """The accumulated answer — shaped exactly like
        ``CompiledPlan.run`` over the same clips at the current
        watermarks (differentially asserted)."""
        res = QueryResult(n_clips=len(self.clips))
        with self._lock:
            n_match = 0
            seconds = 0.0
            total_tracks = 0
            frames: List[Tuple[int, int]] = []
            for clip in self.clips:
                key = clip_key(clip)
                st = self._state.get(key)
                if st is None:
                    continue
                hits = sorted(st.emitted)
                n_match += len(hits)
                seconds += len(hits) / max(self._fps[key], 1)
                total_tracks += len(st.contributing)
                frames.extend((self._pos[key], f) for f in hits)
        if self.plan.aggregate == "tracks":
            res.aggregates["tracks"] = total_tracks
        else:
            res.aggregates["count"] = n_match
            res.aggregates["duration_seconds"] = seconds
        if self.plan.aggregate == "frames":
            res.frames = frames
        return res
