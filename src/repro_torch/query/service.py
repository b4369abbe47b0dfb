"""QueryService: concurrent exploratory queries over one or MANY
TrackStores.

The port of the JAX package's ``repro.query.service``
(``src/repro/query/service.py``). The same code, host-side; cold clips
are extracted on the bank's device through ``TrackStore.ingest``.

The service is the subsystem's front door.  It fronts either a single
``TrackStore`` or a mapping ``{dataset_name: TrackStore}`` — a query's
clips are routed to the store owning their dataset (``profile.name``),
results are merged back in the caller's scan order, and
``Query.datasets`` optionally scopes a query to a subset of datasets
(clips outside the scope are dropped before the scan; surviving frames
keep their indices into the caller's clip list).

Any number of threads may call ``query`` concurrently; each call

  1. **consults the index** — each clip's persisted ``ClipSummary``
     (which survives eviction) is tested against the compiled plan;
     clips the summary proves irrelevant are neither warmed nor
     scanned, so a selective query over a partially-evicted store
     re-ingests nothing it does not actually need;
  2. **warms** the clips it still needs — cold clips are ingested
     through their store (one ingest at a time; concurrent queries
     needing the same cold clips wait on the ingest lock and then find
     them warm instead of extracting twice);
  3. **scans** the packed track arrays through the compiled plan
     (two-phase: histogram answers when the predicate is indexed, row
     scan otherwise — see ``repro_torch.query.plan``).

Every result carries a ``QueryStats`` with the latency split into
ingest vs scan time — the exploratory-analytics contract in numbers:
the FIRST query over a cold dataset pays extraction, every later query
pays only the millisecond-scale scan (BENCH_query.json records both).

``prefetch`` starts the ingest on a background daemon thread instead,
so an analyst's warm-up can overlap query formulation.  Queries over
already-materialized clips bypass the ingest lock entirely (their
latency stays millisecond-scale even while a large prefetch is in
flight); a query that still needs a cold clip waits for the in-flight
ingest to finish, then ingests whatever remains missing (the store's
``has`` makes ingest incremental at clip granularity).  With a query
(``prefetch(clips, q=...)``), the warm-up order is summary-aware:
never-materialized clips first, then clips the plan cannot skip by
descending predicted scan cost, summary-skippable clips last.

The service is also the subscription hub for LIVE streams
(``repro_torch.stream``): ``register_standing`` attaches a ``StandingQuery``
(bootstrapped against whatever is already materialized), and the
segment ingestor's ``notify_append`` fans each watermark advance out
to every subscriber, which folds the delta incrementally instead of
re-running the query.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.video_synth import Clip
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.recorder import crash_dump
from repro_torch.obs.trace import TRACER
from repro_torch.query.ops import Query
from repro_torch.query.plan import CompiledPlan, QueryResult, compile_query
from repro_torch.query.store import IngestReport, TrackStore

# A query whose working set was evicted mid-flight (θ swap or a budget
# smaller than the set) retries warm→get this many times before
# failing loudly instead of livelocking.
_WARM_ATTEMPTS = 3


@dataclass
class QueryStats:
    """Per-query latency accounting (seconds, wall clock) plus the
    plan-phase clip counters ``plan.run`` computes."""
    ingest_seconds: float = 0.0     # time spent materializing cold clips
    scan_seconds: float = 0.0       # time spent in the vectorized scan
    ingested_clips: int = 0
    plan: str = ""
    # plan-phase disposition of this query's clips (QueryResult
    # pass-throughs): summary-skipped, answered from the histogram
    # index, row-scanned, and the selected total
    skipped_clips: int = 0
    indexed_clips: int = 0
    scanned_clips: int = 0
    n_clips: int = 0
    # datasets this query actually touched, "+"-joined sorted names
    # (the latency_report per-dataset breakdown groups on it)
    datasets: str = ""

    @property
    def total_seconds(self) -> float:
        return self.ingest_seconds + self.scan_seconds


def summarize_latency(hist: Sequence["QueryStats"]) -> Dict[str, object]:
    """Aggregate a list of ``QueryStats`` into the ``latency_report``
    dict: the flat keys are unchanged from before the per-dataset
    breakdown (bit-compatible), the new clip-counter totals expose what
    ``plan.run`` always computed, and ``datasets`` groups queries by
    the datasets they touched.  Pure — tested directly."""
    if not hist:
        return {"queries": 0}

    def block(group: Sequence[QueryStats]) -> Dict[str, float]:
        scans = np.asarray(sorted(s.scan_seconds for s in group))
        return {
            "queries": len(group),
            "ingest_seconds_total": sum(s.ingest_seconds
                                        for s in group),
            "scan_seconds_total": sum(s.scan_seconds for s in group),
            "scan_seconds_median": float(np.median(scans)),
            "scan_seconds_p95": float(np.percentile(scans, 95)),
            "warm_queries": sum(1 for s in group
                                if s.ingested_clips == 0),
        }

    out: Dict[str, object] = block(hist)
    out["clips_skipped_total"] = sum(s.skipped_clips for s in hist)
    out["clips_indexed_total"] = sum(s.indexed_clips for s in hist)
    out["clips_scanned_total"] = sum(s.scanned_clips for s in hist)
    out["clips_total"] = sum(s.n_clips for s in hist)
    by: Dict[str, List[QueryStats]] = {}
    for s in hist:
        by.setdefault(s.datasets or "(none)", []).append(s)
    out["datasets"] = {name: block(group)
                       for name, group in sorted(by.items())}
    return out


class QueryService:
    """Thread-safe query answering with transparent cold-clip ingest,
    over one store or a ``{dataset: store}`` mapping."""

    def __init__(self, stores, history: int = 256):
        if isinstance(stores, TrackStore):
            self.stores: Dict[str, TrackStore] = {}
            self.default_store: Optional[TrackStore] = stores
        elif isinstance(stores, Mapping):
            self.stores = dict(stores)
            self.default_store = None
        else:
            raise TypeError(f"stores must be a TrackStore or a mapping "
                            f"of dataset name to TrackStore, got "
                            f"{type(stores).__name__}")
        self._ingest_lock = threading.Lock()
        self._hist_lock = threading.Lock()
        self._history: Deque[QueryStats] = deque(maxlen=history)  # guarded-by: _hist_lock
        self._standing_lock = threading.Lock()
        self._standing: List["StandingQuery"] = []  # guarded-by: _standing_lock

    @property
    def store(self) -> TrackStore:
        """Back-compat single-store accessor."""
        if self.default_store is not None:
            return self.default_store
        if len(self.stores) == 1:
            return next(iter(self.stores.values()))
        raise AttributeError("service fronts multiple stores; use "
                             "store_for(clip) or .stores")

    def store_for(self, clip: Clip) -> TrackStore:
        """The store owning the clip's dataset."""
        st = self.stores.get(clip.profile.name, self.default_store)
        if st is None:
            raise KeyError(f"no store for dataset "
                           f"{clip.profile.name!r} (have "
                           f"{sorted(self.stores)})")
        return st

    # -- ingest ---------------------------------------------------------------

    def warm(self, clips: Sequence[Clip],
             log=lambda *_: None) -> IngestReport:
        """Ingest whatever is cold, blocking until the clips are warm.
        Serialized: two queries racing for the same cold clips extract
        them once, not twice.  Fully-warm requests never touch the
        ingest lock, so queries over materialized clips keep their
        millisecond latency while a large background ingest (e.g. a
        ``prefetch`` of another split) is in flight."""
        total = IngestReport(requested=len(clips))
        # ONE group per store (keyed by identity, per-store clip order
        # preserved): each store ingests its whole share as a single
        # batch, keeping cross-clip decode prefetch and the
        # batch-protected eviction semantics even for interleaved
        # multi-dataset clip lists
        groups: Dict[int, Tuple[TrackStore, List[Clip]]] = {}
        for clip in clips:
            st = self.store_for(clip)
            groups.setdefault(id(st), (st, []))[1].append(clip)
        cold_groups = []
        for st, cs in groups.values():
            if all(st.has(c) for c in cs):
                total.cached += len(cs)
            else:
                cold_groups.append((st, cs))
        if not cold_groups:
            return total
        with self._ingest_lock:
            for st, cs in cold_groups:
                r = st.ingest(cs, log=log)
                total.ingested += r.ingested
                total.cached += r.cached
                total.frames += r.frames
                total.seconds += r.seconds
                total.wall_seconds += r.wall_seconds
                total.evicted += r.evicted
                total.evicted_bytes += r.evicted_bytes
                # store_bytes is a per-store snapshot, not a delta:
                # one batch per store makes summing them correct
                total.store_bytes += r.store_bytes
        return total

    def _prefetch_order(self, clips: Sequence[Clip],
                        plan) -> List[Clip]:
        """Summary-aware warm-up order for ``prefetch``:

          1. clips with NO summary first (never materialized — they
             must be extracted, and nothing can predict their cost);
          2. then clips the plan cannot skip, largest predicted scan
             cost first (``summary.n_rows`` — the row scan is O(rows),
             so big clips warming early shortens the worst query);
          3. summary-skippable clips last (the plan will never touch
             them; they only matter to ``use_index=False`` baselines).

        Within a tier the caller's order is kept (stable sort)."""
        def tier(clip: Clip) -> tuple:
            try:
                summary = self.store_for(clip).summary(clip)
            except KeyError:
                summary = None
            if summary is None:
                return (0, 0)
            if plan is not None and plan.can_skip(summary):
                return (2, -summary.n_rows)
            return (1, -summary.n_rows)
        return sorted(clips, key=tier)

    def prefetch(self, clips: Sequence[Clip],
                 q: Optional[Query] = None,
                 log=lambda *_: None) -> threading.Thread:
        """Kick off ``warm`` on a background daemon thread (returned so
        callers can join; queries never need to — they warm whatever
        the prefetch has not covered yet).  With ``q``, clips warm in
        summary-aware order: unskippable clips first, largest predicted
        scan cost first, so the query that prompted the prefetch gets
        its working set earliest."""
        plan = compile_query(q) if q is not None else None
        ordered = self._prefetch_order(clips, plan)
        th = threading.Thread(target=self.warm, args=(ordered,),
                              kwargs={"log": log}, daemon=True,
                              name="trackstore-ingest")
        th.start()
        return th

    # -- standing queries (live ingestion, repro_torch.stream) ----------------

    def register_standing(self, sq) -> object:
        """Subscribe a ``repro_torch.stream.StandingQuery``: it first catches
        up on already-materialized data (``bootstrap``), then receives
        every watermark advance via ``notify_append``.  Returns the
        query for chaining.

        Bootstrap and subscription happen under the SAME lock that
        serializes delta delivery — an append landing while a query
        registers is therefore seen exactly once, either by the
        bootstrap's store read or as a delivered delta, never neither
        (a delta that fell in the gap would be unrecoverable: later
        deltas only carry later rows)."""
        with self._standing_lock:
            sq.bootstrap(self)
            self._standing.append(sq)
        return sq

    def unregister_standing(self, sq) -> None:
        with self._standing_lock:
            if sq in self._standing:
                self._standing.remove(sq)

    def notify_append(self, clip: Clip, packed, delta) -> List[object]:
        """Fan one watermark advance out to every standing query
        (called by ``SegmentIngestor.append``).  Delivery holds the
        subscription lock — see ``register_standing``.  Returns the
        non-None standing deltas."""
        out = []
        with self._standing_lock:
            for sq in self._standing:
                d = sq.on_append(clip, packed, delta)
                if d is not None:
                    out.append(d)
        return out

    # -- queries --------------------------------------------------------------

    def _gather(self, plan: CompiledPlan,
                selected: Sequence[Tuple[int, Clip]], use_index: bool,
                stats: "QueryStats", log) -> List[tuple]:
        """Warm (index-aware) and collect (clip, packed, summary)
        entries for the scan.  Summaries (and the skip decisions made
        from them) are re-read on every attempt, and an attempt only
        counts as successful if no store's θ-fingerprint moved while it
        ran — a set_params racing the query can therefore trigger a
        retry but never a silently mixed-θ answer.  Retries when
        eviction or a θ swap races the warm-up; raises after
        ``_WARM_ATTEMPTS``."""
        def skippable(s):
            return use_index and plan.can_skip(s)

        for _ in range(_WARM_ATTEMPTS):
            stores = {id(self.store_for(c)): self.store_for(c)
                      for _, c in selected}
            fps = {sid: st.fingerprint for sid, st in stores.items()}
            summaries = [self.store_for(c).summary(c)
                         for _, c in selected]
            need = [c for (_, c), s in zip(selected, summaries)
                    if not skippable(s)]
            report = self.warm(need, log=log)
            stats.ingested_clips += report.ingested
            entries, missing = [], []
            for (_, c), s in zip(selected, summaries):
                packed = None
                if not skippable(s):
                    packed = self.store_for(c).get(c)
                    if packed is None:
                        missing.append(c)
                entries.append((c, packed, s))
            stable = all(st.fingerprint == fps[sid]
                         for sid, st in stores.items())
            if not missing and stable:
                return entries
        raise RuntimeError(
            f"clips still cold after {_WARM_ATTEMPTS} warm attempts "
            f"(θ kept changing mid-query, or the store budget is too "
            f"small for this query's working set)")

    def query(self, q: Query, clips: Sequence[Clip],
              log=lambda *_: None, use_index: bool = True) -> QueryResult:
        """Answer ``q`` over ``clips`` (scan order = list order;
        ``q.datasets`` drops out-of-scope clips first).  Frame indices
        in the result refer to positions in ``clips``.
        ``use_index=False`` forces the full row scan — the differential
        baseline the indexed path is tested against."""
        if TRACER.enabled:
            with TRACER.span("query.run", "query") as sp:
                result = self._query(q, clips, log, use_index)
                st = result.stats
                sp.args = {"plan": st.plan, "datasets": st.datasets,
                           "ingested": st.ingested_clips,
                           "skipped": st.skipped_clips,
                           "indexed": st.indexed_clips,
                           "scanned": st.scanned_clips}
                return result
        return self._query(q, clips, log, use_index)

    def _query(self, q: Query, clips: Sequence[Clip], log,
               use_index: bool) -> QueryResult:
        try:
            return self._query_inner(q, clips, log, use_index)
        except BaseException as exc:
            REGISTRY.counter("query.errors").inc()
            # black box: no-op unless a FlightRecorder is installed
            crash_dump("query.run", exc)
            raise

    def _query_inner(self, q: Query, clips: Sequence[Clip], log,
                     use_index: bool) -> QueryResult:
        stats = QueryStats()
        plan = compile_query(q)
        stats.plan = plan.describe()
        selected = [(i, c) for i, c in enumerate(clips)
                    if q.datasets is None
                    or c.profile.name in q.datasets]
        stats.datasets = "+".join(
            sorted({c.profile.name for _, c in selected}))
        t0 = time.perf_counter()
        entries = self._gather(plan, selected, use_index, stats, log)
        stats.ingest_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = plan.run(entries, use_index=use_index)
        # plan indices are positions in `selected`; map back to `clips`
        result.frames = [(selected[j][0], f) for j, f in result.frames]
        stats.scan_seconds = time.perf_counter() - t0
        stats.skipped_clips = result.skipped_clips
        stats.indexed_clips = result.indexed_clips
        stats.scanned_clips = result.scanned_clips
        stats.n_clips = result.n_clips
        result.stats = stats
        with self._hist_lock:
            self._history.append(stats)
        REGISTRY.counter("query.count").inc()
        REGISTRY.histogram("query.scan_seconds").observe(
            stats.scan_seconds)
        REGISTRY.histogram("query.ingest_seconds").observe(
            stats.ingest_seconds)
        REGISTRY.counter("query.clips.skipped").inc(stats.skipped_clips)
        REGISTRY.counter("query.clips.indexed").inc(stats.indexed_clips)
        REGISTRY.counter("query.clips.scanned").inc(stats.scanned_clips)
        log(f"[query] {stats.plan}: ingest={stats.ingest_seconds:.3f}s "
            f"({stats.ingested_clips} clips) "
            f"scan={stats.scan_seconds * 1e3:.2f}ms "
            f"(skipped {result.skipped_clips}, indexed "
            f"{result.indexed_clips} of {result.n_clips})")
        return result

    # -- reporting ------------------------------------------------------------

    def latency_report(self) -> Dict[str, object]:
        """Aggregate ingest/scan split over the recorded history
        (``summarize_latency``): the flat keys of the original report,
        plus the plan-phase clip-counter totals and a per-dataset
        breakdown keyed by the datasets each query touched.  Median and
        p95 use linear interpolation (an even-length history averages
        the two middle scans rather than reporting the upper one)."""
        with self._hist_lock:
            hist: List[QueryStats] = list(self._history)
        return summarize_latency(hist)
