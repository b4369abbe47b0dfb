"""SegmentIngestor: append frame segments to open clips, keeping every
query answerable in between.

The port of the JAX package's ``repro.stream.ingest``
(``src/repro/stream/ingest.py``), the same code; each segment runs
through the port's ``ClipExecutor.start(frame_ids=, tracker=)`` on the
bank's device (the card unless the bank was built on the CPU).  As in
the reference, a segment boundary changes the chunks, and with them the
batches of the conv nets (the detector and the tracker's crop CNN),
which move by up to an f32 ulp with their batch: appends equal a one-
shot ingest bit for bit where the batches stay the same (segments of
whole chunks at gap 1), and otherwise within that drift.

The live-ingestion pipeline, per appended segment:

  1. the segment's frame ids are the next slice of θ's gap progression
     (the frame CURSOR survives segment boundaries that fall between
     gap strides);
  2. the executor's stage graph runs over exactly those frames
     (``ClipExecutor.start(frame_ids=..., tracker=...)``), with the
     open clip's resumed tracker — DECODE prefetch, chunked PROXY /
     DETECT and the per-chunk crop-embedding batching all apply
     unchanged, and appends can share one ``DecodePool``.  A FLEET of
     cameras (one ingestor per feed, each appending from its own
     thread) passes one shared ``executor.BatchBroker`` through
     ``ExecutorOptions.batch_broker`` so every feed's per-segment
     windows — typically 1-2 per size class — coalesce into
     consolidated detector dispatches; per-feed tracks stay
     bit-identical (the broker invariant), only the batching changes;
  3. the tracker's visible tracks are packed at the new watermark and
     the clip's secondary index is INCREMENTALLY merged
     (``StreamIndexState``) — no full rebuild;
  4. the result lands in the ``TrackStore`` under the open-clip NPZ
     layout (monotone ``watermark``), atomically, so concurrent
     queries see either the previous prefix or the new one;
  5. a ``TrackerCheckpoint`` sidecar is persisted, so a NEW ingestor
     (same process or not) resumes the stream bit-identically;
  6. registered standing queries are notified with the watermark's
     track deltas (``QueryService.notify_append``).

Bit-identity contract: ingesting a clip as ANY sequence of segment
appends yields the same tracks, rows, histograms and summaries as a
one-shot batch ingest — chunking never changes per-frame results
(tests/test_executor.py) and TRACK state is carried exactly
(``TrackerCheckpoint``), so only the schedule differs.  Asserted across
segment sizes and θ in tests/test_stream.py.

Track refinement is a batch-finalization step (it rewrites already-
emitted rows, breaking the append-only property every incremental
structure here relies on), so θ with ``refine=True`` is rejected at
construction; live deployments serve raw tracks and refine offline.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.executor import STAGES, ClipExecutor, ExecutorOptions
from repro_torch.core.pipeline import RunResult
from repro_torch.data.video_synth import Clip
from repro_torch.obs.metrics import (REGISTRY, DriftMonitor, drift_enabled,
                                     empty_stage_block)
from repro_torch.obs.recorder import crash_dump
from repro_torch.obs.trace import TRACER
from repro_torch.query.store import ClipKey, PackedTracks, TrackStore, clip_key
from repro_torch.stream.checkpoint import TrackerCheckpoint
from repro_torch.stream.state import StreamIndexState, WatermarkDelta

CKPT_SUFFIX = "ckpt.npz"


@dataclass
class AppendReport:
    """What one ``append`` call did."""
    key: ClipKey
    watermark: int              # frames visible after this append
    appended: int               # frames this append advanced by
    frames_processed: int       # gap-progression frames actually run
    seconds: float = 0.0        # RunResult cost-model seconds
    wall_seconds: float = 0.0   # wall clock: executor + index + store
    store_seconds: float = 0.0  # of which index merge + NPZ landing
    standing_seconds: float = 0.0   # of which standing-query deltas
    rows_total: int = 0         # visible rows at the new watermark
    rows_delivered: int = 0     # rows newly delivered to the index
    sealed: bool = False
    delta: Optional[WatermarkDelta] = None
    # per-stage executor profile for this segment (RunResult pass-
    # throughs): stage -> {"wall": s, "process": s}, and device
    # dispatch counts per stage
    stage_seconds: Optional[Dict[str, Dict[str, float]]] = None
    dispatches: Optional[Dict[str, int]] = None
    # per-stream drift summary (obs.DriftMonitor.summary()); populated
    # only while obs.enable_drift() is on
    drift: Optional[dict] = None


@dataclass
class _OpenClip:
    """Mutable per-open-clip stream state."""
    clip: Clip
    tracker: object
    cursor: int                 # next gap-progression frame to decode
    watermark: int
    index: StreamIndexState
    seconds: float = 0.0        # accumulated RunResult seconds
    counters: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    drift: Optional[DriftMonitor] = None    # lazy, drift-enabled only


class SegmentIngestor:
    """Drives live segment appends for one ``TrackStore`` version.

    One ingestor owns the open clips it has ``open``-ed; appends are
    serialized under one lock (the executor already parallelizes
    inside a segment).  ``service`` (a ``QueryService``) is notified
    after every append so standing queries re-evaluate incrementally.
    """

    def __init__(self, store: TrackStore, service=None,
                 options: Optional[ExecutorOptions] = None,
                 checkpoint_every: int = 1):
        if store.bank is None:
            raise ValueError("live ingestion needs a store with a "
                             "model bank")
        if store.params.refine:
            raise ValueError(
                "live ingestion requires refine=False: refinement "
                "rewrites already-served rows, breaking the stream's "
                "append-only contract (refine offline after sealing)")
        self.store: TrackStore = store
        self.service: Optional["QueryService"] = service
        self.options = options or ExecutorOptions()
        self.checkpoint_every = max(0, int(checkpoint_every))
        self._executor = ClipExecutor(store.bank, store.params,
                                      self.options)
        self._open: Dict[ClipKey, _OpenClip] = {}  # guarded-by: _lock
        self._appends: Dict[ClipKey, int] = {}  # guarded-by: _lock
        self._lock = threading.RLock()

    # -- lifecycle ------------------------------------------------------------

    def open(self, clip: Clip) -> int:
        """Open a clip for appends; returns the current watermark (0
        for a fresh stream, the persisted watermark when resuming a
        stream another ingestor checkpointed).

        Resume tolerates a checkpoint BEHIND the stored watermark —
        the normal state when ``checkpoint_every > 1``, or after a
        crash between the store landing and the sidecar write: the
        stream ROLLS BACK to the checkpoint (index state rebuilt from
        the checkpointed tracker, store re-materialized at its
        watermark), and re-appending the rolled-back frames is
        deterministic, so the sealed clip is still bit-identical."""
        key = clip_key(clip)
        with self._lock:
            if key in self._open:
                return self._open[key].watermark
            ckpt_path = self.store.sidecar_path(clip, CKPT_SUFFIX)
            packed = self.store.get(clip)
            mid_stream = packed is not None \
                and packed.watermark is not None \
                and packed.watermark < clip.n_frames
            if mid_stream:
                try:
                    ckpt = TrackerCheckpoint.load(ckpt_path)
                except FileNotFoundError:
                    raise RuntimeError(
                        f"open clip {key} has watermark "
                        f"{packed.watermark} but no tracker checkpoint "
                        f"at {ckpt_path}; cannot resume")
                if ckpt.watermark > packed.watermark:
                    raise RuntimeError(
                        f"checkpoint watermark {ckpt.watermark} is "
                        f"AHEAD of stored watermark "
                        f"{packed.watermark} for {key}: the sidecar "
                        f"does not match this store")
                state = self._resume(clip, ckpt, packed)
            elif packed is not None:
                raise RuntimeError(
                    f"clip {key} is already fully materialized for "
                    f"this θ; nothing to append")
            else:
                state = _OpenClip(clip, self._fresh_tracker(), 0, 0,
                                  StreamIndexState(clip.n_frames))
            self._open[key] = state
            return state.watermark

    def _resume(self, clip: Clip, ckpt: TrackerCheckpoint,
                packed: PackedTracks) -> _OpenClip:
        """Rebuild live state from a checkpoint.  When the sidecar
        matches the stored watermark the persisted index IS the merge
        state (cheap path); otherwise roll back: replay the
        checkpointed tracker's visible tracks into a fresh index and
        re-materialize the store at the checkpoint's watermark."""
        tracker = ckpt.restore(self.store.bank, self.store.params,
                               self.options)
        if ckpt.watermark == packed.watermark:
            return _OpenClip(
                clip, tracker, ckpt.cursor, ckpt.watermark,
                StreamIndexState.from_packed(packed, clip.n_frames),
                seconds=packed.seconds,
                counters=list(packed.counters) or [0, 0, 0, 0])
        index = StreamIndexState(clip.n_frames)
        tracks = tracker.result()
        index.merge(tracks, ckpt.watermark)
        rolled = PackedTracks.pack(tracks, clip,
                                   n_frames=ckpt.watermark, build=False)
        rolled.seconds = ckpt.seconds
        rolled.counters = tuple(ckpt.counters)
        rolled.watermark = ckpt.watermark
        index.attach(rolled, ckpt.watermark)
        self.store.materialize_packed(clip, rolled)
        return _OpenClip(clip, tracker, ckpt.cursor, ckpt.watermark,
                         index, seconds=ckpt.seconds,
                         counters=list(ckpt.counters))

    def _fresh_tracker(self):
        """Same construction every other execution path does — built
        here so the instance can be carried across segment runs."""
        from repro_torch.core.pipeline import make_tracker
        return make_tracker(self.store.bank, self.store.params,
                            device_assign=self.options.device_assign,
                            device_tracker=self.options.device_tracker)

    def watermark(self, clip: Clip) -> int:
        with self._lock:
            return self._open[clip_key(clip)].watermark

    # -- appends --------------------------------------------------------------

    def append(self, clip: Clip, n_frames: int) -> AppendReport:
        """Append the next ``n_frames`` frames of the camera feed to
        the open clip: run the stage graph over the segment, merge the
        index, land the watermark in the store, notify standing
        queries.  Clamped at the clip's end; the final append seals the
        clip (its NPZ becomes byte-for-byte the batch-ingest layout,
        minus the timing field)."""
        if TRACER.enabled:
            stream = f"{clip.profile.name}/{clip.split}{clip.clip_id}"
            with TRACER.span("stream.append", "stream",
                             stream=stream) as sp:
                rep = self._append(clip, n_frames)
                sp.args = {"watermark": rep.watermark,
                           "appended": rep.appended,
                           "rows_delivered": rep.rows_delivered,
                           "sealed": rep.sealed}
                return rep
        return self._append(clip, n_frames)

    def _append(self, clip: Clip, n_frames: int) -> AppendReport:
        try:
            return self._append_inner(clip, n_frames)
        except BaseException as exc:
            # black box (no-op unless a FlightRecorder is installed):
            # the dump's checkpoint pointer is the sidecar an operator
            # resumes the stream from after the crash
            crash_dump(
                "stream.append", exc,
                checkpoint=self.store.sidecar_path(clip, CKPT_SUFFIX),
                extra={"stream": f"{clip.profile.name}/{clip.split}"
                                 f"{clip.clip_id}",
                       "requested_frames": int(n_frames)})
            raise

    def _append_inner(self, clip: Clip, n_frames: int) -> AppendReport:
        t_wall = time.perf_counter()
        if int(n_frames) < 0:
            raise ValueError(f"cannot append {n_frames} frames: "
                             f"watermarks are monotone")
        key = clip_key(clip)
        with self._lock:
            st = self._open.get(key)
            if st is None:
                raise KeyError(f"clip {key} is not open (call open())")
            hi = min(st.watermark + int(n_frames), clip.n_frames)
            ids = list(range(st.cursor, hi, self.store.params.gap))
            result = self._run_segment(st, ids)
            st.cursor += self.store.params.gap * len(ids)
            appended = hi - st.watermark
            st.watermark = hi
            st.seconds += result.seconds
            st.counters[0] += result.frames_processed
            st.counters[1] += result.detector_windows
            st.counters[2] += result.full_frames
            st.counters[3] += result.skipped_frames
            sealed = st.watermark >= clip.n_frames

            t_store = time.perf_counter()
            delta = st.index.merge(result.tracks, st.watermark)
            packed = PackedTracks.pack(
                result.tracks, clip, n_frames=st.watermark, build=False)
            packed.seconds = st.seconds
            packed.counters = tuple(st.counters)
            packed.watermark = None if sealed else st.watermark
            st.index.attach(packed, st.watermark)
            self._appends[key] = self._appends.get(key, 0) + 1
            ckpt_due = bool(
                self.checkpoint_every
                and self._appends[key] % self.checkpoint_every == 0)
            # index.json flushes ride the checkpoint cadence: the NPZ
            # (always current) + sidecar are the resume state, and the
            # in-memory entry serves in-process queries, so re-writing
            # every dataset summary per append would pay O(all clips)
            # for one watermark field
            self.store.materialize_packed(clip, packed,
                                          flush=sealed or ckpt_due)
            if sealed:
                self._remove_checkpoint(clip)
                self._open.pop(key, None)
                self._appends.pop(key, None)
            elif ckpt_due:
                self.checkpoint(clip)
            store_seconds = time.perf_counter() - t_store

            report = AppendReport(
                key, st.watermark, appended, len(ids),
                seconds=result.seconds, store_seconds=store_seconds,
                rows_total=len(packed.rows),
                rows_delivered=delta.rows_delivered,
                sealed=sealed, delta=delta,
                stage_seconds=result.stage_seconds,
                dispatches=result.dispatches)
            if self.service is not None:
                t_sq = time.perf_counter()
                self.service.notify_append(clip, packed, delta)
                report.standing_seconds = time.perf_counter() - t_sq
            report.wall_seconds = time.perf_counter() - t_wall
            if drift_enabled():
                if st.drift is None:
                    st.drift = DriftMonitor()
                    # the summary also rides REGISTRY.snapshot() (and
                    # with it /metrics scrapers' /snapshot view) as a
                    # zero-copy provider: the snapshot call reads the
                    # live monitor, appends pay nothing extra
                    stream = (f"{clip.profile.name}/{clip.split}"
                              f"{clip.clip_id}")
                    REGISTRY.provider(f"stream.drift[{stream}]",
                                      st.drift.summary)
                st.drift.observe(st.watermark,
                                 proxy_fracs=result.proxy_fracs,
                                 track_count=len(result.tracks))
                report.drift = st.drift.summary()
            self._publish(clip, report)
            return report

    def _publish(self, clip: Clip, report: AppendReport) -> None:
        """Fold one append into the registry: live-path latency
        histograms plus the per-clip watermark gauges the fleet
        dashboard reads (lag = how long this watermark took to land in
        the store from the moment append() was called)."""
        REGISTRY.counter("stream.appends").inc()
        REGISTRY.histogram("stream.append.wall_seconds").observe(
            report.wall_seconds)
        REGISTRY.histogram("stream.append.store_seconds").observe(
            report.store_seconds)
        if self.service is not None:
            REGISTRY.histogram("stream.append.standing_seconds").observe(
                report.standing_seconds)
        stream = f"{clip.profile.name}/{clip.split}{clip.clip_id}"
        REGISTRY.gauge(f"stream.watermark[{stream}]").set(
            report.watermark)
        REGISTRY.gauge(f"stream.watermark_lag_seconds[{stream}]").set(
            report.wall_seconds)

    def _run_segment(self, st: _OpenClip,
                     ids: Sequence[int]) -> RunResult:
        if not ids:
            # segment smaller than the gap stride: nothing to run, but
            # the watermark still advances (and queries still answer);
            # the zero stage block keeps AppendReport.stage_seconds
            # uniformly shaped across appends
            return RunResult(st.tracker.result(), 0.0, 0, 0, 0, 0,
                             stage_seconds=empty_stage_block(STAGES),
                             dispatches={"proxy": 0, "detect": 0,
                                         "track": 0})
        run = self._executor.start(st.clip, frame_ids=ids,
                                   tracker=st.tracker)
        return self._executor.finish(run)

    # -- checkpoints ----------------------------------------------------------

    def checkpoint(self, clip: Clip) -> str:
        """Persist the open clip's tracker checkpoint sidecar; returns
        its path.  With the store's NPZ (always current), this is the
        complete resume state."""
        key = clip_key(clip)
        with self._lock:
            st = self._open[key]
            path = self.store.sidecar_path(clip, CKPT_SUFFIX)
            TrackerCheckpoint.capture(
                st.tracker, st.cursor, st.watermark,
                counters=st.counters, seconds=st.seconds).save(path)
            return path

    def _remove_checkpoint(self, clip: Clip) -> None:
        import os
        try:
            os.remove(self.store.sidecar_path(clip, CKPT_SUFFIX))
        except FileNotFoundError:
            pass

    def seal(self, clip: Clip) -> PackedTracks:
        """Append whatever remains and return the final packed clip —
        bit-identical (tracks, rows, hist, bboxes, summary, counters)
        to a one-shot batch ingest of the same clip."""
        key = clip_key(clip)
        with self._lock:
            if key in self._open:
                self.append(clip,
                            clip.n_frames - self._open[key].watermark)
            packed = self.store.get(clip)
            if packed is None:
                raise KeyError(f"clip {key} has no materialized data")
            return packed
