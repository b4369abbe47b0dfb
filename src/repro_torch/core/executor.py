"""Streaming clip executor: the stage graph of the chunked MultiScope
pipeline, on a GPU, for one stream or many.

The port of the JAX package's ``repro.core.executor``.  One clip is cut
into chunks of B frames; each chunk runs:

  DECODE  — render B frames at detector resolution on the host, charging
            the decode-cost ledger (``pipeline.render_frame``);
  PROXY   — the proxy encoder on the device, then ONE ``proxy_plan``
            kernel launch for the chunk (head + threshold + detector-grid
            mapping + plan stats), then host window planning from the
            kernel's grids and stats (``windows.plan_from_mapped``); or,
            with ``fused_plan=False``, ONE ``proxy_score`` launch whose
            score map comes back to the host, is mapped onto the
            detector grid (``pipeline.map_proxy_grid``) and planned by
            ``windows.plan_chunk``;
  DETECT  — cross-frame size-class batches through the detector; window
            crops through the ``window_gather_batch`` kernel on the
            chunk's device buffer; batch dims padded to power-of-two
            buckets; ``decode_detections`` + ``nms`` on the host.  With a
            shared ``BatchBroker`` the dispatch itself coalesces windows
            across every concurrent run;
  TRACK   — crop embeddings for the whole chunk in one device call
            (``tracker.embed_dets_chunk``), then the tracker in frame
            order (the only stage with cross-chunk state): on the host by
            default, one ``track_step`` launch per frame with
            ``device_assign``, the chunk's recurrence on the device with
            ``device_tracker``.  With a shared ``TrackBroker`` the device
            steps of every concurrent run ride one ``track_step`` launch
            over K streams.

Three schedulers drive the graph: ``SequentialScheduler`` (every stage of
chunk k completes before chunk k+1 starts), ``StreamingScheduler``
(DECODE, and with double buffering the device upload, runs ahead on
the ``decode_workers`` threads of a ``DecodePool`` the run owns, while
the caller's thread runs
PROXY/DETECT/TRACK; a reorder gate keeps chunks in order, and the
hand-off queue holds at most ``prefetch_depth`` chunks) and
``PooledStreamingScheduler`` (the same, with DECODE on a ``DecodePool``
shared by several runs).  Tracks do not depend on the scheduler.  When θ
asks for refinement and the bank has a refiner, ``finish`` refines the
tracks.  ``run_clips`` runs a list of clips with one clip of decode
lookahead over one shared pool.

Buffer ownership: the padded device copy of a chunk (``frames_dev``,
(B, H, W, 3) f32, about 100 MB at 960x544) is uploaded by a decode
worker (double buffering) or lazily by DETECT, is needed only for
sub-frame window gathers, and is dropped as soon as DETECT finishes.

Threads and the card: stream threads and decode workers all enqueue on
the device's current (default) stream, so their launches serialise in
the order they are issued.

Live ingestion: ``start(clip, frame_ids=, tracker=)`` runs one appended
segment of an open clip, an explicit slice of θ's gap progression fed
to the stream's carried tracker; ``repro_torch.stream.ingest``'s
``SegmentIngestor`` calls it once per append, and
``repro_torch.query.store.TrackStore.ingest`` runs whole clips through
``run_clips``.  While drift monitoring is on (``obs.enable_drift``) a
run collects each frame's proxy positive-cell fraction into
``RunResult.proxy_fracs``, the ingestor's ``DriftMonitor`` input.

Not ported: the ``devices`` and ``mesh`` options (the port runs on the
bank's one card), and the tracing spans and metrics-registry mirrors of
the runs and brokers (the brokers keep their public stats attributes;
the live path's spans and metrics are in ``repro_torch.obs``).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.core.detector import next_bucket, nms
from repro_torch.core.pipeline import (CELL_PX, ModelBank, PipelineParams,
                                       RunResult, det_grid,
                                       downsample_chunk, make_sizeset,
                                       make_tracker, map_proxy_grid,
                                       render_frame)
from repro_torch.core.tracker import RecurrentTracker, embed_dets_chunk
from repro_torch.core.windows import (ChunkPlan, full_frame_plan,
                                      plan_chunk, plan_from_mapped)
from repro_torch.data.video_synth import Clip
from repro_torch.kernels.track_step import track_step
from repro_torch.kernels.window_gather import window_gather_batch
from repro_torch.obs.metrics import RunProfile, drift_enabled

DEFAULT_CHUNK = 16     # frames per chunk (B) when θ does not say

STAGES = ("decode", "proxy", "detect", "track")


def effective_chunk(params: PipelineParams,
                    override: Optional[int] = None) -> int:
    """The chunk size B for one run: explicit override > θ's
    ``chunk_size`` > ``DEFAULT_CHUNK``."""
    if override is not None:
        return int(override)
    return int(params.chunk_size) if params.chunk_size else DEFAULT_CHUNK


@dataclass
class ExecutorOptions:
    """Scheduling knobs — orthogonal to θ (they never change tracks).

    ``prefetch``       — decode chunk k+1 on background threads while
                         chunk k is in proxy/detect/track;
    ``prefetch_depth`` — max decoded chunks in the hand-off queue (bounds
                         host and device memory);
    ``decode_workers`` — decode threads per run (default 1).  With N > 1
                         chunks decode concurrently and a reorder gate
                         hands them to the compute thread strictly in
                         chunk order, so tracks do not change; at most
                         ``prefetch_depth + decode_workers`` decoded
                         chunks are in flight;
    ``double_buffer``  — upload ``frames_dev`` in the decode worker so
                         the copy overlaps the previous chunk's detector
                         work (only when a proxy is active: all-full-frame
                         plans never need the buffer);
    ``chunk_size``     — override θ's B;
    ``decode_pool``    — an externally owned ``DecodePool``: decode jobs go
                         to its persistent shared workers instead of
                         per-run threads (per-run reorder gates keep
                         TRACK in frame order);
    ``share_decode_pool`` — let ``run_clips`` create ONE pool of
                         ``max(2, decode_workers)`` workers shared by its
                         two in-flight clips;
    ``batch_broker``   — an externally owned ``BatchBroker``: DETECT
                         dispatches of every run sharing it coalesce into
                         one detector batch per size class;
    ``fused_plan``     — PROXY plans through the fused ``proxy_plan``
                         kernel; False takes the score-map path
                         (``proxy_score``, host mapping and planning).
                         Both give the same plans up to cells within a
                         few ulps of the threshold;
    ``device_assign``  — TRACK runs each per-frame step as ONE fused
                         ``track_step`` launch (GRU + match logits + cost
                         + JV assignment on the device) instead of the
                         host numpy twins.  Tracks are bit-identical (the
                         fastmath contract);
    ``device_tracker`` — TRACK holds its state in device slot buffers
                         for a whole chunk (``tracker.DeviceTracker``;
                         implies the device step).  Tracks are
                         bit-identical;
    ``track_broker``   — an externally owned ``TrackBroker``: the device
                         track steps of every run sharing it ride one
                         ``track_step`` launch over K streams (a device
                         tracker then steps per frame).  Tracks are
                         bit-identical: padding slots are dead, and the
                         kernel solves each stream's ``assoc_side``
                         square only.

    The run's device is the bank's (``ModelBank.device``).  The
    reference's ``devices`` and ``mesh`` options are not ported: the
    port runs on one card.
    """
    prefetch: bool = True
    prefetch_depth: int = 2
    decode_workers: int = 1
    double_buffer: bool = True
    chunk_size: Optional[int] = None
    decode_pool: Optional["DecodePool"] = None
    share_decode_pool: bool = True
    batch_broker: Optional["BatchBroker"] = None
    fused_plan: bool = True
    device_assign: bool = False
    device_tracker: bool = False
    track_broker: Optional["TrackBroker"] = None


@dataclass
class ChunkTask:
    """One chunk's state as it flows through the stage graph."""
    index: int
    frame_ids: List[int]
    frames: Optional[np.ndarray] = None        # (B, H, W, 3) host pixels
    charged: float = 0.0                       # decode ledger for chunk
    frames_dev: Optional[torch.Tensor] = None  # padded device buffer
    plan: Optional[ChunkPlan] = None
    dets: Optional[List[np.ndarray]] = None    # per-frame detections


class _WorkerFailure:
    def __init__(self, exc: BaseException):
        self.exc = exc


# ---------------------------------------------------------------------------
# Cross-stream brokers
# ---------------------------------------------------------------------------

class BrokerCancelled(RuntimeError):
    """The stream's broker registration was dropped while a request was
    pending: its work is discarded, other streams are unaffected."""


class _Broker:
    """The flush discipline both brokers share.

    Each stream registers a handle and submits one request at a time,
    blocking until its results are routed back, so each stream's order
    is kept.  Whichever waiting stream first observes a trigger flushes
    everything pending inline (no dedicated thread), with the condition
    variable RELEASED during the dispatch: streams that arrive while a
    batch computes enqueue into the next one.  Triggers: every
    registered stream has a request pending, the pending units reach
    the subclass's limit (``_full``), or a request has waited
    ``linger_ms``.  ``unregister`` cancels the stream's pending requests
    with ``BrokerCancelled``; ``close()`` drains what is pending, then
    refuses new work."""

    _name = "broker"

    def __init__(self, linger_ms: float):
        self.linger = float(linger_ms) / 1e3
        self._cv = threading.Condition()
        self._pending: list = []                    # guarded-by: _cv
        self._registered = 0                        # guarded-by: _cv
        self._waiting = 0                           # guarded-by: _cv
        self._closed = False                        # guarded-by: _cv
        self.dispatches = 0                         # guarded-by: _cv

    # -- stream side ----------------------------------------------------------

    def _register(self, handle_cls):
        with self._cv:
            if self._closed:
                raise RuntimeError(f"{type(self).__name__} is closed")
            self._registered += 1
            return handle_cls(self)

    def unregister(self, handle) -> None:
        with self._cv:
            if not handle.active:
                return
            handle.active = False
            self._registered -= 1
            for req in self._pending:
                if req.handle is handle:
                    req.error = BrokerCancelled(
                        f"stream dropped with a {self._name} request in "
                        "flight")
                    req.done = True
            self._pending = [r for r in self._pending if not r.done]
            self._cv.notify_all()

    def close(self) -> None:
        """Drain-on-close: flush whatever is pending, then refuse new
        work.  Idempotent."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            batch, self._pending = self._pending, []
            if batch:
                self._apply_stats(self._flush(batch))
            self._cv.notify_all()

    def _submit(self, req):
        """Enqueue ``req`` and block until it is served (or cancelled);
        -> its result."""
        cv = self._cv
        cv.acquire()
        try:
            if self._closed:
                raise RuntimeError(f"{type(self).__name__} is closed")
            if not req.handle.active:
                raise BrokerCancelled("handle already closed")
            # no notify on enqueue: this thread checks the triggers
            # itself before waiting, and every other waiter re-checks at
            # its own linger deadline
            self._pending.append(req)
            self._waiting += 1
            try:
                deadline = time.monotonic() + self.linger
                while not req.done:
                    if self._pending and (
                            self._should_flush()
                            or time.monotonic() >= deadline):
                        batch, self._pending = self._pending, []
                        cv.release()
                        try:
                            stats = self._flush(batch)
                        finally:
                            cv.acquire()
                        self._apply_stats(stats)
                        cv.notify_all()
                    elif self._pending:
                        cv.wait(timeout=max(
                            deadline - time.monotonic(), 1e-4))
                    else:
                        # our request rode out with another thread's
                        # in-flight flush; its completion (or a cancel)
                        # notifies under the lock
                        cv.wait()
            finally:
                self._waiting -= 1
        finally:
            cv.release()
        if req.error is not None:
            raise req.error
        return req.result

    # -- flush side -----------------------------------------------------------

    # holds-lock: _cv
    def _should_flush(self) -> bool:
        if not self._pending:
            return False
        return self._waiting >= self._registered or self._full()

    def _flush(self, batch: list) -> list:
        """Dispatch each group of compatible requests once; a failing
        group's requests get its exception, the others are served."""
        groups: Dict[tuple, list] = {}
        for req in batch:
            groups.setdefault(self._group_key(req), []).append(req)
        stats = []
        for reqs in groups.values():
            try:
                stats.append(self._dispatch(reqs))
            except BaseException as exc:    # routed to its requests
                for r in reqs:
                    r.error = exc
                    r.done = True
        return stats


class _BrokerHandle:
    """One stream's registration with a ``BatchBroker``.  Created lazily
    by ``_RunContext`` on the stream's first DETECT dispatch (so a run
    that never reaches DETECT never delays other streams' flushes) and
    closed when the run finishes or is cancelled."""

    __slots__ = ("broker", "active")

    def __init__(self, broker: "BatchBroker"):
        self.broker = broker
        self.active = True

    def detect(self, detector, frames, conf, origins, scales,
               n_valid: int) -> List[np.ndarray]:
        return self.broker._detect(self, detector, frames, conf,
                                   origins, scales, n_valid)

    def close(self) -> None:
        self.broker.unregister(self)


class _BrokerRequest:
    __slots__ = ("handle", "detector", "frames", "conf", "origins",
                 "scales", "n", "done", "result", "error")

    def __init__(self, handle, detector, frames, conf, origins, scales,
                 n: int):
        self.handle = handle
        self.detector = detector
        self.frames = frames            # (>= n, h, w, 3); rows >= n pad
        self.conf = conf
        self.origins = list(origins)
        self.scales = list(scales)
        self.n = n
        self.done = False
        self.result: Optional[List[np.ndarray]] = None
        self.error: Optional[BaseException] = None


def _consolidate(parts: Sequence, bucket: int):
    """``bucket`` zero rows with ``parts`` copied into the first ones: a
    device tensor on the parts' device when any part is a tensor (the
    ``window_gather_batch`` crops), else a host array (full-frame
    stacks)."""
    shape = (bucket,) + tuple(parts[0].shape[1:])
    dev = next((p.device for p in parts if isinstance(p, torch.Tensor)),
               None)
    if dev is None:
        stack = np.zeros(shape, np.float32)
    else:
        stack = torch.zeros(shape, dtype=torch.float32, device=dev)
    ofs = 0
    for p in parts:
        if dev is not None and not isinstance(p, torch.Tensor):
            p = torch.from_numpy(np.ascontiguousarray(p, np.float32))
        stack[ofs:ofs + len(p)] = p
        ofs += len(p)
    return stack


class BatchBroker(_Broker):
    """Coalesce DETECT dispatches across concurrent executor runs.

    Each run registers a handle; its DETECT stage submits one request
    per size class and blocks for the routed-back results, which keeps
    TRACK order per stream exactly as without the broker.  Pending
    requests from all streams flush together: requests of one (detector,
    conf, crop shape) group concatenate into ONE ``detect_batch`` call
    padded to a power-of-two bucket, whose per-window results split back
    per request.  Each window's detections are decoded from its own
    rows, so per-stream tracks equal the broker-off run's as far as the
    detector is batch-invariant (bit for bit where it is).

    Flush discipline (``_Broker``), with the pending-window limit
    ``max_batch`` (a full consolidated bucket).  The 10 ms default
    linger is well under a frame period and long enough for streams
    decoding concurrently to coalesce their chunks' windows.

    The batch is built where its parts live: the sub-frame crops of
    ``window_gather_batch`` are device tensors and are copied into the
    rows of one zero buffer on the device; full-frame stacks are host
    arrays and are stacked on the host.  (The reference builds every
    batch in host memory, to bound its number of XLA programs; the port
    compiles nothing per shape.)  Padding rows are zero in both.  A lone
    request whose rows already fill its bucket is passed through as it
    is.

    Stats: ``dispatches`` consolidated detector calls, ``windows_in``
    real windows served, ``batch_fill`` per-call valid/bucket share.
    """

    _name = "detect"

    def __init__(self, max_batch: int = 64, linger_ms: float = 10.0):
        super().__init__(linger_ms)
        self.max_batch = int(max_batch)
        self.windows_in = 0                         # guarded-by: _cv
        self.batch_fill: List[float] = []           # guarded-by: _cv

    def register(self) -> _BrokerHandle:
        return self._register(_BrokerHandle)

    def _detect(self, handle: _BrokerHandle, detector, frames, conf,
                origins, scales, n_valid: int) -> List[np.ndarray]:
        """Submit one size-class request and block for its results.
        ``frames``: (>= n_valid, h, w, 3) host or device rows; rows past
        ``n_valid`` are padding and are dropped before consolidation."""
        if n_valid == 0:
            return []
        return self._submit(_BrokerRequest(handle, detector, frames, conf,
                                           origins, scales, n_valid))

    # holds-lock: _cv
    def _full(self) -> bool:
        return sum(r.n for r in self._pending) >= self.max_batch

    # holds-lock: _cv
    def _apply_stats(self, stats: List[Tuple[int, int]]) -> None:
        for total, bucket in stats:
            self.dispatches += 1
            self.windows_in += total
            self.batch_fill.append(total / bucket)

    @staticmethod
    def _group_key(req: _BrokerRequest) -> tuple:
        return (id(req.detector), float(req.conf),
                tuple(req.frames.shape[1:3]))

    def _dispatch(self, reqs: List[_BrokerRequest]) -> Tuple[int, int]:
        detector = reqs[0].detector
        total = sum(r.n for r in reqs)
        bucket = next_bucket(total)
        if len(reqs) == 1 and reqs[0].frames.shape[0] == bucket:
            # a lone already-bucketed request (a stream flushing alone at
            # its linger deadline): fed through untouched, so a solo
            # stream behind a broker runs what it runs without one
            r = reqs[0]
            r.result = detector.detect_batch(r.frames, r.conf,
                                             origins=r.origins,
                                             scales=r.scales, n_valid=r.n)
            r.done = True
            return total, bucket
        stack = _consolidate([r.frames[:r.n] for r in reqs], bucket)
        dets = detector.detect_batch(
            stack, reqs[0].conf, origins=[o for r in reqs for o in r.origins],
            scales=[s for r in reqs for s in r.scales], n_valid=total)
        ofs = 0
        for r in reqs:
            r.result = dets[ofs:ofs + r.n]
            ofs += r.n
            r.done = True
        return total, bucket


class _TrackHandle:
    """One stream's registration with a ``TrackBroker``.  Attached to the
    stream's tracker as ``_track_handle`` by ``_RunContext`` and closed
    when the run finishes or is cancelled."""

    __slots__ = ("broker", "active")

    def __init__(self, broker: "TrackBroker"):
        self.broker = broker
        self.active = True

    def step(self, h_r, tbox_r, alive_r, te_gap_r, te_match, x, dbox,
             dvalid, thr, params, table, *, params_key):
        return self.broker._step(self, (h_r, tbox_r, alive_r, te_gap_r,
                                        te_match, x, dbox, dvalid),
                                 thr, params, table, params_key)

    def close(self) -> None:
        self.broker.unregister(self)


class _TrackRequest:
    __slots__ = ("handle", "arrs", "thr", "params", "table", "key",
                 "done", "result", "error")

    def __init__(self, handle, arrs, thr, params, table, key):
        self.handle = handle
        self.arrs = arrs                # the 8 (Q, ...) stream tensors
        self.thr = thr
        self.params = params
        self.table = table
        self.key = key                  # flush-group key
        self.done = False
        self.result = None
        self.error: Optional[BaseException] = None


class TrackBroker(_Broker):
    """Coalesce per-frame device track steps across concurrent runs.

    The ``track_step`` kernel batches over a leading K axis of
    independent streams; each stream alone would launch it at K 1.  A
    shared broker lets the steps of K streams ride one launch: each
    stream's ``assign="device"`` tracker submits its step operands (8
    tensors of Q slots on its device, and the host threshold) and blocks
    for its routed-back slice, so TRACK order per stream is as without
    the broker.

    Flush discipline (``_Broker``), with the limit ``max_streams``
    pending steps.  Streams group by (tracker params, threshold, H, e).
    A group's operands are stacked on the device into zero buffers of
    the widest stream's Q and a power-of-two K; padding slots and
    padding streams are dead (alive = dvalid = 0), and the kernel solves
    each stream's ``assoc_side`` square only, so every real row comes
    back with the bits of a solo launch.  One launch a group, and one
    copy of each output to the host a group.

    Stats: ``dispatches`` ``track_step`` calls, ``steps_in`` real stream
    steps served, ``stream_fill`` streams per call."""

    _name = "track step"

    def __init__(self, max_streams: int = 16, linger_ms: float = 5.0):
        super().__init__(linger_ms)
        self.max_streams = int(max_streams)
        self.steps_in = 0                           # guarded-by: _cv
        self.stream_fill: List[int] = []            # guarded-by: _cv

    def register(self) -> _TrackHandle:
        return self._register(_TrackHandle)

    def _step(self, handle: _TrackHandle, arrs, thr, params, table,
              params_key):
        Q, H = arrs[0].shape
        e = arrs[5].shape[1]
        key = (params_key, float(np.asarray(thr).reshape(-1)[0]), H, e)
        return self._submit(_TrackRequest(handle, arrs, thr, params,
                                          table, key))

    # holds-lock: _cv
    def _full(self) -> bool:
        return len(self._pending) >= self.max_streams

    # holds-lock: _cv
    def _apply_stats(self, stats: List[int]) -> None:
        for k in stats:
            self.dispatches += 1
            self.steps_in += k
            self.stream_fill.append(k)

    @staticmethod
    def _group_key(req: _TrackRequest) -> tuple:
        return req.key

    def _dispatch(self, reqs: List[_TrackRequest]) -> int:
        K = len(reqs)
        Kb = next_bucket(K)
        Qm = max(r.arrs[0].shape[0] for r in reqs)
        dev = reqs[0].arrs[0].device
        stacked = []
        for parts in zip(*(r.arrs for r in reqs)):
            buf = torch.zeros((Kb, Qm) + tuple(parts[0].shape[1:]),
                              dtype=torch.float32, device=dev)
            for k, part in enumerate(parts):
                buf[k, :part.shape[0]] = part
            stacked.append(buf)
        r0 = reqs[0]
        matched, h_upd, h_new = (
            o.cpu().numpy() for o in track_step(*stacked, r0.thr,
                                                r0.params, r0.table))
        for k, r in enumerate(reqs):
            q = r.arrs[0].shape[0]
            r.result = (matched[k, :q], h_upd[k, :q], h_new[k, :q])
            r.done = True
        return K


# ---------------------------------------------------------------------------
# Per-run state
# ---------------------------------------------------------------------------

class _RunContext:
    """Per-clip derived state shared by every stage.

    ``frame_ids`` (default: θ's full gap progression over the clip)
    restricts the run to an explicit frame list, one appended segment of
    an open clip at a time.  ``tracker`` injects an existing tracker
    instead of a fresh one, so TRACK state (active tracks, GRU states,
    the id counter) carries across segment runs."""

    def __init__(self, bank: ModelBank, params: PipelineParams,
                 clip: Clip, options: ExecutorOptions,
                 frame_ids: Optional[Sequence[int]] = None,
                 tracker: Optional[object] = None):
        self.bank = bank
        self.params = params
        self.clip = clip
        self.cfg = bank.cfg
        self.device = bank.device
        self.chunk = effective_chunk(params, options.chunk_size)
        self.W, self.H = params.det_res
        self.proxy = bank.proxies.get(params.proxy_res) \
            if params.proxy_res is not None else None
        self.fused_plan = bool(options.fused_plan
                               and self.proxy is not None)
        self.sizeset = make_sizeset(bank, params)
        self.grid = det_grid(params.det_res)
        self.detector = bank.detectors[params.det_arch]
        if tracker is not None:
            self.tracker = tracker
        else:
            self.tracker = make_tracker(
                bank, params, device_assign=options.device_assign,
                device_tracker=options.device_tracker)
        self.batch_embed = isinstance(self.tracker, RecurrentTracker)
        # the track broker takes any device-assign recurrent tracker,
        # injected ones included
        self._track_broker = options.track_broker
        self.track_handle: Optional[_TrackHandle] = None
        if self._track_broker is not None and self.batch_embed \
                and self.tracker.assign == "device":
            self.track_handle = self._track_broker.register()
            self.tracker._track_handle = self.track_handle
        self._broker = options.batch_broker
        self.broker_handle: Optional[_BrokerHandle] = None
        # upload in the decode worker only when the buffer can be used:
        # sub-frame gathers need an active proxy, and the previous
        # chunk's plan predicts whether this one will gather at all
        self.predecode_upload = bool(options.double_buffer
                                     and self.proxy is not None)
        self.prev_chunk_gathered = False    # benign cross-thread read
        self.frame_ids = list(frame_ids) if frame_ids is not None \
            else list(range(0, clip.n_frames, params.gap))
        # ledger + RunResult counters, accumulated by TRACK (the only
        # stage that is strictly sequenced)
        self.charged = 0.0
        self.n_windows = 0
        self.full_frames = 0
        self.skipped = 0
        self.profile = RunProfile(STAGES)
        self._disp_track0 = int(getattr(self.tracker, "dispatches", 0))
        # per-frame proxy positive-cell fractions (drift monitoring
        # only; appended by PROXY, which runs on the draining thread)
        self.proxy_fracs: Optional[List[float]] = \
            [] if drift_enabled() else None

    def broker(self) -> Optional[_BrokerHandle]:
        """The run's batch-broker handle, registered lazily on the first
        DETECT dispatch (only streams that detect take part in the
        all-streams-pending trigger).  DETECT runs on the draining
        thread only, so no lock is needed."""
        if self._broker is not None and self.broker_handle is None:
            self.broker_handle = self._broker.register()
        return self.broker_handle

    def close(self) -> None:
        """Release the broker registrations; called by the executor when
        the run finishes or is cancelled."""
        if self.broker_handle is not None:
            self.broker_handle.close()
            self.broker_handle = None
        self._broker = None
        if self.track_handle is not None:
            if getattr(self.tracker, "_track_handle", None) \
                    is self.track_handle:
                self.tracker._track_handle = None
            self.track_handle.close()
            self.track_handle = None
        self._track_broker = None

    def upload(self, task: ChunkTask) -> torch.Tensor:
        """Pad the chunk to B frames and move it to the run's device."""
        padded = np.zeros((self.chunk, self.H, self.W, 3), np.float32)
        padded[:task.frames.shape[0]] = task.frames
        return torch.from_numpy(padded).to(self.device)


# ---------------------------------------------------------------------------
# The four stages
# ---------------------------------------------------------------------------

def stage_decode(ctx: _RunContext, task: ChunkTask) -> ChunkTask:
    """Render the chunk at detector resolution, charging the ledger.
    ``time.thread_time`` measures the CPU actually spent rendering in
    THIS thread, so the charge stays exact whether decode runs inline or
    on a decode worker."""
    B = len(task.frame_ids)
    frames = np.empty((B, ctx.H, ctx.W, 3), np.float32)
    charged = 0.0
    for k, f in enumerate(task.frame_ids):
        t_r = time.thread_time()
        frame, cost = render_frame(ctx.clip, f, ctx.W, ctx.H)
        charged += cost - (time.thread_time() - t_r)
        frames[k] = frame
    task.frames = frames
    task.charged = charged
    if ctx.predecode_upload and ctx.prev_chunk_gathered:
        task.frames_dev = ctx.upload(task)
    return task


def stage_proxy(ctx: _RunContext, task: ChunkTask) -> ChunkTask:
    """Proxy-score the whole chunk in one launch and plan its windows on
    the host: from the ``proxy_plan`` kernel's mapped grids + plan stats
    (fused), or from the ``proxy_score`` kernel's score map, mapped onto
    the detector grid per frame (``fused_plan=False``)."""
    if ctx.proxy is not None:
        ctx.profile.dispatch("proxy")
        pframes = downsample_chunk(task.frames, ctx.proxy.resolution)
        if ctx.fused_plan:
            grids, stats = ctx.proxy.plan_batch(
                pframes, ctx.params.proxy_threshold, ctx.grid)
            task.plan = plan_from_mapped(grids, stats, ctx.sizeset,
                                         ctx.cfg.windows.max_windows,
                                         chunk_size=ctx.chunk)
        else:
            _, pos = ctx.proxy.scores_batch(pframes,
                                            ctx.params.proxy_threshold)
            grids = [map_proxy_grid(p, ctx.grid) for p in pos]
            task.plan = plan_chunk(grids, ctx.sizeset,
                                   ctx.cfg.windows.max_windows,
                                   chunk_size=ctx.chunk)
        if ctx.proxy_fracs is not None:
            # drift signal: positive-cell fraction per REAL frame (an
            # observer of grids the plan already computed; rows past
            # the chunk's frame count are padding)
            g = np.asarray(grids)[:len(task.frame_ids)]
            fracs = (g > 0).mean(axis=tuple(range(1, g.ndim)))
            ctx.proxy_fracs.extend(float(v) for v in fracs)
    else:
        task.plan = full_frame_plan(len(task.frame_ids), ctx.sizeset)
    return task


def stage_detect(ctx: _RunContext, task: ChunkTask) -> ChunkTask:
    """Cross-frame bucketed detection, through the run's batch broker
    when it has one; reassemble per-frame detections in the exact order
    the per-frame reference path produces them."""
    detector = ctx.detector
    W, H = ctx.W, ctx.H
    conf = ctx.params.det_conf
    plan, frames = task.plan, task.frames
    frames_dev = task.frames_dev
    per_window: Dict[Tuple[int, int], np.ndarray] = {}
    for size, entries in plan.by_size.items():
        pw, ph = size[0] * CELL_PX, size[1] * CELL_PX
        n = len(entries)
        origins = [(x * CELL_PX / W, y * CELL_PX / H)
                   for (_, x, y, _) in entries]
        scales = [(pw / W, ph / H)] * n
        broker = ctx.broker()
        ctx.profile.dispatch("detect")
        if (pw, ph) == (W, H):
            # full-frame windows: the crop is the frame itself
            stack = frames[[slot for (slot, _, _, _) in entries]]
            if broker is not None:
                dets = broker.detect(detector, stack, conf, origins,
                                     scales, n)
            else:
                dets = detector.detect_batch_bucketed(
                    stack, conf, origins=origins, scales=scales)
        else:
            if frames_dev is None:       # lazy path (no double buffer)
                frames_dev = ctx.upload(task)
            # zero padding rows crop frame 0 at cell (0, 0)
            tbl = np.zeros((next_bucket(n), 3), np.int32)
            for k, (slot, x, y, _) in enumerate(entries):
                tbl[k] = (slot, y, x)
            crops = window_gather_batch(frames_dev, tbl, win_h=ph,
                                        win_w=pw, cell=CELL_PX)
            # crops stay on the device: the detector (or the broker's
            # device-side batch) takes them as they are
            if broker is not None:
                dets = broker.detect(detector, crops, conf, origins,
                                     scales, n)
            else:
                dets = detector.detect_batch(
                    crops, conf, origins=origins, scales=scales,
                    n_valid=n)
        for (slot, _, _, wi), d in zip(entries, dets):
            per_window[(slot, wi)] = d

    merged: List[np.ndarray] = []
    for slot, wins in enumerate(plan.windows):
        if not wins:
            merged.append(np.zeros((0, 5), np.float32))
        elif len(wins) == 1 and wins[0][2] == ctx.sizeset.full:
            # the per-frame fast path applies no cross-window NMS
            merged.append(per_window[(slot, 0)])
        else:
            by_size_frame: Dict[Tuple[int, int], List[int]] = {}
            for wi, (_, _, s) in enumerate(wins):
                by_size_frame.setdefault(s, []).append(wi)
            parts = [per_window[(slot, wi)]
                     for wis in by_size_frame.values() for wi in wis]
            merged.append(nms(np.concatenate(parts)))
    task.dets = merged
    # steer the decode worker's eager upload (a stale read just means
    # one lazy upload): this chunk gathered iff any class was sub-frame
    ctx.prev_chunk_gathered = any(
        (s[0] * CELL_PX, s[1] * CELL_PX) != (W, H) for s in plan.by_size)
    # DETECT is the device buffer's last consumer: drop it here
    task.frames_dev = None
    return task


def stage_track(ctx: _RunContext, task: ChunkTask) -> ChunkTask:
    """Feed the tracker strictly in frame order; accumulate counters and
    the decode ledger.  The crop CNN runs once per chunk."""
    for wins in task.plan.windows:
        ctx.n_windows += len(wins)
        if len(wins) == 1 and wins[0][2] == ctx.sizeset.full:
            ctx.full_frames += 1
        if not wins:
            ctx.skipped += 1
    ctx.charged += task.charged
    if ctx.batch_embed:
        ctx.profile.dispatch("embed")
        embeds = embed_dets_chunk(ctx.bank.tracker_params,
                                  ctx.cfg.tracker, task.frames,
                                  task.dets,
                                  min_bucket=max(8, ctx.chunk // 2))
        ctx.tracker.step_chunk(task.frame_ids, task.dets, task.frames,
                               embeds=embeds)
    else:
        for k, f in enumerate(task.frame_ids):
            ctx.tracker.step(f, task.dets[k], task.frames[k])
    task.frames = None
    return task


DEFAULT_STAGES: Dict[str, Callable[[_RunContext, ChunkTask], ChunkTask]] \
    = {"decode": stage_decode, "proxy": stage_proxy,
       "detect": stage_detect, "track": stage_track}


def _timed(name: str, fn: Callable) -> Callable:
    """Wrap a stage so each call adds wall + thread-CPU seconds to the
    run's profile (``thread_time`` counts only the calling thread, so
    overlapped stages do not double-count each other).  Wall time of a
    stage that launches device work is host time: the device work is
    synchronised where its results come back to the host."""

    def wrapper(ctx: _RunContext, task: ChunkTask) -> ChunkTask:
        t0 = time.perf_counter_ns()
        c0 = time.thread_time_ns()
        try:
            return fn(ctx, task)
        finally:
            ctx.profile.note_stage(
                name, (time.perf_counter_ns() - t0) / 1e9,
                (time.thread_time_ns() - c0) / 1e9)
    return wrapper


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------

def _drain_queue(q: "queue.Queue", n: int, ctx: _RunContext,
                 stages: Dict[str, Callable]) -> None:
    """Take ``n`` decoded chunks off ``q`` in order and run the rest of
    the stage graph on each; a decode failure is raised here."""
    for _ in range(n):
        item = q.get()
        if isinstance(item, _WorkerFailure):
            raise item.exc
        task = item
        for name in STAGES[1:]:
            task = stages[name](ctx, task)


class SequentialScheduler:
    """Every stage of chunk k completes before chunk k+1 starts."""

    def start(self, ctx: _RunContext, tasks: List[ChunkTask],
              stages: Dict[str, Callable]):
        return iter(tasks)

    def cancel(self, ctx: _RunContext, handle) -> None:
        pass                          # nothing runs ahead

    def drain(self, ctx: _RunContext, handle,
              stages: Dict[str, Callable]) -> None:
        for task in handle:
            for name in STAGES:
                task = stages[name](ctx, task)


class StreamingScheduler:
    """DECODE runs ahead on ``workers`` background threads behind a
    bounded hand-off queue; PROXY/DETECT/TRACK run on the draining
    thread in chunk order.

    The run owns a ``DecodePool`` of ``workers`` threads, created by
    ``start`` and closed after ``drain`` or ``cancel``, and drains
    through it as ``PooledStreamingScheduler`` does: the pool's reorder
    gate admits each decoded chunk only after every earlier one, so the
    draining thread (and TRACK) sees chunks strictly in frame order for
    any number of workers, and at most ``depth + workers`` decoded
    chunks are in flight."""

    def __init__(self, depth: int = 2, workers: int = 1):
        self.depth = max(1, int(depth))
        self.workers = max(1, int(workers))

    def start(self, ctx: _RunContext, tasks: List[ChunkTask],
              stages: Dict[str, Callable]):
        pool = DecodePool(min(self.workers, max(len(tasks), 1)),
                          name="multiscope-decode")
        try:
            return pool, pool.submit(ctx, tasks, stages, self.depth)
        except BaseException:
            pool.close()
            raise

    def cancel(self, ctx: _RunContext, handle) -> None:
        """Stop the run's decode workers and discard what they
        produced."""
        pool, run = handle
        try:
            pool.cancel(run)
        finally:
            pool.close()

    def drain(self, ctx: _RunContext, handle,
              stages: Dict[str, Callable]) -> None:
        pool, run = handle
        try:
            PooledStreamingScheduler(pool, self.depth).drain(ctx, run,
                                                             stages)
        finally:
            pool.close()


class _PoolRun:
    """One run's state inside a shared ``DecodePool``: a bounded output
    queue plus a per-run reorder gate (chunks are admitted strictly in
    chunk order, whichever pool worker decoded them first)."""

    def __init__(self, ctx: _RunContext, tasks: List[ChunkTask],
                 stages: Dict[str, Callable], depth: int):
        self.ctx = ctx
        self.tasks = tasks
        self.stages = stages
        self.q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self.gate = threading.Condition()
        self.next = 0                 # guarded-by: gate; admitted next
        self.remaining = len(tasks)   # guarded-by: gate; jobs not done
        self.failed = False           # guarded-by: gate
        self.cancelled = False        # guarded-by: gate

    def _account(self) -> None:
        with self.gate:
            self.remaining -= 1
            self.gate.notify_all()


class DecodePool:
    """Persistent decode workers shared by several in-flight runs.

    ``run_clips`` keeps two clips in flight; with per-run workers that
    is ``2 * decode_workers`` threads, started and stopped at every clip
    boundary.  The pool owns ONE set of ``workers`` threads for its
    lifetime: each run submits its chunks as jobs on a shared FIFO, and
    a per-run reorder gate (``_PoolRun``) recovers chunk order before
    the run's bounded hand-off queue, so TRACK still sees every run's
    chunks in frame order and tracks do not depend on the pool size.

    Jobs of different runs interleave in submission order: clip i's
    remaining chunks first, then clip i+1's.  A worker blocked on one
    run's full queue parks with a timeout, so a ``cancel`` of that run
    (or its drain making progress) always releases it; a cancelled run's
    undecoded jobs are dropped as workers reach them.

    Runs sharing a pool must be DRAINED in submission order (or
    cancelled): a later run drained first could starve behind an earlier
    run's full queue that nobody consumes."""

    def __init__(self, workers: int = 2,
                 name: str = "multiscope-pool-decode"):
        self.workers = max(1, int(workers))
        self._jobs: "queue.Queue" = queue.Queue()
        self._closed = False
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{name}-{k}")
            for k in range(self.workers)]
        for th in self._threads:
            th.start()

    def submit(self, ctx: _RunContext, tasks: List[ChunkTask],
               stages: Dict[str, Callable], depth: int) -> _PoolRun:
        if self._closed:
            # jobs queued after close would never run and the run's
            # drain would wait forever: fail fast
            raise RuntimeError("DecodePool is closed")
        run = _PoolRun(ctx, tasks, stages, depth)
        for i, task in enumerate(tasks):
            self._jobs.put((run, i, task))
        return run

    def cancel(self, run: _PoolRun) -> None:
        """Drop the run: undecoded jobs are discarded as workers reach
        them, and the output queue is drained so no shared worker stays
        blocked on it.  Returns once every job is accounted for."""
        with run.gate:
            run.cancelled = True
            run.gate.notify_all()
        while True:
            with run.gate:
                if run.remaining <= 0:
                    return
            try:
                run.q.get(timeout=0.02)
            except queue.Empty:
                pass

    def close(self) -> None:
        """Stop the workers (idempotent).  Outstanding runs must be
        drained or cancelled first."""
        if self._closed:
            return
        self._closed = True
        for _ in self._threads:
            self._jobs.put(None)
        for th in self._threads:
            th.join()

    # -- worker side ----------------------------------------------------------

    def _put(self, run: _PoolRun, item) -> None:
        while not run.cancelled:
            try:
                run.q.put(item, timeout=0.05)
                return
            except queue.Full:
                pass

    def _worker(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            run, i, task = job
            try:
                self._decode_one(run, i, task)
            finally:
                run._account()

    def _decode_one(self, run: _PoolRun, i: int, task: ChunkTask) -> None:
        if run.cancelled or run.failed:
            return                      # dropped job
        try:
            decoded = run.stages["decode"](run.ctx, task)
        except BaseException as exc:    # surfaced by drain()
            with run.gate:
                run.failed = True
                run.gate.notify_all()
            self._put(run, _WorkerFailure(exc))
            return
        with run.gate:
            while run.next != i and not run.cancelled and not run.failed:
                run.gate.wait(0.05)
            if run.cancelled or run.failed:
                return
        self._put(run, decoded)
        with run.gate:
            run.next += 1
            run.gate.notify_all()


class PooledStreamingScheduler:
    """The streaming schedule with DECODE on a shared ``DecodePool``
    instead of per-run threads; drain, and so tracks, as
    ``StreamingScheduler``."""

    def __init__(self, pool: DecodePool, depth: int = 2):
        self.pool = pool
        self.depth = max(1, int(depth))

    def start(self, ctx: _RunContext, tasks: List[ChunkTask],
              stages: Dict[str, Callable]) -> _PoolRun:
        return self.pool.submit(ctx, tasks, stages, self.depth)

    def cancel(self, ctx: _RunContext, run: _PoolRun) -> None:
        self.pool.cancel(run)

    def drain(self, ctx: _RunContext, run: _PoolRun,
              stages: Dict[str, Callable]) -> None:
        try:
            _drain_queue(run.q, len(run.tasks), ctx, stages)
        except BaseException:
            # release any pool worker parked on this run's queue before
            # propagating (shared workers outlive a failed run)
            self.pool.cancel(run)
            raise


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

@dataclass
class _ActiveRun:
    """A clip whose DECODE may already be running ahead."""
    ctx: _RunContext
    handle: object


class ClipExecutor:
    """Execute θ over clips through the stage graph.

    The run's tensors live on the bank's device (the card unless the
    bank was built with ``device="cpu"``); ``device``, when given, must
    name that same device.  ``stages`` replaces any stage function by
    name; ``scheduler`` overrides the one ``options`` pick (a shared
    ``decode_pool`` → pooled, ``prefetch`` → streaming, else
    sequential).  ``start``/``finish`` expose the two-phase form, so
    ``run_clips`` can overlap clip i+1's decode with clip i's compute.
    """

    def __init__(self, bank: ModelBank, params: PipelineParams,
                 options: Optional[ExecutorOptions] = None,
                 stages: Optional[Dict[str, Callable]] = None,
                 scheduler=None, device: Optional[Device] = None):
        if device is not None and resolve_device(device) != bank.device:
            raise ValueError(f"executor on {device}, bank on {bank.device}")
        self.bank = bank
        self.params = params
        self.options = options or ExecutorOptions()
        fns = dict(DEFAULT_STAGES)
        fns.update(stages or {})
        self.stages = {name: _timed(name, fn) for name, fn in fns.items()}
        opts = self.options
        if scheduler is not None:
            self.scheduler = scheduler
        elif opts.decode_pool is not None and opts.prefetch:
            self.scheduler = PooledStreamingScheduler(opts.decode_pool,
                                                      opts.prefetch_depth)
        elif opts.prefetch:
            self.scheduler = StreamingScheduler(opts.prefetch_depth,
                                                opts.decode_workers)
        else:
            self.scheduler = SequentialScheduler()

    def _tasks(self, ctx: _RunContext) -> List[ChunkTask]:
        ids = ctx.frame_ids
        return [ChunkTask(i, ids[c0:c0 + ctx.chunk])
                for i, c0 in enumerate(range(0, len(ids), ctx.chunk))]

    def start(self, clip: Clip, *,
              frame_ids: Optional[Sequence[int]] = None,
              tracker: Optional[object] = None) -> _ActiveRun:
        """Start a run.  ``frame_ids``/``tracker`` are the resume hooks
        of live ingestion (``stream.ingest.SegmentIngestor``): run only
        an explicit frame slice, feeding an existing tracker whose state
        carries across segment runs."""
        ctx = _RunContext(self.bank, self.params, clip, self.options,
                          frame_ids=frame_ids, tracker=tracker)
        try:
            handle = self.scheduler.start(ctx, self._tasks(ctx),
                                          self.stages)
        except BaseException:
            ctx.close()
            raise
        return _ActiveRun(ctx, handle)

    def cancel(self, run: _ActiveRun) -> None:
        """Abandon a started run: stop its decode workers, drop its
        broker registrations (its pending broker requests are cancelled
        without affecting other streams) and release what it buffered."""
        try:
            self.scheduler.cancel(run.ctx, run.handle)
        finally:
            run.ctx.close()

    def finish(self, run: _ActiveRun) -> RunResult:
        ctx = run.ctx
        t0 = time.process_time()
        try:
            self.scheduler.drain(ctx, run.handle, self.stages)
        finally:
            ctx.close()
        tracks = ctx.tracker.result()
        if ctx.params.refine and ctx.bank.refiner is not None:
            tracks = [ctx.bank.refiner.refine(t) for t in tracks]
        seconds = time.process_time() - t0 + max(ctx.charged, 0.0)
        track_disp = int(getattr(ctx.tracker, "dispatches", 0)) \
            - ctx._disp_track0 + ctx.profile.dispatches("embed")
        dispatches = {"proxy": ctx.profile.dispatches("proxy"),
                      "detect": ctx.profile.dispatches("detect"),
                      "track": track_disp}
        return RunResult(tracks, seconds, len(ctx.frame_ids),
                         ctx.n_windows, ctx.full_frames, ctx.skipped,
                         stage_seconds=ctx.profile.stage_seconds(),
                         dispatches=dispatches,
                         proxy_fracs=ctx.proxy_fracs)

    def run(self, clip: Clip) -> RunResult:
        return self.finish(self.start(clip))


def run_clip_streamed(bank: ModelBank, params: PipelineParams,
                      clip: Clip,
                      options: Optional[ExecutorOptions] = None
                      ) -> RunResult:
    """One clip through the streaming executor (prefetch on by
    default), on the bank's device."""
    return ClipExecutor(bank, params, options).run(clip)


def run_clips(bank: ModelBank, params: PipelineParams,
              clips: Sequence[Clip],
              options: Optional[ExecutorOptions] = None
              ) -> Tuple[List[RunResult], float]:
    """Run θ over several clips; -> (per-clip results in order, summed
    seconds).

    With prefetch, clip i+1 is started (its decode runs ahead) while
    clip i drains: one clip of lookahead.  With ``share_decode_pool``
    (the default) the two in-flight clips share ONE ``DecodePool`` of
    ``max(2, decode_workers)`` workers, created and closed here; a
    ``decode_pool`` the caller supplies is used as it is and left open.
    TRACK state never crosses clips, so each result equals the clip's
    own ``ClipExecutor`` run.  If a run fails, the runs started ahead
    are cancelled before the error propagates."""
    opts = options or ExecutorOptions()
    own_pool: Optional[DecodePool] = None
    if opts.prefetch and len(clips) > 1 and opts.share_decode_pool \
            and opts.decode_pool is None:
        own_pool = DecodePool(max(2, opts.decode_workers))
        opts = dataclasses.replace(opts, decode_pool=own_pool)
    try:
        ex = ClipExecutor(bank, params, opts)
        results: List[RunResult] = []
        if not opts.prefetch or len(clips) <= 1:
            for i, clip in enumerate(clips):
                results.append(ex.finish(ex.start(clip)))
            return results, sum(r.seconds for r in results)
        pending: List[_ActiveRun] = [ex.start(clips[0])]
        try:
            for i in range(1, len(clips)):
                pending.append(ex.start(clips[i]))
                results.append(ex.finish(pending.pop(0)))
            results.append(ex.finish(pending.pop(0)))
        except BaseException:
            # the failed run's own workers were stopped by its drain;
            # runs started ahead still hold decoded chunks
            for run in pending:
                ex.cancel(run)
            raise
        return results, sum(r.seconds for r in results)
    finally:
        if own_pool is not None:
            own_pool.close()
