"""Streaming clip executor: the stage graph of the chunked MultiScope
pipeline, on a GPU.

The port of the JAX package's ``repro.core.executor`` single-stream
path.  One clip is cut into chunks of B frames; each chunk runs:

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
            buckets; ``decode_detections`` + ``nms`` on the host;
  TRACK   — crop embeddings for the whole chunk in one device call
            (``tracker.embed_dets_chunk``), then the tracker in frame
            order (the only stage with cross-chunk state): on the host by
            default, one ``track_step`` launch per frame with
            ``device_assign``, the chunk's recurrence on the device with
            ``device_tracker``.

Two schedulers drive the graph: ``SequentialScheduler`` (every stage of
chunk k completes before chunk k+1 starts) and ``StreamingScheduler``
(DECODE, and with double buffering the device upload, of chunk k+1 runs
on a background thread while chunk k is in PROXY/DETECT/TRACK; the
hand-off queue holds at most ``prefetch_depth`` chunks).  Tracks do not
depend on the scheduler.  When θ asks for refinement and the bank has a
refiner, ``finish`` refines the tracks.

Buffer ownership: the padded device copy of a chunk (``frames_dev``,
(B, H, W, 3) f32, about 100 MB at 960x544) is uploaded by the decode
worker (double buffering) or lazily by DETECT, is needed only for
sub-frame window gathers, and is dropped as soon as DETECT finishes, so
at most ``prefetch_depth`` + 1 such buffers exist.

Not ported yet: the decode pool, the cross-stream brokers (the track
broker among them), the mesh and multi-device options, and tracing.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

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
from repro_torch.kernels.window_gather import window_gather_batch
from repro_torch.obs.metrics import RunProfile

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

    ``prefetch``       — decode chunk k+1 on a background thread while
                         chunk k is in proxy/detect/track;
    ``prefetch_depth`` — max decoded chunks in flight (bounds host and
                         device memory);
    ``double_buffer``  — upload ``frames_dev`` in the decode worker so
                         the copy overlaps the previous chunk's detector
                         work (only when a proxy is active: all-full-frame
                         plans never need the buffer);
    ``chunk_size``     — override θ's B;
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
                         bit-identical.

    The run's device is the bank's (``ModelBank.device``).
    """
    prefetch: bool = True
    prefetch_depth: int = 2
    double_buffer: bool = True
    chunk_size: Optional[int] = None
    fused_plan: bool = True
    device_assign: bool = False
    device_tracker: bool = False


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


class _RunContext:
    """Per-clip derived state shared by every stage."""

    def __init__(self, bank: ModelBank, params: PipelineParams,
                 clip: Clip, options: ExecutorOptions):
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
        self.tracker = make_tracker(
            bank, params, device_assign=options.device_assign,
            device_tracker=options.device_tracker)
        self.batch_embed = isinstance(self.tracker, RecurrentTracker)
        # upload in the decode worker only when the buffer can be used:
        # sub-frame gathers need an active proxy, and the previous
        # chunk's plan predicts whether this one will gather at all
        self.predecode_upload = bool(options.double_buffer
                                     and self.proxy is not None)
        self.prev_chunk_gathered = False    # benign cross-thread read
        self.frame_ids = list(range(0, clip.n_frames, params.gap))
        # ledger + RunResult counters, accumulated by TRACK (the only
        # stage that is strictly sequenced)
        self.charged = 0.0
        self.n_windows = 0
        self.full_frames = 0
        self.skipped = 0
        self.profile = RunProfile(STAGES)

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
    on the prefetch worker."""
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
    else:
        task.plan = full_frame_plan(len(task.frame_ids), ctx.sizeset)
    return task


def stage_detect(ctx: _RunContext, task: ChunkTask) -> ChunkTask:
    """Cross-frame bucketed detection; reassemble per-frame detections
    in the exact order the per-frame reference path produces them."""
    detector = ctx.detector
    W, H = ctx.W, ctx.H
    plan, frames = task.plan, task.frames
    frames_dev = task.frames_dev
    per_window: Dict[Tuple[int, int], np.ndarray] = {}
    for size, entries in plan.by_size.items():
        pw, ph = size[0] * CELL_PX, size[1] * CELL_PX
        n = len(entries)
        origins = [(x * CELL_PX / W, y * CELL_PX / H)
                   for (_, x, y, _) in entries]
        scales = [(pw / W, ph / H)] * n
        ctx.profile.dispatch("detect")
        if (pw, ph) == (W, H):
            # full-frame windows: the crop is the frame itself
            stack = frames[[slot for (slot, _, _, _) in entries]]
            dets = detector.detect_batch_bucketed(
                stack, ctx.params.det_conf, origins=origins,
                scales=scales)
        else:
            if frames_dev is None:       # lazy path (no double buffer)
                frames_dev = ctx.upload(task)
            # zero padding rows crop frame 0 at cell (0, 0)
            tbl = np.zeros((next_bucket(n), 3), np.int32)
            for k, (slot, x, y, _) in enumerate(entries):
                tbl[k] = (slot, y, x)
            crops = window_gather_batch(frames_dev, tbl, win_h=ph,
                                        win_w=pw, cell=CELL_PX)
            # crops stay on the device: the detector takes them as is
            dets = detector.detect_batch(
                crops, ctx.params.det_conf, origins=origins,
                scales=scales, n_valid=n)
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
    # DETECT is the device buffer's last consumer: drop it here so at
    # most prefetch_depth + 1 buffers are alive
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


STAGE_FNS: Dict[str, Callable[[_RunContext, ChunkTask], ChunkTask]] \
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

class SequentialScheduler:
    """Every stage of chunk k completes before chunk k+1 starts."""

    def start(self, ctx: _RunContext, tasks: List[ChunkTask],
              stages: Dict[str, Callable]):
        return iter(tasks)

    def drain(self, ctx: _RunContext, handle,
              stages: Dict[str, Callable]) -> None:
        for task in handle:
            for name in STAGES:
                task = stages[name](ctx, task)


class StreamingScheduler:
    """DECODE runs ahead on one background thread behind a bounded
    hand-off queue; PROXY/DETECT/TRACK run on the draining thread in
    chunk order (the queue preserves it), so TRACK sees frames in
    order."""

    def __init__(self, depth: int = 2):
        self.depth = max(1, int(depth))

    def start(self, ctx: _RunContext, tasks: List[ChunkTask],
              stages: Dict[str, Callable]):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def worker():
            for task in tasks:
                if stop.is_set():
                    return
                try:
                    item = stages["decode"](ctx, task)
                except BaseException as exc:    # surfaced by drain()
                    q.put(_WorkerFailure(exc))
                    return
                q.put(item)

        th = threading.Thread(target=worker, daemon=True,
                              name="multiscope-decode")
        th.start()
        return q, th, len(tasks), stop

    @staticmethod
    def _stop(handle) -> None:
        """Stop the decode worker and discard what it produced.  It may
        be blocked in ``q.put`` on the full queue, so keep consuming
        until it exits — a bare ``join`` would deadlock."""
        q, th, _, stop = handle
        stop.set()
        while th.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        th.join()

    def drain(self, ctx: _RunContext, handle,
              stages: Dict[str, Callable]) -> None:
        q, th, n, _ = handle
        try:
            for _ in range(n):
                item = q.get()
                if isinstance(item, _WorkerFailure):
                    raise item.exc
                task = item
                for name in STAGES[1:]:
                    task = stages[name](ctx, task)
        except BaseException:
            # unblock the producer before propagating, or its q.put on
            # the full queue never returns
            self._stop(handle)
            raise
        th.join()


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
    name that same device.  ``options.prefetch`` picks the scheduler.
    ``start``/``finish`` expose the two-phase form.
    """

    def __init__(self, bank: ModelBank, params: PipelineParams,
                 options: Optional[ExecutorOptions] = None,
                 device: Optional[Device] = None):
        if device is not None and resolve_device(device) != bank.device:
            raise ValueError(f"executor on {device}, bank on {bank.device}")
        self.bank = bank
        self.params = params
        self.options = options or ExecutorOptions()
        self.stages = {name: _timed(name, fn)
                       for name, fn in STAGE_FNS.items()}
        if self.options.prefetch:
            self.scheduler = StreamingScheduler(self.options.prefetch_depth)
        else:
            self.scheduler = SequentialScheduler()

    def _tasks(self, ctx: _RunContext) -> List[ChunkTask]:
        ids = ctx.frame_ids
        return [ChunkTask(i, ids[c0:c0 + ctx.chunk])
                for i, c0 in enumerate(range(0, len(ids), ctx.chunk))]

    def start(self, clip: Clip) -> _ActiveRun:
        ctx = _RunContext(self.bank, self.params, clip, self.options)
        handle = self.scheduler.start(ctx, self._tasks(ctx), self.stages)
        return _ActiveRun(ctx, handle)

    def finish(self, run: _ActiveRun) -> RunResult:
        ctx = run.ctx
        t0 = time.process_time()
        self.scheduler.drain(ctx, run.handle, self.stages)
        tracks = ctx.tracker.result()
        if ctx.params.refine and ctx.bank.refiner is not None:
            tracks = [ctx.bank.refiner.refine(t) for t in tracks]
        seconds = time.process_time() - t0 + max(ctx.charged, 0.0)
        track_disp = int(getattr(ctx.tracker, "dispatches", 0)) \
            + ctx.profile.dispatches("embed")
        dispatches = {"proxy": ctx.profile.dispatches("proxy"),
                      "detect": ctx.profile.dispatches("detect"),
                      "track": track_disp}
        return RunResult(tracks, seconds, len(ctx.frame_ids),
                         ctx.n_windows, ctx.full_frames, ctx.skipped,
                         stage_seconds=ctx.profile.stage_seconds(),
                         dispatches=dispatches)

    def run(self, clip: Clip) -> RunResult:
        return self.finish(self.start(clip))


def run_clip_streamed(bank: ModelBank, params: PipelineParams,
                      clip: Clip,
                      options: Optional[ExecutorOptions] = None
                      ) -> RunResult:
    """One clip through the streaming executor (prefetch on by
    default), on the bank's device."""
    return ClipExecutor(bank, params, options).run(clip)
