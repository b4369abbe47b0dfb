"""TrackerCheckpoint: the TRACK stage's cross-chunk state, made
serializable and resumable.

The port of the JAX package's ``repro.stream.checkpoint``
(``src/repro/stream/checkpoint.py``). The same code and NPZ layout, so a
checkpoint either package writes resumes in the other.  ``restore``
builds the port's trackers (the host ``RecurrentTracker``, its
``assign="device"`` flavour or ``DeviceTracker``), whose track state is
host numpy in every flavour, so ``capture`` reads no device tensor.

TRACK is the only pipeline stage with cross-chunk state — everything
else (decode, proxy, detect) is chunk-local and bit-identical for any
chunking (tests/test_executor.py).  That means a clip can be ingested
as N appended segments and produce EXACTLY the tracks of a one-shot
run, provided the tracker's state survives the segment boundary:

  * the active track set — per track: id, frames, boxes, miss count,
    and (recurrent tracker) the GRU hidden state;
  * the finished track list, in finish order (``result()`` emits
    finished + active, so ORDER is part of the bit-identity contract);
  * the next-id counter and, for the recurrent tracker, the last
    stepped frame (the ``t_elapsed`` anchor of the next step);
  * the frame cursor — the next frame index of θ's gap progression not
    yet decoded, so segment boundaries that fall between gap strides
    resume at the right frame.

``capture``/``restore`` snapshot a live ``SortTracker`` /
``RecurrentTracker``; ``to_arrays``/``from_arrays`` flatten the
checkpoint into a dict of numpy arrays for NPZ persistence
(``SegmentIngestor`` writes one sidecar per open clip, so an ingestor
in a NEW process resumes mid-stream bit-identically —
tests/test_stream.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sort import SortTracker, Track
from repro_torch.core.tracker import RecurrentTracker, _ActiveTrack

_KINDS = ("sort", "recurrent")


@dataclass
class TrackState:
    """One track's serializable state (both tracker flavors)."""
    track_id: int
    frames: List[int]
    boxes: List[np.ndarray]             # (4,) float32 each
    misses: int
    h: Optional[np.ndarray] = None      # GRU hidden (recurrent only)


@dataclass
class TrackerCheckpoint:
    """Everything needed to resume TRACK mid-stream.  ``counters`` and
    ``seconds`` carry the stream's accumulated ``RunResult``
    bookkeeping, so a resume that ROLLS BACK to the checkpoint (the
    store may be an append or two ahead when ``checkpoint_every > 1``
    or a crash hit between materialize and checkpoint) still seals
    with counters bit-identical to a one-shot ingest."""
    kind: str                           # "sort" | "recurrent"
    cursor: int                         # next gap-progression frame
    watermark: int                      # frames appended so far
    next_id: int
    last_frame: Optional[int]           # recurrent t_elapsed anchor
    finished: List[TrackState] = field(default_factory=list)
    active: List[TrackState] = field(default_factory=list)
    counters: Tuple[int, ...] = (0, 0, 0, 0)
    seconds: float = 0.0

    # -- live tracker <-> checkpoint ------------------------------------------

    @classmethod
    def capture(cls, tracker, cursor: int, watermark: int,
                counters: Sequence[int] = (0, 0, 0, 0),
                seconds: float = 0.0) -> "TrackerCheckpoint":
        if isinstance(tracker, RecurrentTracker):
            kind, last = "recurrent", tracker._last_frame
        elif isinstance(tracker, SortTracker):
            kind, last = "sort", None
        else:
            raise TypeError(f"cannot checkpoint {type(tracker).__name__}")

        def snap(t) -> TrackState:
            return TrackState(
                int(t.track_id), [int(f) for f in t.frames],
                [np.asarray(b, np.float32).copy() for b in t.boxes],
                int(t.misses),
                h=(np.asarray(t.h, np.float32).copy()
                   if kind == "recurrent" else None))

        return cls(kind, int(cursor), int(watermark),
                   int(tracker._next_id),
                   None if last is None else int(last),
                   [snap(t) for t in tracker.finished],
                   [snap(t) for t in tracker.active],
                   tuple(int(c) for c in counters), float(seconds))

    def restore(self, bank, params, options=None):
        """A live tracker continuing exactly from this state (the same
        construction path ``executor._RunContext`` uses).  ``options``
        (an ``ExecutorOptions`` or anything with ``device_assign`` /
        ``device_tracker`` attributes) picks the execution flavor — a
        scheduling choice, so a stream checkpointed under one flavor
        resumes bit-identically under any other."""
        if self.kind == "recurrent":
            if bank.tracker_params is None:
                raise ValueError("recurrent checkpoint needs a bank "
                                 "with tracker_params")
            if getattr(options, "device_tracker", False):
                from repro_torch.core.tracker import DeviceTracker
                tracker = DeviceTracker(bank.cfg.tracker,
                                        bank.tracker_params)
            else:
                assign = "device" \
                    if getattr(options, "device_assign", False) \
                    else "host"
                tracker = RecurrentTracker(bank.cfg.tracker,
                                           bank.tracker_params,
                                           assign=assign)
            tracker._last_frame = self.last_frame

            def wake(s: TrackState):
                return _ActiveTrack(s.track_id,
                                    np.asarray(s.h, np.float32),
                                    list(s.frames),
                                    [b.copy() for b in s.boxes],
                                    s.misses)
        else:
            tracker = SortTracker()

            def wake(s: TrackState):
                return Track(s.track_id, list(s.frames),
                             [b.copy() for b in s.boxes], s.misses)
        tracker.finished = [wake(s) for s in self.finished]
        tracker.active = [wake(s) for s in self.active]
        tracker._next_id = self.next_id
        return tracker

    # -- NPZ flattening -------------------------------------------------------

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Flatten to fixed-name numpy arrays (``np.savez``-able).
        Tracks serialize finished-first, then active, with row data
        packed ``(N, 5)`` ``[frame, cx, cy, w, h]`` and per-track
        ``(id, misses, n_rows)`` meta."""
        tracks = self.finished + self.active
        meta = np.asarray(
            [_KINDS.index(self.kind), self.cursor, self.watermark,
             self.next_id,
             -1 if self.last_frame is None else self.last_frame,
             len(self.finished), len(self.active),
             *self.counters], np.int64)
        tmeta = np.asarray([(t.track_id, t.misses, len(t.frames))
                            for t in tracks], np.int64).reshape(-1, 3)
        rows = np.zeros((int(tmeta[:, 2].sum()) if len(tracks) else 0, 5),
                        np.float32)
        k = 0
        for t in tracks:
            n = len(t.frames)
            rows[k:k + n, 0] = t.frames
            if n:
                rows[k:k + n, 1:5] = np.stack(t.boxes)
            k += n
        out = {"meta": meta, "tmeta": tmeta, "rows": rows,
               "seconds": np.asarray([self.seconds], np.float64)}
        if self.kind == "recurrent":
            out["h"] = np.stack([t.h for t in tracks]) if tracks \
                else np.zeros((0, 0), np.float32)
        return out

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]
                    ) -> "TrackerCheckpoint":
        meta = arrays["meta"]
        kind = _KINDS[int(meta[0])]
        n_finished = int(meta[5])
        tracks: List[TrackState] = []
        k = 0
        for i, (tid, misses, n) in enumerate(arrays["tmeta"]):
            rows = arrays["rows"][k:k + int(n)]
            k += int(n)
            tracks.append(TrackState(
                int(tid), [int(f) for f in rows[:, 0]],
                [rows[j, 1:5].astype(np.float32).copy()
                 for j in range(len(rows))],
                int(misses),
                h=(arrays["h"][i].astype(np.float32).copy()
                   if kind == "recurrent" else None)))
        counters = tuple(int(v) for v in meta[7:11]) \
            if len(meta) >= 11 else (0, 0, 0, 0)
        seconds = float(arrays["seconds"][0]) \
            if "seconds" in arrays else 0.0
        return cls(kind, int(meta[1]), int(meta[2]), int(meta[3]),
                   None if int(meta[4]) < 0 else int(meta[4]),
                   tracks[:n_finished], tracks[n_finished:],
                   counters, seconds)

    def save(self, path: str) -> None:
        tmp = path + ".tmp.npz"
        np.savez(tmp, **self.to_arrays())
        import os
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "TrackerCheckpoint":
        with np.load(path) as z:
            return cls.from_arrays({k: z[k] for k in z.files})
