"""Incremental secondary-index merge for one open clip.

The port of the JAX package's ``repro.stream.state``
(``src/repro/stream/state.py``). The same code, host numpy.

The batch path builds a clip's index (count histograms, per-track
bboxes, ``ClipSummary``) from scratch at materialize time
(``repro_torch.query.index.build_index``).  Mid-stream that would be an
O(rows) rebuild per appended segment; ``StreamIndexState`` instead
folds each watermark's NEW information into persistent structures in
O(changed rows + histogram width):

  * **histogram merge** — raw tracks are append-only (the stream path
    forbids refinement), so a track's existing rows never change and
    per-frame counts only grow.  For bucket ``b``: a track already
    qualified (``prev_len >= b``) contributes just its NEW rows; a
    track that CROSSED the bucket this segment (``prev_len < b <=
    new_len``) contributes all its rows — the old ones were never
    counted under ``b``.  Tracks that didn't change contribute nothing
    and are never touched.
  * **bbox / occupancy merge** — per-track envelopes and the per-bucket
    GRID occupancy masks grow monotonically by the same new/crossed
    split.
  * **summary** — rebuilt from the (incrementally maintained) hist +
    bboxes via ``index.summarize`` with the precomputed grid masks
    passed through, so its scalars are bit-identical to a full rebuild
    by construction; the differential tests additionally assert the
    hist/bbox arrays themselves equal ``build_index`` run from scratch
    at every watermark (tests/test_stream.py).

The merge also emits the watermark's ``TrackDelta`` list — per changed
track, the visible rows not yet delivered downstream.  Standing
queries consume exactly these deltas, which is what makes their
incremental evaluation scan each visible row once, ever
(``repro_torch.stream.standing``).

Everything here derives deterministically from the visible tracks at a
watermark, so the state can be REBUILT from a stored open-clip NPZ
(``from_packed``) when an ingestor resumes in a fresh process.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.query.index import (MIN_LEN_BUCKETS, grids_from_rows,
                                     occupancy_mask, summarize)
from repro_torch.query.store import PackedTracks


@dataclass
class TrackDelta:
    """One visible track's not-yet-delivered rows at a watermark.

    ``rows`` are the track's rows beyond what earlier watermarks
    delivered — for a track newly visible (it just reached the
    tracker's ``min_hits``) that is ALL its rows, including the
    pre-watermark ones it accumulated while invisible."""
    track_id: int
    prev_len: int               # visible rows delivered before
    new_len: int                # visible rows now
    rows: np.ndarray            # (new_len - prev_len, 6)


@dataclass
class WatermarkDelta:
    """What one ``merge`` call changed.

    Besides the per-track view (``tracks``), the merge precomputes the
    delta ONCE as plain Python lists, shared by every standing query
    subscribed to the clip.  Deltas are a few dozen rows; at that size
    a pure-Python fold beats numpy outright (each vector op pays ~µs
    of dispatch for ~ns of work), so the standing-query hot path never
    touches numpy at all (``repro_torch.stream.standing``).
    ``prev_watermark`` lets a consumer prove the delta follows exactly
    what it has already folded (sequential-delivery fast path)."""
    watermark: int
    prev_watermark: int = -1
    tracks: List[TrackDelta] = field(default_factory=list)
    rows_delivered: int = 0     # sum of len(td.rows)
    rows_list: Optional[list] = None    # R x [f, cx, cy, w, h, tid]
    tid_list: Optional[list] = None     # per-track ids
    len_list: Optional[list] = None     # per-track visible lengths now
    n_list: Optional[list] = None       # per-track delta row counts

    def finalize(self) -> "WatermarkDelta":
        """Build the shared plain-Python view from ``tracks``."""
        if self.tracks:
            self.rows_list = (
                np.concatenate([td.rows for td in self.tracks])
                if len(self.tracks) > 1 else self.tracks[0].rows
            ).tolist()
            self.tid_list = [td.track_id for td in self.tracks]
            self.len_list = [td.new_len for td in self.tracks]
            self.n_list = [len(td.rows) for td in self.tracks]
        else:
            self.rows_list = []
            self.tid_list = []
            self.len_list = []
            self.n_list = []
        return self


class StreamIndexState:
    """Incrementally maintained index for one open clip."""

    def __init__(self, n_frames: int):
        self.n_frames = int(n_frames)
        B = len(MIN_LEN_BUCKETS)
        # full-span histogram; snapshots slice [:, :watermark]
        self.hist = np.zeros((B, self.n_frames), np.int32)
        self.grid: List[int] = [0] * B
        self.delivered: Dict[int, int] = {}      # tid -> rows delivered
        self.bbox: Dict[int, np.ndarray] = {}    # tid -> (4,) envelope
        self._last_watermark = 0                 # delta sequencing

    # -- resume ---------------------------------------------------------------

    @classmethod
    def from_packed(cls, packed: PackedTracks,
                    n_frames: int) -> "StreamIndexState":
        """Rebuild the merge state from a stored open-clip NPZ (resume
        path).  The stored hist/track_bbox ARE the state; delivered
        lengths come from the offsets, and grid masks from the
        persisted summary (or the rows when the summary predates
        grids)."""
        st = cls(n_frames)
        packed.build_index_arrays()
        st.hist[:, :packed.hist.shape[1]] = packed.hist
        summary = packed.summary
        for i in range(packed.n_tracks):
            tr = packed.track(i)
            tid = int(tr[0, 5])
            st.delivered[tid] = len(tr)
            st.bbox[tid] = packed.track_bbox[i].astype(np.float32).copy()
        st._last_watermark = packed.watermark \
            if packed.watermark is not None else packed.n_frames
        if summary.grid is not None:
            st.grid = list(summary.grid)
        else:
            st.grid = list(grids_from_rows(packed.rows, packed.offsets))
        return st

    # -- the merge ------------------------------------------------------------

    def merge(self, tracks: Sequence[np.ndarray],
              watermark: int) -> WatermarkDelta:
        """Fold a watermark's visible tracks into the index.  ``tracks``
        is the tracker's current ``result()`` — visible tracks in
        packed order; only tracks whose visible length grew are
        touched."""
        delta = WatermarkDelta(int(watermark),
                               prev_watermark=self._last_watermark)
        self._last_watermark = int(watermark)
        for tr in tracks:
            if not len(tr):
                continue
            tid = int(tr[0, 5])
            prev = self.delivered.get(tid, 0)
            n = len(tr)
            if n == prev:
                continue                # untouched this segment
            if n < prev:                # appends only — see module doc
                raise RuntimeError(
                    f"track {tid} shrank ({prev} -> {n} rows); the "
                    f"stream index merge requires append-only tracks "
                    f"(is refinement enabled?)")
            new = tr[prev:]
            f_new = new[:, 0].astype(np.int64)
            f_all = tr[:, 0].astype(np.int64)
            for bi, b in enumerate(MIN_LEN_BUCKETS):
                if prev >= b:           # already qualified: new rows only
                    np.add.at(self.hist[bi], f_new, 1)
                    self.grid[bi] |= occupancy_mask(new[:, 1], new[:, 2])
                elif n >= b:            # crossed the bucket: all rows
                    np.add.at(self.hist[bi], f_all, 1)
                    self.grid[bi] |= occupancy_mask(tr[:, 1], tr[:, 2])
            bb = self.bbox.get(tid)
            if bb is None:
                bb = np.asarray([np.inf, np.inf, -np.inf, -np.inf],
                                np.float32)
                self.bbox[tid] = bb
            bb[0] = min(bb[0], float(new[:, 1].min()))
            bb[1] = min(bb[1], float(new[:, 2].min()))
            bb[2] = max(bb[2], float(new[:, 1].max()))
            bb[3] = max(bb[3], float(new[:, 2].max()))
            self.delivered[tid] = n
            delta.tracks.append(TrackDelta(tid, prev, n, new))
            delta.rows_delivered += len(new)
        return delta.finalize()

    # -- snapshots ------------------------------------------------------------

    def attach(self, packed: PackedTracks, watermark: int) -> None:
        """Attach the merged index to this watermark's ``PackedTracks``
        — the exact arrays ``build_index``/``summarize`` would produce
        from scratch (asserted differentially, tests/test_stream.py).
        The hist slice is a copy, so later merges never mutate a
        served ``PackedTracks``."""
        width = int(watermark)
        if len(packed.rows):
            width = max(width, int(packed.rows[:, 0].max()) + 1)
        packed.hist = self.hist[:, :width].copy()
        empty = np.asarray([np.inf, np.inf, -np.inf, -np.inf],
                           np.float32)
        if packed.n_tracks:
            boxes = []
            for i in range(packed.n_tracks):
                if packed.offsets[i] == packed.offsets[i + 1]:
                    boxes.append(empty.copy())      # zero-length stub
                    continue
                tid = int(packed.rows[packed.offsets[i], 5])
                boxes.append(self.bbox.get(tid, empty).copy())
            packed.track_bbox = np.stack(boxes).astype(np.float32)
        else:
            packed.track_bbox = np.empty((0, 4), np.float32)
        packed._summary = summarize(packed.rows, packed.offsets,
                                    packed.hist, packed.track_bbox,
                                    grid=tuple(self.grid))
