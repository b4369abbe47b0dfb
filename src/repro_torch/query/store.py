"""TrackStore: materialize pre-processed tracks once, serve them forever.

The port of the JAX package's ``repro.query.store``
(``src/repro/query/store.py``). The same code and on-disk layout
(version directories, clip NPZ keys and dtypes, ``index.json``,
``meta.json``), so a store either package writes is read by the other;
``ingest`` extracts through the port's ``run_clips`` on the bank's
device (the card unless the bank was built on the CPU).

The store persists ``executor.run_clips`` outputs keyed by
``(dataset, clip, θ-fingerprint)``:

  * **θ-fingerprint** — a hash of the TRACK-RELEVANT fields of
    ``PipelineParams``.  Scheduling-only knobs (``chunk_size``) are
    excluded: tracks are bit-identical across chunk sizes by
    construction (tests/test_executor.py), so re-tuning B must not
    invalidate materialized tracks.  Any change to a field that can
    change tracks (arch, resolution, confidence, gap, proxy, tracker,
    refine) yields a new fingerprint, i.e. a new store version; stale
    versions stay on disk until ``prune()``.
  * **Layout** — one NPZ per clip under
    ``root/<dataset>/<fingerprint>/<split>_<clip>_<frames>.npz`` holding
    the packed track arrays, the run's cost counters, and the clip's
    secondary index (count histograms + per-track bboxes,
    ``repro_torch.query.index``); one ``meta.json`` per fingerprint directory
    describing θ; and one ``index.json`` per fingerprint directory with
    every clip's ``ClipSummary`` + byte size + last-used time.  The
    summaries survive eviction of their NPZ, so the planner can still
    prove an evicted clip irrelevant without re-ingesting it.
  * **Packed representation** — all of a clip's tracks concatenated
    into one ``(N, 6)`` row array ``[frame, cx, cy, w, h, track_id]``
    with an offsets array delimiting tracks.  Query plans
    (``repro_torch.query.plan``) scan these packed arrays with vectorized
    numpy ops; nothing at query time is per-track Python.
  * **Incremental ingest** — ``ingest(clips)`` materializes only the
    clips missing from the current version, streaming them through the
    executor with cross-clip decode prefetch (``executor.run_clips``).
    A fully-materialized split re-ingests with ZERO detector calls and
    zero decodes (asserted by tests/test_query.py).
  * **Bounded size** — an optional ``StoreBudget(max_bytes,
    ttl_seconds)`` caps the version's disk footprint: after each ingest
    (and on ``set_budget``) the least-recently-used clip NPZs are
    evicted from memory AND disk until the budget holds.  Evicted clips
    stay summarized in ``index.json`` and re-ingest transparently on
    the next touch (tracks are deterministic per fingerprint, so the
    re-extracted data — and its index — are identical).

The store itself is thread-safe (one lock around the in-memory index
and disk writes); ``QueryService`` layers concurrent query execution
and transparent cold-clip ingest on top.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.executor import ExecutorOptions, run_clips
from repro_torch.core.pipeline import ModelBank, PipelineParams, RunResult
from repro_torch.data.video_synth import Clip
from repro_torch.query.index import (MIN_LEN_BUCKETS, ClipSummary, build_index,
                                     summarize)

SCHEMA_VERSION = 1

# PipelineParams fields that CANNOT change extracted tracks (pure
# scheduling knobs; see module docstring).  A denylist, so any field
# added to θ later is track-relevant — and store-invalidating — by
# default; a new scheduling-only knob must opt in here explicitly.
_SCHEDULING_ONLY = ("chunk_size",)

ClipKey = Tuple[str, str, int, int]     # (dataset, split, clip_id, n_frames)


def _track_fields(params: PipelineParams) -> Dict[str, object]:
    return {f.name: getattr(params, f.name)
            for f in dataclasses.fields(params)
            if f.name not in _SCHEDULING_ONLY}


def theta_fingerprint(params: PipelineParams) -> str:
    """Stable hex fingerprint of θ's track-relevant fields."""
    payload = _track_fields(params)
    payload["schema"] = SCHEMA_VERSION
    blob = json.dumps(payload, sort_keys=True, default=list)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def clip_key(clip: Clip) -> ClipKey:
    return (clip.profile.name, clip.split, clip.clip_id, clip.n_frames)


def _clip_name(key: ClipKey) -> str:
    _, split, clip_id, n_frames = key
    return f"{split}_{clip_id}_{n_frames}"


@dataclass
class PackedTracks:
    """One clip's tracks as packed numpy arrays (the query-scan format).

    ``rows``    — (N, 6) ``[frame, cx, cy, w, h, track_id]``, all tracks
                  concatenated in track order;
    ``offsets`` — (T+1,) int64; track i is ``rows[offsets[i]:offsets[i+1]]``.

    ``hist`` / ``track_bbox`` are the clip's secondary index
    (``repro_torch.query.index.build_index``), built at pack time, persisted
    in the NPZ, and rebuilt lazily for arrays packed elsewhere.

    Derived arrays used by every plan (row→track map, per-track lengths)
    are computed once and cached; per-track pattern classification is
    computed lazily on first class-filtered query (it needs the clip's
    profile, so it cannot be precomputed dataset-independently).
    """
    rows: np.ndarray
    offsets: np.ndarray
    n_frames: int
    fps: int
    seconds: float = 0.0                    # extraction cost (RunResult)
    counters: Tuple[int, ...] = ()          # RunResult counter snapshot
    hist: Optional[np.ndarray] = field(default=None, repr=False)
    track_bbox: Optional[np.ndarray] = field(default=None, repr=False)
    # OPEN-clip marker (live ingestion, ``repro_torch.stream``): frames
    # [0, watermark) have been appended and extracted; None for sealed
    # clips.  ``n_frames`` equals the watermark while open, so every
    # frame-indexed structure (hist width, bincount minlength) covers
    # exactly the ingested prefix and grows monotonically per append.
    watermark: Optional[int] = None
    _summary: Optional[ClipSummary] = field(default=None, repr=False)
    _row_track: Optional[np.ndarray] = field(default=None, repr=False)
    _classes: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def n_tracks(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def row_track(self) -> np.ndarray:
        """(N,) track index of every row."""
        if self._row_track is None:
            self._row_track = np.repeat(
                np.arange(self.n_tracks, dtype=np.int64), self.lengths)
        return self._row_track

    def build_index_arrays(self) -> None:
        """Ensure ``hist``/``track_bbox`` exist (idempotent)."""
        if self.hist is None or self.track_bbox is None:
            self.hist, self.track_bbox = build_index(
                self.rows, self.offsets, self.n_frames)

    @property
    def summary(self) -> ClipSummary:
        """The clip's scalar index digest (built on first use)."""
        if self._summary is None:
            self.build_index_arrays()
            self._summary = summarize(self.rows, self.offsets,
                                      self.hist, self.track_bbox)
        return self._summary

    def track(self, i: int) -> np.ndarray:
        return self.rows[self.offsets[i]:self.offsets[i + 1]]

    def tracks(self) -> List[np.ndarray]:
        return [self.track(i) for i in range(self.n_tracks)]

    def classes(self, profile) -> np.ndarray:
        """(T,) per-track pattern id (``metrics.classify_track``), -1
        for unclassifiable stubs.  Cached after the first call."""
        if self._classes is None:
            from repro_torch.core.metrics import classify_track
            out = np.full(self.n_tracks, -1, np.int64)
            for i in range(self.n_tracks):
                c = classify_track(self.track(i), profile)
                if c is not None:
                    out[i] = c
            self._classes = out
        return self._classes

    @classmethod
    def pack(cls, tracks: Sequence[np.ndarray], clip: Clip,
             result: Optional[RunResult] = None,
             n_frames: Optional[int] = None,
             build: bool = True) -> "PackedTracks":
        """``n_frames`` overrides the frame span (the stream path packs
        an open clip at its watermark); ``build=False`` skips the index
        rebuild so an incrementally merged index can be attached
        instead (``repro_torch.stream.state``)."""
        offsets = np.zeros(len(tracks) + 1, np.int64)
        parts = []
        for i, t in enumerate(tracks):
            offsets[i + 1] = offsets[i] + len(t)
            parts.append(np.asarray(t, np.float32).reshape(len(t), 6))
        rows = np.concatenate(parts) if parts \
            else np.zeros((0, 6), np.float32)
        counters = () if result is None else (
            result.frames_processed, result.detector_windows,
            result.full_frames, result.skipped_frames)
        seconds = 0.0 if result is None else float(result.seconds)
        span = clip.n_frames if n_frames is None else int(n_frames)
        packed = cls(rows, offsets, span, clip.profile.fps,
                     seconds, counters)
        if build:
            packed.build_index_arrays()
        return packed


@dataclass
class StoreBudget:
    """Size/age bound on one store version's materialized clips.

    ``max_bytes``   — evict least-recently-used clip NPZs until the
                      version's disk footprint is at or under the cap;
    ``ttl_seconds`` — evict clips not touched for this long.

    Enforcement runs at the end of every ``ingest`` and on
    ``set_budget``; the clips of the in-flight ingest batch are never
    evicted by their own ingest (so a query's working set becomes fully
    warm before LRU pressure applies), which means a single batch
    larger than ``max_bytes`` leaves the store above budget until a
    later enforcement — size your budget to hold one query's working
    set.  Eviction is metadata-preserving: the clip's summary stays in
    ``index.json`` for index-based skipping, and the next touch
    re-ingests bit-identical data.
    """
    max_bytes: Optional[int] = None
    ttl_seconds: Optional[float] = None


@dataclass
class IngestReport:
    """What one ``ingest`` call actually did."""
    requested: int = 0          # clips asked for
    ingested: int = 0           # clips that ran through the executor
    cached: int = 0             # clips already materialized
    frames: int = 0             # frames processed during this ingest
    seconds: float = 0.0        # summed RunResult.seconds (cost model)
    wall_seconds: float = 0.0   # wall clock of the executor sweep
    evicted: int = 0            # clips evicted by budget enforcement
    evicted_bytes: int = 0      # bytes freed by those evictions
    store_bytes: int = 0        # version disk footprint after ingest

    @property
    def fps(self) -> float:
        return self.frames / self.wall_seconds if self.wall_seconds > 0 \
            else 0.0


class TrackStore:
    """Persistent, versioned store of extracted tracks for one θ.

    ``set_params`` re-points the store at a different θ version: the
    in-memory index is invalidated and subsequent lookups hit the new
    fingerprint's directory (cold until re-ingested).  All public
    methods are thread-safe.
    """

    def __init__(self, root: str, bank: Optional[ModelBank],
                 params: PipelineParams,
                 options: Optional[ExecutorOptions] = None,
                 budget: Optional[StoreBudget] = None):
        self.root = root
        self.bank = bank
        self.options = options
        # guarded-by: _lock
        self.budget = budget
        self._lock = threading.RLock()
        self._index: Dict[ClipKey, PackedTracks] = {}   # guarded-by: _lock
        # per-clip index.json entries for the CURRENT fingerprint:
        # {"summary": ClipSummary, "bytes": int, "last_used": float,
        #  "present": bool}; populated lazily per dataset directory
        self._entries: Dict[ClipKey, dict] = {}     # guarded-by: _lock
        self._loaded_datasets: Set[str] = set()     # guarded-by: _lock
        self.evictions = 0              # guarded-by: _lock (lifetime counters)
        self.evicted_bytes = 0          # guarded-by: _lock
        from repro_torch.obs.metrics import REGISTRY
        self._m_evictions = REGISTRY.counter("store.evictions")
        self._m_evicted_bytes = REGISTRY.counter("store.evicted_bytes")
        # /healthz store_budget inputs: present-bytes over budget-bytes
        # (budget gauge stays 0 for unbudgeted stores -> "no data")
        self._m_bytes = REGISTRY.gauge("store.bytes")
        self._m_budget_bytes = REGISTRY.gauge("store.budget_bytes")
        if budget is not None and budget.max_bytes is not None:
            self._m_budget_bytes.set(budget.max_bytes)
        self.params: Optional[PipelineParams] = None    # guarded-by: _lock
        self.fingerprint: Optional[str] = None      # guarded-by: _lock
        self.set_params(params)

    # -- versioning -----------------------------------------------------------

    def set_params(self, params: PipelineParams) -> None:
        """Point the store at θ; a changed fingerprint invalidates the
        in-memory index (disk versions are kept until ``prune``)."""
        fp = theta_fingerprint(params)
        with self._lock:
            if fp != self.fingerprint:
                self._index.clear()
                self._entries.clear()
                self._loaded_datasets.clear()
            self.params = params
            self.fingerprint = fp

    def prune(self) -> List[str]:
        """Delete on-disk versions whose fingerprint is not current.
        Returns the removed fingerprints.  Tolerates nested content
        inside version dirs and concurrent deletion."""
        removed = []
        with self._lock:
            try:
                datasets = os.listdir(self.root)
            except FileNotFoundError:
                return removed
            for dataset in datasets:
                dpath = os.path.join(self.root, dataset)
                if not os.path.isdir(dpath):
                    continue
                try:
                    versions = os.listdir(dpath)
                except FileNotFoundError:
                    continue            # dataset dir vanished under us
                for fp in versions:
                    if fp == self.fingerprint:
                        continue
                    vdir = os.path.join(dpath, fp)
                    if not os.path.isdir(vdir):
                        continue
                    shutil.rmtree(vdir, ignore_errors=True)
                    if not os.path.isdir(vdir):     # actually gone
                        removed.append(fp)
        return removed

    # -- budget / eviction ----------------------------------------------------

    def set_budget(self, budget: Optional[StoreBudget]) -> int:
        """Install (or clear) the budget and enforce it immediately.
        Returns the number of clips evicted by this call."""
        with self._lock:
            self.budget = budget
            self._m_budget_bytes.set(
                budget.max_bytes
                if budget is not None and budget.max_bytes is not None
                else 0)
            return self._enforce_budget()

    def disk_bytes(self) -> int:
        """Disk footprint of the current version's PRESENT clips, over
        every dataset directory under the root."""
        with self._lock:
            self._load_all_datasets()
            return sum(e["bytes"] for e in self._entries.values()
                       if e["present"])

    # holds-lock: _lock
    def _load_all_datasets(self) -> None:
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return
        for dataset in names:
            if os.path.isdir(os.path.join(self.root, dataset)):
                self._ensure_loaded(dataset)

    # holds-lock: _lock
    def _enforce_budget(self, protect: frozenset = frozenset()) -> int:
        """Evict TTL-expired then LRU clips (never ``protect``-ed ones)
        until the budget holds.  Caller must hold the lock."""
        if self.budget is None:
            return 0
        self._load_all_datasets()
        n0 = self.evictions
        now = time.time()
        dirty: Set[str] = set()
        def evictable(key, e):
            # an OPEN clip (live ingestion mid-stream) is never evicted:
            # its NPZ is the only copy of the stream's visible prefix,
            # and a transparent batch re-ingest would clobber the
            # append pipeline's tracker/index state
            wm = e.get("watermark")
            return key not in protect \
                and not (wm is not None and wm < key[3])

        if self.budget.ttl_seconds is not None:
            for key, e in list(self._entries.items()):
                if e["present"] and evictable(key, e) \
                        and now - e["last_used"] > self.budget.ttl_seconds:
                    self._evict(key)
                    dirty.add(key[0])
        if self.budget.max_bytes is not None:
            present = [(e["last_used"], key) for key, e
                       in self._entries.items() if e["present"]]
            total = sum(self._entries[k]["bytes"] for _, k in present)
            for _, key in sorted(present):      # oldest first
                if total <= self.budget.max_bytes:
                    break
                if not evictable(key, self._entries[key]):
                    continue
                total -= self._entries[key]["bytes"]
                self._evict(key)
                dirty.add(key[0])
        for dataset in dirty:
            self._flush_index(dataset)
        return self.evictions - n0

    # holds-lock: _lock
    def _evict(self, key: ClipKey) -> None:
        """Drop one clip's NPZ from memory and disk; its summary stays
        in the entry map (and index.json) for index-based skipping.
        Caller must hold the lock."""
        e = self._entries[key]
        try:
            os.remove(self._clip_path(key))
        except FileNotFoundError:
            pass                        # already gone (concurrent prune)
        e["present"] = False
        self._index.pop(key, None)
        self.evictions += 1
        self.evicted_bytes += e["bytes"]
        self._m_evictions.inc()
        self._m_evicted_bytes.inc(e["bytes"])

    # -- paths ----------------------------------------------------------------

    def _version_dir(self, dataset: str,
                     fingerprint: Optional[str] = None) -> str:
        # repro-lint: disable=lock-discipline -- unlocked callers (has/get) always pass an explicit fingerprint snapshot; the default-arg read is only reached under the lock
        fp = fingerprint or self.fingerprint
        return os.path.join(self.root, dataset, fp)

    def _clip_path(self, key: ClipKey,
                   fingerprint: Optional[str] = None) -> str:
        return os.path.join(self._version_dir(key[0], fingerprint),
                            _clip_name(key) + ".npz")

    # holds-lock: _lock
    def _write_meta(self, dataset: str) -> None:
        vdir = self._version_dir(dataset)
        os.makedirs(vdir, exist_ok=True)
        path = os.path.join(vdir, "meta.json")
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump({
                    "fingerprint": self.fingerprint,
                    "schema": SCHEMA_VERSION,
                    "params": self.params.describe(),
                    "theta": _track_fields(self.params),
                    "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
                }, f, indent=1, default=list)

    # -- index.json (per-version clip summaries) ------------------------------

    def _index_path(self, dataset: str) -> str:
        return os.path.join(self._version_dir(dataset), "index.json")

    # holds-lock: _lock
    def _ensure_loaded(self, dataset: str) -> None:
        """Populate ``_entries`` from the dataset's index.json (once per
        dataset per fingerprint).  Caller must hold the lock."""
        if dataset in self._loaded_datasets:
            return
        self._loaded_datasets.add(dataset)
        try:
            with open(self._index_path(dataset)) as f:
                doc = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return
        for name, e in doc.get("clips", {}).items():
            try:
                split, clip_id, n_frames = name.rsplit("_", 2)
                key = (dataset, split, int(clip_id), int(n_frames))
            except ValueError:
                continue
            if key in self._entries:
                # an in-memory entry (registered by get/materialize
                # before this dataset's first bulk load) is fresher
                # than the persisted one — clobbering it would reset
                # last_used and invert the LRU order
                continue
            wm = e.get("watermark")
            self._entries[key] = {
                "summary": ClipSummary.from_json(e["summary"]),
                "bytes": int(e["bytes"]),
                "last_used": float(e["last_used"]),
                "present": bool(e["present"]),
                "watermark": None if wm is None else int(wm),
            }

    # holds-lock: _lock
    def _flush_index(self, dataset: str) -> None:
        """Atomically rewrite the dataset's index.json from the entry
        map.  Caller must hold the lock."""
        vdir = self._version_dir(dataset)
        os.makedirs(vdir, exist_ok=True)
        doc = {
            "schema": SCHEMA_VERSION,
            "fingerprint": self.fingerprint,
            "buckets": list(MIN_LEN_BUCKETS),
            "clips": {
                _clip_name(k): {
                    "summary": e["summary"].to_json(),
                    "bytes": e["bytes"],
                    "last_used": e["last_used"],
                    "present": e["present"],
                    "watermark": e.get("watermark"),
                } for k, e in self._entries.items() if k[0] == dataset
            },
        }
        path = self._index_path(dataset)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)

    # holds-lock: _lock
    def _register(self, key: ClipKey, packed: PackedTracks,
                  path: str) -> None:
        """Record/refresh a clip's entry after load or materialize.
        Caller must hold the lock."""
        try:
            nbytes = os.path.getsize(path)
        except OSError:
            nbytes = int(packed.rows.nbytes + packed.offsets.nbytes)
        self._entries[key] = {
            "summary": packed.summary, "bytes": nbytes,
            "last_used": time.time(), "present": True,
            "watermark": packed.watermark,
        }

    # -- lookup ---------------------------------------------------------------

    def has(self, clip: Clip) -> bool:
        key = clip_key(clip)
        with self._lock:
            if key in self._index:
                return True
            fp = self.fingerprint        # snapshot: θ may swap under us
        return os.path.exists(self._clip_path(key, fp))

    def summary(self, clip: Clip) -> Optional[ClipSummary]:
        """The clip's index digest, available even when its NPZ has
        been evicted; None when the clip was never materialized for
        this θ."""
        key = clip_key(clip)
        with self._lock:
            self._ensure_loaded(key[0])
            e = self._entries.get(key)
            if e is not None:
                return e["summary"]
            hit = self._index.get(key)
            return hit.summary if hit is not None else None

    def _read_clip(self, path: str) -> PackedTracks:
        with np.load(path) as z:
            return PackedTracks(
                rows=z["rows"], offsets=z["offsets"],
                n_frames=int(z["info"][0]), fps=int(z["info"][1]),
                seconds=float(z["seconds"][0]),
                counters=tuple(int(v) for v in z["info"][2:]),
                hist=z["hist"] if "hist" in z.files else None,
                track_bbox=(z["track_bbox"]
                            if "track_bbox" in z.files else None),
                watermark=(int(z["watermark"][0])
                           if "watermark" in z.files else None))

    def get(self, clip: Clip) -> Optional[PackedTracks]:
        """The clip's packed tracks, loading from disk on first touch;
        None when the clip is cold (not materialized for this θ)."""
        key = clip_key(clip)
        with self._lock:
            hit = self._index.get(key)
            if hit is not None:
                e = self._entries.get(key)
                if e is not None:
                    e["last_used"] = time.time()
                return hit
            fp = self.fingerprint        # snapshot: θ may swap under us
        path = self._clip_path(key, fp)
        if not os.path.exists(path):
            return None
        try:
            packed = self._read_clip(path)
        except FileNotFoundError:
            return None                  # evicted between exists and load
        with self._lock:
            if self.fingerprint != fp:
                # θ swapped while we were reading: the data belongs to
                # the OLD version — caching it would serve stale-θ
                # tracks under the new fingerprint.  The clip is cold
                # for the current θ.
                return None
            self._register(key, packed, path)
            # racing loaders produce identical values; first write wins
            return self._index.setdefault(key, packed)

    def tracks(self, clip: Clip) -> List[np.ndarray]:
        """Convenience: the clip's tracks as the executor returned them
        (exact roundtrip through the packed arrays)."""
        packed = self.get(clip)
        if packed is None:
            raise KeyError(f"clip {clip_key(clip)} not materialized "
                           # repro-lint: disable=lock-discipline -- error-message snapshot; a torn θ read only mislabels the exception
                           f"for θ {self.fingerprint}")
        return packed.tracks()

    # -- ingest ---------------------------------------------------------------

    def materialize(self, clip: Clip, result: RunResult,
                    flush: bool = True) -> PackedTracks:
        """Pack one executor result and persist it (with its index).
        ``flush=False`` defers the index.json rewrite — batch callers
        (``ingest``) flush once per dataset at the end instead of
        re-serializing every summary after every clip."""
        return self.materialize_packed(
            clip, PackedTracks.pack(result.tracks, clip, result),
            flush=flush)

    def materialize_packed(self, clip: Clip, packed: PackedTracks,
                           flush: bool = True) -> PackedTracks:
        """Persist an already-packed clip (the stream path packs per
        watermark and attaches its incrementally merged index before
        landing here).  An open clip (``packed.watermark`` set below
        ``clip.n_frames``) gets the watermark persisted in the NPZ and
        the index entry; re-materializing the same key replaces the
        previous watermark's NPZ atomically, so a concurrent reader
        sees either the old prefix or the new one, never a tear."""
        key = clip_key(clip)
        packed.build_index_arrays()
        with self._lock:
            self._ensure_loaded(key[0])
            self._write_meta(key[0])
            path = self._clip_path(key)
            tmp = path + ".tmp.npz"
            info = np.asarray(
                [packed.n_frames, packed.fps, *packed.counters], np.int64)
            arrays = dict(rows=packed.rows, offsets=packed.offsets,
                          info=info,
                          seconds=np.asarray([packed.seconds],
                                             np.float64),
                          hist=packed.hist,
                          track_bbox=packed.track_bbox)
            if packed.watermark is not None:
                arrays["watermark"] = np.asarray([packed.watermark],
                                                 np.int64)
            np.savez(tmp, **arrays)
            os.replace(tmp, path)       # atomic: readers never see partials
            self._index[key] = packed
            self._register(key, packed, path)
            if flush:
                self._flush_index(key[0])
        return packed

    def watermark(self, clip: Clip) -> Optional[int]:
        """Frames ingested so far for an OPEN clip; ``clip.n_frames``
        once sealed (or batch-ingested); None when never materialized
        for this θ."""
        key = clip_key(clip)
        with self._lock:
            self._ensure_loaded(key[0])
            e = self._entries.get(key)
            if e is not None:
                wm = e.get("watermark")
                return key[3] if wm is None else wm
            hit = self._index.get(key)
            if hit is None:
                return None
            return key[3] if hit.watermark is None else hit.watermark

    def sidecar_path(self, clip: Clip, suffix: str) -> str:
        """Path for a per-clip sidecar file inside the current version
        directory (the stream subsystem persists tracker checkpoints as
        ``<clip>.<suffix>`` next to the clip NPZ)."""
        key = clip_key(clip)
        with self._lock:
            vdir = self._version_dir(key[0])
            os.makedirs(vdir, exist_ok=True)
        return os.path.join(vdir, _clip_name(key) + "." + suffix)

    def ingest(self, clips: Sequence[Clip],
               log=lambda *_: None) -> IngestReport:
        """Materialize every clip not yet in the current θ version.

        Cold clips stream through ``executor.run_clips`` — clip i+1's
        decode prefetches while clip i computes, chunks round-robin
        devices — warm clips cost one index lookup and zero model
        calls.  OPEN clips (live ingestion, ``repro_torch.stream``) count as
        cached: they are served at their current watermark and only
        their ``SegmentIngestor`` may extend them.  Budget enforcement
        runs after the batch lands (the batch itself is protected from
        its own ingest)."""
        report = IngestReport(requested=len(clips))
        cold = [c for c in clips if not self.has(c)]
        report.cached = len(clips) - len(cold)
        if cold:
            if self.bank is None:
                raise RuntimeError(
                    f"{len(cold)} cold clips but the store has no model "
                    f"bank to extract with")
            t0 = time.perf_counter()
            # repro-lint: disable=lock-discipline -- batch ingest runs against a stable θ snapshot; set_params mid-ingest is unsupported (the fingerprint check in get() rejects stale results)
            results, seconds = run_clips(self.bank, self.params, cold,
                                         self.options)
            for clip, res in zip(cold, results):
                self.materialize(clip, res, flush=False)
                report.frames += res.frames_processed
            report.ingested = len(cold)
            report.seconds = seconds
            report.wall_seconds = time.perf_counter() - t0
        with self._lock:
            for dataset in {clip_key(c)[0] for c in cold}:
                self._flush_index(dataset)      # once per dataset, not per clip
            self._load_all_datasets()
            bytes0 = self.evicted_bytes
            report.evicted = self._enforce_budget(
                protect=frozenset(clip_key(c) for c in clips))
            report.evicted_bytes = self.evicted_bytes - bytes0
            report.store_bytes = sum(
                e["bytes"] for e in self._entries.values() if e["present"])
            self._m_bytes.set(report.store_bytes)
        if report.ingested:
            log(f"[store] ingested {report.ingested} clips "
                f"({report.frames} frames, {report.fps:.1f} fps wall), "
                f"{report.cached} cached, {report.evicted} evicted")
        return report
