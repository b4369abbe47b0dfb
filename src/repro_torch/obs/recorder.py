"""Flight recorder: a bounded on-disk JSONL ring plus a crash black
box.

The port of the JAX package's ``repro.obs.recorder``
(``src/repro/obs/recorder.py``), the same code; the port's live path
calls ``crash_dump`` from ``SegmentIngestor.append`` and
``QueryService.query``, not yet from ``ClipExecutor.finish``.

The ring (``ring-NNNNNN.jsonl`` segment files under one directory,
oldest segment deleted when the segment cap is hit) holds whatever the
serving plane feeds it — closed spans, metric deltas between scrapes,
fired alert events — so an operator can reconstruct the minutes before
an incident without having had tracing exporters wired up in advance.

``dump()`` is the black box: on an executor/ingestor/query exception it
writes ``dump-NNNNNN.json`` with the failing span's lineage (the open
span stack of the crashing thread, walked parent-by-parent), the last
``span_tail`` closed spans, a full registry snapshot, the traceback,
and — on the ingest path — the tracker-checkpoint sidecar path an
operator resumes from.  The SAME exception propagating through nested
hooks (ingestor append -> executor finish) produces ONE dump: the
first hook writes it, later hooks merge their context into it.

Hooks call the module-level :func:`crash_dump`, which is a no-op until
:func:`install` has attached a recorder — failure paths stay free for
every program that never asked for a black box, and a broken recorder
never turns a pipeline crash into a different crash (every disk error
is swallowed).
"""
from __future__ import annotations

import json
import os
import threading
import time
import traceback
from typing import Dict, List, Optional

from .metrics import REGISTRY, Registry
from .trace import TRACER, Tracer

__all__ = ["FlightRecorder", "install", "uninstall", "active",
           "crash_dump"]

_RING_PREFIX = "ring-"
_DUMP_PREFIX = "dump-"


class FlightRecorder:
    """Bounded JSONL ring + crash dumps under one directory.

    ``segment_records`` caps records per ring segment file and
    ``segments`` caps the number of segment files kept, so the ring's
    disk footprint is bounded no matter how long the fleet runs.
    ``span_tail`` is how many recent closed spans a crash dump
    carries."""

    def __init__(self, root: str, segment_records: int = 2048,
                 segments: int = 4, span_tail: int = 128):
        self.root = root
        self.segment_records = max(1, int(segment_records))
        self.segments = max(1, int(segments))
        self.span_tail = max(1, int(span_tail))
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        existing = self._ring_files()
        self._seg = (int(existing[-1][len(_RING_PREFIX):-6]) + 1
                     if existing else 0)     # guarded-by: _lock
        self._seg_count = 0                  # guarded-by: _lock
        self._last_sid = 0                   # guarded-by: _lock
        self._last_values: Dict[str, object] = {}   # guarded-by: _lock
        self._dump_n = 0                     # guarded-by: _lock
        self._dumped: Dict[int, str] = {}    # guarded-by: _lock

    # -- ring -----------------------------------------------------------------

    def _ring_files(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        return sorted(n for n in names if n.startswith(_RING_PREFIX)
                      and n.endswith(".jsonl"))

    # holds-lock: _lock
    def _write(self, rec: dict) -> None:
        if self._seg_count >= self.segment_records:
            self._seg += 1
            self._seg_count = 0
        path = os.path.join(self.root,
                            f"{_RING_PREFIX}{self._seg:06d}.jsonl")
        if self._seg_count == 0:
            for stale in self._ring_files()[:-(self.segments - 1) or None]:
                if stale != os.path.basename(path):
                    try:
                        os.remove(os.path.join(self.root, stale))
                    except OSError:
                        pass
        with open(path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")
        self._seg_count += 1

    def record(self, kind: str, **payload) -> None:
        """Append one ring record: ``{"kind": ..., "t": ..., **payload}``."""
        rec = {"kind": kind, "t": time.time(), **payload}
        with self._lock:
            self._write(rec)

    def poll(self, tracer: Tracer = TRACER,
             registry: Registry = REGISTRY) -> Dict[str, int]:
        """Fold the system's new state into the ring: closed spans the
        ring has not seen yet, plus deltas of every numeric metric
        since the previous poll.  Called per ``/metrics`` scrape."""
        spans = [s for s in tracer.snapshot()
                 if s.dur >= 0]
        snap = registry.snapshot()
        with self._lock:
            fresh = [s for s in spans if s.sid > self._last_sid]
            if fresh:
                self._last_sid = max(s.sid for s in fresh)
            for s in fresh:
                self._write({"kind": "span", "t": s.ts, **s.to_dict()})
            delta = {}
            for name, v in snap.items():
                if not isinstance(v, (int, float)):
                    continue
                prev = self._last_values.get(name)
                if v != prev:
                    delta[name] = v
                    self._last_values[name] = v
            if delta:
                self._write({"kind": "metrics", "t": time.time(),
                             "delta": delta})
        return {"spans": len(fresh), "metrics": len(delta)}

    def record_alert(self, event: dict) -> None:
        self.record("alert", **event)

    def tail(self, n: int = 50) -> List[dict]:
        """The last ``n`` ring records, oldest first."""
        out: List[dict] = []
        with self._lock:
            files = self._ring_files()
        for name in reversed(files):
            if len(out) >= n:
                break
            try:
                with open(os.path.join(self.root, name)) as f:
                    lines = f.readlines()
            except OSError:
                continue
            recs = []
            for line in lines:
                try:
                    recs.append(json.loads(line))
                except ValueError:
                    pass
            out = recs[-(n - len(out)):] + out
        return out[-n:]

    # -- the black box --------------------------------------------------------

    def _lineage(self, tracer: Tracer) -> List[dict]:
        """The failing span's ancestry, innermost first.

        Crash hooks run in ``except`` clauses — by then the failing
        span's context manager may already have popped it off the
        thread stack and closed it.  Starting from the innermost span
        still open (``tracer.current()``), descend the crashing
        thread's newest-child chain to recover the failing span, then
        walk parent-by-parent back to the root."""
        spans = {s.sid: s for s in tracer.snapshot()}
        tid = threading.get_ident()
        sid = tracer.current()
        while True:
            child = max((s for s in spans.values()
                         if s.tid == tid and s.parent == sid),
                        key=lambda s: s.sid, default=None)
            if child is None:
                break
            sid = child.sid
        chain: List[dict] = []
        while sid is not None and sid in spans:
            s = spans[sid]
            chain.append(s.to_dict())
            sid = s.parent
        return chain

    def dump(self, reason: str, exc: Optional[BaseException] = None,
             checkpoint: Optional[str] = None,
             extra: Optional[dict] = None,
             tracer: Tracer = TRACER,
             registry: Registry = REGISTRY) -> str:
        """Write (or enrich) a crash dump and return its path.

        Dedupe: the same exception OBJECT seen again (an inner hook's
        dump propagating through an outer hook) merges the new
        reason/checkpoint/extra into the existing file instead of
        writing a second dump."""
        closed = [s.to_dict() for s in tracer.snapshot()
                  if s.dur >= 0][-self.span_tail:]
        lineage = self._lineage(tracer)
        err = None
        if exc is not None:
            err = {"type": type(exc).__name__, "message": str(exc),
                   "traceback": "".join(traceback.format_exception(
                       type(exc), exc, exc.__traceback__))}
        with self._lock:
            prior = self._dumped.get(id(exc)) if exc is not None else None
            if prior is not None and os.path.exists(prior):
                try:
                    with open(prior) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    doc = {}
                doc.setdefault("reasons", [doc.get("reason")])
                doc["reasons"].append(reason)
                if checkpoint is not None:
                    doc["checkpoint"] = checkpoint
                if extra:
                    doc.setdefault("extra", {}).update(extra)
                if not doc.get("lineage") and lineage:
                    doc["lineage"] = lineage
                with open(prior, "w") as f:
                    json.dump(doc, f, indent=2, default=str)
                return prior
            path = os.path.join(
                self.root, f"{_DUMP_PREFIX}{self._dump_n:06d}.json")
            self._dump_n += 1
            if exc is not None:
                self._dumped[id(exc)] = path
            doc = {"reason": reason, "t": time.time(), "error": err,
                   "lineage": lineage, "spans": closed,
                   "metrics": registry.snapshot(),
                   "checkpoint": checkpoint, "extra": extra or {}}
            with open(path, "w") as f:
                json.dump(doc, f, indent=2, default=str)
            self._write({"kind": "dump", "t": time.time(),
                         "reason": reason, "path": path})
        return path

    def dumps(self) -> List[str]:
        """Paths of every crash dump written so far, oldest first."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        return [os.path.join(self.root, n) for n in sorted(names)
                if n.startswith(_DUMP_PREFIX) and n.endswith(".json")]


# ---------------------------------------------------------------------------
# Module-level black-box hook surface: failure paths call crash_dump()
# unconditionally; it costs one global read until install() is called.
# ---------------------------------------------------------------------------

_RECORDER: Optional[FlightRecorder] = None


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Attach the process-wide flight recorder (crash hooks activate)."""
    global _RECORDER
    _RECORDER = recorder
    return recorder


def uninstall() -> None:
    global _RECORDER
    _RECORDER = None


def active() -> Optional[FlightRecorder]:
    return _RECORDER


def crash_dump(reason: str, exc: Optional[BaseException] = None,
               checkpoint: Optional[str] = None,
               extra: Optional[dict] = None) -> Optional[str]:
    """Black-box entry point for executor/ingestor/query failure paths:
    no recorder installed -> None; a recorder that itself fails ->
    None (the original exception keeps propagating untouched)."""
    rec = _RECORDER
    if rec is None:
        return None
    try:
        return rec.dump(reason, exc, checkpoint=checkpoint, extra=extra)
    except Exception:
        return None
