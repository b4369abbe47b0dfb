"""Span tracing: one timeline for a multi-stream MultiScope run.

The port of the JAX package's ``repro.obs.trace``
(``src/repro/obs/trace.py``), the same code: spans, their names and
the exported records are the reference's, and the port emits every
name below from the same sites.

The tracer collects SPANS — named wall-clock intervals tagged with the
stream (clip) they belong to, the chunk index, the emitting thread and
an optional parent span — into a bounded ring buffer, and exports them
as JSON-lines (one span per line, greppable) or Chrome trace format
(load the file at ``chrome://tracing`` or https://ui.perfetto.dev to see
a 16-camera broker run as one timeline: per-stream lanes for the
DECODE/PROXY/DETECT/TRACK stages, broker lanes showing the consolidated
flushes every stream's windows rode).

The instrumentation contract (tested by tests/test_obs.py, and for the
port by tests/test_torch_obs.py, tests/test_torch_obs_hooks.py and
tests/test_torch_stream.py):

  * **disabled = free.**  ``TRACER.enabled`` is False by default and
    every instrumentation site guards with one attribute read + branch
    (``if TRACER.enabled:``); no span objects, no timestamps, no locks
    are taken on the hot path while disabled.
  * **enabled = observer only.**  Spans record timings and counters that
    the pipeline already computes (or that cost O(1) alongside them);
    tracing NEVER changes tracks, plans, dispatch counts or any other
    pipeline output (asserted bit-for-bit, tracing on vs off).
  * **bounded.**  The ring buffer holds ``capacity`` spans (default
    65536); older spans fall off the back.  An always-on stream can
    leave tracing enabled without growing memory per frame.

Span naming scheme (see src/repro/obs/README.md for the full table):

  ``run``                    one executor run (a clip, or one appended
                             segment of an open clip)
  ``stage.{decode,proxy,detect,track}``   one chunk through one stage
  ``broker.detect.flush``    one BatchBroker flush (its consolidated
                             dispatches are child spans)
  ``broker.detect.dispatch`` one consolidated detector call
  ``broker.track.flush`` / ``broker.track.dispatch``   TrackBroker twin
  ``stream.append``          one SegmentIngestor.append
  ``query.run``              one QueryService.query
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "TRACER", "enable", "disable", "enabled",
           "export_jsonl", "export_chrome"]


class Span:
    """One recorded interval.  ``ts``/``dur`` are perf_counter
    nanoseconds (monotone across threads); ``proc`` is thread-CPU
    nanoseconds actually spent; ``dur < 0`` marks a still-open span."""

    __slots__ = ("sid", "parent", "name", "cat", "ts", "dur", "proc",
                 "tid", "stream", "chunk", "args")

    def __init__(self, sid: int, parent: Optional[int], name: str,
                 cat: str, ts: int, dur: int, proc: int, tid: int,
                 stream: Optional[str], chunk: Optional[int],
                 args: Optional[dict]):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.cat = cat
        self.ts = ts
        self.dur = dur
        self.proc = proc
        self.tid = tid
        self.stream = stream
        self.chunk = chunk
        self.args = args

    def to_dict(self) -> dict:
        d = {"sid": self.sid, "name": self.name, "cat": self.cat,
             "ts_ns": self.ts, "dur_ns": self.dur, "proc_ns": self.proc,
             "tid": self.tid}
        if self.parent is not None:
            d["parent"] = self.parent
        if self.stream is not None:
            d["stream"] = self.stream
        if self.chunk is not None:
            d["chunk"] = self.chunk
        if self.args:
            d["args"] = self.args
        return d


class Tracer:
    """Thread-safe ring-buffer span collector.  One module-level
    instance (``TRACER``) is shared by every instrumentation site."""

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self._capacity = int(capacity)  # guarded-by: _lock
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self._capacity)  # guarded-by: _lock
        self._ids = itertools.count(1)
        self._tls = threading.local()

    # -- lifecycle ------------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> "Tracer":
        with self._lock:
            if capacity is not None and capacity != self._capacity:
                self._capacity = int(capacity)
                self._spans = deque(self._spans, maxlen=self._capacity)
            self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- recording ------------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[int]:
        """The calling thread's innermost open context-span id."""
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def emit(self, name: str, cat: str = "", *, ts: int, dur: int,
             proc: int = 0, stream: Optional[str] = None,
             chunk: Optional[int] = None, parent: Optional[int] = None,
             args: Optional[dict] = None) -> int:
        """Record one COMPLETE span whose interval the caller already
        measured (the hot-path form: the executor's stage wrapper and
        the broker flushes time themselves regardless of tracing).
        ``parent`` defaults to the calling thread's innermost open
        context span."""
        if parent is None:
            parent = self.current()
        sid = next(self._ids)
        span = Span(sid, parent, name, cat, int(ts), int(dur),
                    int(proc), threading.get_ident(), stream, chunk,
                    args)
        with self._lock:
            self._spans.append(span)
        return sid

    def open(self, name: str, cat: str = "", *,
             stream: Optional[str] = None, chunk: Optional[int] = None,
             parent: Optional[int] = None,
             args: Optional[dict] = None) -> Span:
        """Open a span now; close it later with ``close``.  Used for
        long-lived roots (one executor run) whose children are emitted
        from other threads against an explicit parent id."""
        if parent is None:
            parent = self.current()
        span = Span(next(self._ids), parent, name, cat,
                    time.perf_counter_ns(), -1, 0,
                    threading.get_ident(), stream, chunk, args)
        with self._lock:
            self._spans.append(span)
        return span

    def close(self, span: Span, args: Optional[dict] = None) -> None:
        span.dur = time.perf_counter_ns() - span.ts
        if args:
            span.args = {**(span.args or {}), **args}

    @contextmanager
    def span(self, name: str, cat: str = "", *,
             stream: Optional[str] = None, chunk: Optional[int] = None,
             args: Optional[dict] = None):
        """Context-manager span; nested spans on the same thread parent
        to it automatically.  Callers still guard with ``if
        TRACER.enabled:`` so the disabled path allocates nothing."""
        if not self.enabled:
            yield None
            return
        sp = self.open(name, cat, stream=stream, chunk=chunk, args=args)
        st = self._stack()
        st.append(sp.sid)
        c0 = time.thread_time_ns()
        try:
            yield sp
        finally:
            st.pop()
            sp.proc = time.thread_time_ns() - c0
            self.close(sp)

    # -- reading / export -----------------------------------------------------

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def export_jsonl(self, path: str) -> int:
        """One span per line (open spans exported with ``dur_ns=-1``).
        Returns the number of spans written."""
        spans = sorted(self.snapshot(), key=lambda s: s.ts)
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_dict()) + "\n")
        return len(spans)

    def export_chrome(self, path: str) -> int:
        """Chrome trace format (JSON array of events): one pid lane per
        stream (unattributed spans land on pid 0 "(shared)"), tid = the
        emitting thread, timestamps in microseconds sorted ascending.
        Open in chrome://tracing or Perfetto."""
        spans = sorted(self.snapshot(), key=lambda s: s.ts)
        pids: Dict[str, int] = {}
        events: List[dict] = []
        for s in spans:
            lane = s.stream if s.stream is not None else "(shared)"
            pid = pids.setdefault(lane, len(pids))
            args = dict(s.args or {})
            if s.chunk is not None:
                args["chunk"] = s.chunk
            if s.proc:
                args["thread_cpu_ms"] = round(s.proc / 1e6, 4)
            events.append({
                "name": s.name, "cat": s.cat or "span", "ph": "X",
                "ts": s.ts / 1e3, "dur": max(s.dur, 0) / 1e3,
                "pid": pid, "tid": s.tid, "args": args,
            })
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": lane}}
                for lane, pid in pids.items()]
        with open(path, "w") as f:
            json.dump(meta + events, f)
        return len(events)


TRACER = Tracer()


def enable(capacity: Optional[int] = None) -> Tracer:
    """Turn tracing on (module-level convenience)."""
    return TRACER.enable(capacity)


def disable() -> Tracer:
    return TRACER.disable()


def enabled() -> bool:
    return TRACER.enabled


def export_jsonl(path: str) -> int:
    return TRACER.export_jsonl(path)


def export_chrome(path: str) -> int:
    return TRACER.export_chrome(path)
