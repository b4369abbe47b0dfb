"""Metrics: one namespaced counter/gauge/histogram registry for the
whole pipeline, plus the shared stage-timing assembly and the
per-watermark drift monitors.

The port of the JAX package's ``repro.obs.metrics``
(``src/repro/obs/metrics.py``), the same code: every name below is in
the port's registry under the reference's name (``RunProfile.publish``
folds each executor run in from ``ClipExecutor.finish``).

Before this module each subsystem grew its own ad-hoc counters —
``Detector.dispatches``, the executor's ``stage_seconds`` dicts, the
standing queries' ``rows_scanned``, the store's eviction totals — with
no way to read them in one place or compare them across runs.  The
registry is the aggregate source of truth: instrumented sites keep
their per-instance attributes (tests and benchmarks assert against
those, bit-compatible) AND fold every increment into a namespaced
registry metric, so ``REGISTRY.snapshot()`` is the whole system's
state in one dict.

Naming scheme (full table in src/repro/obs/README.md):

  ``executor.dispatch.{proxy,detect,track}``   device dispatches
  ``executor.stage.{name}.{wall,process}_seconds``   stage histograms
  ``detector.dispatches``                      every detect_batch call
  ``broker.{detect,track}.{dispatches,units_in}``  consolidated calls
  ``broker.{detect,track}.fill``               per-flush occupancy
  ``stream.append.{wall,store,standing}_seconds``  live-path latencies
  ``stream.watermark_lag_seconds``             store-landing lag
  ``stream.watermark[{dataset}/{clip}]``       per-clip gauges
  ``query.{scan,ingest}_seconds``              per-query split
  ``query.clips.{scanned,skipped,indexed}``    plan-phase counters
  ``standing.rows_{scanned,skipped}``          delta-fold exactness
  ``store.{evictions,evicted_bytes}``          budget enforcement

Counters and gauges are always on (one lock + int per event, far off
any per-frame path); histograms retain a bounded window.  ``reset()``
zeroes values IN PLACE so call sites may cache metric objects at import
time.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, List, Mapping, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "Provider", "Registry",
           "REGISTRY", "RunProfile", "DriftMonitor", "stage_block",
           "merge_stage_blocks", "assert_stage_sane", "interp_quantile",
           "drift_enabled", "enable_drift", "disable_drift"]

# wall and thread-CPU clocks have independent resolutions; a stage sum
# may lag its wall sum by at most this before assert_stage_sane trips
_CLOCK_SLACK = 2e-3


class Counter:
    """Monotone (but settable, for bench resets) integer metric."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0                     # guarded-by: _lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, v: int) -> None:
        with self._lock:
            self._value = int(v)

    def reset(self) -> None:
        self.set(0)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins float metric (queue depths, watermark lag)."""

    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def reset(self) -> None:
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


def interp_quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Linearly interpolated quantile over an already-sorted sequence
    (the PR-4 ``latency_report`` convention: an even-length list's
    median averages the two middle values rather than reporting the
    upper one).  Shared by ``Histogram.summary`` and the SLO engine."""
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class Histogram:
    """Running count/sum/min/max plus a bounded window of recent
    observations for percentile summaries.  ``summary()`` quantiles are
    computed over the retained window (default 4096 samples)."""

    __slots__ = ("_lock", "count", "total", "min", "max", "_window")

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self.count = 0                      # guarded-by: _lock
        self.total = 0.0                    # guarded-by: _lock
        self.min = math.inf                 # guarded-by: _lock
        self.max = -math.inf                # guarded-by: _lock
        self._window: deque = deque(maxlen=window)  # guarded-by: _lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._window.append(v)

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = math.inf
            self.max = -math.inf
            self._window.clear()

    def window(self) -> List[float]:
        """Copy of the retained observation window (newest last) — the
        SLO engine's rolling-quantile input."""
        with self._lock:
            return list(self._window)

    def summary(self) -> dict:
        # min/max (and everything else) are read under the lock: a
        # concurrent observe() between unlocked reads could report a
        # max from a sample the count does not include (the PR-9 race)
        with self._lock:
            count, total = self.count, self.total
            vmin, vmax = self.min, self.max
            vals = sorted(self._window)
        if not count:
            return {"count": 0}
        return {
            "count": count,
            "mean": total / count,
            "min": vmin,
            "max": vmax,
            "p50": interp_quantile(vals, 0.50),
            "p95": interp_quantile(vals, 0.95),
            "p99": interp_quantile(vals, 0.99),
        }

    @property
    def value(self) -> dict:
        return self.summary()


class Provider:
    """Callable-backed read-only metric: ``value`` invokes the
    registered callable at snapshot time (DriftMonitor summaries ride
    the registry this way — nothing is copied per append, the snapshot
    reads the live monitor).  ``reset()`` is a no-op: the provider's
    source owns its state.  A failing callable yields ``None`` rather
    than breaking ``snapshot()``."""

    __slots__ = ("_fn",)

    def __init__(self):
        self._fn = None

    def set_fn(self, fn) -> None:
        self._fn = fn

    def reset(self) -> None:
        pass

    @property
    def value(self):
        fn = self._fn
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            return None


class Registry:
    """Name -> metric.  ``counter``/``gauge``/``histogram`` create on
    first use and return the same object thereafter (a name keeps its
    kind: asking for a different kind under the same name raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}   # guarded-by: _lock

    def _get(self, name: str, kind, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(**kw)
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} is {type(m).__name__}, "
                    f"not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get(name, Histogram, window=window)

    def provider(self, name: str, fn) -> Provider:
        """Register (or re-point) a callable-backed metric: its current
        return value appears under ``name`` in ``snapshot()``.  Last
        registration wins — a re-opened stream's fresh DriftMonitor
        replaces the sealed one's under the same instance label."""
        p = self._get(name, Provider)
        p.set_fn(fn)
        return p

    def get(self, name: str):
        """The live metric object registered under ``name`` (None when
        absent) — lets readers reach ``Histogram.window()`` without
        touching registry internals."""
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self, prefix: str = "") -> dict:
        """{name: value} for counters/gauges, {name: summary dict} for
        histograms; optionally filtered by name prefix."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.value for name, m in items
                if name.startswith(prefix)}

    def reset(self, prefix: str = "") -> None:
        """Zero matching metrics IN PLACE (cached references stay
        valid)."""
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if name.startswith(prefix):
                m.reset()


REGISTRY = Registry()

# drift collection costs a little numpy per PROXY chunk (per-frame
# positive-cell fractions), so it is opt-in like tracing
_DRIFT_ENABLED = False


def enable_drift() -> None:
    global _DRIFT_ENABLED
    _DRIFT_ENABLED = True


def disable_drift() -> None:
    global _DRIFT_ENABLED
    _DRIFT_ENABLED = False


def drift_enabled() -> bool:
    return _DRIFT_ENABLED


# ---------------------------------------------------------------------------
# Stage-timing assembly — the ONE place RunResult/AppendReport blocks
# are built and folded (executor.finish builds, the benches merge)
# ---------------------------------------------------------------------------

def stage_block(wall: Mapping[str, float],
                proc: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    """Assemble the ``stage_seconds`` block carried by ``RunResult`` and
    ``AppendReport``: stage -> {"wall": s, "process": s}."""
    return {s: {"wall": float(wall[s]), "process": float(proc.get(s, 0.0))}
            for s in wall}


def empty_stage_block(stages: Sequence[str]) -> Dict[str, Dict[str, float]]:
    return {s: {"wall": 0.0, "process": 0.0} for s in stages}


def merge_stage_blocks(blocks) -> Dict[str, Dict[str, float]]:
    """Sum any iterable of ``stage_seconds`` blocks (None entries are
    skipped) — the aggregation the benches previously hand-rolled."""
    out: Dict[str, Dict[str, float]] = {}
    for block in blocks:
        if not block:
            continue
        for st, d in block.items():
            e = out.setdefault(st, {"wall": 0.0, "process": 0.0})
            e["wall"] += d.get("wall", 0.0)
            e["process"] += d.get("process", 0.0)
    return out


def assert_stage_sane(block: Optional[Mapping[str, Mapping[str, float]]],
                      slack: float = _CLOCK_SLACK) -> None:
    """Per stage, thread-CPU seconds can never exceed wall seconds
    (each stage call's CPU is measured on the thread that ran it over
    the same interval as its wall clock) — a violation means the
    assembly double-counted.  ``slack`` absorbs clock resolution."""
    for st, d in (block or {}).items():
        wall, proc = d.get("wall", 0.0), d.get("process", 0.0)
        assert wall + slack >= proc, \
            f"stage {st!r}: process {proc:.4f}s exceeds wall " \
            f"{wall:.4f}s — stage timing was double-counted"
        assert wall >= 0.0 and proc >= 0.0, (st, d)


class RunProfile:
    """Per-run stage wall/CPU seconds + dispatch counters.  Thread-safe:
    decode runs on a worker thread while the other stages run on the
    draining thread."""

    __slots__ = ("_lock", "wall", "proc", "disp")

    def __init__(self, stages: Sequence[str]):
        self._lock = threading.Lock()
        self.wall = {s: 0.0 for s in stages}    # guarded-by: _lock
        self.proc = {s: 0.0 for s in stages}    # guarded-by: _lock
        self.disp: Dict[str, int] = {}          # guarded-by: _lock

    def note_stage(self, name: str, wall: float, proc: float) -> None:
        with self._lock:
            self.wall[name] += wall
            self.proc[name] += proc

    def dispatch(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.disp[name] = self.disp.get(name, 0) + n

    def dispatches(self, name: str) -> int:
        with self._lock:
            return self.disp.get(name, 0)

    def stage_seconds(self) -> Dict[str, Dict[str, float]]:
        """stage -> {"wall": s, "process": s}."""
        with self._lock:
            return stage_block(self.wall, self.proc)

    def publish(self, registry: Registry = REGISTRY,
                prefix: str = "executor") -> None:
        """Fold this run's totals into the registry (called once per run
        by ``ClipExecutor.finish``): each stage's wall and thread-CPU
        seconds into ``{prefix}.stage.{st}.{wall,process}_seconds``
        histograms, each dispatch count into ``{prefix}.dispatch.{name}``
        counters."""
        with self._lock:
            wall, proc = dict(self.wall), dict(self.proc)
            disp = dict(self.disp)
        for st in wall:
            registry.histogram(
                f"{prefix}.stage.{st}.wall_seconds").observe(wall[st])
            registry.histogram(
                f"{prefix}.stage.{st}.process_seconds").observe(proc[st])
        for name, n in disp.items():
            registry.counter(f"{prefix}.dispatch.{name}").inc(n)


# ---------------------------------------------------------------------------
# Drift monitors (per-watermark, per-stream) — the future online
# tuner's input: has the content this θ was tuned for moved?
# ---------------------------------------------------------------------------

class DriftMonitor:
    """Per-watermark proxy-score and track-count distributions with a
    current-vs-trailing-window delta.

    Every ``observe`` records one watermark's mean proxy positive-cell
    fraction (how much of the frame the proxy wants detected — the
    paper's θ sweeps move exactly this) and the visible track count.
    ``summary()`` reports histograms over the retained window plus, for
    each quantity, the mean over the most recent ``window`` watermarks
    minus the mean over the ``trailing`` watermarks before them — a
    persistent non-zero delta is content drift, the signal Chameleon
    re-tunes on."""

    def __init__(self, window: int = 8, trailing: int = 32,
                 proxy_bins: int = 10):
        self.window = max(1, int(window))
        self.trailing = max(1, int(trailing))
        self.proxy_bins = int(proxy_bins)
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._entries: deque = deque(maxlen=self.window + self.trailing)

    def observe(self, watermark: int,
                proxy_fracs: Optional[Sequence[float]] = None,
                track_count: Optional[int] = None) -> None:
        pf = None
        if proxy_fracs is not None and len(proxy_fracs):
            pf = float(sum(proxy_fracs) / len(proxy_fracs))
        with self._lock:
            self._entries.append((int(watermark), pf, track_count))

    def _delta(self, vals: List[float]) -> dict:
        cur = vals[-self.window:]
        trail = vals[:-self.window][-self.trailing:]
        out = {"mean": sum(vals) / len(vals),
               "current_mean": sum(cur) / len(cur)}
        if trail:
            tm = sum(trail) / len(trail)
            out["trailing_mean"] = tm
            out["delta"] = out["current_mean"] - tm
        return out

    def _hist(self, vals: List[float], lo: float, hi: float,
              bins: int) -> List[int]:
        counts = [0] * bins
        width = (hi - lo) / bins if hi > lo else 1.0
        for v in vals:
            counts[min(bins - 1, max(0, int((v - lo) / width)))] += 1
        return counts

    def summary(self) -> dict:
        with self._lock:
            entries = list(self._entries)
        if not entries:
            return {"watermarks": 0}
        out: dict = {"watermarks": len(entries),
                     "last_watermark": entries[-1][0]}
        proxy = [e[1] for e in entries if e[1] is not None]
        tracks = [float(e[2]) for e in entries if e[2] is not None]
        if proxy:
            out["proxy_score"] = self._delta(proxy)
            out["proxy_score"]["hist"] = self._hist(
                proxy, 0.0, 1.0, self.proxy_bins)
        if tracks:
            out["track_count"] = self._delta(tracks)
            hi = max(tracks) + 1.0
            out["track_count"]["hist"] = self._hist(
                tracks, 0.0, hi, min(10, int(hi)))
        return out

    def drifted(self, proxy_tol: float = 0.1,
                tracks_tol: float = 2.0) -> bool:
        """True when either distribution's current-window mean moved
        beyond tolerance vs the trailing window."""
        s = self.summary()
        p = abs(s.get("proxy_score", {}).get("delta", 0.0))
        t = abs(s.get("track_count", {}).get("delta", 0.0))
        return p > proxy_tol or t > tracks_tol
