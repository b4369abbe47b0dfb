"""SLO engine: rolling-window quantiles + error budgets over the
metrics registry, with declarative alert rules firing structured
events.

The port of the JAX package's ``repro.obs.slo``
(``src/repro/obs/slo.py``), the same code over the port's ``REGISTRY``
and ``interp_quantile``: the same observations give the same edges and
the same quantiles bit for bit.

Everything here is PULL-based: ``SloEngine.tick()`` evaluates every
rule against the registry's current state and is invoked by whoever
wants fresh verdicts (the serving plane ticks on each ``/healthz`` and
``/snapshot`` request, a test or operator script ticks directly).  No
background thread, no cost while nobody asks — the same
zero-cost-when-idle contract the rest of the obs layer keeps.

A rule watches either

* a **histogram** — its retained observation window IS the rolling
  window (``stream.append.wall_seconds``, ``query.scan_seconds``), or
* a **gauge prefix** — per-instance gauges (``stream.
  watermark_lag_seconds[...]``) are sampled into the engine's own
  bounded deque on every tick, so the rolling window spans scrapes.

Per tick a rule computes its interpolated quantile and the fraction of
window observations over the objective ("bad fraction").  The error
budget is the allowed bad fraction: ``budget_remaining = 1 -
bad/budget`` (negative = budget blown).  State transitions fire
:class:`AlertEvent` s — ``warn`` when the quantile first exceeds the
objective, ``page`` when the budget is exhausted, ``resolved`` on
recovery — which land on the flight-recorder ring and bump the
``slo.alerts_fired`` counter.  Steady breaches do NOT re-fire: an
operator sees edges, not a firehose.

Rule names are part of the observable surface (the reference's obs
README tables them, ``src/repro/obs/README.md``), like span and metric
names.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from .metrics import REGISTRY, Registry, interp_quantile

__all__ = ["AlertRule", "AlertEvent", "SloEngine", "default_rules"]


@dataclass(frozen=True)
class AlertRule:
    """One declarative SLO: ``quantile`` of ``metric``'s rolling window
    must stay under ``objective``, with at most ``budget`` of the
    window's observations allowed over it.

    ``source`` is ``"histogram"`` (metric names a registry histogram)
    or ``"gauge"`` (metric is a gauge-name prefix; every matching
    per-instance gauge is sampled into a ``window``-bounded deque per
    tick)."""

    name: str
    metric: str
    objective: float
    quantile: float = 0.95
    budget: float = 0.02
    source: str = "histogram"
    window: int = 256
    min_samples: int = 4


@dataclass
class AlertEvent:
    """One structured alert edge (what the recorder ring stores)."""

    rule: str
    severity: str               # "warn" | "page" | "resolved"
    value: float                # the quantile that triggered the edge
    objective: float
    quantile: float
    bad_fraction: float
    budget_remaining: float
    at: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "value": self.value, "objective": self.objective,
                "quantile": self.quantile,
                "bad_fraction": self.bad_fraction,
                "budget_remaining": self.budget_remaining,
                "at": self.at}


def default_rules() -> List[AlertRule]:
    """The live path's three latency SLOs (objectives are deliberately
    loose defaults — a deployment tightens them per camera fleet)."""
    return [
        AlertRule("ingest_watermark_lag",
                  "stream.watermark_lag_seconds[", objective=5.0,
                  quantile=0.95, source="gauge"),
        AlertRule("append_latency", "stream.append.wall_seconds",
                  objective=2.0, quantile=0.95),
        AlertRule("query_latency", "query.scan_seconds",
                  objective=0.25, quantile=0.95),
    ]


class SloEngine:
    """Evaluates a rule set against a registry on demand (``tick``)."""

    def __init__(self, rules: Optional[List[AlertRule]] = None,
                 registry: Registry = REGISTRY, recorder=None,
                 history: int = 256):
        self.rules = list(rules) if rules is not None else default_rules()
        self.registry = registry
        self.recorder = recorder
        self._lock = threading.Lock()
        self._samples: Dict[str, Deque[float]] = {
            r.name: deque(maxlen=r.window) for r in self.rules
            if r.source == "gauge"}          # guarded-by: _lock
        self._state: Dict[str, str] = {}     # guarded-by: _lock
        self._last: Dict[str, dict] = {}     # guarded-by: _lock
        self._events: Deque[AlertEvent] = deque(maxlen=history)  # guarded-by: _lock
        self._fired = REGISTRY.counter("slo.alerts_fired")

    def _window_for(self, rule: AlertRule) -> List[float]:   # holds-lock: _lock
        if rule.source == "gauge":
            snap = self.registry.snapshot(prefix=rule.metric.rstrip("["))
            buf = self._samples[rule.name]
            for name, v in sorted(snap.items()):
                if isinstance(v, (int, float)):
                    buf.append(float(v))
            return list(buf)
        m = self.registry.get(rule.metric)
        return m.window() if m is not None and hasattr(m, "window") \
            else []

    def tick(self, now: Optional[float] = None) -> List[AlertEvent]:
        """Evaluate every rule; return (and record) the alert EDGES
        this tick produced."""
        now = time.time() if now is None else now
        fired: List[AlertEvent] = []
        with self._lock:
            for rule in self.rules:
                vals = sorted(self._window_for(rule))
                n = len(vals)
                if n < rule.min_samples:
                    self._last[rule.name] = {
                        "state": self._state.get(rule.name, "ok"),
                        "samples": n}
                    continue
                q = interp_quantile(vals, rule.quantile)
                bad = sum(1 for v in vals if v > rule.objective) / n
                remaining = 1.0 - (bad / rule.budget
                                   if rule.budget > 0 else float(bad > 0))
                if q <= rule.objective:
                    state = "ok"
                elif remaining <= 0.0:
                    state = "page"
                else:
                    state = "warn"
                prev = self._state.get(rule.name, "ok")
                if state != prev:
                    sev = state if state != "ok" else "resolved"
                    ev = AlertEvent(rule.name, sev, q, rule.objective,
                                    rule.quantile, bad, remaining,
                                    at=now)
                    fired.append(ev)
                    self._events.append(ev)
                self._state[rule.name] = state
                self._last[rule.name] = {
                    "state": state, "samples": n, "value": q,
                    "objective": rule.objective,
                    "bad_fraction": bad,
                    "budget_remaining": remaining}
        if fired:
            self._fired.inc(len(fired))
            rec = self.recorder
            if rec is not None:
                for ev in fired:
                    rec.record_alert(ev.to_dict())
        return fired

    def report(self) -> dict:
        """Per-rule verdicts from the LAST tick plus recent events
        (call ``tick()`` first for fresh numbers)."""
        with self._lock:
            return {
                "rules": {r.name: dict(self._last.get(r.name,
                                                      {"state": "ok",
                                                       "samples": 0}))
                          for r in self.rules},
                "events": [e.to_dict() for e in self._events],
            }

    def recent_events(self, n: int = 50) -> List[AlertEvent]:
        with self._lock:
            return list(self._events)[-n:]
