"""Component health, derived from registry gauges via declarative
thresholds — the ``/healthz`` payload.

The port of the JAX package's ``repro.obs.serve.health``
(``src/repro/obs/serve/health.py``), the same code: one snapshot dict
grades to the same statuses in both packages.  The stock components
read the gauges the port's ``DecodePool`` and brokers set.

A :class:`HealthComponent` names one subsystem and the gauge (or
per-instance gauge prefix, trailing ``[``) whose current value grades
it: ``ok`` below ``warn``, ``warn`` at or above it, ``fail`` at or
above ``fail``.  ``ratio_of`` divides the watched gauge by a second
gauge first (store bytes over budget bytes).  A component whose gauge
was never registered reports ``ok`` with ``"value": None`` — a
subsystem that is not running is not unhealthy, it is absent (the
decode pool only exists in pooled runs, brokers only in broker runs).

The overall status is the worst component's; an HTTP layer maps
``ok``/``warn`` to 200 and ``fail`` to 503 so a load balancer can act
on the grade without parsing the body.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["HealthComponent", "default_components", "health_report"]

_ORDER = {"ok": 0, "warn": 1, "fail": 2}


@dataclass(frozen=True)
class HealthComponent:
    """One graded subsystem: ``metric`` (gauge name, or prefix ending
    in ``[`` meaning "worst instance") against warn/fail thresholds."""

    name: str
    metric: str
    warn: float
    fail: float
    description: str = ""
    ratio_of: Optional[str] = None


def default_components() -> List[HealthComponent]:
    """The serving plane's stock component set — every live-path
    backpressure signal the registry already carries."""
    return [
        HealthComponent(
            "decode_pool", metric="executor.decode.queue_depth",
            warn=64.0, fail=512.0,
            description="undecoded chunks queued on the shared "
                        "DecodePool"),
        HealthComponent(
            "broker_detect", metric="broker.detect.queue_depth",
            warn=64.0, fail=512.0,
            description="detector windows waiting for a BatchBroker "
                        "flush"),
        HealthComponent(
            "broker_track", metric="broker.track.queue_depth",
            warn=64.0, fail=512.0,
            description="tracker steps waiting for a TrackBroker "
                        "flush"),
        HealthComponent(
            "ingest_lag", metric="stream.watermark_lag_seconds[",
            warn=5.0, fail=30.0,
            description="slowest stream's append wall time behind its "
                        "watermark"),
        HealthComponent(
            "store_budget", metric="store.bytes",
            ratio_of="store.budget_bytes", warn=0.9, fail=1.0,
            description="TrackStore disk footprint over its eviction "
                        "budget"),
    ]


def _value_for(component: HealthComponent,
               snapshot: Dict[str, object]) -> Optional[float]:
    metric = component.metric
    if metric.endswith("["):
        vals = [float(v) for name, v in snapshot.items()
                if name.startswith(metric[:-1] + "[")
                and isinstance(v, (int, float))]
        value = max(vals) if vals else None
    else:
        v = snapshot.get(metric)
        value = float(v) if isinstance(v, (int, float)) else None
    if value is None:
        return None
    if component.ratio_of is not None:
        denom = snapshot.get(component.ratio_of)
        if not isinstance(denom, (int, float)) or denom <= 0:
            return None
        value /= float(denom)
    return value


def health_report(snapshot: Dict[str, object],
                  components: Optional[List[HealthComponent]] = None
                  ) -> dict:
    """Grade every component against one registry snapshot.  Returns
    the ``/healthz`` document: ``{"status", "time", "components":
    {name: {"status", "value", "warn", "fail", "metric",
    "description"}}}``."""
    comps = components if components is not None \
        else default_components()
    out: Dict[str, dict] = {}
    worst = "ok"
    for c in comps:
        value = _value_for(c, snapshot)
        if value is None:
            status = "ok"
        elif value >= c.fail:
            status = "fail"
        elif value >= c.warn:
            status = "warn"
        else:
            status = "ok"
        if _ORDER[status] > _ORDER[worst]:
            worst = status
        out[c.name] = {"status": status, "value": value,
                       "warn": c.warn, "fail": c.fail,
                       "metric": c.metric,
                       "description": c.description}
    return {"status": worst, "time": time.time(), "components": out}
