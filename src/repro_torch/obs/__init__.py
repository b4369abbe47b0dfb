"""Observability of the port: tracing spans, the metrics registry and
the crash flight recorder.

The port of the JAX package's ``repro.obs`` (``src/repro/obs/``):
``obs.enable()`` to trace, ``obs.REGISTRY.snapshot()`` to read metrics,
``obs.recorder.install(FlightRecorder(root))`` for crash dumps.  The
serving plane (``obs.serve``), the SLO engine (``obs.slo``) and the
command line (``obs.__main__``) are not ported yet.
"""
from .trace import (Span, Tracer, TRACER, enable, disable, enabled,
                    export_jsonl, export_chrome)
from .metrics import (Counter, Gauge, Histogram, Provider, Registry, REGISTRY,
                      RunProfile, DriftMonitor, stage_block, empty_stage_block,
                      merge_stage_blocks, assert_stage_sane, interp_quantile,
                      drift_enabled, enable_drift, disable_drift)
from . import recorder

__all__ = [
    "Span", "Tracer", "TRACER", "enable", "disable", "enabled",
    "export_jsonl", "export_chrome",
    "Counter", "Gauge", "Histogram", "Provider", "Registry", "REGISTRY",
    "RunProfile", "DriftMonitor", "stage_block", "empty_stage_block",
    "merge_stage_blocks", "assert_stage_sane", "interp_quantile",
    "drift_enabled", "enable_drift", "disable_drift", "recorder",
]
