"""Observability of the port: tracing spans, the metrics registry, the
crash flight recorder, the SLO engine and the serving plane's pure half.

The port of the JAX package's ``repro.obs`` (``src/repro/obs/``):
``obs.enable()`` to trace, ``obs.REGISTRY.snapshot()`` to read metrics,
``obs.recorder.install(FlightRecorder(root))`` for crash dumps.  The
executor, its brokers, its decode pool and the detector emit the
reference's spans and registry names.  The SLO engine (``obs.slo``) and
the serving plane (``obs.serve``: exposition, health and the
``ObsServer`` mounting ``/metrics``, ``/healthz`` and ``/snapshot``) load
lazily: importing ``repro_torch.obs`` on the hot path pays for neither.
``python -m repro_torch.obs`` is the operator command line (``scrape``,
``snapshot``, ``tail``, ``dump``, ``serve-smoke``).
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
    "serve", "slo",
]

_LAZY_SUBMODULES = ("serve", "slo")


def __getattr__(name: str):
    if name in _LAZY_SUBMODULES:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")
