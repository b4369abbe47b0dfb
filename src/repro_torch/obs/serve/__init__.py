"""The telemetry serving plane's pure half: Prometheus exposition and
component health over a ``Registry.snapshot()`` dict.

The port of the JAX package's ``repro.obs.serve``
(``src/repro/obs/serve/``), without its HTTP server: ``render_prometheus``
(the ``/metrics`` text), ``CONTENT_TYPE``, and ``HealthComponent``,
``default_components`` and ``health_report`` (the ``/healthz``
document), each the reference's code.  Both are pure functions of one
snapshot, read nothing and start nothing.  ``ObsServer`` and ``route``
(a ``ThreadingHTTPServer`` on 127.0.0.1 mounting ``/metrics``,
``/healthz`` and ``/snapshot``) are not ported yet.
"""
from .exposition import CONTENT_TYPE, render_prometheus
from .health import HealthComponent, default_components, health_report

__all__ = ["render_prometheus", "CONTENT_TYPE", "HealthComponent",
           "default_components", "health_report"]
