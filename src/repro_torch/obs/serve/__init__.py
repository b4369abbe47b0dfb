"""The telemetry serving plane: an HTTP surface over ``obs.REGISTRY``.

The port of the JAX package's ``repro.obs.serve``
(``src/repro/obs/serve/``), each module the reference's code:
``render_prometheus`` (the ``/metrics`` text) and ``CONTENT_TYPE``;
``HealthComponent``, ``default_components`` and ``health_report`` (the
``/healthz`` document), pure functions of one snapshot; and ``ObsServer``
with ``route`` / ``ROUTES``, a background ``ThreadingHTTPServer`` on
127.0.0.1 mounting ``/metrics``, ``/healthz`` (503 on ``fail``) and
``/snapshot``.  Serving is strictly pull: nothing runs, allocates or
locks until ``start()`` and a request, and a scraper only reads.
"""
from .exposition import CONTENT_TYPE, render_prometheus
from .health import HealthComponent, default_components, health_report
from .server import ROUTES, ObsServer, route

__all__ = ["ObsServer", "route", "ROUTES", "render_prometheus",
           "CONTENT_TYPE", "HealthComponent", "default_components",
           "health_report"]
