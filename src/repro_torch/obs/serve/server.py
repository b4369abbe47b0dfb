"""``ObsServer``: the background HTTP exporter.

The port of the JAX package's ``repro.obs.serve.server``
(``src/repro/obs/serve/server.py``), the same code over the port's
``Registry``, ``Tracer``, ``render_prometheus``, ``health_report`` and
``default_components``: one registry serves the same bytes from both
packages (tests/test_torch_obs_serve.py holds them side by side).

A stdlib ``ThreadingHTTPServer`` on a daemon thread serves the routes
registered in the module-level ``ROUTES`` table (the ``@route``
decorator — the table is the lintable endpoint surface).  Not calling
``start()`` costs nothing: no socket, no thread, no per-request work
ever runs.

Request handling only READS shared state — ``Registry.snapshot()``,
``health_report`` over it, an ``SloEngine.tick()`` (which samples
gauges and histogram windows), an optional ``FlightRecorder.poll()``
— so a scraper hammering ``/metrics`` during a 16-stream broker run
leaves tracks, dispatch counts, and the span ledger unchanged
(tests/test_torch_obs_serve.py; on the card, ``chip_smoke.run_served``).

Bind with ``port=0`` to take an ephemeral port (``.port`` reports the
bound one); the default bind address is loopback — this is an
operator surface, not a public one.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from ..metrics import REGISTRY, Registry
from ..trace import TRACER, Tracer
from .exposition import CONTENT_TYPE, render_prometheus
from .health import default_components, health_report

__all__ = ["ObsServer", "route", "ROUTES"]

# path -> handler(server) -> (status, content_type, body_bytes)
ROUTES: Dict[str, Callable[["ObsServer"], Tuple[int, str, bytes]]] = {}


def route(path: str):
    """Register a GET handler under ``path``.  Endpoint paths are part
    of the observable surface: the obs README's endpoint table and the
    ``obs-naming`` lint pass check them both directions."""
    def deco(fn):
        ROUTES[path] = fn
        return fn
    return deco


def _json_body(doc: dict) -> bytes:
    return (json.dumps(doc, indent=2, default=str) + "\n").encode()


@route("/metrics")
def _serve_metrics(server: "ObsServer") -> Tuple[int, str, bytes]:
    if server.recorder is not None:
        server.recorder.poll(server.tracer, server.registry)
    body = render_prometheus(server.registry.snapshot())
    return 200, CONTENT_TYPE, body.encode()


@route("/healthz")
def _serve_healthz(server: "ObsServer") -> Tuple[int, str, bytes]:
    if server.slo is not None:
        server.slo.tick()
    doc = health_report(server.registry.snapshot(), server.components)
    if server.slo is not None:
        doc["slo"] = server.slo.report()["rules"]
    status = 503 if doc["status"] == "fail" else 200
    return status, "application/json", _json_body(doc)


@route("/snapshot")
def _serve_snapshot(server: "ObsServer") -> Tuple[int, str, bytes]:
    if server.slo is not None:
        server.slo.tick()
    snap = server.registry.snapshot()
    doc = {
        "metrics": snap,
        "health": health_report(snap, server.components),
        "slo": server.slo.report() if server.slo is not None else None,
        "spans": len(server.tracer.snapshot())
        if server.tracer.enabled else 0,
        "serve": server.stats(),
    }
    return 200, "application/json", _json_body(doc)


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-obs"

    def do_GET(self) -> None:          # noqa: N802 (stdlib API name)
        c0 = time.thread_time()
        try:
            self._handle_get()
        finally:
            self.server.obs._account(time.thread_time() - c0)

    def _handle_get(self) -> None:
        path = self.path.split("?", 1)[0]
        fn = ROUTES.get(path)
        if fn is None:
            body = _json_body({"error": f"no route {path!r}",
                               "routes": sorted(ROUTES)})
            self._reply(404, "application/json", body)
            return
        try:
            status, ctype, body = fn(self.server.obs)
        except Exception as exc:      # a broken reader must not kill the thread
            body = _json_body({"error": f"{type(exc).__name__}: {exc}"})
            self._reply(500, "application/json", body)
            return
        self._reply(status, ctype, body)

    def _reply(self, status: int, ctype: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass                      # scraper went away mid-reply

    def log_message(self, fmt, *args) -> None:
        pass                          # scrapes must not spam stderr


class _Http(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    obs: "ObsServer"


class ObsServer:
    """The exporter: construct, ``start()``, scrape, ``stop()``.

    Optional collaborators: ``components`` (health thresholds;
    defaults to :func:`default_components`), ``slo`` (an ``SloEngine``
    ticked per health/snapshot request), ``recorder`` (a
    ``FlightRecorder`` polled per metrics scrape)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 registry: Registry = REGISTRY,
                 tracer: Tracer = TRACER,
                 components: Optional[list] = None,
                 slo=None, recorder=None):
        self.host = host
        self.requested_port = int(port)
        self.registry = registry
        self.tracer = tracer
        self.components = components if components is not None \
            else default_components()
        self.slo = slo
        self.recorder = recorder
        self._httpd: Optional[_Http] = None
        self._thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self._requests = 0               # guarded-by: _stats_lock
        self._handler_cpu = 0.0          # guarded-by: _stats_lock

    def _account(self, cpu: float) -> None:
        with self._stats_lock:
            self._requests += 1
            self._handler_cpu += cpu

    def stats(self) -> Dict[str, float]:
        """Self-accounting: requests served and the handler threads'
        own CPU seconds (``time.thread_time`` per request), i.e. what
        serving actually costs the process.  Benchmarks read this to
        bound exporter overhead directly instead of differencing two
        noisy end-to-end timings."""
        with self._stats_lock:
            return {"requests": self._requests,
                    "handler_cpu_seconds": round(self._handler_cpu, 6)}

    @property
    def port(self) -> int:
        if self._httpd is None:
            return self.requested_port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ObsServer":
        if self._httpd is not None:
            return self
        httpd = _Http((self.host, self.requested_port), _Handler)
        httpd.obs = self
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="repro-obs-serve")
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, th = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if th is not None:
            th.join(timeout=5.0)

    def __enter__(self) -> "ObsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
