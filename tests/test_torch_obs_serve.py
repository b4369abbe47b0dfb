"""The port's telemetry serving plane over HTTP (``repro_torch.obs.serve``:
``ObsServer``, ``route``, ``ROUTES``) and its operator command line
(``python -m repro_torch.obs``), on the CPU.

The reference's server and CLI tests (tests/test_obs_serve.py) run here
over the port: routes and the 503 on a failing component, nothing
started before ``start()``, a scraper hammering ``/metrics`` and
``/healthz`` through a 16-stream ``BatchBroker`` run that leaves tracks,
dispatches, broker units and the stage-span ledger equal to an unscraped
run, the ``serve-smoke`` artifacts and dump, and ``scrape`` /
``snapshot`` against a live server.  The 16-stream comparison runs the
detector each row at batch one (``_RowwiseNet``): the port's CPU
detector moves by about an ulp with its batch, so only a batch-invariant
detector makes the broker's two runs equal bit for bit whatever their
batches.  The port's server is also held against the reference's: one
registry content, filled identically into each package's ``Registry``,
serves the same ``/metrics`` bytes, the same ``/healthz`` and
``/snapshot`` documents and the same 404 body from both, and the
reference's validators accept the port's scrapes.

Every server binds port 0 and is stopped in a ``with`` block or a
``finally``; every ``urlopen`` has a timeout; every thread join has one.
"""
import dataclasses
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from collections import Counter as Tally

import pytest

torch = pytest.importorskip("torch")

import repro.obs.metrics as jmetrics  # noqa: E402
from repro.obs.__main__ import validate_exposition as jx_validate_exposition  # noqa: E402
from repro.obs.__main__ import validate_health as jx_validate_health  # noqa: E402
from repro.obs.serve import ObsServer as JxObsServer  # noqa: E402
from repro.obs.slo import SloEngine as JxSloEngine  # noqa: E402

import repro_torch.core.executor as tex  # noqa: E402
from repro_torch.obs import recorder as recorder_mod  # noqa: E402
from repro_torch.obs.__main__ import main as obs_main  # noqa: E402
from repro_torch.obs.__main__ import (validate_exposition,  # noqa: E402
                                      validate_health)
from repro_torch.obs.metrics import REGISTRY, Registry  # noqa: E402
from repro_torch.obs.recorder import FlightRecorder  # noqa: E402
from repro_torch.obs.serve import ROUTES, ObsServer, route  # noqa: E402
from repro_torch.obs.serve.health import HealthComponent  # noqa: E402
from repro_torch.obs.slo import SloEngine  # noqa: E402
from repro_torch.obs.trace import TRACER  # noqa: E402

from test_torch_broker import (assert_same, fleet,  # noqa: E402,F401
                               one_thread, run_streams)

JOIN_S = 10.0


@pytest.fixture(autouse=True)
def _serve_clean():
    yield
    TRACER.disable()
    TRACER.clear()
    recorder_mod.uninstall()


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type"), \
            resp.read().decode()


def _error(url, timeout=5.0):
    """-> (status, body) of a request the server answers with an error."""
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(url, timeout)
    return ei.value.code, ei.value.read().decode()


def _await_requests(server, n, timeout=5.0):
    """``server.stats()`` once it counts ``n`` requests, or after
    ``timeout`` seconds: a handler counts its request after the reply's
    bytes have gone out, so a client can read the count one short."""
    deadline = time.monotonic() + timeout
    stats = server.stats()
    while stats["requests"] < n and time.monotonic() < deadline:
        time.sleep(0.005)
        stats = server.stats()
    return stats


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def test_server_routes_and_healthz_503():
    reg = Registry()
    reg.counter("stream.appends").inc()
    comps = [HealthComponent("broker_detect",
                             metric="broker.detect.queue_depth",
                             warn=10.0, fail=100.0)]
    with ObsServer(port=0, registry=reg, components=comps) as server:
        status, ctype, text = _get(server.url + "/metrics")
        assert status == 200
        assert ctype.startswith("text/plain; version=0.0.4")
        assert "stream_appends 1" in text
        status, _, body = _get(server.url + "/healthz")
        assert status == 200
        assert json.loads(body)["status"] == "ok"
        status, _, body = _get(server.url + "/snapshot")
        doc = json.loads(body)
        assert doc["metrics"]["stream.appends"] == 1
        assert doc["slo"] is None
        code, body = _error(server.url + "/nothing")
        assert code == 404
        assert "/metrics" in json.loads(body)["routes"]
        # drive the watched gauge past fail: /healthz flips to 503
        reg.gauge("broker.detect.queue_depth").set(500.0)
        code, body = _error(server.url + "/healthz")
        assert code == 503
        assert json.loads(body)["status"] == "fail"
    # stopped: the port no longer answers
    with pytest.raises(OSError):
        _get(server.url + "/metrics", timeout=0.5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_costs_nothing_until_started():
    """Constructed and never started: no serve thread and no socket.
    (Only the server's own thread name is checked: other tests' daemon
    threads in the same worker may end meanwhile.)"""
    port = _free_port()
    server = ObsServer(port=port)
    assert "repro-obs-serve" not in {t.name for t in threading.enumerate()}
    assert server._httpd is None and server.port == port
    with socket.socket() as s:          # the port is still free to take
        s.bind(("127.0.0.1", port))


def test_server_start_is_idempotent_and_stop_releases_the_socket():
    with ObsServer(port=0, registry=Registry()) as server:
        port = server.port
        assert port != 0
        assert server.start() is server and server.port == port
        names = [t.name for t in threading.enumerate()]
        assert names.count("repro-obs-serve") == 1
        th = server._thread
    assert not th.is_alive()
    server.stop()                        # a second stop is a no-op
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


def test_handler_error_is_a_500_and_the_server_lives_on():
    reg = Registry()
    reg.counter("query.count").inc(2)

    @route("/test-broken")
    def _broken(server):
        raise RuntimeError("broken reader")

    try:
        with ObsServer(port=0, registry=reg) as server:
            code, body = _error(server.url + "/test-broken")
            assert code == 500
            assert json.loads(body)["error"] == \
                "RuntimeError: broken reader"
            status, _, text = _get(server.url + "/metrics")
            assert status == 200 and "query_count 2" in text
            assert server._thread.is_alive()
            stats = _await_requests(server, 2)
            assert stats["requests"] == 2
            assert stats["handler_cpu_seconds"] >= 0.0
    finally:
        del ROUTES["/test-broken"]
    assert sorted(ROUTES) == ["/healthz", "/metrics", "/snapshot"]


# ---------------------------------------------------------------------------
# the port's server against the reference's
# ---------------------------------------------------------------------------

def _fill(reg):
    """The same content into either package's registry: every kind,
    instance labels, a provider, and a histogram past its warn edge."""
    reg.counter("stream.appends").inc(48)
    reg.counter("query.count").inc(12)
    reg.counter("broker.detect.units_in").inc(301)
    h = reg.histogram("stream.append.wall_seconds")
    for i in range(40):
        h.observe(0.010 + 0.25 * (i % 9))
    q = reg.histogram("query.scan_seconds")
    for i in range(16):
        q.observe(0.0005 * (1 + i % 3))
    for cam, lag in (("caldot1/live0", 0.25), ("caldot1/live1", 7.5)):
        reg.gauge(f"stream.watermark[{cam}]").set(480.0)
        reg.gauge(f"stream.watermark_lag_seconds[{cam}]").set(lag)
    reg.gauge("broker.detect.queue_depth").set(70.0)
    reg.gauge("executor.decode.queue_depth").set(2.0)
    reg.gauge("store.bytes").set(1.5e6)
    reg.gauge("store.budget_bytes").set(2e6)
    reg.provider("stream.drift[caldot1/live0]",
                 lambda: {"watermarks": 8, "last_watermark": 480})
    return reg


def _untimed(doc):
    """A health or snapshot document without its clock readings: the
    report's ``time`` and each alert event's ``at``."""
    doc.get("health", doc).pop("time")
    for e in (doc.get("slo") or {}).get("events", ()):
        e.pop("at")
    return doc


def test_server_matches_reference_server():
    treg, jreg = _fill(Registry()), _fill(jmetrics.Registry())
    with ObsServer(port=0, registry=treg,
                   slo=SloEngine(registry=treg)) as ts, \
            JxObsServer(port=0, registry=jreg,
                        slo=JxSloEngine(registry=jreg)) as js:
        tm, jm = (_get(s.url + "/metrics") for s in (ts, js))
        assert tm == jm                 # status, content type, bytes
        assert validate_exposition(tm[2]) == \
            jx_validate_exposition(tm[2]) > 20
        th, jh = (_get(s.url + "/healthz") for s in (ts, js))
        assert th[:2] == jh[:2]
        health = _untimed(json.loads(th[2]))
        assert health == _untimed(json.loads(jh[2]))
        jx_validate_health(health)
        validate_health(health)
        assert health["status"] == "warn"
        assert health["slo"]["append_latency"]["state"] != "ok"
        for s in (ts, js):
            _await_requests(s, 2)
        tsnap, jsnap = (json.loads(_get(s.url + "/snapshot")[2])
                        for s in (ts, js))
        assert tsnap.pop("serve")["requests"] == 2
        assert jsnap.pop("serve")["requests"] == 2
        assert tsnap["slo"]["events"]           # an edge fired
        assert _untimed(tsnap) == _untimed(jsnap)
        assert _error(ts.url + "/none") == _error(js.url + "/none")


# ---------------------------------------------------------------------------
# the no-perturbation contract under live scrape
# ---------------------------------------------------------------------------

def _stage_ledger():
    """Per-stream multiset of (span name, chunk) for the deterministic
    span families (stage + run); broker flush/dispatch counts are
    timing-shaped and excluded."""
    ledger = {}
    for s in TRACER.snapshot():
        if s.name == "run" or s.name.startswith("stage."):
            ledger.setdefault(s.stream, Tally())[(s.name, s.chunk)] += 1
    return ledger


@pytest.mark.usefixtures("one_thread")
def test_concurrent_scrape_never_perturbs_16_stream_ingest(fleet,
                                                           tmp_path):
    bank, clips = fleet["rowwise"], fleet["clips"]
    p1 = dataclasses.replace(fleet["params"], chunk_size=1)
    n_streams = 16
    units = REGISTRY.counter("broker.detect.units_in")

    def one_run(scrape):
        TRACER.enable()
        TRACER.clear()
        units_before = units.value
        stop = threading.Event()
        scrapes = {"/metrics": 0, "/healthz": 0}
        server = scraper = None
        if scrape:
            rec = FlightRecorder(str(tmp_path / "scrape_ring"))
            server = ObsServer(port=0, slo=SloEngine(registry=REGISTRY),
                               recorder=rec).start()

            def hammer():
                while not stop.is_set():
                    for path in scrapes:
                        try:
                            urllib.request.urlopen(
                                server.url + path, timeout=2).read()
                            scrapes[path] += 1
                        except urllib.error.HTTPError:
                            scrapes[path] += 1      # a 503 is an answer
                        except OSError:
                            pass

            scraper = threading.Thread(target=hammer, daemon=True)
            scraper.start()
        try:
            broker = tex.BatchBroker()
            results = run_streams(bank, p1, clips, n_streams,
                                  batch_broker=broker)
            broker.close()
        finally:
            stop.set()
            if scraper is not None:
                scraper.join(JOIN_S)
                assert not scraper.is_alive(), "the scraper hung"
            if server is not None:
                server.stop()
        ledger = _stage_ledger()
        TRACER.disable()
        if scrape:
            assert all(scrapes.values()), scrapes
        return results, units.value - units_before, ledger

    ref, ref_units, ref_ledger = one_run(scrape=False)
    got, got_units, got_ledger = one_run(scrape=True)

    assert len(ref_ledger) == len(clips)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert_same(b, a)
        assert a.dispatches == b.dispatches, i
    assert got_units == ref_units == sum(r.detector_windows for r in ref)
    assert got_ledger == ref_ledger


# ---------------------------------------------------------------------------
# the operator CLI
# ---------------------------------------------------------------------------

def test_cli_serve_smoke_writes_artifacts_and_dump(tmp_path, capsys):
    out = tmp_path / "smoke"
    assert obs_main(["serve-smoke", "--out", str(out)]) == 0
    for name in ("metrics.txt", "healthz.json", "snapshot.json"):
        assert (out / name).exists(), name
    health = json.loads((out / "healthz.json").read_text())
    assert health["status"] in ("ok", "warn", "fail")
    jx_validate_health(health)
    assert jx_validate_exposition((out / "metrics.txt").read_text()) > 0
    capsys.readouterr()

    assert obs_main(["dump", "--dir", str(out / "flight")]) == 0
    dump = json.loads(capsys.readouterr().out)
    assert dump["error"]["type"] == "ValueError"
    assert dump["checkpoint"] == "camA/ckpt.npz"

    assert obs_main(["tail", "--dir", str(out / "flight"),
                     "-n", "5"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert 0 < len(lines) <= 5
    assert all(json.loads(ln)["kind"] for ln in lines)


def test_cli_scrape_and_snapshot_against_live_server(capsys):
    reg = Registry()
    reg.counter("query.count").inc(5)
    with ObsServer(port=0, registry=reg) as server:
        assert obs_main(["scrape", "--url", server.url]) == 0
        text = capsys.readouterr().out
        assert "# TYPE query_count counter" in text
        assert obs_main(["snapshot", "--url", server.url]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["metrics"]["query.count"] == 5
        assert doc["health"]["status"] == "ok"


def test_cli_dump_without_dumps_fails(tmp_path, capsys):
    assert obs_main(["dump", "--dir", str(tmp_path / "empty")]) == 1
    assert "no crash dumps" in capsys.readouterr().err
