"""``python -m repro_torch.obs`` — operator CLI for the telemetry
serving plane.

The port of the JAX package's ``repro.obs.__main__``
(``src/repro/obs/__main__.py``), the same code over the port's
``repro_torch.obs`` modules.  ``scrape`` and ``snapshot`` read any
exporter, the reference's as well.

Subcommands:

* ``scrape``      GET an exporter's ``/metrics`` and print it
* ``snapshot``    GET ``/snapshot`` and pretty-print the JSON
* ``tail``        print the last N flight-recorder ring records
* ``dump``        print the newest crash dump (black-box readout)
* ``serve-smoke`` self-contained exporter smoke: synthetic registry ->
  live server -> real HTTP scrapes -> exposition/health-schema
  validation -> induced crash -> flight-recorder dump on disk
  (``metrics.txt``, ``healthz.json``, ``snapshot.json`` and
  ``flight/`` under ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import urllib.error
import urllib.request
from typing import List, Optional

_DEFAULT_URL = "http://127.0.0.1:9108"

# one exposition sample line: name{labels} value
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
    r"[-+]?([0-9]*\.)?[0-9]+([eE][-+]?[0-9]+)?$")


def _get(url: str, timeout: float = 5.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def _cmd_scrape(args) -> int:
    sys.stdout.write(_get(args.url.rstrip("/") + args.path))
    return 0


def _cmd_snapshot(args) -> int:
    doc = json.loads(_get(args.url.rstrip("/") + "/snapshot"))
    json.dump(doc, sys.stdout, indent=2, default=str)
    sys.stdout.write("\n")
    return 0


def _cmd_tail(args) -> int:
    from repro_torch.obs.recorder import FlightRecorder
    rec = FlightRecorder(args.dir)
    for r in rec.tail(args.n):
        sys.stdout.write(json.dumps(r, default=str) + "\n")
    return 0


def _cmd_dump(args) -> int:
    from repro_torch.obs.recorder import FlightRecorder
    rec = FlightRecorder(args.dir)
    dumps = rec.dumps()
    if not dumps:
        sys.stderr.write(f"no crash dumps under {args.dir}\n")
        return 1
    with open(dumps[-1]) as f:
        sys.stdout.write(f.read().rstrip("\n") + "\n")
    return 0


def validate_exposition(text: str) -> int:
    """Every line must be a comment or a well-formed sample; returns
    the sample count (raises AssertionError otherwise)."""
    samples = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _SAMPLE_RE.match(line), \
            f"malformed exposition line: {line!r}"
        samples += 1
    assert samples > 0, "exposition carried no samples"
    return samples


def validate_health(doc: dict) -> None:
    """The /healthz JSON schema the CI smoke (and operators) rely on."""
    assert doc.get("status") in ("ok", "warn", "fail"), doc
    comps = doc.get("components")
    assert isinstance(comps, dict) and comps, doc
    for name, c in comps.items():
        assert c.get("status") in ("ok", "warn", "fail"), (name, c)
        for key in ("value", "warn", "fail", "metric"):
            assert key in c, (name, key)


def _smoke_registry():
    """A synthetic-but-representative registry: every metric family
    the health components and default SLO rules watch."""
    from repro_torch.obs.metrics import Registry
    reg = Registry()
    reg.counter("stream.appends").inc(48)
    reg.counter("query.count").inc(12)
    h = reg.histogram("stream.append.wall_seconds")
    for i in range(32):
        h.observe(0.010 + 0.001 * (i % 7))
    q = reg.histogram("query.scan_seconds")
    for i in range(16):
        q.observe(0.0005 * (1 + i % 3))
    for cam in ("camA", "camB"):
        reg.gauge(f"stream.watermark[{cam}]").set(480.0)
        reg.gauge(f"stream.watermark_lag_seconds[{cam}]").set(0.25)
    reg.gauge("broker.detect.queue_depth").set(3.0)
    reg.gauge("broker.track.queue_depth").set(1.0)
    reg.gauge("executor.decode.queue_depth").set(2.0)
    reg.gauge("store.bytes").set(1.5e6)
    reg.gauge("store.budget_bytes").set(64e6)
    reg.provider(
        "stream.drift[camA]",
        lambda: {"watermarks": 8, "last_watermark": 480})
    return reg


def _cmd_serve_smoke(args) -> int:
    from repro_torch.obs.recorder import FlightRecorder
    from repro_torch.obs.serve import ObsServer
    from repro_torch.obs.slo import AlertRule, SloEngine
    from repro_torch.obs.trace import Tracer

    out = args.out
    os.makedirs(out, exist_ok=True)
    reg = _smoke_registry()
    tr = Tracer()
    tr.enable()
    rec = FlightRecorder(os.path.join(out, "flight"))
    # one rule tightened far below the synthetic latencies, so the
    # smoke also proves an alert EDGE fires and lands on the ring
    rules = [AlertRule("append_latency", "stream.append.wall_seconds",
                       objective=0.001, quantile=0.95, budget=0.01)]
    slo = SloEngine(rules, registry=reg, recorder=rec)

    with ObsServer(port=args.port, registry=reg, tracer=tr,
                   slo=slo, recorder=rec) as server:
        base = server.url
        metrics = _get(base + "/metrics")
        n = validate_exposition(metrics)
        healthz = json.loads(_get(base + "/healthz"))
        validate_health(healthz)
        snap = json.loads(_get(base + "/snapshot"))
        assert snap["metrics"]["stream.appends"] == 48, snap["metrics"]
        assert snap["metrics"]["stream.drift[camA]"]["watermarks"] == 8
        assert snap["health"]["status"] in ("ok", "warn", "fail")
        try:
            _get(base + "/nope")
        except urllib.error.HTTPError as e:
            assert e.code == 404, e.code
        else:
            raise AssertionError("unknown route did not 404")
        # the tightened SLO must have fired on the /healthz tick
        assert slo.report()["rules"]["append_latency"]["state"] \
            in ("warn", "page"), slo.report()
        assert any(r.get("kind") == "alert" for r in rec.tail(100)), \
            "alert event never reached the flight ring"
        # induced crash inside a traced span -> black-box dump
        try:
            with tr.span("stream.append", "stream", stream="camA"):
                raise ValueError("induced smoke crash")
        except ValueError as exc:
            path = rec.dump("smoke.crash", exc,
                            checkpoint="camA/ckpt.npz",
                            tracer=tr, registry=reg)
        with open(path) as f:
            dump = json.load(f)
        assert dump["error"]["type"] == "ValueError", dump["error"]
        assert dump["checkpoint"] == "camA/ckpt.npz"
        assert any(s["name"] == "stream.append"
                   for s in dump["lineage"]), dump["lineage"]

    with open(os.path.join(out, "metrics.txt"), "w") as f:
        f.write(metrics)
    with open(os.path.join(out, "healthz.json"), "w") as f:
        json.dump(healthz, f, indent=2)
    with open(os.path.join(out, "snapshot.json"), "w") as f:
        json.dump(snap, f, indent=2)
    print(f"[obs-serve-smoke] OK: {n} exposition samples, health="
          f"{healthz['status']}, dump={os.path.relpath(path, out)}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="telemetry serving-plane CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("scrape", help="GET /metrics and print it")
    p.add_argument("--url", default=_DEFAULT_URL)
    p.add_argument("--path", default="/metrics")
    p.set_defaults(fn=_cmd_scrape)

    p = sub.add_parser("snapshot", help="GET /snapshot, pretty-print")
    p.add_argument("--url", default=_DEFAULT_URL)
    p.set_defaults(fn=_cmd_snapshot)

    p = sub.add_parser("tail", help="print recent flight-ring records")
    p.add_argument("--dir", required=True,
                   help="flight-recorder directory")
    p.add_argument("-n", type=int, default=50)
    p.set_defaults(fn=_cmd_tail)

    p = sub.add_parser("dump", help="print the newest crash dump")
    p.add_argument("--dir", required=True,
                   help="flight-recorder directory")
    p.set_defaults(fn=_cmd_dump)

    p = sub.add_parser("serve-smoke",
                       help="self-contained exporter smoke (CI)")
    p.add_argument("--out", default="OBS_SMOKE",
                   help="artifact directory")
    p.add_argument("--port", type=int, default=0)
    p.set_defaults(fn=_cmd_serve_smoke)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
