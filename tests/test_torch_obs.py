"""The port's observability layer (``repro_torch.obs``: the span tracer,
the metrics registry and its helpers, ``DriftMonitor`` and the crash
flight recorder) against the JAX package's ``repro.obs``.

The same calls on both sides must give the same exported records, the
same quantiles bit for bit, the same snapshot keys and value types, the
same drift summaries and crash dumps with the same fields; only clock
readings may differ.  The port's module-level ``TRACER``, ``REGISTRY``
and installed recorder are its own objects, and every test that enables
or installs one undoes it in a ``finally``.
"""
import json
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro.obs.recorder as jrec  # noqa: E402

import repro_torch.obs as tobs  # noqa: E402
import repro_torch.obs.recorder as trec  # noqa: E402

SIDES = {"reference": (jobs, jrec), "port": (tobs, trec)}
# span fields that hold clock readings
CLOCKS = ("ts_ns", "dur_ns", "proc_ns")


def _drive_tracer(obs, capacity=None):
    """One fixed sequence of spans on a fresh tracer; -> the tracer."""
    tr = obs.Tracer(capacity=64) if capacity is None else \
        obs.Tracer(capacity=capacity)
    with tr.span("stream.append", "stream", stream="caldot1/test0"):
        pass                                    # disabled: records nothing
    tr.enable()
    with tr.span("stream.append", "stream", stream="caldot1/test0",
                 args={"watermark": 16}) as sp:
        tr.emit("stage.proxy", "executor", ts=10, dur=5, proc=3, chunk=0)
        with tr.span("query.run", "query") as q:
            q.args = {"plan": "agg=count", "scanned": 2}
        sp.args = {**sp.args, "sealed": False}
    root = tr.open("run", "executor", stream="caldot1/test1",
                   args={"frames": 16})
    th = threading.Thread(target=lambda: tr.emit(
        "broker.detect.dispatch", "broker", ts=20, dur=4,
        parent=root.sid, args={"windows": 3}))
    th.start()
    th.join(10.0)
    assert not th.is_alive()
    tr.close(root, args={"windows": 7})
    tr.open("run", "executor", stream="caldot1/test2")     # left open
    for k in range(5):
        tr.emit("stage.track", ts=30 + k, dur=1, chunk=k)
    return tr


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _timeless(rec):
    out = {k: v for k, v in rec.items() if k not in CLOCKS + ("tid",)}
    out["open"] = rec["dur_ns"] < 0
    return out


@pytest.mark.parametrize("capacity", [None, 6])
def test_tracer_exports_the_reference_records(tmp_path, capacity):
    """JSONL: the same span records (ids, parents, names, categories,
    streams, chunks, args, open spans) in the same order; a full ring
    keeps the same newest spans.  Chrome: the same events and lanes."""
    out = {}
    for name, (obs, _) in SIDES.items():
        tr = _drive_tracer(obs, capacity)
        n = tr.export_jsonl(str(tmp_path / f"{name}.jsonl"))
        m = tr.export_chrome(str(tmp_path / f"{name}.json"))
        recs = _records(tmp_path / f"{name}.jsonl")
        assert n == len(recs) and m == n
        with open(tmp_path / f"{name}.json") as f:
            chrome = json.load(f)
        for ev in chrome:
            ev.pop("ts", None)
            ev.pop("dur", None)
            ev.pop("tid", None)
            ev.get("args", {}).pop("thread_cpu_ms", None)
        out[name] = ([_timeless(r) for r in recs], chrome,
                     [s.sid for s in tr.snapshot()])
    assert out["port"] == out["reference"]
    if capacity is not None:
        assert len(out["port"][2]) == capacity


def test_tracer_singletons_are_the_ports_own():
    assert tobs.TRACER is not jobs.TRACER
    assert tobs.REGISTRY is not jobs.REGISTRY
    assert not tobs.enabled()
    try:
        tobs.enable()
        assert tobs.enabled() and tobs.TRACER.enabled
        assert not jobs.enabled()
    finally:
        tobs.disable()
        tobs.TRACER.clear()
    assert not tobs.enabled()


def test_histogram_and_interp_quantile_bit_for_bit():
    rng = np.random.default_rng(0)
    samples = rng.normal(size=5000).tolist()     # past the 4096 window
    hs = {}
    for name, (obs, _) in SIDES.items():
        h = obs.Histogram()
        assert h.summary() == {"count": 0}
        for v in samples:
            h.observe(v)
        hs[name] = (h.summary(), h.window())
    assert hs["port"] == hs["reference"]
    vals = sorted(rng.exponential(size=257).tolist())
    for q in np.linspace(0.0, 1.0, 41):
        assert tobs.interp_quantile(vals, float(q)) == \
            jobs.interp_quantile(vals, float(q))
    assert tobs.interp_quantile([], 0.5) == jobs.interp_quantile([], 0.5)
    assert tobs.interp_quantile([1.0, 3.0], 0.5) == 2.0


def _drive_registry(obs):
    reg = obs.Registry()
    reg.counter("stream.appends").inc()
    reg.counter("stream.appends").inc(4)
    reg.counter("query.count").set(7)
    reg.gauge("stream.watermark[caldot1/test0]").set(48)
    reg.gauge("stream.watermark_lag_seconds[caldot1/test0]").set(0.25)
    for v in (0.5, 0.125, 2.0):
        reg.histogram("query.scan_seconds").observe(v)
    reg.histogram("stream.append.wall_seconds", window=2)
    reg.provider("stream.drift[caldot1/test0]", lambda: {"watermarks": 3})
    reg.provider("broken", lambda: 1 / 0)
    with pytest.raises(TypeError) as err:
        reg.gauge("query.count")
    return reg, str(err.value)


def test_registry_snapshot_keys_and_types():
    got = {name: _drive_registry(obs) for name, (obs, _) in SIDES.items()}
    (jreg, jerr), (treg, terr) = got["reference"], got["port"]
    js, ts = jreg.snapshot(), treg.snapshot()
    assert list(ts) == list(js)
    assert {k: type(v) for k, v in ts.items()} == \
        {k: type(v) for k, v in js.items()}
    assert ts == js and ts["broken"] is None
    assert treg.snapshot("stream.") == jreg.snapshot("stream.")
    assert terr == jerr
    assert treg.get("query.scan_seconds").window() == [0.5, 0.125, 2.0]
    treg.reset("query.")
    jreg.reset("query.")
    assert treg.snapshot() == jreg.snapshot()
    assert treg.snapshot()["query.count"] == 0


def test_stage_blocks_match_the_reference():
    a = {"decode": 0.5, "proxy": 0.25, "detect": 1.0, "track": 0.75}
    p = {"decode": 0.125, "proxy": 0.25, "detect": 0.5}
    blocks = [tobs.stage_block(a, p), None, tobs.empty_stage_block(
        ("decode", "proxy", "detect", "track")), tobs.stage_block(a, a)]
    assert blocks[0] == jobs.stage_block(a, p)
    assert blocks[2] == jobs.empty_stage_block(
        ("decode", "proxy", "detect", "track"))
    assert tobs.merge_stage_blocks(blocks) == \
        jobs.merge_stage_blocks(blocks)
    tobs.assert_stage_sane(blocks[0])
    bad = {"track": {"wall": 0.1, "process": 0.5}}
    for obs in (jobs, tobs):
        with pytest.raises(AssertionError, match="double-counted"):
            obs.assert_stage_sane(bad)


def test_run_profile_stage_seconds():
    rp = tobs.RunProfile(("decode", "track"))
    rp.note_stage("decode", 0.5, 0.25)
    rp.dispatch("detect", 3)
    assert rp.stage_seconds() == {"decode": {"wall": 0.5, "process": 0.25},
                                  "track": {"wall": 0.0, "process": 0.0}}
    assert rp.dispatches("detect") == 3 and rp.dispatches("proxy") == 0


@pytest.mark.parametrize("window,trailing", [(8, 32), (2, 3)])
def test_drift_monitor_summary_matches_the_reference(window, trailing):
    rng = np.random.default_rng(1)
    seq = []
    for w in range(40):
        fr = None if w % 7 == 3 else rng.uniform(0, 1, 16).tolist()
        tc = None if w % 11 == 5 else int(rng.integers(0, 30))
        seq.append((16 * (w + 1), fr, tc))
    mons = {}
    for name, (obs, _) in SIDES.items():
        m = obs.DriftMonitor(window=window, trailing=trailing)
        assert m.summary() == {"watermarks": 0}
        for wm, fr, tc in seq:
            m.observe(wm, proxy_fracs=fr, track_count=tc)
        mons[name] = (m.summary(), m.drifted(), m.drifted(0.01, 0.5))
    assert mons["port"] == mons["reference"]


def test_drift_switches_are_the_ports_own():
    assert not tobs.drift_enabled()
    try:
        tobs.enable_drift()
        assert tobs.drift_enabled() and not jobs.drift_enabled()
    finally:
        tobs.disable_drift()
    assert not tobs.drift_enabled()


def _crash(obs, rec, root):
    """A failing append under a span, dumped twice (the inner and the
    outer hook), with a recorder installed; -> (the dump, the paths)."""
    obs.TRACER.clear()
    obs.TRACER.enable()
    rec.install(rec.FlightRecorder(str(root), segment_records=4,
                                   segments=2))
    try:
        obs.REGISTRY.counter("stream.appends").inc(0)
        try:
            with obs.TRACER.span("stream.append", "stream",
                                 stream="caldot1/test0"):
                with obs.TRACER.span("query.run", "query"):
                    raise RuntimeError("segment failed")
        except RuntimeError as exc:
            p1 = rec.crash_dump("stream.append", exc,
                                checkpoint="/store/c.ckpt.npz",
                                extra={"requested_frames": 16})
            p2 = rec.crash_dump("outer", exc, extra={"more": 1})
        with open(p1) as f:
            doc = json.load(f)
        return doc, (p1, p2), rec.active().dumps(), rec.active().tail(10)
    finally:
        rec.uninstall()
        obs.TRACER.disable()
        obs.TRACER.clear()


def test_crash_dump_writes_the_reference_fields(tmp_path):
    assert trec.crash_dump("x", RuntimeError("y")) is None   # none installed
    docs = {name: _crash(obs, rec, tmp_path / name)
            for name, (obs, rec) in SIDES.items()}
    (jd, (j1, j2), jdumps, jtail) = docs["reference"]
    (td, (t1, t2), tdumps, ttail) = docs["port"]
    assert t1 == t2 and tdumps == [t1]          # one dump per exception
    assert sorted(td) == sorted(jd)
    for k in ("reason", "reasons", "checkpoint", "extra"):
        assert td[k] == jd[k], k
    for k in ("type", "message"):
        assert td["error"][k] == jd["error"][k]
    assert [s["name"] for s in td["lineage"]] == \
        [s["name"] for s in jd["lineage"]] == ["query.run", "stream.append"]
    assert [s["name"] for s in td["spans"]] == \
        [s["name"] for s in jd["spans"]]
    assert "stream.appends" in td["metrics"]
    assert [r["kind"] for r in ttail] == [r["kind"] for r in jtail]
    assert trec.active() is None and not tobs.TRACER.enabled


def test_flight_recorder_ring_matches_the_reference(tmp_path):
    out = {}
    for name, (obs, rec) in SIDES.items():
        tr, reg = obs.Tracer(), obs.Registry()
        fr = rec.FlightRecorder(str(tmp_path / name), segment_records=3,
                                segments=2)
        tr.enable()
        with tr.span("query.run", "query"):
            pass
        reg.counter("query.count").inc(2)
        polls = [fr.poll(tr, reg)]
        polls.append(fr.poll(tr, reg))           # nothing new
        for k in range(7):
            fr.record("alert", rule="p95", n=k)
        tail = [{k: v for k, v in r.items() if k not in ("t",) + CLOCKS
                 + ("tid",)} for r in fr.tail(20)]
        out[name] = (polls, tail, sorted(p.name for p in
                                         (tmp_path / name).iterdir()))
    assert out["port"] == out["reference"]
