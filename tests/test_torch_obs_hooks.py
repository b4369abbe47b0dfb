"""The port's executor, broker, decode-pool and detector instrumentation
(``repro_torch.core.executor``, ``core.detector``), its SLO engine
(``repro_torch.obs.slo``) and the serving plane's pure half
(``repro_torch.obs.serve``: Prometheus exposition and component health),
on the CPU at the reduced configuration with 16-frame clips.

For the same clip, θ and executor flavour the port emits the reference's
spans (name, category, stream, chunk, parent kind and integer arguments;
durations are clock readings and are not compared) and registers the
reference's metric names with the same dispatch and unit counts, each
package's in a fresh ``Tracer`` and ``Registry`` patched into its
executor and detector (the module globals hold other tests' names).
Tracing observes and never perturbs: tracks and dispatches with the
tracer on equal the same runs with it off, bit for bit, in every
flavour.  The reference's tests of ``repro.obs`` that need no socket
run here as cases over the port; the SLO engine fires the same alert
edges with the same quantiles bit for bit, and one snapshot renders and
grades alike, in both packages.  The banks carry the reference's seeded
weights.  Every test that enables the tracer or installs a recorder
undoes it in a ``finally``; every thread join has a timeout.
"""
import dataclasses
import json
from collections import Counter as Tally

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.executor as jex  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.obs.recorder as jrec  # noqa: E402
from repro.obs.__main__ import validate_exposition  # noqa: E402
from repro.obs.serve import health_report as jx_health_report  # noqa: E402
from repro.obs.serve import render_prometheus as jx_render  # noqa: E402
from repro.obs.slo import AlertRule as JxAlertRule  # noqa: E402
from repro.obs.slo import SloEngine as JxSloEngine  # noqa: E402

import repro_torch.core.executor as tex  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.obs.recorder as trec  # noqa: E402
import repro_torch.query as tq  # noqa: E402
import repro_torch.stream as tstream  # noqa: E402
from repro_torch.obs.metrics import Histogram, Registry  # noqa: E402
from repro_torch.obs.serve import (CONTENT_TYPE,  # noqa: E402
                                   HealthComponent, default_components,
                                   health_report, render_prometheus)
from repro_torch.obs.slo import (AlertRule, SloEngine,  # noqa: E402
                                 default_rules)

from test_torch_broker import (_FakeDetector, _track_requests,  # noqa: E402
                               _win, batch_invariant, run_threads)
from test_torch_query import build_setup, jx_params  # noqa: E402

FLAVORS = ("streaming", "sequential", "device_assign", "device_tracker",
           "unfused", "batch_broker", "track_broker", "run_clips")
# flavours whose runs share a broker across 4 concurrent streams
FLEET_STREAMS = 4


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops run faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Both banks with the reference's weights, two clips each, and θ at
    chunks of 8 (two chunks a clip), its thresholds a margin away from
    every score at chunks of 1, 8 and 16."""
    s = build_setup(n_clips=2, chunks=(1, 8, 16))
    s["params"] = dataclasses.replace(s["params"], chunk_size=8)
    s["rbank"] = batch_invariant(s["tbank"])
    return s


def _options(ex, flavor):
    """(ExecutorOptions, the brokers to close) for one flavour."""
    if flavor == "batch_broker":
        b = ex.BatchBroker()
        return ex.ExecutorOptions(batch_broker=b), [b]
    if flavor == "track_broker":
        b = ex.TrackBroker()
        return ex.ExecutorOptions(device_assign=True, track_broker=b), [b]
    kw = {"sequential": dict(prefetch=False),
          "device_assign": dict(device_assign=True),
          "device_tracker": dict(device_tracker=True),
          "unfused": dict(fused_plan=False)}.get(flavor, {})
    return ex.ExecutorOptions(**kw), []


def _run_flavor(ex, flavor, bank, params, clips, streams=1):
    """The flavour's runs: ``run_clips`` over ``clips``, else one run of
    each stream's clip (round robin), concurrent when ``streams`` > 1;
    -> their results."""
    opts, brokers = _options(ex, flavor)
    try:
        if flavor == "run_clips":
            return ex.run_clips(bank, params, clips, opts)[0]
        fns = [lambda i=i: ex.run_clip_streamed(
            bank, params, clips[i % len(clips)], opts)
            for i in range(streams)]
        return run_threads(fns) if streams > 1 else [fns[0]()]
    finally:
        for b in brokers:
            b.close()


def _fresh(monkeypatch, obs, ex, bank):
    """Point one package's executor, ``RunProfile.publish`` and the
    bank's detectors at a fresh, enabled ``Tracer`` and a fresh
    ``Registry``; -> (tracer, registry)."""
    tr, reg = obs.Tracer(), obs.Registry()
    tr.enable()
    monkeypatch.setattr(ex, "TRACER", tr)
    monkeypatch.setattr(ex, "REGISTRY", reg)
    monkeypatch.setattr(obs.metrics.RunProfile.publish, "__defaults__",
                        (reg, "executor"))
    for det in bank.detectors.values():
        monkeypatch.setattr(det, "_m_dispatches",
                            reg.counter("detector.dispatches"))
    return tr, reg


def span_ledger(spans):
    """The spans as a multiset of (name, category, stream, chunk, parent
    kind, integer arguments): what a run decides, without its clocks."""
    kinds = {s.sid: ("run" if s.name == "run" else "flush")
             for s in spans if s.name == "run" or s.name.endswith(".flush")}
    return Tally((s.name, s.cat, s.stream, s.chunk, kinds.get(s.parent),
                  tuple(sorted((k, v) for k, v in (s.args or {}).items()
                               if type(v) is int)))
                 for s in spans)


def registry_view(reg):
    """Counters by value, histograms by count, gauges by name only."""
    out = {}
    for k, v in reg.snapshot().items():
        if isinstance(v, dict):
            out[k] = ("count", v["count"])
        elif type(v) is int:
            out[k] = v
        else:
            out[k] = "gauge"
    return out


# ---------------------------------------------------------------------------
# The port's spans and registry names against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavor", FLAVORS)
def test_spans_and_registry_match_the_reference(setup, monkeypatch,
                                                flavor):
    """One stream (two clips for ``run_clips``) in each package with a
    fresh tracer and registry: the same span ledger and the same metric
    names, counters and histogram counts."""
    s = setup
    got = {}
    for name, obs, ex, bank, params, clips in (
            ("port", tobs, tex, s["tbank"], s["params"], s["clips"]),
            ("reference", jobs, jex, s["jbank"], jx_params(s["params"]),
             s["jclips"])):
        with monkeypatch.context() as mp:
            tr, reg = _fresh(mp, obs, ex, bank)
            res = _run_flavor(ex, flavor, bank, params, clips)
            got[name] = (span_ledger(tr.snapshot()), registry_view(reg),
                         [r.dispatches for r in res])
    port, ref = got["port"], got["reference"]
    assert port[2] == ref[2]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    names = {k[0] for k in port[0]}
    assert {"run", "stage.decode", "stage.proxy", "stage.detect",
            "stage.track"} <= names
    if flavor in ("batch_broker", "track_broker"):
        kind = flavor.split("_")[0]
        kind = "detect" if kind == "batch" else kind
        assert {f"broker.{kind}.flush", f"broker.{kind}.dispatch"} <= names
        assert port[1][f"broker.{kind}.dispatches"] > 0
    assert port[1]["executor.dispatch.detect"] == sum(
        d["detect"] for d in port[2])
    assert port[1]["detector.dispatches"] >= \
        port[1]["executor.dispatch.detect"]
    if flavor == "run_clips":
        assert "executor.decode.queue_depth" in port[1]
    else:
        assert "executor.decode.queue_depth" not in port[1]


# ---------------------------------------------------------------------------
# Ports of the reference's tests of repro.obs (tests/test_obs.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavor", ("streaming", "device_assign",
                                    "device_tracker", "unfused",
                                    "batch_broker", "track_broker",
                                    "run_clips"))
def test_tracing_on_is_bit_identical_across_flavors(setup, flavor):
    """For each flavour, tracks AND dispatches with the port's tracer on
    equal the tracer-off runs bit for bit.  The brokers serve
    ``FLEET_STREAMS`` concurrent streams under a detector that runs each
    row at batch one (the brokered batches cannot move its bits)."""
    s = setup
    bank = s["rbank"] if flavor == "batch_broker" else s["tbank"]
    streams = FLEET_STREAMS if flavor.endswith("broker") else 1
    runs = {}
    for traced in (False, True):
        tobs.TRACER.clear()
        if traced:
            tobs.enable()
        try:
            res = _run_flavor(tex, flavor, bank, s["params"], s["clips"],
                              streams)
            spans = tobs.TRACER.snapshot()
        finally:
            tobs.disable()
            tobs.TRACER.clear()
        runs[traced] = (res, spans)
    (off, no_spans), (on, spans) = runs[False], runs[True]
    assert no_spans == [] and len(spans) > 0
    assert len(on) == len(off)
    for a, b in zip(off, on):
        assert a.dispatches == b.dispatches
        assert (a.detector_windows, a.skipped_frames) == \
            (b.detector_windows, b.skipped_frames)
        assert len(a.tracks) == len(b.tracks)
        for x, y in zip(a.tracks, b.tracks):
            np.testing.assert_array_equal(x, y)
    assert sum(map(len, off[0].tracks)) > 0


def test_tracing_collects_run_and_stage_spans(setup):
    """An enabled run emits one ``run`` root and per-chunk ``stage.*``
    children parented to it, all tagged with the stream; the root's
    arguments are the run's frames, chunk, windows and skipped frames."""
    s = setup
    tobs.TRACER.clear()
    tobs.enable()
    try:
        r = tex.run_clip_streamed(s["tbank"], s["params"], s["clips"][0],
                                  tex.ExecutorOptions(prefetch=False))
        spans = tobs.TRACER.snapshot()
    finally:
        tobs.disable()
        tobs.TRACER.clear()
    roots = [sp for sp in spans if sp.name == "run"]
    assert len(roots) == 1 and roots[0].dur >= 0
    assert roots[0].stream == "caldot1/test0"
    assert roots[0].args == {"frames": 16, "chunk": 8,
                             "windows": r.detector_windows,
                             "skipped": r.skipped_frames}
    stages = [sp for sp in spans if sp.name.startswith("stage.")]
    assert Tally(sp.name for sp in stages) == Tally(
        {f"stage.{st}": 2 for st in tex.STAGES})
    for sp in stages:
        assert sp.parent == roots[0].sid
        assert sp.stream == roots[0].stream and sp.chunk in (0, 1)
        assert sp.dur >= 0 and sp.proc >= 0
    # each stage's spans sum to exactly what the run's profile recorded
    for st, d in r.stage_seconds.items():
        total = sum(sp.dur for sp in stages if sp.name == f"stage.{st}")
        assert total / 1e9 == pytest.approx(d["wall"], rel=1e-9, abs=1e-12)


def test_chrome_export_16_stream_broker_run(setup, tmp_path):
    """16 concurrent per-frame streams through one BatchBroker export a
    valid Chrome trace: loads with ``json.load``, one lane per stream
    plus the shared broker lane, events with sorted non-negative
    timestamps."""
    s = setup
    params = dataclasses.replace(s["params"], chunk_size=1)
    clips = s["clips"]
    broker = tex.BatchBroker()
    tobs.TRACER.clear()
    tobs.enable()
    try:
        opts = tex.ExecutorOptions(prefetch=False, batch_broker=broker)
        run_threads([lambda i=i: tex.run_clip_streamed(
            s["tbank"], params, clips[i % len(clips)], opts)
            for i in range(16)])
        broker.close()
        path = tmp_path / "trace.json"
        n = tobs.TRACER.export_chrome(str(path))
    finally:
        tobs.disable()
        tobs.TRACER.clear()
    with open(path) as f:
        events = json.load(f)
    xs = [e for e in events if e["ph"] == "X"]
    metas = [e for e in events if e["ph"] == "M"]
    assert len(xs) == n > 0
    lanes = {m["args"]["name"] for m in metas}
    assert "(shared)" in lanes and len(lanes) == len(clips) + 1
    last = -1.0
    for e in xs:
        assert e["ts"] >= last >= -1.0
        assert e["dur"] >= 0.0
        last = e["ts"]
    assert sum(e["name"] == "run" for e in xs) == 16
    assert any(e["name"] == "broker.detect.flush" for e in xs)


def test_global_registry_populated_by_pipeline(setup):
    """A streamed run folds its stage timings and dispatch counts into
    the port's module-level REGISTRY under the reference's names."""
    s = setup
    reg = tobs.REGISTRY
    before = reg.snapshot()
    r = tex.run_clip_streamed(s["tbank"], s["params"], s["clips"][0],
                              tex.ExecutorOptions(prefetch=False))
    snap = reg.snapshot()

    def grew(name):
        old = before.get(name, 0)
        if isinstance(old, dict):
            return snap[name]["count"] - old["count"]
        return snap[name] - old

    assert grew("executor.dispatch.proxy") == r.dispatches["proxy"]
    assert grew("executor.dispatch.detect") == r.dispatches["detect"]
    assert grew("executor.dispatch.track") == r.dispatches["track"]
    for st in r.stage_seconds:
        assert grew(f"executor.stage.{st}.wall_seconds") == 1
        assert grew(f"executor.stage.{st}.process_seconds") == 1
    assert grew("detector.dispatches") >= r.dispatches["detect"] > 0


def test_run_profile_thread_safe_and_publishes():
    prof = tobs.RunProfile(["decode", "detect"])

    def work():
        for _ in range(500):
            prof.note_stage("decode", 0.001, 0.0005)
            prof.dispatch("detect")

    run_threads([work] * 4)
    ss = prof.stage_seconds()
    assert ss["decode"]["wall"] == pytest.approx(0.5 * 4)
    assert ss["decode"]["process"] == pytest.approx(0.25 * 4)
    assert prof.dispatches("detect") == 2000
    tobs.assert_stage_sane(ss)
    reg = Registry()
    prof.publish(reg, prefix="executor")
    snap = reg.snapshot()
    assert snap["executor.dispatch.detect"] == 2000
    assert snap["executor.stage.decode.wall_seconds"]["count"] == 1
    assert snap["executor.stage.detect.process_seconds"]["max"] == 0.0


# ---------------------------------------------------------------------------
# The brokers' flush ledgers (tests/test_broker.py) and registry mirrors
# ---------------------------------------------------------------------------

def _nested_ledger(spans, kind, count):
    """Every ``broker.{kind}.dispatch`` span lies inside its parent flush
    and the dispatches' ``count`` argument sums to the flush's total;
    -> (flushes, dispatches)."""
    flushes = {sp.sid: sp for sp in spans
               if sp.name == f"broker.{kind}.flush"}
    disp = [sp for sp in spans if sp.name == f"broker.{kind}.dispatch"]
    assert flushes and disp
    by_parent = Tally()
    for sp in disp:
        p = flushes.get(sp.parent)
        assert p is not None, "dispatch span not parented to a flush"
        assert p.ts <= sp.ts and sp.ts + sp.dur <= p.ts + p.dur
        by_parent[sp.parent] += sp.args[count]
    for sid, f in flushes.items():
        want = f.args["windows"] if kind == "detect" else f.args["requests"]
        assert by_parent[sid] == want
    return flushes, disp


def test_broker_flush_spans_ledger(monkeypatch):
    """Concurrent flushes of a BatchBroker emit one flush span a flush,
    its dispatch children inside it, and an exact window ledger: per
    flush and over the run; the registry mirrors equal the broker's
    stats."""
    tr, reg = tobs.Tracer(), Registry()
    tr.enable()
    monkeypatch.setattr(tex, "TRACER", tr)
    monkeypatch.setattr(tex, "REGISTRY", reg)
    broker = tex.BatchBroker(linger_ms=50.0)
    det = _FakeDetector()
    n_streams, rounds = 6, 4
    handles = [broker.register() for _ in range(n_streams)]

    def feed(i):
        for r in range(rounds):
            n = 1 + (i + r) % 3
            origins = [(i * 100 + r * 10 + j, 0) for j in range(n)]
            out = handles[i].detect(det, _win(n), 0.4, origins, [1.0] * n,
                                    n_valid=n)
            assert [o[0][0] for o in out] == [float(o[0]) for o in origins]

    try:
        run_threads([lambda i=i: feed(i) for i in range(n_streams)])
    finally:
        for h in handles:
            h.close()
        broker.close()
    spans = tr.snapshot()
    total = sum(1 + (i + r) % 3 for i in range(n_streams)
                for r in range(rounds))
    flushes, disp = _nested_ledger(spans, "detect", "windows")
    assert len(disp) == broker.dispatches
    assert broker.windows_in == total
    assert sum(sp.args["windows"] for sp in disp) == total
    assert sum(f.args["windows"] for f in flushes.values()) == total
    assert sum(f.args["requests"] for f in flushes.values()) == \
        n_streams * rounds
    snap = reg.snapshot()
    assert snap["broker.detect.dispatches"] == broker.dispatches
    assert snap["broker.detect.units_in"] == total
    assert snap["broker.detect.fill"]["count"] == broker.dispatches
    assert snap["broker.detect.linger_wait_ms"]["count"] == len(flushes)
    assert snap["broker.detect.queue_depth"] == 0.0


def test_track_broker_flush_spans_ledger(monkeypatch):
    """The TrackBroker twin: concurrent streams' steps flush into
    ``broker.track.flush`` spans whose dispatch children's streams sum to
    the flush's requests, and over the run to every step submitted."""
    tr, reg = tobs.Tracer(), Registry()
    tr.enable()
    monkeypatch.setattr(tex, "TRACER", tr)
    monkeypatch.setattr(tex, "REGISTRY", reg)
    from repro_torch.kernels.track_step import LOG1P_TABLE_2D, pack_params
    rng = np.random.default_rng(3)
    n_streams, rounds = 4, 3
    streams, thr, heads = _track_requests(rng, (8, 16, 8, 16))
    packed = pack_params(heads, "cpu")
    table = torch.from_numpy(LOG1P_TABLE_2D)
    broker = tex.TrackBroker(linger_ms=50.0)
    handles = [broker.register() for _ in range(n_streams)]

    def feed(i):
        ops = [torch.from_numpy(a) for a in streams[i]]
        for _ in range(rounds):
            out = handles[i].step(*ops, thr, packed, table, params_key=0)
            assert out[0].shape == (streams[i][0].shape[0],)

    try:
        run_threads([lambda i=i: feed(i) for i in range(n_streams)])
    finally:
        for h in handles:
            h.close()
        broker.close()
    flushes, disp = _nested_ledger(tr.snapshot(), "track", "streams")
    steps = n_streams * rounds
    assert len(disp) == broker.dispatches
    assert sum(sp.args["streams"] for sp in disp) == steps == broker.steps_in
    assert all(set(f.args) == {"requests", "streams", "wait_ms"}
               for f in flushes.values())
    snap = reg.snapshot()
    assert snap["broker.track.dispatches"] == broker.dispatches
    assert snap["broker.track.units_in"] == steps
    assert snap["broker.track.fill"]["count"] == broker.dispatches
    assert snap["broker.track.queue_depth"] == 0.0


def test_decode_pool_gauge_reads_zero_once_runs_finish(setup, monkeypatch):
    """The shared pool of ``run_clips`` sets ``executor.decode.queue_depth``
    and leaves it at 0; a single run's own decode threads set none."""
    s = setup
    reg = Registry()
    monkeypatch.setattr(tex, "REGISTRY", reg)
    tex.run_clip_streamed(s["tbank"], s["params"], s["clips"][0])
    assert "executor.decode.queue_depth" not in reg.snapshot()
    pool = tex.DecodePool(2)
    try:
        res, _ = tex.run_clips(s["tbank"], s["params"], s["clips"],
                               tex.ExecutorOptions(decode_pool=pool))
    finally:
        pool.close()
    assert len(res) == 2
    assert reg.snapshot()["executor.decode.queue_depth"] == 0.0


# ---------------------------------------------------------------------------
# The executor's crash dump (finish) and the black box of an append
# ---------------------------------------------------------------------------

def _failing_run(obs, rec, ex, bank, params, clip, root):
    """A run whose proxy stage raises on chunk 2, with a recorder and
    the tracer on; -> (the dump, the run span, the dumps written)."""
    def proxy(ctx, task):
        if task.index == 2:
            raise RuntimeError("proxy failed on chunk 2")
        return ex.stage_proxy(ctx, task)

    recorder = rec.install(rec.FlightRecorder(str(root)))
    obs.TRACER.clear()
    obs.TRACER.enable()
    try:
        with pytest.raises(RuntimeError, match="chunk 2"):
            ex.ClipExecutor(bank, dataclasses.replace(params, chunk_size=4),
                            ex.ExecutorOptions(prefetch=False),
                            stages={"proxy": proxy}).run(clip)
        spans = obs.TRACER.snapshot()
        dumps = recorder.dumps()
    finally:
        rec.uninstall()
        obs.TRACER.disable()
        obs.TRACER.clear()
    with open(dumps[0]) as f:
        doc = json.load(f)
    return doc, [sp for sp in spans if sp.name == "run"], dumps


def test_drain_failure_writes_a_crash_dump_as_the_reference(setup,
                                                            tmp_path):
    """A drain that raises writes one ``executor.drain`` dump with the
    run's stream, frames and chunk and the failing stage's lineage, as
    the reference's; the run still raises and its span is closed."""
    s = setup
    got = {}
    for name, obs, rec, ex, bank, params, clip in (
            ("port", tobs, trec, tex, s["tbank"], s["params"],
             s["clips"][0]),
            ("reference", jobs, jrec, jex, s["jbank"],
             jx_params(s["params"]), s["jclips"][0])):
        got[name] = _failing_run(obs, rec, ex, bank, params, clip,
                                 tmp_path / name)
    (doc, runs, dumps), (jdoc, _, _) = got["port"], got["reference"]
    assert len(dumps) == 1 and len(runs) == 1 and runs[0].dur >= 0
    assert doc["reason"] == jdoc["reason"] == "executor.drain"
    assert doc["extra"] == jdoc["extra"] == {
        "stream": "caldot1/test0", "frames": 16, "chunk": 4}
    assert doc["error"]["type"] == "RuntimeError"
    assert [sp["name"] for sp in doc["lineage"]] == \
        [sp["name"] for sp in jdoc["lineage"]] == ["stage.proxy", "run"]
    assert doc["lineage"][0]["chunk"] == 2


def test_mid_append_executor_crash_writes_black_box(setup, tmp_path,
                                                    monkeypatch):
    """A drain that fails inside an append: the executor's and the
    ingestor's hooks merge into ONE dump, whose lineage is the run that
    crashed inside the append that drove it, and whose checkpoint is the
    sidecar to resume from."""
    import os
    s = setup
    clip = s["clips"][1]
    store = tq.TrackStore(str(tmp_path / "crash_store"), s["tbank"],
                          s["params"])
    ing = tstream.SegmentIngestor(
        store, options=tex.ExecutorOptions(prefetch=False))
    rec = trec.install(trec.FlightRecorder(str(tmp_path / "flight")))
    tobs.TRACER.clear()
    tobs.enable()
    try:
        ing.open(clip)
        ing.append(clip, 8)            # a good append lands a checkpoint

        def explode(*a, **k):
            raise RuntimeError("induced mid-append failure")

        monkeypatch.setattr(ing._executor.scheduler, "drain", explode)
        with pytest.raises(RuntimeError, match="induced"):
            ing.append(clip, 8)
        dumps = rec.dumps()
    finally:
        trec.uninstall()
        tobs.disable()
        tobs.TRACER.clear()
    assert len(dumps) == 1
    with open(dumps[0]) as f:
        doc = json.load(f)
    assert doc["reasons"] == ["executor.drain", "stream.append"]
    assert "induced mid-append failure" in doc["error"]["traceback"]
    assert [sp["name"] for sp in doc["lineage"]] == ["run", "stream.append"]
    assert doc["lineage"][0]["stream"] == "caldot1/test1"
    assert doc["checkpoint"].endswith("ckpt.npz")
    assert os.path.exists(doc["checkpoint"])
    assert doc["extra"] == {"stream": "caldot1/test1", "frames": 8,
                            "chunk": 8, "requested_frames": 8}
    assert doc["metrics"]["stream.appends"] >= 1


# ---------------------------------------------------------------------------
# Ports of the socket-free tests of tests/test_obs_serve.py
# ---------------------------------------------------------------------------

def test_histogram_summary_has_interpolated_p99():
    h = Histogram()
    for i in range(1, 101):
        h.observe(float(i))
    s = h.summary()
    assert s["min"] == 1.0 and s["max"] == 100.0
    assert s["p50"] == pytest.approx(50.5)
    assert s["p99"] == pytest.approx(99.01)


def test_render_prometheus_kinds_labels_and_summaries():
    reg = Registry()
    reg.counter("stream.appends").inc(3)
    reg.gauge("store.bytes").set(12.5)
    reg.gauge("stream.watermark[caldot1/live0]").set(24.0)
    h = reg.histogram("query.scan_seconds")
    for v in (0.1, 0.2, 0.3, 0.4):
        h.observe(v)
    reg.provider("stream.drift[caldot1/live0]", lambda: {"watermarks": 2})
    text = render_prometheus(reg.snapshot())
    lines = text.splitlines()
    assert "# TYPE stream_appends counter" in lines
    assert "stream_appends 3" in lines
    assert "# TYPE store_bytes gauge" in lines
    assert "store_bytes 12.5" in lines
    assert 'stream_watermark{stream="caldot1/live0"} 24.0' in lines
    assert "# TYPE query_scan_seconds summary" in lines
    assert 'query_scan_seconds{quantile="0.50"} 0.25' in lines
    assert "query_scan_seconds_count 4" in lines
    assert any(ln.startswith("query_scan_seconds_sum") for ln in lines)
    assert "drift" not in text
    assert render_prometheus({}) == ""
    assert CONTENT_TYPE.startswith("text/plain; version=0.0.4")
    # the reference's exposition validator agrees it is well-formed
    assert validate_exposition(text) >= 6


def test_health_thresholds_ratio_and_absent():
    comps = default_components()
    assert {c.name for c in comps} == {"decode_pool", "broker_detect",
                                       "broker_track", "ingest_lag",
                                       "store_budget"}
    doc = health_report({}, comps)
    assert doc["status"] == "ok"
    assert all(c["status"] == "ok" and c["value"] is None
               for c in doc["components"].values())
    snap = {"broker.detect.queue_depth": 100.0,
            "stream.watermark_lag_seconds[a]": 1.0,
            "stream.watermark_lag_seconds[b]": 45.0,
            "store.bytes": 50.0, "store.budget_bytes": 100.0}
    doc = health_report(snap, comps)
    assert doc["components"]["broker_detect"]["status"] == "warn"
    assert doc["components"]["ingest_lag"]["status"] == "fail"
    assert doc["components"]["ingest_lag"]["value"] == 45.0
    assert doc["components"]["store_budget"]["value"] == 0.5
    assert doc["components"]["store_budget"]["status"] == "ok"
    assert doc["status"] == "fail"
    doc = health_report({"store.bytes": 50.0}, comps)
    assert doc["components"]["store_budget"]["value"] is None
    one = [HealthComponent("broker_detect", "broker.detect.queue_depth",
                           warn=10.0, fail=100.0)]
    assert health_report({"broker.detect.queue_depth": 500.0},
                         one)["status"] == "fail"


def test_slo_edges_warn_page_resolved(tmp_path):
    reg = Registry()
    rec = trec.FlightRecorder(str(tmp_path / "ring"))
    rule = AlertRule("append_latency", "stream.append.wall_seconds",
                     objective=1.0, quantile=0.95, budget=0.25,
                     min_samples=4)
    eng = SloEngine([rule], registry=reg, recorder=rec)
    h = reg.histogram("stream.append.wall_seconds")
    assert eng.tick() == []                      # under min_samples
    for _ in range(8):
        h.observe(0.5)
    assert eng.tick() == []
    assert eng.report()["rules"]["append_latency"]["state"] == "ok"
    h.observe(5.0)                               # p95 breaches, 1/9 bad
    fired = eng.tick()
    assert [e.severity for e in fired] == ["warn"]
    assert fired[0].value > 1.0
    assert eng.tick() == []                      # steady: no re-fire
    for _ in range(3):
        h.observe(5.0)                           # 4/12 bad: budget blown
    fired = eng.tick()
    assert [e.severity for e in fired] == ["page"]
    assert fired[0].budget_remaining <= 0.0
    h.reset()
    for _ in range(8):
        h.observe(0.1)
    assert [e.severity for e in eng.tick()] == ["resolved"]
    sev = [r["severity"] for r in rec.tail(50) if r["kind"] == "alert"]
    assert sev == ["warn", "page", "resolved"]
    assert [e.severity for e in eng.recent_events()] == \
        ["warn", "page", "resolved"]


def test_slo_gauge_rule_samples_instances_per_tick():
    reg = Registry()
    rule = AlertRule("ingest_watermark_lag",
                     "stream.watermark_lag_seconds[", objective=1.0,
                     quantile=0.5, budget=0.1, source="gauge", window=16,
                     min_samples=4)
    eng = SloEngine([rule], registry=reg)
    reg.gauge("stream.watermark_lag_seconds[a]").set(8.0)
    reg.gauge("stream.watermark_lag_seconds[b]").set(9.0)
    eng.tick()
    assert eng.report()["rules"]["ingest_watermark_lag"]["samples"] == 2
    assert [e.severity for e in eng.tick()] == ["page"]
    for g in "ab":
        reg.gauge(f"stream.watermark_lag_seconds[{g}]").set(0.01)
    for _ in range(10):
        eng.tick()
    assert eng.report()["rules"]["ingest_watermark_lag"]["state"] == "ok"
    assert [r.name for r in default_rules()] == [
        "ingest_watermark_lag", "append_latency", "query_latency"]


def test_ring_rotation_stays_bounded(tmp_path):
    rec = trec.FlightRecorder(str(tmp_path / "ring"), segment_records=10,
                              segments=3)
    for i in range(100):
        rec.record("probe", i=i)
    assert len(rec._ring_files()) <= 3
    tail = rec.tail(25)
    assert [r["i"] for r in tail] == list(range(75, 100))
    assert all(r["kind"] == "probe" for r in tail)


def test_poll_captures_span_and_metric_deltas_once(tmp_path):
    rec = trec.FlightRecorder(str(tmp_path / "ring"))
    reg, tr = Registry(), tobs.Tracer()
    tr.enable()
    reg.counter("stream.appends").inc(2)
    with tr.span("stream.append", "stream", stream="camA"):
        pass
    assert rec.poll(tr, reg) == {"spans": 1, "metrics": 1}
    assert rec.poll(tr, reg) == {"spans": 0, "metrics": 0}
    reg.counter("stream.appends").inc()
    with tr.span("query.run", "query"):
        pass
    assert rec.poll(tr, reg) == {"spans": 1, "metrics": 1}
    kinds = [r["kind"] for r in rec.tail(50)]
    assert kinds.count("span") == 2 and kinds.count("metrics") == 2


def test_crash_dump_lineage_and_nested_merge(tmp_path):
    rec = trec.FlightRecorder(str(tmp_path / "flight"))
    reg, tr = Registry(), tobs.Tracer()
    reg.counter("stream.appends").inc()
    tr.enable()
    try:
        with tr.span("run", "executor", stream="camA"):
            with tr.span("stream.append", "stream", stream="camA"):
                raise RuntimeError("boom")
    except RuntimeError as exc:
        p1 = rec.dump("executor.drain", exc, tracer=tr, registry=reg)
        p2 = rec.dump("stream.append", exc, checkpoint="camA/ckpt.npz",
                      extra={"stream": "camA"}, tracer=tr, registry=reg)
    assert p1 == p2 and rec.dumps() == [p1]
    with open(p1) as f:
        doc = json.load(f)
    assert doc["reasons"] == ["executor.drain", "stream.append"]
    assert doc["checkpoint"] == "camA/ckpt.npz"
    assert "boom" in doc["error"]["traceback"]
    assert [sp["name"] for sp in doc["lineage"]] == ["stream.append", "run"]
    assert doc["metrics"]["stream.appends"] == 1
    try:
        raise ValueError("other")
    except ValueError as exc:
        p3 = rec.dump("query.run", exc, tracer=tr, registry=reg)
    assert p3 != p1 and len(rec.dumps()) == 2


def test_crash_dump_of_a_new_exception_is_a_new_dump(tmp_path):
    """Each of 20 exceptions, each freed before the next is raised (so a
    later one may take an earlier one's ``id``), gets its own dump; the
    same object seen by a second hook merges into its dump."""
    rec = trec.FlightRecorder(str(tmp_path / "flight"))
    tr = tobs.Tracer()
    paths = []
    for k in range(20):
        try:
            raise RuntimeError(f"crash {k}")
        except RuntimeError as exc:
            paths.append(rec.dump("query.run", exc, tracer=tr,
                                  registry=Registry()))
            assert rec.dump("stream.append", exc, tracer=tr,
                            registry=Registry()) == paths[-1]
    assert len(set(paths)) == 20 and rec.dumps() == paths
    for k, path in enumerate(paths):
        with open(path) as f:
            doc = json.load(f)
        assert doc["error"]["message"] == f"crash {k}"
        assert doc["reasons"] == ["query.run", "stream.append"]


def test_crash_dump_module_hook_is_noop_without_recorder():
    trec.uninstall()
    assert trec.crash_dump("executor.drain", RuntimeError("x")) is None
    assert trec.active() is None


# ---------------------------------------------------------------------------
# The SLO engine, exposition and health against the reference's
# ---------------------------------------------------------------------------

def _slo_sequence(reg, eng, rng):
    """Ticks over one seeded sequence of append latencies and lag gauges;
    -> every tick's edges and the last report, without clock fields."""
    h = reg.histogram("stream.append.wall_seconds")
    edges = []
    for k in range(40):
        for _ in range(int(rng.integers(1, 5))):
            h.observe(float(rng.lognormal(0.0, 0.8)))
        if k % 5 == 0:
            reg.gauge(f"stream.watermark_lag_seconds[c{k % 3}]").set(
                float(rng.uniform(0, 8)))
        if k == 25:
            h.reset()
        edges.append([{f: v for f, v in e.to_dict().items() if f != "at"}
                      for e in eng.tick(now=float(k))])
    rep = eng.report()
    for e in rep["events"]:
        e.pop("at")
    return edges, rep


def test_slo_engine_fires_the_reference_edges():
    """The same observations through both packages' engines (the stock
    rules and a tight one): the same edges at the same ticks, with
    equal quantiles, bad fractions and budgets bit for bit."""
    out = {}
    for name, obs, rule_cls, eng_cls in (
            ("port", tobs, AlertRule, SloEngine),
            ("reference", jobs, JxAlertRule, JxSloEngine)):
        mod = tobs.slo if name == "port" else jobs.slo
        reg = obs.Registry()
        rules = mod.default_rules() + [rule_cls(
            "tight", "stream.append.wall_seconds", objective=1.5,
            quantile=0.9, budget=0.2, window=64)]
        out[name] = _slo_sequence(reg, eng_cls(rules, registry=reg),
                                  np.random.default_rng(11))
    assert out["port"] == out["reference"]
    assert any(out["port"][0])                   # some edge fired


def _snapshot_dict():
    """One registry snapshot of every value kind, from the port."""
    reg = Registry()
    rng = np.random.default_rng(2)
    reg.counter("executor.dispatch.detect").inc(17)
    reg.counter("broker.detect.units_in").inc(230)
    reg.gauge("executor.decode.queue_depth").set(70.0)
    reg.gauge("broker.detect.queue_depth").set(3.0)
    reg.gauge("broker.track.queue_depth").set(600.0)
    reg.gauge("store.bytes").set(95.0)
    reg.gauge("store.budget_bytes").set(100.0)
    for c in ("caldot1/test0", 'odd"name'):
        reg.gauge(f"stream.watermark_lag_seconds[{c}]").set(
            float(rng.uniform(0, 9)))
    for name in ("executor.stage.detect.wall_seconds",
                 "broker.detect.fill"):
        h = reg.histogram(name)
        for v in rng.uniform(0, 1, 37):
            h.observe(float(v))
    reg.histogram("query.scan_seconds")           # empty
    reg.provider("stream.drift[caldot1/test0]", lambda: {"watermarks": 4})
    return reg.snapshot()


def test_exposition_and_health_match_the_reference():
    snap = _snapshot_dict()
    assert render_prometheus(snap) == jx_render(snap)
    got, want = health_report(snap), jx_health_report(snap)
    got.pop("time"), want.pop("time")
    assert got == want
    assert {k: c["status"] for k, c in got["components"].items()} == {
        "decode_pool": "warn", "broker_detect": "ok", "broker_track": "fail",
        "ingest_lag": got["components"]["ingest_lag"]["status"],
        "store_budget": "warn"}
    assert validate_exposition(render_prometheus(snap)) > 0


def test_obs_loads_slo_and_serve_lazily():
    import importlib
    obs = importlib.import_module("repro_torch.obs")
    assert obs.slo.SloEngine is SloEngine
    assert obs.serve.render_prometheus is render_prometheus
    assert {"serve", "slo"} <= set(obs.__all__)
    with pytest.raises(AttributeError):
        obs.no_such_module
