"""The port's track store and query service (``repro_torch.query``)
against the JAX package's ``repro.query``, on the CPU at the reduced
configuration with 16-frame clips.

The host modules (index, ops, plan, ref) are held to the reference bit
for bit on seeded synthetic tracks.  The store's on-disk layout is
shared: a store the port's ``TrackStore.ingest`` writes is opened and
queried by the reference's ``TrackStore`` and ``QueryService`` with the
same packed arrays, summaries and answers, and the other way round; the
θ fingerprint is the reference's for equal fields.  The port's store
equals its own executor's output, re-ingests with zero detector calls,
prunes and evicts as the reference does, and its service answers as
the reference's on the same store.  The banks carry the reference's
seeded weights (``repro_torch.params``).  Every thread join has a
timeout.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.detector as jdet  # noqa: E402
import repro.core.pipeline as jpl  # noqa: E402
import repro.core.proxy as jproxy  # noqa: E402
import repro.core.tracker as jtrk  # noqa: E402
import repro.query as jq  # noqa: E402
import repro.query.index as jix  # noqa: E402
import repro.query.ref as jref  # noqa: E402
from repro.configs.multiscope import MULTISCOPE_PIPELINE as J_CFG  # noqa: E402
from repro.data.video_synth import make_clip as jx_make_clip  # noqa: E402

import repro_torch.core.detector as tdet  # noqa: E402
import repro_torch.core.executor as tex  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
import repro_torch.query as tq  # noqa: E402
import repro_torch.query.index as tix  # noqa: E402
import repro_torch.query.ref as tref  # noqa: E402
import repro_torch.query.store as tstore  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.data.video_synth import make_clip  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402

from test_torch_broker import (ARCH, BOX_ATOL, BOX_RTOL, SEED,  # noqa: E402
                               choose_params, port_bank, run_threads)

N_FRAMES = 16
N_CLIPS = 3


# ---------------------------------------------------------------------------
# Set-up shared with tests/test_torch_stream.py
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops run faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jx_params(params):
    """The reference's θ with the port θ's fields."""
    return jpl.PipelineParams(**{f.name: getattr(params, f.name)
                                 for f in dataclasses.fields(params)})


def build_setup(n_clips=N_CLIPS, n_frames=N_FRAMES, chunks=(1, 16)):
    """Both banks with the reference's seeded weights, the port's and
    the reference's clips, and θ from the port's scores (the thresholds
    a margin away from every one)."""
    cfg = J_CFG.reduced()
    jd = jdet.init_detector(ARCH, seed=SEED)
    jp = jproxy.init_proxy(cfg.proxy.cell, cfg.proxy.base_channels,
                           seed=SEED)
    jt = jtrk.init_tracker(cfg.tracker, seed=SEED)

    def np_tree(tree):
        return jax.tree.map(np.asarray, tree)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tbank = port_bank(
            bridge.detector_from_params(ARCH, np_tree(jd)),
            bridge.proxy_from_params(cfg.proxy.cell, cfg.proxy.base_channels,
                                     np_tree(jp)),
            bridge.tracker_from_params(cfg.tracker, np_tree(jt), "cpu"))
        clips = [make_clip("caldot1", "test", i, n_frames=n_frames)
                 for i in range(n_clips)]
        params, psig, dsc = choose_params(tbank, clips, chunks=chunks)
    finally:
        torch.set_num_threads(n)
    pres = cfg.proxy.resolutions[-1]
    jbank = jpl.ModelBank(
        cfg, {ARCH: jdet.Detector(ARCH, jd)},
        {pres: jproxy.ProxyModel(cfg.proxy.cell, cfg.proxy.base_channels,
                                 pres, params=jp)},
        tracker_params=jt, sizes_cells=tbank.sizes_cells,
        ref_grid=tbank.ref_grid, win_times=dict(tbank.win_times))
    jclips = [jx_make_clip("caldot1", "test", i, n_frames=n_frames)
              for i in range(n_clips)]
    return dict(tbank=tbank, jbank=jbank, clips=clips, jclips=jclips,
                params=params, psig=psig, dsc=dsc)


def summary_json(packed):
    """A packed clip's summary as plain JSON (comparable across the two
    packages' ``ClipSummary`` classes)."""
    return json.loads(json.dumps(packed.summary.to_json()))


def assert_packed_equal(a, b, timing=False):
    """Two packed clips (either package's) bit for bit: rows, offsets,
    index arrays, summary, counters, frame span; ``timing`` also holds
    the extraction seconds."""
    for k in ("rows", "offsets", "hist", "track_bbox"):
        x, y = getattr(a, k), getattr(b, k)
        assert type(x) is np.ndarray and type(y) is np.ndarray, k
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert summary_json(a) == summary_json(b)
    assert tuple(a.counters) == tuple(b.counters)
    assert a.n_frames == b.n_frames and a.fps == b.fps
    assert a.watermark == b.watermark
    if timing:
        assert a.seconds == b.seconds


def assert_packed_close(a, b):
    """Two packed clips with the same decisions (frames, ids, offsets,
    histograms, counters), boxes within the slice's tolerances."""
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.rows[:, [0, 5]], b.rows[:, [0, 5]])
    np.testing.assert_allclose(a.rows, b.rows, rtol=BOX_RTOL, atol=BOX_ATOL)
    np.testing.assert_array_equal(a.hist, b.hist)
    np.testing.assert_allclose(a.track_bbox, b.track_bbox, rtol=BOX_RTOL,
                               atol=BOX_ATOL)
    assert tuple(a.counters) == tuple(b.counters)
    assert a.n_frames == b.n_frames and a.watermark == b.watermark
    sa, sb = summary_json(a), summary_json(b)
    for k in ("n_rows", "n_tracks", "max_len", "min_frame", "max_frame",
              "max_count"):
        assert sa[k] == sb[k], k


def result_of(res):
    return (res.frames, res.aggregates, res.scanned_clips,
            res.skipped_clips, res.indexed_clips, res.n_clips)


@pytest.fixture(scope="module")
def setup():
    return build_setup()


# ---------------------------------------------------------------------------
# Host modules against the reference, on synthetic tracks
# ---------------------------------------------------------------------------

class _Profile:
    def __init__(self, name="caldot1", fps=8):
        self.name, self.fps = name, fps


class _Clip:
    def __init__(self, clip_id, n_frames, name="caldot1", fps=8):
        self.profile = _Profile(name, fps)
        self.split, self.clip_id, self.n_frames = "test", clip_id, n_frames


def synthetic_tracks(rng, n_tracks, n_frames, lo=-0.05, hi=1.05):
    """Seeded tracks: lengths 1-9, increasing frames, centers in
    [lo, hi] (past the frame's edges, where the grid clamps)."""
    out = []
    for tid in range(n_tracks):
        n = int(rng.integers(1, 10))
        frames = np.sort(rng.choice(n_frames, size=min(n, n_frames),
                                    replace=False))
        t = np.zeros((len(frames), 6), np.float32)
        t[:, 0] = frames
        t[:, 1:3] = rng.uniform(lo, hi, (len(frames), 2))
        t[:, 3:5] = rng.uniform(0.02, 0.2, (len(frames), 2))
        t[:, 5] = tid
        out.append(t)
    return out


def synthetic_fleet(seed=0):
    rng = np.random.default_rng(seed)
    clips, tracks = [], []
    for i, (n, lo, hi) in enumerate([(12, -0.05, 1.05), (0, 0, 1),
                                     (6, 0.6, 0.95), (9, 0.0, 0.4),
                                     (15, 0.0, 1.0)]):
        clips.append(_Clip(i, 40, fps=8 if i % 2 else 10))
        tracks.append(synthetic_tracks(rng, n, 40, lo, hi))
    return clips, tracks


@pytest.mark.parametrize("case", ["fleet", "empty", "one_row"])
def test_pack_round_trip_matches_the_reference(case):
    if case == "fleet":
        tracks = synthetic_tracks(np.random.default_rng(3), 10, 24)
    elif case == "empty":
        tracks = []
    else:
        tracks = [np.array([[5, 0.5, 0.5, 0.1, 0.1, 0]], np.float32)]
    clip = _Clip(0, 24)
    t, j = tq.PackedTracks.pack(tracks, clip), \
        jq.PackedTracks.pack(tracks, clip)
    assert_packed_equal(t, j, timing=True)
    assert t.rows.shape == (sum(map(len, tracks)), 6)
    for x, y in zip(tracks, t.tracks()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(t.row_track, j.row_track)
    np.testing.assert_array_equal(t.lengths, j.lengths)
    if case == "empty":
        assert t.n_tracks == 0 and t.summary.n_rows == 0
        assert t.summary.max_frame == -1


def test_index_and_summary_bit_for_bit():
    """``build_index``, ``summarize``, the occupancy grids and the
    region masks on seeded synthetic tracks; summaries round-trip
    through each other's JSON."""
    clips, fleet = synthetic_fleet(1)
    for clip, tracks in zip(clips, fleet):
        p = tq.PackedTracks.pack(tracks, clip, build=False)
        th, tb = tix.build_index(p.rows, p.offsets, p.n_frames)
        jh, jb = jix.build_index(p.rows, p.offsets, p.n_frames)
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_array_equal(tb, jb)
        assert th.dtype == jh.dtype and tb.dtype == jb.dtype
        ts = tix.summarize(p.rows, p.offsets, th, tb)
        js = jix.summarize(p.rows, p.offsets, jh, jb)
        assert ts.to_json() == js.to_json()
        assert tix.grids_from_rows(p.rows, p.offsets) == \
            jix.grids_from_rows(p.rows, p.offsets)
        assert jix.ClipSummary.from_json(json.loads(json.dumps(
            ts.to_json()))) == js
        assert tix.ClipSummary.from_json(json.loads(json.dumps(
            js.to_json()))) == ts
    rng = np.random.default_rng(2)
    for _ in range(50):
        x0, y0 = rng.uniform(-0.1, 1.0, 2)
        x1, y1 = x0 + rng.uniform(0, 0.6), y0 + rng.uniform(0, 0.6)
        assert tix.region_mask(x0, y0, x1, y1) == \
            jix.region_mask(x0, y0, x1, y1)
    assert tix.MIN_LEN_BUCKETS == jix.MIN_LEN_BUCKETS


def _queries(m):
    """The queries of tests/test_query.py and a grid over the algebra,
    built from module ``m`` (``repro.query`` or ``repro_torch.query``)."""
    qs = [
        m.Query((m.TrackFilter(min_len=2), m.Region(0.0, 0.0, 0.5, 0.5),
                 m.CountAtLeast(1)), aggregate="count"),
        m.Query((m.Region(0.6, 0.6, 1.0, 1.0),), aggregate="count"),
        m.Query((m.TimeRange(2, None),), aggregate="count"),
        m.Query((m.TrackFilter(min_len=3),), aggregate="count"),
        m.Query((m.TrackFilter(min_len=3),), aggregate="tracks"),
        m.Query((m.CountAtLeast(1),), limit=m.Limit(3, min_spacing=2)),
        m.Query((m.CountAtLeast(1),), aggregate="duration"),
        m.Query((m.Region(0.0, 0.0, 0.2, 0.2), m.Region(0.8, 0.8, 1.0, 1.0)),
                aggregate="count"),
        m.Query((m.TimeRange(0, 2), m.TimeRange(3, 5)), aggregate="count"),
        m.Query((m.CountAtLeast(1),), limit=m.Limit(2)),
        m.Query.count_frames(region=(0.45, 0.0, 0.55, 1.0), min_count=1),
        m.Query.limit_frames(region=(0.0, 0.5, 1.0, 1.0), want=8,
                             min_spacing=4),
        m.Query.count_tracks(region=(0.6, 0.6, 1.0, 1.0),
                             time_range=m.TimeRange(5, 20)),
        m.Query.duration(min_count=2).scoped("caldot1"),
    ]
    for mlen, k, agg in [(1, 1, "frames"), (2, 2, "count"), (4, 1, "count"),
                         (3, 1, "tracks"), (2, 4, "frames")]:
        qs.append(m.Query((m.TrackFilter(min_len=mlen), m.CountAtLeast(k),
                           m.TimeRange(5, 30)), aggregate=agg))
    return qs


def _oracle_kw(plan):
    kw = dict(min_len=plan.min_len, min_count=plan.min_count,
              aggregate=plan.aggregate)
    if plan.region is not None:
        kw["region"] = (plan.region.x0, plan.region.y0, plan.region.x1,
                        plan.region.y1)
    if plan.time_range is not None:
        kw["time_range"] = (plan.time_range.start, plan.time_range.end)
    if plan.limit is not None:
        kw["limit"] = (plan.limit.n, plan.limit.min_spacing)
    return kw


@pytest.mark.parametrize("use_index", [True, False])
def test_plans_match_the_reference_and_the_oracle(use_index):
    """Every query: the port's compiled plan equals the reference's on
    the same clips (frames, aggregates, scanned / skipped / indexed
    counts), and both equal the ported brute-force ``reference_query``
    and the reference's."""
    clips, fleet = synthetic_fleet(4)
    t_entries = [(c, tq.PackedTracks.pack(t, c)) for c, t in
                 zip(clips, fleet)]
    j_entries = [(c, jq.PackedTracks.pack(t, c)) for c, t in
                 zip(clips, fleet)]
    fps = [c.profile.fps for c in clips]
    for tquery, jquery in zip(_queries(tq), _queries(jq)):
        tplan, jplan = tq.compile_query(tquery), jq.compile_query(jquery)
        assert tplan.describe() == jplan.describe()
        got = tplan.run(t_entries, use_index=use_index)
        assert result_of(got) == \
            result_of(jplan.run(j_entries, use_index=use_index))
        if tplan.region is not None and np.isnan(tplan.region.x0):
            continue                    # the folded match-nothing region
        oracle = tref.reference_query(fleet, fps, **_oracle_kw(tplan))
        assert oracle == jref.reference_query(fleet, fps,
                                              **_oracle_kw(tplan))
        assert got.frames == oracle["frames"], tplan.describe()
        assert got.aggregates == oracle["aggregates"], tplan.describe()
    region, want, k, spacing = (0.0, 0.5, 1.0, 1.0), 6, 1, 3
    assert tref.reference_limit_scan(fleet, want, k, region, spacing) == \
        jref.reference_limit_scan(fleet, want, k, region, spacing)


def _errors(m):
    out = []
    for build in (lambda: m.Query(aggregate="nope"),
                  lambda: m.Query(("region",)),
                  lambda: m.Limit(0),
                  lambda: m.CountAtLeast(0),
                  lambda: m.Region(0.5, 0.0, 0.4, 1.0),
                  lambda: m.TimeRange(5, 2),
                  lambda: m.Query((m.CountAtLeast(1),), limit=m.Limit(3),
                                  aggregate="count"),
                  lambda: m.Query(datasets="caldot1"),
                  lambda: m.Query(datasets=("caldot1", 3))):
        with pytest.raises((ValueError, TypeError)) as err:
            build()
        out.append((err.type, str(err.value)))
    return out


def test_query_validation_errors_match_the_reference():
    assert _errors(tq) == _errors(jq)


def test_theta_fingerprint_parity(setup):
    """Equal θ fields give the reference's fingerprint (a store either
    package writes is found by the other); only ``chunk_size`` is
    scheduling-only."""
    p = setup["params"]
    variants = [p, dataclasses.replace(p, chunk_size=4),
                dataclasses.replace(p, gap=2),
                dataclasses.replace(p, tracker="sort"),
                dataclasses.replace(p, proxy_res=None),
                dataclasses.replace(p, refine=True),
                dataclasses.replace(p, det_conf=0.25, det_res=(64, 48)),
                tpl.PipelineParams("ssd-deep", (960, 544), 0.5)]
    fps = [tq.theta_fingerprint(v) for v in variants]
    assert fps == [jq.theta_fingerprint(jx_params(v)) for v in variants]
    assert fps[0] == fps[1] and len(set(fps[1:])) == len(fps) - 1
    assert tstore.SCHEMA_VERSION == 1
    assert tstore._SCHEDULING_ONLY == ("chunk_size",)


# ---------------------------------------------------------------------------
# The store: interop with the reference, and against the port's executor
# ---------------------------------------------------------------------------

def _cross_queries(m):
    return [m.Query.count_frames(min_count=1),
            m.Query.count_frames(region=(0.0, 0.5, 1.0, 1.0), min_count=2),
            m.Query.limit_frames(region=(0.0, 0.0, 1.0, 1.0), want=5,
                                 min_spacing=2),
            m.Query.count_tracks(min_track_len=2),
            m.Query.count_tracks(classes=(0, 1), min_track_len=2),
            m.Query.duration(min_count=1)]


def _assert_same_answers(tservice, tclips, jservice, jclips):
    for tquery, jquery in zip(_cross_queries(tq), _cross_queries(jq)):
        t = tservice.query(tquery, tclips)
        j = jservice.query(jquery, jclips)
        assert result_of(t) == result_of(j), tquery
        assert t.stats.ingested_clips == j.stats.ingested_clips == 0


def test_port_store_read_by_the_reference(setup, tmp_path):
    """The port's ingest writes; the reference's bank-less store opens
    it (index.json, NPZs) and its service answers as the port's."""
    s = setup
    root = str(tmp_path / "store")
    tst = tq.TrackStore(root, s["tbank"], s["params"])
    rep = tst.ingest(s["clips"])
    assert rep.ingested == len(s["clips"]) and rep.frames == \
        len(s["clips"]) * N_FRAMES
    jst = jq.TrackStore(root, None, jx_params(s["params"]))
    assert jst.fingerprint == tst.fingerprint
    for c, jc in zip(s["clips"], s["jclips"]):
        assert jst.has(jc)
        assert jst.summary(jc) == jix.ClipSummary.from_json(
            tst.summary(c).to_json())
        assert_packed_equal(tst.get(c), jst.get(jc), timing=True)
    assert jst.ingest(s["jclips"]).cached == len(s["clips"])
    with open(os.path.join(root, "caldot1", tst.fingerprint,
                           "meta.json")) as f:
        meta = json.load(f)
    assert meta["fingerprint"] == tst.fingerprint
    assert meta["theta"] == json.loads(json.dumps(
        jq.store._track_fields(jx_params(s["params"])), default=list))
    _assert_same_answers(tq.QueryService(tst), s["clips"],
                         jq.QueryService(jst), s["jclips"])


def test_reference_store_read_by_the_port(setup, tmp_path):
    """The reference's ingest (the JAX pipeline) writes; the port's
    bank-less store opens it, and the port's service answers as the
    reference's; the extracted tracks agree within the slice's
    tolerances with the port's own ingest."""
    s = setup
    root = str(tmp_path / "store")
    jst = jq.TrackStore(root, s["jbank"], jx_params(s["params"]))
    jst.ingest(s["jclips"])
    tst = tq.TrackStore(root, None, s["params"])
    assert tst.ingest(s["clips"]).cached == len(s["clips"])
    own = tq.TrackStore(str(tmp_path / "own"), s["tbank"], s["params"])
    own.ingest(s["clips"])
    for c, jc in zip(s["clips"], s["jclips"]):
        assert tst.has(c) and tst.watermark(c) == N_FRAMES
        assert tst.summary(c) == tix.ClipSummary.from_json(
            jst.summary(jc).to_json())
        assert_packed_equal(tst.get(c), jst.get(jc), timing=True)
        assert_packed_close(tst.get(c), own.get(c))
    _assert_same_answers(tq.QueryService(tst), s["clips"],
                         jq.QueryService(jst), s["jclips"])


def test_store_equals_its_own_executor_outputs(setup, tmp_path):
    """Each stored clip is ``PackedTracks.pack`` of that clip's own
    ``ClipExecutor`` run bit for bit (timing aside), as numpy float32
    arrays; a fresh store over the root reads it back."""
    s = setup
    root = str(tmp_path / "store")
    st = tq.TrackStore(root, s["tbank"], s["params"])
    st.ingest(s["clips"])
    again = tq.TrackStore(root, s["tbank"], s["params"])
    for c in s["clips"]:
        res = tex.ClipExecutor(s["tbank"], s["params"]).run(c)
        want = tq.PackedTracks.pack(res.tracks, c, res)
        assert_packed_equal(st.get(c), want)
        assert_packed_equal(again.get(c), want)
        assert st.get(c).rows.dtype == np.float32
        for got, t in zip(st.tracks(c), res.tracks):
            np.testing.assert_array_equal(got, t)


def test_reingest_makes_zero_detector_calls(setup, tmp_path, monkeypatch):
    s = setup
    root = str(tmp_path / "store")
    calls = []
    orig = tdet.Detector.detect_batch

    def counting(self, *args, **kwargs):
        calls.append(1)
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(tdet.Detector, "detect_batch", counting)
    st = tq.TrackStore(root, s["tbank"], s["params"])
    st.ingest(s["clips"][:2])
    assert calls
    calls.clear()
    rep = st.ingest(s["clips"][:2])
    assert rep.ingested == 0 and rep.cached == 2 and not calls
    fresh = tq.TrackStore(root, s["tbank"], s["params"])
    rep = fresh.ingest(s["clips"][:2])
    assert rep.ingested == 0 and not calls
    # chunk_size is scheduling-only: the same version, still warm
    fresh.set_params(dataclasses.replace(s["params"], chunk_size=4))
    assert fresh.ingest(s["clips"][:2]).ingested == 0 and not calls
    with pytest.raises(RuntimeError, match="no model bank"):
        tq.TrackStore(str(tmp_path / "none"), None,
                      s["params"]).ingest(s["clips"][:1])


def test_versioning_and_prune(setup, tmp_path):
    s = setup
    root = str(tmp_path / "store")
    st = tq.TrackStore(root, s["tbank"], s["params"])
    st.ingest(s["clips"][:1])
    old = st.fingerprint
    st.set_params(dataclasses.replace(s["params"], tracker="sort"))
    assert st.fingerprint != old and not st.has(s["clips"][0])
    assert st.get(s["clips"][0]) is None
    st.ingest(s["clips"][:1])
    assert st.prune() == [old]
    assert sorted(os.listdir(os.path.join(root, "caldot1"))) == \
        [st.fingerprint]
    assert tq.TrackStore(str(tmp_path / "missing"), None,
                         s["params"]).prune() == []


def test_budget_eviction_keeps_summaries(setup, tmp_path):
    """LRU eviction to a byte budget: evicted clips keep their summary
    (and skip without re-ingest), re-ingest bit for bit on the next
    touch, and count in the store's and the registry's counters; the
    batch being ingested is never evicted by its own ingest."""
    s = setup
    st = tq.TrackStore(str(tmp_path / "store"), s["tbank"], s["params"])
    st.ingest(s["clips"])
    before = {id(c): st.get(c) for c in s["clips"]}
    m0 = REGISTRY.counter("store.evictions").value
    n = st.set_budget(tq.StoreBudget(max_bytes=1))
    assert n == len(s["clips"]) == st.evictions
    assert REGISTRY.counter("store.evictions").value - m0 == n
    assert st.disk_bytes() == 0
    for c in s["clips"]:
        assert not st.has(c) and st.summary(c) is not None
    skip = tq.Query.count_frames(region=(0.0, 0.0, 0.001, 0.001))
    res = tq.QueryService(st).query(skip, s["clips"])
    assert res.stats.ingested_clips == 0
    rep = st.ingest(s["clips"][:1])           # protected: stays
    assert rep.ingested == 1 and rep.evicted == 0 and st.has(s["clips"][0])
    assert_packed_equal(st.get(s["clips"][0]), before[id(s["clips"][0])])
    st.set_budget(tq.StoreBudget(ttl_seconds=-1.0))
    assert not st.has(s["clips"][0])
    st.set_budget(None)


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def warm(setup, tmp_path_factory):
    """A warm store over the setup's clips, the reference's store over
    the same root, and each package's service."""
    root = str(tmp_path_factory.mktemp("warm"))
    st = tq.TrackStore(root, setup["tbank"], setup["params"])
    st.ingest(setup["clips"])
    jst = jq.TrackStore(root, None, jx_params(setup["params"]))
    return st, jst


def test_service_aggregates_and_limits_match(setup, warm):
    st, jst = warm
    clips, fps = setup["clips"], [8] * N_CLIPS
    tsvc, jsvc = tq.QueryService(st), jq.QueryService(jst)
    all_tracks = [st.tracks(c) for c in clips]
    for tquery, jquery in zip(_queries(tq), _queries(jq)):
        got = tsvc.query(tquery, clips)
        assert result_of(got) == result_of(jsvc.query(jquery,
                                                      setup["jclips"]))
        plan = tq.compile_query(tquery)
        if plan.region is None or not np.isnan(plan.region.x0):
            fps = [c.profile.fps for c in clips]
            want = tref.reference_query(all_tracks, fps, **_oracle_kw(plan))
            assert got.frames == want["frames"]
            assert got.aggregates == want["aggregates"]
    assert tsvc.latency_report()["queries"] == len(_queries(tq))
    keys = set(tsvc.latency_report()) - {"datasets"}
    assert keys == set(jsvc.latency_report()) - {"datasets"}


def test_service_class_partition(setup, warm):
    st, _ = warm
    svc, clips = tq.QueryService(st), setup["clips"]
    total = svc.query(tq.Query.count_tracks(min_track_len=2), clips) \
        .aggregates["tracks"]
    parts = sum(svc.query(tq.Query.count_tracks(classes=(c,),
                                                min_track_len=2),
                          clips).aggregates["tracks"]
                for c in list(range(clips[0].profile.patterns())) + [-1])
    assert parts == total > 0


def test_service_concurrent_queries_agree(setup, warm):
    st, _ = warm
    svc, clips = tq.QueryService(st), setup["clips"]
    q = tq.Query.limit_frames(region=(0.0, 0.5, 1.0, 1.0), want=6,
                              min_spacing=2)
    expected = svc.query(q, clips).frames
    got = run_threads([lambda: [svc.query(q, clips).frames
                                for _ in range(5)]] * 4)
    assert all(r == expected for rs in got for r in rs)
    rep = svc.latency_report()
    assert rep["queries"] == 21 and rep["warm_queries"] == 21


def test_service_warm_query_bypasses_the_ingest_lock(setup, warm):
    st, _ = warm
    svc, clips = tq.QueryService(st), setup["clips"]
    q = tq.Query.count_frames(min_count=1)
    expected = svc.query(q, clips).aggregates
    with svc._ingest_lock:          # an ingest in flight
        assert run_threads([lambda: svc.query(q, clips).aggregates],
                           timeout=10.0) == [expected]


def test_service_cold_then_warm(setup, tmp_path):
    s = setup
    svc = tq.QueryService(tq.TrackStore(str(tmp_path / "cold"), s["tbank"],
                                        s["params"]))
    q = tq.Query.count_frames(min_count=1)
    cold = svc.query(q, s["clips"][:2])
    assert cold.stats.ingested_clips == 2 and cold.stats.ingest_seconds > 0
    warm_res = svc.query(q, s["clips"][:2])
    assert warm_res.stats.ingested_clips == 0
    assert warm_res.aggregates == cold.aggregates
    th = svc.prefetch(s["clips"])
    th.join(60.0)
    assert not th.is_alive()
    assert svc.query(q, s["clips"]).stats.ingested_clips == 0


def test_prefetch_order_matches_the_reference(setup, warm):
    """Never-materialized clips first, then unskippable ones by falling
    row count, summary-skippable ones last: the reference's order on
    the same store."""
    st, jst = warm
    tsvc, jsvc = tq.QueryService(st), jq.QueryService(jst)
    c, jc = setup["clips"], setup["jclips"]
    mixed = [c[0], make_clip("caldot1", "test", 97, n_frames=N_FRAMES),
             c[1], c[2]]
    jmixed = [jc[0], jx_make_clip("caldot1", "test", 97,
                                  n_frames=N_FRAMES), jc[1], jc[2]]
    for tquery, jquery in [(None, None),
                           (tq.Query.count_frames(
                               region=(0.0, 0.0, 0.02, 0.02)),
                            jq.Query.count_frames(
                                region=(0.0, 0.0, 0.02, 0.02))),
                           (tq.Query.count_frames(min_count=3),
                            jq.Query.count_frames(min_count=3))]:
        order = tsvc._prefetch_order(
            mixed, None if tquery is None else tq.compile_query(tquery))
        jorder = jsvc._prefetch_order(
            jmixed, None if jquery is None else jq.compile_query(jquery))
        assert [x.clip_id for x in order] == [x.clip_id for x in jorder]
        assert order[0].clip_id == 97
    th = tsvc.prefetch([c[0]], q=tq.Query.count_frames())
    th.join(60.0)
    assert not th.is_alive()


def test_service_over_a_store_mapping(setup, warm):
    """A ``{dataset: store}`` service routes by the clip's dataset and
    keeps the caller's clip indices; an unknown dataset raises."""
    st, _ = warm
    svc = tq.QueryService({"caldot1": st})
    q = tq.Query.count_frames(min_count=1)
    assert result_of(svc.query(q, setup["clips"])) == \
        result_of(tq.QueryService(st).query(q, setup["clips"]))
    other = make_clip("uav", "test", 0, n_frames=N_FRAMES)
    with pytest.raises(KeyError, match="no store"):
        svc.query(q, [other])
    with pytest.raises(TypeError):
        tq.QueryService([st])
