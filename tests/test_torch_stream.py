"""The port's live ingest (``repro_torch.stream``) on the CPU, at the
reduced configuration with 16-frame clips, against its own one-shot
ingest and against the JAX package's ``repro.stream``.

A segment append changes the chunks, and with them the batches the
conv nets see.  The port's CPU detector and crop CNN move by up to one
f32 ulp with their batch, so a clip appended in segments equals the
one-shot ingest bit for bit under a bank made batch-invariant by
construction (``rowwise``: every row through each net at batch one),
and under the real nets for segments that are whole chunks at gap 1;
otherwise it is held to the slice's tolerances, with θ's thresholds a
margin away from every score.  The port is held to the reference at
the same segment size within those tolerances (never to the
reference's own append-against-one-shot equality).  Checkpoints and
stores carry over between the two packages both ways.  Standing
queries are held exactly to the ad-hoc answer at every watermark.
Every test that enables the tracer or drift, or installs a recorder,
undoes it in a ``finally``; every thread join has a timeout.
"""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.sort as jsort  # noqa: E402
import repro.core.tracker as jtrk  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.query as jq  # noqa: E402
import repro.query.ref as jref  # noqa: E402
import repro.stream as jstream  # noqa: E402

import repro_torch.core.detector as tdet  # noqa: E402
import repro_torch.core.executor as tex  # noqa: E402
import repro_torch.core.sort as tsort  # noqa: E402
import repro_torch.core.tracker as ttrk  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.obs.recorder as trec  # noqa: E402
import repro_torch.query as tq  # noqa: E402
import repro_torch.query.ref as tref  # noqa: E402
import repro_torch.stream as tstream  # noqa: E402
from repro_torch.query.index import build_index, summarize  # noqa: E402
from repro_torch.stream.ingest import CKPT_SUFFIX  # noqa: E402

from test_torch_broker import MARGIN, margin, run_threads  # noqa: E402
from test_torch_query import (N_FRAMES, assert_packed_close,  # noqa: E402
                              assert_packed_equal, build_setup, jx_params,
                              result_of)

SEGS = (1, 7, 12, N_FRAMES)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops run faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Rowwise(torch.nn.Module):
    """A net that runs each row at batch one: its outputs cannot depend
    on the batch a row rides in."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return torch.cat([self.net(x[i:i + 1]) for i in range(x.shape[0])])


def rowwise(bank):
    """``bank`` with its detector and crop CNN batch-invariant."""
    dets = {a: tdet.Detector(a, net=_Rowwise(d.net), device="cpu")
            for a, d in bank.detectors.items()}
    tp = dict(bank.tracker_params, crop_cnn=_Rowwise(
        bank.tracker_params["crop_cnn"]))
    return dataclasses.replace(bank, detectors=dets, tracker_params=tp)


@pytest.fixture(scope="module")
def setup():
    s = build_setup(chunks=(1, 4, 16))
    s["rbank"] = rowwise(s["tbank"])
    s["thetas"] = {
        "sort": dataclasses.replace(s["params"], tracker="sort", gap=1),
        "recurrent": dataclasses.replace(s["params"], gap=2),
    }
    return s


def one_shot(bank, params, clip, root, options=None):
    st = tq.TrackStore(str(root), bank, params, options)
    st.ingest([clip])
    return st.get(clip)


def assert_index_matches_rebuild(packed):
    hist, bbox = build_index(packed.rows, packed.offsets, packed.n_frames)
    np.testing.assert_array_equal(packed.hist, hist)
    np.testing.assert_array_equal(packed.track_bbox, bbox)
    assert packed.summary == summarize(packed.rows, packed.offsets, hist,
                                       bbox)


def live(bank, params, clip, seg, root, service=None, options=None,
         check=True):
    """Append ``clip`` in segments of ``seg`` frames until sealed; ->
    (store, reports, the packed clip at each watermark)."""
    st = tq.TrackStore(str(root), bank, params)
    ing = tstream.SegmentIngestor(st, service=service, options=options)
    assert ing.open(clip) == 0
    reports, seen = [], []
    while True:
        rep = ing.append(clip, seg)
        reports.append(rep)
        packed = st.get(clip)
        seen.append(packed)
        assert packed.n_frames == rep.watermark == st.watermark(clip)
        assert (packed.watermark is None) == rep.sealed
        if check:
            assert_index_matches_rebuild(packed)
        if rep.sealed:
            return st, reports, seen


# ---------------------------------------------------------------------------
# Segment append against one-shot ingest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", ["sort", "recurrent"])
@pytest.mark.parametrize("seg", SEGS)
def test_segment_append_bit_identical_when_batch_invariant(setup, tmp_path,
                                                           theta, seg):
    """Any segment split seals bit for bit to the one-shot ingest, and
    at every watermark the merged index equals a full rebuild.  At gap 2
    a segment of one frame that falls between strides runs nothing,
    still advances the watermark and reports a zero stage block."""
    s = setup
    params, clip = s["thetas"][theta], s["clips"][0]
    ref = one_shot(s["rbank"], params, clip, tmp_path / "batch")
    _, reports, _ = live(s["rbank"], params, clip, seg, tmp_path / "live")
    st = tq.TrackStore(str(tmp_path / "live"), None, params)
    assert_packed_equal(st.get(clip), ref)
    assert sum(r.appended for r in reports) == N_FRAMES
    assert sum(r.frames_processed for r in reports) == \
        len(range(0, N_FRAMES, params.gap))
    idle = [r for r in reports if r.frames_processed == 0]
    assert bool(idle) == (seg == 1 and params.gap == 2)
    for r in idle:
        assert r.stage_seconds == tobs.empty_stage_block(tex.STAGES)
        assert r.dispatches == {"proxy": 0, "detect": 0, "track": 0}
        assert r.rows_delivered == 0


@pytest.mark.parametrize("theta,seg", [("sort", 5), ("recurrent", 7),
                                       ("recurrent", 3)])
def test_segment_append_within_tolerances(setup, tmp_path, theta, seg):
    """The real nets: the segments' batches move scores by at most an
    ulp, the thresholds sit a margin away, so the decisions are the
    one-shot's and the boxes within the slice's tolerances."""
    s = setup
    assert margin(s["psig"], s["params"].proxy_threshold) > MARGIN
    assert margin(s["dsc"], s["params"].det_conf) > MARGIN
    params, clip = s["thetas"][theta], s["clips"][1]
    ref = one_shot(s["tbank"], params, clip, tmp_path / "batch")
    st, _, _ = live(s["tbank"], params, clip, seg, tmp_path / "live")
    assert_packed_close(st.get(clip), ref)


@pytest.mark.parametrize("seg", [4, 8])
def test_whole_chunk_segments_bit_identical(setup, tmp_path, seg):
    """Segments of whole chunks at gap 1 leave every chunk as it was:
    bit for bit under the real nets."""
    s = setup
    params = dataclasses.replace(s["thetas"]["recurrent"], gap=1,
                                 chunk_size=4)
    clip = s["clips"][2]
    ref = one_shot(s["tbank"], params, clip, tmp_path / "batch")
    st, reports, _ = live(s["tbank"], params, clip, seg, tmp_path / "live")
    assert_packed_equal(st.get(clip), ref)
    assert [r.dispatches["detect"] > 0 for r in reports] == \
        [True] * len(reports)


def test_seal_appends_the_rest(setup, tmp_path):
    s = setup
    params, clip = s["thetas"]["sort"], s["clips"][1]
    ref = one_shot(s["rbank"], params, clip, tmp_path / "batch")
    ing = tstream.SegmentIngestor(tq.TrackStore(str(tmp_path / "live"),
                                                s["rbank"], params))
    ing.open(clip)
    ing.append(clip, 5)
    assert_packed_equal(ing.seal(clip), ref)
    assert_packed_equal(ing.seal(clip), ref)       # idempotent
    with pytest.raises(ValueError, match="monotone"):
        ing.append(clip, -1)


# ---------------------------------------------------------------------------
# The port against the reference, and the registry
# ---------------------------------------------------------------------------

SEG_PAIRED = 7
METRIC_PREFIXES = ("stream.", "query.", "store.", "standing.")


def _fresh_registry(obs, modules):
    """Point every module of the live path at a fresh ``Registry``;
    -> (it, a function that puts the old one back)."""
    fresh, old = obs.Registry(), obs.REGISTRY
    targets = [obs.metrics] + list(modules)
    for m in targets:
        m.REGISTRY = fresh
    return fresh, lambda: [setattr(m, "REGISTRY", old) for m in targets]


def _paired_run(m_q, m_stream, bank, params, clips, root):
    """One live sequence: a service with two standing queries, clips
    0-1 opened and appended in turns in segments of ``SEG_PAIRED``, an
    ad-hoc query after each round, the sealed store re-queried; ->
    (reports, packed clips by watermark, standing and ad-hoc answers)."""
    st = m_q.TrackStore(str(root), bank, params)
    svc = m_q.QueryService(st)
    sqs = [svc.register_standing(m_stream.StandingQuery(q, clips))
           for q in (m_q.Query.count_frames(min_count=1),
                     m_q.Query.count_tracks(region=(0.0, 0.0, 1.0, 0.6),
                                            min_track_len=2))]
    ing = m_stream.SegmentIngestor(st, service=svc)
    for c in clips:
        ing.open(c)
    reports, packs, answers = [], [], []
    done = set()
    while len(done) < len(clips):
        for i, c in enumerate(clips):
            if i in done:
                continue
            rep = ing.append(c, SEG_PAIRED)
            reports.append(rep)
            packs.append(st.get(c))
            if rep.sealed:
                done.add(i)
        answers.append([result_of(sq.result()) for sq in sqs] + [
            result_of(svc.query(m_q.Query.count_frames(min_count=2),
                                clips))])
    return reports, packs, answers


@pytest.fixture(scope="module")
def paired(setup, tmp_path_factory):
    """The same live sequence in the port and in the reference (drift
    monitoring on in both), each package's metrics in a fresh registry;
    -> name -> (reports, packed clips, answers, live-path metrics)."""
    s = setup
    params = s["thetas"]["recurrent"]
    out = {}
    for name, m_q, m_stream, obs, bank, p, clips in [
            ("port", tq, tstream, tobs, s["tbank"], params, s["clips"][:2]),
            ("reference", jq, jstream, jobs, s["jbank"], jx_params(params),
             s["jclips"][:2])]:
        reg, restore = _fresh_registry(
            obs, (m_q.service, m_stream.ingest))
        obs.enable_drift()
        try:
            run = _paired_run(m_q, m_stream, bank, p, clips,
                              tmp_path_factory.mktemp(name))
        finally:
            obs.disable_drift()
            restore()
        out[name] = run + ({k: v for k, v in reg.snapshot().items()
                            if k.startswith(METRIC_PREFIXES)},)
    return out


def test_live_port_matches_the_reference_at_the_same_segments(paired):
    """At every append: the same watermark, frames run, rows delivered
    and counters, tracks within the slice's tolerances; standing and
    ad-hoc answers and drift summaries equal."""
    t_reps, t_packs, t_ans = paired["port"][:3]
    j_reps, j_packs, j_ans = paired["reference"][:3]
    assert len(t_reps) == len(j_reps)
    for t, j in zip(t_reps, j_reps):
        for k in ("key", "watermark", "appended", "frames_processed",
                  "rows_total", "rows_delivered", "sealed"):
            assert getattr(t, k) == getattr(j, k), k
        assert set(t.stage_seconds) == set(j.stage_seconds)
        assert t.dispatches["detect"] == j.dispatches["detect"]
        assert t.drift == j.drift and t.drift["watermarks"] > 0
        assert [td.track_id for td in t.delta.tracks] == \
            [td.track_id for td in j.delta.tracks]
    for t, j in zip(t_packs, j_packs):
        assert_packed_close(t, j)
    assert t_ans == j_ans


def test_registry_names_match_the_reference(paired):
    """The live path's metrics (stream, query, store, standing), each
    package's in a fresh registry: the same names after the same
    sequence, counters and histogram counts equal, the watermark gauges
    at the clips' lengths."""
    deltas = {}
    for name in ("port", "reference"):
        d = {}
        for k, v in paired[name][3].items():
            if k.startswith("stream.drift["):
                d[k] = v["watermarks"]
            elif isinstance(v, dict):
                d[k] = v["count"]
            elif isinstance(v, int) or k.startswith("stream.watermark["):
                d[k] = v
            else:
                d[k] = "gauge"
        deltas[name] = d
    assert deltas["port"] == deltas["reference"]
    d = deltas["port"]
    assert d["stream.appends"] == 6 and d["query.count"] == 3
    assert d["stream.watermark[caldot1/test0]"] == N_FRAMES
    assert d["standing.rows_scanned"] > 0
    assert "store.evictions" in d and "query.clips.scanned" in d


# ---------------------------------------------------------------------------
# Checkpoints: the reference's arrays, resumed both ways
# ---------------------------------------------------------------------------

def _tracks(cls, rng, n, h_dim=None):
    out = []
    for tid in range(n):
        k = int(rng.integers(1, 5))
        frames = sorted(int(f) for f in rng.choice(30, k, replace=False))
        boxes = [rng.uniform(0, 1, 4).astype(np.float32) for _ in frames]
        if h_dim is None:
            out.append(cls(tid, frames, boxes, int(rng.integers(0, 3))))
        else:
            out.append(cls(tid, rng.normal(size=h_dim).astype(np.float32),
                           frames, boxes, int(rng.integers(0, 3))))
    return out


def _equal_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["sort", "recurrent"])
def test_checkpoint_arrays_equal_the_reference(setup, kind):
    """One tracker state, built alike in both packages: ``capture`` then
    ``to_arrays`` gives the same NPZ arrays key by key, bit for bit, and
    each package restores the other's to the same visible tracks."""
    s = setup
    trackers = {}
    for name, sort_m, trk_m, bank in [("port", tsort, ttrk, s["tbank"]),
                                      ("reference", jsort, jtrk,
                                       s["jbank"])]:
        rng = np.random.default_rng(7)
        if kind == "sort":
            tr = sort_m.SortTracker()
            tr.finished = _tracks(sort_m.Track, rng, 3)
            tr.active = _tracks(sort_m.Track, rng, 4)
        else:
            cfg = bank.cfg.tracker
            tr = trk_m.RecurrentTracker(cfg, bank.tracker_params)
            tr.finished = _tracks(trk_m._ActiveTrack, rng, 2, cfg.rnn_dim)
            tr.active = _tracks(trk_m._ActiveTrack, rng, 5, cfg.rnn_dim)
            tr._last_frame = 29
        tr._next_id = 9
        trackers[name] = tr
    arrays = {
        name: (tstream.TrackerCheckpoint if name == "port"
               else jstream.TrackerCheckpoint).capture(
            tr, cursor=30, watermark=29, counters=(15, 20, 3, 2),
            seconds=0.25).to_arrays()
        for name, tr in trackers.items()}
    _equal_arrays(arrays["port"], arrays["reference"])
    jrest = jstream.TrackerCheckpoint.from_arrays(arrays["port"]).restore(
        s["jbank"], jx_params(s["params"]))
    trest = tstream.TrackerCheckpoint.from_arrays(
        arrays["reference"]).restore(s["tbank"], s["params"])
    for x, y in zip(jrest.result(), trest.result()):
        np.testing.assert_array_equal(x, y)
    assert len(trest.result()) == len(trackers["port"].result()) > 0


def test_checkpoint_files_carry_over(setup, tmp_path):
    """A live stream's sidecar: the port's file loads in the reference
    (and back) to the same arrays; ``save``/``load`` round-trip."""
    s = setup
    params, clip = s["thetas"]["recurrent"], s["clips"][0]
    st = tq.TrackStore(str(tmp_path / "s"), s["tbank"], params)
    ing = tstream.SegmentIngestor(st, checkpoint_every=0)
    ing.open(clip)
    ing.append(clip, 9)
    path = ing.checkpoint(clip)
    assert path == st.sidecar_path(clip, CKPT_SUFFIX)
    ours = tstream.TrackerCheckpoint.load(path)
    theirs = jstream.TrackerCheckpoint.load(path)
    _equal_arrays(ours.to_arrays(), theirs.to_arrays())
    assert (ours.kind, ours.cursor, ours.watermark, ours.counters) == \
        ("recurrent", 10, 9, theirs.counters)
    back = str(tmp_path / "back.npz")
    theirs.save(back)
    _equal_arrays(tstream.TrackerCheckpoint.load(back).to_arrays(),
                  ours.to_arrays())
    for a, b in zip(ours.restore(s["tbank"], params).result(),
                    ing._open[tq.store.clip_key(clip)].tracker.result()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_cross_resume(setup, tmp_path, first):
    """One package ingests 7 frames and checkpoints; the other opens the
    store where it stands, resumes at the checkpoint and seals.  The
    sealed clip holds the one-shot ingest's decisions, boxes within the
    slice's tolerances."""
    s = setup
    params, clip, jclip = s["thetas"]["recurrent"], s["clips"][1], \
        s["jclips"][1]
    root = str(tmp_path / "live")
    ref = one_shot(s["tbank"], params, clip, tmp_path / "batch")
    stores = {
        "port": lambda: tq.TrackStore(root, s["tbank"], params),
        "reference": lambda: jq.TrackStore(root, s["jbank"],
                                           jx_params(params))}
    ingestors = {"port": tstream.SegmentIngestor,
                 "reference": jstream.SegmentIngestor}
    clips = {"port": clip, "reference": jclip}
    second = "port" if first == "reference" else "reference"
    a = ingestors[first](stores[first]())
    a.open(clips[first])
    a.append(clips[first], 7)
    st = stores[second]()
    b = ingestors[second](st)
    assert b.open(clips[second]) == 7
    b.append(clips[second], 4)
    sealed = b.seal(clips[second])
    assert sealed.watermark is None and sealed.n_frames == N_FRAMES
    assert not os.path.exists(st.sidecar_path(clips[second], CKPT_SUFFIX))
    assert_packed_close(sealed, ref)


def test_rollback_to_a_stale_checkpoint(setup, tmp_path):
    """checkpoint_every=2 leaves the store an append ahead of the
    sidecar; a new ingestor rolls back to the checkpoint, the rolled
    back store equals a rebuild, and the clip still seals bit for bit."""
    s = setup
    params, clip = s["thetas"]["recurrent"], s["clips"][2]
    ref = one_shot(s["rbank"], params, clip, tmp_path / "batch")
    root = str(tmp_path / "live")
    first = tstream.SegmentIngestor(tq.TrackStore(root, s["rbank"], params),
                                    checkpoint_every=2)
    first.open(clip)
    for _ in range(3):
        first.append(clip, 5)                   # checkpoint at 10
    st = tq.TrackStore(root, s["rbank"], params)
    assert st.get(clip).watermark == 15
    second = tstream.SegmentIngestor(st)
    assert second.open(clip) == 10 and st.watermark(clip) == 10
    assert_index_matches_rebuild(st.get(clip))
    while st.watermark(clip) < N_FRAMES:
        second.append(clip, 5)
    assert_packed_equal(st.get(clip), ref)


@pytest.mark.parametrize("first,then", [
    ("device_tracker", "host"), ("host", "device_tracker"),
    ("host", "device_assign"), ("device_assign", "device_tracker")])
def test_device_tracker_ingest_and_resume(setup, tmp_path, first, then):
    """TRACK on the device (plain versions here) seals bit for bit to
    the host one-shot ingest, whole and resumed under another flavour;
    the checkpoint reads host numpy only, and a resumed tracker's
    segments report their own track dispatches."""
    s = setup
    params = dataclasses.replace(s["thetas"]["recurrent"], gap=1,
                                 chunk_size=4)
    clip = s["clips"][0]
    flags = {"host": {}, "device_tracker": {"device_tracker": True},
             "device_assign": {"device_assign": True}}
    ref_st = tq.TrackStore(str(tmp_path / "batch"), s["tbank"], params)
    ref_st.ingest([clip])
    ref = ref_st.get(clip)
    opts = tex.ExecutorOptions(**flags[first])
    whole, _, _ = live(s["tbank"], params, clip, 8, tmp_path / "whole",
                       options=opts)
    assert_packed_equal(whole.get(clip), ref)
    root = str(tmp_path / "resume")
    a = tstream.SegmentIngestor(tq.TrackStore(root, s["tbank"], params),
                                options=opts)
    a.open(clip)
    r1 = a.append(clip, 8)
    tr = a._open[tq.store.clip_key(clip)].tracker
    assert all(type(t.h) is np.ndarray for t in tr.active + tr.finished)
    st = tq.TrackStore(root, s["tbank"], params)
    b = tstream.SegmentIngestor(st, options=tex.ExecutorOptions(
        **flags[then]))
    assert b.open(clip) == 8
    tr = b._open[tq.store.clip_key(clip)].tracker
    assert type(tr) is (ttrk.DeviceTracker if then == "device_tracker"
                        else ttrk.RecurrentTracker)
    assert tr.assign == ("host" if then == "host" else "device")
    r2 = b.append(clip, 8)
    assert r2.sealed
    assert_packed_equal(st.get(clip), ref)
    one = tex.ClipExecutor(s["tbank"], params, tex.ExecutorOptions(
        **flags[then])).run(clip)
    assert r2.dispatches["track"] * 2 == one.dispatches["track"]
    assert r1.dispatches["track"] > 0


# ---------------------------------------------------------------------------
# Guard rails
# ---------------------------------------------------------------------------

def test_ingestor_rejects_refine_and_a_bankless_store(setup, tmp_path):
    s = setup
    params = dataclasses.replace(s["thetas"]["sort"], refine=True)
    with pytest.raises(ValueError, match="refine"):
        tstream.SegmentIngestor(tq.TrackStore(str(tmp_path / "r"),
                                              s["tbank"], params))
    with pytest.raises(ValueError, match="model bank"):
        tstream.SegmentIngestor(tq.TrackStore(str(tmp_path / "b"), None,
                                              s["thetas"]["sort"]))


def test_open_requires_open_state(setup, tmp_path):
    s = setup
    params, clips = s["thetas"]["sort"], s["clips"]
    root = str(tmp_path / "g")
    st = tq.TrackStore(root, s["tbank"], params)
    ing = tstream.SegmentIngestor(st)
    with pytest.raises(KeyError, match="not open"):
        ing.append(clips[0], 8)
    st.ingest([clips[0]])
    with pytest.raises(RuntimeError, match="fully materialized"):
        ing.open(clips[0])
    ing.open(clips[1])
    ing.append(clips[1], 8)
    os.remove(st.sidecar_path(clips[1], CKPT_SUFFIX))
    with pytest.raises(RuntimeError, match="no tracker checkpoint"):
        tstream.SegmentIngestor(tq.TrackStore(root, s["tbank"],
                                              params)).open(clips[1])
    ing.checkpoint(clips[1])
    ing.append(clips[1], 4)
    ing.checkpoint(clips[1])               # sidecar at 12
    st.materialize_packed(clips[1], dataclasses.replace(
        st.get(clips[1]), watermark=10))   # store behind it
    with pytest.raises(RuntimeError, match="AHEAD"):
        tstream.SegmentIngestor(tq.TrackStore(root, s["tbank"],
                                              params)).open(clips[1])


def test_open_clip_never_evicted(setup, tmp_path):
    s = setup
    params, clips = s["thetas"]["sort"], s["clips"]
    st = tq.TrackStore(str(tmp_path / "e"), s["tbank"], params)
    ing = tstream.SegmentIngestor(st)
    ing.open(clips[0])
    ing.append(clips[0], 8)
    st.ingest([clips[1]])
    assert st.set_budget(tq.StoreBudget(max_bytes=1)) == 1
    assert st.get(clips[0]) is not None and st.watermark(clips[0]) == 8
    assert st.ingest([clips[0]]).cached == 1     # open counts as cached
    st.set_budget(None)


def test_append_failure_writes_a_crash_dump(setup, tmp_path):
    s = setup
    params, clip = s["thetas"]["sort"], s["clips"][0]
    st = tq.TrackStore(str(tmp_path / "s"), s["tbank"], params)
    ing = tstream.SegmentIngestor(st)
    ing.open(clip)

    def boom(ctx, task):
        raise RuntimeError("detect failed")

    ing._executor.stages["detect"] = boom
    trec.install(trec.FlightRecorder(str(tmp_path / "box")))
    try:
        with pytest.raises(RuntimeError, match="detect failed"):
            ing.append(clip, 8)
        (path,) = trec.active().dumps()
    finally:
        trec.uninstall()
    with open(path) as f:
        doc = json.load(f)
    # the executor's drain hook writes the dump, the append's merges in
    assert doc["reasons"] == ["executor.drain", "stream.append"]
    assert doc["checkpoint"] == st.sidecar_path(clip, CKPT_SUFFIX)
    assert doc["extra"] == {"stream": "caldot1/test0", "frames": 8,
                            "chunk": 16, "requested_frames": 8}
    assert doc["error"]["type"] == "RuntimeError"


# ---------------------------------------------------------------------------
# Standing queries
# ---------------------------------------------------------------------------

def _standing_queries(m):
    return {
        "count": m.Query.count_frames(min_count=1),
        "region_frames": m.Query((m.Region(0.0, 0.0, 1.0, 0.5),),
                                 aggregate="frames"),
        "count2": m.Query.count_frames(min_count=2),
        "duration": m.Query.duration(min_count=1),
        "tracks": m.Query.count_tracks(min_track_len=3),
        "windowed": m.Query.count_frames(min_count=1,
                                         time_range=m.TimeRange(3, 11)),
    }


def _oracle(q, store, clips, m_ref=tref):
    plan = tq.compile_query(q)
    kw = {}
    if plan.region is not None:
        kw["region"] = (plan.region.x0, plan.region.y0, plan.region.x1,
                        plan.region.y1)
    if plan.time_range is not None:
        kw["time_range"] = (plan.time_range.start, plan.time_range.end)
    return m_ref.reference_query(
        [store.tracks(c) for c in clips], [c.profile.fps for c in clips],
        min_len=plan.min_len, min_count=plan.min_count,
        aggregate=q.aggregate, **kw)


def test_standing_deltas_reconstruct_the_adhoc_answer(setup, tmp_path):
    """At every watermark each standing query's accumulated answer
    equals the ad-hoc plan over the store and the brute-force oracle
    (the port's and the reference's), exactly; each visible row is
    scanned at most once."""
    s = setup
    params, clips = s["thetas"]["recurrent"], s["clips"]
    st = tq.TrackStore(str(tmp_path / "sq"), s["tbank"], params)
    svc = tq.QueryService(st)
    ing = tstream.SegmentIngestor(st, service=svc)
    qs = _standing_queries(tq)
    sqs = {k: svc.register_standing(tstream.StandingQuery(q, clips))
           for k, q in qs.items()}
    for c in clips:
        ing.open(c)
    for _ in range(0, N_FRAMES, 5):
        for c in clips:
            ing.append(c, 5)
        for k, q in qs.items():
            acc, adhoc = sqs[k].result(), svc.query(q, clips)
            ref = _oracle(q, st, clips)
            assert ref == _oracle(q, st, clips, jref)
            assert acc.aggregates == adhoc.aggregates == ref["aggregates"], k
            if q.aggregate == "frames":
                assert sorted(acc.frames) == adhoc.frames == ref["frames"]
    total = sum(len(st.get(c).rows) for c in clips)
    assert sqs["count"].rows_scanned == total > 0
    assert all(sq.rows_scanned <= total for sq in sqs.values())


def test_standing_skips_unaffected_clips(setup, tmp_path):
    s = setup
    params, clips = s["thetas"]["sort"], s["clips"]
    st = tq.TrackStore(str(tmp_path / "skip"), s["tbank"], params)
    svc = tq.QueryService(st)
    ing = tstream.SegmentIngestor(st, service=svc)
    q = tq.Query.count_frames(region=(0.0, 0.0, 0.01, 0.01))
    sq = svc.register_standing(tstream.StandingQuery(q, clips))
    ing.open(clips[0])
    for _ in range(4):
        ing.append(clips[0], 4)
    assert sq.rows_scanned == 0 and sq.clips_skipped >= 1
    assert sq.rows_skipped == len(st.get(clips[0]).rows)
    assert sq.result().aggregates == svc.query(q, clips).aggregates


def test_standing_registration_midstream(setup, tmp_path):
    s = setup
    params, clip = s["thetas"]["sort"], s["clips"][1]
    st = tq.TrackStore(str(tmp_path / "mid"), s["tbank"], params)
    svc = tq.QueryService(st)
    ing = tstream.SegmentIngestor(st, service=svc)
    ing.open(clip)
    ing.append(clip, 8)
    q = tq.Query.count_frames(min_count=1)
    sq = svc.register_standing(tstream.StandingQuery(q, [clip]))
    assert sq.result().aggregates == svc.query(q, [clip]).aggregates
    ing.append(clip, 4)
    assert sq.result().aggregates == svc.query(q, [clip]).aggregates
    svc.unregister_standing(sq)
    before = sq.result().aggregates
    ing.append(clip, 4)
    assert sq.result().aggregates == before


def test_standing_rejects_limit_and_classes(setup):
    clips = setup["clips"]
    with pytest.raises(ValueError, match="Limit"):
        tstream.StandingQuery(tq.Query((), limit=tq.Limit(3)), clips)
    with pytest.raises(ValueError, match="class"):
        tstream.StandingQuery(tq.Query((tq.TrackFilter(classes=(0,)),),
                                       aggregate="tracks"), clips)


def test_open_clip_queried_midstream(setup, tmp_path):
    s = setup
    params, clip = s["thetas"]["recurrent"], s["clips"][0]
    st = tq.TrackStore(str(tmp_path / "open"), s["tbank"], params)
    svc = tq.QueryService(st)
    ing = tstream.SegmentIngestor(st)
    ing.open(clip)
    q = tq.Query.count_frames(min_count=1)
    for _ in range(4):
        ing.append(clip, 4)
        indexed = svc.query(q, [clip])
        scanned = svc.query(q, [clip], use_index=False)
        assert indexed.aggregates == scanned.aggregates
        assert indexed.stats.ingested_clips == 0
        assert indexed.aggregates["count"] == \
            _oracle(q, st, [clip])["aggregates"]["count"]


# ---------------------------------------------------------------------------
# Observation, and a fleet of feeds
# ---------------------------------------------------------------------------

def test_tracer_on_equals_tracer_off(setup, tmp_path):
    """The same live ingest and queries with the port's tracer on and
    off: equal packed clips, reports' decisions and answers; one
    ``stream.append`` span per append and one ``query.run`` per query,
    each with the reference's args."""
    s = setup
    params, clip = s["thetas"]["recurrent"], s["clips"][2]
    q = tq.Query.count_frames(min_count=1)
    runs = {}
    for traced in (False, True):
        root = tmp_path / f"t{int(traced)}"
        tobs.TRACER.clear()
        if traced:
            tobs.enable()
        try:
            svc = tq.QueryService(tq.TrackStore(str(root / "x"), s["tbank"],
                                                params))
            sq = svc.register_standing(tstream.StandingQuery(q, [clip]))
            st, reports, _ = live(s["tbank"], params, clip, 6, root,
                                  service=svc)
            answer = result_of(tq.QueryService(st).query(q, [clip]))
            spans = tobs.TRACER.snapshot()
        finally:
            tobs.disable()
            tobs.TRACER.clear()
        runs[traced] = (st.get(clip), [(r.watermark, r.rows_delivered,
                                        r.dispatches) for r in reports],
                        answer, sq.result().aggregates, spans)
    off, on = runs[False], runs[True]
    assert_packed_equal(on[0], off[0])
    assert on[1:4] == off[1:4]
    assert off[4] == []
    names = [sp.name for sp in on[4]]
    assert names.count("stream.append") == len(on[1])
    assert names.count("query.run") == 1
    appends = [sp for sp in on[4] if sp.name == "stream.append"]
    assert all(sp.stream == "caldot1/test2" and sp.dur >= 0 and
               set(sp.args) == {"watermark", "appended", "rows_delivered",
                                "sealed"} for sp in appends)
    assert appends[-1].args["sealed"] is True


def test_three_feeds_share_a_batch_broker(setup, tmp_path):
    """Three feeds, each with its own ingestor on one store, append from
    their own threads in rounds of one segment a feed (a barrier between
    rounds) through one shared ``BatchBroker``: each sealed clip equals
    its solo ingest bit for bit under the batch-invariant bank."""
    s = setup
    params, clips = s["thetas"]["recurrent"], s["clips"]
    solo = [one_shot(s["rbank"], params, c, tmp_path / f"solo{i}")
            for i, c in enumerate(clips)]
    st = tq.TrackStore(str(tmp_path / "fleet"), s["rbank"], params)
    broker = tex.BatchBroker(linger_ms=50.0)
    opts = tex.ExecutorOptions(batch_broker=broker)
    meet = threading.Barrier(len(clips))

    def feed(i):
        ing = tstream.SegmentIngestor(st, options=opts)
        ing.open(clips[i])
        reports = []
        try:
            while not reports or not reports[-1].sealed:
                meet.wait(60.0)
                reports.append(ing.append(clips[i], 4))
        except BaseException:
            meet.abort()
            raise
        return reports

    got = run_threads([lambda i=i: feed(i) for i in range(len(clips))])
    broker.close()
    for c, want, reports in zip(clips, solo, got):
        assert_packed_equal(st.get(c), want)
        assert len(reports) == N_FRAMES // 4
    assert broker.dispatches > 0
    assert broker.windows_in == sum(st.get(c).counters[1] for c in clips)


def test_queries_race_live_appends(setup, tmp_path):
    """Eight query threads against one appending thread, with a short
    switch interval: no read tears (every answer comes from one whole
    watermark, so each thread's counts never fall) and the last answer
    is the sealed store's."""
    import sys
    s = setup
    params, clip = s["thetas"]["sort"], s["clips"][1]
    st = tq.TrackStore(str(tmp_path / "race"), s["tbank"], params)
    svc = tq.QueryService(st)
    ing = tstream.SegmentIngestor(st, service=svc)
    q = tq.Query.count_frames(min_count=1)
    ing.open(clip)
    ing.append(clip, 2)
    done = threading.Event()

    def appender():
        try:
            while not ing.append(clip, 2).sealed:
                pass
        finally:
            done.set()

    def reader():
        seen = []
        while not done.is_set():
            seen.append(svc.query(q, [clip]).aggregates["count"])
        return seen

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = run_threads([appender] + [reader] * 8)
    finally:
        sys.setswitchinterval(interval)
    final = svc.query(q, [clip]).aggregates["count"]
    assert final == _oracle(q, st, [clip])["aggregates"]["count"] > 0
    for seen in got[1:]:
        assert seen == sorted(seen) and all(c <= final for c in seen)
