"""The port's main path against the JAX package's, on the CPU, at the
reduced configuration with untrained weights and a 24-frame clip.

Both banks hold the same weights (the reference's, moved by
``repro_torch.params``) and the same pre-seeded window times, so window
planning cannot depend on timing.  The conv nets agree only to a float32
tolerance (``CONV_ATOL``), so the proxy threshold and the detector
confidence are first shown to keep a margin wider than that tolerance
from every score the reference thresholds; under that margin the port
must plan the same windows, find the same detections and extract the
same tracks.

Stage by stage, each port stage is fed the reference's output of the
stage before; end to end, both run their streaming executors, with the
host tracker and with TRACK on the device (``device_assign``,
``device_tracker``), with the unfused proxy path (``fused_plan=False``),
and the per-frame engine (``run_clip_frames``), each against the
reference's same path at the same batch composition, with and without a
track refiner built from the same training tracks in both packages.  Host numpy stages and the device tracker must be
bit-identical; values computed from conv outputs (boxes, embeddings)
agree to the stated tolerances.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.detector as jdet  # noqa: E402
import repro.core.executor as jex  # noqa: E402
import repro.core.pipeline as jpl  # noqa: E402
import repro.core.proxy as jproxy  # noqa: E402
import repro.core.tracker as jtrk  # noqa: E402
from repro.configs.multiscope import MULTISCOPE_PIPELINE as J_CFG  # noqa: E402
from repro.data.video_synth import make_clip  # noqa: E402

import repro_torch.core.detector as tdet  # noqa: E402
import repro_torch.core.executor as tex  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
import repro_torch.core.proxy as tproxy  # noqa: E402
import repro_torch.core.tracker as ttrk  # noqa: E402
from repro.core.refine import TrackRefiner as JRefiner  # noqa: E402
from repro_torch.core.refine import TrackRefiner as TRefiner  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE as T_CFG  # noqa: E402

CONV_ATOL = 2e-5        # conv-net outputs, as tests/test_torch_modules.py
MARGIN = CONV_ATOL       # least distance of a thresholded score from its threshold
BOX_RTOL, BOX_ATOL = 1e-4, 2e-5   # boxes: exp(log-size) amplifies drift
SEED = 4
ARCH = "ssd-lite"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _widest_gap(values, lo_q, hi_q):
    """Midpoint of the widest gap between consecutive distinct scores
    with quantile rank in [lo_q, hi_q]: a threshold as far as these
    scores allow from all of them."""
    v = np.unique(np.asarray(values, np.float64).ravel())
    lo, hi = int(lo_q * (len(v) - 1)), int(hi_q * (len(v) - 1))
    gaps = np.diff(v[lo:hi + 1])
    k = lo + int(np.argmax(gaps))
    return float((v[k] + v[k + 1]) / 2)


def _margin(values, thr):
    return float(np.min(np.abs(np.asarray(values, np.float64) - thr)))


@pytest.fixture(scope="module")
def slice_setup():
    cfg = J_CFG.reduced()
    det_res = cfg.detector.resolutions[-1]          # (128, 80): grid 8x5
    pres = cfg.proxy.resolutions[-1]                # (32, 24) at cell 8
    grid = jpl.det_grid(det_res)
    sizes = [grid, (3, 2), (5, 3)]
    times = {(ARCH, s): t for s, t in zip(sizes, (1.0, 0.2, 0.45))}

    jd = jdet.init_detector(ARCH, seed=SEED)
    jp = jproxy.init_proxy(cfg.proxy.cell, cfg.proxy.base_channels,
                           seed=SEED)
    jt = jtrk.init_tracker(cfg.tracker, seed=SEED)
    jbank = jpl.ModelBank(
        cfg, {ARCH: jdet.Detector(ARCH, jd)},
        {pres: jproxy.ProxyModel(cfg.proxy.cell, cfg.proxy.base_channels,
                                 pres, params=jp)},
        tracker_params=jt, sizes_cells=sizes, ref_grid=grid,
        win_times=dict(times))
    tcfg = T_CFG.reduced()
    tbank = tpl.ModelBank(
        tcfg, {ARCH: tdet.Detector(
            ARCH, bridge.detector_from_params(ARCH, _np_tree(jd)),
            device="cpu")},
        {pres: tproxy.ProxyModel(
            cfg.proxy.cell, cfg.proxy.base_channels, pres,
            encoder=bridge.proxy_from_params(
                cfg.proxy.cell, cfg.proxy.base_channels, _np_tree(jp)),
            device="cpu")},
        tracker_params=bridge.tracker_from_params(cfg.tracker,
                                                  _np_tree(jt), "cpu"),
        sizes_cells=sizes, ref_grid=grid, win_times=dict(times),
        device="cpu")
    clip = make_clip("caldot1", "test", 0, n_frames=24)

    # proxy threshold: in the widest gap near the 0.85 quantile of the
    # reference's proxy sigmoids over every chunk it will score
    probe = jpl.PipelineParams(ARCH, det_res, 0.5, proxy_res=pres,
                               tracker="recurrent", refine=False)
    ctx = jex._RunContext(jbank, probe, clip, jex.ExecutorOptions())
    tasks = [jex.stage_decode(ctx, jex.ChunkTask(i, ctx.frame_ids[c:c + 16]))
             for i, c in enumerate(range(0, len(ctx.frame_ids), 16))]
    psig = []
    for t in tasks:
        pf = jdet.pad_to_bucket(jpl.downsample_chunk(t.frames, pres))
        feat = jproxy.proxy_features(jp, jnp.asarray(pf), cfg.proxy.cell)
        logit = jnp.einsum("bhwc,c->bhw", feat, jp["head"]["w"]) \
            + jp["head"]["b"][0]
        psig.append(np.asarray(jax.nn.sigmoid(logit))[:len(t.frame_ids)])
    thr = _widest_gap(np.concatenate(psig), 0.8, 0.9)

    # detector confidence: in the widest gap near the top of every
    # score the reference's detector computes on this plan
    probe = jpl.PipelineParams(ARCH, det_res, 0.5, proxy_res=pres,
                               proxy_threshold=thr, tracker="recurrent",
                               refine=False)
    ctx = jex._RunContext(jbank, probe, clip, jex.ExecutorOptions())
    dsc = []
    for t in tasks:
        jex.stage_proxy(ctx, t)
        for size, entries in t.plan.by_size.items():
            ph, pw = size[1] * jpl.CELL_PX, size[0] * jpl.CELL_PX
            crops = np.stack([t.frames[s, y * 16:y * 16 + ph,
                                       x * 16:x * 16 + pw]
                              for (s, x, y, _) in entries])
            s, _ = jdet._detect_scores(jd, jnp.asarray(
                jdet.pad_to_bucket(crops)), ARCH)
            dsc.append(np.asarray(s)[:len(entries)].ravel())
    conf = _widest_gap(np.concatenate(dsc), 0.6, 0.9)
    params = jpl.PipelineParams(ARCH, det_res, conf, gap=1,
                                proxy_res=pres, proxy_threshold=thr,
                                tracker="recurrent", refine=False)
    return dict(jbank=jbank, tbank=tbank, clip=clip, params=params,
                psig=np.concatenate(psig), dsc=np.concatenate(dsc))


def test_thresholds_keep_margin(slice_setup):
    s = slice_setup
    p = s["params"]
    assert _margin(s["psig"], p.proxy_threshold) > MARGIN
    assert _margin(s["dsc"], p.det_conf) > MARGIN
    # the plan exercises every branch: sub-frame windows, and detections
    assert (s["dsc"] > p.det_conf).sum() >= 8


def _port_params(p):
    return tpl.PipelineParams(p.det_arch, p.det_res, p.det_conf, p.gap,
                              p.proxy_res, p.proxy_threshold, p.tracker,
                              p.refine, p.chunk_size)


def _assert_dets_close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=BOX_RTOL, atol=BOX_ATOL)


def test_stage_by_stage(slice_setup):
    s = slice_setup
    jp, tp = s["params"], _port_params(s["params"])
    jctx = jex._RunContext(s["jbank"], jp, s["clip"], jex.ExecutorOptions())
    tctx = tex._RunContext(s["tbank"], tp, s["clip"], tex.ExecutorOptions())
    assert tctx.sizeset.sizes == jctx.sizeset.sizes
    gathered = 0
    for i, c0 in enumerate(range(0, len(jctx.frame_ids), 16)):
        ids = jctx.frame_ids[c0:c0 + 16]
        jt = jex.stage_decode(jctx, jex.ChunkTask(i, ids))
        tt = tex.stage_decode(tctx, tex.ChunkTask(i, ids))
        np.testing.assert_array_equal(tt.frames, jt.frames)

        jex.stage_proxy(jctx, jt)
        tex.stage_proxy(tctx, tt)
        assert tt.plan.windows == jt.plan.windows
        assert tt.plan.by_size == jt.plan.by_size
        gathered += sum(len(e) for sz, e in jt.plan.by_size.items()
                        if sz != tctx.sizeset.full)

        tt.plan = jt.plan
        jex.stage_detect(jctx, jt)
        tex.stage_detect(tctx, tt)
        _assert_dets_close(tt.dets, jt.dets)

        # TRACK: crop embeddings agree to the conv tolerance; fed the
        # reference's detections and embeddings, tracking is bit-exact
        mb = max(8, jctx.chunk // 2)
        j_emb = jtrk.embed_dets_chunk(jctx.bank.tracker_params,
                                      jctx.cfg.tracker, jt.frames,
                                      jt.dets, min_bucket=mb)
        t_emb = ttrk.embed_dets_chunk(tctx.bank.tracker_params,
                                      tctx.cfg.tracker, jt.frames,
                                      jt.dets, min_bucket=mb)
        for a, b in zip(t_emb, j_emb):
            np.testing.assert_allclose(a, b, rtol=0, atol=CONV_ATOL)
        jctx.tracker.step_chunk(ids, jt.dets, jt.frames, embeds=j_emb)
        tctx.tracker.step_chunk(ids, jt.dets, jt.frames, embeds=j_emb)
    assert gathered > 0
    a, b = jctx.tracker.result(), tctx.tracker.result()
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("engine", ["streaming", "chunked"])
def test_end_to_end(slice_setup, engine):
    s = slice_setup
    ref = jpl.run_clip(s["jbank"], s["params"], s["clip"])
    got = tpl.run_clip(s["tbank"], _port_params(s["params"]), s["clip"],
                       engine=engine)
    for k in ("frames_processed", "detector_windows", "full_frames",
              "skipped_frames"):
        assert getattr(got, k) == getattr(ref, k), k
    assert got.dispatches == ref.dispatches
    assert ref.detector_windows > ref.full_frames     # windows ran
    assert len(got.tracks) == len(ref.tracks) > 0
    for x, y in zip(got.tracks, ref.tracks):
        np.testing.assert_array_equal(x[:, [0, 5]], y[:, [0, 5]])
        np.testing.assert_allclose(x, y, rtol=BOX_RTOL, atol=BOX_ATOL)
    assert set(got.stage_seconds) == set(tex.STAGES)


TRACK_MODES = {"host": {}, "device_assign": {"device_assign": True},
               "device_tracker": {"device_tracker": True}}


@pytest.fixture
def one_thread():
    """Small eager ops run faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_port(s, chunk, **flags):
    return tex.ClipExecutor(s["tbank"], _port_params(s["params"]),
                            tex.ExecutorOptions(chunk_size=chunk, **flags)
                            ).run(s["clip"])


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("chunk", [1, 16])
@pytest.mark.parametrize("mode", list(TRACK_MODES))
def test_end_to_end_track_modes(slice_setup, mode, chunk):
    """Each TRACK flavour against the reference's executor run with the
    same options (same decisions, boxes to the conv tolerance, same
    counters), and the device flavours against the port's host tracker
    on the same run, bit for bit."""
    s = slice_setup
    flags = TRACK_MODES[mode]
    ref = jex.ClipExecutor(s["jbank"], s["params"], jex.ExecutorOptions(
        chunk_size=chunk, **flags)).run(s["clip"])
    got = _run_port(s, chunk, **flags)
    for k in ("frames_processed", "detector_windows", "full_frames",
              "skipped_frames"):
        assert getattr(got, k) == getattr(ref, k), k
    assert got.dispatches == ref.dispatches
    assert len(got.tracks) == len(ref.tracks) > 0
    for x, y in zip(got.tracks, ref.tracks):
        np.testing.assert_array_equal(x[:, [0, 5]], y[:, [0, 5]])
        np.testing.assert_allclose(x, y, rtol=BOX_RTOL, atol=BOX_ATOL)
    if mode != "host":
        host = _run_port(s, chunk)
        assert len(got.tracks) == len(host.tracks)
        for x, y in zip(got.tracks, host.tracks):
            np.testing.assert_array_equal(x, y)
        assert got.dispatches["track"] > host.dispatches["track"]


def _assert_runs_match(got, ref):
    """Same decisions (frames, ids, counters), boxes to the conv
    tolerance, track for track."""
    for k in ("frames_processed", "detector_windows", "full_frames",
              "skipped_frames"):
        assert getattr(got, k) == getattr(ref, k), k
    assert got.dispatches == ref.dispatches
    assert len(got.tracks) == len(ref.tracks) > 0
    for x, y in zip(got.tracks, ref.tracks):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x[:, [0, 5]], y[:, [0, 5]])
        np.testing.assert_allclose(x, y, rtol=BOX_RTOL, atol=BOX_ATOL)


@pytest.fixture(scope="module")
def refined_banks(slice_setup):
    """Both banks with a refiner built from the same training tracks:
    the reference's streaming run over two ``caldot1`` train clips."""
    s = slice_setup
    train = []
    for cid in (0, 1):
        clip = make_clip("caldot1", "train", cid, n_frames=24)
        train += jpl.run_clip(s["jbank"], s["params"], clip).tracks
    scale = 1.0 / s["params"].det_res[0]
    jbank = dataclasses.replace(s["jbank"], refiner=JRefiner(
        s["jbank"].cfg.refine, train, frame_scale=scale))
    tbank = dataclasses.replace(s["tbank"], refiner=TRefiner(
        s["tbank"].cfg.refine, train, frame_scale=scale))
    assert len(tbank.refiner.clusters) == len(jbank.refiner.clusters) > 0
    return jbank, tbank


def _banks(s, refined_banks, refine):
    if refine:
        return refined_banks
    return s["jbank"], s["tbank"]


def _refine_params(p, refine):
    return dataclasses.replace(p, refine=refine)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("refine", [False, True])
def test_end_to_end_frame_engine(slice_setup, refined_banks, refine):
    """The per-frame engine against the reference's ``run_clip_frames``:
    batch-1 proxy through ``proxy_score``, sub-frame windows through the
    single-frame ``window_gather``, the host tracker frame by frame."""
    s = slice_setup
    jbank, tbank = _banks(s, refined_banks, refine)
    jp = _refine_params(s["params"], refine)
    ref = jpl.run_clip_frames(jbank, jp, s["clip"])
    got = tpl.run_clip(tbank, _port_params(jp), s["clip"], engine="frame")
    _assert_runs_match(got, ref)
    assert ref.detector_windows > ref.full_frames     # windows ran
    assert got.stage_seconds is None and got.dispatches is None
    if refine:
        plain = tpl.run_clip_frames(s["tbank"], _port_params(jp), s["clip"])
        assert sum(map(len, got.tracks)) > sum(map(len, plain.tracks))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("refine", [False, True])
def test_end_to_end_unfused_plan(slice_setup, refined_banks, refine):
    """``ExecutorOptions(fused_plan=False)`` against the reference's:
    one ``proxy_score`` launch per chunk, host mapping and planning."""
    s = slice_setup
    jbank, tbank = _banks(s, refined_banks, refine)
    jp = _refine_params(s["params"], refine)
    ref = jex.ClipExecutor(jbank, jp, jex.ExecutorOptions(
        fused_plan=False)).run(s["clip"])
    got = tex.ClipExecutor(tbank, _port_params(jp), tex.ExecutorOptions(
        fused_plan=False)).run(s["clip"])
    _assert_runs_match(got, ref)
    assert ref.detector_windows > ref.full_frames
    # the unfused plans are the fused ones (no score near the threshold)
    fused = tex.ClipExecutor(tbank, _port_params(jp)).run(s["clip"])
    assert len(fused.tracks) == len(got.tracks)
    for x, y in zip(fused.tracks, got.tracks):
        np.testing.assert_array_equal(x, y)
    if refine:
        plain = tex.ClipExecutor(s["tbank"], _port_params(jp),
                                 tex.ExecutorOptions(fused_plan=False)
                                 ).run(s["clip"])
        assert sum(map(len, got.tracks)) > sum(map(len, plain.tracks))


def test_run_clip_rejects_unknown_engine(slice_setup):
    s = slice_setup
    with pytest.raises(ValueError) as exc:
        tpl.run_clip(s["tbank"], _port_params(s["params"]), s["clip"],
                     engine="bogus")
    for name in ("'streaming'", "'chunked'", "'frame'"):
        assert name in str(exc.value)


def test_entry_points_default_to_the_card():
    """Asked for no device on a host without a card, entry points raise
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    cfg = T_CFG.reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdet.Detector(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproxy.ProxyModel(8, 4, (32, 24))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrk.init_tracker(cfg.tracker)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.ModelBank(cfg, {})
    bank = tpl.ModelBank(cfg, {}, device="cpu")
    params = tpl.PipelineParams(ARCH, (128, 80), 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.ClipExecutor(bank, params, device="cuda")
    # the run's device is the bank's; an explicit device must match it
    tex.ClipExecutor(bank, params)
    tex.ClipExecutor(bank, params, device="cpu")
    bank.device = torch.device("meta")
    with pytest.raises(ValueError, match="bank on meta"):
        tex.ClipExecutor(bank, params, device="cpu")
