"""The port's modules against the JAX package's, on the CPU.

Weights are the reference's own initialised parameters, moved into the
port's modules by ``repro_torch.params``; inputs come from seeded numpy
and both sides see the same batch composition (the reference is not
batch-invariant under the installed jax).

Convolutions are float32 on both sides but run through different
libraries (XLA's CPU convolution against oneDNN's), which sum in
different orders: conv-net outputs are held to ``CONV_ATOL`` absolute,
about a hundred f32 ulps of the outputs' O(1) magnitudes.  Everything
that is host numpy in both packages (planning, assignment, tracking,
decoding, the clip simulator) must be bit-identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.detector as jdet  # noqa: E402
import repro.core.fastmath as jfm  # noqa: E402
import repro.core.hungarian as jhung  # noqa: E402
import repro.core.metrics as jmet  # noqa: E402
import repro.core.pipeline as jpl  # noqa: E402
import repro.core.proxy as jproxy  # noqa: E402
import repro.core.refine as jref  # noqa: E402
import repro.core.sort as jsort  # noqa: E402
import repro.core.tracker as jtrk  # noqa: E402
import repro.core.windows as jwin  # noqa: E402
import repro.data.video_synth as jvs  # noqa: E402
from repro.configs.multiscope import MULTISCOPE_PIPELINE as J_CFG  # noqa: E402

import repro_torch.core.detector as tdet  # noqa: E402
import repro_torch.core.fastmath as tfm  # noqa: E402
import repro_torch.core.hungarian as thung  # noqa: E402
import repro_torch.core.metrics as tmet  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
import repro_torch.core.proxy as tproxy  # noqa: E402
import repro_torch.core.refine as tref  # noqa: E402
import repro_torch.core.sort as tsort  # noqa: E402
import repro_torch.core.tracker as ttrk  # noqa: E402
import repro_torch.core.windows as twin  # noqa: E402
import repro_torch.data.video_synth as tvs  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE as T_CFG  # noqa: E402

CONV_ATOL = 2e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("hw", [(8, 12), (9, 13), (7, 10), (16, 16)])
@pytest.mark.parametrize("k,stride", [(3, 2), (3, 1), (1, 1)])
def test_same_padding_matches_xla(hw, k, stride):
    rng = np.random.default_rng(hw[0] * 10 + k + stride)
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    conv = tdet.SameConv2d(5, 6, k, stride)
    bridge._load_conv(conv, w, b)
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)) \
            .permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                               atol=CONV_ATOL)
    if k == 3 and stride == 2:
        # the trap: symmetric padding=1 shifts outputs on even sizes
        sym = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), conv.weight,
            conv.bias, stride, padding=1).permute(0, 2, 3, 1)
        same = np.allclose(sym.detach().numpy(), np.asarray(ref),
                           atol=CONV_ATOL)
        assert same == (hw[0] % 2 == 1 and hw[1] % 2 == 1)


@pytest.mark.parametrize("arch", ["ssd-lite", "ssd-deep"])
@pytest.mark.parametrize("hw", [(80, 128), (48, 80)])
def test_detector_raw_matches(arch, hw):
    jp = jdet.init_detector(arch, seed=3)
    net = bridge.detector_from_params(arch, _np_tree(jp))
    frames = np.random.default_rng(1).random((4, *hw, 3), np.float32)
    ref = np.asarray(jdet.detector_raw(jp, jnp.asarray(frames), arch))
    with torch.no_grad():
        got = net(torch.from_numpy(frames)).numpy()
    assert got.shape == ref.shape == (4, hw[0] // 16, hw[1] // 16, 5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CONV_ATOL)


@pytest.mark.parametrize("cell,base,hw", [(8, 4, (40, 64)),
                                          (32, 8, (64, 96))])
def test_proxy_features_matches(cell, base, hw):
    jp = jproxy.init_proxy(cell, base, seed=5)
    enc = bridge.proxy_from_params(cell, base, _np_tree(jp))
    frames = np.random.default_rng(2).random((4, *hw, 3), np.float32)
    ref = np.asarray(jproxy.proxy_features(jp, jnp.asarray(frames), cell))
    with torch.no_grad():
        got = enc(torch.from_numpy(frames)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=CONV_ATOL)
    np.testing.assert_array_equal(enc.head_w.detach().numpy(),
                                  np.asarray(jp["head"]["w"]))


@pytest.mark.parametrize("cfg", [J_CFG.reduced().tracker, J_CFG.tracker])
def test_crop_embed_matches(cfg):
    jp = jtrk.init_tracker(cfg, seed=7)
    tp = bridge.tracker_from_params(cfg, _np_tree(jp), device="cpu")
    crops = np.random.default_rng(3).random((16, cfg.crop, cfg.crop, 3),
                                            np.float32)
    ref = np.asarray(jtrk.crop_embed(jp, jnp.asarray(crops)))
    got = ttrk.crop_embed(tp["crop_cnn"], crops)
    assert got.shape == ref.shape == (16, cfg.embed_dim)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CONV_ATOL)


@pytest.mark.parametrize("profile", ["caldot1", "warsaw", "uav"])
def test_video_synth_bit_identical(profile):
    jc = jvs.make_clip(profile, "test", 1, n_frames=12)
    tc = tvs.make_clip(profile, "test", 1, n_frames=12)
    assert len(jc.tracks) == len(tc.tracks)
    for a, b in zip(jc.tracks, tc.tracks):
        np.testing.assert_array_equal(a.frames, b.frames)
        np.testing.assert_array_equal(a.boxes, b.boxes)
    for f, (W, H) in [(0, (128, 80)), (7, (960, 544)), (11, (208, 128))]:
        np.testing.assert_array_equal(tc.render(f, W, H),
                                      jc.render(f, W, H))


def _random_grids(rng, n, hc, wc):
    grids = []
    for i in range(n):
        g = np.zeros((hc, wc), np.int8)
        kind = i % 4
        if kind == 1:       # one filled rectangle (the stats shortcut)
            y, x = rng.integers(0, hc - 2), rng.integers(0, wc - 3)
            g[y:y + 2, x:x + 3] = 1
        elif kind >= 2:     # scattered clusters
            g = (rng.random((hc, wc)) > (0.9 if kind == 2 else 0.6)) \
                .astype(np.int8)
        grids.append(g)
    return grids


def _stats(g):
    ys, xs = np.nonzero(g)
    if len(ys) == 0:
        return np.array([0, g.shape[0], -1, g.shape[1], -1, 0, 0, 0])
    return np.array([len(ys), ys.min(), ys.max(), xs.min(), xs.max(),
                     0, 0, 0])


@pytest.mark.parametrize("grid,sizes,times", [
    ((8, 5), [(8, 5), (3, 2), (5, 3)], [1.0, 0.2, 0.45]),
    ((60, 34), [(60, 34), (15, 9), (30, 17)], [1.0, 0.07, 0.25]),
])
def test_plan_from_mapped_identical(grid, sizes, times):
    wc, hc = grid
    rng = np.random.default_rng(wc)
    grids = _random_grids(rng, 16, hc, wc)
    stats = np.stack([_stats(g) for g in grids]).astype(np.int32)
    ref_set = jwin.SizeSet(sizes, dict(zip(sizes, times)))
    port_set = twin.SizeSet(sizes, dict(zip(sizes, times)))
    for mw in (4, 8):
        a = jwin.plan_from_mapped(grids, stats, ref_set, mw, chunk_size=16)
        b = twin.plan_from_mapped(grids, stats, port_set, mw,
                                  chunk_size=16)
        assert a.windows == b.windows and a.by_size == b.by_size
        c = twin.plan_chunk(grids, port_set, mw, chunk_size=16)
        assert c.windows == b.windows
    full = twin.full_frame_plan(3, port_set)
    assert full.windows == jwin.full_frame_plan(3, ref_set).windows


@pytest.mark.parametrize("n,m", [(5, 5), (3, 9), (9, 4), (16, 16), (1, 1)])
def test_hungarian_identical(n, m):
    rng = np.random.default_rng(n * 100 + m)
    cost = np.floor(rng.random((n, m)) * 64) / 64     # ties included
    cost[rng.random((n, m)) > 0.7] = jhung.BIG
    c32 = cost.astype(np.float32)
    assert thung.hungarian_device_np(c32) == jhung.hungarian_device_np(c32)
    assert thung.hungarian(cost) == jhung.hungarian(cost)
    assert thung._hungarian_np(cost) == jhung._hungarian_np(cost)
    side = thung.assoc_side(n, m)
    sq = np.full((side, side), thung.FORBIDDEN_DEVICE, np.float32)
    sq[:n, :m] = np.minimum(c32, thung.FORBIDDEN_DEVICE)
    np.testing.assert_array_equal(thung.solve_device_np(sq),
                                  jhung.solve_device_np(sq))


def test_fastmath_identical():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(4096) * 8).astype(np.float32)
    for name in ("np_exp", "np_sigmoid", "np_tanh"):
        np.testing.assert_array_equal(getattr(tfm, name)(x),
                                      getattr(jfm, name)(x))
    a, w = x[:96].reshape(8, 12), x[96:192].reshape(12, 8)
    np.testing.assert_array_equal(tfm.np_matmul(a, w),
                                  jfm.np_matmul(a, w))
    np.testing.assert_array_equal(tfm.np_fmadd(x, x[::-1], x),
                                  jfm.np_fmadd(x, x[::-1], x))
    te = np.arange(0, 5000, 7).astype(np.float32)
    np.testing.assert_array_equal(tfm.np_log1p_int(te),
                                  jfm.np_log1p_int(te))


def test_decode_and_nms_identical():
    rng = np.random.default_rng(5)
    scores = rng.random((5, 8)).astype(np.float32)
    boxes = rng.standard_normal((5, 8, 4)).astype(np.float32)
    for conf, origin, scale in [(0.5, (0.0, 0.0), (1.0, 1.0)),
                                (0.8, (0.25, 0.5), (0.375, 0.4))]:
        np.testing.assert_array_equal(
            tdet.decode_detections(scores, boxes, conf, origin, scale,
                                   max_dets=6),
            jdet.decode_detections(scores, boxes, conf, origin, scale,
                                   max_dets=6))
    assert [tdet.next_bucket(n, 8) for n in range(40)] == \
        [jdet.next_bucket(n, 8) for n in range(40)]


def _det_sequence(clip, n_frames, rng):
    """Per-frame detections from the clip's ground truth plus jitter,
    with misses and a clutter detection now and then."""
    seq = []
    for f in range(n_frames):
        gt = clip.boxes_at(f)[:, :4]
        keep = rng.random(len(gt)) > 0.15
        d = gt[keep] + rng.normal(0, 0.004, (int(keep.sum()), 4))
        if rng.random() < 0.3:
            d = np.concatenate([d, rng.random((1, 4)) * [1, 1, 0.1, 0.1]])
        sc = rng.random((len(d), 1))
        seq.append(np.concatenate([d, sc], 1).astype(np.float32))
    return seq


@pytest.mark.parametrize("gap", [1, 3])
def test_recurrent_tracker_host_identical(gap):
    """Fed the reference's detections and crop embeddings, the port's
    host tracker yields the reference's tracks bit for bit."""
    cfg = J_CFG.reduced().tracker
    jp = jtrk.init_tracker(cfg, seed=11)
    tp = bridge.tracker_from_params(cfg, _np_tree(jp), device="cpu")
    clip = jvs.make_clip("warsaw", "test", 2, n_frames=40)
    rng = np.random.default_rng(gap)
    seq = _det_sequence(clip, 40, rng)
    ref = jtrk.RecurrentTracker(cfg, jp)
    port = ttrk.RecurrentTracker(cfg, tp)
    frame = clip.render(0, 128, 80)
    for f in range(0, 40, gap):
        emb = np.asarray(jtrk.crop_embed(
            jp, jnp.asarray(jtrk.extract_crops(frame, seq[f], cfg.crop))))
        ref.step(f, seq[f], frame, det_embeds=emb)
        port.step(f, seq[f], frame, det_embeds=emb)
    a, b = ref.result(), port.result()
    assert len(a) == len(b) > 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        ttrk.extract_crops(frame, seq[5], cfg.crop),
        jtrk.extract_crops(frame, seq[5], cfg.crop))


def test_sort_tracker_identical():
    clip = jvs.make_clip("tokyo", "test", 0, n_frames=30)
    seq = _det_sequence(clip, 30, np.random.default_rng(9))
    ref, port = jsort.SortTracker(), tsort.SortTracker()
    for f, d in enumerate(seq):
        ref.step(f, d)
        port.step(f, d)
    a, b = ref.result(), port.result()
    assert len(a) == len(b) > 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_configs_copied():
    for name in ("proxy", "detector", "tracker", "windows"):
        assert getattr(T_CFG, name).__dict__ == getattr(J_CFG, name).__dict__
        assert getattr(T_CFG.reduced(), name).__dict__ == \
            getattr(J_CFG.reduced(), name).__dict__


# ---------------------------------------------------------------------------
# The per-frame path's host stages, refinement and the quality readout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hp,wp,hc,wc", [(8, 13, 34, 60), (3, 4, 5, 8),
                                         (7, 11, 3, 5), (5, 5, 5, 5)])
def test_map_proxy_grid_identical(hp, wp, hc, wc):
    rng = np.random.default_rng(hp * wp + hc)
    for density in (0.0, 0.05, 0.3, 1.0):
        pos = (rng.random((hp, wp)) < density).astype(np.int8)
        got = tpl.map_proxy_grid(pos, (wc, hc))
        assert got.dtype == np.int8 and got.shape == (hc, wc)
        np.testing.assert_array_equal(got, jpl.map_proxy_grid(pos, (wc, hc)))


def test_downsample_identical():
    frames = np.random.default_rng(1).random((3, 80, 128, 3), np.float32)
    for res in ((32, 24), (64, 40), (128, 80)):
        np.testing.assert_array_equal(tpl._downsample(frames[1], res),
                                      jpl._downsample(frames[1], res))
        chunk = tpl.downsample_chunk(frames, res)
        np.testing.assert_array_equal(chunk,
                                      jpl.downsample_chunk(frames, res))
        np.testing.assert_array_equal(chunk[1],
                                      tpl._downsample(frames[1], res))


def test_proxy_scores_match():
    """``ProxyModel.scores`` (batch 1) and ``scores_batch`` (3 frames,
    bucket-padded to 4) on the reference's weights: scores to the conv
    tolerance, positives equal at a threshold whose margin from every
    score exceeds it."""
    cell, base, res = 8, 4, (32, 24)
    jp = jproxy.init_proxy(cell, base, seed=6)
    ref = jproxy.ProxyModel(cell, base, res, params=jp)
    port = tproxy.ProxyModel(cell, base, res, device="cpu",
                             encoder=bridge.proxy_from_params(
                                 cell, base, _np_tree(jp)))
    frames = np.random.default_rng(4).random((3, 24, 32, 3), np.float32)
    s_ref, _ = ref.scores_batch(frames, 0.5)
    v = np.unique(s_ref.astype(np.float64))
    k = int(np.argmax(np.diff(v)))
    thr = float((v[k] + v[k + 1]) / 2)
    assert np.min(np.abs(s_ref - thr)) > CONV_ATOL
    s_j, p_j = ref.scores_batch(frames, thr)
    s_t, p_t = port.scores_batch(frames, thr)
    assert s_t.shape == (3, 3, 4) and p_t.dtype == np.int8
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=CONV_ATOL)
    np.testing.assert_array_equal(p_t, p_j)
    assert 0 < p_t.sum() < p_t.size
    s1_j, p1_j = ref.scores(frames[2], thr)
    s1_t, p1_t = port.scores(frames[2], thr)
    np.testing.assert_allclose(s1_t, s1_j, rtol=0, atol=CONV_ATOL)
    np.testing.assert_array_equal(p1_t, p1_j)
    empty = port.scores_batch(frames[:0], thr)
    assert empty[0].shape == (0, 3, 4) and empty[1].dtype == np.int8


def test_threshold_calibration_identical():
    rng = np.random.default_rng(12)
    scores = [rng.beta(2, 2, (5, 8)).astype(np.float32) for _ in range(6)]
    labels = [(s + rng.normal(0, 0.2, s.shape) > 0.6).astype(np.int8)
              for s in scores]
    base = (0.3, 0.5, 0.7)
    assert tproxy.sweep_candidates(scores, base) == \
        jproxy.sweep_candidates(scores, base)
    cand = tproxy.sweep_candidates(scores, base)
    assert tproxy.threshold_sweep(scores, labels, cand) == \
        jproxy.threshold_sweep(scores, labels, cand)
    for th, mr in ((base, 0.95), (base, 0.5), ((), 0.99), ((0.99,), 1.0)):
        got = tproxy.calibrate_threshold(scores, labels, th, mr)
        assert got == jproxy.calibrate_threshold(scores, labels, th, mr)
    clip = jvs.make_clip("caldot1", "test", 0, n_frames=12)
    for f in (0, 5, 11):
        dets = clip.boxes_at(f)
        np.testing.assert_array_equal(
            tproxy.cells_from_detections(dets, 5, 8),
            jproxy.cells_from_detections(dets, 5, 8))


def _gt_tracks(clip, rng, noise=0.004, keep=1.0, ids=0):
    """The clip's ground-truth tracks as (m, 6) [frame, cx, cy, w, h,
    id] rows, with seeded box noise and dropped rows."""
    out = []
    for t in clip.tracks:
        rows = np.zeros((len(t.frames), 6), np.float32)
        rows[:, 0] = t.frames
        rows[:, 1:5] = t.boxes + rng.normal(0, noise, t.boxes.shape)
        rows[:, 5] = t.track_id + ids
        rows = rows[rng.random(len(rows)) < keep]
        if len(rows):
            out.append(rows)
    return out


def test_refiner_identical():
    """Pure numpy on both sides: the same training tracks give the same
    clusters and index, and every refined track is bit-identical."""
    cfg_j, cfg_t = J_CFG.reduced().refine, T_CFG.reduced().refine
    assert cfg_t.__dict__ == cfg_j.__dict__
    rng = np.random.default_rng(21)
    train = []
    for cid in range(3):
        train += _gt_tracks(jvs.make_clip("caldot1", "train", cid,
                                          n_frames=64), rng)
    ref = jref.TrackRefiner(cfg_j, train, frame_scale=1.0 / 128)
    port = tref.TrackRefiner(cfg_t, train, frame_scale=1.0 / 128)
    assert len(port.clusters) == len(ref.clusters) > 1
    for a, b in zip(port.clusters, ref.clusters):
        np.testing.assert_array_equal(a.center, b.center)
        assert a.size == b.size
    assert dict(port.index) == dict(ref.index)
    test = _gt_tracks(jvs.make_clip("caldot1", "test", 0, n_frames=64),
                      rng, keep=0.5)
    changed = 0
    for t in test + [t[:1] for t in test[:2]]:
        mid = t[len(t) // 4:max(len(t) // 4 + 1, 3 * len(t) // 4)]
        got, want = port.refine(mid), ref.refine(mid)
        np.testing.assert_array_equal(got, want)
        changed += len(got) != len(mid)
    assert changed > 0
    for n in (1, 7, 20):
        np.testing.assert_array_equal(
            tref.resample_track(test[0][:, 1:3], n),
            jref.resample_track(test[0][:, 1:3], n))
    paths = [tref.resample_track(t[:, 1:3], 20) for t in train]
    assert tref.dbscan_tracks(paths, 0.2, 2) == \
        jref.dbscan_tracks(paths, 0.2, 2)


@pytest.mark.parametrize("profile", ["caldot1", "warsaw"])
def test_metrics_identical(profile):
    """Seeded noisy tracks with dropped rows and an identity switch:
    MOTA (host Hungarian, and every frame in one ``assign`` batch on
    CPU tensors), pattern counts and count accuracy equal the
    reference's exactly."""
    clip_j = jvs.make_clip(profile, "test", 1, n_frames=48)
    clip_t = tvs.make_clip(profile, "test", 1, n_frames=48)
    rng = np.random.default_rng(len(profile))
    tracks = _gt_tracks(clip_j, rng, noise=0.01, keep=0.8, ids=100)
    tracks[0] = tracks[0].copy()
    tracks[0][len(tracks[0]) // 2:, 5] += 1000         # identity switch
    tracks.append(np.array([[3, 0.5, 0.5, 0.1, 0.1, 7]], np.float32))
    for frames in (None, range(0, 48, 3)):
        got = tmet.mota(tracks, clip_t, frames)
        assert got == jmet.mota(tracks, clip_j, frames)
        got_b = tmet.mota(tracks, clip_t, frames, assign="batch",
                          device="cpu")
        assert got_b == jmet.mota(tracks, clip_j, frames, assign="batch")
        assert -1.0 < got < 1.0
    np.testing.assert_array_equal(
        tmet.pattern_counts(tracks, clip_t.profile),
        jmet.pattern_counts(tracks, clip_j.profile))
    assert tmet.clip_count_accuracy(tracks, clip_t) == \
        jmet.clip_count_accuracy(tracks, clip_j)
    assert [tmet.classify_track(t, clip_t.profile) for t in tracks] == \
        [jmet.classify_track(t, clip_j.profile) for t in tracks]
    assert tmet.mota([], clip_t) == jmet.mota([], clip_j)
    with pytest.raises(ValueError, match="assign"):
        tmet.mota(tracks, clip_t, assign="gpu")
