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
import repro.core.proxy as jproxy  # noqa: E402
import repro.core.sort as jsort  # noqa: E402
import repro.core.tracker as jtrk  # noqa: E402
import repro.core.windows as jwin  # noqa: E402
import repro.data.video_synth as jvs  # noqa: E402
from repro.configs.multiscope import MULTISCOPE_PIPELINE as J_CFG  # noqa: E402

import repro_torch.core.detector as tdet  # noqa: E402
import repro_torch.core.fastmath as tfm  # noqa: E402
import repro_torch.core.hungarian as thung  # noqa: E402
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
