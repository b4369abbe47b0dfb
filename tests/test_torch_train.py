"""The port's training half against the JAX package's, on the CPU, at the
reduced configuration.

Weights are the reference's own initialised parameters, carried into the
port by ``repro_torch.params`` (and back, to compare trained weights);
batches are seeded numpy, the same arrays on both sides.

  * the optimiser (``optim``): 20 AdamW steps on seeded gradients, with
    a float lr and with schedules, weight decay and the 8-bit second
    moment, params within ``ADAM_RTOL`` of the reference's; the
    schedules, ``global_norm`` and ``clip_by_global_norm``;
  * every loss (detector both archs, proxy, tracker, BlazeIt's two) and
    each of its gradients within ``LOSS_RTOL`` of max |reference|;
  * the numpy builders bit for bit: ``make_targets``,
    ``cells_from_detections``, ``build_examples``, the tracker's sampled
    batches, ``detector_time_model``, ``select_window_sizes``;
  * short fits from carried-over init (detector, proxy, tracker): each
    loss within ``FIT_LOSS_RTOL`` and each final parameter within
    ``FIT_PARAM_RTOL`` of max |reference|;
  * ``params.py`` round trips in both directions, bit for bit.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.baselines.blazeit as jblz  # noqa: E402
import repro.core.detector as jdet  # noqa: E402
import repro.core.proxy as jproxy  # noqa: E402
import repro.core.tracker as jtrk  # noqa: E402
import repro.core.train_models as jtm  # noqa: E402
import repro.core.windows as jwin  # noqa: E402
import repro.optim as joptim  # noqa: E402
from repro.configs.multiscope import MULTISCOPE_PIPELINE as J_CFG  # noqa: E402
from repro.data.video_synth import make_clip  # noqa: E402
from repro.models.common import build  # noqa: E402

import repro_torch.core.baselines.blazeit as tblz  # noqa: E402
import repro_torch.core.detector as tdet  # noqa: E402
import repro_torch.core.proxy as tproxy  # noqa: E402
import repro_torch.core.tracker as ttrk  # noqa: E402
import repro_torch.core.train_models as ttm  # noqa: E402
import repro_torch.core.windows as twin  # noqa: E402
import repro_torch.optim as toptim  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.data.video_synth import make_clip as t_make_clip  # noqa: E402

ADAM_RTOL = 1e-6         # AdamW params after 20 steps, of max |reference|
LOSS_RTOL = 1e-5         # a loss value and each gradient, of max |reference|
FIT_LOSS_RTOL = 1e-4     # each loss of a short fit
FIT_PARAM_RTOL = 1e-4    # each parameter after a short fit, of max |ref|
CFG = J_CFG.reduced()
DET_RES = CFG.detector.resolutions[-1]           # (128, 80)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(float(np.max(np.abs(want), initial=0.0)), 1e-30))


def _assert_trees_close(got, want, rtol, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], rtol, f"{path}/{k}")
        else:
            assert _rel(got[k], want[k]) <= rtol, (f"{path}/{k}",
                                                   _rel(got[k], want[k]))


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and np.array_equal(g, w), f"{path}/{k}"


def _grads(module, to_params):
    """The module's gradients in the reference's layout."""
    g = copy.deepcopy(module)
    with torch.no_grad():
        for pg, p in zip(g.parameters(), module.parameters()):
            pg.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return to_params(g)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# Optimiser
# ---------------------------------------------------------------------------

SHAPES = {"w": (6, 5), "b": (5,), "k": (2, 3, 4), "s": ()}


def _schedule(pkg, name):
    if name == "cosine":
        return pkg.cosine_schedule(1e-2, 5, 20, 0.1)
    if name == "linear":
        return pkg.linear_schedule(1e-2, 5, 20)
    return 3e-3


@pytest.mark.parametrize("lr,wd,quant", [
    ("float", 0.0, False), ("cosine", 0.0, False), ("float", 0.1, False),
    ("linear", 0.1, False), ("float", 0.0, True), ("cosine", 0.1, True)])
def test_adamw_matches_reference_over_20_steps(lr, wd, quant):
    rng = np.random.default_rng(7)
    p0 = {k: np.asarray(rng.standard_normal(s), np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: np.asarray(rng.standard_normal(s)
                            * 10.0 ** rng.integers(-3, 2), np.float32)
              for k, s in SHAPES.items()}
             for _ in range(20)]
    jopt = joptim.adamw(lr=_schedule(joptim, lr), weight_decay=wd,
                        quantize_v=quant)
    update = jax.jit(jopt.update)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = toptim.adamw(list(tp.values()), lr=_schedule(toptim, lr),
                        weight_decay=wd, quantize_v=quant)
    for g in grads:
        jp, state = update({k: jnp.asarray(v) for k, v in g.items()},
                           state, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in SHAPES:
        assert _rel(tp[k].detach().numpy(), jp[k]) <= ADAM_RTOL, k
    st = topt.adam_state()
    assert st.step == int(state.step) == 20
    if quant:
        for (q, s), (jq, js) in zip(st.v, [state.v[k] for k in SHAPES]):
            assert q.dtype == torch.int8 and q.shape == jq.shape
            assert s.shape == js.shape


def test_adamw_keeps_the_reference_defaults():
    p = torch.nn.Parameter(torch.zeros(3))
    g = toptim.AdamW([p]).param_groups[0]
    ref = joptim.AdamW()
    assert (g["lr"], g["b1"], g["b2"], g["eps"], g["weight_decay"],
            g["quantize_v"]) == (ref.lr, ref.b1, ref.b2, ref.eps,
                                 ref.weight_decay, ref.quantize_v)


def test_adamw_takes_a_missing_grad_as_zero():
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((4,)).astype(np.float32)
    jopt = joptim.adamw(lr=1e-2)
    jp = jnp.asarray(p0)
    state = jopt.init(jp)
    jp, state = jopt.update(jnp.zeros(4), state, jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    toptim.adamw([tp], lr=1e-2).step()
    assert _rel(tp.detach().numpy(), jp) <= ADAM_RTOL


@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_schedules_match_reference(name):
    jf, tf = _schedule(joptim, name), _schedule(toptim, name)
    for step in range(0, 26):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = float(tf(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-9 + 1e-6 * abs(want), step


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    rng = np.random.default_rng(11)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32),
                  np.asarray(rng.standard_normal(()), np.float32)]}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": [torch.from_numpy(x) for x in tree["b"]]}
    assert _rel(toptim.global_norm(ttree), joptim.global_norm(jtree)) <= 1e-6
    jc, jn = joptim.clip_by_global_norm(jtree, max_norm)
    tc, tn = toptim.clip_by_global_norm(ttree, max_norm)
    assert _rel(tn, jn) <= 1e-6
    assert _rel(tc["a"], jc["a"]) <= 1e-6
    for g, w in zip(tc["b"], jc["b"]):
        assert _rel(g, w) <= 1e-6


# ---------------------------------------------------------------------------
# Losses and gradients at carried-over params
# ---------------------------------------------------------------------------

def _det_batch(seed, res=DET_RES, B=2):
    rng = np.random.default_rng(seed)
    W, H = res
    frames = rng.random((B, H, W, 3), dtype=np.float32)
    boxes = []
    for _ in range(B):
        n = int(rng.integers(2, 6))
        boxes.append(np.column_stack([
            rng.uniform(0.05, 0.95, (n, 2)),
            rng.uniform(0.03, 0.2, (n, 2))]).astype(np.float32))
    obj, box = jdet.make_targets(boxes, H // jdet.STRIDE, W // jdet.STRIDE)
    return frames, obj, box


@pytest.mark.parametrize("arch", ["ssd-lite", "ssd-deep"])
def test_detector_loss_and_grads_match(arch):
    # the port's seeded init carried into the reference's layout (the
    # reference's own init compiles one random draw per shape, seconds)
    jp = bridge.detector_to_params(tdet.init_detector(arch, seed=2))
    frames, obj, box = _det_batch(5)
    want, jg = jax.jit(jax.value_and_grad(
        lambda p, f, o, b: jdet.detector_loss(p, f, o, b, arch)))(
        jp, jnp.asarray(frames), jnp.asarray(obj), jnp.asarray(box))
    net = bridge.detector_from_params(arch, jp)
    loss = tdet.detector_loss(net, *_t(frames, obj, box))
    loss.backward()
    assert _rel(loss.item(), want) <= LOSS_RTOL
    _assert_trees_close(_grads(net, bridge.detector_to_params),
                        _np_tree(jg), LOSS_RTOL)


def test_detector_raw_channels_are_the_loss_slices():
    jp = bridge.detector_to_params(tdet.init_detector("ssd-lite", seed=4))
    frames = _det_batch(6)[0]
    want = np.asarray(jdet.detector_raw(jp, jnp.asarray(frames),
                                        "ssd-lite"))
    got = tdet.detector_raw(bridge.detector_from_params("ssd-lite", jp),
                            torch.from_numpy(frames)).detach().numpy()
    assert got.shape == want.shape and got.shape[-1] == 5
    assert np.max(np.abs(got - want)) <= 2e-5


def test_proxy_loss_and_grads_match():
    cell, base = CFG.proxy.cell, CFG.proxy.base_channels
    jp = bridge.proxy_to_params(tproxy.init_proxy(cell, base, seed=3))
    rng = np.random.default_rng(8)
    W, H = CFG.proxy.resolutions[0]
    frames = rng.random((3, H, W, 3), dtype=np.float32)
    labels = (rng.random((3, H // cell, W // cell)) < 0.3).astype(np.int8)
    want, jg = jax.jit(jax.value_and_grad(
        lambda p, f, y: jproxy.proxy_loss(p, f, y, cell)))(
        jp, jnp.asarray(frames), jnp.asarray(labels))
    enc = bridge.proxy_from_params(cell, base, jp)
    loss = tproxy.proxy_loss(enc, *_t(frames, labels))
    loss.backward()
    assert _rel(loss.item(), want) <= LOSS_RTOL
    _assert_trees_close(_grads(enc, bridge.proxy_to_params), _np_tree(jg),
                        LOSS_RTOL)


def _tracker_batch(seed, B=3, L=6, K=6):
    cfg = CFG.tracker
    rng = np.random.default_rng(seed)
    C = cfg.crop
    crops = rng.random((B, L + K, C, C, 3), dtype=np.float32)
    boxes = rng.uniform(0.05, 0.9, (B, L + K, 4)).astype(np.float32)
    te = rng.integers(0, 9, (B, L + K)).astype(np.float32)
    pmask = np.zeros((B, L), np.float32)
    for b in range(B):
        pmask[b, L - int(rng.integers(1, L + 1)):] = 1
    cmask = np.zeros((B, K), np.float32)
    for b in range(B):
        cmask[b, :int(rng.integers(1, K + 1))] = 1
    labels = np.zeros((B, K), np.float32)
    labels[:, 0] = 1
    last_box = rng.uniform(0.05, 0.9, (B, 4)).astype(np.float32)
    return crops, boxes, te, pmask, cmask, labels, last_box


def test_tracker_train_loss_and_grads_match():
    jp = bridge.tracker_to_params(ttrk.init_tracker(CFG.tracker, 6, "cpu"))
    batch = _tracker_batch(9)
    want, jg = jax.jit(jax.value_and_grad(jtrk._train_loss))(
        jp, *(jnp.asarray(a) for a in batch))
    net = ttrk.TrackerNet(bridge.tracker_from_params(CFG.tracker, jp, "cpu"))
    loss = ttrk._train_loss(net, *_t(*batch))
    loss.backward()
    assert _rel(loss.item(), want) <= LOSS_RTOL
    got = _grads(net, lambda g: bridge.tracker_to_params(g.to_params()))
    _assert_trees_close(got, _np_tree(jg), LOSS_RTOL)


def test_tracker_pieces_match():
    jp = bridge.tracker_to_params(ttrk.init_tracker(CFG.tracker, 1, "cpu"))
    net = ttrk.TrackerNet(bridge.tracker_from_params(CFG.tracker, jp, "cpu"))
    crops, boxes, te = (a[0] for a in _tracker_batch(2)[:3])
    rng = np.random.default_rng(4)
    h = rng.standard_normal((12, CFG.tracker.rnn_dim)).astype(np.float32)
    want_f = np.asarray(jtrk.embed_dets(jp, *(jnp.asarray(a) for a in
                                              (crops, boxes, te))))
    with torch.no_grad():
        got_f = ttrk.embed_dets(net, *_t(crops, boxes, te)).numpy()
        got_h = ttrk.gru_step(net, *_t(h, got_f)).numpy()
        got_m = ttrk.match_logits(net, *_t(h[:5], boxes[:5], want_f,
                                           boxes, te)).numpy()
    assert np.max(np.abs(got_f - want_f)) <= 2e-5
    want_h = np.asarray(jtrk.gru_step(jp, jnp.asarray(h), jnp.asarray(got_f)))
    assert np.max(np.abs(got_h - want_h)) <= 2e-5
    want_m = np.asarray(jtrk.match_logits(
        jp, *(jnp.asarray(a) for a in (h[:5], boxes[:5], want_f, boxes,
                                       te))))
    assert np.max(np.abs(got_m - want_m)) <= 2e-5


def _scorer_batch(seed, B=4):
    rng = np.random.default_rng(seed)
    frames = rng.random((B, 48, 64, 3), dtype=np.float32)
    return frames, (rng.random(B) < 0.5).astype(np.float32), \
        rng.integers(0, 6, B).astype(np.float32)


@pytest.mark.parametrize("kind", ["cls", "reg"])
def test_blazeit_scorer_losses_and_grads_match(kind):
    jp = bridge.frame_scorer_to_params(tblz.init_frame_scorer(1))
    frames, labels, counts = _scorer_batch(3)
    y = labels if kind == "cls" else counts
    jloss = jblz._scorer_loss_cls if kind == "cls" else jblz._scorer_loss_reg
    tloss = tblz._scorer_loss_cls if kind == "cls" else tblz._scorer_loss_reg
    want, jg = jax.jit(jax.value_and_grad(jloss))(jp, jnp.asarray(frames),
                                                  jnp.asarray(y))
    scorer = bridge.frame_scorer_from_params(jp)
    loss = tloss(scorer, *_t(frames, y))
    loss.backward()
    assert _rel(loss.item(), want) <= LOSS_RTOL
    _assert_trees_close(_grads(scorer, bridge.frame_scorer_to_params),
                        _np_tree(jg), LOSS_RTOL)


# ---------------------------------------------------------------------------
# Numpy builders, bit for bit
# ---------------------------------------------------------------------------

def test_make_targets_and_cells_bit_for_bit():
    rng = np.random.default_rng(12)
    boxes = [np.column_stack([rng.uniform(0, 1, (n, 2)),
                              rng.uniform(0.01, 0.3, (n, 2))]
                             ).astype(np.float32) for n in (0, 3, 9)]
    for hc, wc in ((5, 8), (3, 4), (34, 60)):
        for g, w in zip(tdet.make_targets(boxes, hc, wc),
                        jdet.make_targets(boxes, hc, wc)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        for b in boxes:
            g = tproxy.cells_from_detections(b, hc, wc)
            w = jproxy.cells_from_detections(b, hc, wc)
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_iou_matches():
    rng = np.random.default_rng(13)
    for _ in range(20):
        a, b = (np.concatenate([rng.uniform(0, 1, 2), rng.uniform(0, 0.3, 2)]
                               ).astype(np.float32) for _ in range(2))
        assert tdet.iou(a, b) == jdet.iou(a, b)
    assert tdet.iou(a, a) == pytest.approx(1.0)


def _gt_tracks(clip):
    return [np.column_stack([t.frames, t.boxes,
                             np.full(len(t.frames), t.track_id)]
                            ).astype(np.float32)
            for t in clip.tracks if len(t.frames) >= 1]


def _examples(pkg_make_clip, build_examples, clip_ids=(0, 1)):
    out = []
    for cid in clip_ids:
        clip = pkg_make_clip("caldot1", "train", cid, n_frames=24)
        out.extend(build_examples(
            _gt_tracks(clip), lambda f, c=clip: c.render(f, *DET_RES),
            CFG.tracker.crop, clip_key=cid))
    return out


@pytest.fixture(scope="module")
def examples():
    return (_examples(make_clip, jtrk.build_examples),
            _examples(t_make_clip, ttrk.build_examples))


def test_build_examples_bit_for_bit(examples):
    want, got = examples
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        assert g.clip_key == w.clip_key
        for f in ("frames", "boxes", "crops"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def _reference_tracker_batches(monkeypatch, examples, **kw):
    """The arrays the reference's ``train_tracker`` feeds its loss, with
    its jit and value_and_grad swapped for a recorder (zero grads)."""
    seen = []

    def value_and_grad(fn):
        def run(params, *args):
            seen.append([np.asarray(a) for a in args])
            return 0.0, jax.tree.map(jnp.zeros_like, params)
        return run
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda f: f)
        m.setattr(jax, "value_and_grad", value_and_grad)
        jtrk.train_tracker(CFG.tracker, examples, **kw)
    return seen


@pytest.mark.parametrize("max_prefix", [6, 1])
def test_tracker_batches_bit_for_bit(monkeypatch, examples, max_prefix):
    want = _reference_tracker_batches(monkeypatch, examples[0], steps=3,
                                      batch=5, seed=2, max_prefix=max_prefix)
    got = list(ttrk.tracker_batches(CFG.tracker, examples[1], 3, 5,
                                    np.random.default_rng(2),
                                    max_prefix=max_prefix))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == len(w) == 7
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_window_size_selection_bit_for_bit():
    rng = np.random.default_rng(21)
    full = (16, 10)
    grids = []
    for _ in range(6):
        g = np.zeros((full[1], full[0]), np.int8)
        for _ in range(int(rng.integers(1, 4))):
            x, y = int(rng.integers(0, 13)), int(rng.integers(0, 8))
            g[y:y + int(rng.integers(1, 3)), x:x + int(rng.integers(1, 4))] = 1
        grids.append(g)
    tm_t = twin.detector_time_model(full, 0.0123)
    tm_j = jwin.detector_time_model(full, 0.0123)
    for size in ((1, 1), (4, 3), full):
        assert tm_t(size) == tm_j(size)
    got = twin.select_window_sizes(grids, full, 3, tm_t, max_windows=4)
    want = jwin.select_window_sizes(grids, full, 3, tm_j, max_windows=4)
    assert got == want and len(got) > 1


@pytest.mark.parametrize("full", [(16, 10), (20, 12), (60, 34)])
def test_group_cells_bit_for_bit_on_random_grids(full):
    # the port's merge loop keeps each cluster's centroid and bbox beside
    # it; the windows must be the reference's on every grid and size set
    rng = np.random.default_rng(full[0])
    wc, hc = full
    checked = merged = 0
    for trial in range(60):
        g = np.zeros((hc, wc), np.int8)
        for _ in range(int(rng.integers(0, 9))):
            x, y = int(rng.integers(0, wc)), int(rng.integers(0, hc))
            g[y:y + int(rng.integers(1, 4)), x:x + int(rng.integers(1, 5))] = 1
        sizes = [full] + [(int(rng.integers(1, wc)), int(rng.integers(1, hc)))
                          for _ in range(int(rng.integers(1, 4)))]
        times = [1.0] + [float(rng.choice([0.05, 0.1, 0.3, 0.5]))
                         for _ in sizes[1:]]
        ref = jwin.SizeSet(sizes, dict(zip(sizes, times)))
        port = twin.SizeSet(sizes, dict(zip(sizes, times)))
        for mw in (2, 8):
            want = jwin.group_cells(g, ref, mw)
            assert twin.group_cells(g, port, mw) == want
            checked += 1
            merged += len(want) < len(jwin.connected_components(g))
    assert checked == 120 and merged > 10


# ---------------------------------------------------------------------------
# Short fits from carried-over init
# ---------------------------------------------------------------------------

def _assert_losses_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= FIT_LOSS_RTOL * abs(w), (got, want)


def test_train_detector_short_fit_matches(monkeypatch):
    clips = [make_clip("caldot1", "train", 0, n_frames=12)]
    tclips = [t_make_clip("caldot1", "train", 0, n_frames=12)]
    res = [DET_RES]
    jd, jl = jtm.train_detector("ssd-lite", clips, res, steps=5, batch=2,
                                seed=3)
    init = bridge.detector_from_params(
        "ssd-lite", _np_tree(jdet.init_detector("ssd-lite", 3)))
    # the reference's init at the same seed, carried over
    monkeypatch.setattr(tdet, "init_detector", lambda arch, seed: init)
    td, tl = ttm.train_detector("ssd-lite", tclips, res, steps=5, batch=2,
                                seed=3, device="cpu")
    _assert_losses_close(tl, jl)
    assert tl[-1] < tl[0]
    _assert_trees_close(bridge.detector_to_params(td.net),
                        _np_tree(jd.params), FIT_PARAM_RTOL)


@pytest.fixture(scope="module")
def proxy_fit():
    """The reference's and the port's proxy fit from one init (the
    port's, carried over); -> (reference params, losses, port encoder,
    losses)."""
    cell, base = CFG.proxy.cell, CFG.proxy.base_channels
    jp = bridge.proxy_to_params(tproxy.init_proxy(cell, base, seed=0))
    rng = np.random.default_rng(5)
    W, H = CFG.proxy.resolutions[0]
    frames = rng.random((8, H, W, 3), dtype=np.float32)
    labels = (rng.random((8, H // cell, W // cell)) < 0.25).astype(np.int8)
    idx = [rng.integers(8, size=4) for _ in range(5)]
    jparams, jl = jtm._fit(
        lambda p, fr, lb: jproxy.proxy_loss(p, fr, lb, cell), jp,
        ((jnp.asarray(frames[i]), jnp.asarray(labels[i])) for i in idx))
    enc, tl = ttm._fit(tproxy.proxy_loss,
                       bridge.proxy_from_params(cell, base, jp),
                       ((frames[i], labels[i]) for i in idx))
    return _np_tree(jparams), jl, enc, tl


def test_proxy_short_fit_matches(proxy_fit):
    jparams, jl, enc, tl = proxy_fit
    _assert_losses_close(tl, jl)
    _assert_trees_close(bridge.proxy_to_params(enc), jparams,
                        FIT_PARAM_RTOL)


def test_train_tracker_short_fit_matches(monkeypatch, examples):
    jparams, jl = jtrk.train_tracker(CFG.tracker, examples[0], steps=5,
                                     batch=4, seed=1)
    init = bridge.tracker_from_params(
        CFG.tracker, _np_tree(jtrk.init_tracker(CFG.tracker, 1)), "cpu")
    monkeypatch.setattr(ttrk, "init_tracker", lambda cfg, seed, dev: init)
    tparams, tl = ttrk.train_tracker(CFG.tracker, examples[1], steps=5,
                                     batch=4, seed=1, device="cpu")
    _assert_losses_close(tl, jl)
    _assert_trees_close(bridge.tracker_to_params(tparams),
                        _np_tree(jparams), FIT_PARAM_RTOL)
    # the dict form the inference path takes: a CropCNN in eval mode
    # plus numpy heads, and the host tracker reads the trained heads
    assert isinstance(tparams["crop_cnn"], ttrk.CropCNN)
    assert not tparams["crop_cnn"].training
    host = ttrk.RecurrentTracker(CFG.tracker, tparams).np_params
    assert np.array_equal(host["match/w0"], tparams["match"]["w0"])
    assert not np.array_equal(host["match/w0"], init["match"]["w0"])


def test_train_tracker_without_examples_returns_init():
    params, losses = ttrk.train_tracker(CFG.tracker, [], steps=3, seed=2,
                                        device="cpu")
    init = ttrk.init_tracker(CFG.tracker, seed=2, device="cpu")
    assert losses == []
    assert np.array_equal(params["match"]["w0"], init["match"]["w0"])


# ---------------------------------------------------------------------------
# params.py round trips
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_trees(proxy_fit):
    """Parameter dicts the reference made (its inits, its proxy fit), and
    the carry-over functions of each kind."""
    cell, base = CFG.proxy.cell, CFG.proxy.base_channels
    return {
        "detector": (_np_tree(jdet.init_detector("ssd-lite", 1)),
                     lambda p: bridge.detector_from_params("ssd-lite", p),
                     bridge.detector_to_params),
        "proxy": (proxy_fit[0],
                  lambda p: bridge.proxy_from_params(cell, base, p),
                  bridge.proxy_to_params),
        "tracker": (_np_tree(jtrk.init_tracker(CFG.tracker, 3)),
                    lambda p: bridge.tracker_from_params(CFG.tracker, p,
                                                         "cpu"),
                    bridge.tracker_to_params),
        "blazeit": (_np_tree(build(jblz.def_frame_scorer, "init", seed=4)),
                    bridge.frame_scorer_from_params,
                    bridge.frame_scorer_to_params),
    }


def _port_inits():
    cell, base = CFG.proxy.cell, CFG.proxy.base_channels
    return {
        "detector": tdet.init_detector("ssd-lite", 1),
        "proxy": tproxy.init_proxy(cell, base, 2),
        "tracker": ttrk.init_tracker(CFG.tracker, 3, "cpu"),
        "blazeit": tblz.init_frame_scorer(4),
    }


def _port_state(kind, obj):
    if kind == "tracker":
        out = {f"crop_cnn.{k}": v for k, v in
               obj["crop_cnn"].state_dict().items()}
        for scope in ttrk.HEAD_SCOPES:
            out.update({f"{scope}.{k}": torch.from_numpy(np.asarray(v))
                        for k, v in obj[scope].items()})
        return out
    return obj.state_dict()


@pytest.mark.parametrize("kind", ["detector", "proxy", "tracker", "blazeit"])
def test_params_round_trip_reference_to_port_to_reference(reference_trees,
                                                         kind):
    tree, to_port, to_ref = reference_trees[kind]
    _assert_trees_equal(to_ref(to_port(tree)), tree)


@pytest.mark.parametrize("kind", ["detector", "proxy", "tracker", "blazeit"])
def test_params_round_trip_port_to_reference_to_port(reference_trees, kind):
    _, to_port, to_ref = reference_trees[kind]
    obj = _port_inits()[kind]
    back = to_port(to_ref(obj))
    want, got = _port_state(kind, obj), _port_state(kind, back)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
