"""The port's tuner against the JAX package's, on the CPU, at the reduced
configuration, with every measurement stubbed by one deterministic table.

The tuner's decisions depend on measurements (validation accuracy and
seconds, detector, window and proxy seconds) and on the models' outputs.
Here both packages see the same numbers: ``_evaluate``,
``_measure_det_times``, ``_time_proxy`` and ``measure_window_time`` are
patched in each with one table keyed by θ's fields, the trainers return
stand-in models whose detections and proxy scores are seeded by the
pixels of the frame they are given (the simulator renders both packages'
frames bit for bit), and a θ_best run returns the clip's ground-truth
tracks.  Then ``setup``'s θ_best and window sizes, ``build_caches``'
entries (recall included), the three proposal functions and ``tune``'s
curve must be equal: params, module names and every number.

``run_dataset`` then runs the port end to end on the CPU (no stubs, one
clip a split, 16 frames, 2 steps), and ``table1_runtime`` is held to the
reference's on a fixed curve.
"""
import dataclasses
import math
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.experiment as jexp  # noqa: E402
import repro.core.pipeline as jpl  # noqa: E402
import repro.core.tuner as jtun  # noqa: E402
from repro.configs.multiscope import MULTISCOPE_PIPELINE as J_CFG  # noqa: E402
from repro.data.video_synth import make_split as j_make_split  # noqa: E402

import repro_torch.core.experiment as texp  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
import repro_torch.core.tuner as ttun  # noqa: E402
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE as T_CFG  # noqa: E402
from repro_torch.data.video_synth import make_split as t_make_split  # noqa: E402

CPU = torch.device("cpu")


def _hash01(*parts) -> float:
    return zlib.crc32(repr(parts).encode()) / 2.0 ** 32


def _theta_key(p):
    return tuple(getattr(p, f.name) for f in dataclasses.fields(p))


# ---------------------------------------------------------------------------
# One table of measurements and stand-in models for both packages
# ---------------------------------------------------------------------------

def _eval_table(bank, params, clips):
    W, H = params.det_res
    area = W * H / (256 * 160)
    h = _hash01(_theta_key(params), len(clips))
    deep = params.det_arch == "ssd-deep"
    acc = (0.45 + 0.3 * math.sqrt(area) + (0.05 if deep else 0.0)
           - 0.04 * math.log2(params.gap)
           + (0.02 if params.tracker == "recurrent" else 0.0)
           - (0.03 * params.proxy_threshold if params.proxy_res else 0.0)
           + 0.06 * h)
    secs = len(clips) * (0.02 + 0.4 * area * (1.6 if deep else 1.0)
                         / params.gap
                         * (0.45 if params.proxy_res else 1.0)
                         * (16 / (params.chunk_size or 16)) ** 0.1
                         * (1.0 + 0.1 * h))
    return acc, secs


def _det_times(bank, cfg):
    for arch in cfg.detector.archs:
        for W, H in cfg.detector.resolutions:
            bank.det_times[(arch, (W, H))] = (
                1e-3 * W * H / (256 * 160) * (1.5 if arch == "ssd-deep"
                                              else 1.0))


def _proxy_time(proxy):
    W, H = proxy.resolution
    return 1e-4 * W * H / (64 * 40)


def _window_time(bank, arch, size):
    return 1e-4 + 1e-3 * size[0] * size[1] / 160 * (
        1.5 if arch == "ssd-deep" else 1.0)


def _pixel_rng(frame) -> np.random.Generator:
    return np.random.default_rng(
        zlib.crc32(np.ascontiguousarray(frame, np.float32).tobytes()))


class FakeDetector:
    """Detections seeded by each frame's pixels."""

    def __init__(self, arch):
        self.arch = arch
        self.device = CPU
        self.dispatches = 0

    def detect_batch(self, frames, conf, origins=None, scales=None,
                     max_dets=64, n_valid=None):
        frames = np.asarray(frames)
        out = []
        for fr in frames[:len(frames) if n_valid is None else n_valid]:
            rng = _pixel_rng(fr)
            n = int(rng.integers(0, 6))
            out.append(np.column_stack([
                rng.uniform(0.05, 0.95, (n, 2)),
                rng.uniform(0.04, 0.25, (n, 2)),
                rng.uniform(conf, 1.0, (n, 1))]).astype(np.float32))
        return out


class FakeProxy:
    """Score grids seeded by each frame's pixels."""

    def __init__(self, cell, base_channels, resolution, **_):
        self.cell = cell
        self.resolution = resolution
        self.device = CPU
        self.params = {}
        self.encoder = None

    def scores(self, frame, threshold=0.5):
        W, H = self.resolution
        s = _pixel_rng(frame).random((H // self.cell, W // self.cell)
                                     ).astype(np.float32)
        return s, (s > threshold).astype(np.int8)


def _gt_run(pkg_pl):
    def run_clip(bank, params, clip, engine="streaming"):
        tracks = [np.column_stack([t.frames, t.boxes,
                                   np.full(len(t.frames), t.track_id)]
                                  ).astype(np.float32)
                  for t in clip.tracks if len(t.frames)]
        return pkg_pl.RunResult(tracks, 0.0, clip.n_frames, 0, 0, 0)
    return run_clip


def _stub(m):
    for tun, pl in ((jtun, jpl), (ttun, tpl)):
        m.setattr(tun, "_evaluate", _eval_table)
        m.setattr(tun, "_measure_det_times", _det_times)
        m.setattr(tun, "_time_proxy", _proxy_time)
        m.setattr(pl, "measure_window_time", _window_time)
        m.setattr(pl, "run_clip", _gt_run(pl))
        m.setattr(tun, "train_detector",
                  lambda arch, *a, **k: (FakeDetector(arch), []))
        m.setattr(tun, "_fit", lambda loss, p, batches, **k: (p, []))
        m.setattr(tun, "train_tracker", lambda *a, **k: (None, []))
        m.setattr(tun, "ProxyModel", FakeProxy)


def _splits(make_split):
    return (make_split("caldot1", "train", 2, 16),
            make_split("caldot1", "val", 2, 16))


QUIET = lambda *_: None  # noqa: E731


class TestStubbed:
    """Both packages under the one table (patched for this class only)."""

    @pytest.fixture(scope="class")
    def systems(self):
        """setup in both packages on the same clips and the same table."""
        with pytest.MonkeyPatch.context() as m:
            _stub(m)
            jsys = jtun.setup(J_CFG.reduced(), *_splits(j_make_split),
                              detector_steps=1, proxy_steps=1,
                              tracker_steps=1, log=QUIET)
            tsys = ttun.setup(T_CFG.reduced(), *_splits(t_make_split),
                              detector_steps=1, proxy_steps=1,
                              tracker_steps=1, log=QUIET, device="cpu")
            yield jsys, tsys

    @pytest.fixture(scope="class")
    def caches(self, systems):
        jsys, tsys = systems
        return (jtun.build_caches(jsys, _splits(j_make_split)[1], QUIET),
                ttun.build_caches(tsys, _splits(t_make_split)[1], QUIET))

    def test_setup_theta_best_and_window_sizes_equal(self, systems):
        jsys, tsys = systems
        assert _theta_key(tsys.theta_best) == _theta_key(jsys.theta_best)
        # the table makes the descent stop short of the last resolution
        assert tsys.theta_best.det_res != \
            T_CFG.reduced().detector.resolutions[-1]
        assert tsys.bank.sizes_cells == jsys.bank.sizes_cells
        assert len(tsys.bank.sizes_cells) > 1
        assert tsys.bank.ref_grid == jsys.bank.ref_grid
        assert tsys.bank.det_times == jsys.bank.det_times
        assert set(tsys.bank.proxies) == set(jsys.bank.proxies)
        assert set(tsys.setup_seconds) == set(jsys.setup_seconds)
        assert len(tsys.bank.refiner.clusters) == \
            len(jsys.bank.refiner.clusters)

    def test_build_caches_entries_equal(self, caches):
        (jdc, jpc), (tdc, tpc) = caches
        assert tdc.entries == jdc.entries and len(tdc.entries) == 8
        assert list(tpc.entries) == list(jpc.entries)
        assert tpc.entries == jpc.entries    # est. seconds and recall exact
        recalls = {r for _, r in tpc.entries.values()}
        assert len(recalls) > 2 and min(recalls) < 1.0
        assert tpc.t_frame_full == jpc.t_frame_full

    def test_proposals_equal(self, systems, caches):
        (jdc, jpc), (tdc, tpc) = caches
        jth = _thetas(jpl, J_CFG.reduced())
        tth = _thetas(tpl, T_CFG.reduced())
        for (sys_, pc), th in (((systems[0], jpc), jth),
                               ((systems[1], tpc), tth)):
            res, thr = list(pc.entries)[3]
            th.append(sys_.theta_best)
            th.append(dataclasses.replace(sys_.theta_best, proxy_res=res,
                                          proxy_threshold=thr))
        made = 0
        for j, t in zip(jth, tth):
            for S in (0.3, 0.6):
                for jp, tp in ((jdc.propose(j, S), tdc.propose(t, S)),
                               (jpc.propose(j, S), tpc.propose(t, S))):
                    assert (tp is None) == (jp is None)
                    if tp is not None:
                        made += 1
                        assert _theta_key(tp) == _theta_key(jp)
            jc, tc = jtun.propose_chunk(j), ttun.propose_chunk(t)
            assert (tc is None) == (jc is None)
            if tc is not None:
                assert _theta_key(tc) == _theta_key(jc)
        assert made > 10

    def test_tune_curve_equal(self, systems):
        jsys, tsys = systems
        jcurve = jtun.tune(jsys, _splits(j_make_split)[1], log=QUIET)
        tcurve = ttun.tune(tsys, _splits(t_make_split)[1], log=QUIET)
        assert len(tcurve) == len(jcurve) > 2
        for g, w in zip(tcurve, jcurve):
            assert _theta_key(g.params) == _theta_key(w.params)
            assert (g.val_accuracy, g.val_seconds, g.module) == \
                (w.val_accuracy, w.val_seconds, w.module)
        assert tsys.curve is tcurve
        assert {p.module for p in tcurve} - {"init"}


def _thetas(pkg_pl, cfg):
    r = cfg.detector.resolutions
    out = []
    for arch in cfg.detector.archs:
        for res in (r[0], r[2]):
            for gap in (1, 4):
                for pres, th in ((None, 0.5), (cfg.proxy.resolutions[1],
                                               0.3)):
                    for chunk in (None, 32, 64):
                        out.append(pkg_pl.PipelineParams(
                            arch, res, 0.55, gap=gap, proxy_res=pres,
                            proxy_threshold=th, tracker="sort",
                            chunk_size=chunk))
    return out


# ---------------------------------------------------------------------------
# Unstubbed, port only
# ---------------------------------------------------------------------------

def test_tuner_timers_on_the_cpu_are_process_time(monkeypatch):
    """A CPU bank times one frame, as the reference: the card's batched
    timing is for CUDA banks only."""
    from repro_torch.core.detector import Detector
    from repro_torch.core.proxy import ProxyModel
    det = Detector("ssd-lite", seed=0, device="cpu")
    shapes = []
    real = det.detect_batch
    monkeypatch.setattr(det, "detect_batch", lambda f, c, **k: (
        shapes.append(tuple(f.shape)), real(f, c, **k))[1])
    bank = tpl.ModelBank(T_CFG.reduced(), {"ssd-lite": det}, device="cpu")
    assert tpl.measure_window_time(bank, "ssd-lite", (3, 2)) >= 0.0
    assert set(shapes) == {(1, 32, 48, 3)} and len(shapes) == 4
    proxy = ProxyModel(8, 4, (32, 24), device="cpu")
    assert ttun._time_proxy(proxy) >= 0.0


def test_warm_key_holds_the_device(monkeypatch):
    runs = []
    monkeypatch.setattr(ttun, "_WARMED", set())
    monkeypatch.setattr(tpl, "run_clip",
                        lambda bank, p, c: runs.append(str(bank.device)))
    monkeypatch.setattr(tpl, "run_split", lambda bank, p, clips: (
        [tpl.RunResult([], 0.25, 1, 0, 0, 0) for _ in clips], 0.5))

    class Bank:
        device = CPU
    clips = t_make_split("caldot1", "val", 2, 8)
    p = tpl.PipelineParams("ssd-lite", (128, 80), 0.55)
    for _ in range(2):
        acc, secs = ttun._evaluate(Bank(), p, clips)
    assert runs == ["cpu"] and secs == 0.5
    assert ("ssd-lite", (128, 80), None, "recurrent", None, "cpu") \
        in ttun._WARMED


def test_run_dataset_end_to_end_on_the_cpu(tmp_path):
    res = texp.run_dataset("caldot1", n_train=1, n_val=1, n_test=1,
                           n_frames=16, detector_steps=2, tracker_steps=2,
                           log=lambda *_: None, device="cpu")
    assert set(res) == {"dataset", "n_clips", "theta_best", "setup_seconds",
                        "curves", "best_accuracy", "table1_runtime_at_5pct",
                        "wall_seconds"}
    assert set(res["curves"]) == {"multiscope", "chameleon", "blazeit",
                                  "miris"}
    assert set(res["setup_seconds"]) == {
        "detector_train", "theta_best", "theta_best_labels", "proxy_train",
        "window_sizes", "tracker_train"}
    for curve in res["curves"].values():
        assert curve
        for c in curve:
            assert set(c) == {"params", "module", "val_accuracy",
                              "val_seconds", "test_accuracy", "test_seconds"}
            assert 0.0 <= c["test_accuracy"] <= 1.0 and c["test_seconds"] >= 0
    assert res["best_accuracy"] == max(
        c["test_accuracy"] for cv in res["curves"].values() for c in cv)


@pytest.mark.parametrize("best,slack", [(0.9, 0.05), (0.95, 0.0), (2.0, 0.1)])
def test_table1_runtime_matches(best, slack):
    curve = [{"test_accuracy": a, "test_seconds": s} for a, s in
             ((0.92, 3.0), (0.88, 1.5), (0.95, 4.5), (0.5, 0.2),
              (0.86, 1.2))]
    assert texp.table1_runtime(curve, best, slack) == \
        jexp.table1_runtime(curve, best, slack)
