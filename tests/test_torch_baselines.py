"""The port's baselines (Chameleon, Miris, BlazeIt) against the JAX
package's, on the CPU, at the reduced configuration.

Selection is held with evaluation stubbed by one deterministic table in
both packages: Chameleon's ``_evaluate``, and Miris's and BlazeIt's
``run_clip`` (a clip's ground-truth tracks, kept or dropped by a hash of
the knob and the clip, with seconds from the same hash).  ``pareto`` and
each ``select`` must then give the same points: params, module names
and every number.  Unstubbed, the port's BlazeIt scorer is held to the
reference's on the same frames at carried-over weights, and the port's
BlazeIt and Miris train and run end to end on the CPU.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.baselines.blazeit as jblz  # noqa: E402
import repro.core.baselines.chameleon as jcham  # noqa: E402
import repro.core.baselines.miris as jmir  # noqa: E402
import repro.core.pipeline as jpl  # noqa: E402
import repro.core.tuner as jtun  # noqa: E402
from repro.configs.multiscope import MULTISCOPE_PIPELINE as J_CFG  # noqa: E402
from repro.data.video_synth import make_split as j_make_split  # noqa: E402

import repro_torch.core.baselines.blazeit as tblz  # noqa: E402
import repro_torch.core.baselines.chameleon as tcham  # noqa: E402
import repro_torch.core.baselines.miris as tmir  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
import repro_torch.core.tuner as ttun  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE as T_CFG  # noqa: E402
from repro_torch.core.detector import Detector  # noqa: E402
from repro_torch.core.tracker import build_examples, init_tracker  # noqa: E402
from repro_torch.data.video_synth import make_split as t_make_split  # noqa: E402


def _theta_key(p):
    return tuple(getattr(p, f.name) for f in dataclasses.fields(p))


def _hash01(*parts) -> float:
    return zlib.crc32(repr(parts).encode()) / 2.0 ** 32


def _same_points(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _theta_key(g.params) == _theta_key(w.params)
        assert (g.val_accuracy, g.val_seconds, g.module) == \
            (w.val_accuracy, w.val_seconds, w.module)


class _Bank:
    """What selection reads of a bank: its config."""

    def __init__(self, cfg):
        self.cfg = cfg


def _gt_tracks(clip):
    return [np.column_stack([t.frames, t.boxes,
                             np.full(len(t.frames), t.track_id)]
                            ).astype(np.float32)
            for t in clip.tracks if len(t.frames)]


def _table_run(pkg_pl):
    """A stand-in run_clip: GT tracks kept by a hash of (θ, clip, knob)."""
    def run_clip(self, params, clip, knob):
        key = (_theta_key(params), clip.clip_id, float(knob))
        tracks = [t for i, t in enumerate(_gt_tracks(clip))
                  if _hash01(key, i) < 0.35 + 0.6 * float(knob)]
        return pkg_pl.RunResult(tracks, 0.1 + _hash01(key), clip.n_frames,
                                0, 0, 0)
    return run_clip


def _eval_table(bank, params, clips):
    h = _hash01(_theta_key(params), len(clips))
    W, H = params.det_res
    return (0.5 + 0.3 * W * H / (256 * 160) - 0.03 * params.gap + 0.1 * h,
            len(clips) * (0.05 + W * H / (256 * 160) / params.gap + 0.05 * h))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_matches(seed):
    rng = np.random.default_rng(seed)
    vals = [(float(a), float(t)) for a, t in zip(
        rng.choice([0.5, 0.6, 0.7, 0.8], 14), rng.choice([1.0, 2.0, 3.0], 14))]
    jp = [jtun.TunerPoint(jpl.PipelineParams("ssd-lite", (128, 80), 0.5,
                                             gap=i + 1), a, t, f"m{i}")
          for i, (a, t) in enumerate(vals)]
    tp = [ttun.TunerPoint(tpl.PipelineParams("ssd-lite", (128, 80), 0.5,
                                             gap=i + 1), a, t, f"m{i}")
          for i, (a, t) in enumerate(vals)]
    _same_points(tcham.pareto(tp), jcham.pareto(jp))


def test_chameleon_select_matches(monkeypatch):
    monkeypatch.setattr(jcham, "_evaluate", _eval_table)
    monkeypatch.setattr(tcham, "_evaluate", _eval_table)
    jv = j_make_split("caldot1", "val", 2, 8)
    tv = t_make_split("caldot1", "val", 2, 8)
    want = jcham.ChameleonBaseline(_Bank(J_CFG.reduced())).select(jv)
    got = tcham.ChameleonBaseline(_Bank(T_CFG.reduced())).select(tv)
    _same_points(got, want)
    assert all(p.module == "grid" for p in got)


@pytest.mark.parametrize("name", ["miris", "blazeit"])
def test_miris_and_blazeit_select_match(monkeypatch, name):
    jcls = jmir.MirisBaseline if name == "miris" else jblz.BlazeItBaseline
    tcls = tmir.MirisBaseline if name == "miris" else tblz.BlazeItBaseline
    monkeypatch.setattr(jcls, "run_clip", _table_run(jpl))
    monkeypatch.setattr(tcls, "run_clip", _table_run(tpl))
    jv = j_make_split("caldot1", "val", 3, 16)
    tv = t_make_split("caldot1", "val", 3, 16)
    want = jcls(_Bank(J_CFG.reduced())).select(jv)
    got = tcls(_Bank(T_CFG.reduced())).select(tv)
    _same_points(got, want)
    assert len({p.val_accuracy for p in got}) == len(got)


# ---------------------------------------------------------------------------
# Unstubbed
# ---------------------------------------------------------------------------

def test_frame_score_matches_reference():
    scorer = tblz.init_frame_scorer(3)
    jp = bridge.frame_scorer_to_params(scorer)
    frames = np.random.default_rng(4).random((5, 48, 64, 3),
                                             dtype=np.float32)
    want = np.asarray(jblz.frame_score(jp, jnp.asarray(frames)))
    with torch.no_grad():
        got = tblz.frame_score(scorer, torch.from_numpy(frames)).numpy()
    assert got.shape == (5,)
    assert np.max(np.abs(got - want)) <= 2e-5


@pytest.fixture(scope="module")
def bank():
    cfg = T_CFG.reduced()
    det = Detector("ssd-lite", seed=0, device="cpu")
    return tpl.ModelBank(cfg, {"ssd-lite": det, "ssd-deep": det},
                         tracker_params=init_tracker(cfg.tracker, 0, "cpu"),
                         device="cpu")


def test_blazeit_trains_and_runs_on_the_cpu(bank):
    clips = t_make_split("caldot1", "train", 1, 12)
    det = bank.detectors["ssd-lite"]
    train_dets = [(c, f, det.detect_batch(c.render(f, 128, 80)[None],
                                          0.5)[0])
                  for c in clips for f in range(c.n_frames)]
    blaze = tblz.BlazeItBaseline(bank)
    blaze.train(train_dets, steps=3)
    assert isinstance(blaze.cls_params, tblz.FrameScorer)
    assert not blaze.cls_params.training
    params = tpl.PipelineParams("ssd-lite", (128, 80), 0.5, gap=1,
                                tracker="sort")
    clip = t_make_split("caldot1", "val", 1, 12)[0]
    none = blaze.run_clip(params, clip, 1.1)      # sigmoid < 1.1: skip all
    assert none.skipped_frames == 12 and none.tracks == []
    every = blaze.run_clip(params, clip, 0.0)
    assert every.skipped_frames == 0 and every.frames_processed == 12
    out = blaze.limit_query([clip], params, want=2, min_count=1,
                            region=(0.0, 0.0, 1.0, 1.0), min_spacing=4)
    assert set(out) == {"found", "pre_seconds", "query_seconds",
                        "detector_frames"}
    assert out["detector_frames"] >= len(out["found"])


def test_miris_trains_and_runs_on_the_cpu(bank):
    cfg = bank.cfg
    clip = t_make_split("caldot1", "train", 1, 16)[0]
    examples = build_examples(_gt_tracks(clip),
                              lambda f: clip.render(f, 128, 80),
                              cfg.tracker.crop)
    miris = tmir.MirisBaseline(bank)
    miris.train(examples, steps=2)
    assert set(miris.pair_params) == {"crop_cnn", "det_proj", "gru",
                                      "match"}
    params = tpl.PipelineParams("ssd-lite", (128, 80), 0.5, gap=1,
                                tracker="recurrent")
    res = miris.run_clip(params, clip, 0.5)
    assert 1 <= res.frames_processed <= clip.n_frames
    for t in res.tracks:
        assert np.all(np.diff(t[:, 0]) > 0)
