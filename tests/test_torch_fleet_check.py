"""The fleet's comparison in ``chip_smoke.py`` (``assignment_flip``,
``held_to``), which the fleet and live-ingest phases hold a brokered
stream or a live clip to its solo run with, and the host solver's
distance from the optimum that it allows (``optimality_gap``,
``tools/jv_gap.py``), on the CPU: what they let through and what they
stop."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("scipy")

from scipy.optimize import linear_sum_assignment  # noqa: E402

from repro_torch.configs.multiscope import TrackerConfig  # noqa: E402
from repro_torch.core.hungarian import (  # noqa: E402
    BIG, DEVICE_JV_GAP, FORBIDDEN_DEVICE, hungarian_device_np,
    optimality_gap)
from repro_torch.core.pipeline import RunResult  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
THR = TrackerConfig().match_threshold


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod              # its dataclasses
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    try:
        yield _load("chip_smoke", ROOT / "chip_smoke.py")
    finally:
        sys.modules.pop("chip_smoke", None)


@pytest.fixture(scope="module")
def jv_gap():
    try:
        yield _load("jv_gap", ROOT / "tools" / "jv_gap.py")
    finally:
        sys.modules.pop("jv_gap", None)


def _exact_pairs(cost):
    """scipy's optimum of the real matrix, forbidden pairs dropped."""
    rows, cols = linear_sum_assignment(np.minimum(cost, FORBIDDEN_DEVICE))
    return {(int(r), int(c)) for r, c in zip(rows, cols)
            if cost[r, c] < BIG / 2}


def test_optimality_gap_is_zero_at_the_optimum():
    rng = np.random.default_rng(0)
    for n, m in ((3, 5), (8, 8), (12, 4)):
        cost = rng.uniform(0, 0.8, (n, m)).astype(np.float32)
        cost[rng.uniform(size=(n, m)) < 0.3] = BIG
        assert abs(optimality_gap(cost, _exact_pairs(cost))) < 1e-9


def test_optimality_gap_counts_a_worse_and_a_dropped_pair():
    cost = np.array([[0.1, 0.5], [0.6, 0.2]], np.float32)
    assert optimality_gap(cost, {(0, 0), (1, 1)}) == pytest.approx(0.0)
    assert optimality_gap(cost, {(0, 1), (1, 0)}) == pytest.approx(
        0.8, abs=1e-6)
    assert optimality_gap(cost, {(0, 0)}) >= FORBIDDEN_DEVICE - 1.0


@pytest.mark.parametrize("family", ["sparse", "ties", "dense"])
def test_host_jv_lies_within_the_allowed_gap_of_the_optimum(jv_gap,
                                                           family):
    """The measured bound the fleet's comparison allows: seeded
    tracker-shaped matrices (up to 16 tracks, so padded sides 8-32)."""
    rng = np.random.default_rng(1)
    gaps = [optimality_gap(c, hungarian_device_np(c)) for c in
            (jv_gap.cost_matrix(rng, family, THR, 16) for _ in range(40))]
    assert min(gaps) > -1e-9
    assert max(gaps) <= DEVICE_JV_GAP


def test_jv_gap_tool_reports_and_passes(jv_gap, capsys, monkeypatch):
    monkeypatch.setattr(jv_gap, "TrackerConfig",
                        lambda: TrackerConfig(max_tracks=8))
    assert jv_gap.main(["--matrices", "12", "--seed", "3"]) == 0
    out = capsys.readouterr().out
    assert "largest gap over 12 matrices (seed 3)" in out
    assert "side    8 sparse" in out


def _pair(a, p, b, q):
    return [(np.asarray(b, np.float32), q)], [(np.asarray(a, np.float32), p)]


P = {(0, 0), (1, 1)}
Q = {(0, 1), (1, 0)}


def test_assignment_flip_same_pairs_is_none(smoke):
    a = [[0.1, 0.3], [0.4, 0.2]]
    got, want = _pair(a, P, a, P)
    assert smoke.assignment_flip(got, want, THR, "t") is None


def test_assignment_flip_tie_within_the_drift(smoke):
    a = [[0.1, 0.2], [0.2, 0.1]]               # A(q) - A(p) = 0.2
    b = [[0.15, 0.2], [0.2, 0.15]]             # moved by 0.05 > atol
    got, want = _pair(a, P, b, Q)
    with pytest.raises(AssertionError, match="costs moved"):
        smoke.assignment_flip(got, want, THR, "t")
    a = np.float32([[0.1, 0.2], [0.2, 0.1]])
    a[0, 1] = a[1, 0] = np.float32(0.1) + np.float32(1e-7)
    got, want = _pair(a, P, a + np.float32(1e-6), Q)
    how, k, gap, limit = smoke.assignment_flip(got, want, THR, "t")
    assert how == "tie" and k == 0 and gap <= limit


def test_assignment_flip_solver_flip_within_the_allowed_gap(smoke):
    """The live phase's 5-frame flip in small: q dearer than p by 1.5e-5
    at the solo costs, far more than the costs moved, but each within
    the f32 JV's allowed gap of its own optimum: a solver flip, not a
    fault."""
    a = np.float32([[0.3, 0.3], [0.3, 0.3]])
    a[0, 1] += np.float32(1.5e-5)
    b = a.copy()
    b[0, 0] += np.float32(2e-7)
    got, want = _pair(a, P, b, Q)
    how, k, gap, limit, gp, gq = smoke.assignment_flip(got, want, THR, "t")
    assert how == "solver" and gap > limit
    assert gp == pytest.approx(0.0, abs=1e-9)
    assert 0 < gq <= DEVICE_JV_GAP


def test_assignment_flip_raises_on_an_assignment_off_its_optimum(smoke):
    """A stream whose tracker took pairs a tenth dearer than its own
    costs' optimum: not a flip the drift or the solver explains."""
    a = [[0.1, 0.2], [0.2, 0.1]]
    got, want = _pair(a, P, a, Q)
    with pytest.raises(AssertionError, match="exact optimum"):
        smoke.assignment_flip(got, want, THR, "t")


def test_assignment_flip_gate_and_length(smoke):
    a = np.float32([[0.1, 0.9], [0.9, 0.1]])
    b = a.copy()
    a[0, 1] = BIG
    b[0, 1] = np.float32(1.0 - THR)            # gated on one side only
    got, want = _pair(a, P, b, Q)
    how, k, off = smoke.assignment_flip(got, want, THR, "t")
    assert how == "gate" and max(off) <= smoke.FLEET_COST_ATOL
    got, want = _pair(a, P, a, P)
    with pytest.raises(AssertionError, match="assignments against"):
        smoke.assignment_flip(got + got, want, THR, "t")


def _run(tracks, windows=4):
    return RunResult(tracks, 0.0, 4, windows, 1, 0)


def _track(dx=0.0):
    t = np.zeros((3, 6), np.float32)
    t[:, 0] = [0, 1, 2]
    t[:, 1:5] = np.float32([0.1, 0.2, 0.3, 0.4]) + np.float32(dx)
    return t


def _log(smoke, rows, assigns=()):
    lg = smoke.ScoreLog()
    lg.rows[0] = [np.asarray(r, np.float32) for r in rows]
    lg.assigns[0] = list(assigns)
    return lg


def test_held_to_exact_and_within_the_tolerances(smoke):
    rows = [np.full((2, 1, 3), 0.2), np.full((1, 2, 2), 0.3)]
    want, same = _log(smoke, rows), _log(smoke, rows)
    d, flip = smoke.held_to(_run([_track()]), _run([_track()]), same, want,
                            (0, 0), True, 0.0, 0.5, THR, "t")
    assert d == 0.0 and flip is None
    with pytest.raises(AssertionError, match="bits"):
        smoke.held_to(_run([_track(1e-6)]), _run([_track()]), same, want,
                      (0, 0), True, 0.0, 0.5, THR, "t")
    moved = _log(smoke, [r + 1e-7 for r in rows])
    with pytest.raises(AssertionError, match="beyond 0.0"):
        smoke.held_to(_run([_track()]), _run([_track()]), moved, want,
                      (0, 0), True, 1e-6, 0.5, THR, "t")
    d, flip = smoke.held_to(_run([_track(1e-6)]), _run([_track()]), moved,
                            want, (0, 0), False, 1e-6, 0.5, THR, "t")
    assert 0 < d <= 1e-6 and flip is None
    with pytest.raises(AssertionError, match="boxes differ"):
        smoke.held_to(_run([_track(1e-3)]), _run([_track()]), moved, want,
                      (0, 0), False, 1e-6, 0.5, THR, "t")


def test_held_to_groups_live_rows_by_shape(smoke):
    """A clip appended in segments lists each crop shape's rows in other
    calls than the one-shot run: held by shape, they agree."""
    one = [np.arange(12, dtype=np.float32).reshape(4, 1, 3) / 20]
    split = [one[0][:1], one[0][1:]]
    with pytest.raises(AssertionError, match="detector rows"):
        smoke.held_to(_run([_track()]), _run([_track()]),
                      _log(smoke, split), _log(smoke, one), (0, 0), True,
                      0.0, 0.5, THR, "t")
    d, flip = smoke.held_to(_run([_track()]), _run([_track()]),
                            _log(smoke, split), _log(smoke, one), (0, 0),
                            True, 0.0, 0.5, THR, "t", by_shape=True)
    assert d == 0.0 and flip is None


def test_held_to_flip_holds_counters_only_and_never_when_exact(smoke):
    a = np.float32([[0.3, 0.3], [0.3, 0.3]])
    a[0, 1] += np.float32(1.5e-5)
    rows = [np.full((1, 1, 2), 0.2)]
    want = _log(smoke, rows, [(a, P)])
    got = _log(smoke, rows, [(a, Q)])
    d, flip = smoke.held_to(_run([_track(0.5)]), _run([_track()]), got,
                            want, (0, 0), False, 1e-6, 0.5, THR, "t")
    assert flip[0] == "assignment" and flip[1][0] == "solver"
    with pytest.raises(AssertionError, match="counters|RunResult"):
        smoke.held_to(_run([_track()], windows=5), _run([_track()]), got,
                      want, (0, 0), False, 1e-6, 0.5, THR, "t")
    with pytest.raises(AssertionError, match="no drift"):
        smoke.held_to(_run([_track()]), _run([_track()]), got, want,
                      (0, 0), True, 0.0, 0.5, THR, "t")
