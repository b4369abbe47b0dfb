"""The port's device tracker flavours against its host tracker and the JAX
package's trackers, on the CPU, at the reduced tracker config.

``RecurrentTracker(assign="device")`` (one ``track_step`` per frame) and
``DeviceTracker`` (the chunk's recurrence in slot buffers) run here on
CPU tensors, so ``track_step`` takes its plain version.  Fed the same
detections, crop embeddings and weights (the reference's, moved by
``repro_torch.params``), every flavour must give the host tracker's
tracks and GRU states bit for bit, and the reference's same flavour must
give them too.  The streams have frame gaps > 1, objects that drop out
and come back, and a max_tracks overflow (more detections than slots).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.tracker as jtrk  # noqa: E402
from repro.configs.multiscope import MULTISCOPE_PIPELINE as J_CFG  # noqa: E402

import repro_torch.core.pipeline as tpl  # noqa: E402
import repro_torch.core.tracker as ttrk  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE as T_CFG  # noqa: E402
from repro_torch.kernels.track_step import track_step  # noqa: E402

CFG = J_CFG.reduced().tracker          # embed 16, GRU 32, max_tracks 32


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops run faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = jtrk.init_tracker(CFG, seed=3)
    tp = bridge.tracker_from_params(CFG, jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def _stream(seed, n_frames, n_obj):
    """Per frame (frame index, (n, 5) detections, (n, e) embeddings):
    objects moving linearly, each seen with probability 0.8, shuffled;
    frame gaps of 1 to 3."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n_obj, 2))
    vel = (rng.random((n_obj, 2)) - 0.5) * 0.02
    emb = rng.standard_normal((n_obj, CFG.embed_dim)).astype(np.float32)
    f, out = 0, []
    for _ in range(n_frames):
        idx = np.flatnonzero(rng.random(n_obj) < 0.8)
        rng.shuffle(idx)
        dets = np.zeros((len(idx), 5), np.float32)
        dets[:, :2] = pos[idx] + vel[idx] * f
        dets[:, 2:4] = 0.05
        dets[:, 4] = 0.9
        x = (emb[idx] + 0.1 * rng.standard_normal((len(idx), CFG.embed_dim))
             ).astype(np.float32)
        out.append((f, dets, x))
        f += int(rng.integers(1, 4))
    return out


def _run(tracker, data, chunk):
    for c in range(0, len(data), chunk):
        part = data[c:c + chunk]
        tracker.step_chunk([d[0] for d in part], [d[1] for d in part],
                           [None] * len(part), embeds=[d[2] for d in part])
    return tracker


def _assert_same(a, b):
    ra, rb = a.result(), b.result()
    assert len(ra) == len(rb) > 0
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x, y)
    assert len(a.active) == len(b.active)
    for s, t in zip(a.active, b.active):
        assert s.track_id == t.track_id and s.misses == t.misses
        np.testing.assert_array_equal(np.asarray(s.h).view(np.int32),
                                      np.asarray(t.h).view(np.int32))


def _port(kind, tp):
    if kind == "scan":
        return ttrk.DeviceTracker(CFG, tp)
    return ttrk.RecurrentTracker(CFG, tp, assign=kind)


def _reference(kind, jp):
    if kind == "scan":
        return jtrk.DeviceTracker(CFG, jp)
    return jtrk.RecurrentTracker(CFG, jp, assign=kind)


@pytest.mark.parametrize("kind,chunk", [("device", 1), ("device", 6),
                                        ("scan", 1), ("scan", 6)])
def test_device_flavours_match_host_and_reference(weights, kind, chunk):
    jp, tp = weights
    data = _stream(1, 18, 10)
    host = _run(ttrk.RecurrentTracker(CFG, tp), data, chunk)
    dev = _run(_port(kind, tp), data, chunk)
    _assert_same(dev, host)
    _assert_same(dev, _run(_reference(kind, jp), data, chunk))


@pytest.mark.parametrize("kind", ["device", "scan"])
def test_max_tracks_overflow(weights, kind):
    """40 objects against 32 slots of capacity: the overflow keeps the
    longest tracks (stable on list order) in every flavour."""
    jp, tp = weights
    data = _stream(2, 8, 40)
    assert max(len(d[1]) for d in data) > CFG.max_tracks
    host = _run(ttrk.RecurrentTracker(CFG, tp), data, 4)
    assert len(host.active) == CFG.max_tracks
    dev = _run(_port(kind, tp), data, 4)
    _assert_same(dev, host)
    _assert_same(dev, _run(_reference(kind, jp), data, 4))


def test_dispatch_counts(weights):
    """A device step counts one dispatch per frame with detections, the
    chunk scan one per chunk, as the reference counts them; the plain
    version on CPU tensors counts no kernel launch."""
    _, tp = weights
    data = _stream(4, 6, 5)
    before = track_step.launches
    dev = _run(ttrk.RecurrentTracker(CFG, tp, assign="device"), data, 3)
    scan = _run(ttrk.DeviceTracker(CFG, tp), data, 3)
    host = _run(ttrk.RecurrentTracker(CFG, tp), data, 3)
    assert dev.dispatches == sum(len(d[1]) > 0 for d in data)
    assert scan.dispatches == 2
    assert host.dispatches == 0
    assert track_step.launches == before


def test_make_tracker_selects_flavour(weights):
    _, tp = weights
    cfg = T_CFG.reduced()
    bank = tpl.ModelBank(cfg, {}, tracker_params=tp, device="cpu")
    p = tpl.PipelineParams("ssd-lite", (128, 80), 0.5)
    assert tpl.make_tracker(bank, p).assign == "host"
    assert tpl.make_tracker(bank, p, device_assign=True).assign == "device"
    assert isinstance(tpl.make_tracker(bank, p, device_tracker=True),
                      ttrk.DeviceTracker)
    with pytest.raises(ValueError):
        ttrk.RecurrentTracker(CFG, tp, assign="gpu")


def _spy_track_step(monkeypatch, fail_at=None):
    """Record every ``track_step`` call of the chunk scan (its ``err``
    argument); with ``fail_at``, that call sets the flag as a capped
    solve would."""
    calls = []

    def spy(*args, err=None):
        calls.append(err)
        if len(calls) == fail_at:
            err.fill_(1)
        return track_step(*args, err=err)
    monkeypatch.setattr(ttrk, "track_step", spy)
    return calls


def test_chunk_scan_checks_one_flag_per_chunk(weights, monkeypatch):
    """Every frame of a chunk gets the same (1,) int32 flag on the
    device, a fresh one each chunk, and the tracks stay the host
    tracker's bit for bit."""
    _, tp = weights
    data = _stream(1, 18, 10)
    calls = _spy_track_step(monkeypatch)
    scan = _run(ttrk.DeviceTracker(CFG, tp), data, 6)
    _assert_same(scan, _run(ttrk.RecurrentTracker(CFG, tp), data, 6))
    assert len(calls) == len(data)
    for c in range(0, len(data), 6):
        chunk = calls[c:c + 6]
        assert all(e is chunk[0] for e in chunk)
        assert chunk[0].shape == (1,) and chunk[0].dtype == torch.int32
        assert int(chunk[0]) == 0
    assert len({id(e) for e in calls}) == 3


def test_chunk_scan_raises_after_its_chunk_on_a_capped_solve(weights,
                                                             monkeypatch):
    """A solve that hits its cap on frame 2 of a chunk still raises, once
    every frame of the chunk has launched."""
    _, tp = weights
    data = _stream(1, 6, 10)
    calls = _spy_track_step(monkeypatch, fail_at=2)
    with pytest.raises(RuntimeError, match="did not converge"):
        _run(ttrk.DeviceTracker(CFG, tp), data, 6)
    assert len(calls) == 6


def test_err_argument_on_cpu_tensors():
    """``err`` on CPU tensors: the plain versions set it instead of
    raising and leave it 0 otherwise, with the same answers; a flag of
    another type or shape is refused."""
    from repro_torch.kernels.assign import assign_batch
    from repro_torch.kernels.track_step import (LOG1P_TABLE_2D,
                                                pack_params)
    rng = np.random.default_rng(0)
    costs = torch.from_numpy(
        rng.integers(0, 256, (2, 8, 8)).astype(np.float32) / 64)
    err = torch.zeros(1, dtype=torch.int32)
    assert torch.equal(assign_batch(costs, err=err), assign_batch(costs))
    assert int(err) == 0
    assign_batch(torch.full((1, 4, 4), float("nan")), err=err)
    assert int(err) == 1
    with pytest.raises(ValueError, match="err"):
        assign_batch(costs, err=torch.zeros(1))
    tp = ttrk.init_tracker(CFG, seed=1, device="cpu")
    heads = pack_params(ttrk._host_params(tp), "cpu")
    H, e = CFG.rnn_dim, CFG.embed_dim
    Q = 8
    ops = [torch.from_numpy(rng.random(s).astype(np.float32)) for s in
           ((1, Q, H), (1, Q, 4), (1, Q), (1, Q), (1, Q), (1, Q, e),
            (1, Q, 4), (1, Q))]
    table = torch.from_numpy(LOG1P_TABLE_2D)
    err = torch.zeros(1, dtype=torch.int32)
    with_err = track_step(*ops, 0.2, heads, table, err=err)
    for a, b in zip(with_err, track_step(*ops, 0.2, heads, table)):
        assert torch.equal(a, b)
    assert int(err) == 0
    with pytest.raises(ValueError, match="err"):
        track_step(*ops, 0.2, heads, table,
                   err=torch.zeros(2, dtype=torch.int32))
