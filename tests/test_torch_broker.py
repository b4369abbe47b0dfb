"""The port's cross-stream brokers (``BatchBroker``, ``TrackBroker``) on
the CPU, at the reduced configuration with seeded weights and 16-frame
clips.

Per-stream tracks with a broker must equal each stream's solo broker-off
run.  The port's CPU detector is not batch-invariant (``detect_scores``
at batch 1-8 differs from batch 16 by up to one f32 ulp), so the broker
changing the batch a window rides in may move its scores by that much.
Bit for bit is therefore held under a detector made batch-invariant by
construction (``_RowwiseNet``: each row through the net at batch one,
then concatenated), and with the real detector tracks are held to the
slice's tolerances, with the detector confidence and the proxy
threshold kept a margin away from every score.  The brokers' decisions
(flush triggers, grouping, buckets, routing, stats, cancellation) are
held to the JAX package's brokers on the same scripted requests, and a
``TrackBroker`` launch over K streams to the reference's, bit for bit.
Every thread join has a timeout.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.executor as jex  # noqa: E402
from repro.kernels.track_step import pack_params as jx_pack  # noqa: E402
from repro.kernels.track_step.ops import (  # noqa: E402
    LOG1P_TABLE_2D as JX_TABLE)

import repro_torch.core.detector as tdet  # noqa: E402
import repro_torch.core.executor as tex  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
import repro_torch.core.proxy as tproxy  # noqa: E402
import repro_torch.core.tracker as ttrk  # noqa: E402
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE as T_CFG  # noqa: E402
from repro_torch.data.video_synth import make_clip  # noqa: E402
from repro_torch.kernels.track_step import (  # noqa: E402
    LOG1P_TABLE_2D, pack_params, track_step)

ARCH = "ssd-lite"
SEED = 5
N_FRAMES = 16
CONV_ATOL = 2e-5        # conv-net outputs, as tests/test_torch_modules.py
MARGIN = 2 * CONV_ATOL   # least distance of a thresholded score from it
BOX_RTOL, BOX_ATOL = 1e-4, 2e-5   # boxes: exp(log-size) amplifies drift
JOIN_S = 60.0


# ---------------------------------------------------------------------------
# Set-up shared with tests/test_torch_executor.py
# ---------------------------------------------------------------------------

class _RowwiseNet(torch.nn.Module):
    """A detector net that runs each row at batch one: its outputs
    cannot depend on the batch a row rides in."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, frames):
        return torch.cat([self.net(frames[i:i + 1])
                          for i in range(frames.shape[0])])


def batch_invariant(bank):
    """``bank`` with its detector wrapped in ``_RowwiseNet``."""
    dets = {a: tdet.Detector(a, net=_RowwiseNet(d.net), device="cpu")
            for a, d in bank.detectors.items()}
    return dataclasses.replace(bank, detectors=dets)


def _widest_gap(values, lo_q, hi_q):
    """Midpoint of the widest gap between consecutive distinct scores
    with quantile rank in [lo_q, hi_q]."""
    v = np.unique(np.asarray(values, np.float64).ravel())
    lo, hi = int(lo_q * (len(v) - 1)), int(hi_q * (len(v) - 1))
    gaps = np.diff(v[lo:hi + 1])
    k = lo + int(np.argmax(gaps))
    return float((v[k] + v[k + 1]) / 2)


def margin(values, thr):
    return float(np.min(np.abs(np.asarray(values, np.float64) - thr)))


def port_bank(det_net=None, encoder=None, tracker_params=None):
    """The reduced-config bank on the CPU: the given weights, or weights
    drawn from ``SEED``; window times pre-seeded so that planning emits
    sub-frame windows without timing anything."""
    cfg = T_CFG.reduced()
    det_res = cfg.detector.resolutions[-1]          # (128, 80): grid 8x5
    pres = cfg.proxy.resolutions[-1]                # (32, 24) at cell 8
    grid = tpl.det_grid(det_res)
    sizes = [grid, (3, 2), (5, 3)]
    times = {(ARCH, s): t for s, t in zip(sizes, (1.0, 0.2, 0.45))}
    return tpl.ModelBank(
        cfg, {ARCH: tdet.Detector(ARCH, net=det_net, seed=SEED,
                                  device="cpu")},
        {pres: tproxy.ProxyModel(cfg.proxy.cell, cfg.proxy.base_channels,
                                 pres, encoder=encoder, seed=SEED,
                                 device="cpu")},
        tracker_params=tracker_params or ttrk.init_tracker(
            cfg.tracker, seed=SEED, device="cpu"),
        sizes_cells=sizes, ref_grid=grid, win_times=dict(times),
        device="cpu")


def choose_params(bank, clips, chunks=(1, 16)):
    """θ for the fleet tests: the proxy threshold in the widest gap of
    the proxy's sigmoids near their 0.85 quantile, and the detector
    confidence in the widest gap of every detector score the runs at
    ``chunks`` compute, near the top; -> (params, proxy sigmoids,
    detector scores)."""
    cfg = bank.cfg
    det_res = cfg.detector.resolutions[-1]
    pres = cfg.proxy.resolutions[-1]
    proxy = bank.proxies[pres]
    enc = proxy.encoder
    frames = [np.stack([tpl.render_frame(c, f, *det_res)[0]
                        for f in range(c.n_frames)]) for c in clips]
    with torch.inference_mode():
        psig = np.concatenate([torch.sigmoid(
            proxy.features(tpl.downsample_chunk(fr, pres))[:len(fr)]
            @ enc.head_w + enc.head_b).numpy().ravel() for fr in frames])
    thr = _widest_gap(psig, 0.8, 0.9)
    params = tpl.PipelineParams(ARCH, det_res, 0.5, gap=1, proxy_res=pres,
                                proxy_threshold=thr, tracker="recurrent",
                                refine=False)
    net = bank.detectors[ARCH].net
    dsc = []
    for chunk in chunks:
        p = dataclasses.replace(params, chunk_size=chunk)
        for clip, fr in zip(clips, frames):
            ctx = tex._RunContext(bank, p, clip, tex.ExecutorOptions())
            for c0 in range(0, clip.n_frames, chunk):
                task = tex.ChunkTask(0, ctx.frame_ids[c0:c0 + chunk],
                                     frames=fr[c0:c0 + chunk])
                tex.stage_proxy(ctx, task)
                for size, entries in task.plan.by_size.items():
                    ph, pw = size[1] * tpl.CELL_PX, size[0] * tpl.CELL_PX
                    crops = np.stack([task.frames[s, y * 16:y * 16 + ph,
                                                  x * 16:x * 16 + pw]
                                      for (s, x, y, _) in entries])
                    with torch.inference_mode():
                        s, _ = tdet.detect_scores(net, torch.from_numpy(
                            tdet.pad_to_bucket(crops)))
                    dsc.append(s[:len(entries)].numpy().ravel())
    dsc = np.concatenate(dsc)
    conf = _widest_gap(dsc, 0.6, 0.9)
    return dataclasses.replace(params, det_conf=conf), psig, dsc


def assert_same(a, b):
    """Tracks bit-identical; counters equal."""
    for k in ("frames_processed", "detector_windows", "full_frames",
              "skipped_frames"):
        assert getattr(a, k) == getattr(b, k), k
    assert len(a.tracks) == len(b.tracks)
    for x, y in zip(a.tracks, b.tracks):
        np.testing.assert_array_equal(x, y)


def assert_close(a, b):
    """The same decisions (counters, track frames and ids), boxes within
    the slice's tolerances."""
    for k in ("frames_processed", "detector_windows", "full_frames",
              "skipped_frames"):
        assert getattr(a, k) == getattr(b, k), k
    assert len(a.tracks) == len(b.tracks)
    for x, y in zip(a.tracks, b.tracks):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x[:, [0, 5]], y[:, [0, 5]])
        np.testing.assert_allclose(x, y, rtol=BOX_RTOL, atol=BOX_ATOL)


def run_threads(fns, timeout=JOIN_S):
    """Run each callable on its own thread; -> their results.  Every
    join has a timeout, and a thread still alive after it fails."""
    out = [None] * len(fns)
    errors = []

    def one(i):
        try:
            out[i] = fns[i]()
        except BaseException as exc:     # surfaced by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a stream hung"
    assert not errors, errors
    return out


def run_streams(bank, params, clips, n_streams, **opts):
    """``n_streams`` concurrent runs (clips round-robin), each on its own
    thread, with the given ``ExecutorOptions`` fields."""
    def one(i):
        return lambda: tex.run_clip_streamed(
            bank, params, clips[i % len(clips)],
            tex.ExecutorOptions(prefetch=False, **opts))
    return run_threads([one(i) for i in range(n_streams)])


@pytest.fixture
def one_thread():
    """Small eager ops run faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bank = port_bank()
        clips = [make_clip("caldot1", "test", i, n_frames=N_FRAMES)
                 for i in range(2)]
        params, psig, dsc = choose_params(bank, clips)
    finally:
        torch.set_num_threads(n)
    return dict(bank=bank, rowwise=batch_invariant(bank), clips=clips,
                params=params, psig=psig, dsc=dsc)


def test_fleet_thresholds_keep_margin(fleet):
    p = fleet["params"]
    assert margin(fleet["psig"], p.proxy_threshold) > MARGIN
    assert margin(fleet["dsc"], p.det_conf) > MARGIN
    assert (fleet["dsc"] > p.det_conf).sum() >= 8


def test_rowwise_detector_is_batch_invariant(fleet):
    """The wrapper's scores at a bucket of 16 equal each row's alone."""
    net = fleet["rowwise"].detectors[ARCH].net
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((16, 48, 80, 3), np.float32))
    with torch.inference_mode():
        whole = net(x)
        for b in (1, 2, 4, 8):
            torch.testing.assert_close(net(x[:b]), whole[:b], rtol=0,
                                       atol=0)


# ---------------------------------------------------------------------------
# BatchBroker: tracks per stream
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("n_streams,chunk", [
    (1, 1), (1, 16), (4, 1), (4, 16), (16, 1), (16, 16),
])
def test_broker_bit_identity(fleet, n_streams, chunk):
    """Under the batch-invariant detector every stream's tracks equal its
    solo broker-off run bit for bit, for 1/4/16 streams and per-frame
    (single-window buckets) and chunked plans."""
    bank, clips = fleet["rowwise"], fleet["clips"]
    params = dataclasses.replace(fleet["params"], chunk_size=chunk)
    ref = [tex.run_clip_streamed(bank, params, c,
                                 tex.ExecutorOptions(prefetch=False))
           for c in clips]
    broker = tex.BatchBroker()
    got = run_streams(bank, params, clips, n_streams, batch_broker=broker)
    broker.close()
    for i, r in enumerate(got):
        assert_same(r, ref[i % len(clips)])
    assert ref[0].detector_windows > ref[0].full_frames   # windows ran
    assert sum(map(len, ref[0].tracks)) > 0
    assert broker._registered == 0          # every handle released
    assert all(0.0 < f <= 1.0 for f in broker.batch_fill)
    assert broker.windows_in == sum(r.detector_windows for r in got)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("n_streams,chunk", [(4, 1), (16, 16)])
def test_broker_real_detector_within_tolerance(fleet, n_streams, chunk):
    """With the real detector, which drifts by an ulp with the batch,
    every stream's tracks equal its solo run's within the slice's
    tolerances."""
    bank, clips = fleet["bank"], fleet["clips"]
    params = dataclasses.replace(fleet["params"], chunk_size=chunk)
    ref = [tex.run_clip_streamed(bank, params, c,
                                 tex.ExecutorOptions(prefetch=False))
           for c in clips]
    broker = tex.BatchBroker()
    got = run_streams(bank, params, clips, n_streams, batch_broker=broker)
    broker.close()
    for i, r in enumerate(got):
        assert_close(r, ref[i % len(clips)])
    assert broker.dispatches > 0 and broker._registered == 0


@pytest.mark.usefixtures("one_thread")
def test_broker_consolidates_dispatches(fleet):
    """At 4 streams the consolidated detector calls are STRICTLY fewer
    than the per-stream broker-off runs' summed detector dispatches.  The
    streams meet at a barrier before DETECT, and a registered handle
    that never submits leaves only the linger and max_batch triggers, so
    the 4 streams' requests of a size class ride one flush however the
    host schedules the threads."""
    bank, clips = fleet["rowwise"], fleet["clips"]
    params = dataclasses.replace(fleet["params"], chunk_size=16)
    solo = sum(tex.run_clip_streamed(bank, params, c, tex.ExecutorOptions(
        prefetch=False)).dispatches["detect"] for c in clips * 2)
    broker = tex.BatchBroker(linger_ms=500.0)
    idle = broker.register()
    meet = threading.Barrier(4)

    def proxy_then_meet(ctx, task):
        task = tex.stage_proxy(ctx, task)
        meet.wait(JOIN_S)
        return task

    ex = tex.ClipExecutor(bank, params, tex.ExecutorOptions(
        prefetch=False, batch_broker=broker),
        stages={"proxy": proxy_then_meet})
    got = run_threads([lambda i=i: ex.run(clips[i % len(clips)])
                       for i in range(4)])
    idle.close()
    broker.close()
    assert broker.dispatches < solo
    assert broker.windows_in == sum(r.detector_windows for r in got) > 0


# ---------------------------------------------------------------------------
# BatchBroker: unit tests with a fake detector
# ---------------------------------------------------------------------------

class _FakeDetector:
    """detect_batch stub: one (1, 2) row per valid window encoding
    (origin, scale), so routing back to the right request is checkable;
    records (rows, n_valid, conf) per call."""

    def __init__(self):
        self.calls = []

    def detect_batch(self, frames, conf, origins, scales, n_valid):
        self.calls.append((int(frames.shape[0]), n_valid, float(conf)))
        assert len(origins) == len(scales) == n_valid
        return [np.array([[float(origins[i][0]), float(scales[i])]])
                for i in range(n_valid)]


def _win(n, side=4):
    return np.zeros((n, side, side, 3), np.float32)


def test_broker_zero_windows_is_a_noop():
    """n_valid=0 returns [] without a pending request (a skip-heavy
    stream never delays anyone's flush)."""
    broker = tex.BatchBroker()
    h = broker.register()
    det = _FakeDetector()
    assert h.detect(det, _win(0), 0.4, [], [], n_valid=0) == []
    assert broker.dispatches == 0 and not broker._pending
    h.close()
    broker.close()


def test_broker_single_window_bucket():
    """A lone 1-window request flushes (all-registered-pending trigger)
    into a bucket of one, fill 1.0."""
    broker = tex.BatchBroker()
    h = broker.register()
    det = _FakeDetector()
    out = h.detect(det, _win(1), 0.4, [(7, 0)], [2.0], n_valid=1)
    assert len(out) == 1
    np.testing.assert_array_equal(out[0], [[7.0, 2.0]])
    assert broker.dispatches == 1 and broker.batch_fill == [1.0]
    h.close()
    broker.close()


def test_broker_routes_multi_stream_batches():
    """Two streams' same-shape requests consolidate into ONE detector
    call (the all-streams-pending trigger; no linger rescue) and split
    back per stream in submit order."""
    broker = tex.BatchBroker(linger_ms=60000.0)
    ha, hb = broker.register(), broker.register()
    det = _FakeDetector()

    def run(h, origins):
        return lambda: h.detect(det, _win(len(origins)), 0.4, origins,
                                [1.0] * len(origins), n_valid=len(origins))

    a, b = run_threads([run(ha, [(1, 0), (2, 0)]), run(hb, [(3, 0)])],
                       timeout=10)
    assert len(det.calls) == 1 and broker.dispatches == 1
    assert det.calls[0][:2] == (4, 3)
    assert [r[0][0] for r in a] == [1.0, 2.0]
    assert [r[0][0] for r in b] == [3.0]
    ha.close(), hb.close()
    broker.close()


def _wait_pending(broker, n=1):
    for _ in range(2000):
        with broker._cv:
            if len(broker._pending) >= n:
                return
        threading.Event().wait(0.005)
    raise AssertionError("no request became pending")


def test_broker_stream_failure_mid_flight():
    """Unregistering a stream with a request pending raises
    BrokerCancelled on ITS thread only; the surviving stream's next
    request is served normally."""
    broker = tex.BatchBroker(linger_ms=60000.0)     # no linger rescue
    ha, hb = broker.register(), broker.register()
    det = _FakeDetector()
    caught = []

    def doomed():
        try:
            ha.detect(det, _win(1), 0.4, [(9, 0)], [1.0], n_valid=1)
        except tex.BrokerCancelled as exc:
            caught.append(exc)

    t = threading.Thread(target=doomed, daemon=True)
    t.start()
    _wait_pending(broker)
    ha.close()
    t.join(10)
    assert not t.is_alive() and len(caught) == 1
    assert det.calls == []                      # its windows were dropped
    out = hb.detect(det, _win(1), 0.4, [(5, 0)], [1.0], n_valid=1)
    np.testing.assert_array_equal(out[0], [[5.0, 1.0]])
    hb.close()
    broker.close()


def test_broker_drain_on_close():
    """close() flushes whatever is pending before refusing new work."""
    broker = tex.BatchBroker(linger_ms=60000.0)
    ha, hb = broker.register(), broker.register()     # hb never submits
    det = _FakeDetector()
    out = []
    t = threading.Thread(target=lambda: out.append(ha.detect(
        det, _win(1), 0.4, [(4, 0)], [1.0], n_valid=1)), daemon=True)
    t.start()
    _wait_pending(broker)
    broker.close()
    t.join(10)
    assert not t.is_alive()
    np.testing.assert_array_equal(out[0][0], [[4.0, 1.0]])
    assert broker.dispatches == 1
    with pytest.raises(RuntimeError):
        broker.register()
    with pytest.raises(RuntimeError):
        hb.detect(det, _win(1), 0.4, [(0, 0)], [1.0], n_valid=1)


def test_broker_builds_device_batches_from_tensor_parts():
    """Tensor parts (the gathered crops) are consolidated into one
    tensor with zero padding rows; host parts into one host array."""
    parts = [torch.full((2, 4, 4, 3), 1.0), torch.full((1, 4, 4, 3), 2.0)]
    stack = tex._consolidate(parts, 4)
    assert isinstance(stack, torch.Tensor) and stack.shape == (4, 4, 4, 3)
    assert stack[:2].eq(1).all() and stack[2].eq(2).all()
    assert stack[3].eq(0).all()
    host = tex._consolidate([np.ones((3, 2, 2, 3), np.float32)], 4)
    assert isinstance(host, np.ndarray) and host[3].sum() == 0


# ---------------------------------------------------------------------------
# The brokers' decisions against the JAX package's
# ---------------------------------------------------------------------------

# each step: (stream, windows, window side, conf, padded rows) preloaded
# as pending, then the submitting stream's request, whose inline
# trigger check flushes them all (max_batch 8); the last entry of each
# round is submitted, the rest preloaded
SCRIPT = [
    # 6 windows of one shape (bucket 8, fill 0.75) and a lone request of
    # 2 already-bucketed rows of another shape (passed through)
    [(1, 3, 4, 0.4, 3), (2, 2, 8, 0.4, 2), (0, 3, 4, 0.4, 4)],
    # two confidences split one shape into two groups; a lone request
    # with padding rows past its bucket is consolidated (rows 3 of 8)
    [(1, 3, 4, 0.5, 8), (2, 1, 4, 0.4, 1), (0, 5, 8, 0.4, 8)],
    # more than max_batch in one group: a bucket of 16
    [(1, 7, 4, 0.4, 8), (2, 6, 4, 0.4, 8)],
]


def _scripted(mod, tensors):
    """Run SCRIPT through ``mod.BatchBroker``; -> (calls, results per
    request in order, dispatches, windows_in, batch_fill, cancelled)."""
    broker = mod.BatchBroker(max_batch=8, linger_ms=60000.0)
    handles = [broker.register() for _ in range(3)]
    det = _FakeDetector()
    results, tag = [], 0
    for rnd in SCRIPT:
        reqs = []
        for (s, n, side, conf, rows) in rnd:
            frames = _win(rows, side)
            if tensors:
                frames = torch.from_numpy(frames)
            origins = [(tag + j, s) for j in range(n)]
            scales = [float(s)] * n
            tag += 100
            reqs.append((handles[s], frames, conf, origins, scales, n))
        for (h, frames, conf, origins, scales, n) in reqs[:-1]:
            with broker._cv:
                broker._pending.append(mod._BrokerRequest(
                    h, det, frames, conf, origins, scales, n))
        pre = list(broker._pending)
        h, frames, conf, origins, scales, n = reqs[-1]
        last = h.detect(det, frames, conf, origins, scales, n_valid=n)
        results += [[o.tolist() for o in r.result] for r in pre]
        results.append([o.tolist() for o in last])
    # a request left pending is cancelled when its stream unregisters,
    # and one drained by close()
    for s in (1, 2):
        with broker._cv:
            broker._pending.append(mod._BrokerRequest(
                handles[s], det, _win(1), 0.4, [(900 + s, s)], [1.0], 1))
    doomed, kept = list(broker._pending)
    handles[1].close()
    broker.close()
    results.append([o.tolist() for o in kept.result])
    return (det.calls, results, broker.dispatches, broker.windows_in,
            broker.batch_fill, type(doomed.error).__name__)


@pytest.mark.parametrize("tensors", [False, True])
def test_broker_decisions_match_reference(tensors):
    """The same scripted requests through both packages' BatchBrokers
    (single-threaded: the submitting thread's own trigger check flushes)
    give the same detector calls, routing, stats and cancellation; the
    port's parts may be host arrays or tensors."""
    got = _scripted(tex, tensors)
    want = _scripted(jex, False)
    assert got == want
    calls = got[0]
    assert (16, 13, 0.4) in calls and (2, 2, 0.4) in calls
    assert got[5] == "BrokerCancelled"


def _track_requests(rng, qs, H=16, e=8, M=16):
    """One K-stream step's operands, one stream per Q in ``qs``: live
    tracks and valid detections as prefixes, dead padding slots; and
    the tracker heads."""
    def g(*s):
        return rng.standard_normal(s).astype(np.float32)

    heads = {
        "det_proj/w": g(e + 6, e) * 0.5, "det_proj/b": g(e) * 0.1,
        "gru/wz": g(e + H, H) * 0.5, "gru/wr": g(e + H, H) * 0.5,
        "gru/wh": g(e + H, H) * 0.5,
        "gru/bz": g(H) * 0.1, "gru/br": g(H) * 0.1, "gru/bh": g(H) * 0.1,
        "match/w0": g(H + e + 6, M) * 0.5, "match/b0": g(M) * 0.1,
        "match/w1": g(M, 1) * 0.5, "match/b1": g(1) * 0.1,
    }
    streams = []
    for Q in qs:
        T, n = int(rng.integers(1, Q + 1)), int(rng.integers(1, Q + 1))
        arrs = [np.zeros((Q, H), np.float32), np.zeros((Q, 4), np.float32),
                np.zeros((Q,), np.float32), np.zeros((Q,), np.float32),
                np.full((Q,), float(rng.integers(0, 9)), np.float32),
                np.zeros((Q, e), np.float32), np.zeros((Q, 4), np.float32),
                np.zeros((Q,), np.float32)]
        arrs[0][:T] = g(T, H) * 0.5
        arrs[1][:T] = rng.random((T, 4), np.float32)
        arrs[2][:T] = 1.0
        arrs[3][:T] = rng.integers(1, 9, T)
        arrs[5][:n] = g(n, e) * 0.5
        arrs[6][:n] = rng.random((n, 4), np.float32)
        arrs[7][:n] = 1.0
        streams.append(arrs)
    return streams, np.full((1, 1), 0.35, np.float32), heads


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("qs", [(8, 16, 8), (16, 8, 8, 16, 8)])
def test_track_broker_dispatch_matches_reference(qs):
    """The same K stream steps (Q 8 and 16 mixed, so the launch pads to
    the widest Q and a pow2 K) through both packages'
    ``TrackBroker._dispatch``: equal bits per stream, and equal to each
    stream's solo K 1 step."""
    rng = np.random.default_rng(sum(qs))
    streams, thr, heads = _track_requests(rng, qs)
    packed = pack_params(heads, "cpu")
    table = torch.from_numpy(LOG1P_TABLE_2D)
    t_reqs = [tex._TrackRequest(None, [torch.from_numpy(a) for a in arrs],
                                thr, packed, table, None)
              for arrs in streams]
    j_reqs = [jex._TrackRequest(None, arrs, thr, jx_pack(heads), JX_TABLE,
                                None) for arrs in streams]
    assert tex.TrackBroker()._dispatch(t_reqs) == len(qs)
    jex.TrackBroker()._dispatch(j_reqs)
    for arrs, t, j in zip(streams, t_reqs, j_reqs):
        solo = [o[0].numpy() for o in track_step(
            *(torch.from_numpy(a[None]) for a in arrs), thr, packed, table)]
        for got, want, alone in zip(t.result, j.result, solo):
            np.testing.assert_array_equal(_bits(got), _bits(want))
            np.testing.assert_array_equal(_bits(got), _bits(alone))
    assert any((t.result[0] >= 0).any() for t in t_reqs)


def test_track_broker_groups_and_stats():
    """Steps of other head widths or thresholds go to separate launches;
    the stats count launches, steps and streams per launch."""
    rng = np.random.default_rng(7)
    # three steps pending fill the broker: the submitting thread flushes
    broker = tex.TrackBroker(max_streams=3, linger_ms=60000.0)
    handles = [broker.register() for _ in range(3)]
    a, thr, heads = _track_requests(rng, (8, 8))
    b, _, heads_b = _track_requests(rng, (8,), H=24)
    packed = pack_params(heads, "cpu")
    table = torch.from_numpy(LOG1P_TABLE_2D)
    for h, arrs, hd, key in ((handles[0], a[0], packed, 1),
                             (handles[1], b[0], pack_params(heads_b, "cpu"),
                              2)):
        with broker._cv:
            broker._pending.append(tex._TrackRequest(
                h, [torch.from_numpy(x) for x in arrs], thr, hd, table,
                (key, float(thr[0, 0]), arrs[0].shape[1],
                 arrs[5].shape[1])))
    out = handles[2].step(*(torch.from_numpy(x) for x in a[1]), thr, packed,
                          table, params_key=1)
    assert len(out) == 3 and out[1].shape == (8, 16)
    assert broker.dispatches == 2 and broker.steps_in == 3
    assert sorted(broker.stream_fill) == [1, 2]
    for h in handles:
        h.close()
    broker.close()
