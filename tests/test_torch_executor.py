"""The port's multi-stream executor on the CPU, at the reduced
configuration with 16-frame clips: the decode worker pool and the shared
``DecodePool``, ``run_clips``, cancellation and failure propagation, the
``frame_ids=`` / ``tracker=`` resume hooks, the ``TrackBroker`` behind
``device_assign`` and ``device_tracker``, and ``engine.run_clip_chunked``.

Scheduling never changes the batches the conv nets see, so each
scheduled run is held to the port's own single-thread run bit for bit.
``run_clip_chunked`` is also held to the reference's at the same chunk
size, with the same weights (the reference's, moved by
``repro_torch.params``), within the slice's tolerances.  Every thread
join has a timeout.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.detector as jdet  # noqa: E402
import repro.core.pipeline as jpl  # noqa: E402
import repro.core.proxy as jproxy  # noqa: E402
import repro.core.tracker as jtrk  # noqa: E402
from repro.configs.multiscope import MULTISCOPE_PIPELINE as J_CFG  # noqa: E402
from repro.core.engine import run_clip_chunked as jx_run_clip_chunked  # noqa: E402

import repro_torch.core.executor as tex  # noqa: E402
import repro_torch.core.pipeline as tpl  # noqa: E402
import repro_torch.core.tracker as ttrk  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.core.engine import run_clip_chunked  # noqa: E402
from repro_torch.data.video_synth import make_clip  # noqa: E402

from test_torch_broker import (ARCH, MARGIN, N_FRAMES, SEED,  # noqa: E402
                               assert_close, assert_same, choose_params,
                               margin, port_bank, run_threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops run faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Both banks with the reference's seeded weights; θ from the port's
    scores (the thresholds a margin away from every one)."""
    cfg = J_CFG.reduced()
    jd = jdet.init_detector(ARCH, seed=SEED)
    jp = jproxy.init_proxy(cfg.proxy.cell, cfg.proxy.base_channels,
                           seed=SEED)
    jt = jtrk.init_tracker(cfg.tracker, seed=SEED)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tbank = port_bank(
            bridge.detector_from_params(ARCH, _np_tree(jd)),
            bridge.proxy_from_params(cfg.proxy.cell, cfg.proxy.base_channels,
                                     _np_tree(jp)),
            bridge.tracker_from_params(cfg.tracker, _np_tree(jt), "cpu"))
        clips = [make_clip("caldot1", "test", i, n_frames=N_FRAMES)
                 for i in range(2)]
        params, psig, dsc = choose_params(tbank, clips, chunks=(4, 8, 16))
    finally:
        torch.set_num_threads(n)
    pres = cfg.proxy.resolutions[-1]
    jbank = jpl.ModelBank(
        cfg, {ARCH: jdet.Detector(ARCH, jd)},
        {pres: jproxy.ProxyModel(cfg.proxy.cell, cfg.proxy.base_channels,
                                 pres, params=jp)},
        tracker_params=jt, sizes_cells=tbank.sizes_cells,
        ref_grid=tbank.ref_grid, win_times=dict(tbank.win_times))
    return dict(tbank=tbank, jbank=jbank, clips=clips, params=params,
                psig=psig, dsc=dsc)


def _p(s, **kw):
    return dataclasses.replace(s["params"], **kw)


def _solo(s, params, clip):
    """The single-thread schedule: the port's reference run here."""
    return tex.run_clip_streamed(s["tbank"], params, clip,
                                 tex.ExecutorOptions(prefetch=False))


def _live(prefix):
    return [t for t in threading.enumerate()
            if t.name.startswith(prefix) and t.is_alive()]


def _boom(ctx, task):
    raise RuntimeError("detect failed")


def test_setup_thresholds_keep_margin(setup):
    p = setup["params"]
    assert margin(setup["psig"], p.proxy_threshold) > MARGIN
    assert margin(setup["dsc"], p.det_conf) > MARGIN


# ---------------------------------------------------------------------------
# Decode workers, the shared pool and run_clips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [2, 3])
def test_executor_decode_worker_pool(setup, workers):
    """N decode workers + the reorder gate reproduce the single-thread
    schedule bit for bit (chunks reach TRACK in frame order whichever
    worker decoded them first)."""
    s = setup
    params = _p(s, chunk_size=4)                    # several chunks
    opts = tex.ExecutorOptions(prefetch=True, prefetch_depth=2,
                               decode_workers=workers)
    for clip in s["clips"]:
        got = tex.run_clip_streamed(s["tbank"], params, clip, opts)
        assert_same(got, _solo(s, params, clip))
    assert not _live("multiscope-decode")


def test_run_clips_matches_per_clip(setup):
    """The multi-clip sweep (one clip of decode lookahead over the shared
    pool it owns) returns exactly the per-clip results, in order, and
    their summed seconds."""
    s = setup
    params = s["params"]
    results, total = tex.run_clips(s["tbank"], params, s["clips"])
    assert len(results) == len(s["clips"])
    for clip, r in zip(s["clips"], results):
        assert_same(r, tex.ClipExecutor(s["tbank"], params).run(clip))
    assert total == pytest.approx(sum(r.seconds for r in results))
    assert sum(map(len, results[0].tracks)) > 0
    assert results[0].detector_windows > results[0].full_frames
    assert not _live("multiscope-pool-decode")


def test_run_clips_decode_worker_pool(setup):
    """``decode_workers`` threads through the multi-clip sweep (its own
    pool of max(2, workers))."""
    s = setup
    params = _p(s, chunk_size=4)
    results, _ = tex.run_clips(s["tbank"], params, s["clips"],
                               tex.ExecutorOptions(decode_workers=3))
    for clip, r in zip(s["clips"], results):
        assert_same(r, _solo(s, params, clip))
    assert not _live("multiscope-pool-decode")


@pytest.mark.parametrize("pool_size", [1, 3])
def test_run_clips_shared_pool_bit_identical(setup, pool_size):
    """One caller-owned DecodePool shared by the in-flight clips: per-run
    gates keep TRACK in frame order for any pool size, and the pool is
    reusable across sweeps and left open."""
    s = setup
    params = _p(s, chunk_size=4)
    pool = tex.DecodePool(pool_size)
    try:
        opts = tex.ExecutorOptions(decode_pool=pool)
        results, _ = tex.run_clips(s["tbank"], params, s["clips"], opts)
        for clip, r in zip(s["clips"], results):
            assert_same(r, _solo(s, params, clip))
        again, _ = tex.run_clips(s["tbank"], params, s["clips"], opts)
        for a, b in zip(results, again):
            assert_same(a, b)
        assert len(_live("multiscope-pool-decode")) == pool_size
    finally:
        pool.close()
    assert not _live("multiscope-pool-decode")
    with pytest.raises(RuntimeError, match="closed"):
        tex.ClipExecutor(s["tbank"], params, tex.ExecutorOptions(
            decode_pool=pool)).start(s["clips"][0])


def test_run_clips_without_a_shared_pool(setup):
    """share_decode_pool=False: each in-flight clip decodes on its own
    run's workers, with the same results, and none is left alive."""
    s = setup
    params = _p(s, chunk_size=4)
    results, _ = tex.run_clips(s["tbank"], params, s["clips"],
                               tex.ExecutorOptions(decode_workers=2,
                                                   share_decode_pool=False))
    for clip, r in zip(s["clips"], results):
        assert_same(r, _solo(s, params, clip))
    assert not _live("multiscope-decode")
    assert not _live("multiscope-pool-decode")


def test_run_clips_without_prefetch(setup):
    """prefetch=False: the clips run one after another on the sequential
    scheduler, with the same results."""
    s = setup
    results, _ = tex.run_clips(s["tbank"], s["params"], s["clips"],
                               tex.ExecutorOptions(prefetch=False))
    for clip, r in zip(s["clips"], results):
        assert_same(r, _solo(s, s["params"], clip))


# ---------------------------------------------------------------------------
# Failures and cancellation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 3])
def test_executor_stage_failure_propagates(setup, workers):
    """A stage failure mid-stream propagates promptly: the decode workers
    (blocked on the full queue or parked at the reorder gate) are
    released before it is raised, and none is left alive."""
    s = setup
    params = _p(s, chunk_size=1)                    # chunks >> depth
    ex = tex.ClipExecutor(s["tbank"], params, tex.ExecutorOptions(
        prefetch=True, decode_workers=workers), stages={"detect": _boom})
    out = run_threads([lambda: pytest.raises(
        RuntimeError, ex.run, s["clips"][0])], timeout=30)
    assert "detect failed" in str(out[0].value)
    assert not _live("multiscope-decode")


def test_executor_decode_failure_propagates(setup):
    """A failure in DECODE itself reaches the draining thread."""
    s = setup

    def bad_decode(ctx, task):
        if task.index == 2:
            raise ValueError("decode failed")
        return tex.stage_decode(ctx, task)

    ex = tex.ClipExecutor(s["tbank"], _p(s, chunk_size=2),
                          tex.ExecutorOptions(decode_workers=2),
                          stages={"decode": bad_decode})
    with pytest.raises(ValueError, match="decode failed"):
        ex.run(s["clips"][0])
    assert not _live("multiscope-decode")


def test_executor_cancel_releases_started_run(setup):
    """A started run can be abandoned without draining it (its workers
    would otherwise hold decoded chunks forever)."""
    s = setup
    ex = tex.ClipExecutor(s["tbank"], _p(s, chunk_size=1),
                          tex.ExecutorOptions(prefetch=True,
                                              decode_workers=2))
    run = ex.start(s["clips"][0])
    run_threads([lambda: ex.cancel(run)], timeout=30)   # returns, no hang
    pool, _ = run.handle
    assert not any(t.is_alive() for t in pool._threads)
    assert not _live("multiscope-decode")


def test_shared_pool_failure_releases_workers(setup):
    """A stage failure under a shared pool propagates, the pool's workers
    survive and still serve the next run, and the pool closes cleanly."""
    s = setup
    params = _p(s, chunk_size=1)                    # chunks >> depth
    pool = tex.DecodePool(2)
    try:
        ex = tex.ClipExecutor(s["tbank"], params, tex.ExecutorOptions(
            decode_pool=pool), stages={"detect": _boom})
        with pytest.raises(RuntimeError, match="detect failed"):
            ex.run(s["clips"][0])
        ok = tex.ClipExecutor(s["tbank"], params,
                              tex.ExecutorOptions(decode_pool=pool))
        assert_same(ok.run(s["clips"][0]), _solo(s, params, s["clips"][0]))
    finally:
        pool.close()
    assert not _live("multiscope-pool-decode")


def test_run_clips_failure_cancels_runs_started_ahead(setup, monkeypatch):
    """When a clip fails, run_clips cancels the clip started ahead of it
    and closes its own pool, and the broker registrations of both runs
    are released."""
    s = setup
    broker = tex.BatchBroker()
    calls = []

    def detect_then_fail(ctx, task):
        calls.append(ctx.clip.clip_id)
        if ctx.clip.clip_id == 0 and task.index == 1:
            raise RuntimeError("detect failed")
        return tex.stage_detect(ctx, task)

    monkeypatch.setitem(tex.DEFAULT_STAGES, "detect", detect_then_fail)
    with pytest.raises(RuntimeError, match="detect failed"):
        tex.run_clips(s["tbank"], _p(s, chunk_size=4), s["clips"],
                      tex.ExecutorOptions(batch_broker=broker))
    assert set(calls) == {0}                  # clip 1 never reached DETECT
    assert broker._registered == 0
    broker.close()
    assert not _live("multiscope-pool-decode")


# ---------------------------------------------------------------------------
# Resume hooks and the track broker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("assign", ["host", "device"])
def test_executor_segment_resume_hooks(setup, assign):
    """start(frame_ids=..., tracker=...): a clip run as two resumed
    slices, cut at a chunk boundary, gives the one-shot run's tracks bit
    for bit and splits its counters."""
    s = setup
    params = _p(s, gap=2, chunk_size=4)
    clip = s["clips"][0]
    ref = _solo(s, params, clip)
    ex = tex.ClipExecutor(s["tbank"], params)
    ids = list(range(0, clip.n_frames, params.gap))
    cut = len(ids) // 2
    tracker = ttrk.RecurrentTracker(s["tbank"].cfg.tracker,
                                    s["tbank"].tracker_params, assign=assign)
    r1 = ex.finish(ex.start(clip, frame_ids=ids[:cut], tracker=tracker))
    r2 = ex.finish(ex.start(clip, frame_ids=ids[cut:], tracker=tracker))
    assert r1.frames_processed + r2.frames_processed \
        == ref.frames_processed
    assert r1.detector_windows + r2.detector_windows \
        == ref.detector_windows
    assert len(ref.tracks) == len(r2.tracks) > 0
    for a, b in zip(ref.tracks, r2.tracks):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_streams,flag", [
    (2, "device_assign"), (4, "device_assign"), (4, "device_tracker"),
])
def test_track_broker_multi_stream_bit_identical(setup, n_streams, flag):
    """Concurrent streams sharing a TrackBroker: their device track steps
    ride batched launches, each stream's tracks equal its host-tracker
    run bit for bit, and the broker's ledger accounts for every step."""
    s = setup
    params = _p(s, chunk_size=7)
    clips = s["clips"]
    # a linger past any stream's chunk: flushes wait for every live
    # stream (a finished one unregisters), so steps are batched
    broker = tex.TrackBroker(linger_ms=1000.0)
    ex = tex.ClipExecutor(s["tbank"], params, tex.ExecutorOptions(
        track_broker=broker, **{flag: True}))
    got = run_threads([lambda i=i: ex.run(clips[i % len(clips)])
                       for i in range(n_streams)])
    broker.close()
    for i, r in enumerate(got):
        assert_same(r, tex.run_clip_streamed(s["tbank"], params,
                                             clips[i % len(clips)]))
    assert 0 < broker.dispatches <= broker.steps_in
    assert len(broker.stream_fill) == broker.dispatches
    assert sum(broker.stream_fill) == broker.steps_in
    assert max(broker.stream_fill) > 1            # steps were batched
    assert broker._registered == 0


def test_track_broker_attaches_to_an_injected_tracker(setup):
    """A resumed device-assign tracker gets the run's handle for the run
    and is detached from it when the run finishes; a host tracker is
    never registered."""
    s = setup
    broker = tex.TrackBroker(linger_ms=2.0)
    ex = tex.ClipExecutor(s["tbank"], s["params"],
                          tex.ExecutorOptions(track_broker=broker))
    dev = ttrk.RecurrentTracker(s["tbank"].cfg.tracker,
                                s["tbank"].tracker_params, assign="device")
    run = ex.start(s["clips"][0], tracker=dev)
    assert dev._track_handle is run.ctx.track_handle is not None
    ex.finish(run)
    assert dev._track_handle is None and broker._registered == 0
    assert broker.steps_in > 0
    host = ex.start(s["clips"][0])                # the default host tracker
    assert host.ctx.track_handle is None
    ex.cancel(host)
    broker.close()


# ---------------------------------------------------------------------------
# engine.run_clip_chunked
# ---------------------------------------------------------------------------

def test_effective_chunk_resolution():
    p = tpl.PipelineParams("ssd-lite", (128, 80), 0.4)
    assert tex.effective_chunk(p) == tex.DEFAULT_CHUNK
    assert tex.effective_chunk(dataclasses.replace(p, chunk_size=32)) == 32
    assert tex.effective_chunk(dataclasses.replace(p, chunk_size=32),
                               override=8) == 8


@pytest.mark.parametrize("gap", [1, 4])
@pytest.mark.parametrize("proxy_on", [False, True])
def test_engine_equivalence(setup, proxy_on, gap):
    """run_clip_chunked (the sequential scheduler) gives the streaming
    run's tracks and counters bit for bit."""
    s = setup
    params = _p(s, gap=gap, proxy_res=s["params"].proxy_res
                if proxy_on else None)
    for clip in s["clips"]:
        assert_same(run_clip_chunked(s["tbank"], params, clip),
                    tex.run_clip_streamed(s["tbank"], params, clip))


def test_engine_chunk_size_override_and_dispatch(setup):
    """``chunk_size=`` overrides θ's B, and run_clip(engine="chunked")
    takes the same path."""
    s = setup
    clip = s["clips"][0]
    a = run_clip_chunked(s["tbank"], s["params"], clip, chunk_size=4)
    assert_same(a, _solo(s, _p(s, chunk_size=4), clip))
    assert a.dispatches["proxy"] == N_FRAMES // 4
    assert_same(tpl.run_clip(s["tbank"], s["params"], clip,
                             engine="chunked"),
                run_clip_chunked(s["tbank"], s["params"], clip))


@pytest.mark.parametrize("chunk", [4, 16])
def test_run_clip_chunked_matches_reference(setup, chunk):
    """The port's run_clip_chunked against the reference's at the same
    chunk size and weights: the same counters and decisions, boxes to
    the slice's tolerances."""
    s = setup
    p = _p(s, chunk_size=chunk)
    jp = jpl.PipelineParams(p.det_arch, p.det_res, p.det_conf, p.gap,
                            p.proxy_res, p.proxy_threshold, p.tracker,
                            p.refine, p.chunk_size)
    for clip in s["clips"]:
        ref = jx_run_clip_chunked(s["jbank"], jp, clip)
        got = run_clip_chunked(s["tbank"], p, clip)
        assert_close(got, ref)
        assert got.dispatches == ref.dispatches
    assert ref.detector_windows > ref.full_frames
    assert sum(map(len, ref.tracks)) > 0
