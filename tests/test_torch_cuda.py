"""The port's CUDA kernels against their plain versions, on the card:
``ssd_scan``, ``flash_attention``, ``decode_attention``, ``assign``,
``track_step``, ``proxy_plan`` and ``window_gather_batch``.  Marked
``cuda``: each test skips without a CUDA device (a kernel has no CPU
mode; the CPU tests hold the plain versions to the JAX package).  This
file imports torch only, so that it runs on a machine with a card and no
JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes, operands and tolerances are the kernels' ``check`` modules'
(``repro_torch.kernels.<name>.check``), the same ``chip_smoke.py`` holds
the kernels to: ``ssd_scan``'s f32 y and final state within 1e-4 of max
|plain|, bf16 y within 2 bf16 ulps of the plain version's f32 result on
the same (bf16-valued) inputs, f32 at a ragged S with no padding copy,
and each dtype on its own kernel (both on tensor cores, f32 as 3xTF32,
read from the profiler's trace); the attention kernels' f32 within
1e-5, bf16 one bf16 ulp apart (the f32 bound near zero), flash
attention's dtypes each on its own kernel; ``assign`` and
``track_step`` bit for bit (their tie, signed-zero, all-inf, dead-row,
padding and large-matrix cases included), and non-finite costs must
raise in ``assign`` as in its plain version; ``proxy_plan`` within the
8-ulp threshold band of float64 arithmetic, its stats equal wherever no
flip touched the frame, and ``window_gather_batch`` bit for bit, each
on the branch of its shape (bulk copies where aligned).  Two cases hold
what the cross-stream brokers rely on: the detector's scores at batch 1
against batches 4, 16 and 64 (both architectures, a window and a full
frame at full width), within ``BATCH_DRIFT_ATOL``; and one
``TrackBroker`` launch over 4 streams of mixed Q, each stream's outputs
equal to the plain version's on the CPU bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.assign import check as assign_check  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    check as decode_check)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check as flash_check)
from repro_torch.kernels.proxy_plan import check as plan_check  # noqa: E402
from repro_torch.kernels.ssd_scan import check  # noqa: E402
from repro_torch.kernels.track_step import (  # noqa: E402
    check as track_check)
from repro_torch.kernels.window_gather import (  # noqa: E402
    check as gather_check)

pytestmark = pytest.mark.cuda

# how far a row's detector outputs may move with its batch on the card:
# about 10x the largest drift chip_smoke.run_fleet reads there (1.71e-7
# for ssd-deep on caldot1 frames at full width, H100)
BATCH_DRIFT_ATOL = 2e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", check.CASES, ids=[c[0] for c in
                                                   check.CASES])
def test_ssd_scan_kernel_matches_plain_version(dev, case, dtype):
    name, b, S, H, P, N, chunk = case
    args = check.operands(b, S, H, P, N, dtype, dev, seed=0)
    check.check_scan(args, chunk, f"{name} {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ssd_scan_launches_the_kernel_of_its_dtype(dev, dtype):
    # each dtype runs its own tensor-core kernel, never the other's
    name, b, S, H, P, N, chunk = check.CASES[0]
    args = check.operands(b, S, H, P, N, dtype, dev, seed=0)
    got = check.kernels_launched(args, chunk)
    want = ({check.F32_KERNEL} if dtype == torch.float32 else
            set(check.KERNEL_NAMES) - {check.F32_KERNEL})
    assert got == want, (dtype, got)


def test_ssd_scan_f32_takes_a_ragged_s_without_a_padded_copy(dev,
                                                              monkeypatch):
    # S 130 (a 64-row step of 2 rows, a chunk of 2) reaches the kernel
    # as it is: the wrapper's padding helper must not run
    from repro_torch.kernels.ssd_scan import ops
    name, b, S, H, P, N, chunk = check.CASES[-1]
    assert S % 64 and S % chunk
    args = check.operands(b, S, H, P, N, torch.float32, dev, seed=1)

    def refuse(*_):
        raise AssertionError("the f32 wrapper padded its operands")
    with monkeypatch.context() as m:
        m.setattr(ops, "_padded", refuse)
        with torch.inference_mode():
            y, fin = ops.ssd_scan(*args, chunk=chunk)
    with torch.inference_mode():
        yr, sr = ops.ssd_scan_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert y.shape == (b, S, H, P)
    assert check.within_tolerance(y, yr, fin, sr) == 0


def test_ssd_scan_kernel_refuses_what_it_was_not_built_for(dev):
    check.check_refusals(dev)


@pytest.mark.parametrize("case", flash_check.CASES,
                         ids=[flash_check.case_id(c)
                              for c in flash_check.CASES])
def test_flash_attention_kernel_matches_plain_version(dev, case):
    flash_check.check_case(case, dev, seed=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_launches_the_kernel_of_its_dtype(dev, dtype):
    # each dtype runs its own tensor-core kernel, never the other's
    case = next(c for c in flash_check.CASES if c[1] == dtype)
    got = flash_check.kernels_launched(case, dev)
    want = ({flash_check.F32_KERNEL} if dtype == torch.float32 else
            set(flash_check.KERNEL_NAMES) - {flash_check.F32_KERNEL})
    assert got == want, (dtype, got)


def test_flash_attention_kernel_refuses_what_it_was_not_built_for(dev):
    flash_check.check_refusals(dev)


@pytest.mark.parametrize("dtype", decode_check.DTYPES,
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("case", decode_check.CASES,
                         ids=[c[0] for c in decode_check.CASES])
def test_decode_attention_kernel_matches_plain_version(dev, case, dtype):
    decode_check.check_case(case, dtype, dev, seed=0)


def test_decode_attention_kernel_refuses_what_it_was_not_built_for(dev):
    decode_check.check_refusals(dev)


def test_decode_attention_kernel_replays_in_a_cuda_graph(dev):
    decode_check.check_graph_replay(dev, seed=0)


@pytest.mark.parametrize("case", assign_check.CASES,
                         ids=[c[0] for c in assign_check.CASES])
def test_assign_kernel_matches_plain_version(dev, case):
    assign_check.check_case(case, dev)


@pytest.mark.parametrize("case", assign_check.RAISE_CASES,
                         ids=[c[0] for c in assign_check.RAISE_CASES])
def test_assign_kernel_raises_where_plain_version_does(dev, case):
    assign_check.check_raises(case, dev)


@pytest.mark.parametrize("case", track_check.CASES,
                         ids=[c[0] for c in track_check.CASES])
def test_track_step_kernel_matches_plain_version(dev, case):
    track_check.check_case(case, dev)


@pytest.mark.parametrize("case", plan_check.CASES,
                         ids=[c[0] for c in plan_check.CASES])
def test_proxy_plan_kernel_matches_plain_version(dev, case):
    plan_check.check_case(case, dev)


@pytest.mark.parametrize("case", plan_check.CASES,
                         ids=[c[0] for c in plan_check.CASES])
def test_proxy_plan_takes_the_branch_of_its_shape(dev, case):
    rec = plan_check.check_case(case, dev)
    got = plan_check.kernels_launched(rec["operands"], case[1][4:])
    assert len(got) == 1, got
    bulk = plan_check.BULK_KERNEL in got.pop()
    assert bulk == plan_check.takes_bulk_branch(case)


@pytest.mark.parametrize("case", gather_check.CASES,
                         ids=[c[0] for c in gather_check.CASES])
def test_window_gather_batch_kernel_matches_plain_version(dev, case):
    gather_check.check_case(case, dev)


@pytest.mark.parametrize("case", gather_check.CASES,
                         ids=[c[0] for c in gather_check.CASES])
def test_window_gather_batch_takes_the_branch_of_its_rows(dev, case):
    rec = gather_check.check_case(case, dev)
    got = gather_check.kernels_launched(rec["operands"])
    assert len(got) == 1, got
    scalar = gather_check.SCALAR_KERNEL in got.pop()
    assert scalar == (case[3] == "unaligned")


@pytest.mark.parametrize("hw", [(144, 240), (544, 960)],
                         ids=["window 240x144", "frame 960x544"])
@pytest.mark.parametrize("arch", ["ssd-lite", "ssd-deep"])
def test_detector_batch_drift_on_the_card(dev, arch, hw):
    # a window's detections must not depend on the batch a broker puts
    # it in, beyond the stated conv drift
    from repro_torch.core.detector import Detector, batch_drift
    det = Detector(arch, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    frames = torch.rand((64,) + hw + (3,), generator=gen).to(dev)
    drift = batch_drift(det.net, frames, (1, 4, 16, 64))
    assert drift[1] == 0.0
    assert max(drift.values()) <= BATCH_DRIFT_ATOL, drift


def test_track_broker_launch_matches_plain_version(dev):
    # one flush of 4 streams (Q 64, 128, 32, 128): padded to Q 128 and
    # K 4 on the card, one launch, each stream's bits as its own plain
    # step on the CPU
    import numpy as np
    from repro_torch.core.executor import TrackBroker, _TrackRequest
    from repro_torch.kernels.track_step import (LOG1P_TABLE_2D,
                                                track_step,
                                                track_step_ref)
    heads_cpu = track_check.heads(torch.device("cpu"))
    heads_dev = [p.to(dev) for p in heads_cpu]
    table_cpu = torch.from_numpy(LOG1P_TABLE_2D)
    thr = np.full((1, 1), track_check.TRACKER.match_threshold, np.float32)
    rng = np.random.default_rng(4)
    streams = [track_check.operands(rng, 1, q, heads_cpu,
                                    live=(min(q, 40), min(q, 30)))
               for q in (64, 128, 32, 128)]
    reqs = [_TrackRequest(None, [t[0].to(dev) for t in ops], thr,
                          heads_dev, table_cpu.to(dev), None)
            for ops in streams]
    before = track_step.launches
    assert TrackBroker()._dispatch(reqs) == 4
    assert track_step.launches == before + 1
    for ops, r in zip(streams, reqs):
        want = track_step_ref(*ops, torch.from_numpy(thr), heads_cpu,
                              table_cpu)
        for got, w in zip(r.result, want):
            assert track_check.bits_equal(torch.from_numpy(got), w[0])
    assert any((r.result[0] >= 0).any() for r in reqs)


# ---------------------------------------------------------------------------
# Live ingest on the card: the store, segment appends and checkpoints
# ---------------------------------------------------------------------------

LIVE_FRAMES = 32
LIVE_SEG = 16            # one chunk: every chunk as in a batch ingest


def _live_setup(dev):
    """The reduced configuration on the card with seeded weights, one
    32-frame clip, θ with the proxy threshold and det_conf at quantiles
    of the clip's own scores (refine off, as live ingest requires)."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE
    from repro_torch.core import pipeline as pl
    from repro_torch.core.detector import Detector
    from repro_torch.core.proxy import ProxyModel
    from repro_torch.core.tracker import init_tracker
    from repro_torch.data.video_synth import make_clip
    cfg = MULTISCOPE_PIPELINE.reduced()
    det_res, pres = cfg.detector.resolutions[-1], cfg.proxy.resolutions[-1]
    grid = pl.det_grid(det_res)
    sizes = [grid, (3, 2), (5, 3)]
    bank = pl.ModelBank(
        cfg, {"ssd-lite": Detector("ssd-lite", seed=5, device=dev)},
        {pres: ProxyModel(cfg.proxy.cell, cfg.proxy.base_channels, pres,
                          seed=5, device=dev)},
        tracker_params=init_tracker(cfg.tracker, seed=5, device=dev),
        sizes_cells=sizes, ref_grid=grid,
        win_times={("ssd-lite", s): t
                   for s, t in zip(sizes, (1.0, 0.2, 0.45))},
        device=dev)
    clip = make_clip("caldot1", "test", 0, n_frames=LIVE_FRAMES)
    frames = np.stack([pl.render_frame(clip, f, *det_res)[0]
                       for f in range(LIVE_FRAMES)])
    proxy, det = bank.proxies[pres], bank.detectors["ssd-lite"]
    with torch.inference_mode():
        sig = torch.sigmoid(proxy.features(pl.downsample_chunk(
            frames, pres)) @ proxy.encoder.head_w + proxy.encoder.head_b)
        thr = float(torch.quantile(sig.flatten().float(), 0.85))
        scores = torch.sigmoid(det.net(torch.from_numpy(frames).to(dev))
                               [..., 0])
        conf = float(torch.quantile(scores.flatten().float(), 0.8))
    params = pl.PipelineParams("ssd-lite", det_res, conf, gap=1,
                               proxy_res=pres, proxy_threshold=thr,
                               tracker="recurrent", refine=False)
    return bank, dataclasses.replace(params, chunk_size=LIVE_SEG), clip


def _numpy_only(packed):
    """No torch tensor in any field of a packed clip or its summary."""
    import dataclasses

    import numpy as np
    for k in ("rows", "offsets", "hist", "track_bbox"):
        assert type(getattr(packed, k)) is np.ndarray, k
    assert packed.rows.dtype == np.float32 and packed.rows.shape[1] == 6
    assert all(type(c) is int for c in packed.counters)
    assert type(packed.seconds) is float
    for f in dataclasses.fields(packed):
        assert not isinstance(getattr(packed, f.name), torch.Tensor), f.name
    for v in dataclasses.astuple(packed.summary):
        assert not isinstance(v, torch.Tensor)


def _packed_equal(a, b):
    import numpy as np
    for k in ("rows", "offsets", "hist", "track_bbox"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.summary == b.summary and a.counters == b.counters
    assert a.n_frames == b.n_frames and a.watermark == b.watermark


def test_segment_ingest_on_the_card_equals_batch_ingest(dev, tmp_path):
    # one-chunk segments leave every detector batch as it was: the
    # sealed clip is the batch ingest's bit for bit, and neither holds a
    # torch tensor
    from repro_torch.query import TrackStore
    from repro_torch.stream import SegmentIngestor
    bank, params, clip = _live_setup(dev)
    batch = TrackStore(str(tmp_path / "batch"), bank, params)
    batch.ingest([clip])
    want = batch.get(clip)
    assert len(want.rows) > 0
    st = TrackStore(str(tmp_path / "live"), bank, params)
    ing = SegmentIngestor(st)
    ing.open(clip)
    reports = [ing.append(clip, LIVE_SEG) for _ in range(2)]
    assert [r.watermark for r in reports] == [LIVE_SEG, LIVE_FRAMES]
    assert reports[-1].sealed
    _packed_equal(st.get(clip), want)
    _numpy_only(st.get(clip))
    _numpy_only(want)
    _packed_equal(TrackStore(str(tmp_path / "live"), None,
                             params).get(clip), want)


def test_device_assign_checkpoint_resumes_under_device_tracker(dev,
                                                               tmp_path):
    # a checkpoint taken from a device_assign stream holds host numpy
    # only, and resumes under the device tracker to the host batch clip
    import numpy as np
    from repro_torch.core.executor import ExecutorOptions
    from repro_torch.kernels.track_step import track_step
    from repro_torch.query import TrackStore
    from repro_torch.stream import SegmentIngestor, TrackerCheckpoint
    from repro_torch.stream.ingest import CKPT_SUFFIX
    bank, params, clip = _live_setup(dev)
    batch = TrackStore(str(tmp_path / "batch"), bank, params)
    batch.ingest([clip])
    root = str(tmp_path / "live")
    first = SegmentIngestor(TrackStore(root, bank, params),
                            options=ExecutorOptions(device_assign=True))
    first.open(clip)
    before = track_step.launches
    first.append(clip, LIVE_SEG)
    assert track_step.launches > before
    st = TrackStore(root, bank, params)
    ckpt = TrackerCheckpoint.load(st.sidecar_path(clip, CKPT_SUFFIX))
    assert all(type(v) is np.ndarray for v in ckpt.to_arrays().values())
    assert all(type(t.h) is np.ndarray for t in ckpt.active)
    second = SegmentIngestor(st, options=ExecutorOptions(
        device_tracker=True))
    assert second.open(clip) == LIVE_SEG
    before = track_step.launches
    sealed = second.seal(clip)
    assert track_step.launches > before
    _packed_equal(sealed, batch.get(clip))
    _numpy_only(sealed)
