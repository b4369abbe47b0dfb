"""The port's CUDA kernels against their plain versions, on the card:
``ssd_scan``, ``flash_attention``, ``decode_attention``, ``assign``,
``track_step``, ``proxy_plan``, ``window_gather_batch``,
``proxy_score`` and the single-frame ``window_gather``.  Marked
``cuda``: each test skips without a CUDA device (a kernel has no CPU
mode; the CPU tests hold the plain versions to the JAX package).  This
file imports torch only, so that it runs on a machine with a card and no
JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes, operands and tolerances are the kernels' ``check`` modules'
(``repro_torch.kernels.<name>.check``), the same ``chip_smoke.py`` holds
the kernels to, at every instance the configs serve (the attention
kernels at head dims 64, 112 and 128, the last at each of the configs'
head layouts; whisper-small's encoder, cross- and self-attention (1500
keys non-causal, 500 queries against 1500 keys, MHA 12 of 12) and
pixtral-12b's prompts (32 of 8 at S 1524) in ``SERVE_CASES``, with an
8-step CUDA-graph replay of the 1500-frame cross decode; the scan at
(P, N) = (64, 128) and (64, 64), and its backward kernel in both
dtypes against the plain backward, under autograd, bit for bit twice
and with its planted faults caught), with
refusals of unbuilt ones (head dims 32 and 96): ``ssd_scan``'s f32 y and final
state within 1e-4 of max |plain|, bf16 y within 2 bf16 ulps of the
plain version's f32 result on the same (bf16-valued) inputs, f32 at a
ragged S with no padding copy,
and each dtype on its own kernel (both on tensor cores, f32 as 3xTF32,
read from the profiler's trace); the attention kernels' f32 within
1e-5, bf16 one bf16 ulp apart (the f32 bound near zero), flash
attention's dtypes each on its own kernel; ``assign`` and
``track_step`` bit for bit (their tie, signed-zero, all-inf, dead-row,
padding and large-matrix cases included), and non-finite costs must
raise in ``assign`` as in its plain version; ``proxy_plan`` within the
8-ulp threshold band of float64 arithmetic, its stats equal wherever no
flip touched the frame, and ``window_gather_batch`` bit for bit, each
on the branch of its shape (bulk copies where aligned); ``proxy_score``
within 1e-6 of its plain version and the 8-ulp band, float2 loads where
C is even; the single-frame ``window_gather`` bit for bit, each case on
the instance its rows and table imply (float4 or scalar; a host table
of at most 16 rows carried by the launch, with no host-to-device copy,
else a device table), the per-frame engine's own gathers on the
carried-rows instance, and ``ProxyModel.scores`` with one
device-to-host copy a call.  Two cases hold
what the cross-stream brokers rely on: the detector's scores at batch 1
against batches 4, 16 and 64 (both architectures, a window and a full
frame at full width), within ``BATCH_DRIFT_ATOL``; and one
``TrackBroker`` launch over 4 streams of mixed Q, each stream's outputs
equal to the plain version's on the CPU bit for bit.  Two hold the
executor's instrumentation on the card: tracks, dispatches and
``track_step`` launches with the tracer on equal the untraced runs bit
for bit (host and device TRACK), and a ``BatchBroker``'s flush and
dispatch spans give an exact window ledger.  Two hold the
training and tuning path: the proxy's 3 training steps on the card
against the CPU (``repro_torch.core.train_check``), and a CUDA bank's
window times, taken over a batch of 16 on the device, larger for a
larger window.  One holds the MoE block: two card runs equal bit for
bit, and the card's output the CPU's where the routing agrees.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.assign import check as assign_check  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    check as decode_check)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check as flash_check)
from repro_torch.kernels.proxy_plan import check as plan_check  # noqa: E402
from repro_torch.kernels.proxy_score import (  # noqa: E402
    check as score_check)
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


@pytest.mark.parametrize("case", flash_check.CASES + flash_check.SERVE_CASES,
                         ids=[flash_check.case_id(c) for c in
                              flash_check.CASES + flash_check.SERVE_CASES])
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


# one case a head dim (64, 112, 128), each dtype
BWD_TEST_CASES = [c for c in flash_check.BWD_CASES
                  if c[0] in ("S500 causal", "D112 S500 causal",
                              "D128 S512 causal")]


@pytest.mark.parametrize("case", BWD_TEST_CASES,
                         ids=[flash_check.case_id(c) for c in BWD_TEST_CASES])
def test_flash_attention_bwd_kernel_matches_plain_version(dev, case):
    flash_check.check_bwd_case(case, dev, seed=0)


# bf16 at a group of 7 (three kernels) and of 1 (two), f32 (two)
BWD_KERNEL_CASES = [c for c in flash_check.BWD_CASES
                    if c[0] == "S500 causal"
                    or (c[0] == "D64 MHA12 Sq500 Skv1500 non-causal"
                        and c[1] == torch.bfloat16)]


@pytest.mark.parametrize("case", BWD_KERNEL_CASES,
                         ids=[flash_check.case_id(c)
                              for c in BWD_KERNEL_CASES])
def test_flash_attention_bwd_launches_the_kernels_of_its_dtype(dev, case):
    # bf16 runs the tensor-core kernels (the partials' sum only for a
    # group), f32 the CUDA-core ones, never the other dtype's
    hq, hkv, _ = case[6]
    got = flash_check.bwd_kernels_launched(case, dev, seconds=0.25)
    assert got == set(flash_check.bwd_kernel_names(case[1], hq // hkv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_differentiates_through_its_kernels(dev, dtype):
    """Under grad on the card, ``flash_attention`` launches the forward
    kernel once and, at ``backward``, the backward kernel once; the
    gradients are the plain backward's.  Without grad it launches the
    forward only and its output has no graph."""
    case = next(c for c in flash_check.BWD_CASES
                if c[0] == "S500 causal" and c[1] == dtype)
    q, k, v, _, dout = flash_check.bwd_case_operands(case, dev, seed=3)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    fwd, bwd = flash_check.flash_attention, flash_check.flash_attention_bwd
    f0, b0 = fwd.launches, bwd.launches
    out = fwd(*leaves)
    out.backward(dout)
    assert (fwd.launches - f0, bwd.launches - b0) == (1, 1)
    want = flash_check.flash_attention_bwd_ref(q, k, v, out.detach(), dout)
    flash_check.grads_agree([t.grad for t in leaves], want, "autograd")
    with torch.no_grad():
        assert fwd(*leaves).grad_fn is None


def test_decode_and_scan_refuse_autograd_on_the_card(dev):
    """``decode_attention`` has no backward kernel: under grad with an
    input that requires it, it raises, never hands back an output with
    no graph."""
    q, k, v, kv_len = decode_check.case_operands(
        decode_check.CASES[0], torch.bfloat16, dev, seed=0)
    with pytest.raises(NotImplementedError, match="no backward"):
        decode_check.decode_attention(q.requires_grad_(True), k, v, kv_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", check.CASES, ids=[c[0] for c in
                                                   check.CASES])
def test_ssd_scan_bwd_kernel_matches_plain_version(dev, case, dtype):
    # a final state's gradient in BWD_FINAL_CASE; bf16 twice, same bits
    check.check_bwd_case(case, dtype, dev, seed=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ssd_scan_differentiates_through_its_kernels(dev, dtype):
    """Under grad on the card, ``ssd_scan`` launches the forward kernel
    once and, at ``backward``, the backward kernel once (its three
    kernels, by profiler name); the gradients, in the inputs' dtypes,
    are the plain backward's.  Without grad it launches the forward
    only and its output has no graph."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    case = check.CASES[3]
    *fwd, dy, _ = check.bwd_operands(case, dtype, dev, seed=3)
    chunk = case[6]
    leaves = [t.detach().requires_grad_(True) for t in fwd]
    f0, b0 = ssd_scan.launches, ssd_scan_bwd.launches
    y, _ = ssd_scan(*leaves, chunk=chunk)
    y.backward(dy)
    assert (ssd_scan.launches - f0, ssd_scan_bwd.launches - b0) == (1, 1)
    got = [t.grad for t in leaves]
    assert [g.dtype for g in got] == [t.dtype for t in fwd]
    want = check.ssd_scan_bwd_ref(*(a.float() for a in fwd), dy.float(),
                                  None, chunk=chunk)
    assert not any(check.bwd_outside(got, want).values())
    args = check.bwd_operands(case, dtype, dev, seed=3)
    assert check.bwd_kernels_launched(args, seconds=0.25) == set(
        check.BWD_KERNEL_NAMES)
    with torch.no_grad():
        assert ssd_scan(*leaves, chunk=chunk)[0].grad_fn is None


def test_ssd_scan_bwd_is_deterministic_and_catches_its_planted_faults(dev):
    """Two bf16 calls give the same bits (no atomics), and each of
    ``BWD_PLANTS`` fails the check."""
    case = check.CASES[0]
    args = check.bwd_operands(case, torch.bfloat16, dev, seed=4)
    _, _, first = check.check_bwd(args, "first")
    _, _, second = check.check_bwd(args, "second")
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    read = check.check_bwd_plants(case, torch.float32, dev, seed=4)
    assert set(read) == set(check.BWD_PLANTS)


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


def test_cross_decode_replays_eight_steps_in_a_cuda_graph(dev):
    decode_check.check_cross_graph_replay(dev, seed=0, steps=8)


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


@pytest.mark.parametrize("case", score_check.CASES,
                         ids=[c[0] for c in score_check.CASES])
def test_proxy_score_kernel_matches_plain_version(dev, case):
    score_check.check_case(case, dev)


@pytest.mark.parametrize("case", score_check.CASES,
                         ids=[c[0] for c in score_check.CASES])
def test_proxy_score_takes_the_branch_of_its_shape(dev, case):
    rec = score_check.check_case(case, dev)
    got = score_check.kernels_launched(rec["operands"])
    assert len(got) == 1, got
    vec2 = score_check.VEC2_KERNEL in got.pop()
    assert vec2 == score_check.takes_vec2_branch(case)


@pytest.mark.parametrize("case", gather_check.SINGLE_CASES,
                         ids=[c[0] for c in gather_check.SINGLE_CASES])
def test_window_gather_kernel_matches_plain_version(dev, case):
    gather_check.check_single_case(case, dev)


@pytest.mark.parametrize("case", gather_check.SINGLE_CASES,
                         ids=[c[0] for c in gather_check.SINGLE_CASES])
def test_window_gather_takes_the_branch_of_its_rows_and_table(dev, case):
    rec = gather_check.check_single_case(case, dev)
    got = gather_check.single_kernels_launched(rec["operands"])
    scalar, rows = gather_check.single_branch(case)
    # only a host table too long for the launch goes to the card first
    copies = {k for k in got if "Memcpy" in k}
    assert bool(copies) == (case[4] == "host" and not rows), got
    got -= copies
    assert len(got) == 1, got
    name = got.pop()
    assert (gather_check.SCALAR_KERNEL in name) == scalar, name
    assert (gather_check.ROWS_TABLE if rows
            else gather_check.DEVICE_TABLE) in name, name


def test_per_frame_engine_gathers_take_the_rows_launcher(dev, monkeypatch):
    """The per-frame engine's own gathers (reduced configuration on the
    card): every table is a host array of at most 16 rows, and a replay
    of each call launches the carried-rows instance with no
    host-to-device copy."""
    import numpy as np
    from repro_torch.core import pipeline as pl
    bank, params, clip = _live_setup(dev)
    calls = []
    real = pl.window_gather

    def spy(frame, table, **kw):
        calls.append((frame, table, kw["win_h"], kw["win_w"]))
        return real(frame, table, **kw)
    monkeypatch.setattr(pl, "window_gather", spy)
    pl.run_clip(bank, params, clip, engine="frame")
    assert calls, "the per-frame run gathered no window"
    for frame, table, win_h, win_w in calls[:8]:
        assert isinstance(table, np.ndarray), type(table)
        assert len(table) <= gather_check.MAX_PARAM_ROWS
        got = gather_check.single_kernels_launched(
            (frame, table, win_h, win_w))
        assert not any("Memcpy" in k for k in got), got
        assert len(got) == 1 and gather_check.ROWS_TABLE in got.pop()


def test_proxy_scores_copy_back_once(dev):
    """``ProxyModel.scores`` brings scores and positives back in one
    device-to-host copy a call."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.proxy import ProxyModel
    proxy = ProxyModel(8, 4, (32, 24), seed=5, device=dev)
    frame = np.random.default_rng(0).random((24, 32, 3), np.float32)
    proxy.scores(frame, 0.5)
    torch.cuda.synchronize()
    calls = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            s, p = proxy.scores(frame, 0.5)
        torch.cuda.synchronize()
    copies = sum(ev.count for ev in prof.key_averages()
                 if "Memcpy DtoH" in ev.key)
    assert copies == calls, copies
    assert s.dtype == np.float32 and p.dtype == np.int8


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


def test_tracing_on_the_card_is_bit_identical(dev):
    # the tracer observes the card's runs without perturbing them: host
    # and device TRACK, tracer off / on / off, give the same tracks bit
    # for bit, dispatches and track_step launches; the traced run has
    # one run span and its stage spans, with the run's stream
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.executor import ClipExecutor, ExecutorOptions
    from repro_torch.kernels.track_step import track_step
    bank, params, clip = _live_setup(dev)
    for opts in (ExecutorOptions(), ExecutorOptions(device_tracker=True)):
        runs = []
        for traced in (False, True, False):
            obs.TRACER.clear()
            if traced:
                obs.enable()
            try:
                before = track_step.launches
                r = ClipExecutor(bank, params, opts).run(clip)
                torch.cuda.synchronize()
                runs.append((r, track_step.launches - before,
                             obs.TRACER.snapshot()))
            finally:
                obs.disable()
                obs.TRACER.clear()
        ref = runs[0][0]
        assert sum(map(len, ref.tracks)) > 0
        for r, launches, spans in runs:
            assert r.dispatches == ref.dispatches
            assert launches == runs[0][1]
            assert len(r.tracks) == len(ref.tracks)
            for x, y in zip(r.tracks, ref.tracks):
                assert np.array_equal(x, y)
        spans = runs[1][2]
        roots = [sp for sp in spans if sp.name == "run"]
        assert len(roots) == 1 and roots[0].stream == "caldot1/test0"
        stages = [sp for sp in spans if sp.name.startswith("stage.")]
        assert len(stages) == 4 * (LIVE_FRAMES // LIVE_SEG)
        assert all(sp.parent == roots[0].sid and sp.dur >= 0
                   for sp in stages)
        assert runs[0][2] == runs[2][2] == []
        if opts.device_tracker:
            assert runs[0][1] > 0


def test_batch_broker_flush_ledger_on_the_card(dev):
    # 3 streams through one BatchBroker on the card with the tracer on:
    # each flush's dispatch windows sum to its windows, over the run to
    # every window the streams submitted, and the registry's dispatch
    # counter grows by the broker's dispatches
    import threading
    from repro_torch import obs
    from repro_torch.core.executor import (BatchBroker, ExecutorOptions,
                                           run_clip_streamed)
    bank, params, clip = _live_setup(dev)
    broker = BatchBroker()
    disp0 = obs.REGISTRY.counter("broker.detect.dispatches").value
    results = [None] * 3
    obs.TRACER.clear()
    obs.enable()
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, run_clip_streamed(bank, params, clip, ExecutorOptions(
                batch_broker=broker))), daemon=True) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
        broker.close()
        spans = obs.TRACER.snapshot()
    finally:
        obs.disable()
        obs.TRACER.clear()
    assert all(r is not None for r in results)
    flushes = {sp.sid: sp for sp in spans if sp.name == "broker.detect.flush"}
    disp = [sp for sp in spans if sp.name == "broker.detect.dispatch"]
    assert len(disp) == broker.dispatches > 0
    per = {}
    for sp in disp:
        assert sp.parent in flushes
        per[sp.parent] = per.get(sp.parent, 0) + sp.args["windows"]
    assert per == {sid: f.args["windows"] for sid, f in flushes.items()}
    total = sum(r.detector_windows for r in results)
    assert sum(per.values()) == broker.windows_in == total
    assert obs.REGISTRY.counter("broker.detect.dispatches").value - disp0 \
        == broker.dispatches
    assert obs.REGISTRY.gauge("broker.detect.queue_depth").value == 0.0


def test_proxy_training_on_the_card_matches_the_cpu(dev):
    # 3 steps of _fit from one seeded init on both devices, on identical
    # batches at full width (core.train_check; chip_smoke runs all three
    # trainers): each loss and the first step's gradients within 1e-4,
    # the final parameters the same function within 1e-3, and the two
    # card runs alike
    from repro_torch.core import train_check
    r = train_check.check_trainer("proxy", dev)
    assert r["loss_rel"] <= train_check.LOSS_RTOL
    assert r["grad_rel"] <= train_check.GRAD_RTOL
    assert r["fresh_rel"] <= train_check.FRESH_RTOL
    assert r["card_to_card_loss"] <= train_check.LOSS_RTOL * max(
        r["losses_cpu"])


def test_window_time_on_the_card_times_a_batch(dev, monkeypatch):
    # a CUDA bank's window times come from a batch of the executor's
    # default chunk, already on the device, and read larger for a larger
    # window (at batch 1 the card is launch-bound and they do not)
    from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE
    from repro_torch.core import pipeline as pl
    from repro_torch.core.detector import Detector
    det = Detector("ssd-deep", seed=0, device=dev)
    shapes = []
    real = det.detect_batch
    monkeypatch.setattr(det, "detect_batch", lambda f, c, **k: (
        shapes.append((tuple(f.shape), f.device.type)), real(f, c, **k))[1])
    bank = pl.ModelBank(MULTISCOPE_PIPELINE, {"ssd-deep": det}, device=dev)
    small = pl.measure_window_time(bank, "ssd-deep", (15, 9))
    full = pl.measure_window_time(bank, "ssd-deep", (60, 34))
    assert set(shapes) == {((pl.TIMING_BATCH, 144, 240, 3), "cuda"),
                           ((pl.TIMING_BATCH, 544, 960, 3), "cuda")}
    assert 0.0 < small < full
    assert bank.win_times[("ssd-deep", (15, 9))] == small


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_on_the_card_matches_the_cpu(dev, dtype):
    """``MoEBlock`` at deepseek-moe-16b's routing (64 experts, top-6, 2
    shared; d_model 256, expert_d_ff 64) on a (4, 500) batch: two card
    runs give the same bits (no scatter-add), and the card's output is
    the CPU's within 1e-4 (f32) / 2e-2 (bf16) of max(1, max |CPU|) at
    every token whose routing agrees (``Routing.differs``: at most 1%
    differ, the router's f32 products summing in another order)."""
    import copy
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    cfg = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg, dtype=dtype, d_model=256, n_layers=2,
                              moe=dataclasses.replace(cfg.moe,
                                                      expert_d_ff=64))
    params = build_model(cfg).init_params(0, device="cpu")
    cpu = params.layers[0].moe
    card = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 500, 256), generator=gen).to(getattr(torch, dtype))
    with torch.inference_mode():
        want, want_aux = cpu(x)
        want_r = cpu.routing
        got, aux = card(x.to(dev))
        got_r = card.routing
        again, again_aux = card(x.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(aux, again_aux)
    moved = got_r.differs(want_r).cpu()
    assert int(moved.sum()) <= 0.01 * moved.numel(), int(moved.sum())
    rel = 1e-4 if dtype == "float32" else 2e-2
    tol = rel * max(1.0, float(want.float().abs().max()))
    err = float((got.cpu().float() - want.float())[~moved].abs().max())
    assert err <= tol, (err, tol)
    assert abs(float(aux) - float(want_aux)) <= rel * max(
        1.0, abs(float(want_aux)))
