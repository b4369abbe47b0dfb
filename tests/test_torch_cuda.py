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
