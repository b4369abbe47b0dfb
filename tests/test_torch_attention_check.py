"""The attention kernels' on-card comparison (``repro_torch.kernels.
flash_attention.check.kernel_agrees``, shared by ``decode_attention.
check``), on the CPU: what it lets through and what it stops.  f32 within
1e-5; bf16 at most one bf16 ulp apart, the f32 bound near zero."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bf16_steps  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    check as decode_check)
from repro_torch.kernels.decode_attention.ops import MAX_GROUP  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check as flash_check)
from repro_torch.kernels.flash_attention.check import (  # noqa: E402
    ATTN_F32_ATOL, kernel_agrees)


def _bf16(values):
    return torch.tensor(values, dtype=torch.float32).to(torch.bfloat16)


def _step(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` (bf16) moved ``n`` bf16 values up, through the bit pattern
    (positive values only)."""
    assert bool((t > 0).all())
    return (t.view(torch.int16) + n).view(torch.bfloat16)


@pytest.mark.parametrize("x", [1.0, 0.37, 2.5, 1e-3])
def test_bf16_one_ulp_apart_passes(x):
    want = _bf16([x, 0.5, 0.25])
    got = want.clone()
    got[0] = _step(want[:1], 1)[0]
    assert int(bf16_steps(got, want).max()) == 1
    err = kernel_agrees(got, want, "one ulp")
    assert err == pytest.approx(float(got[0].float() - want[0].float()))


@pytest.mark.parametrize("x", [1.0, 0.37, 2.5, 1e-3])
def test_bf16_two_ulps_apart_fails(x):
    want = _bf16([0.5, x, 0.25])
    got = want.clone()
    got[1] = _step(want[1:2], 2)[0]
    assert float((got.float() - want.float()).abs().max()) > ATTN_F32_ATOL
    with pytest.raises(AssertionError, match=r"at 1 elements, first \(1,\)"):
        kernel_agrees(got, want, "two ulps")


@pytest.mark.parametrize("shape", [(4, 3, 2, 8), (2, 14, 64)])
def test_f32_planted_error_fails(shape):
    rng = np.random.default_rng(0)
    want = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = want.clone()
    at = tuple(int(rng.integers(0, n)) for n in shape)
    got[at] += 1e-4
    with pytest.raises(AssertionError, match="kernel != plain version at 1 "
                       f"elements, first {at}".replace("(", r"\(")
                       .replace(")", r"\)")):
        kernel_agrees(got, want, "planted")


def test_f32_rounding_level_difference_passes():
    rng = np.random.default_rng(1)
    want = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    got = want + 5e-6 * torch.from_numpy(
        rng.choice([-1.0, 1.0], (4, 64)).astype(np.float32))
    assert kernel_agrees(got, want, "rounding") <= ATTN_F32_ATOL


@pytest.mark.parametrize("want_v,got_v,ok", [
    (1e-6, 5e-6, True),       # many bf16 ulps apart, 4e-6 absolute
    (-2e-6, 3e-6, True),      # opposite signs near zero, 5e-6 absolute
    (0.0, 9e-6, True),
    (1e-6, 3e-5, False),      # many ulps and over the absolute bound
    (0.0, -2e-5, False),
])
def test_bf16_near_zero_takes_the_absolute_bound(want_v, got_v, ok):
    want = _bf16([0.5, want_v])
    got = _bf16([0.5, got_v])
    assert int(bf16_steps(got, want)[1]) > 1
    if ok:
        assert kernel_agrees(got, want, "near zero") <= ATTN_F32_ATOL
    else:
        with pytest.raises(AssertionError, match="near zero"):
            kernel_agrees(got, want, "near zero")


def test_flash_cases_cover_the_kernel_contract():
    cases = flash_check.CASES
    assert len(cases) == 22
    assert {c[1] for c in cases} == {torch.float32, torch.bfloat16}
    # the prefill's call, a ragged edge, queries at the end of the keys,
    # kv_valid masking, non-causal, rows with no key
    qwen2 = (flash_check.HQ, flash_check.HKV, flash_check.D)
    assert ("S500 causal", torch.bfloat16, 500, 500, True, 0, qwen2) \
        in cases
    # zamba2-7b's head dim 112 at its prefill (S 500, ragged) in both
    # dtypes
    for dt in (torch.float32, torch.bfloat16):
        assert ("D112 S500 causal", dt, 500, 500, True, 0,
                flash_check.HYBRID_HEADS) in cases
    # deepseek-moe-16b's head dim 128 at its prefill, and every other
    # head-dim-128 layout of the configs, in both dtypes
    for dt in (torch.float32, torch.bfloat16):
        assert ("D128 S500 causal", dt, 500, 500, True, 0,
                flash_check.MOE_HEADS) in cases
        for heads in flash_check.D128_LAYOUTS.values():
            assert any(c[1] == dt and c[6] == heads for c in cases)
    assert any(c[2] < c[3] and c[4] for c in cases)
    assert any(c[5] for c in cases) and any(not c[4] for c in cases)
    assert any(c[2] > c[3] and c[4] for c in cases)
    assert len({flash_check.case_id(c) for c in cases}) == len(cases)


def test_serve_cases_cover_the_encdec_and_vlm_calls():
    """The flash cases of the encdec and vlm cells, each in both dtypes:
    whisper's encoder (1500 keys: no multiple of 64 or 128, non-causal),
    its cross-attention (fewer queries than keys, non-causal), its
    decoder's self-attention at MHA 12 of 12 of 64, and pixtral's
    longest prompt at 32 of 8 of 128; the decode cases of both cells,
    the cross call every row at 1500 frames.  Apart from ``CASES``."""
    cases = flash_check.SERVE_CASES
    assert not set(cases) & set(flash_check.CASES)
    assert len(cases) == 10
    assert len({flash_check.case_id(c) for c in cases}) == len(cases)
    whisper, pixtral = flash_check.WHISPER_HEADS, flash_check.PIXTRAL_HEADS
    for dt in (torch.float32, torch.bfloat16):
        assert ("D64 MHA12 S1500 non-causal", dt, 1500, 1500, False, 0,
                whisper) in cases
        assert ("D64 MHA12 Sq500 Skv1500 non-causal", dt, 500, 1500, False,
                0, whisper) in cases
        assert ("D64 MHA12 S500 causal", dt, 500, 500, True, 0,
                whisper) in cases
        assert ("D128 pixtral-12b S1524 causal", dt, 1524, 1524, True, 0,
                pixtral) in cases
    assert 1500 % 64 and 1500 % 128 and 1524 % 64
    assert whisper == (12, 12, 64) and pixtral == (32, 8, 128)
    cross = decode_check.CROSS_CASE
    assert cross[1:6] == (4, 1500) + whisper and cross[6] == (1500,) * 4
    assert decode_check.VLM_CASE[3:6] == pixtral
    assert decode_check.VLM_CASE[6] == (1, 1085, 1524, 2048)
    assert decode_check.ENCDEC_CASE[3:6] == whisper
    assert set(decode_check.SERVE_CASES) <= set(decode_check.CASES)


def test_flash_case_operands_are_seeded_and_shaped():
    case = flash_check.CASES[4]
    q, k, v = flash_check.case_operands(case, "cpu", seed=3)
    assert q.shape == (flash_check.B, case[2], flash_check.HQ, flash_check.D)
    assert k.shape == v.shape == (flash_check.B, case[3], flash_check.HKV,
                                  flash_check.D)
    assert q.dtype == case[1]
    again = flash_check.case_operands(case, "cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip((q, k, v), again))


def test_decode_cases_cover_the_kernel_contract():
    cases = decode_check.CASES
    serving = cases[0]
    S = serving[2]
    assert serving[1:6] == (4, 1024, 14, 2, 64)
    assert serving[6] == (1, 61, S // 2, S)
    lens = [n for c in cases for n in c[6]]
    assert 0 in lens                          # an empty row gives 0
    assert any(c[3] // c[4] == MAX_GROUP for c in cases)
    for _, b, S, Hq, Hkv, D, kv_len in cases:
        assert len(kv_len) == b and max(kv_len) <= S and Hq % Hkv == 0
    # every head-dim-128 layout at the serving call's lengths
    assert decode_check.MOE_CASE[3:6] == flash_check.MOE_HEADS
    assert {c[3:6] for c in decode_check.D128_CASES} == \
        {flash_check.MOE_HEADS, *flash_check.D128_LAYOUTS.values()}
    assert decode_check.HYBRID_CASE[5] == 112
    q, k, v, kv = decode_check.case_operands(cases[1], torch.bfloat16, "cpu",
                                             seed=0)
    assert q.shape == (4, 14, 64) and k.shape == v.shape == (4, 1024, 2, 64)
    assert kv.dtype == torch.int32 and kv.tolist() == list(cases[1][6])


def test_grid_blocks_counts_each_matching_launch_of_a_trace(monkeypatch):
    """``chip_smoke.grid_blocks``, which reports the decode kernel's
    thread blocks from the profiler's trace: grid x * y * z of each
    launch of a kernel whose name matches, and nothing else."""
    import importlib.util
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # its dataclasses
    spec.loader.exec_module(smoke)
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "args": {"grid": [16, 2, 4],
                                              "block": [128, 1, 1]},
         "name": "void (anonymous namespace)::decode_attention_kernel"
                 "<__nv_bfloat16, 64>(...)"},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
         "args": {}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel",
         "args": {"grid": [100, 1, 1]}},
        {"ph": "X", "cat": "cpu_op", "name": "decode_attention_kernel",
         "args": {}},
        {"ph": "X", "cat": "kernel", "name": "decode_attention_kernel<float>",
         "args": {"grid": [1, 2, 4]}},
    ]}
    names = ("decode_attention_kernel",)
    assert smoke.grid_blocks(trace, names) == [128, 8]
    assert smoke.grid_blocks(trace, ("ssd_scan_kernel",)) == []
    assert smoke.grid_blocks({}, names) == []


def test_trace_sums_match_the_parsed_profile(monkeypatch):
    """``chip_smoke.trace_sums`` reads a profile's raw events where the
    serve phases used ``events()`` / ``key_averages()`` (a Python parse
    that took most of each phase's wall): on a CPU profile of a reduced
    generate, each ``aten::`` op's self time and calls are
    ``key_averages()``'s (within 1e-6 of its time: the sums' order), an
    op whose one child is itself counted once, no device time and no
    launch.  On the card the device sums and launch count read equal
    too, and each op's self time within 0.3% (PERF.md, PR 30)."""
    import importlib.util
    import sys
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # its dataclasses
    spec.loader.exec_module(smoke)
    model = build_model(get_config("qwen2-0.5b").reduced())
    eng = ServeEngine(model, model.init_params(0, device="cpu"), max_len=32)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.generate([[1, 2, 3, 4, 5], [6, 7]], 6)
    finally:
        torch.set_num_threads(n)
    per_name, launches, host = smoke.trace_sums(prof)
    assert per_name == {} and launches == 0
    want = {ev.key: (ev.self_cpu_time_total, ev.count)
            for ev in prof.key_averages() if ev.key.startswith("aten::")}
    got = {name: (us, calls) for us, name, calls in host}
    assert set(got) == set(want) and len(got) > 10
    for name, (us, calls) in got.items():
        assert calls == want[name][1], name
        assert abs(us - want[name][0]) <= 1e-6 * max(us, 1.0), name
    assert [h[0] for h in host] == sorted((h[0] for h in host),
                                          reverse=True)
