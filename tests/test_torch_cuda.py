"""The port's ``ssd_scan`` CUDA kernel against its plain version, on the
card.  Marked ``cuda``: each test skips without a CUDA device (a kernel
has no CPU mode; the CPU tests hold the plain version to the JAX
package).  This file imports torch only, so that it runs on a machine
with a card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes, operands and tolerance are ``repro_torch.kernels.ssd_scan.
check``'s, the same ``chip_smoke.py`` holds the kernel to: f32 y and
final state within 1e-4 of max |plain|; bf16 y within 2 bf16 ulps of the
plain version's f32 result on the same (bf16-valued) inputs.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import check  # noqa: E402

pytestmark = pytest.mark.cuda


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


def test_ssd_scan_kernel_refuses_what_it_was_not_built_for(dev):
    check.check_refusals(dev)
