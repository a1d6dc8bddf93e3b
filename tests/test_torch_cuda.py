"""The CUDA kernel on a card: ``fused_cg_update`` against its plain version,
and CG on the card against CG on the CPU.

These tests need a CUDA device and ``nvcc``, and skip without them.  They
import no JAX, so on a machine without it run them without the JAX-only
conftest::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorchhessianfree_tpu_torch import cg  # noqa: E402
from pytorchhessianfree_tpu_torch.ops.cg_update import (  # noqa: E402
    fused_cg_update,
    fused_cg_update_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) for the kernel")
    return torch.device("cuda")


def _tensors(n, dtype, device):
    rng = np.random.default_rng(n)
    vecs = [rng.standard_normal(n) for _ in range(5)]
    vecs[4] = -vecs[0] + 0.1 * vecs[4]  # b near -x: m far from 0
    alpha = rng.uniform(0.1, 2.0)
    return [torch.tensor(v, dtype=dtype, device=device) for v in vecs] + [
        torch.tensor(alpha, dtype=dtype, device=device)
    ]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 1000, 1_000_003])
def test_kernel_matches_reference(cuda, dtype, n):
    dtype = getattr(torch, dtype)
    args = _tensors(n, dtype, cuda)
    before = fused_cg_update.launches
    out = fused_cg_update(*args)
    again = fused_cg_update(*args)
    ref = fused_cg_update_reference(*args)
    torch.cuda.synchronize()
    assert fused_cg_update.launches == before + 2
    # x', r' are formed without FMA contraction: bitwise equal
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    # m, rr: the summation order differs from the plain version
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(out[2], ref[2], rtol=rtol, atol=0)
    torch.testing.assert_close(out[3], ref[3], rtol=rtol, atol=0)
    # fixed grid, fixed reduction order: bitwise reproducible
    assert torch.equal(out[2], again[2]) and torch.equal(out[3], again[3])


def test_kernel_rejects_cpu_cuda_mix(cuda):
    args = _tensors(1000, torch.float32, cuda)
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="one device"):
        fused_cg_update(*args)


def test_cg_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    n = 512
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.geomspace(1.0, 20.0, n)) @ q.T
    b = rng.standard_normal(n)
    out = []
    for dev in (cuda, torch.device("cpu")):
        A = torch.tensor(a, device=dev)
        out.append(cg(lambda v: A @ v, torch.tensor(b, device=dev),
                      max_iter=40, martens_conv_crit=True,
                      store_x_at_iters=None))
    gpu, cpu = out
    assert (gpu.num_iters, gpu.reason) == (cpu.num_iters, cpu.reason)
    k = gpu.num_iters
    torch.testing.assert_close(gpu.m_hist[: k + 1].cpu(), cpu.m_hist[: k + 1],
                               rtol=1e-9, atol=0)
    err = torch.linalg.vector_norm(gpu.x.cpu() - cpu.x)
    assert err <= 1e-9 * torch.linalg.vector_norm(cpu.x)
