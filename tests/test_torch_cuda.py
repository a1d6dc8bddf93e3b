"""The CUDA kernel on a card: ``fused_cg_update`` against its plain version,
CG (plain and preconditioned) on the card against CG on the CPU, and the
empirical-Fisher diagonal on the card against the CPU.

These tests need a CUDA device and ``nvcc``, and skip without them.  They
import no JAX, so on a machine without it run them without the JAX-only
conftest::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorchhessianfree_tpu_torch import (  # noqa: E402
    TrainableRavel,
    cg,
    diag_EF,
    diag_EF_scan,
    diag_to_preconditioner,
)
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    allcnnc_apply,
    cross_entropy_loss,
    init_allcnnc,
    l2_regularizer,
)
from pytorchhessianfree_tpu_torch.ops.cg_update import (  # noqa: E402
    fused_cg_update,
    fused_cg_update_reference,
)
from pytorchhessianfree_tpu_torch.utils.flatten import tree_map  # noqa: E402

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


def test_preconditioned_cg_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    n = 512
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.geomspace(1.0, 20.0, n)) @ q.T + np.diag(np.geomspace(
        0.1, 10.0, n))
    b = rng.standard_normal(n)
    diag = np.abs(np.diag(a))
    out = []
    for dev in (cuda, torch.device("cpu")):
        A = torch.tensor(a, device=dev)
        M = diag_to_preconditioner(torch.tensor(diag, device=dev), 0.5, 0.75)
        out.append(cg(lambda v: A @ v, torch.tensor(b, device=dev), M=M,
                      max_iter=40, martens_conv_crit=True,
                      store_x_at_iters=None))
    gpu, cpu = out
    assert (gpu.num_iters, gpu.reason) == (cpu.num_iters, cpu.reason)
    k = gpu.num_iters
    torch.testing.assert_close(gpu.m_hist[: k + 1].cpu(), cpu.m_hist[: k + 1],
                               rtol=1e-9, atol=0)
    err = torch.linalg.vector_norm(gpu.x.cpu() - cpu.x)
    assert err <= 1e-9 * torch.linalg.vector_norm(cpu.x)


@pytest.mark.parametrize("use_scan", [False, True])
def test_diag_EF_on_card_matches_cpu(cuda, use_scan):
    gen = torch.Generator().manual_seed(0)
    params = init_allcnnc(gen, width_scale=1 / 8, dtype=torch.float64)
    x = torch.randn((6, 32, 32, 3), generator=gen, dtype=torch.float64)
    y = torch.randint(0, 100, (6,), generator=gen)
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev), params)
        fn = diag_EF_scan if use_scan else diag_EF
        out.append(fn(allcnnc_apply, cross_entropy_loss, p, x.to(dev),
                      y.to(dev), "mean", TrainableRavel(p, pad_to_multiple=1024),
                      loss_reg=l2_regularizer))
    gpu, cpu = out
    assert gpu.device.type == "cuda"
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-10, atol=1e-300)
