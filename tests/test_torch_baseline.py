"""The torch-CPU full-step baseline (benchmarks/torch_baseline.py) is the
denominator of the driver's per-step wall-clock metric, so its solver
semantics must be the *reference's* semantics: this pins its CG against the
NumPy reference replica (tests/test_cross_framework.py) that is itself
trajectory-checked against the JAX implementation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from benchmarks.torch_baseline import _storage_grid, _torch_cg
from test_cross_framework import _np_cg


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_iter", [10, 40])
def test_torch_cg_matches_numpy_replica(seed, max_iter):
    rng = np.random.default_rng(seed)
    n = 30
    R = rng.standard_normal((n, n))
    A = R @ R.T + 1e-2 * np.eye(n)
    b = A @ rng.standard_normal(n)
    x0 = rng.standard_normal(n) * 0.1

    x_np, stored_np, m_np, it_np = _np_cg(
        lambda v: A @ v, b, x0, max_iter
    )

    At = torch.tensor(A, dtype=torch.float64)
    bt = torch.tensor(b, dtype=torch.float64)
    x0t = torch.tensor(x0, dtype=torch.float64)
    x_t, stored_t, m_t, it_t = _torch_cg(
        lambda v: At @ v, bt, x0t, max_iter
    )

    assert it_t == it_np
    # numpy vs torch BLAS differ in summation order; on an ill-conditioned
    # system CG amplifies the last-bit noise over iterations (measured
    # ~4e-5 max drift by iteration 21 at cond ~1e4), so iterates are
    # checked to 5e-4 and the quadratic-model values to 1e-6 relative,
    # while every DISCRETE decision (iteration count, storage grid,
    # termination) must match exactly.
    np.testing.assert_allclose(x_t.numpy(), x_np, rtol=1e-3, atol=5e-4)
    assert set(stored_t) == set(stored_np)
    for k in stored_np:
        np.testing.assert_allclose(
            stored_t[k].numpy(), stored_np[k], rtol=1e-3, atol=5e-4
        )
    np.testing.assert_allclose(
        [float(m) for m in m_t], m_np, rtol=1e-6, atol=1e-8
    )


def test_storage_grid_matches_reference_rule():
    """grid = {ceil(1.3^j) - 1} (reference cg.py:152-170)."""
    grid = _storage_grid(50)
    expected = set()
    j = 0
    while True:
        g = int(np.ceil(1.3**j) - 1)
        if g > 50:
            break
        expected.add(g)
        j += 1
    expected.add(0)
    assert grid == expected
    assert 0 in grid and max(grid) <= 50


def test_reference_hf_step_smoke():
    """One full reference-semantics step on a tiny model: finite results,
    damping moves by one of the three LM factors, warm start decays."""
    from benchmarks.torch_baseline import reference_hf_step

    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Linear(6, 8), torch.nn.Tanh(), torch.nn.Linear(8, 4)
    ).eval()
    x = torch.randn(12, 6)
    y = torch.randint(0, 4, (12,))
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    n = sum(p.numel() for p in params.values())

    new_params, new_x0, new_damping, iters = reference_hf_step(
        model, x, y, params, torch.zeros(n), 1.0, cg_max_iter=10
    )
    assert 1 <= iters <= 10
    assert all(torch.isfinite(v).all() for v in new_params.values())
    assert float(new_damping) in (1.5, 2 / 3, 1.0)
    assert torch.isfinite(new_x0).all()


def test_reference_hf_step_with_regularizer():
    """L2-regularized full step (the All-CNN-C flagship configuration):
    the reg enters loss/gradient/trials; step stays finite; the baseline
    AllCNNC has the paper layer count and CIFAR-100 head."""
    from benchmarks.torch_baseline import (
        AllCNNC,
        allcnnc_l2,
        reference_hf_step,
    )

    model = AllCNNC(num_classes=100).eval()
    convs = [m for m in model.features if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 9
    assert convs[-1].out_channels == 100

    torch.manual_seed(0)
    x = torch.randn(4, 3, 32, 32)
    y = torch.randint(0, 100, (4,))
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    n = sum(p.numel() for p in params.values())
    new_params, new_x0, new_damping, iters = reference_hf_step(
        model, x, y, params, torch.zeros(n), 1.0, cg_max_iter=3,
        reg=allcnnc_l2,
    )
    assert 1 <= iters <= 3
    assert all(torch.isfinite(v).all() for v in new_params.values())
    assert float(allcnnc_l2(params)) > 0.0
