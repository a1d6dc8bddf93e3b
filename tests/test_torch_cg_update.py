"""``fused_cg_update``: the plain version against the JAX package's CG
update expressions (ops/cg.py:324-336), and the wrapper's checks.  The CUDA
kernel's own tests are in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from pytorchhessianfree_tpu_torch.ops.cg_update import (  # noqa: E402
    fused_cg_update,
    fused_cg_update_reference,
)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n) for _ in range(5)] + [rng.uniform(0.1, 2)]


@pytest.mark.parametrize("n", [1, 1000, 1_000_003])
def test_reference_matches_jax_expressions(n):
    x, r, p, ap, b, alpha = _inputs(n, seed=n % 97)
    # the JAX package's CG update (ops/cg.py:324-336)
    jx, jr, jp, jap, jb = map(jnp.asarray, (x, r, p, ap, b))
    x_new = jx + alpha * jp
    r_new = jr + alpha * jap
    m = 0.5 * jnp.vdot(r_new - jb, x_new)
    rr = jnp.vdot(r_new, r_new)

    t = [torch.tensor(v) for v in (x, r, p, ap, b)]
    out = fused_cg_update(*t, torch.tensor(alpha, dtype=torch.float64))
    for got, want in zip(out, (x_new, r_new, m, rr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                                   rtol=0 if got.ndim else 1e-13)


def test_cpu_path_is_the_reference_and_counts_no_launch():
    x, r, p, ap, b, alpha = _inputs(17, seed=0)
    t = [torch.tensor(v) for v in (x, r, p, ap, b)]
    a = torch.tensor(alpha, dtype=torch.float64)
    before = fused_cg_update.launches
    out = fused_cg_update(*t, a)
    ref = fused_cg_update_reference(*t, a)
    assert fused_cg_update.launches == before
    for got, want in zip(out, ref):
        assert torch.equal(got, want)
    # inputs are not written
    np.testing.assert_array_equal(t[0].numpy(), x)


def _tensors(n=1_000_003, dtype=torch.float64):
    x, r, p, ap, b, alpha = _inputs(n, seed=1)
    return [torch.tensor(v, dtype=dtype) for v in (x, r, p, ap, b)] + [
        torch.tensor(alpha, dtype=dtype)
    ]


def test_rejects_mixed_devices():
    args = _tensors()
    args[3] = torch.empty(args[3].shape, dtype=args[3].dtype, device="meta")
    with pytest.raises(ValueError, match="one device"):
        fused_cg_update(*args)
    args = _tensors()
    args[5] = torch.empty((), dtype=args[5].dtype, device="meta")
    with pytest.raises(ValueError, match="one device"):
        fused_cg_update(*args)


def test_rejects_unsupported_device():
    args = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in _tensors()]
    with pytest.raises(ValueError, match="no implementation"):
        fused_cg_update(*args)


def test_rejects_ragged_shape_mismatch():
    args = _tensors()
    args[4] = args[4][:-1].contiguous()
    with pytest.raises(ValueError, match="one length"):
        fused_cg_update(*args)
    args = _tensors()
    args[0] = args[0].reshape(1, -1)
    with pytest.raises(ValueError, match="one length"):
        fused_cg_update(*args)


def test_rejects_dtypes():
    args = _tensors()
    args[2] = args[2].float()
    with pytest.raises(ValueError, match="float32 or all float64"):
        fused_cg_update(*args)
    args = [t.to(torch.float16) for t in _tensors(n=8)]
    with pytest.raises(ValueError, match="float32 or all float64"):
        fused_cg_update(*args)


def test_rejects_non_contiguous_and_bad_alpha():
    args = _tensors(n=1000)
    args[1] = torch.zeros(2000, dtype=torch.float64)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_cg_update(*args)
    args = _tensors(n=1000)
    args[5] = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="one value"):
        fused_cg_update(*args)

