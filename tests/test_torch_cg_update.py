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



def _kernel_elements(geo, n, width):
    """The elements the kernel's loops visit, in the order of
    ``csrc/fused_cg_update.cu``: per thread, whole rounds of ``UNROLL``
    vectors a grid stride apart, the remaining vectors one at a time, then
    the scalar head and tail."""
    from pytorchhessianfree_tpu_torch.ops.cg_update import THREADS, UNROLL

    stride = geo.grid * THREADS
    tail = geo.head + width * geo.nvec
    seen = []
    for tid in range(stride):
        i = tid
        while i + (UNROLL - 1) * stride < geo.nvec:
            for j in range(i, i + UNROLL * stride, stride):
                seen += range(geo.head + width * j, geo.head + width * (j + 1))
            i += UNROLL * stride
        for j in range(i, geo.nvec, stride):
            seen += range(geo.head + width * j, geo.head + width * (j + 1))
        for j in range(tid, geo.head + (n - tail), stride):
            seen.append(j if j < geo.head else tail + (j - geo.head))
    return seen


_SIZES = [0, 1, 3, 4, 5, 7, 1000, 4097, 1_000_003, 1_387_520, 107_717_632]


@pytest.mark.parametrize("itemsize, misalign", [
    (4, 0), (4, 4), (4, 8), (4, 12), (4, None),
    (8, 0), (8, 8), (8, None),
])
def test_launch_geometry_splits_n_once(itemsize, misalign):
    from pytorchhessianfree_tpu_torch.ops.cg_update import (
        THREADS, UNROLL, VEC_BYTES, launch_geometry)

    width = VEC_BYTES // itemsize
    sm_count, per_sm = 132, 2
    for n in _SIZES:
        geo = launch_geometry(n, itemsize, sm_count, per_sm, misalign)
        # a pure function of its arguments
        assert geo == launch_geometry(n, itemsize, sm_count, per_sm, misalign)
        tail = geo.head + width * geo.nvec
        # [0, head) + nvec vectors + [tail, n) is [0, n), once
        assert 0 <= geo.head <= tail <= n and geo.nvec >= 0
        if misalign is None:
            assert (geo.head, geo.nvec) == (n, 0)
        else:
            # the vectors start on a 16-byte boundary; head and tail are
            # shorter than a vector
            assert (misalign + itemsize * geo.head) % VEC_BYTES == 0 or (
                geo.nvec == 0 and geo.head == n)
            assert geo.head < width and n - tail < width
        # one wave at most, and no idle block
        assert 1 <= geo.grid <= sm_count * per_sm
        assert geo.grid == 1 or (
            (geo.grid - 1) * THREADS < geo.nvec
            or (geo.grid - 1) * THREADS < n - width * geo.nvec)
        if misalign == 0 and n >= sm_count * per_sm * THREADS * UNROLL * width:
            assert geo.grid == sm_count * per_sm
        if n <= 5000:
            seen = _kernel_elements(geo, n, width)
            assert sorted(seen) == list(range(n))


def test_launch_geometry_follows_the_card():
    from pytorchhessianfree_tpu_torch.ops.cg_update import launch_geometry

    n = 11_175_936
    assert launch_geometry(n, 4, 132, 2).grid == 264
    assert launch_geometry(n, 4, 132, 3).grid == 396
    assert launch_geometry(n, 4, 114, 2).grid == 228
    # a small n launches only the blocks it fills, one vector per thread
    assert launch_geometry(256, 4, 132, 2).grid == 1
    assert launch_geometry(4096 * 3, 4, 132, 2) == (12, 0, 3072)
    assert launch_geometry(4096 * 3 + 2, 4, 132, 2, 8) == (12, 2, 3072)
    # past one block per SM, a round of 4 vectors per thread
    assert launch_geometry(1_387_520, 4, 132, 4).grid == 339
