"""The randomized Nystrom preconditioner against the JAX package's, on the
same probes, and the port's counterparts of ``tests/test_nystrom.py``:
exact spectra at full rank, the low-rank case, the PSD lower bound, the CG
iteration collapse, and the wrapper's ``get_nystrom_sketch`` /
``step(precond_lowrank=...)`` against JAX's.

Singular vectors may differ from JAX's in sign, so the comparisons are of
``eigs``, ``U diag(eigs) U^T v`` and ``P^{-1} v``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.models import mse_loss  # noqa: E402
from test_torch_optimizer import (  # noqa: E402
    _j_mlp,
    _j_mse,
    _mlp_problem,
    _t_mlp,
    assert_same_step,
)

F64 = torch.float64


def _spd_decaying(dim, seed=0, decay=0.5, tail=1e-6):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    evals = np.maximum(decay ** np.arange(dim), tail)
    return (Q * evals) @ Q.T, np.sort(evals)[::-1]


def _probes(r, n, seed=0):
    """Unit Rademacher rows from numpy, fed to both packages."""
    rng = np.random.default_rng(1000 + seed)
    return rng.choice([-1.0, 1.0], size=(r, n)) / np.sqrt(n)


def _both_sketches(A, probes):
    js = jhf.nystrom_sketch(lambda v: jnp.asarray(A) @ v, jnp.asarray(probes))
    tA = torch.tensor(A)
    ts = thf.nystrom_sketch(lambda v: tA @ v, torch.tensor(probes))
    return js, ts


def _lowrank_apply(sk, v):
    U, eigs = (np.asarray(sk.U), np.asarray(sk.eigs))
    return U @ (eigs * (U.T @ v))


@pytest.mark.parametrize(
    "dim,r,seed,decay",
    [(16, 16, 1, 0.7), (24, 6, 5, 0.5), (40, 10, 9, 0.75), (30, 8, 3, 0.9)],
)
def test_sketch_and_preconditioner_match_jax(dim, r, seed, decay):
    A, _ = _spd_decaying(dim, seed=seed, decay=decay)
    js, ts = _both_sketches(A, _probes(r, dim, seed))
    assert ts.rank == js.rank == r and tuple(ts.U.shape) == (dim, r)
    np.testing.assert_allclose(ts.eigs.numpy(), np.asarray(js.eigs),
                               rtol=1e-10, atol=1e-14)
    rng = np.random.default_rng(seed)
    for mu in (1e-3, 0.5):
        v = rng.standard_normal(dim)
        np.testing.assert_allclose(_lowrank_apply(ts, v),
                                   _lowrank_apply(js, v), rtol=1e-10,
                                   atol=1e-14)
        jM = jhf.nystrom_to_preconditioner(js, mu)
        tM = thf.nystrom_to_preconditioner(ts, mu)
        np.testing.assert_allclose(tM(torch.tensor(v)).numpy(),
                                   np.asarray(jM(jnp.asarray(v))),
                                   rtol=1e-10)


def test_full_rank_sketch_recovers_exact_spectrum():
    dim = 16
    A, evals = _spd_decaying(dim, seed=1, decay=0.7, tail=1e-8)
    _, sk = _both_sketches(A, _probes(dim, dim, 1))
    np.testing.assert_allclose(sk.eigs.numpy(), evals, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose((sk.U.T @ sk.U).numpy(), np.eye(dim),
                               atol=1e-10)
    A_hat = (sk.U * sk.eigs) @ sk.U.T
    np.testing.assert_allclose(A_hat.numpy(), A, atol=1e-9)


def test_exact_for_lowrank_operator():
    """rank(A) = 5 < r = 8: the sketch is the eigendecomposition."""
    dim, true_rank, r = 30, 5, 8
    rng = np.random.default_rng(3)
    B = rng.standard_normal((dim, true_rank))
    A = B @ B.T
    _, sk = _both_sketches(A, _probes(r, dim, 3))
    evals = np.linalg.eigvalsh(A)[::-1]
    np.testing.assert_allclose(sk.eigs[:true_rank].numpy(), evals[:true_rank],
                               rtol=1e-8)
    np.testing.assert_allclose(sk.eigs[true_rank:].numpy(), 0.0,
                               atol=1e-7 * evals[0])
    A_hat = (sk.U * sk.eigs) @ sk.U.T
    np.testing.assert_allclose(A_hat.numpy(), A, atol=1e-7)


def test_sketch_underestimates_psd():
    """v^T A_hat v <= v^T A v: the preconditioner never over-corrects."""
    dim, r = 24, 6
    A, _ = _spd_decaying(dim, seed=5)
    _, sk = _both_sketches(A, _probes(r, dim, 5))
    rng = np.random.default_rng(7)
    for _ in range(5):
        v = rng.standard_normal(dim)
        assert v @ _lowrank_apply(sk, v) <= v @ A @ v + 1e-9


def test_preconditioned_cg_iteration_collapse():
    """Rank-25 Nystrom preconditioning of a geometric-decay system cuts the
    port's CG iterations >= 3x at equal solution quality."""
    dim, r, mu = 120, 25, 1e-3
    A, _ = _spd_decaying(dim, seed=9, decay=0.75, tail=1e-6)
    tA = torch.tensor(A)
    rng = np.random.default_rng(11)
    x_true = torch.tensor(rng.standard_normal(dim))

    def Ad(v):
        return tA @ v + mu * v

    b = Ad(x_true)
    plain = thf.cg(Ad, b, tol=1e-10, max_iter=dim)
    _, sk = _both_sketches(A, _probes(r, dim, 9))
    pre = thf.cg(Ad, b, M=thf.nystrom_to_preconditioner(sk, mu), tol=1e-10,
                 max_iter=dim)
    res_norm = float(torch.linalg.vector_norm(Ad(pre.x) - b))
    assert res_norm <= 1e-9 * float(torch.linalg.vector_norm(b))
    np.testing.assert_allclose(pre.x.numpy(), x_true.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert pre.num_iters * 3 <= plain.num_iters, (pre.num_iters,
                                                  plain.num_iters)


def test_full_rank_preconditioner_is_exact_inverse():
    """r = n: P^{-1}(A + mu I) = (eigs_min + mu) I, so CG converges in one
    iteration (two at most)."""
    dim, mu = 12, 1e-2
    A, _ = _spd_decaying(dim, seed=13, decay=0.6, tail=1e-5)
    _, sk = _both_sketches(A, _probes(dim, dim, 13))
    M = thf.nystrom_to_preconditioner(sk, mu)
    tA = torch.tensor(A)

    def Ad(v):
        return tA @ v + mu * v

    rng = np.random.default_rng(17)
    v = torch.tensor(rng.standard_normal(dim))
    scale = float(sk.eigs[-1] + mu)
    np.testing.assert_allclose(M(Ad(v)).numpy(), scale * v.numpy(),
                               rtol=1e-7)
    b = Ad(torch.tensor(rng.standard_normal(dim)))
    assert thf.cg(Ad, b, M=M, tol=1e-10, max_iter=dim).num_iters <= 2


def test_preconditioner_identity_on_complement_and_spd():
    dim, r, mu = 20, 5, 0.1
    A, _ = _spd_decaying(dim, seed=19)
    _, sk = _both_sketches(A, _probes(r, dim, 19))
    M = thf.nystrom_to_preconditioner(sk, mu)
    rng = np.random.default_rng(23)
    v = torch.tensor(rng.standard_normal(dim))
    v_perp = v - sk.U @ (sk.U.T @ v)
    np.testing.assert_allclose(M(v_perp).numpy(), v_perp.numpy(), atol=1e-10)
    w = torch.tensor(rng.standard_normal(dim))
    assert float(v @ M(v)) > 0
    np.testing.assert_allclose(float(w @ M(v)), float(v @ M(w)), rtol=1e-10)


def test_sketch_validation_errors_match_jax():
    A = np.eye(4)
    for probes in (np.ones(4), np.ones((5, 4))):
        with pytest.raises(ValueError) as j_err:
            jhf.nystrom_sketch(lambda v: jnp.asarray(A) @ v,
                               jnp.asarray(probes))
        with pytest.raises(ValueError) as t_err:
            thf.nystrom_sketch(lambda v: torch.tensor(A) @ v,
                               torch.tensor(probes))
        assert str(t_err.value) == str(j_err.value)


# -- through the optimizer (live damping) ------------------------------------


def _wrappers(seed, **config):
    params, x, y = _mlp_problem(seed)
    j_opt = jhf.HessianFree(jax.tree_util.tree_map(jnp.asarray, params),
                            model_fn=_j_mlp, loss_outer=_j_mse, **config)
    t_opt = thf.HessianFree(params_from_jax(params, device="cpu"),
                            model_fn=_t_mlp, loss_outer=mse_loss, **config)
    return (j_opt, (jnp.asarray(x), jnp.asarray(y)),
            t_opt, (torch.tensor(x), torch.tensor(y)))


def test_wrapper_sketch_and_steps_match_jax():
    """Full rank (rank = the 39 trainable parameters, padded to 1024) makes
    the sketch exact, so neither package's probe draw matters: the sketch
    and two preconditioned steps equal JAX's."""
    j_opt, j_batch, t_opt, t_batch = _wrappers(6, damping=0.5,
                                               cg_max_iter=20)
    n = t_opt.ravel.unpadded_dim
    assert n == 39 and t_opt.ravel.dim == 1024
    js = j_opt.get_nystrom_sketch(j_batch, rank=n)
    ts = t_opt.get_nystrom_sketch(t_batch, rank=n)
    assert tuple(ts.U.shape) == (1024, n)
    np.testing.assert_allclose(ts.eigs.numpy(), np.asarray(js.eigs),
                               rtol=1e-8, atol=1e-12)
    assert float(ts.U[n:].abs().max()) == 0.0  # padding tail untouched
    for _ in range(2):
        j_opt.step(j_batch, precond_lowrank=js)
        t_opt.step(t_batch, precond_lowrank=ts)
    assert_same_step(t_opt, j_opt, 1e-8)


def test_wrapper_step_with_nystrom_preconditioner():
    """step(precond_lowrank=...) equals the step with the M closure built
    at the live damping, and keeps training."""
    params, x, y = _mlp_problem(4)
    batch = (torch.tensor(x), torch.tensor(y))
    kw = dict(model_fn=_t_mlp, loss_outer=mse_loss)
    opt_lr = thf.HessianFree(params_from_jax(params, device="cpu"), **kw)
    opt_m = thf.HessianFree(params_from_jax(params, device="cpu"), **kw)
    sk = opt_lr.get_nystrom_sketch(batch, rank=12)
    assert isinstance(sk, thf.NystromSketch)
    assert tuple(sk.U.shape) == (opt_lr.ravel.dim, 12)
    assert float(sk.eigs[0]) > 0 and float(sk.eigs[-1]) >= 0
    M = thf.nystrom_to_preconditioner(sk, float(opt_m.state.damping))
    loss_lr = opt_lr.step(batch, precond_lowrank=sk)
    loss_m = opt_m.step(batch, M=M)
    np.testing.assert_allclose(loss_lr, loss_m, rtol=1e-12)
    torch.testing.assert_close(opt_lr.ravel.ravel(opt_lr.params),
                               opt_m.ravel.ravel(opt_m.params), rtol=0,
                               atol=1e-12)
    assert opt_lr.step(batch, precond_lowrank=sk) < loss_lr


def test_functional_step_takes_the_sketch_like_jax():
    j_opt, j_batch, t_opt, t_batch = _wrappers(7, damping=0.5,
                                               cg_max_iter=20)
    n = t_opt.ravel.unpadded_dim
    js = j_opt.get_nystrom_sketch(j_batch, rank=n)
    ts = t_opt.get_nystrom_sketch(t_batch, rank=n)
    j_step = jhf.make_hf_step(j_opt.fns, j_opt.config, j_opt.ravel)
    t_step = thf.make_hf_step(t_opt.fns, t_opt.config, t_opt.ravel)
    _, _, jst = j_step(j_opt.params, j_opt.state, j_batch,
                       precond_lowrank=js)
    _, _, tst = t_step(t_opt.params, t_opt.state, t_batch,
                       precond_lowrank=ts)
    assert tst.num_cg_iters == int(jst.num_cg_iters)
    np.testing.assert_allclose(float(tst.final_loss), float(jst.final_loss),
                               rtol=1e-10)
    with pytest.raises(ValueError, match="either precond_diag or"):
        t_step(t_opt.params, t_opt.state, t_batch,
               precond_diag=torch.ones(t_opt.ravel.dim, dtype=F64),
               precond_lowrank=ts)


def test_hessian_sketch_clips_negative():
    _, _, t_opt, t_batch = _wrappers(6)
    sk = t_opt.get_nystrom_sketch(t_batch, rank=8, curvature="hessian")
    assert float(sk.eigs[-1]) >= 0.0


def test_sketch_draws_from_the_given_generator():
    _, _, t_opt, t_batch = _wrappers(8)
    a = t_opt.get_nystrom_sketch(t_batch, rank=6, seed=3)
    b = t_opt.get_nystrom_sketch(
        t_batch, rank=6, generator=torch.Generator().manual_seed(3))
    c = t_opt.get_nystrom_sketch(t_batch, rank=6, seed=4)
    torch.testing.assert_close(a.eigs, b.eigs, rtol=0, atol=0)
    assert not torch.equal(a.eigs, c.eigs)


def test_narrow_resnet_sketch_matches_jax_on_the_same_probes():
    """The sketch vmaps the step's linearized conv-model matvec; on the same
    probes it equals the JAX package's."""
    from pytorchhessianfree_tpu import models as jm
    from pytorchhessianfree_tpu.optimizer import (
        _build_matvec_and_grad as j_build,
    )
    from pytorchhessianfree_tpu_torch import models as tm
    from pytorchhessianfree_tpu_torch.optimizer import (
        _build_matvec_and_grad as t_build,
    )

    jparams = jax.jit(lambda k: jm.init_resnet18(
        k, dtype=jnp.float64, width_scale=1 / 16))(jax.random.PRNGKey(3))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal((4, 28, 28, 1)), rng.integers(0, 10, 4)
    jr = jhf.TrainableRavel(jparams, pad_to_multiple=1024)
    tr = thf.TrainableRavel(tparams, pad_to_multiple=1024)
    probes = np.pad(_probes(8, tr.unpadded_dim, 3),
                    ((0, 0), (0, tr.dim - tr.unpadded_dim)))
    v = rng.standard_normal(tr.dim)

    # one compile of the JAX side: op by op, its linearize and the vmap of
    # the conv matvec take ~5x as long on the CPU
    @jax.jit
    def j_sketch(params, x, y, probes, v):
        j_mvp = j_build(
            jhf.HFModelFns(jm.resnet18_apply, jm.cross_entropy_loss),
            jhf.HFConfig(), jr, params, (x, y))[2]
        js = jhf.nystrom_sketch(j_mvp, probes)
        return js.eigs, jhf.nystrom_to_preconditioner(js, 0.5)(v)

    j_eigs, j_Mv = j_sketch(jparams, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(probes), jnp.asarray(v))
    t_mvp = t_build(thf.HFModelFns(tm.resnet18_apply, tm.cross_entropy_loss),
                    thf.HFConfig(), tr, tparams,
                    (torch.tensor(x), torch.tensor(y)))[2]
    ts = thf.nystrom_sketch(t_mvp, torch.tensor(probes))
    np.testing.assert_allclose(ts.eigs.numpy(), np.asarray(j_eigs),
                               rtol=1e-9)
    tM = thf.nystrom_to_preconditioner(ts, 0.5)
    np.testing.assert_allclose(tM(torch.tensor(v)).numpy(),
                               np.asarray(j_Mv), rtol=1e-9)
