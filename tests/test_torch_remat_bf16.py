"""``remat`` and ``curvature_dtype`` in the port.

- :func:`~pytorchhessianfree_tpu_torch.utils.remat.checkpoint` gives the
  plain function's values and derivatives under every transform the
  optimizer uses, saves only its inputs, and recomputes, also inside the
  forward-mode one-shot products, where it cuts their peak memory (CPU
  profiler) below half of the plain function's;
- ``HFConfig(remat=True)`` and the models' ``remat=True`` give the same
  step as without (rtol 1e-12, f64; norm-wise 1e-10 for the Hessian; the
  analog of tests/test_optimizer.py::test_remat_identical_trajectory), and
  the port's remat step matches the JAX package's;
- ``curvature_dtype="bfloat16"``: the matvec has cosine > 0.99 with the f32
  matvec for the GGN and the Hessian while the loss and the gradient stay
  those of f32 (the analog of tests/test_interop.py:50-111), and a bf16
  step trains, with every cast where JAX casts (the comparison with the
  JAX package's bf16 numbers is in tests/test_torch_bf16_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu.models import mlp as jmlp  # noqa: E402
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.models import moe as tm  # noqa: E402
from pytorchhessianfree_tpu_torch.models import transformer as tt  # noqa: E402
from pytorchhessianfree_tpu_torch.models.mlp import (  # noqa: E402
    init_mlp,
    mlp_apply,
    mse_loss,
)
from pytorchhessianfree_tpu_torch.ops.curvature import (  # noqa: E402
    ggnvp,
    hvp,
    value_and_grad,
)
from pytorchhessianfree_tpu_torch.optimizer import (  # noqa: E402
    _build_matvec_and_grad,
    _cast_floating,
)
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten  # noqa: E402
from pytorchhessianfree_tpu_torch.utils.remat import checkpoint  # noqa: E402

from test_torch_optimizer import assert_same_step, assert_vec_close  # noqa: E402

VOCAB, T, HEADS = 16, 8, 4


def _lm(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = tt.init_decoder_lm(gen, vocab=VOCAB, d_model=16, n_heads=HEADS,
                                n_layers=2, d_ff=32, max_len=T, dtype=dtype)
    start = torch.randint(0, VOCAB, (4,), generator=gen)
    toks = [start]
    for _ in range(T - 1):
        toks.append((5 * toks[-1] + 3) % VOCAB)
    tokens = torch.stack(toks, dim=1)
    return params, (tokens, tokens)


def _lm_fns(**kwargs):
    return thf.HFModelFns(
        model_fn=lambda p, x: tt.decoder_lm_apply(p, x, n_heads=HEADS,
                                                  **kwargs),
        loss_outer=tt.next_token_loss,
    )


def _tanh_chain(p, x):
    for w in p:
        x = torch.tanh(x @ w)
    return x


def _chain_problem():
    gen = torch.Generator().manual_seed(1)
    p = [torch.randn(6, 6, generator=gen, dtype=torch.float64) / 2.45
         for _ in range(4)]
    x = torch.randn(5, 6, generator=gen, dtype=torch.float64)
    v = [torch.randn(6, 6, generator=gen, dtype=torch.float64)
         for _ in range(4)]
    return p, x, v


def _flat(tree):
    return torch.cat([t.reshape(-1) for t in tree_flatten(tree)[0]])


def test_checkpoint_matches_plain_under_every_transform():
    p, x, v = _chain_problem()
    plain = _tanh_chain
    remat = checkpoint(_tanh_chain)

    def loss(fn):
        return lambda q: torch.sum(torch.sin(fn(q, x)))

    def transforms(fn):
        out = [fn(p, x)]
        out.append(torch.func.jvp(lambda q: fn(q, x), (p,), (v,))[1])
        out.append(torch.func.vjp(lambda q: fn(q, x), p)[1](out[0])[0])
        out.append(torch.func.grad(loss(fn))(p))
        out.append(ggnvp(lambda q: fn(q, x), lambda o: torch.sum(o**4), p,
                         v))
        out.append(hvp(loss(fn), p, v))
        out.append(thf.hvp_fn(loss(fn), p)[2](v))  # linearize
        out.append(thf.ggnvp_fn(lambda q: fn(q, x),
                                lambda o: torch.sum(o**4), p)[3](v))
        # per-sample gradients, as diag_EF takes them
        out.append(torch.func.vmap(
            lambda xi: torch.func.grad(
                lambda q: torch.sum(fn(q, xi[None])))(p))(x))
        return [_flat(o) for o in out]

    for a, b in zip(transforms(plain), transforms(remat)):
        torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-14)


def test_checkpoint_saves_only_inputs_and_recomputes():
    p, x, _ = _chain_problem()
    calls = []

    def counted(q, xx):
        calls.append(1)
        return _tanh_chain(q, xx)

    def saved_numel(fn):
        total = []

        def pack(t):
            total.append(t.numel())
            return t

        q = [w.clone().requires_grad_() for w in p]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn(q, x)
        torch.sum(out).backward()
        return sum(total)

    plain = saved_numel(_tanh_chain)
    remat = saved_numel(checkpoint(counted))
    # the inputs only: 4 weights of 36 and x of 30
    assert remat == 4 * 36 + 30 < plain
    assert len(calls) == 2  # the forward, and again in the backward


def _layer(w, h):
    h = torch.tanh(h @ w)
    h = h * torch.sigmoid(h)
    return torch.sin(h)


def _cpu_peak_bytes(fn):
    """Peak of the bytes allocated on the CPU while ``fn`` runs, from the
    profiler's per-op allocations and frees in time order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as p:
        fn()
    events = sorted((e for e in p.events() if e.self_cpu_memory_usage),
                    key=lambda e: e.time_range.start)
    live = peak = 0
    for e in events:
        live += e.self_cpu_memory_usage
        peak = max(peak, live)
    return peak


@pytest.mark.parametrize("nested", [False, True])
@pytest.mark.parametrize("product", ["gradient", "jvp", "ggnvp", "hvp"])
def test_checkpoint_recomputes_and_cuts_memory_in_one_shot_products(
    product, nested
):
    """Each of 16 layers checkpointed (and, nested, the whole model too, as
    ``HFConfig(remat=True)`` over a model's ``remat=True``): the
    forward-mode products run the ``jvp`` rule (the layer runs again), and
    the reverse-mode ones hold one layer input per layer in place of its
    activations."""
    gen = torch.Generator().manual_seed(5)
    ws = [torch.randn(64, 64, generator=gen) / 8 for _ in range(16)]
    vs = [torch.randn(64, 64, generator=gen) for _ in range(16)]
    x = torch.randn(256, 64, generator=gen)
    calls = []

    def counted(w, h):
        calls.append(1)
        return _layer(w, h)

    def run(remat):
        layer = checkpoint(counted) if remat else counted

        def model(q):
            h = x
            for w in q:
                h = layer(w, h)
            return h

        if remat and nested:
            model = checkpoint(model)

        def loss(q):
            return torch.sum(model(q) ** 2)

        return {
            "gradient": lambda: value_and_grad(loss, ws),
            "jvp": lambda: torch.func.jvp(model, (ws,), (vs,)),
            "ggnvp": lambda: ggnvp(model, lambda o: torch.sum(o**2), ws, vs),
            "hvp": lambda: hvp(loss, ws, vs),
        }[product]

    counts, peaks, outs = [], [], []
    for remat in (False, True):
        calls.clear()
        outs.append(_flat(run(remat)()))
        counts.append(len(calls))
        peaks.append(_cpu_peak_bytes(run(remat)))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    assert counts[1] > counts[0]
    if product != "jvp":  # forward mode stores no activations either way
        assert peaks[1] < 0.5 * peaks[0], peaks


@pytest.mark.parametrize("curvature_opt", ["ggn", "hessian"])
def test_config_remat_gives_the_same_trajectory(curvature_opt):
    params, batch = _lm(torch.float64)
    ravel = thf.TrainableRavel(params)
    out = []
    for fns, remat in ((_lm_fns(), False), (_lm_fns(), True),
                       (_lm_fns(remat=True, attn_chunk=4), False)):
        cfg = thf.HFConfig(damping=1.0, cg_max_iter=8, remat=remat,
                           curvature_opt=curvature_opt)
        p, s = params, thf.init_state(ravel, cfg)
        p, s, st = thf.hf_step(p, s, batch, fns=fns, config=cfg,
                               ravel=ravel)
        out.append((ravel.ravel(p), st.num_cg_iters))
    (base, base_iters), *others = out
    for vec, iters in others:
        assert iters == base_iters
        if curvature_opt == "ggn":
            torch.testing.assert_close(vec, base, rtol=1e-12, atol=1e-12)
        else:
            # the one-shot jvp of the gradient and the linearized one sum in
            # other orders; CG carries that rounding into the step, so
            # entries near zero differ by ~1e-11 (2e-12 norm-wise)
            assert_vec_close(vec.numpy(), base.numpy(), 1e-10)


def test_config_remat_acc_step_gives_the_same_result():
    params, (x, y) = _lm(torch.float64)
    ravel = thf.TrainableRavel(params)
    data = [(x[:2], y[:2]), (x[2:], y[2:])]
    out = []
    for remat in (False, True):
        cfg = thf.HFConfig(damping=1.0, cg_max_iter=8, remat=remat)
        p, _, st = thf.hf_acc_step(params, thf.init_state(ravel, cfg),
                                   fns=_lm_fns(), config=cfg, ravel=ravel,
                                   loss_data=data)
        out.append((ravel.ravel(p), st.num_cg_iters))
    assert out[0][1] == out[1][1]
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-12, atol=1e-12)


def test_remat_step_matches_jax():
    jparams = jmlp.init_mlp(jax.random.PRNGKey(0), dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((12, 7)), rng.standard_normal((12, 3))
    kw = dict(damping=0.5, cg_max_iter=10, remat=True)
    j_opt = jhf.HessianFree(jparams, model_fn=jmlp.mlp_apply,
                            loss_outer=jmlp.mse_loss, **kw)
    t_opt = thf.HessianFree(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                        device="cpu"),
        model_fn=mlp_apply, loss_outer=mse_loss, **kw)
    for _ in range(2):
        j_opt.step((jnp.asarray(x), jnp.asarray(y)))
        t_opt.step((torch.tensor(x), torch.tensor(y)))
    assert_same_step(t_opt, j_opt, 1e-8)


def test_moe_remat_matvec_matches_plain():
    gen = torch.Generator().manual_seed(2)
    params = tm.init_moe_decoder_lm(gen, vocab=VOCAB, d_model=16,
                                    n_layers=2, d_ff=32, max_len=T,
                                    dtype=torch.float64)
    tokens = torch.randint(0, VOCAB, (3, T), generator=gen)
    ravel = thf.TrainableRavel(params)
    v = torch.randn(ravel.dim, generator=gen, dtype=torch.float64)
    mvps = []
    for remat in (False, True):
        fns = thf.HFModelFns(
            model_fn=lambda p, t, r=remat: tm.moe_decoder_lm_apply(
                p, t, remat=r, attn_chunk=4),
            loss_outer=tt.next_token_loss,
        )
        mvps.append(_build_matvec_and_grad(
            fns, thf.HFConfig(remat=remat), ravel, params, (tokens, tokens)
        )[2](v))
    torch.testing.assert_close(mvps[1], mvps[0], rtol=1e-12, atol=1e-13)


def _mlp_problem():
    gen = torch.Generator().manual_seed(3)
    params = init_mlp(gen, (7, 5, 5, 3), dtype=torch.float32)
    x = torch.randn(8, 7, generator=gen)
    y = torch.randn(8, 3, generator=gen)
    return params, (x, y), thf.HFModelFns(model_fn=mlp_apply,
                                          loss_outer=mse_loss)


def _cosine(a, b):
    return float(a @ b / (torch.linalg.vector_norm(a)
                          * torch.linalg.vector_norm(b)))


@pytest.mark.parametrize("model", ["mlp", "decoder_lm"])
@pytest.mark.parametrize("curvature_opt", ["ggn", "hessian"])
@pytest.mark.parametrize("remat", [False, True])
def test_bf16_matvec_approximates_f32(model, curvature_opt, remat):
    if model == "mlp":
        params, batch, fns = _mlp_problem()
    else:
        (params, batch), fns = _lm(torch.float32), _lm_fns()
    ravel = thf.TrainableRavel(params)
    cfg32 = thf.HFConfig(curvature_opt=curvature_opt, remat=remat)
    cfgbf = thf.HFConfig(curvature_opt=curvature_opt, remat=remat,
                         curvature_dtype="bfloat16")
    loss32, grad32, mvp32 = _build_matvec_and_grad(fns, cfg32, ravel,
                                                   params, batch)
    lossbf, gradbf, mvpbf = _build_matvec_and_grad(fns, cfgbf, ravel,
                                                   params, batch)
    # loss and gradient are full precision in both configs
    torch.testing.assert_close(lossbf, loss32, rtol=1e-6, atol=0)
    torch.testing.assert_close(gradbf, grad32, rtol=1e-6, atol=1e-7)
    v = torch.randn(ravel.dim, generator=torch.Generator().manual_seed(4))
    a, b = mvp32(v), mvpbf(v)
    assert b.dtype == torch.float32  # the CG vector space stays f32
    # bf16 keeps ~3 decimal digits; the direction must agree strongly, and
    # differ by more than f32 rounding does (a cast happened)
    assert 1e-7 < 1 - _cosine(a, b) and _cosine(a, b) > 0.99
    assert torch.linalg.vector_norm(b - a) > 1e-3 * torch.linalg.vector_norm(a)


@pytest.mark.parametrize("curvature_opt", ["ggn", "hessian"])
def test_bf16_casts_where_jax_casts(curvature_opt):
    """Parameters and floating inputs reach the model in bf16, tokens stay
    integers, the loss sees the outputs back in f32 (GGN), the Hessian
    path's loss is cast back, and the product is raveled in f32."""
    (params, batch), seen = _lm(torch.float32), []

    def model_fn(p, x):
        seen.append(("model", tree_flatten(p)[0][0].dtype, x.dtype))
        return tt.decoder_lm_apply(p, x, n_heads=HEADS)

    def loss_outer(out, y):
        seen.append(("loss", out.dtype, y.dtype))
        return tt.next_token_loss(out, y)

    fns = thf.HFModelFns(model_fn=model_fn, loss_outer=loss_outer)
    ravel = thf.TrainableRavel(params)
    cfg = thf.HFConfig(curvature_opt=curvature_opt,
                       curvature_dtype="bfloat16")
    # the build runs the model (a linearized matvec replays it); the
    # matvec runs the GGN path's loss gradient
    mvp = _build_matvec_and_grad(fns, cfg, ravel, params, batch)[2]
    assert mvp(torch.ones(ravel.dim)).dtype == torch.float32
    assert ("model", torch.bfloat16, torch.int64) in seen
    losses = {entry for entry in seen if entry[0] == "loss"}
    if curvature_opt == "ggn":  # the loss Hessian stays f32
        assert losses == {("loss", torch.float32, torch.int64)}
    else:  # the gradient's f32 loss, and the matvec's bf16 loss
        assert losses == {("loss", torch.float32, torch.int64),
                          ("loss", torch.bfloat16, torch.int64)}


def test_bf16_step_trains_like_f32():
    params, batch = _lm(torch.float32)
    final = []
    for cdtype in (None, "bfloat16"):
        opt = thf.HessianFree(params, model_fn=_lm_fns().model_fn,
                              loss_outer=tt.next_token_loss, damping=1.0,
                              cg_max_iter=20, curvature_dtype=cdtype)
        for _ in range(2):
            opt.step(batch)
        final.append(opt.history["final_losses"][-1])
        assert opt.history["final_losses"][-1] < opt.history["init_losses"][0]
        assert opt.state.x0.dtype == torch.float32
    # bf16 matvecs perturb the CG trajectory, but the step must still reach
    # a comparable loss (the JAX package's bound, tests/test_interop.py)
    np.testing.assert_allclose(final[1], final[0], rtol=0.25)


def test_cast_keeps_integer_leaves():
    tree = {"tokens": torch.arange(4), "x": torch.ones(2), "n": 3}
    out = _cast_floating(tree, torch.bfloat16)
    assert out["tokens"].dtype == torch.int64
    assert out["x"].dtype == torch.bfloat16 and out["n"] == 3


def test_unknown_curvature_dtype_raises():
    params, batch, fns = _mlp_problem()
    with pytest.raises(ValueError, match="curvature_dtype"):
        _build_matvec_and_grad(fns, thf.HFConfig(curvature_dtype="int8"),
                               thf.TrainableRavel(params), params, batch)
