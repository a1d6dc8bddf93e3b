"""Shared parts of the model-axis parity tests (``tests/test_torch_sharded_*``):
the port's sharded steps on gloo ranks (tests/_torch_sharded_worker.py)
against the JAX package's ``make_sharded_hf_*`` on a mesh of the same shape,
taken from the 8 virtual CPU devices, and against the port's one-process
steps, in f64.

Each case of :data:`_torch_sharded_worker.CASES` is tests/test_sharded.py's
test of that name: the same model, draws, configuration, steps and
tolerances (:data:`TOLS`).  :func:`run_all` writes the problems (the JAX
draws as numpy), starts the ranks, runs both references meanwhile and
returns everything; :func:`check` compares one case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as JP

import _torch_dp_worker as dp_worker
import _torch_sharded_worker as worker
import pytorchhessianfree_tpu as jhf
import pytorchhessianfree_tpu_torch as thf
from pytorchhessianfree_tpu.models import (
    cross_entropy_loss as j_xent,
    decoder_lm_apply as j_decoder,
    init_decoder_lm as j_init_decoder,
    init_transformer as j_init_transformer,
    next_token_loss as j_next_token,
    transformer_apply as j_transformer,
)
from pytorchhessianfree_tpu.models.mlp import (
    init_mlp as j_init_mlp,
    mlp_apply as j_mlp,
    mse_loss as j_mse,
)
from pytorchhessianfree_tpu.models.moe import (
    init_moe_decoder_lm as j_init_moe,
    moe_decoder_lm_apply as j_moe,
)
from pytorchhessianfree_tpu.parallel import sharded as jsh
from pytorchhessianfree_tpu.parallel.mesh import make_mesh as j_make_mesh
from pytorchhessianfree_tpu_torch.convert import params_from_jax
from pytorchhessianfree_tpu_torch.parallel.mesh import PartitionSpec

F64 = jnp.float64
# case -> parameter atol per recorded step: tests/test_sharded.py's, but
# for "tp", whose trajectory is chaotic: a 1e-15 perturbation of the start
# moves the one-process port's parameters by 6.7e-7 after step 1 and 2.6e-6
# after step 2 (f64, this host), so no other summation order can meet that
# test's 1e-7 after step 1 (JAX's own sharded step lies 1.0e-6 from the
# port's one-process step there)
TOLS = {
    "ggn": (1e-8,) * 3, "hessian": (1e-8,) * 3, "precond": (1e-8,),
    "model_only": (1e-8,), "rich": (1e-6,), "acc": (1e-8,),
    "loop": (1e-8,), "loop_ema": (1e-8,), "tp": (2e-6, 1e-5),
    "cp": (1e-8, 1e-6), "cp2d": (1e-8,), "acc_cp": (1e-8,),
    "loop_cp": (1e-7,), "ep": (1e-8, 1e-6), "wrap": (1e-8, 1e-8),
    "wrap_cp": (1e-7, 1e-7), "wrap_tp": (2e-6, 1e-5),
}


def _mlp_draw(seed, N=32):
    """tests/test_sharded.py's ``_problem``."""
    kp, kx, ky = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (j_init_mlp(kp, sizes=worker.SIZES, dtype=F64),
            jax.random.normal(kx, (N, worker.SIZES[0]), F64),
            jax.random.normal(ky, (N, worker.SIZES[-1]), F64))


def _tokens(seed, shape=(4, 8)):
    t = jax.random.randint(jax.random.PRNGKey(seed), shape, 0, 12)
    return t, t


def _enc_batch(seed):
    k = jax.random.PRNGKey(seed)
    return (jax.random.randint(k, (16, 8), 0, 12),
            jax.random.randint(jax.random.fold_in(k, 1), (16,), 0, 4))


def _lm(key, layers):
    return dict(key=jax.random.PRNGKey(key), vocab=12, d_model=16,
                n_layers=layers, d_ff=32, max_len=8, dtype=F64)


def draw(case):
    """``(params, [batches])`` of a case, as tests/test_sharded.py draws
    them."""
    mlp = {"ggn": (0, range(1, 4)), "hessian": (0, range(1, 4)),
           "loop": (16, range(30, 33)), "loop_ema": (50, range(51, 54)),
           "wrap": (40, range(41, 43))}
    if case in mlp:
        seed, seeds = mlp[case]
        return _mlp_draw(seed)[0], [_mlp_draw(s)[1:] for s in seeds]
    if case in ("precond", "model_only", "rich"):
        params, x, y = _mlp_draw({"precond": 8, "model_only": 6,
                                  "rich": 14}[case])
        return params, [(x, y)]
    if case == "acc":
        params, x, y = _mlp_draw(18)
        return params, [(x[:16], y[:16]), (x[16:], y[16:])]
    if case in ("tp", "wrap_tp"):
        params = j_init_transformer(num_classes=4, **_lm(0, 2))
        return params, [_enc_batch(60 + i) for i in range(2)]
    if case == "cp":
        return j_init_decoder(**_lm(0, 2)), [_tokens(70 + i)
                                             for i in range(2)]
    if case == "cp2d":
        return j_init_decoder(**_lm(1, 2)), [_tokens(75)]
    if case == "acc_cp":
        return j_init_decoder(**_lm(8, 1)), [_tokens(95 + i)
                                             for i in range(2)]
    if case == "loop_cp":
        return j_init_decoder(**_lm(3, 1)), [_tokens(80 + i)
                                             for i in range(2)]
    if case == "wrap_cp":
        return j_init_decoder(**_lm(6, 2)), [_tokens(91 + i)
                                             for i in range(2)]
    if case == "ep":
        return (j_init_moe(n_experts=4, **_lm(4, 2)),
                [_tokens(200 + i) for i in range(2)])
    raise ValueError(case)


def write_problem(path, cases):
    arrays = {}
    for case in cases:
        if case not in worker.CASES:
            continue
        params, batches = draw(case)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
            arrays[f"{case}/p{i}"] = np.asarray(leaf)
        for i, (x, y) in enumerate(batches):
            arrays[f"{case}/x{i}"] = np.asarray(x)
            arrays[f"{case}/y{i}"] = np.asarray(y)
    np.savez(path, **arrays)


def to_jax_specs(tree):
    """The port's spec tree -> the JAX package's (by field)."""
    if tree is None:
        return None
    if isinstance(tree, PartitionSpec):
        return JP(*tree)
    if isinstance(tree, dict):
        return {k: to_jax_specs(v) for k, v in tree.items()}
    return [to_jax_specs(v) for v in tree]


def j_model(kind):
    """The JAX fns and config of a worker model kind."""
    _, _, config = worker.model(kind)
    if kind == "mlp":
        fns = jhf.HFModelFns(model_fn=j_mlp, loss_outer=j_mse)
    elif kind == "enc":
        fns = jhf.HFModelFns(
            model_fn=lambda p, x: j_transformer(p, x, n_heads=4),
            loss_outer=j_xent)
    elif kind.startswith("dec"):
        onehot = kind == "dec_onehot"
        fns = jhf.HFModelFns(
            model_fn=lambda p, t: j_decoder(p, t, n_heads=4,
                                            embed_onehot=onehot),
            loss_outer=lambda o, t: j_next_token(o, t, onehot=onehot))
    else:
        fns = jhf.HFModelFns(model_fn=lambda p, t: j_moe(p, t, n_heads=4),
                             loss_outer=j_next_token)
    return fns


def j_config(case):
    c = worker.config_for(case)
    return jhf.HFConfig(
        curvature_opt=c.curvature_opt, damping=c.damping,
        cg_max_iter=c.cg_max_iter, rich_stats=c.rich_stats,
        cg=jhf.CGConfig(store_dtype=c.cg.store_dtype))


def jax_run(case, world):
    spec = worker.CASES[case]
    params, batches = draw(case)
    fns, config = j_model(spec["model"]), j_config(case)
    ravel = jhf.TrainableRavel(params, pad_to_multiple=8)
    if spec.get("mesh") == "model":
        mesh = j_make_mesh(world, axis_names=("model",))
        data_axis = None
    else:
        mesh = j_make_mesh(world, axis_names=("data", "model"),
                           shape=(world // 2, 2))
        data_axis = "data"
    kw = dict(data_axis=data_axis,
              param_specs=to_jax_specs(spec.get("param_specs")),
              batch_specs=to_jax_specs(spec.get("batch_specs")))
    state = jhf.init_state(ravel, config)
    builder = spec.get("builder", "step")
    out = {}
    if builder == "step":
        step = jsh.make_sharded_hf_step(fns, config, ravel, mesh, **kw)
        diag = None
        if spec.get("precond"):
            diag = jhf.diag_EF(j_mlp, j_mse, params, *batches[0], "mean",
                               ravel)
        ps, ss, p = [], [], params
        for batch in batches:
            p, state, stats = step(p, state, batch, precond_diag=diag)
            ps.append(np.asarray(ravel.ravel(p)))
            ss.append(stats)
        out["params"] = np.stack(ps)
        for name in ("init_loss", "new_damping", "num_cg_iters"):
            out[name] = np.array([float(getattr(s, name)) for s in ss])
        if spec.get("rich"):
            out["m_hist"] = np.asarray(stats.detail.m_hist)
    elif builder == "acc":
        step = jsh.make_sharded_hf_acc_step(fns, config, ravel, mesh, **kw)
        data = tuple(jnp.stack([b[k] for b in batches]) for k in range(2))
        p, _, stats = step(params, state, data)
        out["params"] = np.asarray(ravel.ravel(p))[None]
        out["num_cg_iters"] = np.array([int(stats.num_cg_iters)])
        out["init_loss"] = np.array([float(stats.init_loss)])
    elif builder == "loop":
        loop = jsh.make_sharded_hf_train_loop(
            fns, config, ravel, mesh, precond_ema_decay=spec.get("ema"),
            **kw)
        data = tuple(jnp.stack([b[k] for b in batches]) for k in range(2))
        res = loop(params, state, data)
        out["params"] = np.asarray(ravel.ravel(res[0]))[None]
        out["num_cg_iters"] = np.asarray(res[2].num_cg_iters)
        out["init_loss"] = np.asarray(res[2].init_loss)
        if spec.get("ema"):
            out["ema"] = np.asarray(res[3][0])
    else:
        opt = jhf.HessianFree(
            params, model_fn=fns.model_fn, loss_outer=fns.loss_outer,
            config=config, pad_to_multiple=8, mesh=mesh,
            param_specs=kw["param_specs"], batch_specs=kw["batch_specs"])
        out.update(worker.wrapper_calls(opt, batches,
                                        precond=case == "wrap"))
    return out


def port_run(case):
    """The port in one process: ``hf_step`` / ``hf_acc_step`` /
    ``make_hf_train_loop`` / the wrapper without a mesh."""
    spec = worker.CASES[case]
    params, batches = draw(case)
    tparams = params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    batches = [tuple(torch.tensor(np.asarray(a)) for a in b)
               for b in batches]
    _, fns, _ = worker.model(spec["model"])
    config = worker.config_for(case)
    ravel = thf.TrainableRavel(tparams, pad_to_multiple=8)
    state = thf.init_state(ravel, config)
    builder = spec.get("builder", "step")
    out = {}
    if builder == "step":
        step = thf.make_hf_step(fns, config, ravel)
        diag = None
        if spec.get("precond"):
            diag = thf.diag_EF(fns.model_fn, fns.loss_outer, tparams,
                               *batches[0], "mean", ravel)
        ps, ss, p = [], [], tparams
        for batch in batches:
            p, state, stats = step(p, state, batch, precond_diag=diag)
            ps.append(ravel.ravel(p).numpy())
            ss.append(stats)
        out["params"] = np.stack(ps)
        for name in ("init_loss", "new_damping", "num_cg_iters"):
            out[name] = np.array([float(getattr(s, name)) for s in ss])
        if spec.get("rich"):
            out["m_hist"] = stats.detail.m_hist.numpy()
    elif builder == "acc":
        p, _, stats = thf.hf_acc_step(
            tparams, state, fns=fns, config=config, ravel=ravel,
            loss_data=worker.stacked(batches))
        out["params"] = ravel.ravel(p).numpy()[None]
        out["num_cg_iters"] = np.array([stats.num_cg_iters])
        out["init_loss"] = np.array([float(stats.init_loss)])
    elif builder == "loop":
        loop = thf.make_hf_train_loop(fns, config, ravel,
                                      precond_ema_decay=spec.get("ema"))
        res = loop(tparams, state, worker.stacked(batches))
        out["params"] = ravel.ravel(res[0]).numpy()[None]
        out["num_cg_iters"] = res[2].num_cg_iters.numpy()
        out["init_loss"] = res[2].init_loss.numpy()
        if spec.get("ema"):
            out["ema"] = res[3].diag.numpy()
    else:
        opt = thf.HessianFree(tparams, model_fn=fns.model_fn,
                              loss_outer=fns.loss_outer, config=config,
                              pad_to_multiple=8)
        out.update(worker.wrapper_calls(opt, batches,
                                        precond=case == "wrap"))
    return out


def run_all(cases, tmp, world):
    """Start ``world`` ranks on ``cases``, compute the JAX and one-process
    references meanwhile, and return ``({case: (jax, port)}, ranks)``."""
    write_problem(tmp / "problem.npz", cases)
    procs = dp_worker.spawn_script(
        worker.__file__, [str(tmp / "problem.npz"), str(tmp),
                          ",".join(cases)], world)
    try:
        refs = {case: (jax_run(case, world), port_run(case))
                for case in cases if case in worker.CASES}
        return refs, dp_worker.collect(procs, tmp, timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def check(results, case):
    """The ranks' run of ``case`` against JAX and the one-process port at
    tests/test_sharded.py's tolerances, and the ranks against each other
    bit for bit."""
    refs, ranks = results
    r0 = ranks[0]
    tols = TOLS[case]
    for ref in refs[case]:
        np.testing.assert_array_equal(r0[f"{case}/num_cg_iters"],
                                      ref["num_cg_iters"])
        # [records, n]: each row, a whole parameter vector, is compared
        assert r0[f"{case}/params"].ndim == ref["params"].ndim == 2
        assert r0[f"{case}/params"].shape == ref["params"].shape
        for i, atol in enumerate(tols[:len(ref["params"])]):
            np.testing.assert_allclose(r0[f"{case}/params"][i],
                                       ref["params"][i], rtol=0, atol=atol)
        if "init_loss" in ref:
            # the first step's loss at the shared start; each later one
            # at parameters as far apart as the step before allows
            for i, (got, want) in enumerate(zip(r0[f"{case}/init_loss"],
                                                ref["init_loss"])):
                atol = 1e-9 if i == 0 else 10 * tols[min(i, len(tols)) - 1]
                np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        for key, kw in (("m_hist", dict(atol=1e-6)),
                        ("ema", dict(atol=1e-10)),
                        ("diag", dict(rtol=1e-9, atol=1e-12)),
                        ("acc_params", dict(atol=tols[-1]))):
            if key in ref:
                np.testing.assert_allclose(r0[f"{case}/{key}"], ref[key],
                                           **kw)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{case}/params"],
                                      r0[f"{case}/params"])
