"""One rank of the port's model-axis parity runs, on the CPU over gloo.

Started by the ``tests/test_torch_sharded_*.py`` files::

    python tests/_torch_sharded_worker.py RANK WORLD PORT PROBLEM.npz OUT_DIR CASES [DEVICE]

Each rank joins a ``WORLD``-rank gloo group on ``localhost:PORT`` (its
tensors on ``DEVICE``, the CPU by default) and forms a ``(data, model)``
mesh of shape ``(WORLD / 2, 2)``.  For every case named
in the comma-separated ``CASES`` it rebuilds the case's model from the
problem's leaves (written with numpy by the test, drawn by the JAX
package), runs the case's builder of ``parallel/sharded.py`` (or the
``HessianFree`` wrapper) on the WHOLE batches, and writes the WHOLE
parameters, the CG iterations and the losses to ``OUT_DIR/rank{RANK}.npz``.
:data:`CASES` mirrors tests/test_sharded.py; the test runs the same cases
through the JAX package's builders and through the port's one-process
steps (``tests/_torch_sharded_parity.py``).  The suites of
:data:`MEGATRON_SUITES` check what each rank computes under Megatron
tensor parallelism against one process's values in the rank itself.  It
imports no JAX.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    cross_entropy_loss,
    decoder_lm_apply,
    init_decoder_lm,
    init_mlp,
    init_transformer,
    mlp_apply,
    mse_loss,
    next_token_loss,
    transformer_apply,
)
from pytorchhessianfree_tpu_torch.models.moe import (  # noqa: E402
    init_moe_decoder_lm,
    moe_decoder_lm_apply,
    moe_param_specs,
)
from pytorchhessianfree_tpu_torch.parallel import (  # noqa: E402
    collectives,
    sharded,
)
from pytorchhessianfree_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize_distributed,
    rank_device,
)
from pytorchhessianfree_tpu_torch.parallel.mesh import (  # noqa: E402
    PartitionSpec as P,
    make_mesh,
)
from pytorchhessianfree_tpu_torch.utils.flatten import (  # noqa: E402
    tree_flatten,
    tree_map,
    tree_unflatten,
)

SIZES = (7, 16, 16, 4)
COL, ROW = P(None, "model"), P("model", None)
# tests/test_sharded.py:316-331
MEGATRON = {
    "embed": P(None, "model"),
    "pos": P(None, "model"),
    "head": {"w": COL, "b": P("model")},
    "blocks": [
        {"ln1": P(), "ln2": P(), "qkv": {"w": COL, "b": P("model")},
        "proj": {"w": ROW, "b": P()}, "ff1": {"w": COL, "b": P("model")},
        "ff2": {"w": ROW, "b": P()}}
        for _ in range(2)
    ],
}
TINY_LM = dict(vocab=12, d_model=16, d_ff=32, max_len=8)

# case -> model, builder, steps and the builder's keywords
CASES = {
    "ggn": dict(model="mlp", steps=3),
    "hessian": dict(model="mlp", steps=3, curvature="hessian"),
    "precond": dict(model="mlp", steps=1, precond=True),
    "model_only": dict(model="mlp", steps=1, mesh="model"),
    "rich": dict(model="mlp", steps=1, rich=True),
    "acc": dict(model="mlp", steps=1, builder="acc"),
    "loop": dict(model="mlp", steps=3, builder="loop"),
    "loop_ema": dict(model="mlp", steps=3, builder="loop", ema=0.9),
    "tp": dict(model="enc", steps=2, param_specs=MEGATRON),
    "cp": dict(model="dec", steps=2, batch_specs=P(None, "model")),
    "cp2d": dict(model="dec_onehot", steps=1,
                 batch_specs=P("data", "model")),
    "acc_cp": dict(model="dec1", steps=1, builder="acc",
                   batch_specs=P(None, "model")),
    "loop_cp": dict(model="dec1", steps=2, builder="loop",
                    batch_specs=P(None, "model")),
    "ep": dict(model="moe", steps=2, param_specs=moe_param_specs(2)),
    "wrap": dict(model="mlp", steps=2, builder="wrapper"),
    "wrap_cp": dict(model="dec", steps=2, builder="wrapper", cg=20,
                    batch_specs=P(None, "model")),
    "wrap_tp": dict(model="enc", steps=2, builder="wrapper",
                    param_specs=MEGATRON),
}


def model(kind):
    """``(params template, HFModelFns, HFConfig)`` of a model kind, as
    tests/test_sharded.py builds it (the template's values are replaced
    by the problem's)."""
    g = torch.Generator().manual_seed(0)
    f64 = torch.float64
    if kind == "mlp":
        return (init_mlp(g, sizes=SIZES, dtype=f64),
                thf.HFModelFns(model_fn=mlp_apply, loss_outer=mse_loss),
                thf.HFConfig(damping=0.5, cg_max_iter=50))
    if kind == "enc":
        return (init_transformer(g, n_layers=2, num_classes=4, dtype=f64,
                                 **TINY_LM),
                thf.HFModelFns(
                    model_fn=lambda p, x: transformer_apply(p, x, n_heads=4),
                    loss_outer=cross_entropy_loss),
                thf.HFConfig(damping=1.0, cg_max_iter=25))
    if kind.startswith("dec"):
        layers = 1 if kind == "dec1" else 2
        onehot = kind == "dec_onehot"
        return (init_decoder_lm(g, n_layers=layers, dtype=f64, **TINY_LM),
                thf.HFModelFns(
                    model_fn=lambda p, t: decoder_lm_apply(
                        p, t, n_heads=4, embed_onehot=onehot),
                    loss_outer=lambda o, t: next_token_loss(
                        o, t, onehot=onehot)),
                thf.HFConfig(damping=1.0,
                             cg_max_iter=15 if layers == 1 else 25))
    if kind == "moe":
        return (init_moe_decoder_lm(g, n_layers=2, n_experts=4, dtype=f64,
                                    **TINY_LM),
                thf.HFModelFns(
                    model_fn=lambda p, t: moe_decoder_lm_apply(p, t,
                                                                n_heads=4),
                    loss_outer=next_token_loss),
                thf.HFConfig(damping=1.0, cg_max_iter=25))
    raise ValueError(kind)


def config_for(case):
    spec = CASES[case]
    _, _, config = model(spec["model"])
    if spec.get("curvature"):
        config = thf.HFConfig(curvature_opt=spec["curvature"],
                              damping=config.damping,
                              cg_max_iter=config.cg_max_iter)
    if spec.get("rich"):
        config = thf.HFConfig(damping=0.5, cg_max_iter=25, rich_stats=True,
                              cg=thf.CGConfig(store_dtype="float32"))
    if spec.get("cg"):
        config = thf.HFConfig(damping=config.damping,
                              cg_max_iter=spec["cg"])
    return config


def problem(z, case):
    """The case's params (the JAX draw's leaves in the template's tree)
    and its batches ``[(x, y), ...]`` as tensors."""
    template = model(CASES[case]["model"])[0]
    leaves, treedef = tree_flatten(template)
    params = tree_unflatten(
        treedef, [torch.tensor(z[f"{case}/p{i}"]) for i in range(len(leaves))])
    batches = []
    i = 0
    while f"{case}/x{i}" in z:
        batches.append((torch.tensor(z[f"{case}/x{i}"]),
                        torch.tensor(z[f"{case}/y{i}"])))
        i += 1
    return params, batches


def record(out, case, ravel, params_per_step, stats_per_step):
    out[f"{case}/params"] = np.stack(
        [ravel.ravel(p).numpy() for p in params_per_step])
    for name in ("init_loss", "new_damping", "num_cg_iters"):
        out[f"{case}/{name}"] = np.array(
            [float(getattr(s, name)) for s in stats_per_step])


def stacked(batches):
    return tuple(torch.stack([b[k] for b in batches]) for k in range(2))


def run_case(case, z, meshes, out):
    spec = CASES[case]
    params, batches = problem(z, case)
    _, fns, _ = model(spec["model"])
    config = config_for(case)
    ravel = thf.TrainableRavel(params, pad_to_multiple=8)
    mesh = meshes[spec.get("mesh", "2d")]
    data_axis = "data" if "data" in mesh.mesh_dim_names else None
    kw = dict(data_axis=data_axis, param_specs=spec.get("param_specs"),
              batch_specs=spec.get("batch_specs"))
    specs = spec.get("param_specs")
    builder = spec.get("builder", "step")
    state = thf.init_state(ravel, config)
    if builder == "step":
        step = sharded.make_sharded_hf_step(fns, config, ravel, mesh, **kw)
        diag = None
        if spec.get("precond"):
            diag = thf.diag_EF(mlp_apply, mse_loss, params, *batches[0],
                               "mean", ravel)
        p, ps, ss = params, [], []
        for batch in batches:
            p, state, stats = step(p, state, batch, precond_diag=diag)
            ps.append(sharded.unshard_params(p, specs, mesh, ravel))
            ss.append(stats)
        record(out, case, ravel, ps, ss)
        if spec.get("rich"):
            out[f"{case}/m_hist"] = stats.detail.m_hist.numpy()
        if specs is not None:  # the returned leaves are this rank's blocks
            out[f"{case}/shapes"] = np.array(
                repr([tuple(t.shape) for t in tree_flatten(p)[0]]))
    elif builder == "acc":
        step = sharded.make_sharded_hf_acc_step(fns, config, ravel, mesh,
                                                **kw)
        p, state, stats = step(params, state, stacked(batches))
        record(out, case, ravel, [p], [stats])
    elif builder == "loop":
        loop = sharded.make_sharded_hf_train_loop(
            fns, config, ravel, mesh, precond_ema_decay=spec.get("ema"),
            **kw)
        res = loop(params, state, stacked(batches))
        p, stats = res[0], res[2]
        out[f"{case}/params"] = ravel.ravel(p).numpy()[None]
        out[f"{case}/num_cg_iters"] = stats.num_cg_iters.numpy()
        out[f"{case}/init_loss"] = stats.init_loss.numpy()
        if spec.get("ema"):  # the EMA diagonal, whole
            out[f"{case}/ema"] = sharded.ModelShard(
                collectives.mesh_axis(mesh, "model"),
                ravel.dim).gather(res[3].diag).numpy()
        out[f"{case}/x0_shape"] = np.array(res[1].x0.shape)
    else:
        wrapper_case(case, spec, params, batches, fns, config, mesh, out)


def wrapper_calls(opt, batches, precond=True):
    """The calls of tests/test_sharded.py's wrapper tests, here and in the
    test: steps (the whole parameters after each), a diagonal, an
    accumulated step."""
    rows = []
    for batch in batches:
        opt.step(batch)
        rows.append(np.asarray(opt.ravel.ravel(opt.params)))
    res = {"params": np.stack(rows),
           "num_cg_iters": np.array(opt.history["num_cg_iters"])}
    if precond:
        x, y = batches[0]
        res["diag"] = np.asarray(opt.get_preconditioner(x, y, "mean"))
        opt.acc_step(tuple(t.reshape(2, -1, *t.shape[1:])
                           for t in batches[0]))
        res["acc_params"] = np.asarray(opt.ravel.ravel(opt.params))
    return res


def wrapper_case(case, spec, params, batches, fns, config, mesh, out):
    opt = thf.HessianFree(
        params, model_fn=fns.model_fn, loss_outer=fns.loss_outer,
        config=config, pad_to_multiple=8, mesh=mesh,
        param_specs=spec.get("param_specs"),
        batch_specs=spec.get("batch_specs"))
    res = wrapper_calls(opt, batches, precond=case == "wrap")
    for k, v in res.items():
        out[f"{case}/{k}"] = v
    out[f"{case}/x0_shape"] = np.array(opt.state.x0.shape)
    if case == "wrap_tp":
        return
    errors = []
    if case == "wrap":
        try:
            data = tuple(t.reshape(2, -1, *t.shape[1:]) for t in batches[0])
            opt.acc_step(data, grad_data=data)
        except ValueError as e:
            errors.append(str(e))
    else:
        for m in (None, make_mesh(axis_names=("data",))):
            try:
                thf.HessianFree(params, model_fn=fns.model_fn,
                                loss_outer=fns.loss_outer, mesh=m,
                                batch_specs=P(None, "model"))
            except ValueError as e:
                errors.append(str(e))
    out[f"{case}/errors"] = np.array(errors)


def validation(meshes, out):
    """tests/test_sharded.py::test_sharded_validation: an axis that is not
    there, and a flat dimension the model axis does not divide (an MLP of
    451 parameters, unpadded)."""
    params, fns, config = model("mlp")
    errors = []
    try:
        sharded.make_sharded_hf_step(fns, config, thf.TrainableRavel(
            params, pad_to_multiple=8), meshes["2d"], model_axis="tensor")
    except ValueError as e:
        errors.append(str(e))
    odd = init_mlp(torch.Generator().manual_seed(0), sizes=(7, 16, 16, 3),
                   dtype=torch.float64)
    assert thf.TrainableRavel(odd).dim % 2 == 1
    try:
        sharded.make_sharded_hf_step(fns, config, thf.TrainableRavel(odd),
                                     meshes["model"], data_axis=None)
    except ValueError as e:
        errors.append(str(e))
    out["validation/errors"] = np.array(errors)


def placement(meshes, out):
    """tests/test_sharded.py::test_batch_specs_tree_prefix_and_stacked:
    the blocks each rank keeps under per-leaf specs, a None leaf, P(), one
    spec over the tree, and a stacked leading axis."""
    mesh = meshes["2d"]
    x = torch.arange(32.0).reshape(8, 4)
    y = torch.arange(8.0)
    dp = P("data")
    got = sharded._place_batch(mesh, (x, y, y), (P("data", "model"), None,
                                                 P()), dp)
    out["place/xy"] = np.concatenate([t.reshape(-1).numpy() for t in got])
    got = sharded._place_batch(mesh, (x, x), P("data"), None)
    out["place/tree"] = np.concatenate([t.reshape(-1).numpy() for t in got])
    xs = torch.arange(96.0).reshape(3, 8, 4)
    got = sharded._place_batch(mesh, (xs,), (P("data", "model"),), None,
                               stacked=True)
    out["place/stacked"] = got[0].numpy()


# -- Megatron tensor parallelism: what each rank computes -----------------

_tp_sums = [0]


def _count_tp_sums():
    """Count the forward's sums over a tensor axis (each partitioned
    sub-layer calls ``collectives.reduce_from_axis`` once per forward)."""
    reduce = collectives.reduce_from_axis

    def counted(x, axis):
        if collectives.tensor_axis() is not None:
            _tp_sums[0] += 1
        return reduce(x, axis)

    collectives.reduce_from_axis = counted


def tiny_megatron_model(kind, dtype=torch.float64, device="cpu"):
    """``(params, fns, batch, remat)`` of the derivative checks: the
    encoder of tests/test_sharded.py, the causal decoder LM with full or
    chunked attention or rematerialized blocks, the MoE LM (its attention
    split, its experts whole), and two head counts the axis does not
    divide (``heads1``: 1 head, its MLP still split; ``odd``: 3 heads and
    d_ff 33, nothing split)."""
    g = torch.Generator().manual_seed(7)
    dims = dict(TINY_LM)
    heads, kw = 4, {}
    if kind == "odd":
        dims.update(d_model=12, d_ff=33)
        heads = 3
    if kind in ("enc", "heads1", "odd"):
        params = init_transformer(g, n_layers=2, num_classes=4, dtype=dtype,
                                  **dims)
        x = torch.randint(0, 12, (16, 8), generator=g)
        y = torch.randint(0, 4, (16,), generator=g)
        heads = 1 if kind == "heads1" else heads
        fns = thf.HFModelFns(
            model_fn=lambda p, t: transformer_apply(p, t, n_heads=heads),
            loss_outer=cross_entropy_loss)
    elif kind == "moe":
        params = init_moe_decoder_lm(g, n_layers=2, n_experts=4,
                                     dtype=dtype, **dims)
        x = y = torch.randint(0, 12, (4, 8), generator=g)
        fns = thf.HFModelFns(
            model_fn=lambda p, t: moe_decoder_lm_apply(p, t, n_heads=4),
            loss_outer=next_token_loss)
    else:
        params = init_decoder_lm(g, n_layers=2, dtype=dtype, **dims)
        x = torch.randint(0, 12, (4, 8), generator=g)
        y = x
        kw = {"dec_chunk": dict(attn_chunk=4),
              "dec_remat": dict(remat=True)}.get(kind, {})
        fns = thf.HFModelFns(
            model_fn=lambda p, t: decoder_lm_apply(p, t, n_heads=4, **kw),
            loss_outer=next_token_loss)
    params = tree_map(lambda t: t.to(device), params)
    return params, fns, (x.to(device), y.to(device)), bool(kw.get("remat"))


def megatron_values(fns, params, batch, curvature, remat, axis, v):
    """Loss, flat gradient and one curvature matvec (GGN or Hessian) with
    the forward's tensor axis ``axis`` (``None``: one process's)."""
    ravel = thf.TrainableRavel(params, pad_to_multiple=8)
    config = thf.HFConfig(damping=1.0, curvature_opt=curvature, remat=remat)
    with collectives.axes(tensor=axis):
        loss, grad, mvp = thf.optimizer._build_matvec_and_grad(
            fns, config, ravel, params, batch)
        return [loss.reshape(1), grad, mvp(v)]


# the kinds each model-axis group of ranks checks, of about equal cost
MEGATRON_GROUPS = (("enc", "dec_chunk", "heads1"),
                   ("dec", "dec_remat", "moe", "odd"))


def megatron_curvatures(kind):
    """The matvecs checked per kind: GGN and Hessian on the encoder, the
    decoder LM and its one-shot rematerialized form; GGN alone on the
    chunked attention (the same linearized path as the decoder's), the
    MoE LM and where the axis cannot split the heads (``heads1``,
    ``odd``)."""
    return ("ggn", "hessian") if kind in ("enc", "dec", "dec_remat") \
        else ("ggn",)


def megatron_derivatives(mesh, out):
    """Loss, gradient and GGN and Hessian matvecs of the partitioned
    forward per model kind, then one process's, the ranks of the model
    axis taking turns (no collective is left to wait on): each model-axis
    group of ranks takes one of :data:`MEGATRON_GROUPS`."""
    axis = collectives.mesh_axis(mesh, "model")
    checks = []
    for kind in MEGATRON_GROUPS[mesh.get_local_rank("data")]:
        params, fns, batch, remat = tiny_megatron_model(kind)
        v = torch.randn(thf.TrainableRavel(params, pad_to_multiple=8).dim,
                        dtype=torch.float64,
                        generator=torch.Generator().manual_seed(3))
        for curvature in megatron_curvatures(kind):
            key = f"mega/{kind}/{curvature}"
            args = (fns, params, batch, curvature, remat)
            checks.append((key, args, v))
            _tp_sums[0] = 0
            got = megatron_values(*args, axis, v)
            out[f"{key}/sums"] = np.array(_tp_sums[0])
            for name, value in zip(("loss", "grad", "mvp"), got):
                out[f"{key}/{name}"] = value.numpy()
    for key, args, v in checks[axis.rank::axis.size]:
        for name, value in zip(("loss", "grad", "mvp"),
                               megatron_values(*args, None, v)):
            out[f"{key}/{name}_one"] = value.numpy()


class _Shapes(TorchDispatchMode):
    """The output shapes of the ops a forward runs, by op name."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        result = func(*args, **(kwargs or {}))
        if isinstance(result, torch.Tensor):
            self.seen.add(f"{func.overloadpacket.__name__}"
                          f"{tuple(result.shape)}")
        return result


def megatron_split(mesh, out):
    """What one rank computes under the tensor axis against one process:
    the FLOPs of a block and of the encoder's forward
    (``FlopCounterMode``), and the output shapes of the block's ops."""
    from torch.utils.flop_counter import FlopCounterMode

    from pytorchhessianfree_tpu_torch.models.transformer import _block

    axis = collectives.mesh_axis(mesh, "model")
    params, fns, (x, _), _ = tiny_megatron_model("enc")
    h = torch.randn(16, 8, 16, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    blk = params["blocks"][0]
    for name, ax in (("tp", axis), ("one", None)):
        with collectives.axes(tensor=ax):
            with FlopCounterMode(display=False) as block_flops:
                _block(blk, h, n_heads=4)
            with FlopCounterMode(display=False) as forward_flops:
                fns.model_fn(params, x)
            with _Shapes() as shapes:
                _block(blk, h, n_heads=4)
        out[f"split/{name}/block_flops"] = np.array(
            block_flops.get_total_flops())
        out[f"split/{name}/forward_flops"] = np.array(
            forward_flops.get_total_flops())
        out[f"split/{name}/shapes"] = np.array(sorted(shapes.seen))


def megatron_refusals(mesh, out):
    """Megatron blocks with context parallelism (the decoder LM under
    ``batch_specs=P(None, "model")``) and with expert parallelism (the MoE
    LM's expert specs with Megatron attention) over one model axis."""
    errors = []
    params, fns, config = model("dec")
    specs = {"embed": P(), "pos": P(), "ln_f": P(),
             "blocks": MEGATRON["blocks"]}
    tokens = torch.randint(0, 12, (4, 8),
                           generator=torch.Generator().manual_seed(1))
    moe, moe_fns, _ = model("moe")
    moe_specs = moe_param_specs(2)
    for blk in moe_specs["blocks"]:
        blk.update(qkv={"w": COL, "b": P("model")},
                   proj={"w": ROW, "b": P()})
    for p, f, kw in ((params, fns, dict(param_specs=specs,
                                        batch_specs=P(None, "model"))),
                     (moe, moe_fns, dict(param_specs=moe_specs))):
        ravel = thf.TrainableRavel(p, pad_to_multiple=8)
        step = sharded.make_sharded_hf_step(f, config, ravel, mesh, **kw)
        try:
            step(p, thf.init_state(ravel, config), (tokens, tokens))
        except ValueError as e:
            errors.append(str(e))
    out["refuse/errors"] = np.array(errors)


def megatron_on_device(mesh, out):
    """The encoder's forward and GGN matvec of the partitioned forward and
    of one process's in f32 on the rank's device."""
    device = rank_device()
    axis = collectives.mesh_axis(mesh, "model")
    params, fns, batch, _ = tiny_megatron_model("enc", torch.float32,
                                                device)
    n = thf.TrainableRavel(params, pad_to_multiple=8).dim
    v = torch.randn(n, generator=torch.Generator().manual_seed(3)).to(device)
    for name, ax in (("tp", axis), ("one", None)):
        with collectives.axes(tensor=ax):
            logits = fns.model_fn(params, batch[0])
        _, _, mv = megatron_values(fns, params, batch, "ggn", False, ax, v)
        out[f"card/{name}/logits"] = logits.cpu().numpy()
        out[f"card/{name}/mvp"] = mv.cpu().numpy()


MEGATRON_SUITES = {"mega": megatron_derivatives, "split": megatron_split,
                   "refuse": megatron_refusals, "card": megatron_on_device}


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    problem_path, out_dir, cases = sys.argv[4:7]
    device = sys.argv[7] if len(sys.argv) > 7 else "cpu"
    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo",
                           device=device)
    meshes = {"2d": make_mesh(axis_names=("data", "model"),
                              shape=(world // 2, 2)),
              "model": make_mesh(axis_names=("model",))}
    z = dict(np.load(problem_path)) if os.path.exists(problem_path) else {}
    _count_tp_sums()
    out = {}
    for case in cases.split(","):
        _tp_sums[0] = 0
        if case == "validation":
            validation(meshes, out)
        elif case == "placement":
            placement(meshes, out)
        elif case in MEGATRON_SUITES:
            MEGATRON_SUITES[case](meshes["2d"], out)
        else:
            run_case(case, z, meshes, out)
            out[f"{case}/tp_sums"] = np.array(_tp_sums[0])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    print(f"rank {rank}/{world} [{cases}]: ok")


if __name__ == "__main__":
    main()
