"""One rank of the pipeline parity runs (``tests/test_torch_pipeline*.py``),
on the CPU over gloo, in f64::

    python tests/_torch_pipeline_worker.py RANK WORLD PORT PROBLEM.npz \
        OUT_DIR CASES [DEVICE BACKEND]

Each rank joins a ``WORLD``-rank group (gloo on the CPU by default;
``cuda:0 gloo`` for ranks sharing the card) on ``localhost:PORT``, runs
the comma-separated ``CASES`` of :data:`CASES` and writes
``OUT_DIR/rank{RANK}.npz``:

- on 4 ranks, a (stage 4) mesh, tests/test_pipeline.py's cases through the
  port's ``pipeline_blocks`` on the JAX draws of the problem file: the
  forward, loss, gradient and GGN matvec (``fwd``), the Hessian matvec
  (``hvp``), a whole ``make_hf_step`` step (``step``), the forwards at
  other microbatch counts and with remat (``micro``), the two
  ``ValueError``s (``errors``) and the shifts of one forward pass and of
  one gradient (``count``);
- ``sharded`` (4 ranks, a (stage 2, model 2) mesh): a
  ``make_sharded_hf_step`` step over the pipelined model (``data_axis=
  None``);
- ``vmap`` (2 ranks, a (stage 2) mesh): ``vmap`` through the pipeline in
  the optimizer's own uses (:func:`case_vmap`);
- ``probe`` (2 ranks): the three collectives of the
  schedule under every
  transform the optimizer uses -- ``ppermute`` against the joined program
  of the ranks (:func:`probe_expected`), and a two-stage pipeline of a
  small nonlinear block through ``copy_to_axis`` and ``reduce_from_axis``
  against the same blocks run in sequence in one process.

It imports no JAX; tests/_torch_pipeline_parity.py is the JAX side.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.func import jvp, linearize, vjp, vmap  # noqa: E402

import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    init_decoder_lm,
    next_token_loss,
)
from pytorchhessianfree_tpu_torch.models.transformer import (  # noqa: E402
    _block,
    _layernorm,
    stack_blocks,
)
from pytorchhessianfree_tpu_torch.ops.curvature import (  # noqa: E402
    ggnvp_fn,
    hvp_fn,
)
from pytorchhessianfree_tpu_torch.parallel import (  # noqa: E402
    collectives as C,
)
from pytorchhessianfree_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize_distributed,
)
from pytorchhessianfree_tpu_torch.parallel.mesh import make_mesh  # noqa
from pytorchhessianfree_tpu_torch.parallel.pipeline import (  # noqa: E402
    pipeline_blocks,
)
from pytorchhessianfree_tpu_torch.parallel.sharded import (  # noqa: E402
    make_sharded_hf_step,
)
from pytorchhessianfree_tpu_torch.utils.flatten import (  # noqa: E402
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from pytorchhessianfree_tpu_torch.utils.remat import checkpoint  # noqa

N_LAYERS, N_HEADS = 4, 4
STEP_CG, SHARDED_CG = 15, 10  # tests/test_pipeline.py's cg_max_iter
MICRO = {"m1": dict(n_microbatches=1), "m4": dict(n_microbatches=4),
         "remat": dict(n_microbatches=2, remat=True)}
F64 = torch.float64


def pipelined_apply(mesh, n_microbatches=2, remat=False):
    """tests/test_pipeline.py's ``_pipelined_apply``, in the port."""

    def block_fn(blk, h):
        return _block(blk, h, N_HEADS, causal=True)

    if remat:
        block_fn = checkpoint(block_fn)

    def apply(params, tokens):
        x = params["embed"][tokens] + params["pos"][:tokens.shape[1]]
        x = pipeline_blocks(stack_blocks(params["blocks"]), x, block_fn,
                            mesh, n_microbatches=n_microbatches)
        return _layernorm(params["ln_f"], x) @ params["embed"].T

    return apply


def problem(z, case):
    """The case's JAX-drawn weights in the port's tree, and its tokens."""
    template = init_decoder_lm(torch.Generator().manual_seed(0), vocab=16,
                               d_model=16, n_layers=N_LAYERS, d_ff=32,
                               max_len=8, dtype=F64)
    leaves, treedef = tree_flatten(template)
    params = tree_unflatten(treedef, [torch.tensor(z[f"{case}/p{i}"])
                                      for i in range(len(leaves))])
    return params, torch.tensor(z[f"{case}/tokens"])


def flat(tree):
    return torch.cat([leaf.reshape(-1) for leaf in tree_flatten(tree)[0]])


def ones(tree):
    return tree_map(torch.ones_like, tree)


def case_fwd(mesh, z, out):
    params, tokens = problem(z, "fwd")
    apply = pipelined_apply(mesh)
    loss, outputs, grad, gv = ggnvp_fn(
        lambda q: apply(q, tokens), lambda o: next_token_loss(o, tokens),
        params)
    out["fwd/out"] = outputs
    out["fwd/loss"] = loss
    out["fwd/grad"] = flat(grad)
    out["fwd/ggn"] = flat(gv(ones(params)))


def case_hvp(mesh, z, out):
    params, tokens = problem(z, "hvp")
    apply = pipelined_apply(mesh)
    loss, grad, hvp = hvp_fn(
        lambda q: next_token_loss(apply(q, tokens), tokens), params)
    out["hvp/loss"] = loss
    out["hvp/grad"] = flat(grad)
    out["hvp/hvp"] = flat(hvp(ones(params)))


def case_step(mesh, z, out):
    params, tokens = problem(z, "step")
    config = thf.HFConfig(damping=1.0, cg_max_iter=STEP_CG)
    ravel = thf.TrainableRavel(params)
    step = thf.make_hf_step(
        thf.HFModelFns(model_fn=pipelined_apply(mesh),
                       loss_outer=next_token_loss), config, ravel)
    p, _, st = step(params, thf.init_state(ravel, config), (tokens, tokens))
    out["step/params"] = flat(p)
    out["step/num_cg_iters"] = torch.tensor(st.num_cg_iters)


def case_micro(mesh, z, out):
    params, tokens = problem(z, "micro")
    for name, kw in MICRO.items():
        out[f"micro/{name}"] = pipelined_apply(mesh, **kw)(params, tokens)


def case_errors(mesh, z, out):
    """The two ``ValueError``s, raised before any collective."""
    params, tokens = problem(z, "errors")
    errors = []
    three = stack_blocks(params["blocks"][:3])  # 3 layers over 4 stages
    for call in (
        lambda: pipeline_blocks(three, torch.zeros(4, 8, 16, dtype=F64),
                                lambda b, h: h, mesh),
        lambda: pipelined_apply(mesh, n_microbatches=3)(params, tokens),
    ):
        try:
            call()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)


def case_count(mesh, z, out):
    """The shifts of one forward pass and of one gradient (forward and
    backward): their count and each one's shape."""
    params, tokens = problem(z, "fwd")
    apply = pipelined_apply(mesh)
    shapes = []
    shift = C._shift

    def counted(x, axis, k):
        shapes.append(tuple(x.shape))
        return shift(x, axis, k)

    C._shift = counted
    try:
        apply(params, tokens)
        out["count/forward"] = torch.tensor(shapes)
        shapes.clear()
        loss, pull = vjp(lambda q: next_token_loss(apply(q, tokens), tokens),
                         params)
        pull(torch.ones_like(loss))
        out["count/gradient"] = torch.tensor(shapes)
    finally:
        C._shift = shift


def batched_step(fns, z):
    """A short step of ``fns`` on the ``step`` draw with both selections
    batched: one ``vmap`` sweep of the loss over the candidates each."""
    params, tokens = problem(z, "step")
    config = thf.HFConfig(damping=1.0, cg_max_iter=5,
                          backtracking_mode="batched",
                          linesearch=thf.LineSearchConfig(mode="batched"))
    ravel = thf.TrainableRavel(params)
    p, _, st = thf.hf_step(params, thf.init_state(ravel, config),
                           (tokens, tokens), fns=fns, config=config,
                           ravel=ravel)
    return {"vmap/params": flat(p),
            "vmap/num_cg_iters": torch.tensor(st.num_cg_iters)}


def case_vmap(mesh, z, out):
    """``vmap`` through the pipeline in the optimizer's own uses:
    :func:`batched_step`, and the linearized GGN matvec ``vmap``ped over 3
    probes (as the Nystrom sketch takes it) beside the matvec of each."""
    fns = thf.HFModelFns(model_fn=pipelined_apply(mesh),
                         loss_outer=next_token_loss)
    out.update(batched_step(fns, z))
    params, tokens = problem(z, "step")
    ravel = thf.TrainableRavel(params)
    _, _, mvp = thf.optimizer._build_matvec_and_grad(
        fns, thf.HFConfig(), ravel, params, (tokens, tokens))
    probes = torch.linspace(-1, 1, 3 * ravel.dim, dtype=F64).reshape(3, -1)
    out["vmap/matvecs"] = vmap(mvp)(probes)
    out["vmap/looped"] = torch.stack([mvp(q) for q in probes])


def case_sharded(_, z, out):
    """tests/test_pipeline.py:141-189 on a (stage 2, model 2) mesh."""
    mesh = make_mesh(4, axis_names=("stage", "model"), shape=(2, 2))
    params, tokens = problem(z, "sharded")
    config = thf.HFConfig(damping=1.0, cg_max_iter=SHARDED_CG)
    ravel = thf.TrainableRavel(params, pad_to_multiple=8)
    step = make_sharded_hf_step(
        thf.HFModelFns(model_fn=pipelined_apply(mesh),
                       loss_outer=next_token_loss),
        config, ravel, mesh, data_axis=None, model_axis="model")
    p, state, st = step(params, thf.init_state(ravel, config),
                        (tokens, tokens))
    out["sharded/params"] = flat(p)
    out["sharded/num_cg_iters"] = torch.tensor(st.num_cg_iters)
    out["sharded/x0_size"] = torch.tensor(state.x0.numel())


# -- the probe -------------------------------------------------------------

PN, PB, REPLAYS = 3, 4, 20  # width, rows, linearize replays


def probe_inputs(rank):
    """Rank ``rank``'s point, tangents and cotangents for ``ppermute``
    (seeded by rank), and the replicated ones of the pipeline (one seed)."""
    g = np.random.default_rng(300 + rank)
    t = lambda *s: torch.tensor(g.standard_normal(s))  # noqa: E731
    own = {"x": t(PN), "t": t(PN), "u": t(PN), "w": t(PN), "v": t(PN),
           "ts": t(REPLAYS, PN), "tb": t(3, PN)}
    g = np.random.default_rng(400)
    dim = 2 * PN * PN + PB * PN  # two stages' [PN, PN] weights and x
    rep = {"z": t(dim), "t": t(dim), "u": t(PB, PN), "w": t(PB, PN),
           "v": t(dim), "ts": t(REPLAYS, dim), "tb": t(3, dim)}
    return own, rep


def shift_sq(x, axis):
    """f_r(x) = (x_{r-1})^2, the square of the previous rank's x."""
    return C.ppermute(x * x, axis)


def shift_loss(x, w, axis):
    """A rank-dependent scalar through shifts both ways."""
    y = C.ppermute(x * x, axis)
    return torch.sum(w * y * y) + w[0] * torch.sum(
        C.ppermute(x, axis, -1) ** 3)


def probe_blocks(z):
    """The pipeline probe's stacked weights ``[2, PN, PN]`` and rows
    ``[PB, PN]`` from the flat point."""
    return (z[:2 * PN * PN].reshape(2, PN, PN),
            z[2 * PN * PN:].reshape(PB, PN))


def probe_block(W, h):
    return torch.tanh(h @ W) + 0.5 * h


def pipe_fn(mesh):
    def f(z):
        W, x = probe_blocks(z)
        return pipeline_blocks(W, x, probe_block, mesh, n_microbatches=2)
    return f


def seq_fn(z):
    W, h = probe_blocks(z)
    for i in range(W.shape[0]):
        h = probe_block(W[i], h)
    return h


def derivatives(f, loss, x, d):
    """Every derivative of the probe: the value, jvp, 20 linearize replays,
    vjp, the vjp of a jvp, the gradient of ``loss`` and its Hessian
    products forward over reverse, reverse over reverse and linearized,
    and vmap of a jvp."""
    t, u, v = d["t"], d["u"], d["v"]
    out = {"value": f(x), "jvp": jvp(f, (x,), (t,))[1]}
    _, lin = linearize(f, x)
    out["linearize"] = torch.stack([lin(ti) for ti in d["ts"]])
    out["vjp"] = vjp(f, x)[1](u)[0]
    out["vjp_of_jvp"] = vjp(lambda q: torch.sum(u * jvp(f, (q,), (t,))[1]),
                            x)[1](torch.ones((), dtype=F64))[0]
    out["vmap_jvp"] = vmap(lambda tt: jvp(f, (x,), (tt,))[1])(d["tb"])

    def grad_L(q):
        return vjp(loss, q)[1](torch.ones((), dtype=F64))[0]

    out["grad"] = grad_L(x)
    out["hvp_fwd_rev"] = jvp(grad_L, (x,), (v,))[1]
    out["hvp_rev_rev"] = vjp(grad_L, x)[1](v)[0]
    out["hvp_linearized"] = linearize(grad_L, x)[1](v)
    return out


def probe_expected(world):
    """What each rank's probe must give: ``ppermute/*`` from the joined
    program over the ranks' stacked inputs, ``[world, ...]``, and
    ``pipeline/*`` from the blocks in sequence in one process, the same on
    every rank."""
    ds = [probe_inputs(r)[0] for r in range(world)]
    J = {k: torch.stack([d[k] for d in ds]) for k in ds[0]}

    def joined(xs):
        return torch.roll(xs * xs, 1, 0)

    def joined_loss(xs):
        y = joined(xs)
        return torch.sum(J["w"] * y * y) + torch.sum(
            J["w"][:, 0] * torch.sum(torch.roll(xs, -1, 0) ** 3, 1))

    d = dict(J, ts=J["ts"].transpose(0, 1), tb=J["tb"].transpose(0, 1))
    got = derivatives(joined, joined_loss, J["x"], d)
    for key in ("linearize", "vmap_jvp"):
        got[key] = got[key].transpose(0, 1)
    out = {f"ppermute/{k}": v.numpy() for k, v in got.items()}
    rep = probe_inputs(0)[1]
    seq = derivatives(seq_fn, lambda q: torch.sum(rep["w"] * seq_fn(q) ** 2),
                      rep["z"], rep)
    for k, v in seq.items():
        out[f"pipeline/{k}"] = np.broadcast_to(v.numpy(),
                                               (world,) + v.shape)
    return out


def handed(fn):
    """``fn()`` with what this rank hands the collectives counted:
    ``[all-reduce bytes, all-to-all bytes sent, calls]``, the all-to-all's
    by its send splits."""
    counts = [0, 0, 0]
    reduce, a2a = dist.all_reduce, dist.all_to_all_single

    def all_reduce(t, *args, **kwargs):
        counts[0] += t.numel() * t.element_size()
        counts[2] += 1
        return reduce(t, *args, **kwargs)

    def all_to_all_single(output, input, output_split_sizes=None,
                          input_split_sizes=None, *args, **kwargs):
        sent = input.numel() if input_split_sizes is None \
            else sum(input_split_sizes)
        counts[1] += sent * input.element_size()
        counts[2] += 1
        return a2a(output, input, output_split_sizes, input_split_sizes,
                   *args, **kwargs)

    dist.all_reduce, dist.all_to_all_single = all_reduce, all_to_all_single
    try:
        fn()
    finally:
        dist.all_reduce, dist.all_to_all_single = reduce, a2a
    return torch.tensor(counts)


def case_probe(mesh, _, out):
    axis = C.mesh_axis(mesh, "stage")
    own, rep = probe_inputs(axis.rank)
    # one shift hands the collective this rank's block alone
    out["ppermute/handed"] = handed(lambda: C.ppermute(own["ts"], axis))
    got = derivatives(lambda q: shift_sq(q, axis),
                      lambda q: shift_loss(q, own["w"], axis), own["x"], own)
    out.update({f"ppermute/{k}": v for k, v in got.items()})
    f = pipe_fn(mesh)
    got = derivatives(f, lambda q: torch.sum(rep["w"] * f(q) ** 2),
                      rep["z"], rep)
    out.update({f"pipeline/{k}": v for k, v in got.items()})


CASES = {"fwd": case_fwd, "hvp": case_hvp, "step": case_step,
         "micro": case_micro, "errors": case_errors, "count": case_count,
         "sharded": case_sharded, "probe": case_probe, "vmap": case_vmap}


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    problem_path, out_dir, cases = sys.argv[4:7]
    device, backend = (sys.argv[7:9] if len(sys.argv) > 7
                       else ("cpu", "gloo"))
    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank,
                           backend=backend, device=device)
    torch.set_default_device(device)
    z = np.load(problem_path) if os.path.exists(problem_path) else None
    stage = make_mesh(world, axis_names=("stage",))
    out = {}
    for case in cases.split(","):
        CASES[case](stage, z, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
                for k, v in out.items()})
    dist.destroy_process_group()
    print(f"rank {rank}/{world} [{cases}]: ok")


if __name__ == "__main__":
    main()
