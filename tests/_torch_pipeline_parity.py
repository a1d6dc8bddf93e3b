"""The JAX side of the pipeline parity tests (``tests/test_torch_pipeline*.py``):
tests/test_pipeline.py's draws, configurations and values through the JAX
package's own ``pipeline_blocks`` on 4 of the 8 virtual CPU devices, in
f64.

:func:`run` writes each case's weights (carried across with
``convert.params_from_jax``) and tokens for the ranks
(tests/_torch_pipeline_worker.py), starts them, computes what they must
give (:func:`reference`, jitted) while they run, and returns both.
"""

import jax
import jax.numpy as jnp
import numpy as np

import _torch_dp_worker as dp_worker
import _torch_pipeline_worker as worker
from pytorchhessianfree_tpu import (
    HFConfig,
    HFModelFns,
    TrainableRavel,
    init_state,
    make_hf_step,
)
from pytorchhessianfree_tpu.models import init_decoder_lm, next_token_loss
from pytorchhessianfree_tpu.models.transformer import (
    _block,
    _layernorm,
    stack_blocks,
)
from pytorchhessianfree_tpu.ops.curvature import ggnvp_fn, hvp_fn
from pytorchhessianfree_tpu.parallel.mesh import make_mesh
from pytorchhessianfree_tpu.parallel.pipeline import pipeline_blocks
from pytorchhessianfree_tpu.parallel.sharded import make_sharded_hf_step
from pytorchhessianfree_tpu_torch.convert import params_from_jax
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten

# case -> (params seed, tokens key), as tests/test_pipeline.py draws them
DRAWS = {"fwd": (0, 1), "step": (2, 3), "micro": (4, 5), "errors": (6, 7),
         "hvp": (3, 4), "sharded": (8, 9)}


def _params(seed):
    return init_decoder_lm(
        jax.random.PRNGKey(seed), vocab=16, d_model=16,
        n_layers=worker.N_LAYERS, d_ff=32, max_len=8, dtype=jnp.float64)


def _tokens(key):
    return jax.random.randint(jax.random.PRNGKey(key), (4, 8), 0, 16)


def write_problem(path, cases):
    arrays = {}
    for case in cases:
        seed, key = DRAWS[case]
        leaves, _ = tree_flatten(params_from_jax(
            jax.tree_util.tree_map(np.asarray, _params(seed)), device="cpu"))
        for i, leaf in enumerate(leaves):
            arrays[f"{case}/p{i}"] = leaf.numpy()
        arrays[f"{case}/tokens"] = np.asarray(_tokens(key))
    np.savez(path, **arrays)


def _pipelined_apply(mesh, n_microbatches=2, remat=False,
                     stage_axis="stage"):
    """tests/test_pipeline.py's ``_pipelined_apply``."""

    def block_fn(blk, h):
        return _block(blk, h, worker.N_HEADS, causal=True)

    if remat:
        block_fn = jax.checkpoint(block_fn)

    def apply(params, tokens):
        x = params["embed"][tokens] + params["pos"][:tokens.shape[1]]
        x = pipeline_blocks(stack_blocks(params["blocks"]), x, block_fn,
                            mesh, stage_axis=stage_axis,
                            n_microbatches=n_microbatches)
        return _layernorm(params["ln_f"], x) @ params["embed"].T

    return apply


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(leaf))
                           for leaf in jax.tree_util.tree_leaves(tree)])


def _ones(tree):
    return jax.tree_util.tree_map(jnp.ones_like, tree)


def _case_fwd(mesh):
    params, tokens = _params(0), _tokens(1)
    apply = _pipelined_apply(mesh)

    @jax.jit
    def values(p):
        loss, out, grad, gv = ggnvp_fn(
            lambda q: apply(q, tokens),
            lambda o: next_token_loss(o, tokens), p)
        return out, loss, grad, gv(_ones(p))

    out, loss, grad, gv = values(params)
    return {"fwd/out": np.asarray(out), "fwd/loss": np.asarray(loss),
            "fwd/grad": _flat(grad), "fwd/ggn": _flat(gv)}


def _case_hvp(mesh):
    params, tokens = _params(3), _tokens(4)
    apply = _pipelined_apply(mesh)

    @jax.jit
    def values(p):
        loss, grad, hvp = hvp_fn(
            lambda q: next_token_loss(apply(q, tokens), tokens), p)
        return loss, grad, hvp(_ones(p))

    loss, grad, hv = values(params)
    return {"hvp/loss": np.asarray(loss), "hvp/grad": _flat(grad),
            "hvp/hvp": _flat(hv)}


def _case_step(mesh):
    params, tokens = _params(2), _tokens(3)
    config = HFConfig(damping=1.0, cg_max_iter=worker.STEP_CG)
    ravel = TrainableRavel(params)
    step = make_hf_step(HFModelFns(model_fn=_pipelined_apply(mesh),
                                   loss_outer=next_token_loss),
                        config, ravel)
    p, _, st = step(params, init_state(ravel, config), (tokens, tokens))
    return {"step/params": _flat(p),
            "step/num_cg_iters": np.asarray(int(st.num_cg_iters))}


def _case_micro(mesh):
    params, tokens = _params(4), _tokens(5)
    out = {}
    for name, kw in worker.MICRO.items():
        out[f"micro/{name}"] = np.asarray(
            jax.jit(_pipelined_apply(mesh, **kw))(params, tokens))
    return out


def _case_sharded(_):
    """tests/test_pipeline.py:141-189 on a (stage 2, model 2) mesh."""
    mesh = make_mesh(4, axis_names=("stage", "model"), shape=(2, 2))
    params, tokens = _params(8), _tokens(9)
    config = HFConfig(damping=1.0, cg_max_iter=worker.SHARDED_CG)
    ravel = TrainableRavel(params, pad_to_multiple=8)
    step = make_sharded_hf_step(
        HFModelFns(model_fn=_pipelined_apply(mesh), loss_outer=next_token_loss),
        config, ravel, mesh, data_axis=None, model_axis="model")
    p, _, st = step(params, init_state(ravel, config), (tokens, tokens))
    return {"sharded/params": _flat(p),
            "sharded/num_cg_iters": np.asarray(int(st.num_cg_iters))}


CASES = {"fwd": _case_fwd, "hvp": _case_hvp, "step": _case_step,
         "micro": _case_micro, "sharded": _case_sharded}


def reference(cases):
    """The JAX package's values of ``cases``: ``{case/key: array}``."""
    out = {}
    for case in cases:
        if case in CASES:
            out.update(CASES[case](make_mesh(4, axis_names=("stage",))))
    return out



def run(tmp, cases, world=4, meanwhile=None):
    """``(the ranks' results, the JAX values)`` of ``cases`` on ``world``
    gloo ranks; with ``meanwhile``, also ``meanwhile(problem file)``,
    computed while the ranks run."""
    path = tmp / "problem.npz"
    write_problem(path, [c for c in cases if c in DRAWS])
    procs = dp_worker.spawn_script(
        worker.__file__, [str(path), str(tmp), ",".join(cases)], world)
    try:
        want = reference(cases)
        extra = () if meanwhile is None else (meanwhile(np.load(path)),)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return (dp_worker.collect(procs, tmp), want) + extra


def assert_ranks_equal(got):
    """Every rank's every result bit for bit equal to rank 0's."""
    for key in got[0]:
        for r in got[1:]:
            np.testing.assert_array_equal(r[key], got[0][key], err_msg=key)
