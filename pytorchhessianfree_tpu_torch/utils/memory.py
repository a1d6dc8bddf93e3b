"""Solver working-set estimation: what one HF step keeps live in device
memory (port of :mod:`pytorchhessianfree_tpu.utils.memory`).

The reference gives no sizing guidance (its iterate list simply grows on
one GPU, reference cg.py:187-210).  The port's dominant solver buffers are
known from ``ravel.dim`` and the configuration, so users can size batch and
``cg_max_iter`` before the first step.  Estimates cover the SOLVER's
flat-vector working set -- model activations and the autodiff residuals of
the user's network are model-specific and excluded (they scale with batch
size, not ``ravel.dim``).
"""

from __future__ import annotations

from ..config import HFConfig, float_dtype
from ..ops.cg import storing_grid
from .flatten import TrainableRavel

# Flat [n] vectors live at once during the port's CG (ops/cg.py), counted
# at its peak: the gradient g and CG's right-hand side -g, the warm start,
# the iterate x, the residual r and the direction p, the product A p, the
# fused update's fresh x' and r' beside the x and r they replace, and one
# temporary of the damped product (mvp(v) + damping v, taken while the
# previous A p is still held) or of the direction update (-y + beta p).
# The JAX package's while_loop carries six.
_CG_VECTORS = 10
# Whole [n] vectors each rank of a model axis holds beside its blocks
# (parallel/sharded.py): the gradient, kept for the line search, and in
# each matvec the gathered direction and its product before the rank
# keeps its block.
_GATHERED_VECTORS = 3


def solver_memory_bytes(
    ravel: TrainableRavel,
    config: HFConfig,
    model_axis_size: int = 1,
) -> dict:
    """Bytes of solver state live during one HF step of the port.

    Counts what the port's eager CG keeps, which is more than the JAX
    package's loop: 10 flat vectors (the JAX estimate counts 6), 11 with a
    preconditioner (its application ``y = M(r)``), because an eager update
    allocates its outputs beside its inputs and the gradient and the
    right-hand side ``-g`` are two tensors; plus the iterate grid and the
    preconditioner's diagonal and its ``(D + damping)^(-exponent)`` scale
    vector (two vectors; JAX counts one).  The grid has ``max(G, 1)`` rows
    of ``store_dtype`` (``G`` the backtracking grid's length, 1 without
    backtracking): ``store_mode`` is a no-op in the port, which never
    allocates JAX's ``"scratch"`` row.

    Args:
        ravel: the flat vector space (``ravel.dim`` entries of
            ``ravel.dtype``).
        config: the step configuration (CG iteration cap, backtracking
            grid, storage dtype, preconditioner).
        model_axis_size: ranks the CG space is split over
            (:mod:`~..parallel.sharded`).

    Returns a dict with per-buffer byte counts, ``total`` and
    ``per_device``: ``total`` on one device; over ``M > 1`` ranks each
    holds ``total // M`` of blocks plus three whole vectors of its gathers
    (the gradient, a matvec's direction and its product), which the JAX
    package's estimate does not count.
    """
    if model_axis_size < 1:
        raise ValueError(f"Invalid model_axis_size {model_axis_size}")
    n = ravel.dim
    vec_bytes = n * ravel.dtype.itemsize

    max_iter = config.cg_max_iter if config.cg_max_iter is not None else n
    if config.use_cg_backtracking:
        G = len(storing_grid(max_iter, config.cg.grid_gamma))
    else:
        G = 1  # store=(0,): the warm-start row only
    sdtype = (
        float_dtype(config.cg.store_dtype, "store_dtype")
        if config.cg.store_dtype is not None
        else ravel.dtype
    )
    rows = max(G, 1)
    grid_bytes = rows * n * sdtype.itemsize

    preconditioned = config.precond != "none"
    vectors_bytes = (_CG_VECTORS + preconditioned) * vec_bytes
    precond_bytes = 2 * vec_bytes if preconditioned else 0

    total = vectors_bytes + grid_bytes + precond_bytes
    gathered = _GATHERED_VECTORS * vec_bytes if model_axis_size > 1 else 0
    return {
        "flat_dim": n,
        "vector_bytes": vec_bytes,
        "cg_vectors_bytes": vectors_bytes,
        "iterate_grid_rows": rows,
        "iterate_grid_bytes": grid_bytes,
        "precond_diag_bytes": precond_bytes,
        "total": total,
        "per_device": total // model_axis_size + gathered,
    }


def format_solver_memory(
    ravel: TrainableRavel,
    config: HFConfig,
    model_axis_size: int = 1,
) -> str:
    """Human-readable sizing summary."""
    m = solver_memory_bytes(ravel, config, model_axis_size)
    mb = 1024.0**2

    def f(b):
        return f"{b / mb:,.1f} MB"

    lines = [
        f"flat dim {m['flat_dim']:,} ({f(m['vector_bytes'])}/vector)",
        f"CG vectors: {f(m['cg_vectors_bytes'])}",
        f"iterate grid [{m['iterate_grid_rows']} rows]: "
        f"{f(m['iterate_grid_bytes'])}",
    ]
    if m["precond_diag_bytes"]:
        lines.append(f"precond diagonal: {f(m['precond_diag_bytes'])}")
    lines.append(f"total: {f(m['total'])}")
    if model_axis_size > 1:
        lines.append(
            f"per device (model axis {model_axis_size}): "
            f"{f(m['per_device'])}"
        )
    return "\n".join(lines)
