"""The Hessian-free optimizer: functional core and stateful wrapper (port
of :mod:`pytorchhessianfree_tpu.optimizer`).

One update runs the reference's phases in order (reference
hessianfree/optimizer.py:208-363): loss and gradient -> curvature matvec
closure -> damped CG with Martens' stop and the iterate grid -> warm-start
decay -> CG backtracking -> Levenberg-Marquardt damping -> Armijo line
search -> parameter update.  PyTorch runs it eagerly: the CG loop and the
trial loops are Python loops that read one value back to the host per
iteration (a batched select mode reads one sweep back instead), and the CG
vector phase is the hand-written :func:`~.ops.cg_update.fused_cg_update`
kernel on a card.

:func:`hf_step` is a function of ``(params, state, batch)`` that returns new
tensors and leaves its inputs alone; :func:`hf_acc_step` is the same update
over datalists (:mod:`.accumulate`); :func:`make_hf_train_loop` runs steps
over a stacked batch with an optional EMA empirical-Fisher preconditioner.
:class:`HessianFree` owns the parameter tree and keeps the reference's
history lists; it also builds Nystrom sketches of the live curvature
(:meth:`HessianFree.get_nystrom_sketch`), estimates its spectrum
(:meth:`HessianFree.estimate_spectrum`) and saves and restores itself
(:mod:`.checkpoint`).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from . import accumulate as acc
from .config import HFConfig, float_dtype, precision_ctx
from .ops.cg import CG_REASON_STRINGS, cg
from .ops.curvature import (
    ggn_matvec_fn,
    ggnvp,
    ggnvp_fn,
    hvp,
    hvp_fn,
    value_and_grad,
)
from .ops.precond import (
    EMADiag,
    diag_EF,
    diag_EF_scan,
    diag_to_preconditioner,
)
from .ops.nystrom import (
    NystromSketch,
    nystrom_sketch,
    nystrom_to_preconditioner,
)
from .ops.select import cg_efficient_backtracking, simple_linesearch
from .ops.spectrum import normalized_probes, ritz, slq
from .parallel import collectives
from .utils.flatten import TrainableRavel, tree_flatten, tree_map
from .utils.remat import checkpoint


class HFState(NamedTuple):
    """Cross-step optimizer state: CG warm start and live damping."""

    x0: torch.Tensor  # [dim] CG warm start (decayed previous solution)
    damping: torch.Tensor  # 0-dim, live (LM-adapted) damping
    step_count: torch.Tensor  # 0-dim int64


class HFStats(NamedTuple):
    """Per-step record.  Tensors stay on the device; the CG counts and the
    flags that the host already read are Python values."""

    init_loss: torch.Tensor
    final_loss: torch.Tensor
    damping: torch.Tensor  # damping used for this step's CG solve
    new_damping: torch.Tensor  # damping after LM adaptation
    rho: torch.Tensor  # LM reduction ratio (NaN if adaptation disabled)
    cg_reason: int  # see ops.cg.CG_REASON_STRINGS
    num_cg_iters: int
    best_cg_iter: int  # chosen backtracking iterate
    lr: torch.Tensor  # step size actually applied
    nonpos_curvature: torch.Tensor  # bool
    rho_negative: torch.Tensor  # bool
    linesearch_failed: bool
    not_descent_direction: bool
    # HFDetail when config.rich_stats, else None: the data behind the
    # reference's per-CG-iteration lines, backtracking table and line-search
    # trace (reference cg.py:202-203, cg_backtracking.py:100-110,
    # linesearch.py:57-102)
    detail: Any = None


class HFDetail(NamedTuple):
    """Per-phase solver trace (``HFConfig.rich_stats=True``), on the
    device, NaN in slots never evaluated; valid entries of ``m_hist`` are
    ``0..num_cg_iters``."""

    m_hist: torch.Tensor  # [cg_max_iter + 1] quadratic values m(x_i)
    cand_iters: torch.Tensor  # [G+1] CG iteration per candidate (last=final)
    bt_f: torch.Tensor  # [G+1] backtracking losses (NaN = not evaluated)
    ls_alphas: torch.Tensor  # [ls_max_iter] trial step sizes (NaN = not tried)
    ls_f: torch.Tensor  # [ls_max_iter] losses at the trials


class HFModelFns(NamedTuple):
    """User model and loss callables.

    - split form (required for GGN): ``model_fn(params, inputs) -> outputs``
      and ``loss_outer(outputs, targets) -> scalar``; the batch is an
      ``(inputs, targets)`` tuple;
    - direct form (Hessian only): ``loss_fn(params, batch) -> scalar``.

    ``loss_reg(params) -> scalar`` is an optional parameter-only term folded
    into every loss evaluation and the gradient; the GGN flows through the
    model outputs only and does not see it.
    """

    model_fn: Optional[Callable[[Any, Any], Any]] = None
    loss_outer: Optional[Callable[[Any, Any], torch.Tensor]] = None
    loss_fn: Optional[Callable[[Any, Any], torch.Tensor]] = None
    loss_reg: Optional[Callable[[Any], torch.Tensor]] = None

    def data_loss(self, params, batch):
        """Loss without the parameter-only regularizer."""
        if self.loss_fn is not None:
            return self.loss_fn(params, batch)
        inputs, targets = batch
        return self.loss_outer(self.model_fn(params, inputs), targets)

    def full_loss(self, params, batch):
        loss = self.data_loss(params, batch)
        if self.loss_reg is not None:
            loss = loss + self.loss_reg(params)
        return loss


def init_state(
    ravel: TrainableRavel, config: HFConfig, dtype=None
) -> HFState:
    """Fresh state: zero warm start and the configured initial damping."""
    dtype = dtype or ravel.dtype
    return HFState(
        x0=torch.zeros(ravel.dim, dtype=dtype, device=ravel.device),
        damping=torch.tensor(config.damping, dtype=dtype, device=ravel.device),
        step_count=torch.zeros((), dtype=torch.int64, device=ravel.device),
    )


def _adapt_damping(config: HFConfig, damping, f_0, f_step, m_0, m_step):
    """Levenberg-Marquardt heuristic (reference optimizer.py:464-506):
    ``rho = (f_step - f_0) / (m_step - m_0)``; damping x 3/2 if
    ``rho < 1/4``, x 2/3 if ``rho > 3/4``.  ``f_0`` is the loss at the CG
    warm start."""
    rho = (f_step - f_0) / (m_step - m_0)
    factor = torch.where(
        rho < 0.25,
        damping.new_tensor(3.0 / 2.0),
        torch.where(
            rho > 0.75, damping.new_tensor(2.0 / 3.0), damping.new_tensor(1.0)
        ),
    )
    return rho, damping * factor


def _step_core(
    config: HFConfig,
    ravel: TrainableRavel,
    params: Any,
    state: HFState,
    *,
    init_loss: torch.Tensor,
    grad_vec: torch.Tensor,
    mvp_vec: Callable[[torch.Tensor], torch.Tensor],
    loss_at: Callable[[torch.Tensor], torch.Tensor],
    M: Optional[Callable[[torch.Tensor], torch.Tensor]],
    shard_vec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    shard_buf: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[Any, HFState, HFStats]:
    """Solve, select and update on flat vectors, in the reference's phase
    order.  ``loss_at(delta)`` is the loss at ``params + delta``.

    With a hook that keeps a rank's block and can ``gather`` the blocks
    back (:class:`~.parallel.sharded.ModelShard`), CG runs on the rank's
    blocks of every vector and of the iterate grid (``ops.cg``): the
    gradient enters as its block, each matvec gathers its direction,
    applies ``mvp_vec`` to the whole vector and keeps its block, and every
    trial loss gathers its step.  The chosen step is gathered once; the
    line search and the update run on whole vectors, alike on every
    rank."""
    damping = state.damping
    sv = shard_vec if shard_vec is not None else (lambda v: v)
    gather = getattr(shard_vec, "gather", None)
    grad_full, loss_full = grad_vec, loss_at
    if gather is not None:
        whole_mvp = mvp_vec

        def mvp_vec(v):
            return sv(whole_mvp(gather(v)))

        loss_at = _gathered(loss_at, gather)
    grad_vec = sv(grad_vec)

    def A(v):
        return mvp_vec(v) + damping * v

    # store only the start unless backtracking wants the grid
    # (reference optimizer.py:260-262)
    store = None if config.use_cg_backtracking else (0,)
    cgres = cg(
        A,
        -grad_vec,
        x0=state.x0,
        M=M,
        max_iter=(
            config.cg_max_iter if config.cg_max_iter is not None else ravel.dim
        ),
        tol=config.cg.tol,
        atol=config.cg.atol,
        martens_conv_crit=True,
        store_x_at_iters=store,
        grid_gamma=config.cg.grid_gamma,
        martens_threshold=config.cg.martens_threshold,
        martens_min_window=config.cg.martens_min_window,
        nonpos_curv_option=config.cg.nonpos_curv_option,
        store_dtype=config.cg.store_dtype,
        buffer_layout=config.cg.buffer_layout,
        store_mode=config.cg.store_mode,
        shard_vec=shard_vec,
        shard_buf=shard_buf,
    )

    # warm start for the next step: the decayed FINAL iterate
    new_x0 = grad_vec.new_tensor(config.cg_decay_x0) * cgres.x

    nan = grad_vec.new_tensor(float("nan"))
    G1 = len(cgres.stored_iters) + 1
    bt_f = ls_alphas = ls_f = None  # the rich_stats records
    if config.use_cg_backtracking:
        bt = cg_efficient_backtracking(
            loss_at, cgres, mode=config.backtracking_mode
        )
        step_vec, best_cg_iter, f_at_final = bt.step, bt.best_iter, bt.f_final
        bt_f = bt.f_vals
    else:
        step_vec, best_cg_iter, f_at_final = cgres.x, cgres.num_iters, None

    if config.adapt_damping:
        f_0 = loss_at(state.x0)  # loss at the warm start
        if f_at_final is None:
            f_at_final = loss_at(cgres.x)
            # the final iterate's slot, as the JAX package records it
            bt_f = torch.cat([nan.expand(G1 - 1), f_at_final[None]])

    if gather is not None:
        step_vec = gather(step_vec)
    if config.use_linesearch:
        ls = simple_linesearch(
            loss_full,
            grad_full,
            step_vec,
            f_0=init_loss,
            init_alpha=config.lr,
            beta=config.linesearch.beta,
            c=config.linesearch.c,
            max_iter=config.linesearch.max_iter,
            mode=config.linesearch.mode,
            batch_chunk=config.linesearch.batch_chunk,
        )
        lr, final_loss = ls.alpha, ls.f_alpha
        ls_failed, not_descent = ls.failed, ls.not_descent
        ls_alphas, ls_f = ls.alphas, ls.f_trace
    else:
        lr = grad_vec.new_tensor(config.lr)
        final_loss = (
            loss_full(lr * step_vec) if config.compute_final_loss else nan
        )
        ls_failed, not_descent = False, False

    if config.adapt_damping:
        rho, new_damping = _adapt_damping(
            config, damping, f_0, f_at_final, cgres.m_hist[0], cgres.m_final
        )
        rho_negative = rho < 0
    else:
        rho, new_damping = nan, damping
        rho_negative = torch.zeros((), dtype=torch.bool, device=grad_vec.device)

    new_params = ravel.add(params, lr * step_vec)

    detail = None
    if config.rich_stats:
        empty = grad_vec.new_zeros(0)
        detail = HFDetail(
            m_hist=cgres.m_hist,
            cand_iters=torch.tensor(
                cgres.stored_iters + (cgres.num_iters,), device=grad_vec.device
            ),
            bt_f=nan.expand(G1).clone() if bt_f is None else bt_f,
            ls_alphas=empty if ls_alphas is None else ls_alphas,
            ls_f=empty if ls_f is None else ls_f,
        )

    new_state = HFState(
        x0=new_x0, damping=new_damping, step_count=state.step_count + 1
    )
    stats = HFStats(
        init_loss=init_loss,
        final_loss=final_loss,
        damping=damping,
        new_damping=new_damping,
        rho=rho,
        cg_reason=cgres.reason,
        num_cg_iters=cgres.num_iters,
        best_cg_iter=best_cg_iter,
        lr=lr,
        nonpos_curvature=cgres.nonpos_pAp,
        rho_negative=rho_negative,
        linesearch_failed=ls_failed,
        not_descent_direction=not_descent,
        detail=detail,
    )
    return new_params, new_state, stats


def _gathered(loss_at, gather):
    """``loss_at`` of whole steps as a function of a rank's blocks: each
    trial gathers its step, and a batched sweep gathers its rows."""

    def at(delta):
        return loss_at(gather(delta))

    whole_sweep = getattr(loss_at, "sweep", None)

    def sweep(deltas):
        deltas = gather(deltas)
        if whole_sweep is None:
            return torch.func.vmap(loss_at)(deltas)
        return whole_sweep(deltas)

    at.sweep = sweep
    return at


def _maybe_remat(fns: HFModelFns, config: HFConfig) -> HFModelFns:
    """Apply ``config.remat``: checkpoint the model forward (resp.
    ``loss_fn``) so that derivatives recompute its activations instead of
    storing them."""
    if not config.remat:
        return fns
    if fns.loss_fn is not None:
        fns = fns._replace(loss_fn=checkpoint(fns.loss_fn))
    if fns.model_fn is not None:
        fns = fns._replace(model_fn=checkpoint(fns.model_fn))
    return fns


def _cast_floating(tree, dtype):
    """Cast the floating-point tensor leaves of ``tree`` to ``dtype``;
    integer leaves (tokens, labels) and other leaves pass through."""
    return tree_map(
        lambda a: a.to(dtype)
        if isinstance(a, torch.Tensor) and a.is_floating_point()
        else a,
        tree,
    )


def _curvature_dtype(config: HFConfig) -> Optional[torch.dtype]:
    if config.curvature_dtype is None:
        return None
    return float_dtype(config.curvature_dtype, "curvature_dtype")


def _build_matvec_and_grad(
    fns: HFModelFns, config: HFConfig, ravel: TrainableRavel, params, batch,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Loss, flat gradient and flat (undamped) curvature matvec for one
    batch.  The GGN path linearizes the model once per batch; the Hessian
    path linearizes ``(grad, value)`` of the loss once per batch.

    ``reduce`` (the data-parallel steps' ``all_reduce``; see
    :func:`_reduce_then_regularize`) combines the data term's loss,
    gradient and each matvec product across ranks, outside every
    transform, before the regularizer is added.

    ``config.curvature_dtype`` (e.g. ``"bfloat16"``): the matvec runs
    through a cast of the parameters and of the floating leaves of the
    batch (integer tokens stay integers); the model outputs (resp. the
    Hessian path's loss) are cast back to the parameter dtype, each tangent
    is cast to the curvature dtype and each product is raveled in the
    parameter dtype.  The loss and the gradient stay full precision (one
    ``vjp``; the curvature-dtype matvec is built without a loss or gradient
    of its own), and no CG vector is ever in the curvature dtype.

    ``config.remat``: the model forward (resp. ``loss_fn``) is wrapped in
    :func:`~.utils.remat.checkpoint`, and every matvec is the one-shot
    ``ggnvp`` / ``hvp``, which recomputes the forward instead of replaying a
    linearization that would store every activation.  The numbers are the
    same."""
    fns = _maybe_remat(fns, config)
    reg = fns.loss_reg
    if reduce is not None or config.curvature_opt == "ggn":
        # added after the data term (and its reduction), once
        fns = fns._replace(loss_reg=None)
    else:
        reg = None  # the Hessian of ``full_loss`` holds it
    cdtype = _curvature_dtype(config)
    derived = cdtype is not None or config.remat

    def cast(tree):
        return tree if cdtype is None else _cast_floating(tree, cdtype)

    if config.curvature_opt == "ggn":
        if fns.model_fn is None or fns.loss_outer is None:
            raise ValueError(
                "curvature_opt='ggn' needs the split form: model_fn + "
                "loss_outer (the GGN is defined through the model outputs, "
                "reference optimizer.py:152-154)."
            )
        inputs, targets = batch

        def outer(out):
            return fns.loss_outer(out, targets)

        if not derived:
            loss, _outputs, grad_tree, mvp_tree = ggnvp_fn(
                lambda p: fns.model_fn(p, inputs), outer, params
            )
        else:
            loss, grad_tree = value_and_grad(
                lambda p: outer(fns.model_fn(p, inputs)), params
            )
            lp_inputs, lp_params = cast(inputs), cast(params)

            def lp_model_at(p):
                # outputs back in the parameter dtype: the loss Hessian
                # stays full precision
                out = fns.model_fn(p, lp_inputs)
                return out if cdtype is None else _cast_floating(
                    out, ravel.dtype
                )

            if config.remat:
                def mvp_tree(v):
                    return ggnvp(lp_model_at, outer, lp_params, v)
            else:
                mvp_tree = ggn_matvec_fn(lp_model_at, outer, lp_params)[2]
    else:
        if not derived:
            loss, grad_tree, mvp_tree = hvp_fn(
                lambda p: fns.full_loss(p, batch), params
            )
        else:
            loss, grad_tree = value_and_grad(
                lambda p: fns.full_loss(p, batch), params
            )
            lp_batch, lp_params = cast(batch), cast(params)

            def lp_loss_of(p):
                return fns.full_loss(p, lp_batch).to(ravel.dtype)

            if config.remat:
                def mvp_tree(v):
                    return hvp(lp_loss_of, lp_params, v)
            else:
                mvp_tree = hvp_fn(lp_loss_of, lp_params)[2]

    def mvp_vec(v):
        return ravel.ravel(mvp_tree(cast(ravel.unravel(v))))

    return _reduce_then_regularize(
        config, ravel, params, loss, ravel.ravel(grad_tree), mvp_vec, reg,
        reduce,
    )


def _reduce_then_regularize(config, ravel, params, loss, grad_vec, mvp_vec,
                            reg, reduce):
    """The data term's loss, flat gradient and matvec, each combined across
    ranks by ``reduce`` when it is given, plus the regularizer ``reg`` when
    it is given.  ``reg`` depends only on the parameters, alike on every
    rank, so it is added after the reduction and counts once: in the loss
    and the gradient, and in the matvec for the Hessian (the GGN, defined
    through the model outputs, holds none of it)."""
    if reduce is not None:
        loss, grad_vec = reduce(loss), reduce(grad_vec)
    if reg is None and reduce is None:
        return loss, grad_vec, mvp_vec
    reg_mvp = None
    if reg is not None:
        reg_val, reg_grad = value_and_grad(reg, params)
        loss = loss + reg_val
        grad_vec = grad_vec + ravel.ravel(reg_grad)
        if config.curvature_opt == "hessian":
            reg_mvp = hvp_fn(reg, params)[2]

    def full_mvp(v):
        out = mvp_vec(v) if reduce is None else reduce(mvp_vec(v))
        if reg_mvp is not None:
            out = out + ravel.ravel(reg_mvp(ravel.unravel(v)))
        return out

    return loss, grad_vec, full_mvp


def hf_step(
    params: Any,
    state: HFState,
    batch: Any,
    *,
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    precond_diag: Optional[torch.Tensor] = None,
    precond_exponent: float = 0.75,
    precond_lowrank: Any = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    grad_vec: Optional[torch.Tensor] = None,
    mvp_vec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    shard_vec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    shard_buf: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[Any, HFState, HFStats]:
    """One Hessian-free update (reference optimizer.py:126-363).

    ``M`` is an optional preconditioner matvec on flat vectors.  Without
    it, ``precond_diag`` (an empirical-Fisher diagonal) gives Martens'
    ``(D + damping)^(-precond_exponent)`` with the *live* damping;
    ``precond_lowrank`` (a :class:`~.ops.nystrom.NystromSketch`) gives the
    low-rank ``(A + damping I)^{-1}`` approximation, also with the live
    damping; without any, ``config.precond="diag_ef"`` computes the
    diagonal from this step's batch and uses ``config.precond_exponent``.
    Custom
    ``grad_vec`` / ``mvp_vec`` override the derived gradient and curvature
    matvec.  ``config.matmul_precision`` sets the TF32 switches for the
    whole step.  ``shard_vec`` / ``shard_buf``: the hooks that
    :mod:`.parallel.sharded` passes to run CG on a rank's blocks
    (:func:`_step_core`); ``state.x0`` is then the rank's block.
    """
    return _hf_step(
        params, state, batch, fns=fns, config=config, ravel=ravel,
        precond_diag=precond_diag, precond_exponent=precond_exponent,
        precond_lowrank=precond_lowrank, M=M, grad_vec=grad_vec,
        mvp_vec=mvp_vec, shard_vec=shard_vec, shard_buf=shard_buf,
    )


def _hf_step(
    params, state, batch, *, fns, config, ravel, precond_diag=None,
    precond_exponent=0.75, precond_lowrank=None, M=None, grad_vec=None,
    mvp_vec=None, reduce=None, shard_vec=None, shard_buf=None,
):
    """:func:`hf_step`; with ``reduce``, each rank's data term of the loss,
    the gradient, the matvec, the trial losses and an in-step diagonal is
    combined across the ranks (:mod:`.parallel.data_parallel`)."""
    with precision_ctx(config):
        loss, derived_grad, derived_mvp = _build_matvec_and_grad(
            fns, config, ravel, params, batch, reduce
        )

        sv = shard_vec if shard_vec is not None else (lambda v: v)
        if M is None and precond_diag is not None:
            M = diag_to_preconditioner(
                sv(precond_diag), state.damping, precond_exponent
            )
        elif M is None and precond_lowrank is not None:
            M = nystrom_to_preconditioner(precond_lowrank, state.damping)
        elif M is None and config.precond == "diag_ef":
            if fns.model_fn is None:
                raise ValueError(
                    "precond='diag_ef' requires the split model form "
                    "(per-sample gradients need model_fn + loss_outer)."
                )
            inputs, targets = batch
            diag = _diag(fns, params, inputs, targets,
                         config.precond_reduction, ravel, reduce)
            M = diag_to_preconditioner(
                sv(diag), state.damping, config.precond_exponent
            )

        data_fns, reg = _split_reg(fns, reduce)
        return _step_core(
            config,
            ravel,
            params,
            state,
            init_loss=loss,
            grad_vec=derived_grad if grad_vec is None else grad_vec,
            mvp_vec=derived_mvp if mvp_vec is None else mvp_vec,
            loss_at=_loss_at(lambda p: data_fns.full_loss(p, batch), reg,
                             ravel, params, reduce),
            M=M,
            shard_vec=shard_vec,
            shard_buf=shard_buf,
        )


def _split_reg(fns: HFModelFns, reduce):
    """``(fns, None)``, or with ``reduce``, ``fns`` without its regularizer
    and the regularizer apart, to add after the reduction."""
    if reduce is None:
        return fns, None
    return fns._replace(loss_reg=None), fns.loss_reg


def _loss_at(data_at, reg, ravel: TrainableRavel, params, reduce=None):
    """``loss_at(delta)``: ``data_at(params + delta)``, combined across
    ranks by ``reduce`` when it is given, plus ``reg`` at the same point
    when it is given.  With ``reduce`` it carries the ``sweep`` of
    :mod:`.ops.select`, which reduces the vector of trial losses after the
    ``vmap`` (no collective runs inside one)."""

    def loss_at(delta):
        p = ravel.add(params, delta)
        loss = data_at(p) if reduce is None else reduce(data_at(p))
        return loss if reg is None else loss + reg(p)

    if reduce is not None:
        def sweep(deltas):
            losses = reduce(torch.func.vmap(
                lambda d: data_at(ravel.add(params, d)))(deltas))
            if reg is not None:
                losses = losses + torch.func.vmap(
                    lambda d: reg(ravel.add(params, d)))(deltas)
            return losses

        loss_at.sweep = sweep
    return loss_at


def _diag(fns, params, inputs, targets, reduction, ravel, reduce=None,
          diag=diag_EF):
    """The empirical-Fisher diagonal through ``diag`` (``diag_EF`` or
    ``diag_EF_scan``).  With ``reduce``, of every rank's rows (equal
    shares): each rank sums its rows' squares, ``reduce.sum`` adds the
    partial sums, and ``"mean"`` divides by the global row count.  Each
    per-sample gradient sees its sample alone, with no batch statistics
    across the ranks (:func:`~.parallel.collectives.local_batch`), as a
    ``vmap`` over samples gives each a batch of one in the JAX package."""
    if reduce is None:
        return diag(fns.model_fn, fns.loss_outer, params, inputs, targets,
                    reduction, ravel, loss_reg=fns.loss_reg)
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction {reduction} is not supported.")
    with collectives.local_batch():
        d = reduce.sum(diag(fns.model_fn, fns.loss_outer, params, inputs,
                            targets, "sum", ravel, loss_reg=fns.loss_reg))
    if reduction == "mean":
        d = d / (tree_flatten(inputs)[0][0].shape[0] * reduce.size)
    return d


def precond_arg(precond_diag, ravel: TrainableRavel):
    """An optional preconditioner diagonal in the step builders' calling
    convention: ``(diag, True)``, or ``(zeros(1), False)`` for ``None``.
    The JAX package needs the flag because ``jit`` cannot take an optional
    array operand; the port keeps the convention so that the data-parallel
    steps read the same way."""
    if precond_diag is None:
        return torch.zeros(1, dtype=ravel.dtype, device=ravel.device), False
    return precond_diag, True


def make_hf_step(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    precond_exponent: float = 0.75,
    donate: bool = False,
):
    """``step(params, state, batch, precond_diag=None, precond_lowrank=None)
    -> (params, state, stats)``: the counterpart of the JAX package's jitted
    step (PyTorch runs it eagerly).  ``donate`` is accepted and ignored:
    the eager step already returns new tensors and leaves its inputs to
    the caller, so there is no buffer to donate."""

    def step(params, state, batch, precond_diag=None, precond_lowrank=None):
        if precond_diag is not None and precond_lowrank is not None:
            raise ValueError(
                "Pass either precond_diag or precond_lowrank, not both."
            )
        return hf_step(
            params, state, batch, fns=fns, config=config, ravel=ravel,
            precond_diag=precond_diag, precond_exponent=precond_exponent,
            precond_lowrank=precond_lowrank,
        )

    return step


def _stack_stats(per_step) -> HFStats:
    """Per-step :class:`HFStats` -> one whose fields have a leading steps
    axis, :class:`HFDetail` included (as the JAX package's scan stacks
    it).  Fields that the host already read (CG counts, flags) become CPU
    tensors."""
    fields = {}
    for name in HFStats._fields:
        values = [getattr(s, name) for s in per_step]
        if name == "detail":
            fields[name] = None if values[0] is None else HFDetail(
                *(torch.stack(f) for f in zip(*values))
            )
        elif isinstance(values[0], torch.Tensor):
            fields[name] = torch.stack(values)
        else:
            fields[name] = torch.tensor(values)
    return HFStats(**fields)


def make_hf_train_loop(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    precond_exponent: float = 0.75,
    donate: bool = False,
    precond_ema_decay: Optional[float] = None,
):
    """Steps over a stacked batch: ``loop(params, state, batches)`` runs one
    :func:`hf_step` per slice of the leading steps axis of ``batches``
    (leaves ``[T, N, ...]``) and returns ``(params, state, stats)`` with
    stacked :class:`HFStats`.  The JAX package's ``lax.scan`` program is a
    Python loop here.

    ``precond_ema_decay``: keep an exponential moving average of each
    step's empirical-Fisher diagonal and precondition every CG solve with
    it (split model form only).  The loop then takes and returns the EMA,
    an :class:`EMADiag`, ``loop(params, state, batches, ema=None) ->
    (params, state, stats, ema)``, so it carries across calls; ``None``
    starts a fresh ``EMADiag(precond_ema_decay)``.  An EMA is seeded by its
    first diagonal, not by ``step_count``, so a loop resumed from a
    checkpoint seeds a fresh EMA with its first diagonal.  ``donate`` is
    accepted and ignored, as in :func:`make_hf_step`.
    """
    return _train_loop(fns, config, ravel, precond_exponent,
                       precond_ema_decay)


def _train_loop(fns, config, ravel, precond_exponent, precond_ema_decay,
                reduce=None):
    """:func:`make_hf_train_loop`; with ``reduce``, every step and every
    EMA diagonal combined across the ranks, as in :func:`_hf_step`."""
    if precond_ema_decay is not None:
        if not 0.0 <= precond_ema_decay < 1.0:
            raise ValueError(f"Invalid decay {precond_ema_decay}")
        if fns.model_fn is None or fns.loss_outer is None:
            raise ValueError(
                "precond_ema_decay requires the split model form "
                "(per-sample gradients need model_fn + loss_outer)."
            )
    use_ema = precond_ema_decay is not None

    def loop(params, state, batches, ema=None):
        if use_ema and ema is None:
            ema = EMADiag(precond_ema_decay)
        num_steps = tree_flatten(batches)[0][0].shape[0]
        per_step = []
        for i in range(num_steps):
            batch = tree_map(lambda a: a[i], batches)
            precond_diag = None
            if use_ema:
                inputs, targets = batch
                with precision_ctx(config):
                    d = _diag(fns, params, inputs, targets,
                              config.precond_reduction, ravel, reduce)
                precond_diag = ema.update(d)
            params, state, stats = _hf_step(
                params, state, batch, fns=fns, config=config, ravel=ravel,
                precond_diag=precond_diag, precond_exponent=precond_exponent,
                reduce=reduce,
            )
            per_step.append(stats)
        stats = _stack_stats(per_step)
        if use_ema:
            return params, state, stats, ema
        return params, state, stats

    return loop


def hf_acc_step(
    params: Any,
    state: HFState,
    *,
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    loss_data,
    grad_data=None,
    mvp_data=None,
    reduction: str = "mean",
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    precond_diag: Optional[torch.Tensor] = None,
    precond_exponent: float = 0.75,
    mvp_amortize: bool = False,
    shard_vec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    shard_buf: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[Any, HFState, HFStats]:
    """Accumulated Hessian-free update (reference optimizer.py:519-606).

    Loss, gradient and curvature matvec are accumulated over their own
    datalists (``grad_data`` and ``mvp_data`` default to ``loss_data``)
    with the weighted-sum semantics of :mod:`.accumulate`.  Every CG
    iteration forms the curvature products chunk by chunk, as the
    reference does; ``mvp_amortize=True`` (GGN, stacked data) linearizes
    once per step instead.  ``config.matmul_precision`` applies to the
    whole step.  ``config.remat`` checkpoints the model forward (resp.
    ``loss_fn``) for every evaluation of the step; ``config.curvature_dtype``
    is ignored here, as in the JAX package: the accumulated matvec runs in
    the parameter dtype.  ``shard_vec`` / ``shard_buf`` are
    :func:`hf_step`'s.
    """
    return _hf_acc_step(
        params, state, fns=fns, config=config, ravel=ravel,
        loss_data=loss_data, grad_data=grad_data, mvp_data=mvp_data,
        reduction=reduction, M=M, precond_diag=precond_diag,
        precond_exponent=precond_exponent, mvp_amortize=mvp_amortize,
        shard_vec=shard_vec, shard_buf=shard_buf,
    )


def _hf_acc_step(params, state, *, fns, config, ravel, loss_data,
                 grad_data=None, mvp_data=None, reduction="mean", M=None,
                 precond_diag=None, precond_exponent=0.75,
                 mvp_amortize=False, reduce=None, shard_vec=None,
                 shard_buf=None):
    """:func:`hf_acc_step`; with ``reduce``, each rank accumulates its
    chunks, and one reduction follows each chunk sum (loss, gradient,
    every matvec, the trial losses), as in :func:`_hf_step`."""
    if config.precond == "diag_ef":
        raise ValueError(
            "precond='diag_ef' (in-step diagonal from the step's own batch) "
            "is a single-batch feature; for accumulated steps compute the "
            "diagonal explicitly (diag_EF / EMADiag) and pass precond_diag."
        )
    if grad_data is None:
        grad_data = loss_data
    if mvp_data is None:
        mvp_data = loss_data

    with precision_ctx(config):
        init_loss, grad_vec, mvp_vec, loss_at = _acc_parts(
            fns, config, ravel, params, loss_data, grad_data, mvp_data,
            reduction, mvp_amortize, reduce,
        )
        if M is None and precond_diag is not None:
            if shard_vec is not None:
                precond_diag = shard_vec(precond_diag)
            M = diag_to_preconditioner(
                precond_diag, state.damping, precond_exponent
            )

        return _step_core(
            config,
            ravel,
            params,
            state,
            init_loss=init_loss,
            grad_vec=grad_vec,
            mvp_vec=mvp_vec,
            loss_at=loss_at,
            M=M,
            shard_vec=shard_vec,
            shard_buf=shard_buf,
        )


def _acc_parts(fns, config, ravel, params, loss_data, grad_data, mvp_data,
               reduction, mvp_amortize=False, reduce=None):
    """:func:`_hf_acc_step`'s loss, flat gradient, matvec and ``loss_at``
    over the datalists (with ``reduce``, this rank's chunks)."""
    fns, reg = _split_reg(_maybe_remat(fns, config), reduce)
    init_loss, grad_vec, mvp_vec = _reduce_then_regularize(
        config, ravel, params,
        acc.acc_loss(fns, params, loss_data, reduction),
        acc.acc_grad(fns, params, grad_data, reduction, ravel),
        acc.make_acc_mvp(fns, config, params, mvp_data, reduction, ravel,
                         amortize=mvp_amortize),
        reg, reduce,
    )
    loss_at = _loss_at(lambda p: acc.acc_loss(fns, p, loss_data, reduction),
                       reg, ravel, params, reduce)
    return init_loss, grad_vec, mvp_vec, loss_at


def make_hf_acc_step(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    reduction: str = "mean",
    precond_exponent: float = 0.75,
    mvp_amortize: bool = False,
):
    """``step(params, state, loss_data, grad_data=None, mvp_data=None,
    precond_diag=None) -> (params, state, stats)``."""

    def step(params, state, loss_data, grad_data=None, mvp_data=None,
             precond_diag=None):
        return hf_acc_step(
            params, state, fns=fns, config=config, ravel=ravel,
            loss_data=loss_data, grad_data=grad_data, mvp_data=mvp_data,
            reduction=reduction, precond_diag=precond_diag,
            precond_exponent=precond_exponent, mvp_amortize=mvp_amortize,
        )

    return step


def format_rich_stats(stats: HFStats) -> str:
    """Pretty-print an ``HFStats.detail`` record in the reference's verbose
    style: per-CG-iteration m-values (reference cg.py:202-203), the
    backtracking table (reference cg_backtracking.py:100-110) and the
    line-search trace (reference linesearch.py:57-102).  The same text as
    the JAX package's ``format_rich_stats`` for the same numbers."""
    import numpy as np

    def host(t):
        return np.asarray(t.detach().cpu())

    d = stats.detail
    if d is None:
        return "(no detail recorded -- set HFConfig.rich_stats=True)"
    out = []
    num = int(stats.num_cg_iters)
    m = host(d.m_hist)
    out.append(f"CG m-history ({num} iterations):")
    for i in range(num + 1):
        out.append(f"  cg-iter {i:4d}  m = {m[i]: .9e}")

    out.append("Backtracking (reverse walk, NaN = skipped by early exit):")
    cand = host(d.cand_iters)
    bt = host(d.bt_f)
    best = int(stats.best_cg_iter)
    for j in range(len(cand) - 1, -1, -1):
        if j < len(cand) - 1 and cand[j] >= cand[-1]:
            continue  # buffer rows at/past the final iterate (never reached)
        chosen = int(cand[j]) == best and not np.isnan(bt[j])
        tag = " <-- chosen" if chosen else ""
        fstr = "   (skipped)" if np.isnan(bt[j]) else f"f = {bt[j]: .9e}"
        out.append(f"  cg-iter {int(cand[j]):4d}  {fstr}{tag}")

    if d.ls_alphas.shape[0]:
        out.append("Line search (Armijo):")
        al = host(d.ls_alphas)
        fl = host(d.ls_f)
        for i in range(len(al)):
            if np.isnan(al[i]) and np.isnan(fl[i]):
                continue
            mark = " <-- accepted" if al[i] == float(stats.lr) else ""
            out.append(f"  alpha = {al[i]:.6f}  f = {fl[i]: .9e}{mark}")
        if bool(stats.linesearch_failed):
            out.append("  no alpha accepted -> alpha = 0 (no update)")
    return "\n".join(out)


# -- debug self-tests (reference optimizer.py:365-448, :817-926) -------------


def _random_vector(ravel: TrainableRavel, generator: Optional[torch.Generator]):
    """A standard-normal flat vector drawn on the generator's device (seed 0
    if none is given) and moved to the ravel's device, so the same seed
    gives the same vector on every device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v = torch.randn(ravel.dim, generator=generator, device=generator.device,
                    dtype=ravel.dtype)
    return v.to(ravel.device)


def check_deterministic(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    params: Any,
    batch: Any,
    generator: Optional[torch.Generator] = None,
    fns_factory: Optional[Callable[[torch.Generator], HFModelFns]] = None,
    batch_factory: Optional[Callable[[], Any]] = None,
) -> dict:
    """Look for randomness that would break CG's fixed quadratic model
    (reference optimizer.py:365-448); returns a dict of booleans.

    - ``forward_deterministic`` / ``outputs_deterministic``: two
      evaluations of the loss and of the model agree;
    - ``mvp_deterministic``: two curvature matvecs of one random vector
      (drawn from ``generator``, seed 0 by default) agree;
    - ``rng_invariant`` (with ``fns_factory(generator) -> HFModelFns``):
      the fns built from two generators give the same loss.  A model whose
      loss depends on its generator must fix it for a whole step (as
      :func:`~.models.mlp.mlp_dropout_apply` does with a seed in the
      batch) or turn dropout off;
    - ``data_reproducible`` (with ``batch_factory() -> batch``): two calls
      give equal batches leaf by leaf.
    """
    results = {}
    loss1 = fns.full_loss(params, batch)
    loss2 = fns.full_loss(params, batch)
    results["forward_deterministic"] = bool(torch.allclose(loss1, loss2))
    if fns.model_fn is not None:
        inputs, _ = batch
        out1 = tree_flatten(fns.model_fn(params, inputs))[0]
        out2 = tree_flatten(fns.model_fn(params, inputs))[0]
        results["outputs_deterministic"] = all(
            bool(torch.allclose(a, b)) for a, b in zip(out1, out2)
        )

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v = _random_vector(ravel, generator)
    with precision_ctx(config):
        _, _, mvp = _build_matvec_and_grad(fns, config, ravel, params, batch)
        results["mvp_deterministic"] = bool(torch.allclose(mvp(v), mvp(v)))

    if fns_factory is not None:
        seeds = torch.randint(2**62, (2,), generator=generator,
                              device=generator.device).tolist()
        la, lb = (
            fns_factory(
                torch.Generator(device=generator.device).manual_seed(s)
            ).full_loss(params, batch)
            for s in seeds
        )
        results["rng_invariant"] = bool(torch.allclose(la, lb))

    if batch_factory is not None:
        leaves1 = tree_flatten(batch_factory())[0]
        leaves2 = tree_flatten(batch_factory())[0]

        def leaves_equal(a, b):
            # leaves may be plain Python scalars
            a, b = torch.as_tensor(a), torch.as_tensor(b)
            return a.shape == b.shape and bool(torch.allclose(a, b))

        results["data_reproducible"] = len(leaves1) == len(leaves2) and all(
            leaves_equal(a, b) for a, b in zip(leaves1, leaves2)
        )
    return results


def check_reduction(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    params: Any,
    datalist,
    reduction: str,
    rtol: float = 1e-2,
    atol: float = 1e-4,
    generator: Optional[torch.Generator] = None,
) -> None:
    """Check the loss's declared reduction ("mean" or "sum") (reference
    optimizer.py:817-926): loss, gradient and matvec accumulated over the
    datalist (two chunks or more) must match the same quantities on the
    concatenated batch within ``rtol`` / ``atol``; raises ``RuntimeError``
    otherwise.  The bound is entry-wise: on a full-width f32 All-CNN-C on
    the GPU, the chunked and concatenated matvecs of a correct "mean"
    differ by more than ``atol`` in near-zero entries, so it raises there
    too; run it on an f64 copy of the model and data."""
    if len(acc._chunks(datalist)) <= 1:
        raise AssertionError(
            "This test is only meaningful for a data list with at least two "
            "entries."
        )
    v = _random_vector(ravel, generator)
    with precision_ctx(config):
        a_loss = acc.acc_loss(fns, params, datalist, reduction)
        a_grad = acc.acc_grad(fns, params, datalist, reduction, ravel)
        a_mvp = acc.make_acc_mvp(
            fns, config, params, datalist, reduction, ravel
        )(v)
        r_loss, r_grad, r_mvp_fn = _build_matvec_and_grad(
            fns, config, ravel, params, acc.concat_datalist(datalist)
        )
        r_mvp = r_mvp_fn(v)

    failures = [
        name
        for name, ref, got in (
            ("loss values", r_loss, a_loss),
            ("gradients", r_grad, a_grad),
            ("mvps", r_mvp, a_mvp),
        )
        if not bool(torch.allclose(got, ref, rtol=rtol, atol=atol))
    ]
    if failures:
        raise RuntimeError(
            f"Inconsistent results for reduction {reduction} "
            f"(mismatched: {', '.join(failures)}). The loss function's "
            "reduction does not match the declared one."
        )


_BACKEND_ERROR = (
    "Unknown checkpoint backend {!r}: the port has 'torch' (torch.save) "
    "and 'npz' (the JAX package's npz layout); Orbax is not ported."
)


class HessianFree:
    """Stateful Hessian-free optimizer owning the parameter tree.

    Construct once and call :meth:`step` per batch (or :meth:`acc_step`
    per datalist, :meth:`train_steps` per stacked batch); the per-step
    history (reference optimizer.py:186-192) accumulates in
    ``self.history`` and :meth:`state_dict` round-trips it with the
    optimizer state.

    Args:
        params: Initial parameter tree (a private detached copy is kept).
        model_fn / loss_outer: split model form; required for GGN.
        loss_fn: direct form ``loss_fn(params, batch)`` (Hessian only).
        loss_reg: optional parameter-only loss term.
        trainable: optional boolean mask tree.
        config: :class:`HFConfig`; or pass its fields as keyword args.
        pad_to_multiple: flat-space padding (see :class:`TrainableRavel`).
        mesh: a ``DeviceMesh`` from :func:`~.parallel.mesh.make_mesh` with
            a ``data_axis``: :meth:`step`, :meth:`acc_step`,
            :meth:`train_steps` and :meth:`get_preconditioner` run
            data-parallel (:mod:`.parallel.data_parallel`).  Every rank
            constructs the optimizer (rank 0's parameters are broadcast to
            the others) and passes its own rows of each batch
            (:func:`~.parallel.mesh.shard_batch`, or a
            ``DevicePrefetcher(sharding=...)``); the Nystrom sketch and the
            spectrum take the batch they are given on each rank alone, as
            the JAX package's do.  The loss's reduction (``"mean"`` or
            ``"sum"``, which the JAX package's GSPMD step derives from the
            loss) is read from the loss on the first batch; a loss that is
            neither raises.  A model whose forward couples the rows
            (BatchNorm's batch statistics) takes them over every rank's
            rows, as the JAX package's GSPMD step does.  With a
            ``model_axis`` in the mesh, the steps split the solver state
            over it (:mod:`.parallel.sharded`): :attr:`params` stay whole
            on every rank, ``state.x0`` is the rank's block, and each rank
            passes the WHOLE batch, which the step cuts per
            ``batch_specs`` (rows over ``data_axis`` by default).
        data_axis / model_axis: the mesh's axis names.
        param_specs: tree prefix of :class:`~.parallel.mesh.PartitionSpec`
            splitting the weights over the mesh (tensor and expert
            parallelism; transformer blocks in the Megatron layout also
            split their compute, :mod:`.parallel.sharded`); needs a mesh
            with a model axis.
        batch_specs: tree prefix of specs placing the batch per leaf
            (context parallelism: tokens ``[N, T]`` under
            ``PartitionSpec(None, "model")``); needs a mesh with a model
            axis.

    :meth:`save` and :meth:`load` checkpoint the parameters, the optimizer
    state and the history (:mod:`.checkpoint`).
    """

    def __init__(
        self,
        params: Any,
        model_fn=None,
        loss_outer=None,
        loss_fn=None,
        loss_reg=None,
        trainable=None,
        config: Optional[HFConfig] = None,
        pad_to_multiple: Optional[int] = 1024,
        mesh=None,
        data_axis: str = "data",
        model_axis: str = "model",
        param_specs=None,
        batch_specs=None,
        **config_kwargs,
    ):
        if config is None:
            config = HFConfig(**config_kwargs)
        elif config_kwargs:
            raise ValueError("Pass either config or keyword args, not both.")
        specs = param_specs is not None or batch_specs is not None
        self._sharded = False
        if mesh is None:
            if specs:
                raise ValueError("param_specs/batch_specs require mesh.")
        else:
            names = mesh.mesh_dim_names or ()
            self._sharded = model_axis in names
            if specs and not self._sharded:
                raise ValueError(
                    "param_specs/batch_specs require a mesh with a "
                    f"{model_axis!r} axis."
                )
            if not self._sharded and data_axis not in names:
                raise ValueError(
                    f"mesh has no {data_axis!r} axis (axes {names})"
                )
        self.mesh = mesh
        self._data_axis = data_axis
        self._model_axis = model_axis
        self._param_specs = param_specs
        self._batch_specs = batch_specs
        self._dp_reduction = None
        self.config = config
        self.fns = HFModelFns(
            model_fn=model_fn,
            loss_outer=loss_outer,
            loss_fn=loss_fn,
            loss_reg=loss_reg,
        )
        if config.curvature_opt == "ggn" and model_fn is None:
            raise ValueError(
                "curvature_opt='ggn' requires model_fn + loss_outer."
            )
        self.params = tree_map(lambda t: t.detach().clone(), params)
        if mesh is not None:
            from .parallel.data_parallel import _broadcast_replicas

            for axis in (data_axis, model_axis):
                if axis in (mesh.mesh_dim_names or ()):
                    _broadcast_replicas(self.params, mesh, axis)
        self.ravel = TrainableRavel(
            self.params, trainable, pad_to_multiple=pad_to_multiple
        )
        self.state = init_state(self.ravel, config)
        # EMA diagonals of train_steps, one EMADiag per decay
        self._ema_states: dict = {}
        self.last_stats: Optional[HFStats] = None
        self.history = {
            "init_losses": [],
            "final_losses": [],
            "dampings": [],
            "cg_reasons": [],
            "num_cg_iters": [],
            "best_cg_iters": [],
            "learning_rates": [],
        }

    def _append_history(self, stats: HFStats, i=None):
        """Append one step to the history; ``i`` indexes stacked stats."""
        if i is not None:
            # every field but the last, detail, which the history skips
            stats = HFStats(*(v[i] for v in stats[:-1]))
        h = self.history
        h["init_losses"].append(float(stats.init_loss))
        h["final_losses"].append(float(stats.final_loss))
        h["dampings"].append(float(stats.damping))
        h["cg_reasons"].append(CG_REASON_STRINGS[int(stats.cg_reason)])
        h["num_cg_iters"].append(int(stats.num_cg_iters))
        h["best_cg_iters"].append(int(stats.best_cg_iter))
        h["learning_rates"].append(float(stats.lr))

    def _loss_reduction(self, batch) -> str:
        """The loss's reduction for the data-parallel steps, read from the
        first batch (:func:`.parallel.data_parallel._loss_reduction`) and
        kept.  A sharded step reduces over the data axis only when it
        splits the rows: with no data axis, or ``batch_specs``, the
        reduction is the default ``"mean"``, which no reduction reads."""
        if self._sharded and (
            self._batch_specs is not None
            or self._data_axis not in (self.mesh.mesh_dim_names or ())
        ):
            return "mean"
        if self._sharded:
            from .parallel.mesh import shard_batch

            batch = shard_batch(batch, self.mesh, self._data_axis)
        if self._dp_reduction is None:
            from .parallel.data_parallel import _loss_reduction

            self._dp_reduction = _loss_reduction(
                self.fns, self.params, batch, self.mesh, self._data_axis
            )
        return self._dp_reduction

    def clear_caches(self) -> None:
        """The JAX package drops its compiled step variants here.  The
        eager port compiles nothing and keeps no variant, so there is
        nothing to drop."""

    def _record(self, stats: HFStats) -> float:
        h = self.history
        self._append_history(stats)
        self.last_stats = stats
        if self.config.verbose:
            flags = [
                name
                for name, on in (
                    ("nonpos-curvature", bool(stats.nonpos_curvature)),
                    ("rho<0", bool(stats.rho_negative)),
                    ("linesearch-failed", stats.linesearch_failed),
                    ("not-descent", stats.not_descent_direction),
                )
                if on
            ]
            print(
                f"[HF step {len(h['init_losses'])}]"
                f" loss {float(stats.init_loss):.6f} -> "
                f"{float(stats.final_loss):.6f} | damping "
                f"{float(stats.damping):.6f} -> {float(stats.new_damping):.6f}"
                f" (rho {float(stats.rho):.4f}) | cg "
                f"{stats.num_cg_iters} iters "
                f"({CG_REASON_STRINGS[stats.cg_reason]}) | best "
                f"iter {stats.best_cg_iter} | lr {float(stats.lr):.6f}"
                + (f" | flags: {', '.join(flags)}" if flags else "")
            )
            if stats.detail is not None:
                print(format_rich_stats(stats))
        return float(stats.final_loss)

    def step(
        self,
        batch: Any,
        precond_diag: Optional[torch.Tensor] = None,
        test_deterministic: bool = False,
        M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        grad_vec: Optional[torch.Tensor] = None,
        mvp: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        precond_lowrank: Any = None,
    ) -> float:
        """One update on ``batch``; returns the final mini-batch loss
        (reference optimizer.py:126-363).  ``M``, ``grad_vec`` and ``mvp``
        are the reference's ``M_func``, ``grad`` and ``mvp`` arguments;
        ``precond_diag`` (from :meth:`get_preconditioner`) is preconditioned
        with ``config.precond_exponent`` and the live damping;
        ``precond_lowrank`` (from :meth:`get_nystrom_sketch`) is the low-rank
        ``(A + damping I)^{-1}`` approximation with the live damping.
        ``test_deterministic=True`` runs :meth:`test_deterministic` first and
        warns if it finds randomness."""
        if test_deterministic:
            self._warn_if_nondeterministic(batch)
        if precond_lowrank is not None and (
            precond_diag is not None or M is not None or mvp is not None
            or grad_vec is not None
        ):
            raise ValueError(
                "precond_lowrank cannot be combined with precond_diag, "
                "M, mvp or grad_vec; build the preconditioner closure "
                "explicitly (ops.nystrom.nystrom_to_preconditioner) and "
                "pass it as M for custom compositions."
            )
        if M is not None and precond_diag is not None:
            raise ValueError("Pass either M or precond_diag, not both.")
        if self.mesh is not None:
            if precond_lowrank is not None:
                raise ValueError(
                    "precond_lowrank is not supported with mesh=; use the "
                    "functional hf_step with an explicit M closure instead."
                )
            if M is not None or mvp is not None or grad_vec is not None:
                raise ValueError(
                    "Custom M/grad/mvp closures are not supported with "
                    "mesh=; use the functional hf_step instead."
                )
            if self._sharded:
                from .parallel.sharded import make_sharded_hf_step

                step = make_sharded_hf_step(
                    self.fns, self.config, self.ravel, self.mesh,
                    **self._sharded_kwargs(batch),
                    precond_exponent=self.config.precond_exponent,
                )
            else:
                from .parallel.data_parallel import make_dp_hf_step

                step = make_dp_hf_step(
                    self.fns, self.config, self.ravel, self.mesh,
                    axis_name=self._data_axis,
                    precond_exponent=self.config.precond_exponent,
                    reduction=self._loss_reduction(batch),
                )
            params, self.state, stats = step(
                self.params, self.state, batch, precond_diag
            )
            self.params = self._whole(params)
            return self._record(stats)
        self.params, self.state, stats = hf_step(
            self.params, self.state, batch, fns=self.fns, config=self.config,
            ravel=self.ravel, precond_diag=precond_diag,
            precond_exponent=self.config.precond_exponent,
            precond_lowrank=precond_lowrank, M=M, grad_vec=grad_vec,
            mvp_vec=mvp,
        )
        return self._record(stats)

    def _sharded_kwargs(self, batch) -> dict:
        """The keywords of a :mod:`.parallel.sharded` builder."""
        data = self._data_axis
        if data not in (self.mesh.mesh_dim_names or ()):
            data = None
        return dict(data_axis=data, model_axis=self._model_axis,
                    param_specs=self._param_specs,
                    batch_specs=self._batch_specs,
                    reduction="mean" if batch is None
                    else self._loss_reduction(batch))

    def _whole(self, params):
        """Parameters as a sharded step returned them -> whole on every
        rank (the wrapper keeps them whole)."""
        if not self._sharded or self._param_specs is None:
            return params
        from .parallel.sharded import unshard_params

        return unshard_params(params, self._param_specs, self.mesh,
                              self.ravel)

    def _warn_if_nondeterministic(self, batch) -> None:
        res = self.test_deterministic(batch)
        if not all(res.values()):
            warnings.warn(
                "Non-deterministic behaviour detected "
                f"({res}). CG's quadratic model assumes a fixed batch "
                "and deterministic model."
            )

    def acc_step(
        self,
        loss_data,
        grad_data=None,
        mvp_data=None,
        reduction: str = "mean",
        precond_diag: Optional[torch.Tensor] = None,
        test_deterministic: bool = False,
        mvp_amortize: bool = False,
    ) -> float:
        """Accumulated step over datalists (reference optimizer.py:519-606);
        see :func:`hf_acc_step`.  ``test_deterministic=True`` checks the
        first chunk of ``loss_data`` and warns."""
        if test_deterministic:
            self._warn_if_nondeterministic(acc._chunks(loss_data)[0])
        if self.mesh is not None:
            if grad_data is not None or mvp_data is not None:
                raise ValueError(
                    "acc_step with mesh= supports only loss_data (stacked); "
                    "use hf_acc_step / parallel.* builders for independent "
                    "grad/mvp datalists."
                )
            if self._sharded:
                from .parallel.sharded import make_sharded_hf_acc_step

                kwargs = self._sharded_kwargs(None)
                kwargs["reduction"] = reduction
                step = make_sharded_hf_acc_step(
                    self.fns, self.config, self.ravel, self.mesh, **kwargs,
                    precond_exponent=self.config.precond_exponent,
                    mvp_amortize=mvp_amortize,
                )
            else:
                from .parallel.data_parallel import make_dp_hf_acc_step

                step = make_dp_hf_acc_step(
                    self.fns, self.config, self.ravel, self.mesh,
                    axis_name=self._data_axis, reduction=reduction,
                    precond_exponent=self.config.precond_exponent,
                    mvp_amortize=mvp_amortize,
                )
            params, self.state, stats = step(
                self.params, self.state, loss_data, precond_diag=precond_diag
            )
            self.params = self._whole(params)
            return self._record(stats)
        self.params, self.state, stats = hf_acc_step(
            self.params, self.state, fns=self.fns, config=self.config,
            ravel=self.ravel, loss_data=loss_data, grad_data=grad_data,
            mvp_data=mvp_data, reduction=reduction, precond_diag=precond_diag,
            precond_exponent=self.config.precond_exponent,
            mvp_amortize=mvp_amortize,
        )
        return self._record(stats)

    def train_steps(self, batches, precond_ema_decay=None):
        """Run one step per slice of the leading steps axis of ``batches``
        (leaves ``[T, N, ...]``) through :func:`make_hf_train_loop`; appends
        every step to :attr:`history` and returns the final losses.

        ``precond_ema_decay``: precondition every CG solve with an EMA of
        the empirical-Fisher diagonals.  The EMA persists across calls, one
        per decay value (switching decays does not continue another decay's
        average).  With ``mesh=``, ``batches`` holds this rank's rows of
        each step's batch (leaves ``[T, N / ranks, ...]``)."""
        if self.mesh is not None and self._sharded:
            from .parallel.sharded import make_sharded_hf_train_loop

            loop = make_sharded_hf_train_loop(
                self.fns, self.config, self.ravel, self.mesh,
                **self._sharded_kwargs(tree_map(lambda a: a[0], batches)),
                precond_exponent=self.config.precond_exponent,
                precond_ema_decay=precond_ema_decay,
            )
        elif self.mesh is not None:
            from .parallel.data_parallel import make_dp_hf_train_loop

            loop = make_dp_hf_train_loop(
                self.fns, self.config, self.ravel, self.mesh,
                axis_name=self._data_axis,
                precond_exponent=self.config.precond_exponent,
                precond_ema_decay=precond_ema_decay,
                reduction=self._loss_reduction(
                    tree_map(lambda a: a[0], batches)),
            )
        else:
            loop = make_hf_train_loop(
                self.fns, self.config, self.ravel,
                precond_exponent=self.config.precond_exponent,
                precond_ema_decay=precond_ema_decay,
            )
        if precond_ema_decay is None:
            self.params, self.state, stats = loop(
                self.params, self.state, batches
            )
        else:
            self.params, self.state, stats, ema = loop(
                self.params, self.state, batches,
                self._ema_states.get(precond_ema_decay),
            )
            self._ema_states[precond_ema_decay] = ema
        self.params = self._whole(self.params)
        for i in range(stats.init_loss.shape[0]):
            self._append_history(stats, i)
        self.last_stats = stats
        return [float(v) for v in stats.final_loss]

    def get_preconditioner(
        self,
        inputs: Any,
        targets: Any,
        reduction: str,
        use_scan: bool = False,
    ) -> torch.Tensor:
        """Empirical-Fisher diagonal at the current params; pass it to
        :meth:`step` or :meth:`acc_step` as ``precond_diag``.  The step
        builds ``(D + damping)^(-config.precond_exponent)`` with the live
        damping.  (The reference's method of this name returns ``None``;
        this one returns the diagonal, as the JAX package's does.)  With
        ``mesh=``, ``inputs`` and ``targets`` are this rank's rows and the
        ranks' partial sums are reduced (``parallel.dp_diag_EF``); with a
        model axis, ``inputs`` and ``targets`` are the whole batch, whose
        rows the data axis splits, and the diagonal is whole on every
        rank."""
        fn = diag_EF_scan if use_scan else diag_EF
        with precision_ctx(self.config):
            reduce = None
            names = self.mesh.mesh_dim_names or () if self.mesh else ()
            if self._sharded and self._data_axis in names:
                from .parallel.mesh import shard_batch

                inputs, targets = shard_batch((inputs, targets), self.mesh,
                                              self._data_axis)
            if self.mesh is not None and self._data_axis in names:
                from .parallel.data_parallel import _Reduce

                reduce = _Reduce(self.mesh, self._data_axis, "sum")
            return _diag(self.fns, self.params, inputs, targets, reduction,
                         self.ravel, reduce, diag=fn)

    def test_reduction(self, datalist, reduction: str) -> None:
        """Raise ``RuntimeError`` if the loss's reduction is not
        ``reduction`` (see :func:`check_reduction`)."""
        check_reduction(
            self.fns, self.config, self.ravel, self.params, datalist, reduction
        )

    def test_deterministic(
        self, batch, fns_factory=None, batch_factory=None
    ) -> dict:
        """See :func:`check_deterministic`."""
        return check_deterministic(
            self.fns, self.config, self.ravel, self.params, batch,
            fns_factory=fns_factory, batch_factory=batch_factory,
        )

    def _probes(self, count, generator, seed):
        """``count`` unit Rademacher rows in the unpadded subspace, zero on
        the padding tail, drawn from ``generator`` (a CPU generator seeded
        with ``seed`` if none is given, so one seed gives the same probes
        on every device) and moved to the ravel's device."""
        ravel = self.ravel
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        probes = normalized_probes(
            generator, count, ravel.unpadded_dim, ravel.dtype,
            pad_to=ravel.dim if ravel.dim != ravel.unpadded_dim else None,
        )
        return probes.to(ravel.device)

    def _live_matvec(self, batch, curvature):
        """The undamped matvec that this step's CG would solve against on
        ``batch`` (``curvature`` overrides ``config.curvature_opt``); call
        under :func:`precision_ctx`."""
        config = self.config
        if curvature is not None:
            config = dataclasses.replace(config, curvature_opt=curvature)
        return _build_matvec_and_grad(
            self.fns, config, self.ravel, self.params, batch
        )[2]

    def get_nystrom_sketch(
        self,
        batch,
        *,
        rank: int = 32,
        generator: Optional[torch.Generator] = None,
        curvature: Optional[str] = None,
        seed: int = 0,
    ) -> NystromSketch:
        """Rank-``rank`` randomized Nystrom eigensketch of the live curvature
        operator (the params, batch and curvature configuration the step's
        CG solves against); pass it to :meth:`step` as ``precond_lowrank``.

        Cost: one matvec build and ``rank`` matvecs in one ``vmap``.  The
        sketch can serve several steps while the curvature drifts slowly.
        ``curvature`` overrides ``config.curvature_opt``; the sketch assumes
        a PSD operator, so on the Hessian negative eigenvalues are clipped.
        """
        probes = self._probes(rank, generator, seed)
        with precision_ctx(self.config):
            return nystrom_sketch(self._live_matvec(batch, curvature), probes)

    def estimate_spectrum(
        self,
        batch,
        *,
        num_iters: int = 32,
        num_probes: int = 0,
        generator: Optional[torch.Generator] = None,
        curvature: Optional[str] = None,
        seed: int = 0,
    ):
        """Spectral diagnostics of the live curvature operator: Ritz values
        of one ``num_iters``-step Lanczos run with full reorthogonalization
        and, if ``num_probes > 0``, SLQ with that many Rademacher probes
        (feed the nodes and weights to :func:`~.ops.spectrum.slq_trace` /
        :func:`~.ops.spectrum.slq_density` with ``dim =
        self.ravel.unpadded_dim``).  ``curvature`` overrides
        ``config.curvature_opt`` (e.g. to look for saddles of the Hessian
        while training with the GGN).

        Returns a :class:`~.ops.spectrum.RitzResult` (values descending), or
        ``(RitzResult, (nodes, weights))`` when ``num_probes > 0``.
        """
        probes = self._probes(1 + num_probes, generator, seed)
        with precision_ctx(self.config):
            mvp = self._live_matvec(batch, curvature)
            r = ritz(mvp, probes[0], num_iters)
            if num_probes:
                return r, slq(mvp, probes[1:], num_iters)
        return r

    def state_dict(self) -> dict:
        """Snapshot of the optimizer state (on the CPU) and the history."""
        return {
            "state": {
                k: v.detach().cpu().clone()
                for k, v in self.state._asdict().items()
            },
            "history": {k: list(v) for k, v in self.history.items()},
            "step_count": int(self.state.step_count),
        }

    def save(self, path: str, backend: str = "torch") -> None:
        """Checkpoint the parameters, the optimizer state and the history:
        ``backend="torch"`` (:func:`.checkpoint.save`, a directory) or
        ``"npz"`` (:func:`.checkpoint.save_npz`, the JAX package's npz
        layout)."""
        from . import checkpoint as ckpt

        if backend == "torch":
            ckpt.save(path, self.params, self.state, self.history)
        elif backend == "npz":
            ckpt.save_npz(path, self.params, self.state, self.history)
        else:
            raise ValueError(_BACKEND_ERROR.format(backend))

    def load(self, path: str, backend: str = "torch") -> None:
        """Restore a checkpoint written by :meth:`save` (or, with
        ``backend="npz"``, by the JAX package's ``save_npz``) onto the
        ravel's device; training continues as if it had not stopped."""
        from . import checkpoint as ckpt

        if backend == "torch":
            params, state, history = ckpt.restore(path)
        elif backend == "npz":
            params, state, history = ckpt.restore_npz(path, self.params)
        else:
            raise ValueError(_BACKEND_ERROR.format(backend))
        dev = self.ravel.device
        self.params = tree_map(lambda t: t.to(dev), params)
        self.state = HFState(*(t.to(dev) for t in state))
        self.history.update(history)

    def load_state_dict(self, sd: dict) -> None:
        s = sd["state"]
        dev = self.ravel.device
        x0 = torch.as_tensor(s["x0"]).to(dev)
        self.state = HFState(
            x0=x0,
            damping=torch.as_tensor(s["damping"]).to(device=dev, dtype=x0.dtype),
            step_count=torch.as_tensor(s["step_count"]).to(dev, torch.int64),
        )
        self.history.update(
            {k: list(v) for k, v in sd.get("history", {}).items()}
        )
