"""The Hessian-free optimizer: functional core and stateful wrapper (port
of :mod:`pytorchhessianfree_tpu.optimizer`).

One update runs the reference's phases in order (reference
hessianfree/optimizer.py:208-363): loss and gradient -> curvature matvec
closure -> damped CG with Martens' stop and the iterate grid -> warm-start
decay -> CG backtracking -> Levenberg-Marquardt damping -> Armijo line
search -> parameter update.  PyTorch runs it eagerly: the CG loop and the
trial loops are Python loops that read one value back to the host per
iteration, and the CG vector phase is the hand-written
:func:`~.ops.cg_update.fused_cg_update` kernel on a card.

:func:`hf_step` is a function of ``(params, state, batch)`` that returns new
tensors and leaves its inputs alone; :class:`HessianFree` owns the
parameter tree and keeps the reference's history lists.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch.func import grad_and_value

from .config import HFConfig, not_ported, precision_ctx
from .ops.cg import CG_REASON_STRINGS, cg
from .ops.curvature import ggnvp_fn, hvp_fn
from .ops.select import cg_efficient_backtracking, simple_linesearch
from .utils.flatten import TrainableRavel, tree_map


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
    detail: Any = None  # solver trace, not ported (HFConfig.rich_stats)


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
) -> Tuple[Any, HFState, HFStats]:
    """Solve, select and update on flat vectors, in the reference's phase
    order.  ``loss_at(delta)`` is the loss at ``params + delta``."""
    damping = state.damping

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
    )

    # warm start for the next step: the decayed FINAL iterate
    new_x0 = grad_vec.new_tensor(config.cg_decay_x0) * cgres.x

    if config.use_cg_backtracking:
        bt = cg_efficient_backtracking(loss_at, cgres)
        step_vec, best_cg_iter, f_at_final = bt.step, bt.best_iter, bt.f_final
    else:
        step_vec, best_cg_iter, f_at_final = cgres.x, cgres.num_iters, None

    if config.adapt_damping:
        f_0 = loss_at(state.x0)  # loss at the warm start
        if f_at_final is None:
            f_at_final = loss_at(cgres.x)

    nan = grad_vec.new_tensor(float("nan"))
    if config.use_linesearch:
        ls = simple_linesearch(
            loss_at,
            grad_vec,
            step_vec,
            f_0=init_loss,
            init_alpha=config.lr,
            beta=config.linesearch.beta,
            c=config.linesearch.c,
            max_iter=config.linesearch.max_iter,
        )
        lr, final_loss = ls.alpha, ls.f_alpha
        ls_failed, not_descent = ls.failed, ls.not_descent
    else:
        lr = grad_vec.new_tensor(config.lr)
        final_loss = (
            loss_at(lr * step_vec) if config.compute_final_loss else nan
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
    )
    return new_params, new_state, stats


def _build_matvec_and_grad(
    fns: HFModelFns, config: HFConfig, ravel: TrainableRavel, params, batch
):
    """Loss, flat gradient and flat (undamped) curvature matvec for one
    batch.  The GGN path linearizes the model once per batch; the Hessian
    path linearizes ``(grad, value)`` of the loss once per batch."""
    if config.curvature_opt == "ggn":
        if fns.model_fn is None or fns.loss_outer is None:
            raise ValueError(
                "curvature_opt='ggn' needs the split form: model_fn + "
                "loss_outer (the GGN is defined through the model outputs, "
                "reference optimizer.py:152-154)."
            )
        inputs, targets = batch
        loss, _outputs, grad_tree, mvp_tree = ggnvp_fn(
            lambda p: fns.model_fn(p, inputs),
            lambda out: fns.loss_outer(out, targets),
            params,
        )
        grad_vec = ravel.ravel(grad_tree)
        if fns.loss_reg is not None:
            # the regularizer enters loss and gradient, not the GGN
            reg_grad, reg_val = grad_and_value(fns.loss_reg)(params)
            loss = loss + reg_val
            grad_vec = grad_vec + ravel.ravel(reg_grad)
    else:
        loss, grad_tree, mvp_tree = hvp_fn(
            lambda p: fns.full_loss(p, batch), params
        )
        grad_vec = ravel.ravel(grad_tree)

    def mvp_vec(v):
        return ravel.ravel(mvp_tree(ravel.unravel(v)))

    return loss, grad_vec, mvp_vec


def hf_step(
    params: Any,
    state: HFState,
    batch: Any,
    *,
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    precond_diag: Optional[torch.Tensor] = None,
    precond_lowrank: Any = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    grad_vec: Optional[torch.Tensor] = None,
    mvp_vec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[Any, HFState, HFStats]:
    """One Hessian-free update (reference optimizer.py:126-363).

    ``M`` is an optional preconditioner matvec on flat vectors; custom
    ``grad_vec`` / ``mvp_vec`` override the derived gradient and curvature
    matvec.  ``config.matmul_precision`` sets the TF32 switches for the
    whole step.
    """
    if precond_diag is not None or precond_lowrank is not None:
        raise not_ported("Preconditioning (precond_diag, precond_lowrank)",
                          "items 9 and 18")
    with precision_ctx(config):
        loss, derived_grad, derived_mvp = _build_matvec_and_grad(
            fns, config, ravel, params, batch
        )

        def loss_at(delta):
            return fns.full_loss(ravel.add(params, delta), batch)

        return _step_core(
            config,
            ravel,
            params,
            state,
            init_loss=loss,
            grad_vec=derived_grad if grad_vec is None else grad_vec,
            mvp_vec=derived_mvp if mvp_vec is None else mvp_vec,
            loss_at=loss_at,
            M=M,
        )


def make_hf_step(fns: HFModelFns, config: HFConfig, ravel: TrainableRavel):
    """``step(params, state, batch) -> (params, state, stats)``: the
    counterpart of the JAX package's jitted step (PyTorch runs it eagerly)."""

    def step(params, state, batch, precond_diag=None, precond_lowrank=None):
        return hf_step(
            params, state, batch, fns=fns, config=config, ravel=ravel,
            precond_diag=precond_diag, precond_lowrank=precond_lowrank,
        )

    return step


class HessianFree:
    """Stateful Hessian-free optimizer owning the parameter tree.

    Construct once and call :meth:`step` per batch; the per-step history
    (reference optimizer.py:186-192) accumulates in ``self.history`` and
    :meth:`state_dict` round-trips it with the optimizer state.

    Args:
        params: Initial parameter tree (a private detached copy is kept).
        model_fn / loss_outer: split model form; required for GGN.
        loss_fn: direct form ``loss_fn(params, batch)`` (Hessian only).
        loss_reg: optional parameter-only loss term.
        trainable: optional boolean mask tree.
        config: :class:`HFConfig`; or pass its fields as keyword args.
        pad_to_multiple: flat-space padding (see :class:`TrainableRavel`).
        mesh: not ported (ROADMAP.md, queue 1, item 20).
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
        **config_kwargs,
    ):
        if config is None:
            config = HFConfig(**config_kwargs)
        elif config_kwargs:
            raise ValueError("Pass either config or keyword args, not both.")
        if mesh is not None:
            raise not_ported("mesh=", "item 20")
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
        self.ravel = TrainableRavel(
            self.params, trainable, pad_to_multiple=pad_to_multiple
        )
        self.state = init_state(self.ravel, config)
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

    def _record(self, stats: HFStats) -> float:
        h = self.history
        h["init_losses"].append(float(stats.init_loss))
        h["final_losses"].append(float(stats.final_loss))
        h["dampings"].append(float(stats.damping))
        h["cg_reasons"].append(CG_REASON_STRINGS[stats.cg_reason])
        h["num_cg_iters"].append(stats.num_cg_iters)
        h["best_cg_iters"].append(stats.best_cg_iter)
        h["learning_rates"].append(float(stats.lr))
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
        are the reference's ``M_func``, ``grad`` and ``mvp`` arguments."""
        if test_deterministic:
            raise not_ported("test_deterministic", "item 11")
        self.params, self.state, stats = hf_step(
            self.params, self.state, batch, fns=self.fns, config=self.config,
            ravel=self.ravel, precond_diag=precond_diag,
            precond_lowrank=precond_lowrank, M=M, grad_vec=grad_vec,
            mvp_vec=mvp,
        )
        return self._record(stats)

    def acc_step(self, *args, **kwargs) -> float:
        raise not_ported("acc_step", "item 11")

    def train_steps(self, *args, **kwargs):
        raise not_ported("train_steps", "item 13")

    def get_preconditioner(self, *args, **kwargs):
        raise not_ported("get_preconditioner", "item 9")

    def get_nystrom_sketch(self, *args, **kwargs):
        raise not_ported("get_nystrom_sketch", "item 18")

    def estimate_spectrum(self, *args, **kwargs):
        raise not_ported("estimate_spectrum", "item 18")

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
