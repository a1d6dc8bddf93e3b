"""Update-step selection: CG backtracking and the Armijo line search (port
of the ``"sequential"`` routines of :mod:`pytorchhessianfree_tpu.ops.select`).

Both routines evaluate a target ``f(step) -> loss`` (the reference's
``tfunc`` closure, reference optimizer.py:288-294) at a sequence of trial
steps with an early exit, exactly as the reference's loops do
(reference cg_backtracking.py:53-112, linesearch.py:8-103).  Each trial
reads one comparison back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .cg import CGResult


class BacktrackResult(NamedTuple):
    best_iter: int  # CG iteration number of the chosen step
    step: torch.Tensor  # [n] the chosen update step
    f_best: torch.Tensor  # loss at the chosen step
    f_final: torch.Tensor  # loss at the final CG iterate (always evaluated)
    f_vals: torch.Tensor  # [G+1] loss per candidate, NaN where not evaluated


class LinesearchResult(NamedTuple):
    alpha: torch.Tensor  # chosen step size (0.0 on failure)
    f_alpha: torch.Tensor  # loss at alpha * step (f(0) on failure)
    failed: bool  # no alpha satisfied the Armijo condition
    not_descent: bool  # step is not a descent direction
    alphas: torch.Tensor  # [max_iter] trial step sizes, NaN where not tried
    f_trace: torch.Tensor  # [max_iter] losses at the trials


def cg_efficient_backtracking(
    f: Callable[[torch.Tensor], torch.Tensor], cgres: CGResult
) -> BacktrackResult:
    """Reverse-walk the stored CG iterates, stopping at the first
    non-improvement (reference cg_backtracking.py:53-112).

    The final iterate is evaluated first with ``f_min = inf``, so it is the
    initial best; then stored rows from the last reached one down to
    iteration 0, while ``f`` strictly improves.  Rows at or past
    ``num_iters`` are never reached or duplicate the final iterate, and are
    skipped.
    """
    G = len(cgres.stored_iters)
    x = cgres.x
    f_vals = torch.full((G + 1,), float("nan"), dtype=x.dtype, device=x.device)

    def step_at(j):
        return x if j == G else cgres.row(j)

    best, f_min = G, float("inf")
    f_best = torch.tensor(f_min, dtype=x.dtype, device=x.device)
    for j in range(G, -1, -1):
        if j < G and cgres.stored_iters[j] >= cgres.num_iters:
            continue
        fj = f(step_at(j))
        f_vals[j] = fj
        if j == G:
            f_final = fj
        fj_host = fj.item()
        if not fj_host < f_min:
            break
        best, f_best, f_min = j, fj, fj_host

    best_iter = cgres.num_iters if best == G else cgres.stored_iters[best]
    return BacktrackResult(
        best_iter=best_iter,
        step=step_at(best),
        f_best=f_best,
        f_final=f_final,
        f_vals=f_vals,
    )


def simple_linesearch(
    f: Callable[[torch.Tensor], torch.Tensor],
    f_grad_0: torch.Tensor,
    step: torch.Tensor,
    f_0: torch.Tensor,
    init_alpha: float = 1.0,
    beta: float = 0.8,
    c: float = 1e-2,
    max_iter: int = 20,
) -> LinesearchResult:
    """Armijo backtracking line search (reference linesearch.py:8-103).

    From ``alpha = init_alpha``, accept the first alpha with
    ``f(alpha * step) <= f(0) + alpha * c * (grad . step)``, else shrink by
    ``beta``.  After ``max_iter`` rejected trials return ``(0.0, f(0))``:
    no update.  ``f_0 = f(0)`` is supplied by the caller.  The condition is
    evaluated in the tensors' dtype, as in the JAX package.
    """
    if beta >= 1.0:
        raise ValueError(f"Invalid reduction factor beta = {beta}")
    if c < 0.0:
        raise ValueError(f"Invalid c = {c}")
    if max_iter < 1:
        raise ValueError(f"Invalid line-search max_iter {max_iter}")

    dtype, device = step.dtype, step.device
    c_dir = c * torch.dot(f_grad_0, step)
    not_descent = bool((c_dir >= 0).item())

    alphas = torch.full((max_iter,), float("nan"), dtype=dtype, device=device)
    f_trace = torch.full_like(alphas, float("nan"))
    alpha = torch.tensor(init_alpha, dtype=dtype, device=device)
    beta_t = torch.tensor(beta, dtype=dtype, device=device)
    for i in range(max_iter):
        fa = f(alpha * step)
        alphas[i] = alpha
        f_trace[i] = fa
        if bool((fa <= f_0 + alpha * c_dir).item()):
            return LinesearchResult(
                alpha, fa, False, not_descent, alphas=alphas, f_trace=f_trace
            )
        alpha = alpha * beta_t
    return LinesearchResult(
        torch.zeros((), dtype=dtype, device=device),
        f_0,
        True,
        not_descent,
        alphas=alphas,
        f_trace=f_trace,
    )
