"""Update-step selection: CG backtracking and the Armijo line search (port
of :mod:`pytorchhessianfree_tpu.ops.select`).

Both routines evaluate a target ``f(step) -> loss`` (the reference's
``tfunc`` closure, reference optimizer.py:288-294) at a sequence of trial
steps.  The ``"sequential"`` mode exits early, exactly as the reference's
loops do (reference cg_backtracking.py:53-112, linesearch.py:8-103), and
reads one comparison back to the host per trial.  The ``"batched"`` mode
evaluates every candidate in one ``torch.func.vmap`` of ``f``, reads the
sweep back once and applies the same selection rule: the backtracking walk
makes the sequential choice, and the line search takes the largest
accepted alpha.  The JAX package's ``fused_trials`` has no counterpart:
eager PyTorch gains nothing from one traced forward, and the standalone
routines evaluate the same points.

A target may carry a ``sweep`` attribute, ``f.sweep(steps [k, n]) -> [k]``,
which the batched modes call in place of ``vmap(f)``: the data-parallel
steps (:mod:`~..parallel.data_parallel`) sum the ranks' trial losses there,
after the ``vmap``, since no collective can run inside one.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

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


def _candidates(cgres: CGResult):
    """Candidate ``j`` in ``[0, G]``: buffer row ``j`` for ``j < G``, the
    final iterate for ``j == G``.  Returns the ``[G+1, n]`` stack (rows cast
    to the iterate's dtype) and the host mask of valid candidates: a row is
    valid only below ``num_iters`` (rows at or past it duplicate the final
    iterate or were never reached, the reference's ``None`` holes,
    reference cg_backtracking.py:85-86)."""
    x = cgres.x
    stacked = torch.cat([cgres.x_buf.to(x.dtype), x[None]])
    valid = [it < cgres.num_iters for it in cgres.stored_iters] + [True]
    return stacked, valid


def _sweep(f, steps: torch.Tensor) -> torch.Tensor:
    """``f`` at every row of ``steps``: ``f.sweep(steps)`` if the target
    has one (module docstring), else one ``vmap`` of ``f``."""
    sweep = getattr(f, "sweep", None)
    return torch.func.vmap(f)(steps) if sweep is None else sweep(steps)


def _best_iter(cgres: CGResult, best: int) -> int:
    G = len(cgres.stored_iters)
    return cgres.num_iters if best == G else cgres.stored_iters[best]


def cg_efficient_backtracking(
    f: Callable[[torch.Tensor], torch.Tensor],
    cgres: CGResult,
    mode: str = "sequential",
) -> BacktrackResult:
    """Reverse-walk the stored CG iterates, stopping at the first
    non-improvement (reference cg_backtracking.py:53-112).

    The final iterate is evaluated first with ``f_min = inf``, so it is the
    initial best; then stored rows from the last reached one down to
    iteration 0, while ``f`` strictly improves.  Rows at or past
    ``num_iters`` are skipped.  ``mode="batched"`` evaluates every valid
    candidate in one vmapped sweep, then walks the values; its ``f_vals``
    holds every valid candidate's loss.
    """
    G = len(cgres.stored_iters)
    x = cgres.x
    nan = float("nan")

    def step_at(j):
        return x if j == G else cgres.row(j)

    if mode == "batched":
        stacked, valid = _candidates(cgres)
        f_all = _sweep(f, stacked)
        f_host = f_all.tolist()  # the one host read of the sweep
        best, f_min = G, math.inf
        for j in range(G, -1, -1):
            if not valid[j]:
                continue
            if not f_host[j] < f_min:
                break
            best, f_min = j, f_host[j]
        mask = torch.tensor(valid, device=x.device)
        return BacktrackResult(
            best_iter=_best_iter(cgres, best),
            step=stacked[best],
            f_best=f_all[best],
            f_final=f_all[G],
            f_vals=torch.where(mask, f_all, f_all.new_tensor(nan)),
        )

    f_vals = torch.full((G + 1,), nan, dtype=x.dtype, device=x.device)
    best, f_min = G, math.inf
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

    return BacktrackResult(
        best_iter=_best_iter(cgres, best),
        step=step_at(best),
        f_best=f_best,
        f_final=f_final,
        f_vals=f_vals,
    )


def cg_backtracking(
    f: Callable[[torch.Tensor], torch.Tensor], cgres: CGResult
) -> BacktrackResult:
    """Exhaustive variant: the global argmin over the valid candidates
    (reference cg_backtracking.py:6-50), evaluated in one vmapped sweep."""
    stacked, valid = _candidates(cgres)
    f_all = _sweep(f, stacked)
    mask = torch.tensor(valid, device=stacked.device)
    masked = torch.where(mask, f_all, f_all.new_tensor(math.inf))
    best = int(torch.argmin(masked))
    return BacktrackResult(
        best_iter=_best_iter(cgres, best),
        step=stacked[best],
        f_best=masked[best],
        f_final=f_all[-1],
        f_vals=torch.where(mask, f_all, f_all.new_tensor(float("nan"))),
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
    mode: str = "sequential",
    batch_chunk: Optional[int] = None,
) -> LinesearchResult:
    """Armijo backtracking line search (reference linesearch.py:8-103).

    From ``alpha = init_alpha``, accept the first alpha with
    ``f(alpha * step) <= f(0) + alpha * c * (grad . step)``, else shrink by
    ``beta``.  After ``max_iter`` rejected trials return ``(0.0, f(0))``:
    no update.  ``f_0 = f(0)`` is supplied by the caller.  The condition is
    evaluated in the tensors' dtype, as in the JAX package.

    ``mode="batched"`` evaluates the ``max_iter`` alphas
    ``init_alpha * beta**i`` in one vmapped sweep (or, with
    ``batch_chunk=k``, in ``ceil(max_iter / k)`` sweeps of ``k``, the last
    one padded with the last alpha) and takes the largest accepted one.
    """
    return _linesearch(f, torch.dot(f_grad_0, step), step, f_0, init_alpha,
                       beta, c, max_iter, mode, batch_chunk)


def _linesearch(f, slope, step, f_0, init_alpha=1.0, beta=0.8, c=1e-2,
                max_iter=20, mode="sequential", batch_chunk=None):
    """:func:`simple_linesearch` given the slope ``grad . step`` (a rank's
    block dot reduced over the ranks in a sharded step)."""
    if beta >= 1.0:
        raise ValueError(f"Invalid reduction factor beta = {beta}")
    if c < 0.0:
        raise ValueError(f"Invalid c = {c}")
    if max_iter < 1:
        raise ValueError(f"Invalid line-search max_iter {max_iter}")

    dtype, device = step.dtype, step.device
    c_dir = c * slope
    not_descent = bool((c_dir >= 0).item())

    if mode == "batched":
        exponents = torch.arange(max_iter, dtype=dtype, device=device)
        alphas = init_alpha * (beta**exponents)

        def sweep(a):
            return _sweep(f, a[:, None] * step)

        if batch_chunk is None or batch_chunk >= max_iter:
            f_trace = sweep(alphas)
        else:
            k = int(batch_chunk)
            pad = (-max_iter) % k
            padded = torch.cat([alphas, alphas[-1:].expand(pad)])
            f_trace = torch.cat(
                [sweep(chunk) for chunk in padded.reshape(-1, k)]
            )[:max_iter]
        accepts = (f_trace <= f_0 + alphas * c_dir).tolist()
        if True in accepts:
            first = accepts.index(True)  # smallest index = largest alpha
            return LinesearchResult(
                alphas[first], f_trace[first], False, not_descent,
                alphas=alphas, f_trace=f_trace,
            )
        return LinesearchResult(
            torch.zeros((), dtype=dtype, device=device), f_0, True,
            not_descent, alphas=alphas, f_trace=f_trace,
        )

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
