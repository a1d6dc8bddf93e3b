"""A frozen, plain Hessian-free step (Martens 2010), the yardstick of the
benchmark's training cells.

It works on flat vectors of its own (:class:`~.tree.Flat`) and is given
plain callables of the parameter tree: the loss, its gradient, the
Gauss-Newton matvec and, where a step is preconditioned, a diagonal.  One
step, with the settings that the benchmark's cells state:

1. CG on ``(G + lambda I) x = -g`` from the warm start ``x0``,
   preconditioned by ``M = (d + lambda)^(-exponent)`` where a diagonal
   ``d`` is given; it stops on Martens' relative progress of the quadratic
   ``m`` over a window of ``max(10, i // 10)`` iterations, else on the
   iteration cap, a NaN residual, or ``||r|| < tol ||b||``, tested in that
   order; it keeps the iterates of iterations ``ceil(gamma^j) - 1``;
2. backtracking over those iterates: the final one first, then the kept
   ones from the last reached down, while the loss strictly falls; given
   the program's choice (``follow``), the step goes on from the iterate
   that choice names, and ``select`` measures by how much the reference's
   own loss there lies above the loss of its own choice (near-equal losses
   of two kept iterates are ordered by rounding, so a sound program may
   choose another of them);
3. Levenberg-Marquardt damping: ``rho = (f(x_final) - f(x0)) / (m_final -
   m_0)``; ``lambda`` times 3/2 below 1/4, times 2/3 above 3/4;
4. the Armijo line search on the chosen step from ``alpha = lr``, times
   ``beta`` per rejection, accepting ``f(alpha s) <= f(0) + c alpha g.s``;
   no update after ``max_iter`` rejections;
5. the next warm start, ``decay`` times the final CG iterate.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch


def storing_grid(max_iter: int, gamma: float):
    """Iterations ``ceil(gamma^j) - 1`` up to ``max_iter``, ascending."""
    j_max = math.ceil(math.log(max_iter + 1) / math.log(gamma))
    iters = sorted({int(math.ceil(gamma**j) - 1) for j in range(j_max + 1)})
    return [i for i in iters if i <= max_iter]


def cg(A, b, x0, M, max_iter, tol, threshold, min_window, gamma):
    """Preconditioned CG as the module docstring states.  Returns the final
    iterate, the iteration count, ``m`` at the start and at the end, and
    the kept iterates ``{iteration: x}``."""
    grid = set(storing_grid(max_iter, gamma))
    x = x0.clone()
    bound = tol * torch.linalg.vector_norm(b)
    r = A(x) - b
    m_hist = [0.5 * torch.dot(r - b, x)]
    kept = {0: x.clone()} if 0 in grid else {}
    y = r if M is None else M(r)
    ry = torch.dot(r, y)
    p = -y
    it = 1
    while True:
        Ap = A(p)
        alpha = ry / torch.dot(p, Ap)
        x = x + alpha * p
        r = r + alpha * Ap
        m = 0.5 * torch.dot(r - b, x)
        rr = torch.dot(r, r)
        m_hist.append(m)
        if it in grid:
            kept[it] = x
        k = max(min_window, it // 10)
        martens = k < it and bool(
            (m - m_hist[it - k]) / (m - m_hist[0]) < threshold)
        res = float(torch.sqrt(rr))
        if martens or it >= max_iter or math.isnan(res) or res < float(bound):
            break
        y = r if M is None else M(r)
        ry_new = torch.dot(r, y)
        p = -y + (ry_new / ry) * p
        ry = ry_new
        it += 1
    return x, it, m_hist[0], m_hist[it], kept


def step(
    w: torch.Tensor,
    x0: torch.Tensor,
    damping: float,
    loss: Callable[[torch.Tensor], torch.Tensor],
    grad: torch.Tensor,
    init_loss: float,
    ggn: Callable[[torch.Tensor], torch.Tensor],
    settings: Dict,
    diag: Optional[torch.Tensor] = None,
    follow: Optional[Tuple[int, int]] = None,
) -> Dict:
    """One step from the flat parameters ``w``: ``loss(w')`` is the full
    loss at ``w'``, ``grad`` and ``init_loss`` its gradient and value at
    ``w``, ``ggn`` the undamped Gauss-Newton matvec at ``w``.  ``settings``
    holds ``damping`` rules and solver constants (:data:`SETTINGS`).
    ``follow`` is the program's choice, ``(best_iter, num_cg_iters)``.
    Returns the new ``w``, ``x0`` and ``damping`` and what the step chose."""
    s = dict(SETTINGS, **settings)
    lam = torch.tensor(damping, dtype=w.dtype, device=w.device)

    def A(v):
        return ggn(v) + lam * v

    M = None
    if diag is not None:
        scale = (diag + lam) ** (-s["precond_exponent"])

        def M(v):
            return scale * v

    x, iters, m0, m_final, kept = cg(
        A, -grad, x0, M, s["cg_max_iter"], s["cg_tol"],
        s["martens_threshold"], s["martens_min_window"], s["grid_gamma"])

    # backtracking: the final iterate, then the kept ones below it
    best, best_iter, f_final = x, iters, loss(w + x)
    f_min = float(f_final)
    f_at = {iters: f_min}
    for i in sorted((i for i in kept if i < iters), reverse=True):
        f_i = float(loss(w + kept[i]))
        f_at[i] = f_i
        if not f_i < f_min:
            break
        best, best_iter, f_min = kept[i], i, f_i
    select = 0.0
    if follow is not None:
        # the program's final iterate is this solve's final one; a kept
        # iterate past this solve's end is its final one too
        i = iters if follow[0] >= min(follow[1], iters) else follow[0]
        if i not in f_at:
            f_at[i] = float(loss(w + kept[i]))
        select = max(0.0, f_at[i] - f_min) / abs(f_min)
        best = x if i == iters else kept[i]

    f_0 = loss(w + x0)
    rho = float((f_final - f_0) / (m_final - m0))
    new_damping = damping * (1.5 if rho < 0.25 else
                             (2.0 / 3.0 if rho > 0.75 else 1.0))

    slope = float(torch.dot(grad, best))
    alpha, lr = s["lr"], 0.0
    for _ in range(s["ls_max_iter"]):
        if float(loss(w + alpha * best)) <= (
                init_loss + alpha * s["ls_c"] * slope):
            lr = alpha
            break
        alpha *= s["ls_beta"]
    return dict(w=w + lr * best, x0=s["cg_decay_x0"] * x,
                damping=new_damping, cg_iters=iters, best_iter=best_iter, lr=lr,
                rho=rho, select=select)


# Martens' constants and the defaults of the configurations benchmarked
SETTINGS = dict(
    cg_max_iter=250, cg_tol=1e-5, martens_threshold=5e-4,
    martens_min_window=10, grid_gamma=1.3, cg_decay_x0=0.95, lr=1.0,
    ls_beta=0.8, ls_c=1e-2, ls_max_iter=20, precond_exponent=0.75,
)
# a cell's nested ``cg`` and ``linesearch`` fields under SETTINGS' names
NESTED = dict(
    cg=dict(tol="cg_tol", martens_threshold="martens_threshold",
            martens_min_window="martens_min_window",
            grid_gamma="grid_gamma"),
    linesearch=dict(beta="ls_beta", c="ls_c", max_iter="ls_max_iter"),
)


def settings_of(fields: Dict) -> Dict:
    """The settings of :func:`step` that a cell's optimizer fields state,
    laid out as the program's configuration is (``{"cg": {"tol": 0.0}}``
    sets ``cg_tol``).  A nested field this step does not follow raises
    ``KeyError``; top-level fields it has no setting for (the initial
    damping, which a step is given) are left out."""
    out = {}
    for key, value in fields.items():
        if key in NESTED:
            out.update({NESTED[key][k]: v for k, v in value.items()})
        elif key in SETTINGS:
            out[key] = value
    return out


def ggn_matvec(outputs: Callable, outer_hvp: Callable, params, flat):
    """The Gauss-Newton matvec ``J^T H_L J v`` of ``outputs(params)`` on
    flat vectors: ``J v`` by forward-mode AD, ``H_L`` given in closed form
    by ``outer_hvp(outputs, u)``, ``J^T`` by one stored reverse pass."""
    outs, pullback = torch.func.vjp(outputs, params)

    def mv(v):
        _, jv = torch.func.jvp(outputs, (params,), (flat.tree(v),))
        return flat.flat(pullback(outer_hvp(outs.detach(), jv))[0])

    return mv


def softmax_ce_hvp(logits: torch.Tensor, u: torch.Tensor, rows: int):
    """``H u`` of the mean softmax cross-entropy over ``rows`` rows of
    logits (last axis the classes): ``(p * u - p (p . u)) / rows``."""
    p = torch.softmax(logits, dim=-1)
    return (p * u - p * (p * u).sum(-1, keepdim=True)) / rows
