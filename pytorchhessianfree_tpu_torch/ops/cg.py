"""Preconditioned conjugate gradients (port of
:mod:`pytorchhessianfree_tpu.ops.cg`).

Same semantics as the JAX solver, which follows the reference CG
(reference hessianfree/cg.py:9-231):

- termination in the order Martens -> max_iter -> NaN -> tolerance, with a
  strict ``<`` on the residual bound ``max(tol * ||b||, atol)``;
- Martens' window ``k = max(10, it // 10)`` and relative-progress threshold;
- the iterate stored on the ``ceil(gamma^j) - 1`` grid into a ``[G, n]``
  buffer, written only on grid iterations, optionally in a reduced
  ``store_dtype`` (read back through :meth:`CGResult.row`, cast to the
  iterate's dtype);
- non-positive ``p.Ap`` flagged, and with ``"saddle-free"`` replaced by its
  absolute value.

The loop is a Python loop.  Each iteration makes one curvature matvec, one
``p.Ap`` and one call of :func:`~.cg_update.fused_cg_update` (the iterate,
residual, ``m`` and ``r.r`` in one pass).  ``alpha`` stays a device tensor;
the termination test reads one integer back to the host per iteration, as
the reference does.  Torch indexes in int64, so the JAX package's
flat/chunked buffer layout and its int32 guard are not needed.
"""

from __future__ import annotations

from math import ceil, log
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import float_dtype
from .cg_update import fused_cg_update

REASON_RUNNING = 0
REASON_MARTENS = 1
REASON_MAX_ITER = 2
REASON_DIVERGENCE = 3
REASON_TOLERANCES = 4

CG_REASON_STRINGS = {
    REASON_RUNNING: "Running",
    REASON_MARTENS: "Convergence (Martens)",
    REASON_MAX_ITER: "Number of iterations",
    REASON_DIVERGENCE: "Divergence",
    REASON_TOLERANCES: "Convergence (tolerances)",
}


def cg_reason_str(code: int) -> str:
    """Human-readable termination reason for a reason code."""
    return CG_REASON_STRINGS[int(code)]


def storing_grid(max_iter: int, gamma: float = 1.3) -> Tuple[int, ...]:
    """Iterations at which CG stores its iterate: ``ceil(gamma^j) - 1`` for
    ``j = 0 .. ceil(log(max_iter + 1) / log(gamma))``, deduplicated, sorted,
    capped at ``max_iter``."""
    if gamma <= 1.0:
        raise ValueError(f"Invalid gamma = {gamma}")
    j_max = ceil(log(max_iter + 1) / log(gamma))
    iters = sorted({int(ceil(gamma**j) - 1) for j in range(j_max + 1)})
    return tuple(i for i in iters if i <= max_iter)


class CGResult(NamedTuple):
    """Result of a CG solve.

    Row ``g`` of ``x_buf`` holds the iterate of iteration ``stored_iters[g]``
    if that iteration was reached, in the solve's ``store_dtype``; the final
    iterate is ``x``.  Unlike the
    JAX result, ``num_iters`` and ``reason`` are host integers: the loop
    already read them back to decide termination.
    """

    x: torch.Tensor  # [n] final iterate
    num_iters: int  # CG iterations performed (>= 1)
    reason: int  # termination code, see CG_REASON_STRINGS
    x_buf: torch.Tensor  # [G, n] iterates stored at the grid iterations
    # (in the store dtype)
    stored_iters: Tuple[int, ...]  # iteration number per buffer row
    m_hist: torch.Tensor  # [max_iter + 1] m(x_i); valid 0..num_iters
    nonpos_pAp: torch.Tensor  # bool, non-positive curvature detected

    def row(self, jc: int) -> torch.Tensor:
        """Stored iterate of buffer row ``jc``, in the iterate's dtype."""
        return self.x_buf[jc].to(self.x.dtype)

    @property
    def m_final(self) -> torch.Tensor:
        """Quadratic value at termination."""
        return self.m_hist[self.num_iters]

    def reached(self) -> torch.Tensor:
        """[G] bool mask: buffer rows filled before termination."""
        iters = torch.tensor(self.stored_iters, dtype=torch.int64)
        return (iters <= self.num_iters).to(self.x.device)


def cg(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    max_iter: Optional[int] = None,
    tol: float = 1e-5,
    atol: Optional[float] = None,
    martens_conv_crit: bool = False,
    store_x_at_iters: Optional[Sequence[int]] = (),
    grid_gamma: float = 1.3,
    martens_threshold: float = 5e-4,
    martens_min_window: int = 10,
    nonpos_curv_option: str = "ignore",
    store_dtype: Optional[str] = None,
) -> CGResult:
    """Preconditioned CG for ``A x = b`` with Hessian-free modifications.

    Args:
        A: matvec ``x -> A @ x`` on flat ``[n]`` vectors.
        b: right-hand side, contiguous ``[n]`` vector.
        x0: warm start (zeros if ``None``).
        M: preconditioner matvec approximating ``A^{-1}`` (identity if None).
        max_iter: iteration cap; ``n`` if None.
        tol, atol: stop when ``||r|| < max(tol * ||b||, atol)``.
        martens_conv_crit: enable Martens' relative-progress criterion.
        store_x_at_iters: iterations at which to store the iterate; ``None``
            selects the ``ceil(gamma^j) - 1`` grid, ``()`` stores nothing.
        nonpos_curv_option: "ignore" or "saddle-free".
        store_dtype: dtype name (e.g. ``"bfloat16"``) of the stored
            iterates; ``None`` stores them in ``b``'s dtype.  Only the
            buffer is rounded: the iteration itself is the same.
    """
    if nonpos_curv_option not in ("ignore", "saddle-free"):
        raise ValueError(f"Unknown option {nonpos_curv_option}.")

    n = b.shape[0]
    dtype, device = b.dtype, b.device
    max_iter = int(n if max_iter is None else max_iter)

    if store_x_at_iters is None:
        stored_iters = storing_grid(max_iter, grid_gamma)
    else:
        stored_iters = tuple(
            sorted({int(i) for i in store_x_at_iters if 0 <= int(i) <= max_iter})
        )
    G = len(stored_iters)
    slot_of_iter = {it: g for g, it in enumerate(stored_iters)}

    x = torch.zeros_like(b) if x0 is None else x0.to(dtype).contiguous()

    res_bound = tol * torch.linalg.vector_norm(b)
    if atol is not None:
        res_bound = torch.clamp(res_bound, min=atol)

    def apply_M(v):
        return M(v) if M is not None else v

    r = A(x) - b
    m_hist = torch.zeros(max_iter + 1, dtype=dtype, device=device)
    m_hist[0] = 0.5 * torch.dot(r - b, x)
    y = apply_M(r)
    ry = torch.dot(r, y)
    p = -y

    sdtype = dtype if store_dtype is None else float_dtype(
        store_dtype, "store_dtype"
    )
    x_buf = torch.zeros((max(G, 1), n), dtype=sdtype, device=device)
    if G and stored_iters[0] == 0:
        x_buf[0] = x

    nonpos = torch.zeros((), dtype=torch.bool, device=device)
    false = torch.zeros((), dtype=torch.bool, device=device)

    it = 1
    while True:
        Ap = A(p)
        pAp = torch.dot(p, Ap)
        nonpos = nonpos | (pAp <= 0)
        if nonpos_curv_option == "saddle-free":
            pAp = pAp.abs()
        alpha = ry / pAp

        x, r, m, rr = fused_cg_update(x, r, p, Ap, b, alpha)
        res_norm = torch.sqrt(rr)

        if it in slot_of_iter:
            x_buf[slot_of_iter[it]] = x
        m_hist[it] = m

        k = max(martens_min_window, it // 10)
        if martens_conv_crit and k < it:
            m_lag = m_hist[it - k]
            martens = (m - m_lag) / (m - m_hist[0]) < martens_threshold
        else:
            martens = false
        # the one host read per iteration; tests in the reference's order
        martens, diverged, within_tol = torch.stack(
            (martens, torch.isnan(res_norm), res_norm < res_bound)
        ).tolist()
        if martens:
            reason = REASON_MARTENS
        elif it >= max_iter:
            reason = REASON_MAX_ITER
        elif diverged:
            reason = REASON_DIVERGENCE
        elif within_tol:
            reason = REASON_TOLERANCES
        else:
            reason = REASON_RUNNING
        if reason != REASON_RUNNING:
            break

        if M is None:
            y, ry_new = r, rr
        else:
            y = apply_M(r)
            ry_new = torch.dot(r, y)
        beta = ry_new / ry
        p = -y + beta * p
        ry = ry_new
        it += 1

    return CGResult(
        x=x,
        num_iters=it,
        reason=reason,
        x_buf=x_buf[:G],
        stored_iters=stored_iters,
        m_hist=m_hist,
        nonpos_pAp=nonpos,
    )
