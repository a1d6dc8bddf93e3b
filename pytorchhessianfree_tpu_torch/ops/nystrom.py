"""Randomized Nystrom low-rank preconditioner for the damped CG solve (port
of :mod:`pytorchhessianfree_tpu.ops.nystrom`).

Method (Tropp, Yurtsever, Udell & Cevher 2017 for the stabilized sketch;
Frangella, Tropp & Udell 2021, "Randomized Nystrom Preconditioning", for
the ``(A + mu I)`` preconditioner):

1. sketch ``Y = A @ Q`` for an orthonormalized probe block ``Q [n, r]``:
   ``r`` curvature matvecs in one ``torch.func.vmap`` of the matvec that
   CG uses;
2. shift by ``nu = sqrt(n) * eps * ||Y||_F``, take the clipped inverse
   square root of the symmetrized ``[r, r]`` core (``eigh``: an indefinite
   Hessian keeps its PSD part) and a thin SVD, giving the eigenpairs
   ``(U [n, r], eigs [r])`` of the approximation ``A_hat ⪯ A``;
3. the damped-system preconditioner

   ``P^{-1} v = (eigs_r + mu) * U ((eigs + mu)^{-1} (U^T v)) + (v - U U^T v)``

The thin SVD of the tall ``B [n, r]`` is a QR of ``B`` followed by an SVD
of the ``[r, r]`` factor, which keeps the decomposition of an ``n``-row
matrix to one QR.  Singular vectors may differ from the JAX package's in
sign; ``eigs``, ``U diag(eigs) U^T`` and ``P^{-1}`` do not.  The ``[n, r]``
products are plain matmuls, as in the JAX package.  Eager steps take the
optional sketch directly (``precond_lowrank=None``), so the JAX package's
``lowrank_arg`` calling convention for jitted steps has no counterpart.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class NystromSketch(NamedTuple):
    """Rank-``r`` eigensketch ``A_hat = U diag(eigs) U^T`` of a PSD operator:
    ``U [n, r]`` with orthonormal columns, ``eigs [r]`` descending and
    ``>= 0``."""

    U: torch.Tensor
    eigs: torch.Tensor

    @property
    def rank(self) -> int:
        return self.U.shape[1]


def nystrom_sketch(
    mvp: Callable[[torch.Tensor], torch.Tensor],
    probes: torch.Tensor,
) -> NystromSketch:
    """Randomized Nystrom eigensketch of a PSD matvec.

    Args:
        mvp: PSD matrix-vector product on flat ``[n]`` vectors (the
            *undamped* operator; damping enters in
            :func:`nystrom_to_preconditioner`).  It must support
            ``torch.func.vmap``, as the optimizer's matvecs do.
        probes: ``[r, n]`` probe rows of full row rank (e.g. from
            :func:`~.spectrum.normalized_probes`); orthonormalized here.

    Returns:
        :class:`NystromSketch`, eigenvalues clipped to ``>= 0`` and
        descending; exact (up to the shift) whenever ``rank(A) <= r``.
    """
    if probes.ndim != 2:
        raise ValueError(
            f"probes must be [r, n], got shape {tuple(probes.shape)}"
        )
    r, n = probes.shape
    if r > n:
        raise ValueError(f"rank r={r} exceeds dimension n={n}")
    Q, _ = torch.linalg.qr(probes.T)  # [n, r], orthonormal columns
    Y = torch.func.vmap(mvp)(Q.T).T  # [n, r] = A @ Q, batched matvecs
    eps = torch.finfo(Y.dtype).eps
    nu = math.sqrt(n) * eps * torch.linalg.norm(Y)
    Y_nu = Y + nu * Q
    core = Q.T @ Y_nu
    core = (core + core.T) / 2.0
    d, W = torch.linalg.eigh(core)
    floor = eps * torch.clamp(d.abs().max(), min=eps)
    keep = d > floor
    inv_sqrt = torch.where(
        keep, 1.0 / torch.sqrt(torch.where(keep, d, torch.ones_like(d))),
        torch.zeros_like(d),
    )
    B = Y_nu @ (W * inv_sqrt)  # [n, r]
    QB, R = torch.linalg.qr(B)
    Ur, s, _ = torch.linalg.svd(R)
    eigs = torch.clamp(s * s - nu, min=0.0)
    return NystromSketch(U=QB @ Ur, eigs=eigs)


def nystrom_to_preconditioner(
    sketch: NystromSketch, damping
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The damped-system preconditioner ``M(v) ~= (A + damping I)^{-1} v``
    (Frangella et al. 2021, eq. 5.2), the ``M`` contract of
    :func:`~.precond.diag_to_preconditioner`:

        P^{-1} v = (eigs_r + mu) * U ((eigs + mu)^{-1} (U^T v))
                   + (v - U (U^T v))

    SPD for any ``damping > 0``; the identity on the complement of the
    sketch (the padding tail of a ``TrainableRavel`` included)."""
    U, eigs = sketch.U, sketch.eigs
    lam_r = eigs[-1]

    def M_func(v: torch.Tensor) -> torch.Tensor:
        Utv = U.T @ v
        low = U @ ((lam_r + damping) / (eigs + damping) * Utv)
        return low + (v - U @ Utv)

    return M_func
