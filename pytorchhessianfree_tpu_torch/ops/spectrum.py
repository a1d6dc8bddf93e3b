"""Curvature-spectrum diagnostics: Lanczos Ritz values and stochastic
Lanczos quadrature (SLQ) (port of :mod:`pytorchhessianfree_tpu.ops.spectrum`).

Matrix-free spectral diagnostics of the flat curvature operators CG solves
against: ``lambda_max`` and the top Ritz values (is the damping in the
right decade?), negative Ritz values on the Hessian path (saddles), and
SLQ spectral densities and trace estimates.

:func:`lanczos` is a Python loop over a preallocated ``[k, n]`` basis whose
unfilled rows are zero, so full reorthogonalization is two ``[k, n] x [n]``
products against the whole buffer, and a breakdown is handled with
``torch.where``: no iteration reads a value back to the host.

References (methods, public): Lanczos with full reorthogonalization (Paige
1971; Golub & Van Loan ch. 10), stochastic Lanczos quadrature (Ubaru, Chen
& Saad 2017; Ghorbani, Krishnan & Xiao 2019 for deep-net Hessians).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

MatVec = Callable[[torch.Tensor], torch.Tensor]


class LanczosResult(NamedTuple):
    """Tridiagonalization ``T = V A V^T`` of a symmetric operator.

    ``alpha[j] = v_j^T A v_j`` is the diagonal of ``T``; ``beta[j]`` couples
    ``v_j`` and ``v_{j+1}`` (``T`` uses ``beta[:-1]``; ``beta[-1]`` is the
    residual norm of the Kaniel-Paige bound).  After a breakdown (``beta_j``
    below the tolerance: an invariant Krylov subspace) the remaining entries
    are zero, so the trailing block adds spurious zero eigenvalues whose
    first-component weights are exactly zero.  ``basis`` is the ``[k, n]``
    row stack of Lanczos vectors when requested, else ``None``.
    """

    alpha: torch.Tensor
    beta: torch.Tensor
    basis: Optional[torch.Tensor]


def lanczos(
    mvp: MatVec,
    v0: torch.Tensor,
    num_iters: int,
    *,
    reorth: bool = True,
    keep_basis: bool = False,
    breakdown_tol: float = 1e-8,
) -> LanczosResult:
    """Run ``num_iters`` Lanczos iterations of a symmetric ``mvp``.

    Args:
        mvp: Symmetric matrix-vector product on flat vectors.
        v0: Start vector (normalized here; must be nonzero).
        num_iters: Krylov dimension ``k``.
        reorth: Full reorthogonalization against every stored basis vector,
            twice (classical Gram-Schmidt applied twice).  Essential in f32
            for eigenvalue work; SLQ densities conventionally run without.
        keep_basis: Return the ``[k, n]`` basis (stored anyway when
            ``reorth``; memory ``k * n`` elements).
        breakdown_tol: ``beta`` below this is treated as exact breakdown.
    """
    if num_iters < 1:
        raise ValueError(f"num_iters must be >= 1, got {num_iters}")
    v_cur = v0 / torch.linalg.vector_norm(v0)
    # built from v_cur, so that under vmap (slq) the basis is batched too
    V = (
        torch.stack([torch.zeros_like(v_cur)] * num_iters)
        if reorth or keep_basis
        else None
    )
    v_prev = torch.zeros_like(v_cur)
    beta_prev = v_cur.new_zeros(())
    alphas, betas = [], []
    for j in range(num_iters):
        if V is not None:
            V[j] = v_cur
        w = mvp(v_cur)
        alpha_j = torch.dot(v_cur, w)
        w = w - alpha_j * v_cur - beta_prev * v_prev
        if reorth:
            # unfilled rows of V are zero and project out nothing
            for _ in range(2):
                w = w - (V @ w) @ V
        beta_j = torch.linalg.vector_norm(w)
        ok = beta_j > breakdown_tol
        v_next = torch.where(
            ok, w / torch.where(ok, beta_j, torch.ones_like(beta_j)),
            torch.zeros_like(w),
        )
        beta_j = torch.where(ok, beta_j, torch.zeros_like(beta_j))
        alphas.append(alpha_j)
        betas.append(beta_j)
        v_prev, v_cur, beta_prev = v_cur, v_next, beta_j
    return LanczosResult(
        torch.stack(alphas), torch.stack(betas), V if keep_basis else None
    )


def tridiag_eigh(
    alpha: torch.Tensor, beta: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of the Lanczos tridiagonal: ``alpha`` is the
    ``[k]`` diagonal, ``beta[:-1]`` the off-diagonal.  Returns ``(theta,
    Y)`` with ``theta`` ascending, as :func:`torch.linalg.eigh`."""
    off = beta[:-1]
    T = (
        torch.diag_embed(alpha)
        + torch.diag_embed(off, 1)
        + torch.diag_embed(off, -1)
    )
    return torch.linalg.eigh(T)


class RitzResult(NamedTuple):
    """Ritz approximations to the operator's eigenvalues, descending.

    ``residual_bounds[i] = |beta_k * Y[k-1, i]|`` bounds the distance from
    ``values[i]`` to some true eigenvalue (Kaniel-Paige); ``weights[i] =
    Y[0, i]^2`` is the start vector's overlap, exactly zero for the spurious
    zeros a breakdown appends.
    """

    values: torch.Tensor
    residual_bounds: torch.Tensor
    weights: torch.Tensor


def ritz(
    mvp: MatVec,
    v0: torch.Tensor,
    num_iters: int,
    *,
    reorth: bool = True,
    breakdown_tol: float = 1e-8,
) -> RitzResult:
    """Ritz values of ``mvp`` from one Lanczos run (extremal eigenvalues
    converge first)."""
    res = lanczos(
        mvp, v0, num_iters, reorth=reorth, breakdown_tol=breakdown_tol
    )
    theta, Y = tridiag_eigh(res.alpha, res.beta)
    bounds = torch.abs(res.beta[-1] * Y[-1, :])
    weights = Y[0, :] ** 2
    # descending; ties in reverse index order, as the JAX package orders
    order = torch.argsort(theta, stable=True).flip(0)
    return RitzResult(theta[order], bounds[order], weights[order])


def slq(
    mvp: MatVec,
    probes: torch.Tensor,
    num_iters: int,
    *,
    reorth: bool = False,
    breakdown_tol: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic Lanczos quadrature: Gauss nodes and weights per probe.

    For each unit-norm probe row ``v`` the Lanczos tridiagonal gives a
    ``num_iters``-point Gauss quadrature of the spectral measure
    ``sum_i <v, u_i>^2 delta(lambda - lambda_i)``: nodes are the Ritz
    values, weights the squared first eigenvector components; it is exact
    for polynomials up to degree ``2 * num_iters - 1``.

    The probes run through ``torch.func.vmap`` of one Lanczos run, so every
    iteration makes one batched matvec for all probes, as the JAX package's
    ``vmap`` does; ``mvp`` must support ``vmap``, as the optimizer's
    matvecs do.

    Returns:
        ``(nodes, weights)`` of shape ``[num_probes, num_iters]``; each
        row's weights sum to 1.
    """

    def one(v):
        res = lanczos(
            mvp, v, num_iters, reorth=reorth, breakdown_tol=breakdown_tol
        )
        theta, Y = tridiag_eigh(res.alpha, res.beta)
        return theta, Y[0, :] ** 2

    return torch.func.vmap(one)(probes)


def slq_trace(
    nodes: torch.Tensor,
    weights: torch.Tensor,
    dim: int,
    f: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Estimate of ``trace(f(A))`` from SLQ nodes and weights:
    ``dim * mean_probes sum_i w_i f(theta_i)`` (``f=None``: ``trace(A)``)."""
    vals = nodes if f is None else f(nodes)
    return dim * torch.mean(torch.sum(weights * vals, dim=-1))


def slq_density(
    nodes: torch.Tensor,
    weights: torch.Tensor,
    grid: torch.Tensor,
    sigma: float,
) -> torch.Tensor:
    """Gaussian-smoothed spectral density on ``grid`` (integrates to ~1):
    the mean over probes of ``sum_i w_i N(grid; theta_i, sigma)``."""
    z = (grid[:, None, None] - nodes[None, :, :]) / sigma
    kern = torch.exp(-0.5 * z * z) / (sigma * math.sqrt(2.0 * math.pi))
    return torch.mean(torch.sum(weights[None, :, :] * kern, dim=-1), dim=-1)


def normalized_probes(
    generator: torch.Generator,
    num_probes: int,
    dim: int,
    dtype: torch.dtype = torch.float32,
    *,
    pad_to: Optional[int] = None,
) -> torch.Tensor:
    """Unit-norm Rademacher probe rows ``[num_probes, dim]``, drawn from
    ``generator`` on its device, optionally zero-padded to ``pad_to``
    columns (probes for a padded ``TrainableRavel`` space live in the
    unpadded subspace, where the curvature operator acts)."""
    if pad_to is not None and pad_to < dim:
        raise ValueError(f"pad_to={pad_to} < dim={dim}")
    r = torch.randint(
        0, 2, (num_probes, dim), generator=generator,
        device=generator.device, dtype=dtype,
    )
    r = (2 * r - 1) / math.sqrt(dim)  # every row has norm 1
    if pad_to is not None:
        r = torch.nn.functional.pad(r, (0, pad_to - dim))
    return r
