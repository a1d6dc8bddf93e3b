"""Matrix-free curvature-vector products: HVP and GGN-VP (port of
:mod:`pytorchhessianfree_tpu.ops.curvature`).

Both builders do the nonlinear work once per batch and return a matvec
closure that the CG loop calls once per iteration:

- ``ggnvp_fn``: ``torch.func.linearize`` of the model gives ``J v`` by
  replaying a traced tangent graph (the primal is not recomputed), and
  ``torch.func.vjp`` of the model gives ``J^T``.  Each matvec is then
  ``J v`` -> jvp of ``grad(loss_outer)`` at the outputs -> ``J^T``.
- ``hvp_fn``: ``torch.func.linearize`` of ``(grad, value)`` of the loss,
  forward over reverse.

Both work on parameter trees; the optimizer converts to and from the flat
CG vector space with :class:`~.utils.flatten.TrainableRavel`.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.func import grad, grad_and_value, jvp, linearize, vjp


def hvp_fn(
    loss_fn: Callable[[Any], torch.Tensor], params: Any
) -> Tuple[torch.Tensor, Any, Callable[[Any], Any]]:
    """Hessian-vector product of ``loss_fn`` at ``params``.

    Returns ``(loss, grad, hvp)`` with ``hvp(v) = H @ v`` on trees.
    """
    (grad_tree, loss), tangent_fn = linearize(grad_and_value(loss_fn), params)

    def hvp(v: Any) -> Any:
        return tangent_fn(v)[0]

    return loss, grad_tree, hvp


def ggnvp_fn(
    model_fn: Callable[[Any], Any],
    loss_outer: Callable[[Any], torch.Tensor],
    params: Any,
) -> Tuple[torch.Tensor, Any, Any, Callable[[Any], Any]]:
    """GGN-vector product ``Gv = J^T H_L (J v)``.

    Returns ``(loss, outputs, grad, ggnvp)``: ``grad`` is the gradient of
    ``loss_outer(model_fn(params))`` and ``ggnvp(v)`` maps a tangent tree to
    ``G @ v``.
    """
    outputs, vjp_of_model = vjp(model_fn, params)
    _, jvp_of_model = linearize(model_fn, params)
    loss_grad_fn = grad(loss_outer)

    loss = loss_outer(outputs)
    grad_tree = vjp_of_model(loss_grad_fn(outputs))[0]

    def ggnvp(v: Any) -> Any:
        Jv = jvp_of_model(v)
        HJv = jvp(loss_grad_fn, (outputs,), (Jv,))[1]
        return vjp_of_model(HJv)[0]

    return loss, outputs, grad_tree, ggnvp
