"""Analytic target functions as pseudo-models (port of
:mod:`pytorchhessianfree_tpu.models.targetfunc`).

The reference's ``TargetFuncModel`` wraps a callable and a parameter tensor
so that deterministic functions (quadratics, Rosenbrock) can be driven by
the optimizer.  Here a "model" is ``loss_fn(params, batch)`` with
``batch = None``, used with ``curvature_opt="hessian"``.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from ..optimizer import HFModelFns


def target_func_fns(func: Callable[[torch.Tensor], torch.Tensor]) -> HFModelFns:
    """Wrap ``func(x) -> scalar`` as optimizer model fns over the parameter
    tree ``{"x": tensor}``; the batch is ignored (pass ``None``)."""

    def loss_fn(params, batch):
        del batch
        return func(params["x"])

    return HFModelFns(loss_fn=loss_fn)


def rosenbrock(
    x: torch.Tensor, a: float = 1.0, b: float = 100.0
) -> torch.Tensor:
    """The 2-D Rosenbrock function ``(a - x0)^2 + b (x1 - x0^2)^2``, with its
    minimum at ``(a, a^2)``."""
    return (a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2


def rosenbrock_problem(
    init: Tuple[float, float] = (-0.5, 1.5),
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
):
    """Initial params (on the card unless ``device`` says otherwise) and
    model fns for the Rosenbrock workload."""
    params = {"x": torch.tensor(init, dtype=dtype, device=device)}
    return params, target_func_fns(rosenbrock)


def quadratic_problem(
    A: torch.Tensor, b: torch.Tensor, c, x_init: torch.Tensor
):
    """The quadratic ``0.5 x^T A x + b^T x + c`` as an optimizer problem."""

    def quad(x):
        return 0.5 * x @ (A @ x) + b @ x + c

    params = {"x": torch.as_tensor(x_init).clone()}
    return params, target_func_fns(quad)
