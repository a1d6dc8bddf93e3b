"""``HessianFree.step``: one batch per step, the single-batch path (one
``linearize`` build per batch, its replay per CG iteration).

A cell's traffic holds ``batch`` (rows per step) and ``pad_to_multiple``;
every loss, the gradient and the curvature are over the step's batch."""

from __future__ import annotations

from ..reference import hf
from ..reference.problem import Problem
from ..flops import trial_losses

# the port's function whose result holds (loss, flat gradient, ...)
GRAD_SOURCE = ("optimizer", "_build_matvec_and_grad")


def rows_per_step(traffic) -> int:
    return traffic["batch"]


class Driver:
    def __init__(self, pkg, params, fns, traffic, config, span):
        self.opt = pkg.HessianFree(
            params, config=config,
            pad_to_multiple=traffic["pad_to_multiple"], **fns)

    def step(self, rows) -> dict:
        self.opt.step(rows)
        return {}


def step_flops(fam, model, traffic, record, config) -> int:
    f = fam.forward_flops(model, traffic, traffic["batch"])
    return (3 + 4 * record["num_cg_iters"]
            + trial_losses(record, config)) * f


def reference_step(ref, model, traffic, settings, params, x0, damping,
                   rows, carry, follow):
    """The frozen plain step from ``params`` with the warm start ``x0`` and
    ``damping``; returns the reference's loss, gradient, new parameters,
    warm start and damping (trees and floats) and the carry."""
    prob = Problem(ref, model, params, [rows], [rows])
    w = prob.flat.flat(params)
    value, g = prob.value_and_grad(w)
    out = hf.step(w, prob.flat.flat(x0), damping, prob.loss, g, value,
                  prob.ggn(w), settings, follow=follow)
    tree = prob.flat.tree
    return dict(loss=value, grad=tree(g), params=tree(out["w"]),
                x0=tree(out["x0"]), damping=out["damping"],
                cg_iters=out["cg_iters"], best_iter=out["best_iter"],
                lr=out["lr"], select=out["select"]), carry
