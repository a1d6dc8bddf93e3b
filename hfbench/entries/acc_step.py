"""``HessianFree.get_preconditioner`` + ``HessianFree.acc_step``: the
large-batch, preconditioned path (one-shot products chunk by chunk, no
``linearize``).

A cell's traffic holds ``chunks`` of ``chunk`` rows per step, of which the
first ``curvature_chunks`` carry the curvature and the preconditioner's
empirical-Fisher diagonal, averaged over steps with ``ema_decay``; the loss
and the gradient are over all the chunks."""

from __future__ import annotations

from ..reference import hf
from ..reference.problem import Problem
from ..flops import trial_losses

GRAD_SOURCE = ("optimizer", "_acc_parts")


def rows_per_step(traffic) -> int:
    return traffic["chunks"] * traffic["chunk"]


def _chunks(rows, traffic):
    x, y = rows
    c = traffic["chunk"]
    return [(x[i * c:(i + 1) * c], y[i * c:(i + 1) * c])
            for i in range(traffic["chunks"])]


def _curvature_rows(rows, traffic):
    x, y = rows
    k = traffic["curvature_chunks"] * traffic["chunk"]
    return x[:k], y[:k]


class Driver:
    def __init__(self, pkg, params, fns, traffic, config, span):
        self.opt = pkg.HessianFree(
            params, config=config,
            pad_to_multiple=traffic["pad_to_multiple"], **fns)
        self.ema = pkg.EMADiag(traffic["ema_decay"])
        self.traffic, self.span = traffic, span

    def step(self, rows) -> dict:
        chunks = _chunks(rows, self.traffic)
        with self.span("precond"):
            diag = self.ema.update(self.opt.get_preconditioner(
                *_curvature_rows(rows, self.traffic), "mean"))
        self.opt.acc_step(
            chunks, mvp_data=chunks[:self.traffic["curvature_chunks"]],
            precond_diag=diag)
        return {"diag": diag}


def step_flops(fam, model, traffic, record, config) -> int:
    f_loss = fam.forward_flops(model, traffic, rows_per_step(traffic))
    f_curv = fam.forward_flops(
        model, traffic, traffic["curvature_chunks"] * traffic["chunk"])
    return ((3 + trial_losses(record, config)) * f_loss
            + (4 * record["num_cg_iters"] + 3) * f_curv)


def reference_step(ref, model, traffic, settings, params, x0, damping,
                   rows, carry, follow):
    """The frozen plain step, preconditioned by the EMA of the reference's
    own diagonals (``carry``, ``None`` before the first step)."""
    chunks = _chunks(rows, traffic)
    prob = Problem(ref, model, params, chunks,
                   chunks[:traffic["curvature_chunks"]])
    w = prob.flat.flat(params)
    value, g = prob.value_and_grad(w)
    d = prob.diag(w, *_curvature_rows(rows, traffic))
    decay = traffic["ema_decay"]
    ema = d if carry is None else decay * carry + (1 - decay) * d
    out = hf.step(w, prob.flat.flat(x0), damping, prob.loss, g, value,
                  prob.ggn(w), settings, diag=ema, follow=follow)
    tree = prob.flat.tree
    return dict(loss=value, grad=tree(g), params=tree(out["w"]),
                x0=tree(out["x0"]), damping=out["damping"], diag=tree(ema),
                cg_iters=out["cg_iters"], best_iter=out["best_iter"],
                lr=out["lr"], select=out["select"]), ema
