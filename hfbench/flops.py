"""Work that a Hessian-free step needs, counted from shapes and from the
step's own record, never from a measured time.

With ``F`` one forward over a batch: a gradient is ``3 F`` (the forward
and a backward of twice its cost), a Gauss-Newton matvec ``4 F`` (a
forward-mode and a reverse-mode pass through the model, each ``2 F``), a
trial loss ``F``.  Work done again only to save memory or time (a second
forward for the loss beside the gradient's, the build's trace) is not
counted."""

from __future__ import annotations

import math

from .reference.hf import storing_grid


def backtracking_losses(num_cg_iters: int, best_cg_iter: int,
                        cg_max_iter: int, gamma: float) -> int:
    """Losses the backtracking walk evaluated: the final iterate, then each
    kept iterate below it down to the chosen one, and the one after it
    that did not improve, if the walk had one left."""
    kept = [i for i in storing_grid(cg_max_iter, gamma) if i < num_cg_iters]
    if best_cg_iter == num_cg_iters:
        return 1 + (1 if kept else 0)
    below = [i for i in kept if i < best_cg_iter]
    walked = [i for i in kept if i >= best_cg_iter]
    return 1 + len(walked) + (1 if below else 0)


def linesearch_losses(lr: float, init_lr: float, beta: float,
                      max_iter: int) -> int:
    """Trials of the Armijo search: ``k + 1`` for an accepted ``init_lr
    beta^k``, all ``max_iter`` for a failed one (``lr == 0``)."""
    if lr == 0.0:
        return max_iter
    return int(round(math.log(lr / init_lr) / math.log(beta))) + 1


def trial_losses(record: dict, config) -> int:
    """Every loss a step evaluated besides its gradient's, under the
    program's ``HFConfig``: the backtracking walk, the loss at the warm
    start that the damping's reduction ratio needs, and the line search."""
    return (backtracking_losses(record["num_cg_iters"],
                                record["best_cg_iter"], config.cg_max_iter,
                                config.cg.grid_gamma)
            + (1 if config.adapt_damping else 0)
            + linesearch_losses(record["lr"], config.lr,
                                config.linesearch.beta,
                                config.linesearch.max_iter))
