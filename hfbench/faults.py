"""Faults planted under the timed path, to show that the comparison that
decides ``correct`` catches them (``run.py --fault``; the tests).  Never
used by a benchmark run."""

from __future__ import annotations

import contextlib

FAULTS = ("frozen", "half_batch", "choice")


def half_batch(loss_outer):
    """The loss over the first half of the rows only: half of the batch
    left out, the mean taken over the rest."""

    def loss(outputs, targets):
        keep = max(1, outputs.shape[0] // 2)
        return loss_outer(outputs[:keep], targets[:keep])

    return loss


@contextlib.contextmanager
def planted(fault, fns):
    """Plant ``fault``; yields the program's callables to build with."""
    if fault is None:
        yield fns
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    if fault == "half_batch":
        yield dict(fns, loss_outer=half_batch(fns["loss_outer"]))
        return
    from pytorchhessianfree_tpu_torch import optimizer

    if fault == "choice":
        # the backtracking's answer altered where it is produced: the
        # lowest kept iterate (the warm start) in place of the walk's
        walk = optimizer.cg_efficient_backtracking

        def lowest(f, cgres, mode="sequential"):
            bt = walk(f, cgres, mode=mode)
            step = cgres.row(0)
            return bt._replace(best_iter=cgres.stored_iters[0], step=step,
                               f_best=f(step))

        optimizer.cg_efficient_backtracking = lowest
        try:
            yield fns
        finally:
            optimizer.cg_efficient_backtracking = walk
        return
    core = optimizer._step_core

    def frozen(config, ravel, params, state, **kwargs):
        return (params, state) + tuple(core(config, ravel, params, state,
                                            **kwargs)[2:])

    optimizer._step_core = frozen
    try:
        yield fns
    finally:
        optimizer._step_core = core
