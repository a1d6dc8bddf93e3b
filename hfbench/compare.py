"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out again, each held to a limit of
the cell's traffic file.

Over the first steps that set-up drives, the reference recomputes each step
from the program's parameters, warm start and damping before it:

- ``loss``: each step's loss, ``|a - b| / |b|``;
- ``grad``: the first step's flat gradient as the optimizer got it, by the
  worst leaf (:func:`worst_leaf_gap`);
- ``select``: by how much the reference's loss at the iterate that the
  program's backtracking chose lies above the loss of the reference's own
  choice, relative to it (:func:`~.reference.hf.step`);
- ``update``: each step's change of the parameters, by the worst leaf,
  the reference going on from the program's chosen iterate;
- ``state``: each step's next warm start by the worst leaf, and its next
  damping, ``|a - b| / b``;
- ``precond``: each step's preconditioner diagonal (the moving average the
  step used), by the worst leaf, where the step has one.

A number is the largest over the steps.  A cell's limit of null for a
number means it is read and printed, not compared.  The changes leave out the leaves
whose reference gradient is nought to rounding (:func:`sound_leaves`),
which only rounding moves."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch

# a leaf whose reference gradient is below this share of the median leaf's
# moves by rounding alone and is left out of the comparisons of changes
NOUGHT = 1e-3


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {p: float(torch.linalg.vector_norm(t.double())) for p, t in
            tree.items()}


def sound_leaves(grad_norms: Dict[str, float]) -> set:
    """Leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad_norms.values())
    return {p for p, g in grad_norms.items() if g >= NOUGHT * med}


def worst_leaf(program: Dict[str, torch.Tensor],
               reference: Dict[str, torch.Tensor],
               keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The largest ``| |a| - |b| | / max(|b|, median |b|)`` over the leaves
    (``keep`` only, where given), ``a`` the program's leaf, ``b`` the
    reference's, ``|.|`` the 2-norm; and the leaf's path."""
    if set(program) != set(reference):
        raise ValueError("the program's and the reference's leaves differ: "
                         f"{sorted(set(program) ^ set(reference))[:4]}")
    paths = sorted(reference if keep is None else set(keep))
    a, b = norms({p: program[p] for p in paths}), norms(
        {p: reference[p] for p in paths})
    floor = statistics.median(b.values())
    return max((abs(a[p] - b[p]) / max(b[p], floor, 1e-300), p)
               for p in paths)


def worst_leaf_gap(program, reference, keep=None) -> float:
    return worst_leaf(program, reference, keep)[0]


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)
