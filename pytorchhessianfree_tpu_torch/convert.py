"""Carry parameters and optimizer state over from the JAX package.

The port keeps the JAX package's parameter layout (see
:mod:`.models.resnet`), so carrying weights across is a structural copy.
The functions take numpy arrays (``np.asarray`` of the JAX values), or for
:func:`specs_from_jax` the JAX package's ``PartitionSpec`` trees, which
keeps this package free of any JAX import.  They put the tensors on the
card unless the caller passes another ``device`` (``device="cpu"``, as the
parity tests do); without a card the default raises.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .optimizer import HFState
from .utils.flatten import tree_map


def params_from_jax(
    tree_of_numpy: Any,
    device: Union[str, torch.device] = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Any:
    """A JAX parameter tree given as numpy arrays -> the port's tree (same
    nesting, same leaf shapes, copied).  ``dtype`` casts floating leaves."""

    def leaf(a):
        t = torch.tensor(np.asarray(a), device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    return tree_map(leaf, tree_of_numpy)


def state_from_jax(
    x0: Any,
    damping: Any,
    step_count: Any,
    device: Union[str, torch.device] = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> HFState:
    """The port's :class:`HFState` from the fields of a JAX ``HFState``."""
    x0 = torch.tensor(np.asarray(x0), device=device)
    if dtype is not None:
        x0 = x0.to(dtype)
    return HFState(
        x0=x0,
        damping=torch.tensor(float(damping), dtype=x0.dtype, device=device),
        step_count=torch.tensor(int(step_count), device=device),
    )


def specs_from_jax(tree: Any) -> Any:
    """A JAX package ``param_specs`` / ``batch_specs`` tree -> the port's:
    each ``jax.sharding.PartitionSpec`` (recognized by its type's name,
    with no JAX import) becomes a
    :class:`~.parallel.mesh.PartitionSpec` of the same fields; ``None``
    stays ``None``; dicts, lists and tuples keep their structure."""
    from .parallel.mesh import PartitionSpec

    if tree is None:
        return None
    if type(tree).__name__ == "PartitionSpec":
        return PartitionSpec(*tuple(tree))
    if isinstance(tree, dict):
        return {k: specs_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(specs_from_jax(v) for v in tree)
    raise TypeError(f"not a spec tree: {tree!r}")
