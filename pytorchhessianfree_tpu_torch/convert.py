"""Carry parameters and optimizer state over from the JAX package.

The port keeps the JAX package's parameter layout (see
:mod:`.models.resnet`), so carrying weights across is a structural copy.
Both functions take numpy arrays (``np.asarray`` of the JAX values), which
keeps this package free of any JAX import.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .optimizer import HFState
from .utils.flatten import tree_map


def params_from_jax(
    tree_of_numpy: Any,
    device: Optional[torch.device] = None,
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
    device: Optional[torch.device] = None,
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
