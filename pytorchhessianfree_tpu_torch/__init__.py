"""pytorchhessianfree_tpu_torch -- the Hessian-free optimizer in PyTorch.

Port of the JAX package :mod:`pytorchhessianfree_tpu` to PyTorch on an
NVIDIA H100: the same module layout, public names and solver semantics
(Martens' Hessian-free optimizer with GGN/Hessian matvecs, CG with Martens'
stop, Levenberg-Marquardt damping, CG backtracking and an Armijo line
search).  Plain tensor code is PyTorch; the CG vector phase is a CUDA
kernel written for Hopper (:func:`~.ops.cg_update.fused_cg_update`).  This
package never imports JAX.
"""

from .config import CGConfig, HFConfig, LineSearchConfig
from .ops.cg import CG_REASON_STRINGS, CGResult, cg, cg_reason_str, storing_grid
from .ops.cg_update import fused_cg_update, fused_cg_update_reference
from .ops.curvature import ggnvp_fn, hvp_fn
from .ops.select import (
    BacktrackResult,
    LinesearchResult,
    cg_efficient_backtracking,
    simple_linesearch,
)
from .optimizer import (
    HessianFree,
    HFModelFns,
    HFState,
    HFStats,
    hf_step,
    init_state,
    make_hf_step,
)
from .utils.flatten import TrainableRavel

__version__ = "0.1.0"

__all__ = [
    "CGConfig",
    "HFConfig",
    "LineSearchConfig",
    "CG_REASON_STRINGS",
    "CGResult",
    "cg",
    "cg_reason_str",
    "storing_grid",
    "fused_cg_update",
    "fused_cg_update_reference",
    "ggnvp_fn",
    "hvp_fn",
    "BacktrackResult",
    "LinesearchResult",
    "cg_efficient_backtracking",
    "simple_linesearch",
    "HessianFree",
    "HFModelFns",
    "HFState",
    "HFStats",
    "hf_step",
    "init_state",
    "make_hf_step",
    "TrainableRavel",
]
