"""pytorchhessianfree_tpu_torch -- the Hessian-free optimizer in PyTorch.

Port of the JAX package :mod:`pytorchhessianfree_tpu` to PyTorch on an
NVIDIA H100: the same module layout, public names and solver semantics
(Martens' Hessian-free optimizer with GGN/Hessian matvecs, CG with Martens'
stop, Levenberg-Marquardt damping, CG backtracking and an Armijo line
search, Nystrom preconditioning, Lanczos/SLQ spectra and checkpoints).
Plain tensor code is PyTorch; the CG vector phase is a CUDA kernel written
for Hopper (:func:`~.ops.cg_update.fused_cg_update`).  This package never
imports JAX.

As in the JAX package, ``checkpoint`` is the checkpoint module
(:mod:`.checkpoint`); the rematerializing wrapper is
:func:`.utils.remat.checkpoint`.
"""

from .config import CGConfig, HFConfig, LineSearchConfig
from .ops.cg import CG_REASON_STRINGS, CGResult, cg, cg_reason_str, storing_grid
from .ops.cg_update import fused_cg_update, fused_cg_update_reference
from .ops.curvature import ggnvp_fn, hvp_fn
from .ops.precond import (
    EMADiag,
    diag_EF,
    diag_EF_preconditioner,
    diag_EF_scan,
    diag_to_preconditioner,
)
from .ops.nystrom import (
    NystromSketch,
    nystrom_sketch,
    nystrom_to_preconditioner,
)
from .ops.spectrum import (
    LanczosResult,
    RitzResult,
    lanczos,
    normalized_probes,
    ritz,
    slq,
    slq_density,
    slq_trace,
)
from .ops.select import (
    BacktrackResult,
    LinesearchResult,
    cg_backtracking,
    cg_efficient_backtracking,
    simple_linesearch,
)
from .accumulate import (
    StackedData,
    acc_grad,
    acc_loss,
    acc_reduce,
    make_acc_mvp,
    pad_ragged_datalist,
    weighted_fns,
)
from .optimizer import (
    HessianFree,
    HFDetail,
    HFModelFns,
    HFState,
    HFStats,
    check_deterministic,
    check_reduction,
    format_rich_stats,
    hf_acc_step,
    hf_step,
    init_state,
    make_hf_acc_step,
    make_hf_step,
    make_hf_train_loop,
)
from .models import (
    decoder_lm_apply,
    init_decoder_lm,
    init_moe_decoder_lm,
    init_transformer,
    moe_decoder_lm_apply,
    next_token_loss,
    transformer_apply,
)
from .utils.flatten import TrainableRavel
from . import checkpoint  # the checkpoint module, as in the JAX package

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
    "EMADiag",
    "diag_EF",
    "diag_EF_preconditioner",
    "diag_EF_scan",
    "diag_to_preconditioner",
    "BacktrackResult",
    "LinesearchResult",
    "cg_backtracking",
    "cg_efficient_backtracking",
    "simple_linesearch",
    "NystromSketch",
    "nystrom_sketch",
    "nystrom_to_preconditioner",
    "LanczosResult",
    "RitzResult",
    "lanczos",
    "normalized_probes",
    "ritz",
    "slq",
    "slq_density",
    "slq_trace",
    "StackedData",
    "acc_grad",
    "acc_loss",
    "acc_reduce",
    "make_acc_mvp",
    "pad_ragged_datalist",
    "weighted_fns",
    "HessianFree",
    "HFModelFns",
    "HFState",
    "HFStats",
    "HFDetail",
    "format_rich_stats",
    "check_deterministic",
    "check_reduction",
    "hf_acc_step",
    "hf_step",
    "init_state",
    "make_hf_acc_step",
    "make_hf_step",
    "make_hf_train_loop",
    "decoder_lm_apply",
    "init_decoder_lm",
    "init_moe_decoder_lm",
    "init_transformer",
    "moe_decoder_lm_apply",
    "next_token_loss",
    "transformer_apply",
    "TrainableRavel",
    "checkpoint",
]
