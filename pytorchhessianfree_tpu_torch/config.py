"""Configuration of the Hessian-free optimizer (PyTorch port).

Field-for-field port of :mod:`pytorchhessianfree_tpu.config`: the same
frozen dataclasses, the same defaults and the same eager validation, so a
config written for one package means the same thing in the other.

Two groups of fields differ in what they do here:

- **Layout knobs with identical results** (``CGConfig.buffer_layout``,
  ``CGConfig.store_mode``, ``HFConfig.fused_trials``): they chose XLA buffer
  layouts or how many forward graphs a compiled step holds.  PyTorch runs
  eagerly, so they are accepted, validated and otherwise ignored.
- **``matmul_precision``** maps onto the two TF32 switches of PyTorch on
  CUDA, ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32``, set for the duration of a step by
  :func:`precision_ctx` and restored afterwards.  ``None`` and
  ``"highest"`` mean full f32 on both; ``"high"`` and ``"default"`` mean
  TF32 on both.  cuDNN convolutions default to TF32 on Hopper, so an unset
  knob has to switch it off explicitly.

Every other knob acts as in the JAX package: ``curvature_dtype`` (a
reduced-precision matvec, for example ``"bfloat16"``) and ``remat``
(rematerialized model forward) in ``optimizer._build_matvec_and_grad``;
``CGConfig.store_dtype`` (the stored CG iterates in a reduced dtype) in
:func:`~.ops.cg.cg`; the ``"batched"`` select modes (one ``vmap`` sweep
over the candidates) in :mod:`~.ops.select`; ``rich_stats`` (the
``HFDetail`` solver trace) in ``optimizer._step_core``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Optional

import torch


def float_dtype(name: str, what: str) -> torch.dtype:
    """The floating torch dtype called ``name`` (e.g. ``"bfloat16"``);
    ``what`` names the knob in the error."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"Unknown {what} {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class CGConfig:
    """Hyperparameters of the preconditioned-CG inner solver (see
    :class:`pytorchhessianfree_tpu.config.CGConfig`)."""

    tol: float = 1e-5
    atol: Optional[float] = None
    martens_threshold: float = 5e-4
    martens_min_window: int = 10
    grid_gamma: float = 1.3
    nonpos_curv_option: str = "ignore"
    # dtype name of the stored backtracking iterates (e.g. "bfloat16")
    store_dtype: Optional[str] = None
    # layout knob of the XLA iterate buffer; no effect here
    buffer_layout: str = "flat"
    # layout knob of the XLA off-grid store; no effect here
    store_mode: str = "cond"

    def __post_init__(self):
        if self.buffer_layout not in ("flat", "rows"):
            raise ValueError(f"Unknown buffer_layout {self.buffer_layout}")
        if self.store_mode not in ("scratch", "cond"):
            raise ValueError(f"Unknown store_mode {self.store_mode}")
        if self.grid_gamma <= 1.0:
            raise ValueError(f"Invalid gamma = {self.grid_gamma}")
        if self.nonpos_curv_option not in ("ignore", "saddle-free"):
            raise ValueError(f"Unknown option {self.nonpos_curv_option}.")


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    """Armijo backtracking line-search hyperparameters (see
    :class:`pytorchhessianfree_tpu.config.LineSearchConfig`)."""

    beta: float = 0.8
    c: float = 1e-2
    max_iter: int = 20
    mode: str = "sequential"
    # only read by the "batched" mode
    batch_chunk: Optional[int] = None

    def __post_init__(self):
        if self.beta >= 1.0:
            raise ValueError(f"Invalid reduction factor beta = {self.beta}")
        if self.c < 0.0:
            raise ValueError(f"Invalid c = {self.c}")
        if self.mode not in ("sequential", "batched"):
            raise ValueError(f"Unknown line-search mode {self.mode}")
        if self.max_iter < 1:
            raise ValueError(f"Invalid line-search max_iter {self.max_iter}")


_TF32 = {None: False, "highest": False, "high": True, "default": True}


@contextlib.contextmanager
def precision_ctx(config: "HFConfig"):
    """Set both TF32 switches from ``config.matmul_precision`` for the
    duration of the block, and restore them afterwards."""
    tf32 = _TF32[config.matmul_precision]
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
    )
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
        ) = saved


@dataclasses.dataclass(frozen=True)
class HFConfig:
    """Top-level Hessian-free optimizer configuration (see
    :class:`pytorchhessianfree_tpu.config.HFConfig`).  ``damping`` is only
    the initial damping; the live value is carried in ``HFState``."""

    curvature_opt: str = "ggn"
    damping: float = 1.0
    adapt_damping: bool = True
    cg_max_iter: Optional[int] = 250
    cg_decay_x0: float = 0.95
    use_cg_backtracking: bool = True
    lr: float = 1.0
    use_linesearch: bool = True
    verbose: bool = False
    # compile-time knob of the JAX step; the port always runs the standalone
    # routines, which evaluate the same points
    fused_trials: bool = True
    rich_stats: bool = False
    compute_final_loss: bool = True
    backtracking_mode: str = "sequential"
    curvature_dtype: Optional[str] = None
    remat: bool = False
    matmul_precision: Optional[str] = None
    precond: str = "none"
    precond_exponent: float = 0.75
    precond_reduction: str = "mean"
    cg: CGConfig = dataclasses.field(default_factory=CGConfig)
    linesearch: LineSearchConfig = dataclasses.field(
        default_factory=LineSearchConfig
    )

    def __post_init__(self):
        if self.curvature_opt not in ("hessian", "ggn"):
            raise ValueError(f"Invalid curvature_opt = {self.curvature_opt}")
        if self.damping < 0.0:
            raise ValueError(f"Invalid damping = {self.damping}")
        if self.damping == 0.0 and self.adapt_damping:
            warnings.warn("The damping is set to `0.0` and won't get adapted.")
            object.__setattr__(self, "adapt_damping", False)
        if self.cg_max_iter is not None and self.cg_max_iter < 1:
            raise ValueError(f"Invalid cg_max_iter: {self.cg_max_iter}")
        if self.lr < 0.0:
            raise ValueError(f"Invalid learning rate lr = {self.lr}")
        if self.backtracking_mode not in ("sequential", "batched"):
            raise ValueError(
                f"Unknown backtracking mode {self.backtracking_mode}"
            )
        if self.precond not in ("none", "diag_ef"):
            raise ValueError(f"Unknown precond option {self.precond}")
        if self.matmul_precision is not None and self.matmul_precision not in (
            "default",
            "high",
            "highest",
        ):
            raise ValueError(
                f"Unknown matmul_precision {self.matmul_precision}"
            )
