"""``torch.nn.Module`` adapter (port of the flax / dm-haiku adapters of
:mod:`pytorchhessianfree_tpu.interop`).

The reference takes any ``torch.nn.Module`` plus a loss closure (reference
optimizer.py:126-154); the JAX package's on-ramp was flax and haiku.  Here
the module is called functionally, ``torch.func.functional_call(module,
(params, buffers), x)``, with ``params`` the tree the optimizer ravels and
updates, so every transform of the step (``vjp``, ``linearize``, ``jvp``,
``vmap``) sees a pure function of the parameters.  The determinism contract
is the JAX package's:

- **Buffers are frozen within a step.**  Every evaluation inside one HF step
  -- the gradient, every CG curvature matvec, every backtracking and
  line-search trial forward -- sees the same buffers (BatchNorm running
  statistics), so CG's fixed quadratic model holds.  A module whose forward
  would update a buffer (``nn.BatchNorm*`` in training mode with
  ``track_running_stats=True``) raises instead of mutating it silently, as
  flax raises for an immutable collection; batch-statistics BatchNorm
  (``track_running_stats=False``) is allowed.  Refresh running statistics
  *between* steps with :func:`module_state_update`.
- **Randomness rides in the batch** (``rng_in_batch=True``: ``inputs = (x,
  seed)``).  Every ``F.dropout`` / ``dropout1d/2d/3d`` of the forward draws
  its keep-mask from a ``torch.Generator`` seeded from ``(seed, i)``, ``i``
  the call's index in the forward, with PyTorch's dispatch modes off, so the
  gradient, each one-shot matvec, each trial forward and the replay of
  ``torch.func.linearize``'s trace all see one set of masks (a trace would
  otherwise record the draw as an op and replay it with other masks).  The
  masks are those of :func:`~.models.mlp.mlp_dropout_apply` for the same
  seed.  Advance the seed between steps like any other batch data.  Without
  ``rng_in_batch``, a dropout that is active (training mode, ``p > 0``)
  raises: it would draw new masks on every evaluation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.nn.modules.batchnorm import _NormBase
from torch.overrides import TorchFunctionMode

from .models.mlp import _keep_mask
from .optimizer import HFModelFns

__all__ = [
    "split_module_state",
    "module_fns",
    "module_state_update",
]

# dropout functions -> number of trailing (feature) dims a mask broadcasts
# over: 0 drops elements, k drops whole channels of a k-d feature map
_DROPOUT_DIMS = {F.dropout: 0, F.dropout1d: 1, F.dropout2d: 2, F.dropout3d: 3}
# drawn from the global generator, with no seeded counterpart here
_UNSEEDED = (F.alpha_dropout, F.feature_alpha_dropout)


def split_module_state(
    module: torch.nn.Module,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(params, buffers)``: detached copies of the module's parameters and
    buffers, each a dict keyed by the module's own names (``"0.weight"``,
    ``"1.running_mean"``).  ``params`` is what the optimizer sees;
    ``buffers`` is passed to :func:`module_fns` and refreshed with
    :func:`module_state_update`.  Copies, so that neither the optimizer nor
    a later training-mode forward of the module changes the other."""
    params = {k: v.detach().clone() for k, v in module.named_parameters()}
    buffers = {k: v.detach().clone() for k, v in module.named_buffers()}
    return params, buffers


class _SeededDropout(TorchFunctionMode):
    """Replace each active dropout of a forward by a mask drawn from
    ``(seed, call index)``; with ``seed=None`` an active dropout raises,
    unless ``draw_unseeded`` lets it draw from the global generator."""

    def __init__(self, seed: Optional[int], draw_unseeded: bool = False):
        super().__init__()
        self.seed = seed
        self.draw_unseeded = draw_unseeded
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        k = _DROPOUT_DIMS.get(func)
        if k is None and func not in _UNSEEDED:
            return func(*args, **kwargs)
        bound = dict(zip(("input", "p", "training", "inplace"), args))
        bound.update(kwargs)
        x, p = bound["input"], bound.get("p", 0.5)
        training = bound.get("training", func not in _UNSEEDED)
        if not training or p == 0 or (self.seed is None and self.draw_unseeded):
            return func(*args, **kwargs)
        if self.seed is None or k is None:
            raise RuntimeError(
                f"module_fns: {func.__name__} is active (training mode, p = "
                f"{p}) and would draw new masks on every evaluation of a "
                "step, which breaks CG's fixed quadratic model. "
                + ("Pass rng_in_batch=True and inputs (x, seed), or call "
                   ".eval() on the dropout." if k is not None else
                   "It has no seeded form here; call .eval() on it.")
            )
        keep = 1.0 - p
        shape = x.shape if k == 0 else x.shape[: x.ndim - k] + (1,) * k
        mask = _keep_mask(shape, self.seed, self.calls, keep, x.device)
        self.calls += 1
        if keep == 0.0:
            return x * 0
        return torch.where(mask, x / keep, x.new_zeros(()))


def _refuse_buffer_updates(module: torch.nn.Module) -> None:
    for name, m in module.named_modules():
        if isinstance(m, _NormBase) and m.training and m.track_running_stats:
            raise RuntimeError(
                f"module_fns: {name or 'the module'} ({type(m).__name__}) "
                "is in training mode with track_running_stats=True: its "
                "forward would update running statistics, which stay frozen "
                "within a step. Call .eval() on it (running statistics, "
                "refreshed between steps with module_state_update), or build "
                "it with track_running_stats=False (batch statistics)."
            )


def _version(t: torch.Tensor) -> Optional[int]:
    """In-place version counter of a plain tensor; ``None`` for a tensor
    wrapped by a transform (its counter is not the buffer's)."""
    if torch._C._functorch.is_functorch_wrapped_tensor(t):
        return None
    return t._version


def module_fns(
    module: torch.nn.Module,
    loss_outer: Optional[Callable[[Any, Any], torch.Tensor]] = None,
    *,
    buffers: Optional[Dict[str, torch.Tensor]] = None,
    buffers_in_batch: bool = False,
    rng_in_batch: bool = False,
    forward_kwargs: Optional[dict] = None,
    loss_reg: Optional[Callable[[Any], torch.Tensor]] = None,
) -> HFModelFns:
    """Wrap a ``torch.nn.Module`` as :class:`~.optimizer.HFModelFns` (split
    form): ``model_fn(params, inputs)`` calls
    ``torch.func.functional_call(module, (params, buffers), (x,),
    forward_kwargs)`` with ``params`` from :func:`split_module_state`.

    ``buffers``: the buffers to close over, FROZEN for every evaluation
    (a copy of the module's own, from :func:`split_module_state`, if
    ``None``).  ``buffers_in_batch=True`` takes them from the batch instead
    -- inputs ``(x, buffers)``, or ``(x, seed, buffers)`` with
    ``rng_in_batch`` -- so refreshed statistics can be passed step by step
    without building new fns.  Batch-mapping transforms (``diag_EF`` and
    the batched modes ``vmap`` the inputs) then map the buffers too, as the
    JAX package maps its state in the batch.

    ``rng_in_batch=True``: inputs are ``(x, seed)`` with an integer seed,
    and every active dropout draws the masks of that seed (module
    docstring).  The module's mode decides which dropouts and norms are
    active; the adapter never changes it.
    """
    if buffers_in_batch and buffers is not None:
        raise ValueError("Pass buffers or buffers_in_batch=True, not both.")
    frozen = None
    if not buffers_in_batch:
        frozen = dict(
            split_module_state(module)[1] if buffers is None else buffers
        )
    extra = dict(forward_kwargs) if forward_kwargs else {}

    def model_fn(params, inputs):
        if rng_in_batch and buffers_in_batch:
            x, seed, bufs = inputs
        elif rng_in_batch:
            (x, seed), bufs = inputs, frozen
        elif buffers_in_batch:
            (x, bufs), seed = inputs, None
        else:
            x, seed, bufs = inputs, None, frozen
        _refuse_buffer_updates(module)
        # constants of the step: no transform differentiates them (remat
        # differentiates every floating leaf of the inputs)
        bufs = {k: v.detach() for k, v in bufs.items()}
        before = [_version(b) for b in bufs.values()]
        with _SeededDropout(None if seed is None else int(seed)):
            out = torch.func.functional_call(
                module, (params, bufs), (x,), extra
            )
        changed = [
            name
            for name, b, v in zip(bufs, bufs.values(), before)
            if v is not None and _version(b) != v
        ]
        if changed:
            raise RuntimeError(
                f"module_fns: the forward wrote the buffers {changed} in "
                "place; buffers stay frozen within a step (refresh them "
                "between steps with module_state_update)."
            )
        return out

    return HFModelFns(
        model_fn=model_fn, loss_outer=loss_outer, loss_reg=loss_reg
    )


def module_state_update(
    module: torch.nn.Module,
    params: Dict[str, torch.Tensor],
    buffers: Dict[str, torch.Tensor],
    x: Any,
    *,
    seed: Optional[int] = None,
    forward_kwargs: Optional[dict] = None,
) -> Dict[str, torch.Tensor]:
    """One training-mode forward on copies of ``buffers``; returns the
    refreshed buffers (e.g. BatchNorm running statistics).

    Call it BETWEEN HF steps when running statistics should track the data;
    inside a step they stay frozen by design.  With ``seed``, dropouts draw
    the masks of that seed (as ``rng_in_batch`` does); without, they draw
    from PyTorch's generator.  The module's own mode, parameters and
    buffers are left as they were.
    """
    new = {k: v.detach().clone() for k, v in buffers.items()}
    modes = [(m, m.training) for m in module.modules()]
    try:
        module.train()
        with torch.no_grad(), _SeededDropout(seed, draw_unseeded=True):
            torch.func.functional_call(
                module, (params, new), (x,), dict(forward_kwargs or {})
            )
    finally:
        for m, training in modes:
            m.training = training
    return new
