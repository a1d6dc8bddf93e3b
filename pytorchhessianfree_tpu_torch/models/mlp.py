"""MLP models and losses (port of :mod:`pytorchhessianfree_tpu.models.mlp`).

Models are ``init -> parameter tree`` and ``apply(params, x)`` pairs over
plain dicts and lists of tensors; the optimizer ravels the tree directly.
Under a tensor axis (``param_specs`` that put every layer's ``w`` under
``P(None, model)`` and ``b`` under ``P(model)``) each layer is
column-parallel (:func:`_layer`).  Initialization draws from an explicit
``torch.Generator``.  It does not
reproduce ``jax.random``'s numbers: to compare with the JAX package, carry
weights across with :func:`pytorchhessianfree_tpu_torch.convert.params_from_jax`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import _disable_current_modes

from ..parallel import collectives
from ..utils.flatten import tree_map


def _dense_init(generator, n_in, n_out, device, dtype) -> Dict[str, torch.Tensor]:
    scale = 1.0 / n_in**0.5

    def uniform(shape):
        u = torch.rand(shape, generator=generator, device=generator.device,
                       dtype=dtype)
        return ((u * 2 - 1) * scale).to(device)

    return {"w": uniform((n_in, n_out)), "b": uniform((n_out,))}


def init_mlp(
    generator: torch.Generator,
    sizes: Sequence[int] = (7, 5, 5, 3),
    device: Optional[torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> Any:
    """MLP params ``{"layers": [dense, ...]}``: tanh between layers, linear
    head, weights uniform in ``±1/sqrt(fan_in)``, drawn on the generator's
    device and moved to ``device`` (the generator's device if ``None``)."""
    if device is None:
        device = generator.device
    layers = [
        _dense_init(generator, sizes[i], sizes[i + 1], device, dtype)
        for i in range(len(sizes) - 1)
    ]
    return {"layers": layers}


def _layer(layer, x: torch.Tensor, i: int, last: bool) -> torch.Tensor:
    """Layer ``i``: ``tanh(x @ w + b)``, or ``x @ w + b`` for the head.
    Under a tensor axis that splits the layer's role ``"layers.{i}"``
    (:func:`~..parallel.collectives.tensor_role`) this rank computes its
    ``d_out / M`` output columns: ``x`` enters through
    :func:`~..parallel.collectives.copy_to_axis` (its cotangent summed
    over the axis), ``w`` and ``b`` are the rank's column blocks
    (:func:`~..parallel.collectives.leaf_block`), and the columns are
    joined by :func:`~..parallel.collectives.gather_from_axis`, whose
    backward keeps the rank's block: GSPMD's partition of the JAX
    package's layer under ``w`` at ``P(None, model)`` and ``b`` at
    ``P(model)``."""
    role = f"layers.{i}"
    tp = collectives.tensor_role(role, layer["w"].shape[-1])
    if tp is None:
        y = x @ layer["w"] + layer["b"]
        return y if last else torch.tanh(y)
    x = collectives.copy_to_axis(x, tp)
    w = collectives.leaf_block(layer["w"], tp, role, 1)
    b = collectives.leaf_block(layer["b"], tp, role, 0)
    y = x @ w + b
    return collectives.gather_from_axis(y if last else torch.tanh(y), tp,
                                        dim=-1)


def mlp_apply(params: Any, x: torch.Tensor) -> torch.Tensor:
    """tanh MLP forward with a linear head; each layer column-parallel
    under a tensor axis (:func:`_layer`)."""
    layers = params["layers"]
    for i, layer in enumerate(layers):
        x = _layer(layer, x, i, i == len(layers) - 1)
    return x


def _keep_mask(shape, seed: int, layer: int, keep: float, device):
    """Dropout keep-mask of ``shape``, drawn from a ``torch.Generator``
    seeded from ``(seed, layer)``.

    The draw runs with PyTorch's dispatch modes switched off, so a trace
    (``torch.func.linearize`` traces the model with ``make_fx``) records the
    mask as a constant.  Traced as an op, its replay would draw again from
    the generator's advanced state and give the tangent graph other masks
    than the primal."""
    with _disable_current_modes():
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + layer) % 2**63)
        return torch.rand(shape, generator=gen, device=device) < keep


def mlp_dropout_apply(params: Any, inputs: Any, rate: float = 0.1):
    """MLP forward with dropout on the hidden activations, the randomness
    **in the batch**: ``inputs = (x, seed)`` with an integer ``seed``.

    Every evaluation of one step (gradient, each CG matvec, each trial
    forward) then sees the same masks, and CG's fixed quadratic model
    holds; change the seed between steps, like the batch.  The masks come
    from a ``torch.Generator`` seeded from ``(seed, layer)``: the same seed
    gives the same masks on every call.  They are not ``jax.random``'s
    masks; at ``rate=0`` the output equals the JAX model's."""
    x, seed = inputs
    layers = params["layers"]
    keep = 1.0 - rate
    for i, layer in enumerate(layers[:-1]):
        # drawn on the whole (gathered) activations: one process's masks
        x = _layer(layer, x, i, False)
        mask = _keep_mask(x.shape, seed, i, keep, x.device)
        x = torch.where(mask, x / keep, x.new_zeros(()))
    return _layer(layers[-1], x, len(layers) - 1, True)


def mse_loss(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """MSE with mean reduction."""
    return torch.mean((outputs - targets) ** 2)


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, mean reduction."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None].long()))


def mse_loss_sum(
    outputs: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    return torch.sum((outputs - targets) ** 2)


def cross_entropy_loss_sum(
    logits: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.gather(logp, -1, labels[:, None].long()))


def mse_per_sample(
    outputs: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    """[N] per-sample MSE (mean over the feature dims): its mean over
    samples is :func:`mse_loss`."""
    axes = tuple(range(1, outputs.ndim))
    return torch.mean((outputs - targets) ** 2, dim=axes)


def cross_entropy_per_sample(
    logits: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """[N] per-sample softmax cross-entropy with integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long())[:, 0]


def freeze_first_layer(params: Any) -> Any:
    """Trainable mask with layer 0 frozen (the reference's ``freeze_layer1``
    test knob)."""
    mask = tree_map(lambda _: True, params)
    mask["layers"][0] = tree_map(lambda _: False, mask["layers"][0])
    return mask
