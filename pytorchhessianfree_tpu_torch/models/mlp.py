"""MLP models and losses (port of :mod:`pytorchhessianfree_tpu.models.mlp`).

Models are ``init -> parameter tree`` and ``apply(params, x)`` pairs over
plain dicts and lists of tensors; the optimizer ravels the tree directly.
Initialization draws from an explicit ``torch.Generator``.  It does not
reproduce ``jax.random``'s numbers: to compare with the JAX package, carry
weights across with :func:`pytorchhessianfree_tpu_torch.convert.params_from_jax`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch


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
    head, weights uniform in ``±1/sqrt(fan_in)``."""
    layers = [
        _dense_init(generator, sizes[i], sizes[i + 1], device, dtype)
        for i in range(len(sizes) - 1)
    ]
    return {"layers": layers}


def mlp_apply(params: Any, x: torch.Tensor) -> torch.Tensor:
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    return x @ layers[-1]["w"] + layers[-1]["b"]


def mse_loss(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """MSE with mean reduction."""
    return torch.mean((outputs - targets) ** 2)


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, mean reduction."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None].long()))
