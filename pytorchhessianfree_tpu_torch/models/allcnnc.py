"""All-CNN-C for CIFAR-100 (port of
:mod:`pytorchhessianfree_tpu.models.allcnnc`).

Springenberg et al. (2015), as DeepOBS' ``cifar100_allcnnc`` problem runs it
in ``eval()`` mode: nine convolutions with ReLU between them and global
average pooling, no dropout.  The parameter tree is the JAX tree
(``{"convs": [{"w": HWIO, "b": [out]}, ...]}``), so flat vectors of the two
packages are equal index for index.  The public ``x`` is NHWC as in JAX,
permuted to NCHW once inside.  :func:`l2_regularizer` is DeepOBS' weight
decay on the conv kernels, to pass as ``loss_reg``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .resnet import _conv_init, conv

# (stride, padding) per conv layer; the seventh is VALID, as in the paper
_LAYOUT = (
    (1, "SAME"),
    (1, "SAME"),
    (2, "SAME"),
    (1, "SAME"),
    (1, "SAME"),
    (2, "SAME"),
    (1, "VALID"),
    (1, "SAME"),
    (1, "SAME"),
)


def init_allcnnc(
    generator: torch.Generator,
    num_classes: int = 100,
    in_channels: int = 3,
    dtype: torch.dtype = torch.float32,
    width_scale: float = 1.0,
    device: Optional[torch.device] = None,
) -> Any:
    """All-CNN-C parameters: three blocks of three convs (96, 96, 96/2 |
    192, 192, 192/2 | 192 valid, 1x1 192, 1x1 ``num_classes``).  Kernels
    are He-normal, drawn on the generator's device and moved to ``device``
    (the generator's device if ``None``); biases are zero.  ``width_scale``
    shrinks the channel widths (same topology); 1.0 is the paper's model,
    1,387,108 parameters at 100 classes."""
    if device is None:
        device = generator.device
    c96 = max(1, round(96 * width_scale))
    c192 = max(1, round(192 * width_scale))
    widths = [
        (3, in_channels, c96),
        (3, c96, c96),
        (3, c96, c96),
        (3, c96, c192),
        (3, c192, c192),
        (3, c192, c192),
        (3, c192, c192),
        (1, c192, c192),
        (1, c192, num_classes),
    ]
    return {
        "convs": [
            {
                "w": _conv_init(generator, k, k, cin, cout, device, dtype),
                "b": torch.zeros(cout, device=device, dtype=dtype),
            }
            for k, cin, cout in widths
        ]
    }


def allcnnc_apply(params: Any, x: torch.Tensor) -> torch.Tensor:
    """Forward pass.  ``x``: [N, 32, 32, C] (NHWC); returns [N, classes]."""
    x = x.permute(0, 3, 1, 2)
    last = len(_LAYOUT) - 1
    for i, (layer, (stride, padding)) in enumerate(
        zip(params["convs"], _LAYOUT)
    ):
        x = conv(x, layer["w"], stride, padding) + layer["b"][:, None, None]
        if i < last:
            x = torch.relu(x)
    return torch.mean(x, dim=(2, 3))  # global average pool -> logits


def l2_regularizer(params: Any, coeff: float = 5e-4) -> torch.Tensor:
    """``0.5 * coeff * sum ||w||^2`` over the conv kernels (not the
    biases), DeepOBS' regularization loss."""
    return 0.5 * coeff * sum(torch.sum(c["w"] ** 2) for c in params["convs"])
