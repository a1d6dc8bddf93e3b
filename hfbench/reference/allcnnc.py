"""All-CNN-C (Springenberg et al. 2015) as DeepOBS' ``cifar100_allcnnc``
runs it in evaluation mode, in plain PyTorch: nine convolutions with ReLU
between them and a global average pool to the class logits, no dropout;
softmax cross-entropy plus ``0.5 * l2 * sum ||w||^2`` over the kernels.

The parameter tree is the benchmark's (``families/allcnnc.py``): ``convs``,
a list of ``{"w": [kh, kw, in, out], "b": [out]}``; images are ``[N, H, W,
C]``.  "SAME" padding puts the odd pixel after the image, as TensorFlow
and JAX do."""

from __future__ import annotations

import torch.nn.functional as F

from .hf import softmax_ce_hvp


def _same(size, k, s):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def outputs(params, images, model):
    x = images.permute(0, 3, 1, 2)
    last = len(params["convs"]) - 1
    for i, (layer, s, pad) in enumerate(zip(
            params["convs"], model["strides"], model["padding"])):
        w = layer["w"]
        if pad == "SAME":
            top, bottom = _same(x.shape[2], w.shape[0], s)
            left, right = _same(x.shape[3], w.shape[1], s)
            x = F.pad(x, (left, right, top, bottom))
        x = F.conv2d(x, w.permute(3, 2, 0, 1), layer["b"], stride=s)
        if i < last:
            x = F.relu(x)
    return x.mean(dim=(2, 3))


def outer_loss(logits, labels):
    return F.cross_entropy(logits, labels)


def outer_hvp(logits, labels, u):
    return softmax_ce_hvp(logits, u, logits.shape[0])


def regularizer(model):
    """DeepOBS' weight decay on the kernels, not the biases."""
    coeff = model["l2"]
    return lambda p: 0.5 * coeff * sum((c["w"] ** 2).sum()
                                       for c in p["convs"])
