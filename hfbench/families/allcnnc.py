"""All-CNN-C classifiers through the port's ``allcnnc_apply``,
``cross_entropy_loss`` and ``l2_regularizer``.

A configuration's ``model`` holds the nine layers' ``kernels``,
``channels`` (the last is the class count), ``strides`` and ``padding``,
the image ``size`` and ``in_channels``, and the weight decay ``l2``.  The
port's layout of strides and padding is fixed, so a configuration has to
state that layout."""

from __future__ import annotations

import functools
import math

import torch

LAYOUT_STRIDES = [1, 1, 2, 1, 1, 2, 1, 1, 1]
LAYOUT_PADDING = ["SAME"] * 6 + ["VALID", "SAME", "SAME"]


def _layers(model):
    """``(k, c_in, c_out, stride, padding)`` per convolution."""
    if (model["strides"] != LAYOUT_STRIDES
            or model["padding"] != LAYOUT_PADDING):
        raise ValueError("the port's All-CNN-C has a fixed layout of "
                         f"strides {LAYOUT_STRIDES} and padding "
                         f"{LAYOUT_PADDING}")
    c_in = [model["in_channels"]] + model["channels"][:-1]
    return list(zip(model["kernels"], c_in, model["channels"],
                    model["strides"], model["padding"]))


def parameter_count(model) -> int:
    return sum(k * k * ci * co + co for k, ci, co, _, _ in _layers(model))


def make_params(model, generator, device, dtype=torch.float32):
    """He-normal kernels ``N(0, 2 / (k k c_in))`` in HWIO, zero biases (the
    port's ``init_allcnnc``), cut from one normal draw on the device."""
    layers = _layers(model)
    pool = torch.randn(sum(k * k * ci * co for k, ci, co, _, _ in layers),
                       generator=generator, device=device, dtype=dtype)
    convs, at = [], 0
    for k, ci, co, _, _ in layers:
        n = k * k * ci * co
        convs.append({"w": pool[at:at + n].view(k, k, ci, co)
                      * math.sqrt(2.0 / (k * k * ci)),
                      "b": torch.zeros(co, device=device, dtype=dtype)})
        at += n
    return {"convs": convs}


def program_fns(model):
    from pytorchhessianfree_tpu_torch import models

    return dict(model_fn=models.allcnnc_apply,
                loss_outer=models.cross_entropy_loss,
                loss_reg=functools.partial(models.l2_regularizer,
                                           coeff=model["l2"]))


def make_rows(model, traffic, rows, generator, device):
    """``rows`` standard-normal images ``[H, W, C]`` with uniform labels."""
    s = model["size"]
    images = torch.randn((rows, s, s, model["in_channels"]),
                         generator=generator, device=device)
    labels = torch.randint(0, model["channels"][-1], (rows,),
                           generator=generator, device=device)
    return images, labels


def _out(size, k, s, padding):
    return -(-size // s) if padding == "SAME" else (size - k) // s + 1


def forward_flops(model, traffic, rows) -> int:
    """Multiply-adds of the convolutions, 2 per product, over ``rows``
    images: ``2 H_out W_out k k c_in c_out`` per layer."""
    total, size = 0, model["size"]
    for k, ci, co, s, padding in _layers(model):
        size = _out(size, k, s, padding)
        total += 2 * size * size * k * k * ci * co
    return rows * total
