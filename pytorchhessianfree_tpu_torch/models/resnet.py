"""ResNet-18 for the MNIST workload (port of
:mod:`pytorchhessianfree_tpu.models.resnet`).

The parameter tree has the JAX tree's keys and shapes: conv kernels in HWIO,
``head.w`` as ``[in, out]``, so flat vectors of the two packages are equal
index for index.  The forward permutes each kernel to OIHW for cuDNN, and
the public ``x`` is NHWC as in JAX, permuted to NCHW once inside.

Two details make it the JAX model and not torchvision's:

- convolutions pad as JAX ``"SAME"``: ``total = max((ceil(in/s)-1)*s + k -
  in, 0)``, ``lo = total // 2`` before and the rest after, applied with
  ``F.pad`` ahead of an unpadded conv.  The 7x7/2 stem on 28 pads (2, 3)
  and the first 3x3/2 conv of stages 3 and 4 pads (0, 1);
- BatchNorm is written out with pure batch statistics (biased variance over
  N, H and W, ``rsqrt(var + 1e-5)``), no running statistics.  The forward
  is then a deterministic function of ``(params, batch)``, which CG's
  quadratic model needs.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..parallel import collectives

_BN_EPS = 1e-5
_STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))  # (channels, first stride)


def _same_pad(size: int, k: int, s: int):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(
    x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: str = "SAME"
) -> torch.Tensor:
    """NCHW input, HWIO kernel, JAX ``"SAME"`` or ``"VALID"`` padding."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"Unknown padding {padding!r}")
    if padding == "SAME":
        kh, kw = w.shape[0], w.shape[1]
        top, bottom = _same_pad(x.shape[2], kh, stride)
        left, right = _same_pad(x.shape[3], kw, stride)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def max_pool(
    x: torch.Tensor, window: int = 3, stride: int = 2
) -> torch.Tensor:
    """Max pooling over the spatial dims of an NCHW tensor with one row and
    column of ``-inf`` padding on each side, as the JAX package's
    ``reduce_window`` (which pools NHWC) pads them.  Ties in a window carry
    zero tangents after the stem's ReLU, so the pick among them cannot
    change a derivative."""
    return F.max_pool2d(x, window, stride, padding=1)


def _conv_init(generator, kh, kw, cin, cout, device, dtype):
    """He-normal HWIO kernel, drawn on the generator's device."""
    t = torch.randn((kh, kw, cin, cout), generator=generator,
                    device=generator.device, dtype=dtype)
    return (t * (2.0 / (kh * kw * cin)) ** 0.5).to(device)


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """Pure batch-statistics normalization over (N, H, W) of NCHW.  Under a
    data-parallel step with the JAX package's GSPMD semantics, the mean and
    the mean of squared deviations are taken over every rank's rows
    (:func:`~..parallel.collectives.batch_mean`), as one process would take
    them over the whole batch."""
    mean = collectives.batch_mean(x, (0, 2, 3))
    var = collectives.batch_mean((x - mean) ** 2, (0, 2, 3))
    inv = torch.rsqrt(var + _BN_EPS)
    return (x - mean) * inv * scale[:, None, None] + bias[:, None, None]


def _block_apply(p, x, stride):
    out = conv(x, p["conv1"], stride)
    out = torch.relu(batchnorm(out, p["bn1"]["scale"], p["bn1"]["bias"]))
    out = conv(out, p["conv2"], 1)
    out = batchnorm(out, p["bn2"]["scale"], p["bn2"]["bias"])
    if "down_conv" in p:
        x = batchnorm(
            conv(x, p["down_conv"], stride),
            p["down_bn"]["scale"],
            p["down_bn"]["bias"],
        )
    return torch.relu(out + x)


def resnet18_apply(params: Any, x: torch.Tensor) -> torch.Tensor:
    """Forward pass.  ``x``: [N, H, W, C] (NHWC); returns [N, classes]."""
    out = conv(x.permute(0, 3, 1, 2), params["stem"], stride=2)
    out = torch.relu(
        batchnorm(out, params["stem_bn"]["scale"], params["stem_bn"]["bias"])
    )
    out = max_pool(out)
    for blocks, (_, stride) in zip(params["stages"], _STAGES):
        out = _block_apply(blocks[0], out, stride)
        out = _block_apply(blocks[1], out, 1)
    out = torch.mean(out, dim=(2, 3))  # global average pool
    return out @ params["head"]["w"] + params["head"]["b"]


def init_resnet18(
    generator: torch.Generator,
    num_classes: int = 10,
    in_channels: int = 1,
    width_scale: float = 1.0,
    device: Optional[torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> Any:
    """Parameters for ResNet-18: 7x7/2 stem, 3x3/2 max pool, four stages of
    two basic blocks, global average pool, linear head.  Conv kernels are
    He-normal, the head normal over ``sqrt(fan_in)``.  Values are drawn on
    the generator's device and moved to ``device`` (the generator's device
    if ``None``).

    ``width_scale`` shrinks every channel width (same topology)."""
    if device is None:
        device = generator.device

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=dtype)
        return (t * std).to(device)

    def conv_init(kh, kw, cin, cout):
        return _conv_init(generator, kh, kw, cin, cout, device, dtype)

    def bn_init(c):
        return {
            "scale": torch.ones(c, device=device, dtype=dtype),
            "bias": torch.zeros(c, device=device, dtype=dtype),
        }

    def block_init(cin, cout, stride):
        p = {
            "conv1": conv_init(3, 3, cin, cout),
            "bn1": bn_init(cout),
            "conv2": conv_init(3, 3, cout, cout),
            "bn2": bn_init(cout),
        }
        if stride != 1 or cin != cout:
            p["down_conv"] = conv_init(1, 1, cin, cout)
            p["down_bn"] = bn_init(cout)
        return p

    def w(c):
        return max(1, round(c * width_scale))

    params = {
        "stem": conv_init(7, 7, in_channels, w(64)),
        "stem_bn": bn_init(w(64)),
        "stages": [],
        "head": {
            "w": normal((w(512), num_classes), 1.0 / w(512) ** 0.5),
            "b": torch.zeros(num_classes, device=device, dtype=dtype),
        },
    }
    cin = w(64)
    for cout, stride in _STAGES:
        params["stages"].append(
            [block_init(cin, w(cout), stride), block_init(w(cout), w(cout), 1)]
        )
        cin = w(cout)
    return params
