"""Workload models in PyTorch: MLP and ResNet-18."""

from .mlp import cross_entropy_loss, init_mlp, mlp_apply, mse_loss
from .resnet import init_resnet18, resnet18_apply

__all__ = [
    "cross_entropy_loss",
    "init_mlp",
    "mlp_apply",
    "mse_loss",
    "init_resnet18",
    "resnet18_apply",
]
