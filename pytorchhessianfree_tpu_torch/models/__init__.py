"""Workload models in PyTorch: MLPs, ResNet-18, All-CNN-C and analytic
targets."""

from .allcnnc import allcnnc_apply, init_allcnnc, l2_regularizer
from .mlp import (
    cross_entropy_loss,
    cross_entropy_loss_sum,
    cross_entropy_per_sample,
    freeze_first_layer,
    init_mlp,
    mlp_apply,
    mlp_dropout_apply,
    mse_loss,
    mse_loss_sum,
    mse_per_sample,
)
from .resnet import init_resnet18, resnet18_apply
from .targetfunc import (
    quadratic_problem,
    rosenbrock,
    rosenbrock_problem,
    target_func_fns,
)

__all__ = [
    "allcnnc_apply",
    "init_allcnnc",
    "l2_regularizer",
    "cross_entropy_loss",
    "cross_entropy_loss_sum",
    "cross_entropy_per_sample",
    "freeze_first_layer",
    "init_mlp",
    "mlp_apply",
    "mlp_dropout_apply",
    "mse_loss",
    "mse_loss_sum",
    "mse_per_sample",
    "init_resnet18",
    "resnet18_apply",
    "quadratic_problem",
    "rosenbrock",
    "rosenbrock_problem",
    "target_func_fns",
]
