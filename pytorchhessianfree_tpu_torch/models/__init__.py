"""Workload models in PyTorch: MLPs, ResNet-18, All-CNN-C, analytic
targets, the transformer family and the MoE decoder LM."""

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
from .moe import init_moe_decoder_lm, moe_decoder_lm_apply, moe_param_specs
from .resnet import init_resnet18, resnet18_apply
from .targetfunc import (
    quadratic_problem,
    rosenbrock,
    rosenbrock_problem,
    target_func_fns,
)
from .transformer import (
    decoder_lm_apply,
    init_decoder_lm,
    init_transformer,
    next_token_loss,
    transformer_apply,
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
    "decoder_lm_apply",
    "init_decoder_lm",
    "init_transformer",
    "next_token_loss",
    "transformer_apply",
    "init_moe_decoder_lm",
    "moe_decoder_lm_apply",
    "moe_param_specs",
]
