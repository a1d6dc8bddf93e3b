"""Config parity: the port's dataclasses against the JAX package's."""

import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from pytorchhessianfree_tpu import config as jcfg  # noqa: E402
from pytorchhessianfree_tpu_torch import config as tcfg  # noqa: E402


def _defaults(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", ["HFConfig", "CGConfig", "LineSearchConfig"])
def test_field_defaults_match_jax(name):
    j = _defaults(getattr(jcfg, name)())
    t = _defaults(getattr(tcfg, name)())
    assert list(j) == list(t)
    for key in j:
        if dataclasses.is_dataclass(j[key]):
            assert _defaults(j[key]) == _defaults(t[key]), key
        else:
            assert j[key] == t[key], key


_INVALID = [
    ("HFConfig", dict(curvature_opt="newton")),
    ("HFConfig", dict(damping=-1.0)),
    ("HFConfig", dict(cg_max_iter=0)),
    ("HFConfig", dict(lr=-0.1)),
    ("HFConfig", dict(backtracking_mode="random")),
    ("HFConfig", dict(precond="kfac")),
    ("HFConfig", dict(matmul_precision="bf16")),
    ("CGConfig", dict(buffer_layout="tiled")),
    ("CGConfig", dict(store_mode="always")),
    ("CGConfig", dict(grid_gamma=1.0)),
    ("CGConfig", dict(nonpos_curv_option="clip")),
    ("LineSearchConfig", dict(beta=1.0)),
    ("LineSearchConfig", dict(c=-1e-2)),
    ("LineSearchConfig", dict(mode="parallel")),
    ("LineSearchConfig", dict(max_iter=0)),
]


@pytest.mark.parametrize("name,kwargs", _INVALID)
def test_validation_errors_match_jax(name, kwargs):
    with pytest.raises(ValueError) as j_err:
        getattr(jcfg, name)(**kwargs)
    with pytest.raises(ValueError) as t_err:
        getattr(tcfg, name)(**kwargs)
    assert str(j_err.value) == str(t_err.value)


def test_zero_damping_disables_adaptation_like_jax():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        j = jcfg.HFConfig(damping=0.0)
        t = tcfg.HFConfig(damping=0.0)
    assert j.adapt_damping is False and t.adapt_damping is False
    assert len(caught) == 2
    assert str(caught[0].message) == str(caught[1].message)


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("HFConfig", dict(rich_stats=True)),
        ("HFConfig", dict(backtracking_mode="batched")),
        ("CGConfig", dict(store_dtype="bfloat16")),
        ("LineSearchConfig", dict(mode="batched")),
    ],
)
def test_unported_knobs_raise_and_name_roadmap(name, kwargs):
    """Once refused as not ported; now each knob builds in both packages
    with the same fields."""
    j = _defaults(getattr(jcfg, name)(**kwargs))
    t = _defaults(getattr(tcfg, name)(**kwargs))
    assert list(j) == list(t)
    for key in j:
        if dataclasses.is_dataclass(j[key]):
            assert _defaults(j[key]) == _defaults(t[key]), key
        else:
            assert j[key] == t[key], key
    for key, value in kwargs.items():
        assert t[key] == value


@pytest.mark.parametrize(
    "kwargs", [dict(curvature_dtype="bfloat16"), dict(remat=True)]
)
def test_curvature_dtype_and_remat_are_ported(kwargs):
    for key, value in kwargs.items():
        assert getattr(tcfg.HFConfig(**kwargs), key) == value
        assert getattr(jcfg.HFConfig(**kwargs), key) == value


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(buffer_layout="rows"),
        dict(store_mode="scratch"),
    ],
)
def test_layout_knobs_are_accepted(kwargs):
    assert tcfg.HFConfig(cg=tcfg.CGConfig(**kwargs), fused_trials=False)


@pytest.mark.parametrize(
    "precision,tf32",
    [(None, False), ("highest", False), ("high", True), ("default", True)],
)
def test_precision_ctx_sets_and_restores_both_tf32_switches(precision, tf32):
    cuda_mm = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = (cuda_mm.allow_tf32, cudnn.allow_tf32)
    try:
        cuda_mm.allow_tf32, cudnn.allow_tf32 = (not tf32), (not tf32)
        with tcfg.precision_ctx(tcfg.HFConfig(matmul_precision=precision)):
            assert cuda_mm.allow_tf32 is tf32
            assert cudnn.allow_tf32 is tf32
        assert cuda_mm.allow_tf32 is (not tf32)
        assert cudnn.allow_tf32 is (not tf32)
    finally:
        cuda_mm.allow_tf32, cudnn.allow_tf32 = saved
