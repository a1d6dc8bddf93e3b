"""Device defaults of the port's entry points: they create tensors on the
card unless the caller asks for another device, and never fall back to the
CPU on their own."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorchhessianfree_tpu_torch.convert import (  # noqa: E402
    params_from_jax,
    state_from_jax,
)
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    init_allcnnc,
    init_decoder_lm,
    init_mlp,
    init_moe_decoder_lm,
    init_resnet18,
    init_transformer,
    rosenbrock_problem,
)
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten  # noqa: E402


def _tree():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((3, 2)), "b": rng.standard_normal(2)}


def test_converters_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default works there")
    with pytest.raises((RuntimeError, AssertionError)):
        params_from_jax(_tree())
    with pytest.raises((RuntimeError, AssertionError)):
        state_from_jax(np.zeros(4), 1.0, 0)
    with pytest.raises((RuntimeError, AssertionError)):
        rosenbrock_problem()


def test_converters_take_an_explicit_cpu_device():
    tree = params_from_jax(_tree(), device="cpu", dtype=torch.float32)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in tree_flatten(tree)[0])
    np.testing.assert_allclose(tree["w"].numpy(), _tree()["w"], rtol=1e-7)
    st = state_from_jax(np.zeros(4), 0.5, 3, device="cpu")
    assert st.x0.device.type == "cpu" and float(st.damping) == 0.5
    assert rosenbrock_problem(device="cpu")[0]["x"].device.type == "cpu"


@pytest.mark.parametrize(
    "init",
    [
        lambda g, d: init_mlp(g, dtype=d),
        lambda g, d: init_resnet18(g, width_scale=1 / 16, dtype=d),
        lambda g, d: init_allcnnc(g, width_scale=1 / 8, dtype=d),
        lambda g, d: init_transformer(g, dtype=d),
        lambda g, d: init_decoder_lm(g, dtype=d),
        lambda g, d: init_moe_decoder_lm(g, dtype=d),
    ],
    ids=["mlp", "resnet18", "allcnnc", "transformer", "decoder_lm", "moe"],
)
def test_inits_put_every_leaf_on_the_generator_device(init):
    # on a card the same holds for a CUDA generator (tests/test_torch_cuda.py)
    leaves = tree_flatten(init(torch.Generator().manual_seed(0),
                               torch.float64))[0]
    assert {(t.device.type, t.dtype) for t in leaves} == {
        ("cpu", torch.float64)}
