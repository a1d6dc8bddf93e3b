"""TrainableRavel parity: the port's flat vectors equal the JAX package's
index for index (sorted dict keys, lists in order)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorchhessianfree_tpu.utils.flatten import (  # noqa: E402
    TrainableRavel as JRavel,
)
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.utils.flatten import (  # noqa: E402
    TrainableRavel,
    tree_flatten,
    tree_unflatten,
)


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    # keys deliberately inserted out of sorted order
    return {
        "z": {"w": rng.standard_normal((3, 2)), "b": rng.standard_normal(2)},
        "a": [rng.standard_normal((4,)), rng.standard_normal((2, 2, 2))],
        "m": (rng.standard_normal((1, 5)),),
    }


def _mask(frozen):
    return {
        "z": {"w": frozen, "b": True},
        "a": [True, not frozen],
        "m": (True,),
    }


def _jax(tree):
    import jax

    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pad", [None, 8, 64])
def test_ravel_equals_jax(masked, pad):
    tree = _np_tree(0)
    mask = _mask(False) if masked else None
    jr = JRavel(_jax(tree), mask, pad_to_multiple=pad)
    tr = TrainableRavel(params_from_jax(tree, device="cpu"), mask, pad_to_multiple=pad)
    assert (tr.dim, tr.unpadded_dim) == (jr.dim, jr.unpadded_dim)
    np.testing.assert_array_equal(
        tr.ravel(params_from_jax(tree, device="cpu")).numpy(),
        np.asarray(jr.ravel(_jax(tree))),
    )


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pad", [None, 64])
def test_unravel_add_write_round_trip(masked, pad):
    tree = params_from_jax(_np_tree(1), device="cpu")
    mask = _mask(False) if masked else None
    tr = TrainableRavel(tree, mask, pad_to_multiple=pad)
    jr = JRavel(_jax(_np_tree(1)), mask, pad_to_multiple=pad)
    vec_np = np.random.default_rng(2).standard_normal(tr.dim)
    if pad:
        vec_np[tr.unpadded_dim:] = 0.0
    vec = torch.tensor(vec_np)

    # unravel: tangent tree with zeros on frozen leaves, as in JAX
    t_leaves, _ = tree_flatten(tr.unravel(vec))
    j_leaves, _ = tree_flatten(jr.unravel(jnp.asarray(vec_np)))
    for t, j in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tr.ravel(tr.unravel(vec)).numpy(), vec_np)

    # add: params + unravel(vec); frozen leaves untouched
    added = tr.add(tree, vec)
    np.testing.assert_allclose(
        tr.ravel(added).numpy(), tr.ravel(tree).numpy() + vec_np, rtol=1e-15
    )
    j_added = jr.add(_jax(_np_tree(1)), jnp.asarray(vec_np))
    for t, j in zip(tree_flatten(added)[0], tree_flatten(j_added)[0]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-15)

    # write: trainable leaves replaced, frozen leaves passed through
    written = tr.write(tree, vec)
    np.testing.assert_array_equal(tr.ravel(written).numpy(), vec_np)
    for t, orig, m in zip(
        tree_flatten(written)[0], tree_flatten(tree)[0], tr._mask
    ):
        if not m:
            assert t is orig


def test_unravel_slices_are_views():
    tree = params_from_jax(_np_tree(3), device="cpu")
    tr = TrainableRavel(tree)
    vec = tr.ravel(tree)
    leaves, _ = tree_flatten(tr.unravel(vec))
    leaves[0].add_(1.0)
    assert vec[0] == tree_flatten(tree)[0][0].reshape(-1)[0] + 1.0


def test_tree_flatten_order_and_round_trip():
    tree = {"b": [1, 2], "a": {"y": 3, "x": (4, 5)}}
    leaves, treedef = tree_flatten(tree)
    assert leaves == [4, 5, 3, 1, 2]
    assert tree_unflatten(treedef, leaves) == tree


def test_errors():
    tree = params_from_jax(_np_tree(4), device="cpu")
    tr = TrainableRavel(tree, pad_to_multiple=16)
    with pytest.raises(ValueError, match="flat vector of length"):
        tr.unravel(torch.zeros(tr.dim + 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="leaves"):
        tr.ravel({"a": tree["a"]})
    with pytest.raises(ValueError, match="one boolean per parameter"):
        TrainableRavel(tree, {"a": [True, True]})
    with pytest.raises(ValueError, match="No trainable"):
        TrainableRavel(tree, _mask(True) | {"z": {"w": False, "b": False},
                                            "a": [False, False],
                                            "m": (False,)})
    with pytest.raises(ValueError, match="pad_to_multiple"):
        TrainableRavel(tree, pad_to_multiple=0)
    assert tr.zeros().shape == (tr.dim,)
