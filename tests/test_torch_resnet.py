"""ResNet-18 parity: the port's forward, loss, gradient and GGN matvecs
against the JAX model on the same weights (carried over with
``params_from_jax``), in f64 at width 1/16; and the full-width parameter
count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from pytorchhessianfree_tpu import HFConfig as JConfig  # noqa: E402
from pytorchhessianfree_tpu import HFModelFns as JFns  # noqa: E402
from pytorchhessianfree_tpu import TrainableRavel as JRavel  # noqa: E402
from pytorchhessianfree_tpu.models import (  # noqa: E402
    cross_entropy_loss as j_ce,
    init_resnet18 as j_init,
    resnet18_apply as j_apply,
)
from pytorchhessianfree_tpu.optimizer import (  # noqa: E402
    _build_matvec_and_grad as j_build,
)
from pytorchhessianfree_tpu_torch import HFConfig, HFModelFns  # noqa: E402
from pytorchhessianfree_tpu_torch import TrainableRavel  # noqa: E402
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    cross_entropy_loss,
    init_resnet18,
    resnet18_apply,
)
from pytorchhessianfree_tpu_torch.models.resnet import _same_pad  # noqa: E402
from pytorchhessianfree_tpu_torch.optimizer import (  # noqa: E402
    _build_matvec_and_grad,
)
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten  # noqa: E402


def _assert_vec_close(actual, expected, rtol):
    # norm-wise: entries near zero carry absolute errors at the vector's
    # scale (sums in another order), which an element-wise rtol would
    # read as large relative errors
    err = np.linalg.norm(actual - expected)
    assert err <= rtol * np.linalg.norm(expected), (err, rtol)


@pytest.fixture(scope="module")
def problem():
    init = jax.jit(lambda key: j_init(key, dtype=jnp.float64,
                                      width_scale=1 / 16))
    jparams = init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 28, 28, 1))
    y = rng.integers(0, 10, 4)
    return jparams, params_from_jax(np_params, device="cpu"), x, y


def test_tree_and_flat_vector_match_jax(problem):
    jparams, tparams, _, _ = problem
    j_leaves = jax.tree_util.tree_leaves(jparams)
    t_leaves, _ = tree_flatten(tparams)
    assert [tuple(a.shape) for a in j_leaves] == [tuple(t.shape)
                                                  for t in t_leaves]
    jr = JRavel(jparams, pad_to_multiple=1024)
    tr = TrainableRavel(tparams, pad_to_multiple=1024)
    np.testing.assert_array_equal(tr.ravel(tparams).numpy(),
                                  np.asarray(jr.ravel(jparams)))


@pytest.mark.parametrize(
    "size,k,s,pads",
    [(28, 7, 2, (2, 3)), (4, 3, 2, (0, 1)), (2, 3, 2, (0, 1)),
     (7, 3, 1, (1, 1)), (7, 1, 2, (0, 0))],
)
def test_same_padding_is_jax_same(size, k, s, pads):
    assert _same_pad(size, k, s) == pads


def test_logits_loss_gradient_and_ggn_matvecs_match_jax(problem):
    jparams, tparams, x, y = problem
    batch_j = (jnp.asarray(x), jnp.asarray(y))
    batch_t = (torch.tensor(x), torch.tensor(y))
    jr = JRavel(jparams, pad_to_multiple=1024)
    tr = TrainableRavel(tparams, pad_to_multiple=1024)
    j_fns = JFns(model_fn=j_apply, loss_outer=j_ce)

    @jax.jit
    def j_run(params, batch, vs):
        logits = j_apply(params, batch[0])
        loss, grad, mvp = j_build(j_fns, JConfig(), jr, params, batch)
        return logits, loss, grad, jax.lax.map(mvp, vs)

    rng = np.random.default_rng(1)
    vs = rng.standard_normal((3, tr.dim))
    vs[:, tr.unpadded_dim:] = 0.0
    j_logits, j_loss, j_grad, j_mvps = j_run(jparams, batch_j,
                                             jnp.asarray(vs))
    t_logits = resnet18_apply(tparams, batch_t[0]).numpy()
    np.testing.assert_allclose(t_logits, np.asarray(j_logits), rtol=1e-10)
    t_loss, t_grad, t_mvp = _build_matvec_and_grad(
        HFModelFns(model_fn=resnet18_apply, loss_outer=cross_entropy_loss),
        HFConfig(), tr, tparams, batch_t,
    )
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-10)
    _assert_vec_close(t_grad.numpy(), np.asarray(j_grad), 1e-10)

    for v, j_gv in zip(vs, np.asarray(j_mvps)):
        _assert_vec_close(t_mvp(torch.tensor(v)).numpy(), j_gv, 1e-9)


def test_full_width_parameter_count():
    params = init_resnet18(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in tree_flatten(params)[0]) == 11_175_370
    assert TrainableRavel(params, pad_to_multiple=1024).dim == 11_175_936
    logits = resnet18_apply(params, torch.zeros(2, 28, 28, 1))
    assert logits.shape == (2, 10)
