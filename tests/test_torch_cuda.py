"""The CUDA kernel on a card: ``fused_cg_update`` against its plain version,
CG (plain and preconditioned) on the card against CG on the CPU, the
empirical-Fisher diagonal and the LM matvecs on the card against the CPU,
the peak memory that rematerialization saves on the card, and the Nystrom
sketch, Lanczos/SLQ, the batched select modes, the reduced-precision
iterate store and checkpoints on the card against the CPU.

These tests need a CUDA device and ``nvcc``, and skip without them.  They
import no JAX, so on a machine without it run them without the JAX-only
conftest::

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorchhessianfree_tpu_torch import (  # noqa: E402
    TrainableRavel,
    cg,
    diag_EF,
    diag_EF_scan,
    diag_to_preconditioner,
)
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    allcnnc_apply,
    cross_entropy_loss,
    init_allcnnc,
    l2_regularizer,
)
from pytorchhessianfree_tpu_torch.ops.cg_update import (  # noqa: E402
    fused_cg_update,
    fused_cg_update_reference,
)
from pytorchhessianfree_tpu_torch.utils.flatten import (  # noqa: E402
    tree_flatten,
    tree_map,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) for the kernel")
    return torch.device("cuda")


def _tensors(n, dtype, device):
    rng = np.random.default_rng(n)
    vecs = [rng.standard_normal(n) for _ in range(5)]
    vecs[4] = -vecs[0] + 0.1 * vecs[4]  # b near -x: m far from 0
    alpha = rng.uniform(0.1, 2.0)
    return [torch.tensor(v, dtype=dtype, device=device) for v in vecs] + [
        torch.tensor(alpha, dtype=dtype, device=device)
    ]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 1000, 1_000_003])
def test_kernel_matches_reference(cuda, dtype, n):
    dtype = getattr(torch, dtype)
    args = _tensors(n, dtype, cuda)
    before = fused_cg_update.launches
    out = fused_cg_update(*args)
    again = fused_cg_update(*args)
    ref = fused_cg_update_reference(*args)
    torch.cuda.synchronize()
    assert fused_cg_update.launches == before + 2
    # x', r' are formed without FMA contraction: bitwise equal
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    # m, rr: the summation order differs from the plain version
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(out[2], ref[2], rtol=rtol, atol=0)
    torch.testing.assert_close(out[3], ref[3], rtol=rtol, atol=0)
    # fixed grid, fixed reduction order: bitwise reproducible
    assert torch.equal(out[2], again[2]) and torch.equal(out[3], again[3])


def test_kernel_rejects_cpu_cuda_mix(cuda):
    args = _tensors(1000, torch.float32, cuda)
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="one device"):
        fused_cg_update(*args)


def test_cg_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    n = 512
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.geomspace(1.0, 20.0, n)) @ q.T
    b = rng.standard_normal(n)
    out = []
    for dev in (cuda, torch.device("cpu")):
        A = torch.tensor(a, device=dev)
        out.append(cg(lambda v: A @ v, torch.tensor(b, device=dev),
                      max_iter=40, martens_conv_crit=True,
                      store_x_at_iters=None))
    gpu, cpu = out
    assert (gpu.num_iters, gpu.reason) == (cpu.num_iters, cpu.reason)
    k = gpu.num_iters
    torch.testing.assert_close(gpu.m_hist[: k + 1].cpu(), cpu.m_hist[: k + 1],
                               rtol=1e-9, atol=0)
    err = torch.linalg.vector_norm(gpu.x.cpu() - cpu.x)
    assert err <= 1e-9 * torch.linalg.vector_norm(cpu.x)


def test_preconditioned_cg_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    n = 512
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.geomspace(1.0, 20.0, n)) @ q.T + np.diag(np.geomspace(
        0.1, 10.0, n))
    b = rng.standard_normal(n)
    diag = np.abs(np.diag(a))
    out = []
    for dev in (cuda, torch.device("cpu")):
        A = torch.tensor(a, device=dev)
        M = diag_to_preconditioner(torch.tensor(diag, device=dev), 0.5, 0.75)
        out.append(cg(lambda v: A @ v, torch.tensor(b, device=dev), M=M,
                      max_iter=40, martens_conv_crit=True,
                      store_x_at_iters=None))
    gpu, cpu = out
    assert (gpu.num_iters, gpu.reason) == (cpu.num_iters, cpu.reason)
    k = gpu.num_iters
    torch.testing.assert_close(gpu.m_hist[: k + 1].cpu(), cpu.m_hist[: k + 1],
                               rtol=1e-9, atol=0)
    err = torch.linalg.vector_norm(gpu.x.cpu() - cpu.x)
    assert err <= 1e-9 * torch.linalg.vector_norm(cpu.x)


@pytest.mark.parametrize("use_scan", [False, True])
def test_diag_EF_on_card_matches_cpu(cuda, use_scan):
    gen = torch.Generator().manual_seed(0)
    params = init_allcnnc(gen, width_scale=1 / 8, dtype=torch.float64)
    x = torch.randn((6, 32, 32, 3), generator=gen, dtype=torch.float64)
    y = torch.randint(0, 100, (6,), generator=gen)
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev), params)
        fn = diag_EF_scan if use_scan else diag_EF
        out.append(fn(allcnnc_apply, cross_entropy_loss, p, x.to(dev),
                      y.to(dev), "mean", TrainableRavel(p, pad_to_multiple=1024),
                      loss_reg=l2_regularizer))
    gpu, cpu = out
    assert gpu.device.type == "cuda"
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-10, atol=1e-300)


def test_entry_points_default_to_the_card(cuda):
    from pytorchhessianfree_tpu_torch.convert import params_from_jax
    from pytorchhessianfree_tpu_torch.models import init_mlp

    gen = torch.Generator(device="cuda").manual_seed(0)
    assert {t.device.type for t in tree_flatten(init_mlp(gen))[0]} == {"cuda"}
    tree = params_from_jax({"w": np.ones((2, 2))})
    assert tree["w"].device.type == "cuda"


def _narrow_lms():
    from pytorchhessianfree_tpu_torch.models import (
        decoder_lm_apply,
        init_decoder_lm,
        init_moe_decoder_lm,
        moe_decoder_lm_apply,
    )

    gen = torch.Generator().manual_seed(0)
    dense = init_decoder_lm(gen, vocab=32, d_model=32, n_layers=2, d_ff=64,
                            dtype=torch.float64)
    moe = init_moe_decoder_lm(gen, vocab=32, d_model=32, n_layers=2,
                              d_ff=64, dtype=torch.float64)
    tokens = torch.randint(0, 32, (4, 16), generator=gen)
    return ((dense, decoder_lm_apply), (moe, moe_decoder_lm_apply)), tokens


@pytest.mark.parametrize("which", [0, 1], ids=["decoder_lm", "moe"])
@pytest.mark.parametrize(
    "config",
    [dict(), dict(remat=True)],
    ids=["plain", "remat"],
)
def test_lm_matvec_on_card_matches_cpu(cuda, which, config):
    from pytorchhessianfree_tpu_torch import HFConfig, HFModelFns
    from pytorchhessianfree_tpu_torch.models import next_token_loss
    from pytorchhessianfree_tpu_torch.optimizer import _build_matvec_and_grad

    models, tokens = _narrow_lms()
    params, apply = models[which]
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev), params)
        ravel = TrainableRavel(p)
        fns = HFModelFns(model_fn=lambda q, t: apply(q, t, attn_chunk=8),
                         loss_outer=next_token_loss)
        v = torch.randn(ravel.dim, generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64).to(dev)
        loss, grad, mvp = _build_matvec_and_grad(
            fns, HFConfig(**config), ravel, p, (tokens.to(dev),) * 2)
        out.append([loss.cpu(), grad.cpu(), mvp(v).cpu()])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_bf16_matvec_on_card_approximates_f32(cuda):
    from pytorchhessianfree_tpu_torch import HFConfig, HFModelFns
    from pytorchhessianfree_tpu_torch.models import (
        decoder_lm_apply,
        init_decoder_lm,
        next_token_loss,
    )
    from pytorchhessianfree_tpu_torch.optimizer import _build_matvec_and_grad

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_decoder_lm(gen, vocab=64, d_model=64, n_layers=2, d_ff=128)
    tokens = torch.randint(0, 64, (8, 16), generator=gen, device="cuda")
    fns = HFModelFns(model_fn=decoder_lm_apply, loss_outer=next_token_loss)
    ravel = TrainableRavel(params)
    v = torch.randn(ravel.dim, generator=gen, device="cuda")
    res = [
        _build_matvec_and_grad(fns, HFConfig(curvature_dtype=c), ravel,
                               params, (tokens, tokens))
        for c in (None, "bfloat16")
    ]
    torch.testing.assert_close(res[1][1], res[0][1], rtol=1e-6, atol=1e-7)
    a, b = res[0][2](v), res[1][2](v)
    assert b.dtype == torch.float32
    cos = float(a @ b / (torch.linalg.vector_norm(a)
                         * torch.linalg.vector_norm(b)))
    assert cos > 0.99


@pytest.mark.parametrize("product", ["gradient", "ggnvp", "hvp"])
def test_remat_cuts_peak_memory_on_card(cuda, product):
    """16 checkpointed layers hold one input each in place of their
    activations, in the one-shot products that ``HFConfig(remat=True)``
    builds."""
    from pytorchhessianfree_tpu_torch.ops.curvature import (
        ggnvp,
        hvp,
        value_and_grad,
    )
    from pytorchhessianfree_tpu_torch.utils.remat import checkpoint

    def layer(w, h):
        h = torch.tanh(h @ w)
        h = h * torch.sigmoid(h)
        return torch.sin(h)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ws = [torch.randn(1024, 1024, generator=gen, device="cuda") / 32
          for _ in range(16)]
    vs = [torch.randn(1024, 1024, generator=gen, device="cuda")
          for _ in range(16)]
    x = torch.randn(2048, 1024, generator=gen, device="cuda")
    peaks = []
    for remat in (False, True):
        f = checkpoint(layer) if remat else layer

        def model(q):
            h = x
            for w in q:
                h = f(w, h)
            return h

        def loss(q):
            return torch.sum(model(q) ** 2)

        run = {
            "gradient": lambda: value_and_grad(loss, ws),
            "ggnvp": lambda: ggnvp(model, lambda o: torch.sum(o**2), ws, vs),
            "hvp": lambda: hvp(loss, ws, vs),
        }[product]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    assert peaks[1] < 0.5 * peaks[0], peaks


def _narrow_resnet_opt(dev, **config):
    from pytorchhessianfree_tpu_torch import HessianFree, HFConfig
    from pytorchhessianfree_tpu_torch.models import (
        init_resnet18,
        resnet18_apply,
    )

    gen = torch.Generator().manual_seed(1)
    params = init_resnet18(gen, width_scale=1 / 16, dtype=torch.float64)
    x = torch.randn((4, 28, 28, 1), generator=gen, dtype=torch.float64)
    y = torch.randint(0, 10, (4,), generator=gen)
    opt = HessianFree(tree_map(lambda t: t.to(dev), params),
                      model_fn=resnet18_apply, loss_outer=cross_entropy_loss,
                      config=HFConfig(damping=1.0, cg_max_iter=5, **config))
    return opt, (x.to(dev), y.to(dev))


def test_nystrom_and_spectrum_on_card_match_cpu(cuda):
    """The sketch and the Lanczos/SLQ runs vmap the step's linearized
    conv-model matvec; on the same probes the card gives the CPU's
    numbers.  SLQ's nodes are not compared: without reorthogonalization
    this badly conditioned GGN turns last-bit differences into percent
    ones within 12 iterations (test_torch_spectrum.py's
    ``test_slq_trace_survives_last_bit_noise_that_moves_its_nodes``); its
    trace rests on the first Lanczos coefficient alone."""
    from pytorchhessianfree_tpu_torch import slq_trace

    out = []
    for dev in (cuda, torch.device("cpu")):
        opt, batch = _narrow_resnet_opt(dev)
        sk = opt.get_nystrom_sketch(batch, rank=8, seed=2)
        res, (nodes, weights) = opt.estimate_spectrum(
            batch, num_iters=12, num_probes=3, seed=3)
        assert sk.U.device.type == dev.type
        out.append([sk.eigs.cpu(), res.values.cpu(),
                    slq_trace(nodes, weights, opt.ravel.unpadded_dim).cpu()])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-12)


def test_batched_select_and_rich_stats_on_card_match_cpu(cuda):
    from pytorchhessianfree_tpu_torch import LineSearchConfig

    runs = []
    for dev in (cuda, torch.device("cpu")):
        opt, batch = _narrow_resnet_opt(
            dev, rich_stats=True, backtracking_mode="batched",
            linesearch=LineSearchConfig(mode="batched", batch_chunk=8))
        for _ in range(2):
            opt.step(batch)
        runs.append(opt)
    gpu, cpu = runs
    for key in ("num_cg_iters", "cg_reasons", "best_cg_iters"):
        assert gpu.history[key] == cpu.history[key], key
    for a, b in zip(gpu.last_stats.detail, cpu.last_stats.detail):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-12,
                                   equal_nan=True)


def test_bf16_iterate_store_on_card_leaves_cg_unchanged(cuda):
    rng = np.random.default_rng(2)
    n = 512
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = torch.tensor((q * np.geomspace(1.0, 20.0, n)) @ q.T, device=cuda,
                     dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(n), device=cuda, dtype=torch.float32)
    kw = dict(max_iter=40, martens_conv_crit=True, store_x_at_iters=None)
    full = cg(lambda v: A @ v, b, **kw)
    low = cg(lambda v: A @ v, b, store_dtype="bfloat16", **kw)
    assert (low.num_iters, low.reason) == (full.num_iters, full.reason)
    assert torch.equal(low.x, full.x) and torch.equal(low.m_hist, full.m_hist)
    assert low.x_buf.dtype == torch.bfloat16
    assert torch.equal(low.x_buf, full.x_buf.to(torch.bfloat16))


@pytest.mark.parametrize("backend", ["torch", "npz"])
def test_checkpoint_on_card_continues_bitwise(cuda, backend, tmp_path):
    torch.backends.cudnn.deterministic = True
    try:
        opt, batch = _narrow_resnet_opt(cuda)
        opt.step(batch)
        opt.save(str(tmp_path / "ckpt"), backend=backend)
        fresh, _ = _narrow_resnet_opt(cuda)
        fresh.load(str(tmp_path / "ckpt"), backend=backend)
        assert fresh.state.x0.device.type == "cuda"
        assert fresh.step(batch) == opt.step(batch)
        assert torch.equal(fresh.ravel.ravel(fresh.params),
                           opt.ravel.ravel(opt.params))
    finally:
        torch.backends.cudnn.deterministic = False
