"""The CUDA kernel on a card: ``fused_cg_update`` against its plain version,
CG (plain and preconditioned) on the card against CG on the CPU, the
empirical-Fisher diagonal and the LM matvecs on the card against the CPU,
the peak memory that rematerialization saves on the card, and the Nystrom
sketch, Lanczos/SLQ, the batched select modes, the reduced-precision
iterate store and checkpoints on the card against the CPU, and the
data-parallel pieces on a 1-rank NCCL group (the prefetcher's sharding, a
DP step equal to ``hf_step``), and the collectives, the pipeline's probe
the Megatron-partitioned forward and the MoE LM under context + expert
parallelism on two gloo ranks sharing the card.

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


def _same_as_reference(out, ref, dtype):
    # x', r' are formed without FMA contraction: bitwise equal
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    # m, rr: the summation order differs from the plain version
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(out[2], ref[2], rtol=rtol, atol=0)
    torch.testing.assert_close(out[3], ref[3], rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize(
    "n", [1, 3, 4, 5, 7, 1000, 4097, 1_000_003, 1_387_520])
def test_kernel_matches_reference(cuda, dtype, n):
    dtype = getattr(torch, dtype)
    args = _tensors(n, dtype, cuda)
    before = fused_cg_update.launches
    out = fused_cg_update(*args)
    again = fused_cg_update(*args)
    ref = fused_cg_update_reference(*args)
    torch.cuda.synchronize()
    assert fused_cg_update.launches == before + 2
    _same_as_reference(out, ref, dtype)
    # fixed grid, fixed reduction order: bitwise reproducible
    assert torch.equal(out[2], again[2]) and torch.equal(out[3], again[3])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("offsets", [(1,) * 5, (2,) * 5, (3,) * 5,
                                     (0, 1, 2, 3, 1)])
def test_kernel_on_misaligned_views(cuda, dtype, offsets):
    # views with a storage offset: a common one (a scalar head up to the
    # 16-byte boundary) and offsets that share no boundary (all scalar)
    dtype = getattr(torch, dtype)
    n = 4097
    args = _tensors(n, dtype, cuda)
    views = [torch.cat([torch.zeros(k, dtype=dtype, device=cuda), t])[k:]
             for k, t in zip(offsets, args[:5])]
    assert [v.storage_offset() for v in views] == list(offsets)
    out = fused_cg_update(*views, args[5])
    ref = fused_cg_update_reference(*views, args[5])
    torch.cuda.synchronize()
    _same_as_reference(out, ref, dtype)
    assert out[0].is_contiguous() and out[0].shape == (n,)


def test_kernel_is_one_launch_per_call(cuda):
    from torch.profiler import ProfilerActivity, profile

    args = _tensors(1_387_520, torch.float32, cuda)
    fused_cg_update(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fused_cg_update(*args)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 3, kernels
    assert all("fused_cg_update_kernel" in k for k in kernels), kernels


def _three_updates(x, r, p, Ap, b, alpha):
    # three chained iterations, as CG makes them
    outs = []
    for _ in range(3):
        x, r, m, rr = fused_cg_update(x, r, p, Ap, b, alpha)
        outs += [x, r, m, rr]
    return outs


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_in_a_cuda_graph(cuda, dtype):
    dtype = getattr(torch, dtype)
    args = _tensors(1_000_003, dtype, cuda)
    eager = _three_updates(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        _three_updates(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _three_updates(*args)
    for _ in range(2):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


def test_kernel_outputs_outlive_the_next_call(cuda):
    # CG keeps rr as the next iteration's r.y: a call must not write the
    # previous call's (m, rr)
    first = _tensors(1_000_003, torch.float32, cuda)
    second = [t * 2 for t in first]
    _, _, m, rr = fused_cg_update(*first)
    want = (m.clone(), rr.clone())
    for _ in range(3):
        fused_cg_update(*second)
    torch.cuda.synchronize()
    assert torch.equal(m, want[0]) and torch.equal(rr, want[1])


def test_kernel_on_two_streams_at_once(cuda):
    inputs = [_tensors(n, torch.float32, cuda) for n in (1_387_520, 1_000_003)]
    eager = [fused_cg_update(*args) for args in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):  # interleaved, so the two streams overlap
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[k].append(fused_cg_update(*inputs[k]))
    torch.cuda.synchronize()
    for k in range(2):
        for out in outs[k]:
            for got, want in zip(out, eager[k]):
                assert torch.equal(got, want)


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


def test_prefetcher_on_card_is_bitwise_and_orders_the_stream(cuda):
    """``DevicePrefetcher`` on the card over ``depth + 2`` batches (two
    passes through its queue, pinned buffers per batch): every batch equals
    the loader's bit for bit, labels stay int64, and the consumer's stream
    waits on the copy's event -- with the copy held back behind a sleep on
    the prefetcher's stream, the current stream is busy right after the
    pop."""
    import threading

    from pytorchhessianfree_tpu_torch.runtime import (
        DevicePrefetcher,
        PrefetchLoader,
    )

    rng = np.random.default_rng(0)
    x = rng.random((64, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, 64).astype(np.int64)
    depth = 2
    ref = PrefetchLoader(x, y, batch_size=8, seed=3)
    expected = [ref.next_batch() for _ in range(depth + 2)]
    ref.close()

    gate = threading.Event()
    loader = PrefetchLoader(x, y, batch_size=8, seed=3)

    def gated():
        gate.wait(30)
        yield from loader

    pf = DevicePrefetcher(gated(), depth=depth, n_batches=depth + 2)
    with torch.cuda.stream(pf._stream):
        torch.cuda._sleep(1_000_000_000)  # ~0.5 s on the copy's stream
    gate.set()
    torch.cuda.current_stream().synchronize()
    bx, by = next(pf)
    assert not torch.cuda.current_stream().query()
    got = [(bx, by)] + list(pf)
    pf.close()
    loader.close()
    assert len(got) == depth + 2
    for (bx, by), (ex, ey) in zip(got, expected):
        assert bx.device.type == "cuda" and by.dtype == torch.int64
        assert torch.equal(bx.cpu(), torch.from_numpy(ex))
        assert torch.equal(by.cpu(), torch.from_numpy(ey))


def test_module_adapter_allcnnc_gradient_on_card_matches_cpu(cuda):
    """The ``nn.Sequential`` All-CNN-C through ``module_fns``: loss and
    gradient on the card against the CPU, f64."""
    import sys
    from pathlib import Path

    from pytorchhessianfree_tpu_torch import module_fns, split_module_state
    from pytorchhessianfree_tpu_torch.ops.curvature import value_and_grad

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from examples_torch.example_utils import (
        allcnnc_sequential,
        load_hwio_convs,
    )

    gen = torch.Generator().manual_seed(0)
    net = load_hwio_convs(
        allcnnc_sequential(width_scale=0.125).double(),
        init_allcnnc(gen, width_scale=0.125, dtype=torch.float64))
    params, _ = split_module_state(net)
    x = torch.randn((8, 3, 32, 32), generator=gen, dtype=torch.float64)
    y = torch.randint(0, 100, (8,), generator=gen)
    fns = module_fns(net, cross_entropy_loss)
    out = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        loss, grad = value_and_grad(
            lambda q: fns.loss_outer(fns.model_fn(q, x.to(dev)), y.to(dev)), p)
        out.append((loss.cpu(), TrainableRavel(p).ravel(grad).cpu()))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-12, atol=0)
    err = torch.linalg.vector_norm(g_gpu - g_cpu)
    assert err <= 1e-10 * torch.linalg.vector_norm(g_cpu)


@pytest.fixture(scope="module")
def nccl_mesh():
    """A 1-rank NCCL group (the default backend on the card) and its
    mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) for the kernel")
    import socket

    import torch.distributed as dist

    from pytorchhessianfree_tpu_torch.parallel import distributed as pdist
    from pytorchhessianfree_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    pdist.initialize_distributed(f"localhost:{port}", 1, 0)
    assert dist.get_backend() == "nccl"
    yield make_mesh()
    dist.destroy_process_group()
    pdist._device = None


class _SecondOfTwo:
    """A mesh as rank 1 of a 2-rank data axis sees it."""

    mesh_dim_names = ("data",)

    def size(self, dim):
        return 2

    def get_local_rank(self, axis):
        return 1


def test_prefetcher_with_sharding_on_card_keeps_the_rank_rows(nccl_mesh):
    """``DevicePrefetcher(sharding=)`` on the card: each batch is this
    rank's rows, bit for bit, on the rank's card (all rows on the 1-rank
    mesh and when replicated; the second half as rank 1 of 2)."""
    from pytorchhessianfree_tpu_torch.parallel.mesh import (
        Sharding,
        batch_sharding,
        replicated,
    )
    from pytorchhessianfree_tpu_torch.runtime import DevicePrefetcher

    rng = np.random.default_rng(0)
    x = rng.random((8, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, 8).astype(np.int64)
    for sharding, rows in ((batch_sharding(nccl_mesh), slice(0, 8)),
                           (replicated(nccl_mesh), slice(0, 8)),
                           (Sharding(_SecondOfTwo(), "data"), slice(4, 8))):
        with DevicePrefetcher(iter([(x, y)] * 3), sharding=sharding) as pf:
            got = list(pf)
        assert len(got) == 3
        for bx, by in got:
            assert bx.device == torch.device("cuda", 0)
            assert torch.equal(bx.cpu(), torch.from_numpy(x[rows]))
            assert torch.equal(by.cpu(), torch.from_numpy(y[rows]))


def test_one_rank_nccl_dp_step_is_hf_step_on_card(nccl_mesh):
    """``make_dp_hf_step`` on the 1-rank NCCL mesh equals ``hf_step`` bit
    for bit on a narrow ResNet-18, f32, cuDNN deterministic."""
    from pytorchhessianfree_tpu_torch import (
        HFConfig,
        HFModelFns,
        hf_step,
        init_state,
    )
    from pytorchhessianfree_tpu_torch.models import (
        init_resnet18,
        resnet18_apply,
    )
    from pytorchhessianfree_tpu_torch.parallel.data_parallel import (
        make_dp_hf_step,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_resnet18(gen, width_scale=1 / 8)
    x = torch.randn((16, 28, 28, 1), generator=gen, device="cuda")
    y = torch.randint(0, 10, (16,), generator=gen, device="cuda")
    fns = HFModelFns(model_fn=resnet18_apply, loss_outer=cross_entropy_loss)
    config = HFConfig(damping=1.0, cg_max_iter=20)
    ravel = TrainableRavel(params, pad_to_multiple=1024)
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for step in (
            lambda p, s, b: hf_step(p, s, b, fns=fns, config=config,
                                    ravel=ravel),
            make_dp_hf_step(fns, config, ravel, nccl_mesh),
        ):
            p, s = params, init_state(ravel, config)
            for _ in range(2):
                p, s, stats = step(p, s, (x, y))
            runs.append((ravel.ravel(p), s, stats))
    finally:
        torch.backends.cudnn.deterministic = False
    (pa, sa, ta), (pb, sb, tb) = runs
    assert torch.equal(pa, pb)
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))
    assert ta.num_cg_iters == tb.num_cg_iters
    assert torch.equal(ta.final_loss, tb.final_loss)


@pytest.mark.parametrize("backend, world", [("gloo", 2), ("nccl", 1)])
def test_collectives_on_card_match_the_joined_program(cuda, tmp_path,
                                                      backend, world):
    """tests/test_torch_collectives.py's checks with the tensors on
    ``cuda:0``: two gloo ranks sharing the card, and NCCL at world size 1
    calling the ``Function``s directly (jvp, linearize replayed 20 times,
    vjp, vjp of jvp, both Hessian orders and the linearized one, vmap, and
    all_gather with its reduce-scatter adjoint)."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import _torch_collectives_worker as worker
    import _torch_dp_worker as dp_worker

    procs = dp_worker.spawn_script(worker.__file__,
                                   [str(tmp_path), "cuda:0", backend], world)
    got = dp_worker.collect(procs, tmp_path)
    for key, want in worker.expected(world).items():
        np.testing.assert_allclose(np.stack([r[key] for r in got]), want,
                                   rtol=1e-12, atol=1e-12, err_msg=key)
    for r in got:
        np.testing.assert_allclose(r["pair_gather"], r["pair_split"],
                                   rtol=1e-12, atol=1e-12)


def test_pipeline_probe_on_card_matches_the_sequential_blocks(cuda, tmp_path):
    """tests/test_torch_pipeline_sharded.py's probe with the tensors on
    ``cuda:0``, two gloo ranks sharing the card: ``ppermute`` against the
    joined program, and a two-stage ``pipeline_blocks`` against its blocks
    in sequence, under jvp, linearize (20 replays), vjp, the vjp of a jvp,
    the three Hessian orders and vmap of a jvp (f64)."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import _torch_dp_worker as dp_worker
    import _torch_pipeline_worker as worker

    procs = dp_worker.spawn_script(
        worker.__file__,
        [str(tmp_path / "none"), str(tmp_path), "probe", "cuda:0", "gloo"], 2)
    got = dp_worker.collect(procs, tmp_path)
    for key, want in worker.probe_expected(2).items():
        np.testing.assert_allclose(np.stack([r[key] for r in got]), want,
                                   rtol=1e-12, atol=1e-12, err_msg=key)


def test_megatron_forward_and_matvec_on_card_match_one_process(cuda,
                                                               tmp_path):
    """Two gloo ranks sharing ``cuda:0``: tests/test_sharded.py's encoder
    through the Megatron-partitioned forward (2 of 4 heads and 16 of 32
    feed-forward columns per rank) in f32, its logits and GGN matvec within
    1e-5 of one process's (norm-wise), the ranks' matvecs bitwise equal."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import _torch_dp_worker as dp_worker
    import _torch_sharded_worker as worker

    procs = dp_worker.spawn_script(
        worker.__file__,
        [str(tmp_path / "none.npz"), str(tmp_path), "card", "cuda:0"], 2)
    got = dp_worker.collect(procs, tmp_path)
    for r in got:
        for name in ("logits", "mvp"):
            a, b = r[f"card/tp/{name}"], r[f"card/one/{name}"]
            assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), name
    np.testing.assert_array_equal(got[0]["card/tp/mvp"],
                                  got[1]["card/tp/mvp"])


def test_moe_context_and_expert_parallel_on_card_match_one_process(
        cuda, tmp_path):
    """Two gloo ranks sharing ``cuda:0``: the narrow MoE LM of the
    ``moe_cp_ep`` case under CP + EP (each rank 4 of 8 positions and 2 of
    4 experts, the feed-forward routing the gathered positions, the loss
    adding the aux) in f32, its loss, gradient and GGN matvec within 1e-5
    of one process's (norm-wise), the ranks' values bitwise equal."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import _torch_dp_worker as dp_worker
    import _torch_sharded_worker as worker

    procs = dp_worker.spawn_script(
        worker.__file__,
        [str(tmp_path / "none.npz"), str(tmp_path), "card_moe", "cuda:0"], 2)
    got = dp_worker.collect(procs, tmp_path)
    for r in got:
        for name in ("loss", "grad", "mvp"):
            a, b = r[f"card_moe/joined/{name}"], r[f"card_moe/one/{name}"]
            assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), name
    for name in ("loss", "grad", "mvp"):
        np.testing.assert_array_equal(got[0][f"card_moe/joined/{name}"],
                                      got[1][f"card_moe/joined/{name}"])
