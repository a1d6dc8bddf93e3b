"""Shared utilities of the PyTorch port's examples: the device, synthetic
problems, the real-data stream and the step report.

Every example runs on the CUDA card by default and stops with an error if
there is none; ``--cpu`` is the only way to run it on the CPU.  ``--tiny``
shrinks an example (width, batch, CG budget; same code path) so that it
runs in seconds on a CPU.  The image examples take ``--data <dir>`` to
stream a real dataset through the native loader and the device prefetcher.

As in the JAX package's examples (and unlike the reference, which
downloads MNIST / CIFAR-100 with torchvision / DeepOBS), the default data
is synthetic at the real shapes: HF never looks at the data's meaning, only
at loss, gradient and curvature evaluations.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402
from torch import nn  # noqa: E402


def get_device() -> torch.device:
    """``cuda`` unless ``--cpu`` is given; without a CUDA device the
    example stops instead of falling back to the CPU."""
    if "--cpu" in sys.argv:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(
            "No CUDA device: the examples run on the card by default; pass "
            "--cpu to run on the CPU."
        )
    return torch.device("cuda")


def flag_value(name, default=None):
    """The argument after ``name`` on the command line, or ``default``."""
    if name not in sys.argv:
        return default
    i = sys.argv.index(name)
    if i + 1 >= len(sys.argv):
        raise SystemExit(f"{name} needs a value")
    return sys.argv[i + 1]


def is_tiny() -> bool:
    return "--tiny" in sys.argv


def generator(device, seed: int = 0) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def get_small_nn_problem(gen, N=16, sizes=(7, 5, 5, 3),
                         dtype=torch.float32):
    """Small-MLP + MSE problem (reference examples/example_utils.py:23-56):
    params on the generator's device and one ``(x, y)`` batch."""
    from pytorchhessianfree_tpu_torch.models import init_mlp

    params = init_mlp(gen, sizes, dtype=dtype)
    return params, get_small_nn_batch(gen, N, sizes, dtype)


def get_small_nn_batch(gen, N=16, sizes=(7, 5, 5, 3), dtype=torch.float32):
    dev = gen.device
    x = torch.randn((N, sizes[0]), generator=gen, device=dev, dtype=dtype)
    y = torch.randn((N, sizes[-1]), generator=gen, device=dev, dtype=dtype)
    return x, y


def synthetic_mnist_batch(gen, batch_size=32, dtype=torch.float32):
    """[N, 28, 28, 1] images (NHWC) + 10-class int64 labels."""
    dev = gen.device
    x = torch.randn((batch_size, 28, 28, 1), generator=gen, device=dev,
                    dtype=dtype)
    y = torch.randint(0, 10, (batch_size,), generator=gen, device=dev)
    return x, y


def synthetic_cifar100_batch(gen, batch_size=32, dtype=torch.float32):
    """[N, 32, 32, 3] images (NHWC) + 100-class int64 labels."""
    dev = gen.device
    x = torch.randn((batch_size, 32, 32, 3), generator=gen, device=dev,
                    dtype=dtype)
    y = torch.randint(0, 100, (batch_size,), generator=gen, device=dev)
    return x, y


def parse_data_dir():
    """``--data <dir>`` switches from synthetic batches to a real dataset
    streamed through the native loader.

    Expected files: ``<dir>/train_x.npy`` -- float32 ``[N, H, W, C]``
    (NHWC) preprocessed images (MNIST: ``[N, 28, 28, 1]`` scaled to [0, 1]
    like torchvision ``ToTensor``; CIFAR-100: ``[N, 32, 32, 3]`` per-channel
    standardized like DeepOBS) -- and ``<dir>/train_y.npy`` -- integer
    ``[N]`` class labels.
    """
    if "--data" not in sys.argv:
        return None
    i = sys.argv.index("--data")
    if i + 1 >= len(sys.argv):
        raise SystemExit(
            "--data needs a directory argument (containing "
            "train_x.npy [N,H,W,C] float32 + train_y.npy [N] int)"
        )
    d = sys.argv[i + 1]
    for f in ("train_x.npy", "train_y.npy"):
        if not os.path.exists(os.path.join(d, f)):
            raise FileNotFoundError(
                f"--data {d}: missing {f} (expected train_x.npy "
                "[N,H,W,C] float32 + train_y.npy [N] int labels)"
            )
    return d


def real_batch_stream(data_dir, batch_size, device, seed=0, sharding=None):
    """Real-dataset pipeline: mmap-backed ``.npy`` -> C++
    ``PrefetchLoader`` (threaded shuffled gathers) -> ``DevicePrefetcher``
    (pinned host copy, asynchronous transfer on a side stream, overlapped
    with the step).  With a ``sharding`` (data parallelism), every rank
    reads the same global batches and keeps its own rows before the copy.

    Returns the ``DevicePrefetcher`` (an iterator of ``(x, y)`` batches on
    ``device``; also a context manager -- close it when done).
    """
    from pytorchhessianfree_tpu_torch.runtime import (
        DevicePrefetcher,
        PrefetchLoader,
    )

    loader = PrefetchLoader.from_npy(
        os.path.join(data_dir, "train_x.npy"),
        os.path.join(data_dir, "train_y.npy"),
        batch_size,
        seed=seed,
    )
    # close_source: closing the prefetcher also shuts the native loader's
    # threads and mmap handles down (the stream owns the whole pipeline)
    return DevicePrefetcher(loader, device=device, close_source=True,
                            sharding=sharding)


def allcnnc_sequential(num_classes=100, in_channels=3, width_scale=1.0):
    """All-CNN-C as a ``torch.nn.Sequential`` of ``nn.Conv2d`` / ``nn.ReLU``
    on NCHW inputs, ending in the global mean: the model of
    :func:`~pytorchhessianfree_tpu_torch.models.allcnnc_apply` as a user
    would write it.  Its "SAME" padding is explicit, as in ``allcnnc_apply``:
    an ``nn.ZeroPad2d(1)`` before each stride-1 3x3 conv and an
    ``nn.ZeroPad2d((0, 1, 0, 1))`` before each stride-2 one -- JAX's "SAME"
    at stride 2 pads one row and column after and none before, where
    ``nn.Conv2d(padding=1)`` would pad both sides and read shifted windows
    -- so that the two models run the same convolutions."""
    c96 = max(1, round(96 * width_scale))
    c192 = max(1, round(192 * width_scale))
    same, same_s2 = (1, 1, 1, 1), (0, 1, 0, 1)  # (left, right, top, bottom)
    layers = []
    for k, cin, cout, stride, pad in (
        (3, in_channels, c96, 1, same),
        (3, c96, c96, 1, same),
        (3, c96, c96, 2, same_s2),
        (3, c96, c192, 1, same),
        (3, c192, c192, 1, same),
        (3, c192, c192, 2, same_s2),
        (3, c192, c192, 1, None),  # VALID, as in the paper
        (1, c192, c192, 1, None),
        (1, c192, num_classes, 1, None),
    ):
        if pad is not None:
            layers.append(nn.ZeroPad2d(pad))
        layers += [nn.Conv2d(cin, cout, k, stride=stride), nn.ReLU()]
    layers[-1] = nn.AdaptiveAvgPool2d(1)  # no ReLU after the last conv
    layers.append(nn.Flatten())
    return nn.Sequential(*layers)


@torch.no_grad()
def load_hwio_convs(module, params):
    """Copy a ``{"convs": [{"w": HWIO, "b": [out]}, ...]}`` tree (e.g.
    ``init_allcnnc``'s) into the ``nn.Conv2d`` layers of ``module`` in
    order, HWIO -> OIHW."""
    convs = [m for m in module.modules() if isinstance(m, nn.Conv2d)]
    if len(convs) != len(params["convs"]):
        raise ValueError(f"{len(convs)} convolutions for "
                         f"{len(params['convs'])} kernels")
    for m, layer in zip(convs, params["convs"]):
        m.weight.copy_(layer["w"].permute(3, 2, 0, 1))
        m.bias.copy_(layer["b"])
    return module


def report(step_idx, opt):
    h = opt.history
    print(
        f"step {step_idx}: loss {h['init_losses'][-1]:.6f} -> "
        f"{h['final_losses'][-1]:.6f} | lr {h['learning_rates'][-1]:.4f} | "
        f"damping {h['dampings'][-1]:.4f} | cg {h['num_cg_iters'][-1]} iters "
        f"({h['cg_reasons'][-1]}) | best iter {h['best_cg_iters'][-1]}"
    )


def start_ranks(device):
    """Join the process group that ``torch.distributed.run`` describes
    (``--backend gloo`` to let several ranks share one card; gloo on the
    CPU, NCCL on the cards otherwise) and return ``(rank, world, the rank's
    device, say)``, where ``say`` prints on rank 0 only."""
    import torch.distributed as dist

    from pytorchhessianfree_tpu_torch.parallel.distributed import (
        initialize_distributed,
        rank_device,
    )

    initialize_distributed(backend=flag_value("--backend"),
                           device=device.type)
    if not dist.is_initialized():
        raise SystemExit(
            "start the ranks with torch.distributed.run, e.g. python -m "
            "torch.distributed.run --standalone --nproc-per-node 2 "
            f"{os.path.basename(sys.argv[0])} --cpu"
        )
    rank = dist.get_rank()

    def say(text):
        if rank == 0:
            print(text, flush=True)

    return rank, dist.get_world_size(), rank_device(), say


def report_launches(rank, world, iters, device, say):
    """On the card: every rank's CUDA-kernel launches beside its CG
    iterations, brought to rank 0 by one ``all_reduce`` and printed there
    alone (the launcher merges the ranks' output streams, which may split
    one rank's line with another's).  Nothing on the CPU."""
    if device.type != "cuda":
        return
    import torch.distributed as dist

    from pytorchhessianfree_tpu_torch import fused_cg_update

    counts = torch.zeros(world, 1 + len(iters), dtype=torch.float64,
                         device=device)
    counts[rank] = torch.tensor([fused_cg_update.launches, *iters],
                                dtype=torch.float64)
    dist.all_reduce(counts)
    for r, row in enumerate(counts.tolist()):
        say(f"rank {r}: fused_cg_update launches: {int(row[0])} "
            f"(CG iterations {[int(i) for i in row[1:]]})")
