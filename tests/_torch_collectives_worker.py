"""One rank of tests/test_torch_collectives.py (on the CPU over gloo) and of
the collectives' card test in tests/test_torch_cuda.py::

    python tests/_torch_collectives_worker.py RANK WORLD PORT OUT_DIR \
        [DEVICE BACKEND]

Each rank joins a ``WORLD``-rank group (gloo on the CPU by default; e.g.
``cuda:0 nccl`` on the card) on ``localhost:PORT``, takes
its inputs from :func:`inputs` (rank-dependent, f64), pushes them through
the differentiable collectives of ``parallel/collectives.py`` under every
transform the optimizer uses, and writes ``OUT_DIR/rank{RANK}.npz``.  The
test computes the same derivatives of the joined program
(:func:`expected`) in one process over the joined inputs.  On one rank
the collectives' ``Function``s are called directly (the public wrappers
are the identity there and call nothing).  It imports no JAX.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.func import jvp, linearize, vjp, vmap  # noqa: E402

from pytorchhessianfree_tpu_torch.parallel import (  # noqa: E402
    collectives as C,
)

N = 5
REPLAYS = 20


def inputs(rank, world):
    """Rank ``rank``'s point, tangents and cotangents (seeded by rank)."""
    g = np.random.default_rng(100 + rank)
    t = lambda *s: torch.tensor(g.standard_normal(s))  # noqa: E731
    return {"x": t(N), "t": t(N), "u": t(N), "w": t(N), "v": t(N),
            "ts": t(REPLAYS, N), "ug": t(world * N), "tb": t(3, N)}


# -- the functions, per rank and joined ----------------------------------


def sq(x, axis):
    """f_r(x) = sum over the ranks of x_s^2 (elementwise), on every rank."""
    return C.all_reduce_sum(x * x, axis)


def joined_sq(xs):
    """The ranks' outputs of :func:`sq`, stacked: [world, N]."""
    y = (xs * xs).sum(0)
    return y.expand(xs.shape[0], -1)


def loss(x, w, axis):
    """A rank-dependent scalar through both collectives:
    sum(w_r * (sum_s x_s^2)^2) + sum(w_r[0] * gather(x)^3)."""
    y = C.all_reduce_sum(x * x, axis)
    return torch.sum(w * y * y) + w[0] * torch.sum(C.all_gather(x, axis) ** 3)


def joined_loss(xs, ws):
    """Sum over the ranks of :func:`loss`."""
    y = (xs * xs).sum(0)
    return sum(torch.sum(w * y * y) + w[0] * torch.sum(xs ** 3) for w in ws)


def joined_gather(xs):
    return xs.reshape(-1).expand(xs.shape[0], -1)


def expected(world):
    """What every rank's :func:`run` must give, from the joined program in
    one process: ``{key: [world, ...]}``."""
    ds = [inputs(r, world) for r in range(world)]
    J = {k: torch.stack([d[k] for d in ds]) for k in ds[0]}
    xs, one = J["x"], torch.ones((), dtype=torch.float64)
    out = {"value": joined_sq(xs),
           "jvp": jvp(joined_sq, (xs,), (J["t"],))[1],
           "vjp": vjp(joined_sq, xs)[1](J["u"])[0]}
    out["linearize"] = torch.stack(
        [jvp(joined_sq, (xs,), (J["ts"][:, i],))[1]
         for i in range(REPLAYS)], 1)

    def phi(z):
        return torch.sum(J["u"] * jvp(joined_sq, (z,), (J["t"],))[1])

    out["vjp_of_jvp"] = vjp(phi, xs)[1](one)[0]
    tb = J["tb"].transpose(0, 1)
    out["vmap_jvp"] = vmap(
        lambda t: jvp(joined_sq, (xs,), (t,))[1])(tb).transpose(0, 1)

    def L(z):
        return joined_loss(z, J["w"])

    def grad_L(z):
        return vjp(L, z)[1](torch.ones((), dtype=z.dtype))[0]

    out["grad"] = grad_L(xs)
    hv = jvp(grad_L, (xs,), (J["v"],))[1]
    for key in ("hvp_fwd_rev", "hvp_rev_rev", "hvp_linearized"):
        out[key] = hv
    out["gather"] = joined_gather(xs)
    out["gather_jvp"] = joined_gather(J["t"])
    out["gather_vjp"] = vjp(joined_gather, xs)[1](J["ug"])[0]
    out["gather_vmap"] = tb.reshape(3, -1).expand(world, -1, -1)
    return {k: v.numpy() for k, v in out.items()}


def run(rank, world):
    axis = C.Axis(dist.group.WORLD, world, rank)
    d = inputs(rank, world)
    x, t, u, w, v = (d[k] for k in "xtuwv")
    out = {}
    f = lambda z: sq(z, axis)  # noqa: E731

    out["value"] = f(x)
    out["jvp"] = jvp(f, (x,), (t,))[1]
    _, lin = linearize(f, x)
    out["linearize"] = torch.stack([lin(ti) for ti in d["ts"]])
    out["vjp"] = vjp(f, x)[1](u)[0]
    # the vjp of the jvp: d/dx <u, J(x) t>
    out["vjp_of_jvp"] = vjp(lambda z: torch.dot(u, jvp(f, (z,), (t,))[1]),
                            x)[1](torch.ones((), dtype=x.dtype))[0]
    out["vmap_jvp"] = vmap(lambda tt: jvp(f, (x,), (tt,))[1])(d["tb"])

    L = lambda z: loss(z, w, axis)  # noqa: E731
    grad_L = lambda z: vjp(L, z)[1](torch.ones((), dtype=z.dtype))[0]  # noqa
    out["grad"] = grad_L(x)
    out["hvp_fwd_rev"] = jvp(grad_L, (x,), (v,))[1]
    out["hvp_rev_rev"] = vjp(grad_L, x)[1](v)[0]
    _, lin_g = linearize(grad_L, x)
    out["hvp_linearized"] = lin_g(v)

    gth = lambda z: C.all_gather(z, axis)  # noqa: E731
    out["gather"] = gth(x)
    out["gather_jvp"] = jvp(gth, (x,), (t,))[1]
    out["gather_vjp"] = vjp(gth, x)[1](d["ug"])[0]
    out["gather_vmap"] = vmap(gth)(d["tb"])
    # the adjoint pair: y replicated (rank 0's cotangent on every rank)
    y = inputs(0, world)["ug"]
    out["pair_gather"] = torch.dot(gth(x), y)
    out["pair_split"] = C.all_reduce_sum(
        torch.dot(x, C.split(y, axis)), axis)
    return {k: val.detach().cpu().numpy() for k, val in out.items()}


def _direct():
    """Call the ``Function``s even on one rank."""
    C.all_reduce_sum = lambda x, axis: C._AllReduceSum.apply(x, axis)
    C.all_gather = lambda x, axis, dim=0: C._AllGather.apply(
        x, axis, dim % x.dim())
    C.split = lambda x, axis, dim=0: C._block(x, axis, dim % x.dim())


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    out_dir = sys.argv[4]
    device, backend = (sys.argv[5:7] if len(sys.argv) > 5
                       else ("cpu", "gloo"))
    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    if world == 1:
        _direct()
    torch.set_default_device(device)
    out = run(rank, world)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    print(f"rank {rank}/{world} [collectives, {device}, {backend}]: ok")


if __name__ == "__main__":
    main()
