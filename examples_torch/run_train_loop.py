"""Several steps over a stacked batch with ``make_hf_train_loop``.

The JAX package compiles the steps into one ``lax.scan`` program; the
port's loop runs the same steps as a Python loop over the leading steps
axis and stacks their statistics.  This example runs the steps three ways
-- one ``make_hf_step`` call per step, the train loop, and the stateful
wrapper's ``train_steps`` -- and checks that they agree.

Runs on the CUDA card; ``--cpu`` runs it on the CPU.
"""

import time

import torch
from example_utils import generator, get_device

from pytorchhessianfree_tpu_torch import (
    HessianFree,
    HFConfig,
    HFModelFns,
    TrainableRavel,
    init_state,
    make_hf_step,
    make_hf_train_loop,
)
from pytorchhessianfree_tpu_torch.models import init_mlp, mlp_apply, mse_loss

STEPS = 16


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    device = get_device()
    print(f"Running train-loop demo on {device}")
    gen = generator(device)
    params = init_mlp(gen, sizes=(64, 64, 64, 8))
    fns = HFModelFns(model_fn=mlp_apply, loss_outer=mse_loss)
    config = HFConfig(damping=0.5, cg_max_iter=30)
    ravel = TrainableRavel(params)

    xs = torch.randn((STEPS, 64, 64), generator=gen, device=device)
    ys = torch.randn((STEPS, 64, 8), generator=gen, device=device)

    # one step call per step
    step = make_hf_step(fns, config, ravel)
    p, s = params, init_state(ravel, config)
    sync(device)
    t0 = time.perf_counter()
    for i in range(STEPS):
        p, s, stats = step(p, s, (xs[i], ys[i]))
    sync(device)
    t_loop = time.perf_counter() - t0
    print(f"step calls  : {STEPS} steps in {t_loop:.3f}s "
          f"({1e3 * t_loop / STEPS:.2f} ms/step), "
          f"final loss {float(stats.final_loss):.5f}")

    # the train loop over the stacked batch
    loop = make_hf_train_loop(fns, config, ravel)
    sync(device)
    t0 = time.perf_counter()
    p2, s2, st = loop(params, init_state(ravel, config), (xs, ys))
    sync(device)
    t_train = time.perf_counter() - t0
    print(f"train loop  : {STEPS} steps in {t_train:.3f}s "
          f"({1e3 * t_train / STEPS:.2f} ms/step), "
          f"final loss {float(st.final_loss[-1]):.5f}")
    assert abs(float(stats.final_loss) - float(st.final_loss[-1])) < 1e-6

    # The same loop through the stateful wrapper (history per step kept)
    opt = HessianFree(params, model_fn=mlp_apply, loss_outer=mse_loss,
                      damping=0.5, cg_max_iter=30, pad_to_multiple=None)
    finals = opt.train_steps((xs, ys))
    assert abs(finals[-1] - float(st.final_loss[-1])) < 1e-6
    print(f"wrapper     : opt.train_steps ran {len(finals)} steps, "
          f"final loss {finals[-1]:.5f}, history length "
          f"{len(opt.history['final_losses'])}")
