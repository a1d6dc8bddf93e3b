"""Host cost of the pieces of ``fused_cg_update``'s CUDA path, on a card.

Prints, for one call of the wrapper and for each piece of its host path
(the checks, the allocations, the ctypes call with its launch, the
pointer and stream lookups) and for one small PyTorch op as a yardstick,
the host microseconds per call: the best and the median of 7 rounds of
200 calls queued with no synchronise, at n = 2**20 in f32.  Run from the
root of the repository on a machine with a CUDA device::

    PYTHONPATH=. python3 benchmarks_torch/k1_host.py
"""

import time

import torch

from pytorchhessianfree_tpu_torch.ops import cg_update as cu


def best(fn, calls=200, rounds=7):
    for _ in range(50):
        fn()
    rates = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rates.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return f"{min(rates):.2f} / {sorted(rates)[len(rates) // 2]:.2f}"


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k1_host.py: no CUDA device.")
    n = 1 << 20
    g = torch.Generator(device="cuda").manual_seed(0)
    args = [torch.randn(n, device="cuda", generator=g) for _ in range(5)]
    args.append(torch.tensor(0.5, device="cuda"))
    x = args[0]
    out = torch.empty(2, device="cuda")
    tiny = torch.zeros(1, device="cuda")
    cu.fused_cg_update(*args)  # builds the kernel, fills the caches
    geo = next(iter(cu._geometries.values()))
    stream = cu._raw_stream(0)
    scratch = cu._scratches[(0, stream)]
    x_out, r_out = torch.empty_like(x), torch.empty_like(x)
    packed = cu._ARGS.pack(
        *(t.data_ptr() for t in args), x_out.data_ptr(), r_out.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), n, geo.head, geo.nvec, geo.grid,
        0, stream)
    print("host us per call, best / median of 7 rounds of 200 "
          "(n = 2^20, f32):")
    for label, fn in (
        ("fused_cg_update", lambda: cu.fused_cg_update(*args)),
        ("_check", lambda: cu._check(*args)),
        ("ctypes call + launch", lambda: cu._lib.fused_cg_update(packed, 4)),
        ("torch.empty_like (CUDA)", lambda: torch.empty_like(x)),
        ("x.new_empty(2)", lambda: x.new_empty(2)),
        ("out.unbind()", lambda: out.unbind()),
        ("10 data_ptr", lambda: [t.data_ptr() for t in args * 2]),
        ("raw stream + capturing", lambda: (cu._raw_stream(0),
                                            cu._capturing())),
        ("tiny.add_(1) (one torch launch)", lambda: tiny.add_(1.0)),
        ("plain reference", lambda: cu.fused_cg_update_reference(*args)),
    ):
        print(f"  {label:32s} {best(fn)}")
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
