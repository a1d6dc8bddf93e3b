"""One run of one training cell: set-up, the measured window, and the
comparison with the plain reference that decides ``correct``.

Set-up makes the weights and every step's rows on the device from the
seed, builds one optimizer, and drives it through the cell's
``check_steps`` first steps with the window's own call, keeping on the host
what the reference needs to follow them: the parameters, the warm start and
the damping before and after each step, the first step's gradient as the
optimizer got it, and the preconditioner's diagonal where a step has one.
These steps also warm up every shape the window uses.  The window then
runs whole steps on fresh rows until ``seconds`` have passed; its time ends
with the last step.  After it, the program is freed and the reference
recomputes each of the first steps from the program's state before it, in
float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from types import SimpleNamespace

from . import compare, devtrace, faults, manifest, spans
from .reference import hf
from .reference.tree import by_path

GIB = 2**30


def process_start() -> float:
    """The epoch time at which this process started (10 ms resolution)."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def set_precision(torch, config):
    """The configuration's precision for the whole process: float32 with
    TF32 off for matmuls and convolutions, as both configurations state."""
    p = config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = p["tf32_matmul"]
    torch.backends.cudnn.allow_tf32 = p["tf32_cudnn"]


def _host(t):
    return t.detach().to("cpu", copy=True)


def _snapshot(opt, extra):
    from pytorchhessianfree_tpu_torch.utils.flatten import tree_map

    return dict(params=tree_map(_host, opt.params), x0=_host(opt.state.x0),
                damping=float(opt.state.damping),
                extra={k: _host(v) for k, v in extra.items()})


def _record(history, j):
    return dict(init_loss=history["init_losses"][j],
                final_loss=history["final_losses"][j],
                num_cg_iters=history["num_cg_iters"][j],
                best_cg_iter=history["best_cg_iters"][j],
                lr=history["learning_rates"][j])


@contextlib.contextmanager
def _first_gradient(source, out):
    """Keep the flat gradient of the first call of the port's
    ``source = (module, function)``, whose result is ``(loss, gradient,
    ...)``."""
    import importlib

    module = importlib.import_module(
        f"pytorchhessianfree_tpu_torch.{source[0]}")
    original = getattr(module, source[1])

    def keep(*args, **kwargs):
        result = original(*args, **kwargs)
        out.setdefault("grad", _host(result[1]))
        return result

    setattr(module, source[1], keep)
    try:
        yield
    finally:
        setattr(module, source[1], original)


@contextlib.contextmanager
def _no_span(name):
    yield


# the groups of a cell's ``hf`` fields that ``HFConfig`` takes as objects
_NESTED = {"cg": "CGConfig", "linesearch": "LineSearchConfig"}


def run(name, seed, seconds, trace, *, root=manifest.ROOT, device="cuda",
        control=None, fault=None, started=None):
    """Run the cell ``name`` once.  Returns ``(result, compared)``: the
    result line's object without its ``compared`` key, and the compared
    numbers as ``{name: (value, limit)}``."""
    import torch

    import pytorchhessianfree_tpu_torch as pkg
    from pytorchhessianfree_tpu_torch.ops import cg_update

    started = time.time() if started is None else started
    cell = manifest.Cell(name, root)
    fam, ent, ref = cell.family, cell.entry, cell.reference
    model, traffic = cell.config["model"], cell.traffic
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    set_precision(torch, cell.config)

    gen = torch.Generator(device=device).manual_seed(seed)
    params = fam.make_params(model, gen, device)
    n_check, pool = traffic["check_steps"], traffic["batches"]
    per = ent.rows_per_step(traffic)
    x_all, y_all = fam.make_rows(model, traffic, per * (n_check + pool), gen,
                                 device)
    steps = [(x_all[i * per:(i + 1) * per], y_all[i * per:(i + 1) * per])
             for i in range(n_check + pool)]
    hf_config = dict(traffic["hf"])
    if control == "tf32":
        hf_config["matmul_precision"] = "high"
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    hf_config = pkg.HFConfig(**{
        k: getattr(pkg, _NESTED[k])(**v) if k in _NESTED else v
        for k, v in hf_config.items()})
    tracer = spans.Tracer(sync) if trace else None
    span = tracer.span if trace else _no_span

    with faults.planted(fault, fam.program_fns(model)) as fns:
        driver = ent.Driver(pkg, params, fns, traffic, hf_config, span)
        del params
        opt, ravel = driver.opt, driver.opt.ravel
        snaps, captured = [_snapshot(opt, {})], {}
        with _first_gradient(ent.GRAD_SOURCE, captured):
            for k in range(n_check):
                extra = driver.step(steps[k])
                sync()
                snaps.append(_snapshot(opt, extra))

        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        launches0 = cg_update.fused_cg_update.launches
        if trace:
            tracer.install()
        setup_s = time.time() - started
        with (devtrace.Profile(cuda) if trace
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            done = 0
            while True:
                with span("step"):
                    driver.step(steps[n_check + done % pool])
                sync()
                done += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
        if trace:
            tracer.uninstall()
        window_s = t1 - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        launches = cg_update.fused_cg_update.launches - launches0
        history, config = opt.history, opt.config
        checked = [_record(history, j) for j in range(n_check)]
        records = [_record(history, j) for j in range(n_check,
                                                       n_check + done)]
        del driver, opt, steps[n_check:]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    failed = sum(1 for r in records
                 if not (math.isfinite(r["final_loss"])
                         and r["final_loss"] <= r["init_loss"]))
    flops = sum(ent.step_flops(fam, model, traffic, r, config)
                for r in records)
    peaks = _peaks(torch, device)
    run_info = SimpleNamespace(
        records=records, steps=done, window_s=window_s, flat_dim=ravel.dim,
        itemsize=ravel.dtype.itemsize, peaks=peaks, flops=flops,
        spans=[s for s in tracer.spans if s.start >= t0] if trace else [],
        ops=prof.ops if trace else [], window=(t0, t1))
    result = dict(correct=False, attempted=done, failed=failed, metrics={},
                  device=_device(torch, device, peak))
    if trace:
        _traced(cell, run_info, result)
    else:
        e2e = dict(step_s=window_s / done,
                   mfu=100 * flops / window_s
                   / peaks["float32_flops_per_s"],
                   peak_mem_gib=peak / GIB, setup_s=setup_s)
        result["metrics"] = {m["name"]: dict(value=e2e[m["name"]],
                                             unit=m["unit"])
                             for m in cell.end_to_end}
    result["info"] = dict(
        cg_iters=[r["num_cg_iters"] for r in records],
        check_cg_iters=[r["num_cg_iters"] for r in checked],
        k1_launches=launches, window_s=window_s, setup_s=setup_s,
        flops=flops, seed=seed, control=control, fault=fault)

    t_ref = time.perf_counter()
    numbers, followed = _compare(ent, ref, model, traffic, ravel, snaps,
                                 checked, captured, x_all[:per * n_check],
                                 y_all[:per * n_check], per, device)
    result["info"]["followed"] = followed
    result["info"]["reference_s"] = time.perf_counter() - t_ref
    if trace:
        result["info"]["trace_read_s"] = prof.read_s
    limits = traffic.get("limits", {})
    # a number whose limit is null is read and printed, not compared
    read = {k: v for k, v in numbers.items()
            if k in limits and limits[k] is None}
    result["info"]["read"] = read
    compared = {k: (v, limits.get(k)) for k, v in numbers.items()
                if k not in read}
    result["correct"] = bool(
        done > 0 and failed == 0
        and all(lim is not None and v <= lim
                for v, lim in compared.values()))
    return result, compared


def _peaks(torch, device):
    table = manifest.read_json(manifest.HERE / "peaks.json")["cards"]
    if device != "cuda":
        return dict(next(iter(table.values())))
    name = torch.cuda.get_device_name(0)
    if name not in table:
        raise RuntimeError(f"no peaks for the card {name!r} in peaks.json")
    return table[name]


def _device(torch, device, peak):
    if device != "cuda":
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=1, memory_peak_bytes=peak)


def _traced(cell, run_info, result):
    """The per-layer metrics of a traced window, its device busy time and
    its breakdown."""
    window = run_info.window
    ops = [devtrace.DeviceOp(o.name, max(o.start, window[0]),
                             min(o.end, window[1]))
           for o in run_info.ops if o.end > window[0] and o.start < window[1]]
    run_info.ops = ops
    run_info.busy_s = devtrace.busy_seconds(ops)
    result["device"]["busy_s"] = run_info.busy_s
    result["device"]["window_s"] = run_info.window_s
    for m in cell.per_layer:
        value = cell.metric(m["name"]).read(run_info)
        if value is not None:
            result["metrics"][m["name"]] = dict(value=value, unit=m["unit"])
    result["breakdown"] = dict(
        device_ops=devtrace.top_ops(ops),
        idle_gaps=devtrace.idle_by_span(ops, window, run_info.spans))


def _compare(ent, ref, model, traffic, ravel, snaps, checked, captured,
             x, y, per, device):
    """Follow each first step with the reference from the program's state
    before it, and measure the gaps that :mod:`.compare` describes."""
    from pytorchhessianfree_tpu_torch.utils.flatten import tree_map

    settings = hf.settings_of(traffic["hf"])

    def dev(tree):
        return tree_map(lambda t: t.to(device), tree)

    def tree_of(flat):
        return by_path(ravel.unravel(flat.to(device)))

    numbers = dict(loss=0.0, grad=0.0, select=0.0, update=0.0, state=0.0)
    followed = []  # per step, (program, reference): what each step chose
    carry = None
    for k in range(len(checked)):
        before, after = snaps[k], snaps[k + 1]
        params = dev(before["params"])
        rows = (x[k * per:(k + 1) * per], y[k * per:(k + 1) * per])
        out, carry = ent.reference_step(
            ref, model, traffic, settings, params,
            ravel.unravel(before["x0"].to(device)), before["damping"], rows,
            carry, (checked[k]["best_cg_iter"], checked[k]["num_cg_iters"]))
        keep = compare.sound_leaves(compare.norms(by_path(out["grad"])))
        numbers["loss"] = max(numbers["loss"], compare.rel_gap(
            checked[k]["init_loss"], out["loss"]))
        numbers["select"] = max(numbers["select"], out["select"])
        if k == 0:
            numbers["grad"] = compare.worst_leaf_gap(
                tree_of(captured["grad"]), by_path(out["grad"]))
        start, prog, refp = by_path(params), by_path(dev(after["params"])), \
            by_path(out["params"])
        update, leaf = compare.worst_leaf(
            {p: prog[p] - start[p] for p in start},
            {p: refp[p] - start[p] for p in start}, keep)
        numbers["update"] = max(numbers["update"], update)
        numbers["state"] = max(
            numbers["state"],
            compare.worst_leaf_gap(tree_of(after["x0"]), by_path(out["x0"]),
                                   keep),
            compare.rel_gap(after["damping"], out["damping"]))
        if "diag" in out:
            numbers["precond"] = max(numbers.get("precond", 0.0),
                                     compare.worst_leaf_gap(
                                         tree_of(after["extra"]["diag"]),
                                         by_path(out["diag"])))
        followed.append(dict(
            cg_iters=(checked[k]["num_cg_iters"], out["cg_iters"]),
            best_iter=(checked[k]["best_cg_iter"], out["best_iter"]),
            select=out["select"],
            lr=(checked[k]["lr"], out["lr"]),
            damping=(after["damping"], out["damping"]),
            update=(update, leaf)))
        del params, out
    return numbers, followed
