"""Process groups over ``torch.distributed`` (port of
:mod:`pytorchhessianfree_tpu.parallel.distributed`).

The JAX package wires hosts together with ``jax.distributed.initialize``;
the port's ranks are processes in one ``torch.distributed`` process group.
Every rank runs the same program, holds a replica of the parameters and
feeds its own rows of the global batch (:func:`global_batch_slice`).

The backend is NCCL on the card and gloo on the CPU, or where the caller
asks for it: two ranks can share one card only over gloo, whose
``all_reduce`` and ``broadcast`` take CUDA tensors (NCCL refuses two ranks
on one GPU).  A group that fails to form raises; nothing falls back from
one backend to the other.  Every group gets :data:`GROUP_TIMEOUT`, so that
ranks which stop agreeing fail instead of waiting forever.

Run one process per rank, for example with the launcher::

    python -m torch.distributed.run --standalone --nproc-per-node 2 train.py

and call :func:`initialize_distributed` with no arguments in each; or pass
the coordinator's address, the number of processes and the rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

GROUP_TIMEOUT = datetime.timedelta(seconds=300)
# what torch.distributed.run sets for every rank
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
# the device each rank computes on; see rank_device
_device: Optional[torch.device] = None


def _resolve(device, rank: int) -> torch.device:
    """``device`` as a ``torch.device`` with an index on the card:
    ``LOCAL_RANK`` (or the rank) modulo the number of cards, so that ranks
    beyond the card count share cards."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_distributed: device 'cuda' but no CUDA device "
                "is available; pass device='cpu' to run the ranks on the CPU."
            )
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {device!r}")
    return dev


def _form_group(backend, device, rank, **kwargs) -> None:
    """Bind the rank to its device and form the default group."""
    global _device
    dev = _resolve(device, rank)
    if dev.type == "cuda":
        # before the group forms: NCCL binds its communicator to it, and
        # DeviceMesh respects a device that is already set
        torch.cuda.set_device(dev)
        torch.cuda.init()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, timeout=GROUP_TIMEOUT, rank=rank,
                            **kwargs)
    _device = dev


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> None:
    """Join this process to the default process group.

    - With ``coordinator_address`` (``"host:port"`` or a URL such as
      ``"tcp://localhost:29500"``), ``num_processes`` and ``process_id``:
      form the group over a TCP store at that address.  A failure raises.
    - With no arguments, under a launcher (``torch.distributed.run`` sets
      ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``): form
      the group from those variables.
    - With no arguments and no launcher: stay a single process (a no-op, as
      in the JAX package); :func:`~.mesh.make_mesh` then gives a 1-rank
      mesh.

    A second call, once a group exists, is a no-op.

    Args (the port adds the last two):
        backend: ``"nccl"`` by default on the card, ``"gloo"`` on the CPU;
            pass ``"gloo"`` to run several ranks on one card.
        device: the rank's device, ``"cuda"`` by default (card
            ``LOCAL_RANK`` modulo the card count) or e.g. ``"cuda:0"`` or
            ``"cpu"``.  It is recorded for :func:`rank_device` even when the
            call stays single-process.
    """
    global _device
    if dist.is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError(
                "initialize_distributed: pass coordinator_address, "
                "num_processes and process_id together (or none of them "
                "under a launcher)"
            )
        url = coordinator_address
        if "://" not in url:
            url = f"tcp://{url}"
        _form_group(backend, device, int(process_id), init_method=url,
                    world_size=int(num_processes))
    elif all(k in os.environ for k in _LAUNCHER_ENV):
        _form_group(backend, device, int(os.environ["RANK"]),
                    init_method="env://",
                    world_size=int(os.environ["WORLD_SIZE"]))
    else:
        _device = None if device is None else torch.device(device)


def _init_single_process_group() -> None:
    """A 1-rank default group held in memory (no address, no port), on the
    device recorded by :func:`initialize_distributed` (the card if none
    was): what :func:`~.mesh.make_mesh` forms in a process that joined no
    group."""
    _form_group(None, _device, 0, store=dist.HashStore(), world_size=1)


def rank_device() -> torch.device:
    """The device this rank computes on: the one its group was formed with
    (or recorded by a single-process :func:`initialize_distributed`), the
    current card otherwise."""
    if _device is not None:
        if _device.type == "cuda" and _device.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return _device
    return torch.device("cuda", torch.cuda.current_device())


def global_batch_slice(
    global_batch_size: int,
    process_count: Optional[int] = None,
    process_index: Optional[int] = None,
) -> slice:
    """The rows of a global batch that this process feeds: a contiguous
    equal share.  ``process_count`` and ``process_index`` default to the
    live group's world size and rank (1 and 0 without a group); passing
    them makes other layouts testable, and a wrong layout fails loudly."""
    live = dist.is_initialized()
    pc = (dist.get_world_size() if live else 1) if process_count is None \
        else int(process_count)
    pi = (dist.get_rank() if live else 0) if process_index is None \
        else int(process_index)
    if pc < 1 or not 0 <= pi < pc:
        raise ValueError(f"Invalid process layout: index {pi} of {pc}")
    if global_batch_size % pc != 0:
        raise ValueError(
            f"global_batch_size {global_batch_size} is not divisible by "
            f"process_count {pc}; every host must feed an equal shard"
        )
    per = global_batch_size // pc
    start = per * pi
    return slice(start, start + per)
