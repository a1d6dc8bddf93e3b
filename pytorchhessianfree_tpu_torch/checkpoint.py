"""Checkpoint / resume (port of :mod:`pytorchhessianfree_tpu.checkpoint`).

The optimizer state is an explicit :class:`~.optimizer.HFState`, so a
checkpoint is ``(params, state, history)``.  Two backends:

- :func:`save` / :func:`restore`: ``torch.save`` of the tensors into a
  directory, read back with ``torch.load(weights_only=True)``; the port's
  native format, in place of the JAX package's Orbax.  The history goes to
  ``history.json`` beside it.
- :func:`save_npz` / :func:`restore_npz`: one ``numpy.savez`` file in the
  JAX package's layout (``param_{i}`` in sorted-key leaf order,
  ``state_x0`` / ``state_damping`` / ``state_step_count`` and a ``__meta__``
  JSON record), so a checkpoint of either package restores in the other.

Both write atomically (a temporary file, then ``os.replace``) and restore
onto the CPU; :meth:`~.optimizer.HessianFree.load` moves the tensors to the
optimizer's device.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .optimizer import HFState
from .utils.flatten import tree_flatten, tree_map, tree_unflatten

# __meta__["writer"] of the npz files this package writes
_WRITER = "pytorchhessianfree_tpu_torch"


def _replace_atomically(path: str, write) -> None:
    """``write(tmp_path)``, then rename it onto ``path``, so a crash never
    leaves a torn file at ``path``."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _cpu(tree: Any) -> Any:
    return tree_map(lambda t: t.detach().cpu(), tree)


def save(path: str, params: Any, state: HFState,
         history: Optional[dict] = None) -> None:
    """Checkpoint ``(params, state, history)`` into the directory ``path``:
    ``tree.pt`` holds the tensors, ``history.json`` the history lists."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tree = {"params": _cpu(params), "state": _cpu(state._asdict())}
    _replace_atomically(
        os.path.join(path, "tree.pt"), lambda tmp: torch.save(tree, tmp)
    )

    def write_history(tmp):
        with open(tmp, "w") as f:
            json.dump(history or {}, f)

    _replace_atomically(os.path.join(path, "history.json"), write_history)


def restore(path: str) -> Tuple[Any, HFState, dict]:
    """Restore a checkpoint written by :func:`save`, on the CPU.  A missing
    ``history.json`` (a save cut between its two files) warns and restores
    an empty history."""
    path = os.path.abspath(path)
    tree = torch.load(
        os.path.join(path, "tree.pt"), map_location="cpu", weights_only=True
    )
    hpath = os.path.join(path, "history.json")
    if os.path.exists(hpath):
        with open(hpath) as f:
            history = json.load(f)
    else:
        warnings.warn(
            f"checkpoint at {path!r} has a tree but no history.json "
            "(interrupted save?); restoring with empty history",
            RuntimeWarning,
            stacklevel=2,
        )
        history = {}
    return tree["params"], HFState(**tree["state"]), history


def _npz_path(path: str) -> str:
    # np.savez appends ".npz" when missing; save and restore agree on it
    return path if path.endswith(".npz") else path + ".npz"


def _treedef_str(tree: Any) -> str:
    """The structure of a tree of dicts, lists, tuples and leaves in the
    form of the JAX package's ``str(treedef)``."""

    def node(t):
        if isinstance(t, dict):
            items = ", ".join(f"{k!r}: {node(t[k])}" for k in sorted(t))
            return "{" + items + "}"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(node(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({node(tree)})"


def save_npz(path: str, params: Any, state: HFState,
             history: Optional[dict] = None) -> None:
    """Checkpoint into one npz file in the JAX package's layout."""
    path = _npz_path(path)
    leaves, _ = tree_flatten(params)
    arrays = {
        f"param_{i}": leaf.detach().cpu().numpy()
        for i, leaf in enumerate(leaves)
    }
    for name, value in state._asdict().items():
        arrays[f"state_{name}"] = value.detach().cpu().numpy()
    meta = {
        "treedef": _treedef_str(params),
        "num_leaves": len(leaves),
        "history": history or {},
        "writer": _WRITER,
    }

    def write(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)

    _replace_atomically(path, write)


def restore_npz(path: str, params_template: Any) -> Tuple[Any, HFState, dict]:
    """Restore an npz checkpoint of either package, on the CPU, into the
    structure of ``params_template``.  The leaf count and every leaf's shape
    must match the template; the structure string is checked too on files
    this package wrote (the JAX package's comes from JAX's own tree
    registry)."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        leaves, treedef = tree_flatten(params_template)
        if meta["num_leaves"] != len(leaves):
            raise ValueError(
                f"Checkpoint has {meta['num_leaves']} leaves, template has "
                f"{len(leaves)}."
            )
        if meta.get("writer") == _WRITER and (
            meta["treedef"] != _treedef_str(params_template)
        ):
            raise ValueError(
                "Checkpoint pytree structure does not match the template:\n"
                f"  saved:    {meta['treedef']}\n"
                f"  template: {_treedef_str(params_template)}"
            )
        new_leaves = []
        for i, leaf in enumerate(leaves):
            arr = data[f"param_{i}"]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"Checkpoint leaf {i} has shape {arr.shape}, template "
                    f"has {tuple(leaf.shape)}."
                )
            new_leaves.append(torch.from_numpy(arr))
        state = HFState(
            x0=torch.from_numpy(data["state_x0"]),
            damping=torch.from_numpy(data["state_damping"]),
            step_count=torch.from_numpy(data["state_step_count"]).to(
                torch.int64
            ),
        )
    return tree_unflatten(treedef, new_leaves), state, meta.get("history", {})
