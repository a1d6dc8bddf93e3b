"""Flat-vector <-> parameter-tree conversion with a trainable mask.

Port of :mod:`pytorchhessianfree_tpu.utils.flatten`.  A parameter tree is a
nest of dicts, lists and tuples whose leaves are tensors.  Leaves are taken
in the order ``jax.tree_util.tree_flatten`` gives them (dict keys sorted,
lists and tuples in order), so a flat vector of this package equals the JAX
package's flat vector of the same tree index for index.
``torch.utils._pytree`` keeps dict insertion order instead, which would
permute the vector; it is not used here.  A rebuilt dict keeps the key
order of the dict it was flattened from, because ``torch.func.jvp`` and
``linearize`` require a tangent tree to have its primal tree's structure,
key order included.

Slices of a flat vector are views.  The XLA-specific optimization barriers
of the JAX version have no counterpart in eager PyTorch.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

import torch


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """Leaves of ``tree`` in JAX order, and a structure to rebuild it."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append(d)
        return leaves, ("dict", (keys, list(tree)), defs)
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for v in tree:
            sub, d = tree_flatten(v)
            leaves += sub
            defs.append(d)
        return leaves, (type(tree).__name__, None, defs)
    return [tree], None


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("Too many leaves for this tree structure.")
    return out


def _build(treedef, it):
    if treedef is None:
        return next(it)
    kind, keys, defs = treedef
    children = [_build(d, it) for d in defs]
    if kind == "dict":
        sorted_keys, order = keys
        by_key = dict(zip(sorted_keys, children))
        return {k: by_key[k] for k in order}
    return tuple(children) if kind == "tuple" else children


def tree_map(fn, tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(leaf) for leaf in leaves])


class TrainableRavel:
    """Ravel/unravel the trainable subset of a parameter tree.

    Args:
        params: Template parameter tree (tensor leaves give shapes, dtypes
            and the device).
        trainable: Optional tree of booleans with the same structure; ``None``
            marks every leaf trainable.
        pad_to_multiple: Optionally round the flat dimension up to a multiple
            and zero-pad every raveled vector to it.  The tail stays zero
            through every CG operation; ``unravel``/``add``/``write`` ignore
            it.
    """

    def __init__(
        self,
        params: Any,
        trainable: Optional[Any] = None,
        pad_to_multiple: Optional[int] = None,
    ):
        leaves, treedef = tree_flatten(params)
        self._treedef = treedef
        self._shapes = [tuple(leaf.shape) for leaf in leaves]
        self._dtypes = [leaf.dtype for leaf in leaves]

        if trainable is None:
            mask = [True] * len(leaves)
        else:
            mask_leaves, _ = tree_flatten(trainable)
            if len(mask_leaves) != len(leaves):
                raise ValueError(
                    "Trainable mask must have one boolean per parameter "
                    f"leaf: got {len(mask_leaves)} for {len(leaves)} leaves."
                )
            mask = [bool(m) for m in mask_leaves]
        self._mask = mask

        sizes = [math.prod(s) if m else 0 for s, m in zip(self._shapes, mask)]
        self._offsets = [0]
        for s in sizes:
            self._offsets.append(self._offsets[-1] + s)
        self.unpadded_dim = self._offsets[-1]
        if self.unpadded_dim == 0:
            raise ValueError("No trainable parameters.")
        if pad_to_multiple is not None:
            if pad_to_multiple < 1:
                raise ValueError(f"Invalid pad_to_multiple {pad_to_multiple}")
            self.dim = -(-self.unpadded_dim // pad_to_multiple) * pad_to_multiple
        else:
            self.dim = self.unpadded_dim
        self._pad = self.dim - self.unpadded_dim
        train_dtypes = [d for d, m in zip(self._dtypes, mask) if m]
        dtype = train_dtypes[0]
        for d in train_dtypes[1:]:
            dtype = torch.promote_types(dtype, d)
        self.dtype = dtype
        self.device = next(
            leaf.device for leaf, m in zip(leaves, mask) if m
        )

    def _check_leaves(self, leaves):
        if len(leaves) != len(self._mask):
            raise ValueError(
                f"Tree has {len(leaves)} leaves; this TrainableRavel was "
                f"built for {len(self._mask)}."
            )

    def _check_len(self, vec: torch.Tensor):
        if vec.ndim != 1 or vec.shape[0] != self.dim:
            raise ValueError(
                f"Expected a flat vector of length {self.dim}, got shape "
                f"{tuple(vec.shape)}."
            )

    def ravel(self, tree: Any) -> torch.Tensor:
        """Concatenate the trainable leaves of ``tree`` into a flat vector."""
        leaves, _ = tree_flatten(tree)
        self._check_leaves(leaves)
        parts = [
            leaf.reshape(-1).to(self.dtype)
            for leaf, m in zip(leaves, self._mask)
            if m
        ]
        if self._pad:
            parts.append(parts[0].new_zeros(self._pad))
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def ravel_rows(self, tree: Any) -> torch.Tensor:
        """A tree whose leaves carry a leading axis of ``N`` (per-sample
        gradients) -> ``[N, dim]``; row ``i`` is :meth:`ravel` of slice
        ``i``."""
        leaves, _ = tree_flatten(tree)
        self._check_leaves(leaves)
        n = leaves[0].shape[0]
        parts = [
            leaf.reshape(n, -1).to(self.dtype)
            for leaf, m in zip(leaves, self._mask)
            if m
        ]
        if self._pad:
            parts.append(parts[0].new_zeros((n, self._pad)))
        return torch.cat(parts, dim=1)

    def _views(self, vec: torch.Tensor):
        """Per-leaf views of ``vec`` (``None`` for frozen leaves)."""
        self._check_len(vec)
        return [
            vec[self._offsets[i] : self._offsets[i + 1]].view(shape).to(dtype)
            if m
            else None
            for i, (shape, dtype, m) in enumerate(
                zip(self._shapes, self._dtypes, self._mask)
            )
        ]

    def unravel(self, vec: torch.Tensor) -> Any:
        """Vector -> tree whose frozen leaves are zeros (a tangent tree)."""
        out = [
            v
            if v is not None
            else torch.zeros(shape, dtype=dtype, device=vec.device)
            for v, shape, dtype in zip(
                self._views(vec), self._shapes, self._dtypes
            )
        ]
        return tree_unflatten(self._treedef, out)

    def write(self, params: Any, vec: torch.Tensor) -> Any:
        """Replace the trainable leaves of ``params`` with slices of ``vec``;
        frozen leaves pass through unchanged."""
        leaves, _ = tree_flatten(params)
        self._check_leaves(leaves)
        out = [
            leaf if v is None else v
            for leaf, v in zip(leaves, self._views(vec))
        ]
        return tree_unflatten(self._treedef, out)

    def add(self, params: Any, vec: torch.Tensor) -> Any:
        """Return ``params + unravel(vec)`` as a new tree."""
        leaves, _ = tree_flatten(params)
        self._check_leaves(leaves)
        out = [
            leaf if v is None else leaf + v
            for leaf, v in zip(leaves, self._views(vec))
        ]
        return tree_unflatten(self._treedef, out)

    def add_rows(self, params: Any, rows: torch.Tensor) -> Any:
        """One tree ``params + unravel(row)`` per row of ``rows`` ``[k,
        dim]``, stacked along a leading axis (frozen leaves repeated): the
        points that a batched sweep evaluates under one ``vmap``."""
        leaves, _ = tree_flatten(params)
        self._check_leaves(leaves)
        k = rows.shape[0]
        out = [
            leaf + rows[:, self._offsets[i]:self._offsets[i + 1]].reshape(
                k, *shape).to(dtype) if m
            else leaf.expand(k, *leaf.shape)
            for i, (leaf, shape, dtype, m) in enumerate(
                zip(leaves, self._shapes, self._dtypes, self._mask))
        ]
        return tree_unflatten(self._treedef, out)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The dot product of two flat vectors."""
        return torch.dot(a, b)

    def zeros(self) -> torch.Tensor:
        """A zero flat vector of the trainable dimension."""
        return torch.zeros(self.dim, dtype=self.dtype, device=self.device)
