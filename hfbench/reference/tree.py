"""Parameter trees (nests of dicts and lists with tensor leaves) as flat
vectors: dict keys sorted, lists in order.  Each leaf is named by its path,
such as ``blocks.3.qkv.w``."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs of ``tree`` in order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


def by_path(tree: Any) -> Dict[str, torch.Tensor]:
    return dict(leaves(tree))


def rebuild(tree: Any, values: List[torch.Tensor]) -> Any:
    """A tree of ``tree``'s structure holding ``values`` in leaf order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


class Flat:
    """Flat vectors of ``tree``'s leaves and back."""

    def __init__(self, tree: Any):
        self.template = tree
        self.shapes = [t.shape for _, t in leaves(tree)]
        self.sizes = [t.numel() for _, t in leaves(tree)]

    def flat(self, tree: Any) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for _, t in leaves(tree)])

    def tree(self, vec: torch.Tensor) -> Any:
        parts = torch.split(vec, self.sizes)
        return rebuild(self.template,
                       [p.reshape(s) for p, s in zip(parts, self.shapes)])
