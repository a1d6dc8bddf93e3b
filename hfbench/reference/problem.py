"""A training objective in plain PyTorch on flat vectors, made of a model
family's reference forward and loss and the step's rows.

The loss and the gradient are the mean over the loss chunks (all of one
size) plus the family's regularizer; the Gauss-Newton matrix is that of the
data term over the curvature chunks, without the regularizer; the
empirical-Fisher diagonal is the mean over samples of the squared gradient
of one sample's loss plus the regularizer."""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import hf
from .tree import Flat, leaves


class Problem:
    def __init__(self, ref, model, params, loss_chunks: List[Tuple],
                 curvature_chunks: List[Tuple]):
        self.ref, self.model = ref, model
        self.flat = Flat(params)
        self.reg = ref.regularizer(model)
        self.loss_chunks = loss_chunks
        self.curvature_chunks = curvature_chunks

    def _data_loss(self, tree, x, y):
        return self.ref.outer_loss(self.ref.outputs(tree, x, self.model), y)

    def _full(self, tree, chunks):
        total = sum(self._data_loss(tree, x, y) for x, y in chunks)
        total = total / len(chunks)
        return total if self.reg is None else total + self.reg(tree)

    def loss(self, w: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._full(self.flat.tree(w), self.loss_chunks)

    def value_and_grad(self, w: torch.Tensor):
        """The loss and its flat gradient at ``w``, chunk by chunk."""
        wv = w.detach().clone().requires_grad_(True)
        grad = torch.zeros_like(w)
        value = 0.0
        parts = [lambda t, x=x, y=y: self._data_loss(t, x, y)
                 / len(self.loss_chunks) for x, y in self.loss_chunks]
        if self.reg is not None:
            parts.append(self.reg)
        for part in parts:
            out = part(self.flat.tree(wv))
            grad += torch.autograd.grad(out, wv)[0]
            value += float(out.detach())
        return value, grad

    def ggn(self, w: torch.Tensor):
        """The undamped Gauss-Newton matvec at ``w`` on flat vectors."""
        tree = self.flat.tree(w)
        parts = [
            hf.ggn_matvec(
                lambda p, x=x: self.ref.outputs(p, x, self.model),
                lambda out, u, y=y: self.ref.outer_hvp(out, y, u),
                tree, self.flat)
            for x, y in self.curvature_chunks
        ]

        def mv(v):
            return sum(p(v) for p in parts) / len(parts)

        return mv

    def diag(self, w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             block: int = 64) -> torch.Tensor:
        """The empirical-Fisher diagonal of the rows ``x``, ``y`` at ``w``:
        per-sample gradients in blocks of ``block`` samples."""
        tree = self.flat.tree(w)

        def one(p, xi, yi):
            loss = self._data_loss(p, xi[None], yi[None])
            return loss if self.reg is None else loss + self.reg(p)

        per_sample = torch.func.vmap(torch.func.grad(one),
                                     in_dims=(None, 0, 0))
        total = torch.zeros_like(w)
        for i in range(0, x.shape[0], block):
            g = per_sample(tree, x[i:i + block], y[i:i + block])
            total += torch.cat([t.reshape(t.shape[0], -1) for _, t in
                                leaves(g)], dim=1).pow(2).sum(0)
        return total / x.shape[0]

