"""This rank's view of the parameter tree inside a sharded step, and the
all-to-all that moves entries between it and the flat CG space (used by
:mod:`.sharded`).

The flat CG space stays :class:`~..utils.flatten.TrainableRavel`'s, split in
contiguous blocks over the model axis: rank ``o`` owns entries ``[o n / M,
(o + 1) n / M)`` (:class:`~.sharded.ModelShard`), the layout in which the
warm start, the preconditioner diagonal and the iterate grid are compared
with the JAX package.  The forward, though, needs a different cut: each leaf
that it splits over the tensor or the expert axis is read at this rank's
block (``(dim, starts, length)``: the ranges ``[s, s + length)`` of
dimension ``dim``, one per start, joined in order; for the fused ``qkv``
three strided column ranges), and every other leaf whole.
:class:`LocalLayout` holds that cut for every rank of the axis and maps
this rank's flat block to its local tree and back with one all-to-all
(:func:`~.collectives.all_to_all`):

- **flat to tree** (:meth:`LocalLayout.unravel`): each owner sends each
  rank the entries of its block that the rank computes with; a whole leaf
  goes to every rank;
- **tree to flat** (:meth:`LocalLayout.ravel`): each flat entry goes to its
  owner.  In one replicated program (Megatron tensor parallelism, the
  MLP's column-parallel layers, expert parallelism without a sequence
  split) a whole leaf's value is alike on every rank, so its owner keeps
  its own copy and only a block's entries travel, from the rank that
  computes them; in the joined program (context parallelism) every rank's
  value is its share, and ``combine`` adds every rank's entries at the
  owner, a reduce-scatter of the rank's part.

Every transfer is a list of copies between a rectangle of the owner's flat
block and one of the rank's local buffer (the local leaves laid end to end,
each row-major), computed once per layout as slices, not as ``n``-long
index tensors; adjacent copies are merged.  The copies run outside every
transform, on vectors with any leading axes (a batched sweep's ``[k, n /
M]`` rows at once).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..utils.flatten import TrainableRavel, tree_flatten, tree_unflatten
from . import collectives

Block = Tuple[int, Tuple[int, ...], int]  # (dim, starts, length)


def _grid(shape, block: Block):
    """``(P, D, I)``: the rows before ``dim``, ``dim``'s size and the
    entries after it, of a leaf of ``shape`` read at ``block``."""
    dim = block[0]
    if not shape:
        return 1, 1, 1
    return (math.prod(shape[:dim]), shape[dim], math.prod(shape[dim + 1:]))


def _whole_block(shape) -> Block:
    return (0, (0,), shape[0] if shape else 1)


def _local_shape(shape, block: Optional[Block]):
    if block is None:
        return tuple(shape)
    dim, starts, length = block
    return tuple(shape[:dim]) + (len(starts) * length,) + tuple(
        shape[dim + 1:])


def narrow_block(t: torch.Tensor, block: Block, dim_offset: int = 0):
    """The entries of ``t`` at ``block`` (its dimension counted past
    ``dim_offset`` leading ones), joined in the block's order."""
    dim, starts, length = block
    pieces = [t.narrow(dim + dim_offset, s, length) for s in starts]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces,
                                                        dim + dim_offset)


def _segments(a: int, b: int, R: int):
    """Rows of width ``R`` covering the leaf-local flat range ``[a, b)``:
    ``(first row, rows, first column, end column)``, a partial first row,
    the full rows, a partial last row."""
    first, last = a // R, (b - 1) // R
    if first == last:
        return [(first, 1, a - first * R, b - first * R)]
    segs, body0, body1, tail = [], first, last + 1, None
    if a % R:
        segs.append((first, 1, a % R, R))
        body0 = first + 1
    if b % R:
        tail = (last, 1, 0, b - last * R)
        body1 = last
    if body1 > body0:
        segs.append((body0, body1 - body0, 0, R))
    if tail is not None:
        segs.append(tail)
    return segs


class _Ops:
    """The copies between an owner's flat block and a rank's local buffer,
    in one order that both sides follow: ``("1", flat start, local start,
    count)`` for a contiguous run on both sides, ``("2", flat start, rows,
    row width, first column, end column, local start, local row width,
    local first column)`` for a rectangle."""

    def __init__(self):
        self.ops: list = []
        self.size = 0

    def add(self, f0, nrows, R, c0, c1, l0, Rl, lc0):
        self.size += nrows * (c1 - c0)
        if nrows == 1 or (c0 == 0 and c1 == R == Rl):
            fs, ls = (f0 + c0, l0 + lc0) if nrows == 1 else (f0, l0)
            n = nrows * (c1 - c0)
            last = self.ops[-1] if self.ops else None
            if last and last[0] == "1" and last[1] + last[3] == fs \
                    and last[2] + last[3] == ls:
                self.ops[-1] = ("1", last[1], last[2], last[3] + n)
            else:
                self.ops.append(("1", fs, ls, n))
        else:
            self.ops.append(("2", f0, nrows, R, c0, c1, l0, Rl, lc0))


def _flat_view(v: torch.Tensor, op):
    if op[0] == "1":
        return v[..., op[1]:op[1] + op[3]]
    _, f0, nrows, R, c0, c1 = op[:6]
    return v[..., f0:f0 + nrows * R].unflatten(-1, (nrows, R))[..., c0:c1]


def _local_view(buf: torch.Tensor, op):
    if op[0] == "1":
        return buf[..., op[2]:op[2] + op[3]]
    _, _, nrows, _, c0, c1, l0, Rl, lc0 = op
    return buf[..., l0:l0 + nrows * Rl].unflatten(-1, (nrows, Rl))[
        ..., lc0:lc0 + c1 - c0]


def _pack(t, ops, view, lead):
    if not ops:
        return t.new_empty(0)
    parts = [view(t, op).reshape(*lead, -1) for op in ops]
    return (parts[0] if len(parts) == 1 else torch.cat(parts, -1)).reshape(-1)


def _unpack(chunk, ops, t, view, lead, add=False):
    k = math.prod(lead)
    at = 0
    chunk = chunk.reshape(k, -1) if ops else chunk
    for op in ops:
        dst = view(t, op)
        n = dst[(0,) * len(lead)].numel() if lead else dst.numel()
        src = chunk[:, at:at + n].reshape(dst.shape)
        if add:
            dst.add_(src)
        else:
            dst.copy_(src)
        at += n


class LocalLayout:
    """This rank's local parameter tree in a sharded step (module
    docstring).  ``blocks[r]`` maps a leaf index (``tree_flatten``'s order)
    to rank ``r``'s block of it; a leaf absent there is whole on rank
    ``r``.  A split leaf's blocks tile it: the same ``dim`` and ``length``
    on every rank, the starts of all ranks covering ``dim`` once.

    ``dim``, ``dtype`` and ``device`` are the flat space's; ``block`` is
    this rank's ``n / M`` entries; ``shapes`` the local leaves' shapes."""

    def __init__(self, ravel: TrainableRavel, axis: collectives.Axis,
                 blocks: List[Dict[int, Block]]):
        self.base, self.axis = ravel, axis
        self.dim, self.dtype, self.device = ravel.dim, ravel.dtype, \
            ravel.device
        M, me = axis.size, axis.rank
        self.block = ravel.dim // M
        self.blocks = blocks[me]
        self.all_blocks = blocks
        self.split = frozenset(i for b in blocks for i in b)
        whole = ravel._shapes
        for i in self.split:
            self._check_tiling(i, whole[i], [b.get(i) for b in blocks])
        # per split leaf, every rank's starts in rank order: a gather's
        self._starts = {i: [s for b in blocks for s in b[i][1]]
                        for i in self.split}
        self.shapes = [_local_shape(s, self.blocks.get(i))
                       for i, s in enumerate(whole)]
        train = [i for i, m in enumerate(ravel._mask) if m]
        self._train = train
        # each rank's local buffer: its trainable local leaves end to end
        offsets, self._sizes = [], []
        for r in range(M):
            at, offs = 0, {}
            for i in train:
                offs[i] = at
                at += math.prod(_local_shape(whole[i], blocks[r].get(i)))
            offsets.append(offs)
            self._sizes.append(at)
        self._offsets = offsets[me]
        # ops[kind][(owner, rank)]: kind "split" for the leaves some rank
        # holds as blocks, "whole" for the others
        self._ops = {kind: {(o, r): _Ops() for o in range(M)
                            for r in range(M)}
                     for kind in ("split", "whole")}
        for i in train:
            kind = "split" if i in self.split else "whole"
            for r in range(M):
                self._leaf_ops(i, r, blocks[r].get(i), offsets[r][i], kind)
        # whether a transfer moves anything between ranks (a replicated
        # program's ravel of whole leaves does not): the same on every
        # rank, so all skip its all-to-all together
        self._moves = {own: any(self._count(o, r, own) for o in range(M)
                                for r in range(M) if o != r)
                       for own in (False, True)}

    @staticmethod
    def _check_tiling(i, shape, per_rank):
        if any(b is None for b in per_rank):
            raise ValueError(f"leaf {i} is split on some ranks only")
        dims = {b[0] for b in per_rank}
        lengths = {b[2] for b in per_rank}
        starts = sorted(s for b in per_rank for s in b[1])
        (dim,), (length,) = dims, lengths
        if starts != list(range(0, shape[dim], length)):
            raise ValueError(
                f"leaf {i}: the ranks' blocks {per_rank} do not tile "
                f"dimension {dim} of {tuple(shape)}")

    def _leaf_ops(self, i, r, block, l_off, kind):
        shape = self.base._shapes[i]
        block = block or _whole_block(shape)
        dim, starts, length = block
        P, D, I = _grid(shape, block)
        R, Rl = D * I, len(starts) * length * I
        off = self.base._offsets[i]
        B = self.block
        for o in range(self.axis.size):
            a, b = max(off, o * B), min(off + P * R, (o + 1) * B)
            if a >= b:
                continue
            ops = self._ops[kind][(o, r)]
            for p0, nrows, c0, c1 in _segments(a - off, b - off, R):
                for j, s in enumerate(starts):
                    g0, g1 = max(c0, s * I), min(c1, (s + length) * I)
                    if g0 < g1:
                        ops.add(off + p0 * R - o * B, nrows, R, g0, g1,
                                l_off + p0 * Rl, Rl,
                                j * length * I + g0 - s * I)

    def _pairs(self, owner, rank, own):
        """The copies between ``owner``'s block and ``rank``'s buffer;
        with ``own``, a whole leaf's only where the owner is the rank."""
        ops = list(self._ops["split"][(owner, rank)].ops)
        if not own or owner == rank:
            ops += self._ops["whole"][(owner, rank)].ops
        return ops

    def _count(self, owner, rank, own):
        n = self._ops["split"][(owner, rank)].size
        if not own or owner == rank:
            n += self._ops["whole"][(owner, rank)].size
        return n

    # -- flat -> tree ---------------------------------------------------

    def _buffer(self, vec: torch.Tensor) -> torch.Tensor:
        """This rank's local buffer from its flat block(s) ``[..., n / M]``
        (one all-to-all)."""
        M, me = self.axis.size, self.axis.rank
        lead = tuple(vec.shape[:-1])
        k = math.prod(lead)
        chunks = [vec.new_empty(0) if r == me
                  else _pack(vec, self._pairs(me, r, False), _flat_view,
                             lead) for r in range(M)]
        counts = [k * self._count(o, me, False) for o in range(M)]
        got = collectives.all_to_all(chunks, counts, self.axis) \
            if self._moves[False] else chunks
        buf = vec.new_empty(*lead, self._sizes[me])
        for o in range(M):
            ops = self._pairs(o, me, False)
            if o == me:
                for op in ops:
                    _local_view(buf, op).copy_(_flat_view(vec, op))
            else:
                _unpack(got[o], ops, buf, _local_view, lead)
        return buf

    def unravel(self, vec: torch.Tensor):
        """The local tree of the flat block ``vec`` ``[..., n / M]`` (its
        leading axes kept), frozen leaves zero: a tangent tree."""
        buf = self._buffer(vec)
        lead = tuple(vec.shape[:-1])
        out = []
        for i, (shape, dtype) in enumerate(zip(self.shapes,
                                               self.base._dtypes)):
            if i in self._offsets:
                at = self._offsets[i]
                out.append(buf[..., at:at + math.prod(shape)].reshape(
                    *lead, *shape).to(dtype))
            else:
                out.append(torch.zeros(*lead, *shape, dtype=dtype,
                                       device=vec.device))
        return tree_unflatten(self.base._treedef, out)

    def add(self, params, vec: torch.Tensor):
        """``params + unravel(vec)`` on the local tree ``params``."""
        leaves, treedef = tree_flatten(params)
        return tree_unflatten(treedef, [
            leaf + d if m else leaf for leaf, d, m in
            zip(leaves, tree_flatten(self.unravel(vec))[0],
                self.base._mask)])

    def add_rows(self, params, rows: torch.Tensor):
        """One local tree per row of ``rows`` ``[k, n / M]``, stacked along
        a leading axis (frozen leaves repeated): the points that a batched
        sweep evaluates under one ``vmap``."""
        k = rows.shape[0]
        delta = tree_flatten(self.unravel(rows))[0]
        leaves, treedef = tree_flatten(params)
        return tree_unflatten(treedef, [
            leaf + d if m else leaf.expand(k, *leaf.shape)
            for leaf, d, m in zip(leaves, delta, self.base._mask)])

    # -- tree -> flat ---------------------------------------------------

    def ravel(self, tree, combine: bool = False) -> torch.Tensor:
        """This rank's flat block ``[..., n / M]`` of the local ``tree``
        (leaves with any leading axes, the same on every leaf).  By
        default the tree is one replicated value, so a whole leaf's owner
        keeps its own copy (module docstring); with ``combine`` every
        rank's tree is its share, summed at the owner."""
        M, me = self.axis.size, self.axis.rank
        own = not combine
        leaves = tree_flatten(tree)[0]
        first = self._train[0]
        lead = tuple(leaves[first].shape[:leaves[first].dim()
                                          - len(self.shapes[first])])
        k = math.prod(lead)
        parts = [leaves[i].reshape(*lead, -1).to(self.dtype)
                 for i in self._train]
        buf = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
        chunks = [buf.new_empty(0) if o == me
                  else _pack(buf, self._pairs(o, me, own), _local_view, lead)
                  for o in range(M)]
        counts = [k * self._count(me, r, own) for r in range(M)]
        got = collectives.all_to_all(chunks, counts, self.axis) \
            if self._moves[own] else chunks
        out = buf.new_zeros(*lead, self.block)
        for r in range(M):
            ops = self._pairs(me, r, own)
            if r == me:
                for op in ops:
                    view = _flat_view(out, op)
                    src = _local_view(buf, op)
                    view.copy_(src) if own else view.add_(src)
            else:
                _unpack(got[r], ops, out, _flat_view, lead, add=not own)
        return out

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The dot product of two flat vectors from the ranks' blocks
        ``a`` and ``b``: the block's, summed over the axis."""
        return collectives._reduce(torch.dot(a, b), self.axis)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.block, dtype=self.dtype, device=self.device)

    # -- whole leaves ---------------------------------------------------

    def whole(self, tree):
        """The whole tree from the local ``tree`` on every rank: each split
        leaf gathered over the axis
        (:func:`~.collectives.gather_from_axis`, whose backward keeps this
        rank's block of the replicated cotangent) and its blocks put in
        order.  A ``loss_reg``, a function of the whole tree, sees the
        parameters through this."""
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [self.whole_leaf(i, leaf)
                                        for i, leaf in enumerate(leaves)])

    def whole_leaf(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` whole from this rank's block of it (:meth:`whole`);
        leading axes past the leaf's own are kept."""
        block = self.blocks.get(i)
        if block is None:
            return leaf
        dim, _, length = block
        dim += leaf.dim() - len(self.shapes[i])
        g = collectives.gather_from_axis(leaf, self.axis, dim)
        starts = self._starts[i]
        order = sorted(range(len(starts)), key=starts.__getitem__)
        if order == list(range(len(starts))):
            return g
        pieces = torch.split(g, length, dim)
        return torch.cat([pieces[j] for j in order], dim)


def move_blocks(xs, src, dst, axis: collectives.Axis):
    """Each ``xs[i]``, this rank's block of a leaf under ``src[i][r]`` (per
    rank ``r`` of ``axis``, blocks of one ``dim``), as this rank's block
    under ``dst[i][r]``: one all-to-all for all the leaves."""
    M, me = axis.size, axis.rank
    pieces = {}  # (sender, receiver) -> [(leaf, sender at, receiver at, n)]
    for i, (s_blocks, d_blocks) in enumerate(zip(src, dst)):
        for s in range(M):
            dim, s_starts, s_len = s_blocks[s]
            for r in range(M):
                _, d_starts, d_len = d_blocks[r]
                for j, a in enumerate(s_starts):
                    for q, c in enumerate(d_starts):
                        lo, hi = max(a, c), min(a + s_len, c + d_len)
                        if lo < hi:
                            pieces.setdefault((s, r), []).append(
                                (i, j * s_len + lo - a, q * d_len + lo - c,
                                 hi - lo))
    outs = []
    for i, x in enumerate(xs):
        dim, starts, length = dst[i][me]
        shape = list(x.shape)
        shape[dim] = len(starts) * length
        outs.append(x.new_empty(shape))

    def send(r):
        parts = [xs[i].narrow(src[i][me][0], at, n).reshape(-1)
                 for i, at, _, n in pieces.get((me, r), [])]
        return torch.cat(parts) if parts else xs[0].new_empty(0)

    def size(i, n):
        return n * xs[i].numel() // xs[i].shape[src[i][me][0]]

    counts = [sum(size(i, n) for i, _, _, n in pieces.get((s, me), []))
              for s in range(M)]
    got = collectives.all_to_all([send(r) for r in range(M)], counts, axis)
    for s in range(M):
        at = 0
        chunk = got[s]
        for i, _, to, n in pieces.get((s, me), []):
            dim = dst[i][me][0]
            view = outs[i].narrow(dim, to, n)
            view.copy_(chunk[at:at + view.numel()].view(view.shape))
            at += view.numel()
    return outs
