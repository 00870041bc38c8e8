"""Collectives with gradients, written out where the JAX package has
``shard_map`` and GSPMD.

JAX inserts the collectives of a sharded program itself; here each one is
explicit, over a process group, and where a collective needs a gradient it
is a ``torch.autograd.Function``:

* :func:`all_gather`: concatenation of every rank's rows along dim 0.  Its
  backward all-reduces the gathered gradient and keeps this rank's slice,
  which every backend that has ``all_reduce`` runs (gloo has no
  reduce-scatter on every device).
* :func:`ring_shift`: ``ppermute`` over the ring ``i -> i + 1``: this rank
  sends to ``i + 1`` and receives from ``i - 1``; the backward sends the
  gradient the other way.
* Megatron's pair: :func:`copy_to_model` (identity forward, all-reduce
  backward), at the input of a column-parallel product, and
  :func:`reduce_from_model` (all-reduce forward, identity backward), at the
  output of a row-parallel one.  The pipeline takes the same pair on its
  ``pipe`` group: the stages' input (its gradient is stage 0's, summed over
  the stages) and the masked sum of the last stage's output (each stage's
  cotangent passes through once, the mask keeps the last stage's).
* Megatron-SP's pairs over the sequence axis (dim 1 of ``[B, T, W]``) on
  the ``model`` group: :func:`gather_seq` (all-gather forward,
  reduce-scatter backward) and :func:`scatter_seq_sum` (reduce-scatter
  forward, all-gather backward) around a block's products;
  :func:`split_seq` (this rank's rows forward, all-gather backward) and
  :func:`join_seq` (all-gather forward, this rank's rows backward) where
  the tower enters and leaves the sequence-parallel layout.
* FSDP's just-in-time gather, :func:`fsdp_gather`: a weight all-gathered
  over ``data`` along its cut dimension, its gradient reduce-scattered back,
  which is the data-parallel sum of that leaf's gradient.
  :class:`FullySharded` carries which leaves are cut and gathers a block's
  at its use (``models/layers.py``).

A reduce-scatter is ``reduce_scatter_tensor`` on NCCL and an all-reduce
then this rank's part on another backend (gloo has no reduce-scatter on
every device).

Every function takes its group; ``None`` is a one-rank axis with no
process group, where each is the identity.  At world size 1 over a real
group each runs its collective, which then moves nothing.  The package
never stages a collective through host memory.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


def size(group) -> int:
    """The number of ranks of ``group`` (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


def rank_in(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no gradient) and return it."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_max_(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group``, in place (no gradient)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_reduce_many_(tensors, group) -> None:
    """Sum each tensor of ``tensors`` over ``group`` in place, as one flat
    buffer per dtype (one collective, not one per leaf)."""
    if group is None or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        start = 0
        for t in ts:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=0)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.rows = group, t.shape[0]
        return _gather_rows(t, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        i = rank_in(ctx.group)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order (``jax.lax.all_gather(..., tiled=True)``), differentiable."""
    if group is None:
        return t
    return _AllGather.apply(t, group)


def _shift(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``t`` to rank ``i + step`` and receive from ``i - step`` (group ranks)."""
    n, i = size(group), rank_in(group)
    out = torch.empty_like(t)
    dst = dist.get_global_rank(group, (i + step) % n)
    src = dist.get_global_rank(group, (i - step) % n)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t.contiguous(), dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for r in reqs:
        r.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.ppermute`` over the ring ``[(i, i + 1)]``: rank ``i``
    receives rank ``i - 1``'s ``t``; differentiable."""
    if size(group) == 1:
        return t
    return _RingShift.apply(t, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(t.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(t: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward (Megatron's ``f``)."""
    if group is None:
        return t
    return _CopyToModel.apply(t, group)


def reduce_from_model(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward, identity backward (Megatron's ``g``)."""
    if group is None:
        return t
    return _ReduceFromModel.apply(t, group)


def gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank
    order (no gradient)."""
    parts = [torch.empty_like(t) for _ in range(size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def local_part(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's ``1/n`` of ``t`` along ``dim`` (a contiguous copy)."""
    n = size(group)
    if t.shape[dim] % n:
        raise ValueError(f"axis {dim} of size {t.shape[dim]} is not divisible by the group's {n} ranks")
    c = t.shape[dim] // n
    return t.narrow(dim, rank_in(group) * c, c).clone(memory_format=torch.contiguous_format)


def reduce_scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``t`` summed over ``group``, this rank's ``1/n`` along ``dim`` kept (no
    gradient)."""
    n = size(group)
    if t.shape[dim] % n:
        raise ValueError(f"axis {dim} of size {t.shape[dim]} is not divisible by the group's {n} ranks")
    if dist.get_backend(group) == "nccl":
        rows = t.movedim(dim, 0).contiguous()
        out = torch.empty((rows.shape[0] // n, *rows.shape[1:]), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, rows, group=group)
        return out.movedim(0, dim).contiguous()
    return local_part(all_reduce_(t.contiguous().clone(), group), group, dim)


class _Pair(torch.autograd.Function):
    """``fwd(t, group, dim)`` forward, ``bwd(g, group, dim)`` backward."""

    @staticmethod
    def forward(ctx, t, group, dim, fwd, bwd):
        ctx.group, ctx.dim, ctx.bwd = group, dim, bwd
        return fwd(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.contiguous(), ctx.group, ctx.dim), None, None, None, None


def gather_seq(t: torch.Tensor, group) -> torch.Tensor:
    """``[B, T/n, W]`` -> ``[B, T, W]`` over ``group``; the backward
    reduce-scatters (Megatron-SP's gather before a column-parallel product)."""
    return t if group is None else _Pair.apply(t, group, 1, gather_dim, reduce_scatter_dim)


def scatter_seq_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``[B, T, W]`` partials summed over ``group``, this rank's ``T/n``
    rows kept; the backward all-gathers (after a row-parallel product)."""
    return t if group is None else _Pair.apply(t, group, 1, reduce_scatter_dim, gather_dim)


def split_seq(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's ``T/n`` rows of a ``[B, T, W]`` every rank holds; the
    backward all-gathers (the tower entering the sequence-parallel layout)."""
    return t if group is None else _Pair.apply(t, group, 1, local_part, gather_dim)


def join_seq(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows all-gathered over ``group``; the backward keeps this
    rank's rows (the tower leaving the sequence-parallel layout, every rank
    then computing the same loss)."""
    return t if group is None else _Pair.apply(t, group, 1, gather_dim, local_part)


def fsdp_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A weight's ``1/n`` shard all-gathered over ``group`` (``data``) along
    ``dim``; its gradient reduce-scattered back, summed over the group."""
    return t if group is None else _Pair.apply(t, group, dim, gather_dim, reduce_scatter_dim)


@dataclasses.dataclass(frozen=True)
class FullySharded:
    """The FSDP leaves of a rank's tree: ``dims`` maps ``id`` of each local
    leaf cut over ``group`` to the dimension it is cut along."""

    group: Any
    dims: Dict[int, int]

    def gathered(self, tree, skip=()):
        """``tree`` with each cut leaf replaced by its gathered whole
        (:func:`fsdp_gather`), dict keys in ``skip`` kept as they are."""
        if isinstance(tree, dict):
            return {k: v if k in skip else self.gathered(v, skip) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self.gathered(v, skip) for v in tree]
        if torch.is_tensor(tree) and id(tree) in self.dims:
            return fsdp_gather(tree, self.group, self.dims[id(tree)])
        return tree


_FSDP: contextvars.ContextVar = contextvars.ContextVar("tapclip_fsdp", default=None)


@contextlib.contextmanager
def fully_sharded(state: Optional[FullySharded]):
    """Gather the FSDP leaves of the towers' blocks at their use
    (``layers.transformer_forward``) inside the body; ``None``: no FSDP."""
    token = _FSDP.set(state)
    try:
        yield
    finally:
        _FSDP.reset(token)


def current_fsdp() -> Optional[FullySharded]:
    """The state :func:`fully_sharded` set (``None`` outside it)."""
    return _FSDP.get()


def model_group_of(mesh) -> Optional[object]:
    """The ``model`` group a tower's blocks reduce over: ``None`` without a
    mesh or on a one-rank ``model`` axis (the blocks then run as they do
    with no mesh)."""
    if mesh is None or mesh.tp <= 1:
        return None
    return mesh.model_group


_MODEL_GROUP: contextvars.ContextVar = contextvars.ContextVar("tapclip_model_group", default=None)


@contextlib.contextmanager
def tensor_parallel(group):
    """Run the towers' blocks (``layers.transformer_forward``) tensor-parallel
    over ``group`` inside the block (``None``: as with no mesh).  The mesh
    steps set it around their forward; each kernel's autograd Function keeps
    the group for its backward, and a rematerialised block gets it as an
    argument, so the backward needs no context."""
    token = _MODEL_GROUP.set(group)
    try:
        yield
    finally:
        _MODEL_GROUP.reset(token)


def current_model_group():
    """The group :func:`tensor_parallel` set (``None`` outside it)."""
    return _MODEL_GROUP.get()
