"""The collectives of the parallel port, over ``torch.distributed``, and the
autograd functions built on them.

The JAX package never writes a collective: GSPMD inserts them from the
sharding annotations (``causal_gen_tpu/parallel/mesh.py``). Here each one is
explicit, and each differentiable one has its exact adjoint as its backward:

- ``all_reduce_sum``: an all-reduce (sum) whose backward all-reduces the
  cotangents, so every rank's input takes the sum of every rank's
  cotangent;
- ``all_gather``: the ranks' equal parts concatenated along ``dim`` in rank
  order; its backward sums the cotangents over the ranks and hands each rank
  its own part (a reduce-scatter, written as an all-reduce and a slice:
  gloo has no reduce-scatter);
- ``halo``: ``rows`` rows from each neighbour along ``dim`` (none at the
  image's borders); its backward sends the cotangent of each borrowed row
  back to its owner, who adds it to its own.

So a rank that differentiates its own copy of a loss made with them
differentiates the sum of all ranks' copies: ``mesh.py`` divides each
gradient by the number of copies.

Backends: NCCL moves CUDA tensors and gloo CPU ones. PyTorch's backend
table gives gloo CUDA tensors in ``all_reduce``, ``broadcast`` and
``barrier`` only (PyTorch 2.11's gloo took an all-gather of them too), so
every other gloo collective on a CUDA tensor (all-gather, point-to-point)
is staged through host memory here, and only there: one path for every
version. A failed collective raises: nothing carries on without it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import Tensor


def staged(t: Tensor, group) -> bool:
    """Whether a collective other than all-reduce and broadcast on ``t`` goes
    through host memory: a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_(t: Tensor, group) -> Tensor:
    """In place: the sum of ``t`` over ``group`` (None: a group of one)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: Tensor, src: int, group) -> Tensor:
    """In place: ``t`` of global rank ``src`` on every rank of ``group``."""
    if group is not None:
        dist.broadcast(t, src=src, group=group)
    return t


def gather_parts(t: Tensor, group) -> List[Tensor]:
    """Every rank's ``t`` (all of one shape), in group-rank order."""
    if group is None:
        return [t]
    n = dist.get_world_size(group)
    host = staged(t, group)
    src = (t.cpu() if host else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if host else parts


def exchange(send_prev: Optional[Tensor], send_next: Optional[Tensor], prev: Optional[int],
             next_: Optional[int], group) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """Point-to-point swap with the neighbours along one mesh axis: send
    ``send_prev`` to global rank ``prev`` and ``send_next`` to ``next_``, and
    receive a tensor of the same shape from each; a missing neighbour sends
    and receives nothing."""
    like = send_prev if send_prev is not None else send_next
    if like is None:
        return None, None
    host = staged(like, group)

    def out(t):
        return (t.cpu() if host else t).contiguous()

    ops, recv = [], []
    for send, peer in ((send_prev, prev), (send_next, next_)):
        if peer is None:
            recv.append(None)
            continue
        send = out(send)
        recv.append(torch.empty_like(send))
        ops += [dist.P2POp(dist.isend, send, peer, group),
                dist.P2POp(dist.irecv, recv[-1], peer, group)]
    recv_prev, recv_next = recv
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    back = (lambda t: None if t is None else t.to(like.device)) if host else (lambda t: t)
    return back(recv_prev), back(recv_next)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(t: Tensor, group) -> Tensor:
    """The sum of ``t`` over ``group``, differentiable (see the module
    docstring); ``t`` itself when ``group`` is None."""
    return t if group is None else _AllReduceSum.apply(t, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, t.shape[dim]
        ctx.index = dist.get_rank(group)
        return torch.cat(gather_parts(t, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def all_gather(t: Tensor, dim: int, group) -> Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order,
    differentiable; ``t`` itself when ``group`` is None."""
    return t if group is None else _AllGather.apply(t, dim, group)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, dim, prev, next_, group):
        ctx.rows, ctx.dim, ctx.prev, ctx.next, ctx.group = rows, dim, prev, next_, group
        n = x.shape[dim]
        top = x.narrow(dim, 0, rows) if prev is not None else None
        bottom = x.narrow(dim, n - rows, rows) if next_ is not None else None
        from_prev, from_next = exchange(top, bottom, prev, next_, group)
        return torch.cat([t for t in (from_prev, x, from_next) if t is not None], dim=dim)

    @staticmethod
    def backward(ctx, g):
        rows, dim = ctx.rows, ctx.dim
        lo = rows if ctx.prev is not None else 0
        hi = g.shape[dim] - (rows if ctx.next is not None else 0)
        g_prev = g.narrow(dim, 0, rows) if ctx.prev is not None else None
        g_next = g.narrow(dim, hi, rows) if ctx.next is not None else None
        gx = g.narrow(dim, lo, hi - lo).contiguous().clone()
        from_prev, from_next = exchange(g_prev, g_next, ctx.prev, ctx.next, ctx.group)
        if from_prev is not None:
            gx.narrow(dim, 0, rows).add_(from_prev)
        if from_next is not None:
            gx.narrow(dim, gx.shape[dim] - rows, rows).add_(from_next)
        return gx, None, None, None, None, None


def halo(x: Tensor, rows: int, dim: int, prev: Optional[int], next_: Optional[int],
         group) -> Tensor:
    """``x`` with ``rows`` rows of its neighbours along ``dim`` on each side
    (global ranks ``prev`` and ``next_``; None at a border, where nothing is
    added), differentiable."""
    if prev is None and next_ is None:
        return x
    return _Halo.apply(x, rows, dim, prev, next_, group)


def flat_all_reduce_(tensors: Sequence[Tensor], group) -> None:
    """In place: each of ``tensors`` summed over ``group``, in one collective
    per dtype and device."""
    if group is None or not tensors:
        return
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group)
        i = 0
        for t in ts:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
