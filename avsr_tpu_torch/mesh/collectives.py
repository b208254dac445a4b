"""The port's collectives in one place. Every reduction, gather and scatter
across processes goes through a :class:`Group`, over the default process
group's backend (NCCL on the card, gloo on the CPU or when ranks share a
card), which takes each of them on the tensors' own device: gloo takes
all four on CUDA tensors too (``chip_smoke.py``'s phase 21 asks the
backend and fails if it refuses one), so nothing is swapped or staged
behind the caller's back.

:class:`EchoGroup` stands in for a group without talking to any other
process: its gathers repeat the local tensor and its reductions return it,
so a step run over it allocates what the real step allocates (the batch-
size probe, ``train/probe.py``) and never waits on a rank that ran out of
memory.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}


def _split(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """[..., n*s, ...] -> [n*s0, ...] with the n chunks along ``dim`` laid
    out one after another (what a reduce-scatter over dim 0 reads)."""
    if dim == 0:
        return t.contiguous()
    return torch.stack(t.chunk(n, dim=dim)).flatten(0, 1)


def _join(buf: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """The inverse of :func:`_split` for a gathered buffer."""
    if dim == 0:
        return buf
    return torch.cat(buf.unflatten(0, (n, -1)).unbind(0), dim=dim)


class Group:
    """The ranks ``ranks`` of the default process group as one group,
    over the process group ``pg`` (None: a group of one, which needs no
    communication). Make groups with :func:`make_groups`."""

    def __init__(self, ranks: list[int], pg: Any = None):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.pg = pg

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group, in place; returns ``t``."""
        if self.size > 1:
            dist.all_reduce(t, op=_REDUCE[op], group=self.pg)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of group rank ``src`` on every rank, in place."""
        if self.size > 1:
            dist.broadcast(t, src=self.ranks[src], group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return t
        x = t.detach().contiguous()
        buf = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(buf, x, group=self.pg)
        return _join(buf, self.size, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's chunk along ``dim`` of ``t`` summed over the group."""
        if self.size == 1:
            return t
        x = _split(t.detach(), self.size, dim)
        out = x.new_empty((x.shape[0] // self.size, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=self.pg)
        return out

    def all_gather_object(self, obj: Any) -> list[Any]:
        """Every rank's picklable ``obj``, in rank order."""
        if self.size == 1:
            return [obj]
        out: list[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.pg)
        return out


def make_groups(rank_lists: list[list[int]]) -> Group:
    """The group of ``rank_lists`` that holds this rank. Creating a process
    group is collective over the world, so every rank passes the same lists
    in the same order."""
    me, mine = dist.get_rank(), None
    world = dist.get_world_size()
    for ranks in rank_lists:
        if len(ranks) == 1:
            pg = None
        elif len(ranks) == world:
            pg = dist.group.WORLD
        else:
            pg = dist.new_group(ranks)
        if me in ranks:
            mine = Group(ranks, pg)
    if mine is None:
        raise ValueError(f"rank {me} is in none of {rank_lists}")
    return mine


class EchoGroup:
    """A group of ``size`` in which this process is rank ``rank``, that
    never communicates (see the module docstring)."""

    def __init__(self, size: int, rank: int):
        self.size, self.rank = size, rank
        self.ranks = list(range(size))

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        del op
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return torch.cat([t.detach()] * self.size, dim=dim) if self.size > 1 else t

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.size == 1:
            return t
        return t.detach().chunk(self.size, dim=dim)[self.rank].contiguous()
