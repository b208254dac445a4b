"""The port's collectives in one place. Every reduction, gather and scatter
across processes goes through a :class:`Group`, over the default process
group's backend (NCCL on the card, gloo on the CPU or when ranks share a
card), which takes each of them on the tensors' own device: gloo takes
them on CUDA tensors too. :data:`BACKEND_TABLE` lists every collective
the port makes, the three Megatron operators of tensor parallelism, the
ring shift of sequence parallelism and the pipeline's hand-off and return
included, and :func:`probe_backend` asks the backend for each
(``chip_smoke.py``'s phases 21-24 print the answers and fail if it refuses
one), so nothing is swapped or staged behind the caller's back.

Tensor parallelism (``mesh.tp``) uses three autograd operators over the
``tp`` group, Megatron's f, g and gather:

  * :func:`copy_to_tp`: identity forward, all-reduce backward (the input
    of a column-parallel product, and a replicated leaf that a rank uses
    a slice of, so that its gradient is summed over the group once);
  * :func:`reduce_from_tp`: all-reduce forward, identity backward (the
    partial sums of a row-parallel product);
  * :func:`gather_from_tp`: all-gather forward, slice backward (the
    vocab-sharded logits, and a tp-sharded leaf gathered where it is used:
    every rank of the group computes the same gradient of the whole leaf,
    so each keeps its own slice of it).

Sequence parallelism (``mesh.sp``) holds one contiguous chunk of a
sequence on each rank of the ``sp`` group inside a block stack
(``models/``), with three autograd operators and the ring's shift:

  * :func:`scatter_to_sp`: this rank's chunk of a tensor every rank holds
    whole; the backward puts the chunk's gradient at its place in a
    zero tensor of the whole's shape, without communication;
  * :func:`gather_from_sp`: every rank's chunk, concatenated; the backward
    reduce-scatters the gradient over the group;
  * :func:`ring_shift` (``Group.shift``): each rank's tensor to the next
    rank, the previous rank's received; the backward is the reverse shift
    (``ppermute``'s transpose). Ring attention (``ops/ring_attention.py``)
    rotates K and V, and in its backward their gradients, with
    ``Group.shift`` itself.

Under these rules every gradient that leaves the sharded stack is a
partial sum: a replicated tensor upstream of :func:`scatter_to_sp` gets
only its own chunk's share on each rank, and the shares of the ranks sum
to the whole (so does the loss, each rank's chunk of label positions,
``models/avsr.py::forward``). Every gradient, whether its leaf is used
inside the stack or only on replicated tensors, is then summed over the
sp group once (``train/step.py::reduce_grads``, over the mesh's ``sums``
group), and none is counted ``sp`` times. Over NCCL, and over gloo on CPU
tensors, a shift is one ``batch_isend_irecv`` of send/receive pairs
(every rank makes the same calls in the same order: in the forward,
remat's recompute and the backward); gloo on CUDA tensors takes it as an
all-gather (:data:`BACKEND_TABLE`, :func:`shift_route`).

Mixture of experts across processes (``ops/moe.py``) routes each rank's
tokens as a piece of the global batch: one all-gather of integer choice
counts gives the slot offsets, and :func:`sum_over` sums the balance and
z losses' sums over the routing group with a gradient summed over it too
(``psum``'s transpose), so that every rank gets its tokens' whole share.
Expert parallelism (``mesh.ep``) splits the stacked experts over the ep
group with two operators, the dense exchange:

  * :func:`scatter_to_experts`: each rank's partial [E, C, d] slot tensor
    summed over the group, every rank keeping its E / ep experts' slots
    (a reduce-scatter); the backward all-gathers;
  * :func:`gather_from_experts`: the owners' [E / ep, C, d'] outputs
    gathered to [E, C, d'] on every rank; the backward reduce-scatters.

Pipeline parallelism (``mesh.pp``, ``ops/pipeline.py``) hands each
microbatch's activations to the next stage with ``Group.shift`` and
returns the last stage's output to every stage with an all-reduce; its
own autograd Function runs the reverse schedule (the gradients shifted
back, the return's gradient all-reduced), so it needs no operator here.

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

    def shift(self, ts: list[torch.Tensor], offset: int = 1) -> list[torch.Tensor]:
        """Each of ``ts`` sent to group rank ``rank + offset`` (mod size);
        returns the tensors of group rank ``rank - offset``, in one batch
        of sends and receives (:func:`shift_route`)."""
        n = self.size
        if n == 1 or offset % n == 0:
            return list(ts)
        xs = [t.detach().contiguous() for t in ts]
        src = (self.rank - offset) % n
        if shift_route(xs[0].device, self.pg) == "all_gather":
            return [self.all_gather(x.reshape(1, -1)).reshape(n, *x.shape)[src].clone()
                    for x in xs]
        outs = [torch.empty_like(x) for x in xs]
        dst, peer = self.ranks[(self.rank + offset) % n], self.ranks[src]
        ops = []
        for x, out in zip(xs, outs):
            ops += [dist.P2POp(dist.isend, x, dst, self.pg),
                    dist.P2POp(dist.irecv, out, peer, self.pg)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    def all_gather_object(self, obj: Any) -> list[Any]:
        """Every rank's picklable ``obj``, in rank order."""
        if self.size == 1:
            return [obj]
        out: list[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.pg)
        return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.all_reduce(grad.contiguous().clone()), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, dim: int) -> torch.Tensor:
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = ctx.group
        return grad.chunk(g.size, dim=ctx.dim)[g.rank].contiguous(), None, None


class _ScatterToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, dim: int) -> torch.Tensor:
        ctx.group, ctx.dim, ctx.shape = group, dim, x.shape
        return x.chunk(group.size, dim=dim)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = ctx.group
        out = grad.new_zeros(ctx.shape)
        out.narrow(ctx.dim, g.rank * grad.shape[ctx.dim], grad.shape[ctx.dim]).copy_(grad)
        return out, None, None


class _GatherFromSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, dim: int) -> torch.Tensor:
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.reduce_scatter(grad.contiguous(), ctx.dim), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, offset: int) -> torch.Tensor:
        ctx.group, ctx.offset = group, offset
        return group.shift([x], offset)[0]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.shift([grad.contiguous()], -ctx.offset)[0], None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.all_reduce(grad.contiguous().clone()), None


class _ScatterToExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return group.reduce_scatter(x.contiguous(), 0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.all_gather(grad.contiguous(), 0), None


def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over ``group`` (None: ``x``)."""
    if group is None or group.size == 1 or not _grad_path(x):
        return x
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the gradient passes through as it is."""
    if group is None or group.size == 1:
        return x
    if _grad_path(x):
        return _ReduceFromTP.apply(x, group)
    return group.all_reduce(x.contiguous())


def gather_from_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; the gradient of the
    whole is sliced back to this rank's part."""
    if group is None or group.size == 1:
        return x
    dim = dim % x.ndim
    if _grad_path(x):
        return _GatherFromTP.apply(x, group, dim)
    return group.all_gather(x, dim)


def scatter_to_sp(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``x``, which every rank of the
    sp ``group`` holds whole; its gradient is this rank's share of the
    whole's (see the module docstring). None: ``x``."""
    if group is None or group.size == 1:
        return x
    dim = dim % x.ndim
    if _grad_path(x):
        return _ScatterToSP.apply(x, group, dim)
    return x.chunk(group.size, dim=dim)[group.rank].contiguous()


def gather_from_sp(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's chunk along ``dim``, concatenated in rank order; the
    gradient of the whole is reduce-scattered back (the ranks' partial
    sums of it, summed)."""
    if group is None or group.size == 1:
        return x
    dim = dim % x.ndim
    if _grad_path(x):
        return _GatherFromSP.apply(x, group, dim)
    return group.all_gather(x, dim)


def ring_shift(x: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """The ``x`` of group rank ``rank - offset``, ``x`` sent to ``rank +
    offset``; the gradient travels the reverse way."""
    if group is None or group.size == 1:
        return x
    if _grad_path(x):
        return _RingShift.apply(x, group, offset)
    return group.shift([x], offset)[0]


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (None: ``x``); its gradient is summed
    over the group too, so a value that every rank computes from the sum
    passes each rank the gradient of its own part."""
    if group is None or group.size == 1:
        return x
    if _grad_path(x):
        return _SumOver.apply(x, group)
    return group.all_reduce(x.contiguous().clone())


def scatter_to_experts(x: torch.Tensor, group) -> torch.Tensor:
    """[E, C, d] -> this rank's [E / size, C, d], summed over the ep
    ``group`` (None: ``x``); the gradient is gathered back."""
    if group is None or group.size == 1:
        return x
    if _grad_path(x):
        return _ScatterToExperts.apply(x, group)
    return group.reduce_scatter(x.contiguous(), 0)


def gather_from_experts(y: torch.Tensor, group) -> torch.Tensor:
    """Every rank's [E / size, C, d'] -> [E, C, d'] over the ep ``group``;
    the gradient is reduce-scattered back (the ranks' combines summed)."""
    return gather_from_sp(y, group, 0)


# How gloo moves a shift of CUDA tensors: its send and receive read the
# tensor's memory from the host ("writev ... Bad address" with torch 2.11
# on an H100's host), so there a shift is an all-gather, which gloo takes
# on CUDA tensors (through its own host copies), and each rank keeps its
# source's part.
GLOO_CUDA_SHIFT = "all_gather"


def shift_route(device: torch.device, pg: Any = None) -> str:
    """"p2p" (send/receive pairs) or "all_gather": how :meth:`Group.shift`
    moves tensors on ``device`` over the process group ``pg``."""
    if device.type == "cuda" and dist.get_backend(pg) == "gloo":
        return GLOO_CUDA_SHIFT
    return "p2p"


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


# Every collective the port makes, as (the call on the default group, the
# dtypes it moves): the data axes' reductions, gathers and reduce-scatters,
# tensor parallelism's three operators, forward and backward, sequence
# parallelism's ring shift (send/receive pairs; an all-gather on gloo's
# CUDA tensors, ``shift_route``) and its two operators, and the pipeline's
# hand-off (the same shift) and return (an all-reduce), and mixture of
# experts' routing sums (float64) and slot counts (int64) and the ep
# exchange (a reduce-scatter and an all-gather of [E, C, d]).
BACKEND_TABLE: dict[str, tuple[str, tuple[str, ...]]] = {
    "all_reduce_sum": ("all_reduce sum: gradients, metrics, reduce_from_tp forward, "
                       "copy_to_tp backward, the pipeline's return and its gradient, "
                       "sum_over forward and backward (MoE's loss sums, float64)",
                       ("float32", "bfloat16", "float64")),
    "all_reduce_max": ("all_reduce max: decisions every rank takes", ("float32",)),
    "all_reduce_min": ("all_reduce min: the batch-size probe", ("float32",)),
    "broadcast": ("broadcast: rank 0's checkpoint decision", ("float32",)),
    "all_gather": ("all_gather: fsdp, tp and ep gathers, gather_from_tp forward, "
                   "gather_from_experts forward, scatter_to_experts backward, MoE's "
                   "slot counts (int64)",
                   ("float32", "bfloat16", "int8", "uint8", "int64")),
    "reduce_scatter": ("reduce_scatter: the fsdp gather's backward, gather_from_sp "
                       "backward, scatter_to_experts forward, gather_from_experts "
                       "backward", ("float32", "bfloat16")),
    "shift": ("send to the next rank, receive from the previous: the ring's K/V and "
              "their gradients, ring_shift forward and backward, the pipeline's "
              "hand-offs and their gradients", ("float32", "bfloat16")),
}


def probe_backend(device: str | torch.device) -> dict[str, str]:
    """Whether the default process group's backend takes each collective
    of :data:`BACKEND_TABLE` on tensors of each of its dtypes on
    ``device`` ("yes", or the error), through :class:`Group` and the tp
    operators as the port calls them. Every rank makes the same calls in
    order."""
    world = make_groups([list(range(dist.get_world_size()))])
    n = world.size
    out: dict[str, str] = {}

    def x(dtype: str, k: int = 4) -> torch.Tensor:
        return torch.ones(k * n, device=device).to(getattr(torch, dtype))

    calls: dict[str, Any] = {}
    for name, (_, dtypes) in BACKEND_TABLE.items():
        for dt in dtypes:
            if name.startswith("all_reduce"):
                op = name.rsplit("_", 1)[1]
                calls[f"{name}_{dt}"] = lambda dt=dt, op=op: world.all_reduce(x(dt), op)
            elif name == "broadcast":
                calls[f"{name}_{dt}"] = lambda dt=dt: world.broadcast(x(dt))
            elif name == "all_gather":
                calls[f"{name}_{dt}"] = lambda dt=dt: world.all_gather(x(dt))
            elif name == "shift":
                calls[f"{name}_{dt}"] = lambda dt=dt: shift_check(dt)
            else:
                calls[f"{name}_{dt}"] = lambda dt=dt: world.reduce_scatter(x(dt))

    def shift_check(dt: str) -> None:
        mine = x(dt) * world.rank
        back = world.shift(world.shift([mine, mine + 1])[:1], -1)[0]
        got = world.shift([mine])[0]
        if not (torch.equal(back, mine) and bool((got == (world.rank - 1) % n).all())):
            raise ValueError("a shift moved the wrong values")

    def ring_operators(dt: str) -> None:
        a = x(dt).requires_grad_(True)
        y = gather_from_sp(ring_shift(scatter_to_sp(a, world, 0) * 2, world), world, 0)
        y.sum().backward()

    def megatron(dt: str) -> None:
        a = x(dt).requires_grad_(True)
        y = gather_from_tp(reduce_from_tp(copy_to_tp(a, world) * 2, world), world)
        y.sum().backward()

    def pipeline(dt: str) -> None:
        from avsr_tpu_torch.ops.pipeline import pipeline_apply

        w = [torch.full((1,), 2.0, device=device, dtype=getattr(torch, dt), requires_grad=True)
             for _ in range(n)]
        y = pipeline_apply(lambda ws, xb: xb * ws[0], w, x(dt).reshape(n, -1), group=world)
        y.float().sum().backward()
        if not torch.equal(y, x(dt).reshape(n, -1) * 2 ** n):
            raise ValueError("the pipeline returned the wrong values")

    def experts(dt: str) -> None:
        a = x(dt).reshape(n, 4, 1).requires_grad_(True)
        y = gather_from_experts(scatter_to_experts(a, world) * 2, world)
        (y.float().sum() + sum_over(a.float().sum().reshape(1), world).sum()).backward()
        if not torch.equal(y, a.detach() * 2 * n):
            raise ValueError("the expert exchange returned the wrong values")

    for dt in ("float32", "bfloat16"):
        calls[f"ep_operators_{dt}"] = lambda dt=dt: experts(dt)
        calls[f"tp_operators_{dt}"] = lambda dt=dt: megatron(dt)
        calls[f"sp_operators_{dt}"] = lambda dt=dt: ring_operators(dt)
        calls[f"pp_operators_{dt}"] = lambda dt=dt: pipeline(dt)
    for name, call in calls.items():
        try:
            call()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            out[name] = "yes"
        except Exception as e:  # noqa: BLE001 — reported; the caller fails on it
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


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

    def shift(self, ts: list[torch.Tensor], offset: int = 1) -> list[torch.Tensor]:
        del offset
        return [t.detach().clone() for t in ts] if self.size > 1 else list(ts)
