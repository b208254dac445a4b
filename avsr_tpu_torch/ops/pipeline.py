"""GPipe pipeline parallelism over a ``pp`` group of processes, the port of
``avsr_tpu/ops/pipeline.py``.

The JAX package stacks the layers [S, L/S, ...] over the ``pp`` mesh axis
and runs one SPMD program: microbatches enter stage 0 one per tick, each
stage's output ``ppermute``s to the next stage every tick, and after
S + M - 1 ticks one ``psum`` over ``pp`` returns the last stage's outputs
to every device; reverse-mode AD derives the backward (the reverse
rotation). The port runs one process per stage. Every rank holds the
whole layer list and runs its stage, the layers of its ``pp`` coordinate
(:func:`stage_layers`, with JAX's ``stack_stages`` message), and
:func:`pipeline_apply` runs JAX's schedule with three differences:

  * the rows are this rank's rows of the global batch (the ranks of a pp
    group hold the same rows), split into the most equal microbatches, up
    to ``microbatches`` (default S), that divide them: fewer than JAX's
    where a rank holds fewer rows or an odd count. JAX's message fires on
    the global batch, as JAX checks it. The stages mix no rows, so the
    split changes no value;
  * a stage computes only on the M ticks where it holds a microbatch (JAX's
    stages also run on their carry at the other S - 1 ticks and mask the
    result out); there it hands its input on untouched, which no stage
    reads. The bubble in time stays JAX's, (S - 1) / (S + M - 1);
  * the backward is this module's autograd Function, which runs the
    reverse schedule by hand: the return's gradient all-reduced over the
    group (``psum``'s transpose), then the ticks in reverse, each computing
    tick's stage backward over the graph it saved and its input's gradient
    shifted to the previous stage. Every rank makes the same collectives
    in the same order, whatever its own leaves need: left to autograd,
    stage 0, which never reads the carry it receives, would not run the
    backward of its shifts, and the group would hang.

A stage's gradient flows to its own layers and, on stage 0, to the
input; the other ranks get None for both, so each gradient that leaves
the pipeline is this rank's part of the group's sum. No kernel of its
own: the stages' blocks launch theirs.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def stage_layers(layers: list, n_stages: int, stage: int) -> list:
    """The consecutive layers of stage ``stage`` of ``n_stages``; JAX's
    message when they do not divide."""
    L = len(layers)
    if L % n_stages != 0:
        raise ValueError(f"{L} layers not divisible by pp={n_stages}")
    per = L // n_stages
    return list(layers[stage * per: (stage + 1) * per])


def split_count(rows: int, global_rows: int, microbatches: int) -> int:
    """The number of equal microbatches of a rank's ``rows``: JAX's check
    of the global batch against ``microbatches``, then the largest count up
    to it that divides ``rows``."""
    if global_rows % microbatches != 0:
        raise ValueError(f"batch {global_rows} not divisible by microbatches {microbatches}")
    return max(m for m in range(1, min(microbatches, rows) + 1) if rows % m == 0)


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class _Schedule:
    """One call's schedule on this rank: ``forward`` runs the ticks (and,
    with ``grad``, keeps each computing tick's graph), ``backward`` the
    reverse ticks over them."""

    def __init__(self, stage_fn: Callable, stage: list, aux: tuple, group, n_micro: int):
        self.stage_fn, self.stage, self.aux = stage_fn, stage, aux
        self.group, self.M = group, n_micro
        self.saved: list[tuple[torch.Tensor, torch.Tensor]] = []

    def _holds(self, t: int) -> bool:
        return 0 <= t - self.group.rank < self.M

    def forward(self, x: torch.Tensor, grad: bool) -> torch.Tensor:
        S, s, M = self.group.size, self.group.rank, self.M
        mb = x.shape[0] // M
        xs = x.split(mb)
        auxs = [a.split(mb) for a in self.aux]
        ticks = S + M - 1
        carry = torch.zeros_like(xs[0])
        outs = []
        for t in range(ticks):
            inp = xs[min(t, M - 1)] if s == 0 else carry
            y = inp                       # an idle tick hands its input on
            if self._holds(t):
                aux_m = [a[t - s] for a in auxs]
                if grad:
                    inp = inp.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = self.stage_fn(self.stage, inp, *aux_m)
                    self.saved.append((inp, y))
                else:
                    y = self.stage_fn(self.stage, inp, *aux_m)
                if y.shape != inp.shape or y.dtype != inp.dtype:
                    raise ValueError(f"a stage returned {tuple(y.shape)} {y.dtype} for its "
                                     f"input's {tuple(inp.shape)} {inp.dtype}")
                if s == S - 1:
                    outs.append(y.detach())
            if t < ticks - 1:
                carry = self.group.shift([y.detach()])[0]
        out = torch.cat(outs) if s == S - 1 else torch.zeros_like(x)
        return self.group.all_reduce(out)

    def backward(self, g_out: torch.Tensor, params: list[torch.Tensor], want_x: bool):
        """(the gradient of x, or None off stage 0 or without ``want_x``; the
        gradients of ``params``, this stage's leaves that need one)."""
        S, s, M = self.group.size, self.group.rank, self.M
        g = self.group.all_reduce(g_out.contiguous().clone())
        mb = g.shape[0] // M
        gs = g.split(mb)
        g_x = torch.zeros_like(g) if s == 0 and want_x else None
        p_grads: list[torch.Tensor | None] = [None] * len(params)
        ticks = S + M - 1
        zeros = torch.zeros_like(gs[0])
        g_send = zeros
        for t in reversed(range(ticks)):
            # the gradient of this tick's output: what the next stage found
            # for the carry it received (the forward's shift, reversed)
            g_y = self.group.shift([g_send], -1)[0] if t < ticks - 1 else zeros
            g_in = g_y
            if self._holds(t):
                if s == S - 1:
                    g_y = g_y + gs[t - s]
                inp, y = self.saved.pop()
                with torch.enable_grad():
                    got = torch.autograd.grad(y, [inp, *params], g_y, allow_unused=True)
                del y
                g_in = got[0] if got[0] is not None else zeros
                for i, gp in enumerate(got[1:]):
                    if gp is not None:
                        p_grads[i] = gp if p_grads[i] is None else p_grads[i] + gp
                if g_x is not None:
                    g_x[(t - s) * mb: (t - s + 1) * mb] += g_in
            # stage 0 never reads the carry it receives: its gradient is zero
            g_send = zeros if s == 0 else g_in
        return g_x, p_grads


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node over x and every layer's leaves
    (the whole stack's, so that whether it needs a backward is the same
    on every rank); gradients reach x on stage 0 and this stage's leaves."""

    @staticmethod
    def forward(ctx, sched: _Schedule, mine: list[int], x: torch.Tensor, *leaves):
        ctx.sched, ctx.mine = sched, mine
        ctx.params = [leaves[i] for i in mine]
        return sched.forward(x, grad=True)

    @staticmethod
    def backward(ctx, g_out: torch.Tensor):
        need = ctx.needs_input_grad
        g_x, p_grads = ctx.sched.backward(g_out, ctx.params, need[2])
        grads: list[torch.Tensor | None] = [None] * (len(need) - 3)
        for i, gp in zip(ctx.mine, p_grads):
            grads[i] = gp
        ctx.sched = ctx.params = None
        return (None, None, g_x, *grads)


def pipeline_apply(stage_fn: Callable, layers: list, x: torch.Tensor, *aux: torch.Tensor,
                   group, microbatches: int | None = None,
                   global_rows: int | None = None) -> torch.Tensor:
    """``x`` [B, ...] (this rank's rows) through the S stages of the
    ``pp`` group ``group``: ``stage_fn(stage, x_mb, *aux_mb) -> y_mb`` runs
    one stage's layers (``stage``, this rank's slice of ``layers``) on one
    microbatch and returns its input's shape and dtype; ``aux`` are
    per-row side inputs [B, ...] (the valid lengths) given to every stage
    with its microbatch. Returns the last stage's output [B, ...] on every
    rank. ``global_rows``: the rows of the global batch that JAX's check
    reads (default B); ``microbatches``: at most this many (default S)."""
    S = group.size
    stage = stage_layers(layers, S, group.rank)
    M = split_count(x.shape[0], global_rows or x.shape[0], microbatches or S)
    sched = _Schedule(stage_fn, stage, aux, group, M)
    leaves = _leaves(layers)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
        per = [len(_leaves(layer)) for layer in layers]
        first = sum(per[: group.rank * len(stage)])
        count = sum(per[group.rank * len(stage): (group.rank + 1) * len(stage)])
        mine = [i for i in range(first, first + count) if leaves[i].requires_grad]
        return _Pipeline.apply(sched, mine, x, *leaves)
    with torch.no_grad():
        return sched.forward(x, grad=False)
