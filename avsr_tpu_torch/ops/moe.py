"""Shared mixture-of-experts routing, the port of ``avsr_tpu/ops/moe.py``:
GShard capacity dispatch as dense one-hot algebra.

Used by the ``moe`` connector (``models/connectors.py``, gelu experts) and
the LLM's MoE FFN layers (``models/llama.py``, SwiGLU experts). Top-k
routing with a static per-expert capacity C: the dispatch is a one-hot
[N, E, C] tensor (or [B, T, E, C] when each row routes on its own), the
experts run as one batched product over [E, C, d], and tokens past
capacity drop to the residual path (GShard's overflow). This is the JAX
package's formulation, kept as it is: it is deterministic and computes
what the JAX package computes; an index-based dispatch would move far
fewer bytes (ROADMAP Queue 2).

Where the routing must make the JAX package's choices bit for bit:
  * top-k comes from a stable descending sort, so tied probabilities (an
    all-zero router: every logit equal) go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order);
  * slot positions are an integer cumsum (JAX's f32 cumsum is exact at
    these sizes, an integer one always);
  * the gate values are read from the probabilities with a one-hot
    product, not a gather: a gather's backward is a scatter-add, which
    adds with float atomics on the card, and a resumed train step must
    repeat an uninterrupted one bit for bit.
:func:`ffn` is the routed FFN both callers run: the router's logits are an
f32 product (with TF32 off, as PyTorch's default leaves it, a full f32
one), then :func:`route` and the experts in one of three routings.

Across processes (one per card, ``mesh/``) the training routing is the
JAX package's over the global batch, which its mesh shards over the data
axes (``dcn``, ``dp``, ``fsdp``, ``ep``) and, inside the LLM's ring, over
``sp``. Each rank routes its own tokens (:class:`Routing`): the capacity is
the global token count's, each slot position adds how many tokens before
it in the global order chose that expert with that choice rank
(:func:`slot_offsets`, from one all-gather of per-row counts), and the
balance and z losses are global means (their sums all-reduced with a
gradient that is summed too). An expert's output depends only on its
token, so only the drop decisions and the losses need the other ranks.
Under ``mesh.ep`` a rank holds E / ep experts: the dense exchange
(``collectives.scatter_to_experts`` / ``gather_from_experts``) sums the
ranks' partial [E, C, d] slot tensors onto the experts' owners over the
ep group and gathers the owners' outputs back for the combine. A row
whose chunks ring under sp at an inference prefill routes the same way
within the row.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from avsr_tpu_torch.mesh.collectives import (gather_from_experts, scatter_to_experts,
                                             sum_over)

ExpertFn = Callable[[torch.Tensor], torch.Tensor]


class Routing(NamedTuple):
    """The ranks whose tokens route together. ``group``'s ranks hold the
    same number of rows each; under sequence parallelism each row is cut
    into ``chunks`` contiguous chunks held by consecutive group ranks, so
    group rank r holds chunk ``r % chunks`` of the rows of data position
    ``r // chunks``. The global token order is then JAX's flattened one:
    data positions, their rows, each row's positions."""

    group: Any
    chunks: int = 1


def slot_offsets(counts: torch.Tensor, rank: int, chunks: int = 1) -> torch.Tensor:
    """What to add to group rank ``rank``'s local slot positions to give
    the global ones. ``counts`` [..., n, R, k, E] (int64) holds every
    rank's count of valid tokens per local row (its chunk of the row), per
    choice rank and expert, in group order (:class:`Routing`); leading
    dims are independent routings. A global position is the count of all
    tokens' earlier choice ranks to the expert, plus the count of this
    choice rank's picks of it by tokens before the token in global order;
    the local cumsum of :func:`route` counts the same over the rank's own
    tokens. Returns [..., k, R, E]."""
    *lead, n, R, k, E = counts.shape
    pieces = (counts.reshape(*lead, n // chunks, chunks, R, k, E).transpose(-4, -3)
              .reshape(*lead, n * R, k, E))                            # global order
    before = pieces.cumsum(-3) - pieces
    total = pieces.sum(-3)
    base = total.cumsum(-2) - total                                    # [.., k, E]
    d, s = divmod(rank, chunks)
    idx = (d * R + torch.arange(R, device=counts.device)) * chunks + s
    mine = counts[..., rank, :, :, :]                                  # [.., R, k, E]
    local = mine.sum(-3)
    off = (base[..., None, :, :] + before[..., idx, :, :]
           - (local.cumsum(-2) - local)[..., None, :, :] - (mine.cumsum(-3) - mine))
    return off.transpose(-3, -2)


def capacity(n_tokens: int, n_experts: int, topk: int, factor: float) -> int:
    """Static per-expert slot count, rounded up to a multiple of 8."""
    c = int(math.ceil(topk * n_tokens * factor / n_experts))
    return max(8, (c + 7) // 8 * 8)


def capacity_dyn(n_valid: torch.Tensor, n_experts: int, topk: int,
                 factor: float) -> torch.Tensor:
    """:func:`capacity` from a tensor of per-row VALID token counts (int64,
    no host sync). Row-wise inference routing uses it as each row's slot
    cutoff, so a request drops the same tokens whatever bucket it was
    padded to and whatever shares its batch. Monotone in ``n_valid``, so it
    never exceeds ``capacity(T, ...)`` of the padded width T."""
    c = torch.ceil(topk * n_valid.float() * factor / n_experts).long()
    return torch.clamp((c + 7) // 8 * 8, min=8)


def dropless_capacity(n_tokens: int, topk: int) -> int:
    """C >= topk * N: no token can overflow any expert, so a token's output
    depends only on its own hidden state. The token-step paths (a decode
    step routes B tokens, a speculative verify B * (gamma + 1)) use it;
    prefills route row by row instead (dropless there would be a
    topk * N^2 * E dispatch)."""
    return max(8, (topk * n_tokens + 7) // 8 * 8)


def piece_offsets(routing: Routing, B: int, T: int
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The ``offset`` of :func:`route` for a rank's B rows of T positions
    (its chunk of them under sp), flattened, as a piece of ``routing``'s
    global batch: the choices' per-row counts all-gathered over the group
    (int64), then :func:`slot_offsets`."""
    g = routing.group

    def offset(se: torch.Tensor) -> torch.Tensor:                      # [N, k, E]
        k, E = se.shape[-2:]
        counts = g.all_gather(se.reshape(B, T, k, E).sum(1)[None])      # [n, B, k, E]
        off = slot_offsets(counts, g.rank, routing.chunks)              # [k, B, E]
        return off[:, :, None, :].expand(k, B, T, E).reshape(k, B * T, E)

    return offset


def route(logits: torch.Tensor, valid: torch.Tensor, topk: int, C: int,
          cap: torch.Tensor | None = None,
          offset: Callable[[torch.Tensor], torch.Tensor] | None = None,
          group: Any = None
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-routed top-k dispatch from router logits.

    logits [..., N, E] f32, valid [..., N] (1 routes the token, 0 masks
    padding out of the routing and the aux losses). Leading dims are
    independent routings (the JAX package ``vmap``s :func:`route` over
    rows). Returns
      dispatch [..., N, E, C]  one-hot token -> slot assignment (f32)
      combine  [..., N, E, C]  dispatch * renormalized gate weight
      lb       [...]           Switch load-balance loss (1.0 at uniform)
      z        [...]           router z-loss
    Priority is slot-major: every token's first choice claims capacity
    before any token's second choice. ``cap`` ([...] integer tensor, each
    <= C, e.g. :func:`capacity_dyn`) tightens the overflow cutoff below the
    slot dim C without changing any shape.

    Routing a piece of a larger token set (:class:`Routing`): ``offset``, a
    function of the choices ``se`` [..., N, k, E] that gives [..., k, N, E]
    or a shape that broadcasts to it (:func:`piece_offsets`), is added to
    each choice's slot position, and ``group`` sums the aux losses' token
    counts and sums over its ranks (with a gradient that is summed over
    them too), so that lb and z are the whole set's. The sums are taken in
    float64 (and the losses rounded to float32), so that pieces give the
    one-call values."""
    N, E = logits.shape[-2:]
    lead = logits.shape[:-2]
    dev = logits.device
    vf = valid.to(torch.float32)
    vi = valid.to(torch.int64)
    probs = torch.softmax(logits, dim=-1)                               # [.., N, E]
    order = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices
    choice = order[..., :topk, None] == torch.arange(E, device=dev)     # [.., N, k, E]
    gate = (probs[..., None, :] * choice).sum(-1)                       # [.., N, k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    gate = gate * vf[..., None]                                         # pad -> 0

    se = choice.to(torch.int64) * vi[..., None, None]                   # [.., N, k, E]
    se_f = se.transpose(-3, -2).reshape(*lead, topk * N, E)             # [.., kN, E]
    pos_e = torch.cumsum(se_f, dim=-2) - se_f
    if offset is not None:
        pos_e = pos_e + offset(se).expand(*lead, topk, N, E).reshape(*lead, topk * N, E)
    pos = (pos_e * se_f).sum(-1)                                        # [.., kN]
    cutoff = C if cap is None else cap[..., None]
    in_cap = pos < cutoff
    slot = torch.where(in_cap, pos, 0)
    oh_c = ((slot[..., None] == torch.arange(C, device=dev))
            & in_cap[..., None]).to(torch.float32)                      # [.., kN, C]
    se_k = se_f.to(torch.float32).reshape(*lead, topk, N, E, 1)
    oh_k = oh_c.reshape(*lead, topk, N, 1, C)
    gate_k = gate.transpose(-1, -2)[..., None, None]                    # [.., k, N, 1, 1]
    # each (token, expert) pair comes from at most one of the k choices,
    # so these sums add one nonzero term: exact, as JAX's sum over k
    dispatch = sum(se_k[..., j, :, :, :] * oh_k[..., j, :, :, :] for j in range(topk))
    combine = sum((se_k[..., j, :, :, :] * gate_k[..., j, :, :, :]) * oh_k[..., j, :, :, :]
                  for j in range(topk))

    # Switch-style load balance on valid tokens, E * sum_e f_e * P_e (1.0
    # at uniform routing), and the router z-loss
    vd = vf.double()
    sums = torch.cat([se[..., 0, :].sum(-2).double(),                  # top-1 counts
                      (probs.double() * vd[..., None]).sum(-2),
                      (torch.logsumexp(logits, dim=-1).double() ** 2 * vd).sum(-1, keepdim=True),
                      vd.sum(-1, keepdim=True)], dim=-1)
    top1, psum, zsum, nv = sum_over(sums, group).split([E, E, 1, 1], dim=-1)
    nvalid = torch.clamp(nv, min=1.0)
    lb = (E * ((top1 / nvalid) * (psum / nvalid)).sum(-1)).float()
    z = (zsum / nvalid)[..., 0].float()
    return dispatch, combine, lb, z


def dispatch_apply(dispatch: torch.Tensor, combine: torch.Tensor, xf: torch.Tensor,
                   expert_fn: ExpertFn, ep: Any = None) -> torch.Tensor:
    """Dispatch -> experts -> combine over flattened tokens: dispatch and
    combine [N, E, C] from :func:`route`, xf [N, d];
    ``expert_fn([E', C, d]) -> [E', C, d']`` is the expert math over the
    experts this rank holds. Both one-hot contractions are matrix products
    in xf's dtype (their backward is too: no atomics). Under expert
    parallelism (``ep``, the group over which the experts are split, E' =
    E / ep) the rank's partial [E, C, d] is summed onto the owners of its
    slices of E and the owners' outputs are gathered back; a slot holds
    one token, so both sums add one nonzero term and are exact, and a slot
    that no token of the group took runs the experts on zeros, which no
    combine reads. Returns [N, d']."""
    N, E, C = dispatch.shape
    cdt = xf.dtype
    xs = torch.matmul(dispatch.to(cdt).reshape(N, E * C).t(), xf)       # [E*C, d]
    ys = expert_fn(scatter_to_experts(xs.reshape(E, C, -1), ep))
    ys = gather_from_experts(ys, ep)
    return torch.matmul(combine.to(cdt).reshape(N, E * C), ys.reshape(E * C, -1))


def dispatch_apply_rowwise(dispatch: torch.Tensor, combine: torch.Tensor,
                           x: torch.Tensor, expert_fn: ExpertFn) -> torch.Tensor:
    """Row-wise dispatch -> experts -> combine: dispatch and combine
    [B, T, E, C] from a per-row :func:`route`, x [B, T, d]. Each row owns
    its capacity slots, so its routing outcome is independent of what else
    shares the call (the inference-prefill counterpart of
    :func:`dispatch_apply`); the experts still run as one batched product
    over [E, B*C, d]. Returns [B, T, d']."""
    B, T, E, C = dispatch.shape
    cdt = x.dtype
    xs = torch.matmul(dispatch.to(cdt).reshape(B, T, E * C).transpose(1, 2), x)
    xs = xs.reshape(B, E, C, -1).transpose(0, 1).reshape(E, B * C, -1)
    ys = expert_fn(xs)
    ys = ys.reshape(E, B, C, -1).transpose(0, 1).reshape(B, E * C, -1)
    return torch.matmul(combine.to(cdt).reshape(B, T, E * C), ys)


def ffn(x: torch.Tensor, router_w: torch.Tensor, valid: torch.Tensor, topk: int,
        factor: float, expert_fn: ExpertFn, *, rowwise: bool = False,
        dropless: bool = False, routing: Routing | None = None,
        ep: Any = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A routed FFN over x [B, T, d]: the f32 router logits x @ router_w
    [d, E], :func:`route` and the experts. ``valid`` [B, T] (1 routes the
    token) masks right-padding out of the routing and the aux losses.
    Returns (y [B, T, d'], lb, z). Three routings, as in the JAX package's
    MoE connector and MoE FFN:
      * training (default): one flattened routing over the B*T tokens with
        the bounded ``capacity`` (GShard's trade); with ``routing`` x is
        this rank's piece of the global batch (:class:`Routing`), routed
        with the global capacity, slot offsets and losses;
      * ``rowwise`` (every inference prefill): each row routes within its
        own slots, its cutoff from its valid length (:func:`capacity_dyn`),
        so a request gives the same output in any batch or bucket; lb and
        z are the rows' means. With ``routing`` (a ring's sp group,
        ``chunks`` its size) x holds this rank's chunk of every row, routed
        as the whole row;
      * ``dropless`` (token steps): :func:`dropless_capacity`, nothing
        overflows.
    ``ep``: the expert-parallel group of the experts' slices, whose tokens
    ``expert_fn`` reaches through :func:`dispatch_apply`'s exchange (the
    training routing only: inference holds whole experts)."""
    B, T, d = x.shape
    E = router_w.shape[1]
    router = router_w.float()
    vf = valid.float()
    g = routing.group if routing is not None and routing.group.size > 1 else None
    if (rowwise or dropless) and ep is not None and ep.size > 1:
        raise NotImplementedError(
            f"the inference routings run on whole experts; this rank holds "
            f"{E // ep.size} of {E} (mesh.ep={ep.size}): gather them first")
    if rowwise:
        n = routing.chunks if g is not None else 1
        C = capacity(T * n, E, topk, factor)
        nv = vf.sum(-1)
        cap = capacity_dyn(nv if g is None else g.all_reduce(nv.clone()), E, topk, factor)
        offset = None
        if g is not None:
            def offset(se: torch.Tensor) -> torch.Tensor:          # [B, T, k, E]
                counts = g.all_gather(se.sum(-3)[None])             # [n, B, k, E]
                return slot_offsets(counts.transpose(0, 1)[:, :, None], g.rank, n)
        dispatch, combine, lb, z = route(torch.matmul(x.float(), router), vf, topk, C,
                                         cap=cap, offset=offset, group=g)
        return dispatch_apply_rowwise(dispatch, combine, x, expert_fn), lb.mean(), z.mean()
    N = B * T
    if dropless:
        C = dropless_capacity(N, topk)
    else:
        C = capacity(N * (g.size if g is not None else 1), E, topk, factor)
    offset = piece_offsets(routing, B, T) if g is not None and not dropless else None
    xf = x.reshape(N, d)
    dispatch, combine, lb, z = route(torch.matmul(xf.float(), router), vf.reshape(N), topk, C,
                                     offset=offset, group=g if not dropless else None)
    y = dispatch_apply(dispatch, combine, xf, expert_fn, ep)
    return y.reshape(B, T, -1), lb, z
