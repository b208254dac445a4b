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
one), then :func:`route` and the experts in one of three routings. Expert
parallelism (``constrain_ep``, mesh.ep > 1) is not ported: the port runs
on one card.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

ExpertFn = Callable[[torch.Tensor], torch.Tensor]


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


def route(logits: torch.Tensor, valid: torch.Tensor, topk: int, C: int,
          cap: torch.Tensor | None = None
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
    slot dim C without changing any shape."""
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
    pos = ((torch.cumsum(se_f, dim=-2) - se_f) * se_f).sum(-1)          # [.., kN]
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
    nvalid = torch.clamp(vf.sum(-1), min=1.0)                           # [..]
    f_e = se[..., 0, :].to(torch.float32).sum(-2) / nvalid[..., None]   # top-1 share
    p_e = (probs * vf[..., None]).sum(-2) / nvalid[..., None]
    lb = E * (f_e * p_e).sum(-1)
    z = (torch.logsumexp(logits, dim=-1) ** 2 * vf).sum(-1) / nvalid
    return dispatch, combine, lb, z


def dispatch_apply(dispatch: torch.Tensor, combine: torch.Tensor, xf: torch.Tensor,
                   expert_fn: ExpertFn) -> torch.Tensor:
    """Dispatch -> experts -> combine over flattened tokens: dispatch and
    combine [N, E, C] from :func:`route`, xf [N, d];
    ``expert_fn([E, C, d]) -> [E, C, d']`` is the expert math. Both
    one-hot contractions are matrix products in xf's dtype (their
    backward is too: no atomics). Returns [N, d']."""
    N, E, C = dispatch.shape
    cdt = xf.dtype
    xs = torch.matmul(dispatch.to(cdt).reshape(N, E * C).t(), xf)       # [E*C, d]
    ys = expert_fn(xs.reshape(E, C, -1))
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
        dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A routed FFN over x [B, T, d]: the f32 router logits x @ router_w
    [d, E], :func:`route` and the experts. ``valid`` [B, T] (1 routes the
    token) masks right-padding out of the routing and the aux losses.
    Returns (y [B, T, d'], lb, z). Three routings, as in the JAX package's
    MoE connector and MoE FFN:
      * training (default): one flattened routing over the B*T tokens with
        the bounded ``capacity`` (GShard's trade);
      * ``rowwise`` (every inference prefill): each row routes within its
        own slots, its cutoff from its valid length (:func:`capacity_dyn`),
        so a request gives the same output in any batch or bucket; lb and
        z are the rows' means;
      * ``dropless`` (token steps): :func:`dropless_capacity`, nothing
        overflows."""
    B, T, d = x.shape
    E = router_w.shape[1]
    router = router_w.float()
    vf = valid.float()
    if rowwise:
        C = capacity(T, E, topk, factor)
        cap = capacity_dyn(vf.sum(-1), E, topk, factor)
        dispatch, combine, lb, z = route(torch.matmul(x.float(), router), vf, topk, C, cap=cap)
        return dispatch_apply_rowwise(dispatch, combine, x, expert_fn), lb.mean(), z.mean()
    N = B * T
    C = dropless_capacity(N, topk) if dropless else capacity(N, E, topk, factor)
    xf = x.reshape(N, d)
    dispatch, combine, lb, z = route(torch.matmul(xf.float(), router), vf.reshape(N), topk, C)
    return dispatch_apply(dispatch, combine, xf, expert_fn).reshape(B, T, -1), lb, z
