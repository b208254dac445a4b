"""Ring attention: exact attention over a sequence sharded across the ranks
of an ``sp`` group, the port of ``avsr_tpu/ops/ring_attention.py``.

Each rank holds one contiguous chunk of q, k and v ([B, H, T/sp, D], rank
i the positions [i T/sp, (i+1) T/sp)). In ``sp`` steps every rank attends
its queries to each chunk of keys in turn, as the chunks travel the ring
(``Group.shift``: to the next rank, from the previous one), and merges the
partial results through their per-row logsumexp in f32. The JAX package
unrolls the same ring in plain JAX and lets autodiff transpose it; the
port writes the backward (:class:`RingAttention`):

  * **forward**: one block per step, ``flash_attention`` (the CUDA kernel
    of ``csrc/flash_fwd.cu``) of the local q against the visiting chunk
    ``src``, with that chunk's key lengths ``clamp(kv_lens - src Tl, 0,
    Tl)``. Under ``causal`` a chunk before this rank's is a full block, this
    rank's own is the kernel's causal block (top-left aligned, Tq = Tk)
    and a later one launches nothing (rank i runs i + 1 blocks). The
    kernel gives a row without a key lse = +inf and O = 0; the merge takes
    that as -inf, so the block weighs nothing, and a row with no key in
    any block gives zeros, as JAX's ring does;
  * **backward**: the merged O and lse are kept; each step launches the dQ
    and dK/dV kernels of ``csrc/flash_bwd.cu`` against the visiting chunk
    with the global lse (and the delta = rowsum(dO O) of the merged O that
    the dQ kernel writes). dQ adds up in f32 on its rank; a chunk's dK and
    dV add up in f32 as they travel with it and reach its owner after one
    more shift.

On CUDA every block whose head width the kernels take
(``attention.kernel_takes``: a multiple of 64) launches them, whatever the chunk's
length (the 256-row threshold is a rule of the non-ring path); another
width takes the plain block, as JAX's ring is plain JAX, and so does every
CPU tensor (:func:`ring_block_reference` forward, the kernels' plain
backward versions). Nothing gives way to a plain version when a kernel
fails to build or launch: that raises.

Queries past ``q_lens`` (this rank's chunk of the global row counts) are
masked as the non-ring path masks them (O = 0, dQ = 0); JAX's ring masks
keys only, so the two agree on valid rows.
"""

from __future__ import annotations

import torch

from avsr_tpu_torch.ops.attention import (
    NEG_INF,
    _scale,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dkv_reference,
    flash_bwd_dq,
    flash_bwd_dq_reference,
    kernel_takes,
)

# The kernel launches of the ring's blocks (each also counted by its
# wrapper; ``attention.ring_dispatch_count`` counts the rings)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def ring_block_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos0: int, k_pos0: int, kv_lens: torch.Tensor,
                         causal: bool, sm_scale: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block of the ring in plain PyTorch, JAX's ``_ring_block``: local
    q [B,H,Tq,D] against a kv block [B,Hkv,Tk,D] whose first position is
    ``k_pos0`` (q's is ``q_pos0``), keys past ``kv_lens`` [B] (global)
    masked, and under ``causal`` keys after the query. Returns (the
    unnormalized output [B,H,Tq,D] f32, the row max m and the row sum l of
    exp(s - m), each [B,H,Tq,1]); a row with no key has m = NEG_INF, l = 0
    and a zero output."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Tq, D).float() * sm_scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    q_ids = q_pos0 + torch.arange(Tq, device=q.device)
    k_ids = k_pos0 + torch.arange(Tk, device=q.device)
    mask = (k_ids[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, None, :]
    if causal:
        mask = mask & (q_ids[:, None] >= k_ids[None, :])[None, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return (out.reshape(B, H, Tq, D), m.reshape(B, H, Tq, 1), l.reshape(B, H, Tq, 1))


def _chunk_lens(lens: torch.Tensor | None, chunk: int, Tl: int, B: int,
                device: torch.device) -> torch.Tensor:
    """The valid rows of chunk ``chunk`` of ``Tl`` rows for global counts
    ``lens`` [B] (all of them without)."""
    if lens is None:
        return torch.full((B,), Tl, dtype=torch.int32, device=device)
    return (lens.to(device=device, dtype=torch.int32) - chunk * Tl).clamp(0, Tl)


def _plain_block(q, kb, vb, ql, kl, idx, src, causal, scale):
    """(O, lse) of one block in plain PyTorch, lse -inf on rows without a
    key (and on rows past ``ql``, whose O is 0)."""
    Tl = q.shape[2]
    out, m, l = ring_block_reference(q, kb, vb, idx * Tl, src * Tl, kl + src * Tl,
                                     causal, scale)
    rows = (torch.arange(Tl, device=q.device)[None, :] < ql[:, None])[:, None, :, None]
    ok = (l > 0) & rows
    o = torch.where(ok, out / torch.where(ok, l, 1.0), 0.0)
    lse = torch.where(ok, m + torch.log(torch.where(ok, l, 1.0)), float("-inf"))
    return o.to(q.dtype), lse[..., 0]


def _merge(acc: torch.Tensor, lse: torch.Tensor, o: torch.Tensor,
           lse_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The running (O f32, lse) with one more block (O_b, lse_b) merged:
    lse' = logaddexp(lse, lse_b), O' = exp(lse - lse') O + exp(lse_b -
    lse') O_b; rows with no key so far stay 0 and -inf."""
    new = torch.logaddexp(lse, lse_b)
    fin = torch.isfinite(new)
    a = torch.where(fin, torch.exp(lse - new), 0.0)[..., None]
    b = torch.where(fin, torch.exp(lse_b - new), 0.0)[..., None]
    return acc * a + o.float() * b, new


class RingAttention(torch.autograd.Function):
    """O = exact attention of this rank's q chunk over the whole sequence
    of k and v, sharded over ``group`` (see the module docstring).
    ``RingAttention.apply(q, k, v, q_lens, kv_lens, group, causal,
    sm_scale, kernel)``; q, k, v contiguous chunks, lens global [B] or
    None, ``kernel`` whether the blocks launch the CUDA kernels."""

    @staticmethod
    def forward(ctx, q, k, v, q_lens, kv_lens, group, causal, sm_scale, kernel):
        B, _, Tl, D = q.shape
        n, idx = group.size, group.rank
        scale = _scale(sm_scale, D)
        ql = _chunk_lens(q_lens, idx, Tl, B, q.device)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], float("-inf"), device=q.device)
        kb, vb = k, v
        for i in range(n):
            src = (idx - i) % n
            if not (causal and src > idx):
                kl = _chunk_lens(kv_lens, src, Tl, B, q.device)
                blk_causal = causal and src == idx
                if kernel:
                    o, lse_b = flash_attention(q, kb, vb, ql, kl, blk_causal, scale)
                    launches["flash_fwd"] += 1
                    lse_b = torch.where(lse_b == float("inf"), float("-inf"), lse_b)
                else:
                    o, lse_b = _plain_block(q, kb, vb, ql, kl, idx, src, blk_causal, scale)
                acc, lse = _merge(acc, lse, o, lse_b)
            if i + 1 < n:
                kb, vb = group.shift([kb, vb])
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse, ql)
        ctx.args = (kv_lens, group, causal, scale, kernel)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, ql = ctx.saved_tensors
        kv_lens, group, causal, scale, kernel = ctx.args
        n, idx = group.size, group.rank
        B, _, Tl, _ = q.shape
        do = do.contiguous()
        # the kernels' convention: +inf marks a row with no key
        lse = torch.where(lse == float("-inf"), float("inf"), lse).contiguous()
        dq_fn, dkv_fn = ((flash_bwd_dq, flash_bwd_dkv) if kernel
                         else (flash_bwd_dq_reference, flash_bwd_dkv_reference))
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kb, vb = k, v
        for i in range(n):
            src = (idx - i) % n
            if not (causal and src > idx):
                kl = _chunk_lens(kv_lens, src, Tl, B, q.device)
                blk_causal = causal and src == idx
                dq_b, delta = dq_fn(q, kb, vb, out, lse, do, ql, kl, blk_causal, scale)
                dk_b, dv_b = dkv_fn(q, kb, vb, lse, delta, do, ql, kl, blk_causal, scale)
                if kernel:
                    launches["flash_bwd_dq"] += 1
                    launches["flash_bwd_dkv"] += 1
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            if i + 1 < n:
                kb, vb, dk, dv = group.shift([kb, vb, dk, dv])
        if n > 1:                       # the partials reach their chunk's owner
            dk, dv = group.shift([dk, dv])
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group,
                   causal: bool = False, kv_lens: torch.Tensor | None = None,
                   q_lens: torch.Tensor | None = None, sm_scale: float | None = None,
                   use_kernel: str = "auto") -> torch.Tensor:
    """Exact attention over a sequence sharded over the sp ``group``: q
    [B,H,Tl,D] and k, v [B,Hkv,Tl,D] are this rank's chunks (Tl = T /
    group.size, H % Hkv == 0), ``kv_lens`` / ``q_lens`` [B] the global valid
    key / query counts (right padding); returns this rank's chunk of O
    [B,H,Tl,D] in q's dtype, differentiable. The blocks launch the flash
    kernels on CUDA at the head widths they take, unless ``use_kernel`` is
    "never"."""
    kernel = (use_kernel != "never" and q.is_cuda and kernel_takes(q.shape[-1]))
    return RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), q_lens,
                               kv_lens, group, causal, sm_scale, kernel)
