"""Attention ops: plain PyTorch references + the Hopper flash-attention kernels.

The counterpart of ``avsr_tpu/ops/attention.py``:

  * ``mha_reference`` — masked multi-head attention in plain PyTorch (f32
    scores), the port of the JAX ``mha_reference``. It serves every shape
    the kernel does not take (CLIP at T=50, ``kv_valid`` masks).
  * ``flash_attention`` — the wrapper of the CUDA kernel
    ``csrc/flash_fwd.cu`` (the port of the Pallas ``_flash_fwd_kernel``):
    returns O and the per-row logsumexp. It records no gradient: on a CUDA
    tensor that requires one it raises (use ``attention``).
  * ``flash_bwd_dq`` / ``flash_bwd_dkv`` — the wrappers of the CUDA kernels
    of ``csrc/flash_bwd.cu`` (the ports of ``_flash_bwd_dq_kernel`` and
    ``_flash_bwd_dkv_kernel``); ``flash_attention_bwd_reference`` is their
    plain version. dQ also returns delta = rowsum(dO * O), which dK/dV
    reads in place of O.
  * ``FlashAttention`` — the autograd Function around the three kernels,
    the counterpart of the JAX ``_flash_core`` custom VJP.
  * ``attention`` — the dispatch, with the JAX package's predicate; under
    sequence parallelism (an ``sp`` group) it runs ring attention
    (``ops/ring_attention.py``) on this rank's chunks, where
    :func:`ring_span` (JAX's ring predicate, warning and counter) let the
    block stack shard its sequence.

Every kernel wrapper takes its plain version for a CPU tensor, and for a
CUDA tensor launches its kernel (on the current stream) or raises. All
shapes are [batch, heads, seq, head_dim]; GQA needs H % Hkv == 0. Rows at
or past ``q_len`` and rows with no valid key give O = 0 (and lse = +inf)
in every function here, and a zero dQ.
"""

from __future__ import annotations

import ctypes
import logging

import torch

from avsr_tpu_torch.core.logging import trace_range

NEG_INF = -1e30

# Ring dispatches under sequence parallelism (one per attention call that
# rings, as the JAX package's ``ring_dispatch_count``), and the reasons
# already logged for a stack that could not ring.
ring_dispatch_count = 0
_ring_fallback_warned: set[str] = set()

# Launches of each CUDA kernel (incremented once per launch, nowhere else).
launches = 0          # flash_fwd
dq_launches = 0       # flash_bwd dQ
dkv_launches = 0      # flash_bwd dK/dV
# Tensors zero-padded to a compiled head width by the wrappers (one per
# padded operand; the pad route of the f32 forward and of the backward).
pad_copies = 0

# Kernel dispatch thresholds of the JAX package (attention.py:565-571). They
# were set on a TPU, where the Pallas kernel loses to XLA below ~256 tokens;
# the port keeps them as the reference's rule until measured on the card.
MIN_KERNEL_SEQ = 256
# The head widths the kernels take: every multiple of 64, the JAX rule
# (attention.py:566-571, ``D % 64 == 0``): 64 (Whisper, HuBERT, CLIP,
# Llama-3.2), 128 (Llama-2-7B and 13B), and 256, 384, 512, 640 and 1024 (the
# connectors' 8 heads over a 2048-, 3072-, 4096-, 5120- and 8192-wide LLM).
# Up to 512 the CUDA sources compile COMPILED_HEAD_DIMS, and the widths
# between them run the next wider kernel with the scale of the true width
# on zero columns past it (exact: zero columns add nothing to Q K^T or
# dO V^T). The bf16 forward reads its operands at their own width: its TMA
# tensor maps zero-fill the panels past it and do not store O's columns
# past it, so it makes no copy (``operand_width``). The f32 kernels read by
# pointer, not by TMA, and the backward kernels still take padded operands,
# so those wrappers zero-pad to the compiled width (``_pad_heads``) and
# slice the pad columns off their outputs. Above 512 the panel kernels take
# the width itself at run time: they stream Q, K, V (and dO) through shared
# memory in 64-column panels and split every output into groups of 256
# columns, one CTA a group. The bf16 forward runs the groups of one tile as
# a thread-block cluster that computes one S between them, up to 8 groups
# (D <= 2048); above, and in the backward and f32 kernels, each group
# recomputes the scores over the whole width.
COMPILED_HEAD_DIMS = (64, 128, 256, 512)


def kernel_takes(D: int) -> bool:
    """Whether the kernels take head width D (JAX's rule: a multiple of
    64)."""
    return D > 0 and D % 64 == 0


def _lens(lens: torch.Tensor | None, n: int, batch: int,
          device: torch.device) -> torch.Tensor:
    if lens is None:
        return torch.full((batch,), n, dtype=torch.int32, device=device)
    return lens.to(device=device, dtype=torch.int32)


def _scale(sm_scale: float | None, D: int) -> float:
    return sm_scale if sm_scale is not None else D ** -0.5


def kernel_width(D: int) -> int:
    """The kernel width that runs head width D: D itself when it is compiled
    or above 512 (the panel kernels), else the next wider compiled width, on
    zero-padded operands."""
    if D > COMPILED_HEAD_DIMS[-1]:
        return D
    return min(w for w in COMPILED_HEAD_DIMS if w >= D)


def operand_width(D: int, dtype: torch.dtype) -> int:
    """The head width of the operands the forward kernel is given at head
    width D: D itself for bfloat16 (its tensor maps read and write at the
    true width), ``kernel_width(D)`` for float32 (the scalar kernels read
    by pointer, so a width between the compiled ones is zero-padded)."""
    return D if dtype == torch.bfloat16 else kernel_width(D)


def kernel_cluster(D: int, dtype: torch.dtype) -> int:
    """The thread-block cluster size of the forward kernel at head width D:
    above 512 in bfloat16 the ceil(D / 256) column groups of a tile, while
    they number at most 8 (the largest portable cluster: D <= 2048); else 0
    (no cluster). Asks the built library (its C entry
    ``avsr_flash_fwd_cluster``)."""
    from avsr_tpu_torch.ops import _build

    fn = _build.load("flash_fwd").avsr_flash_fwd_cluster
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(D, _DTYPES[dtype])


def _pad_heads(Dp: int, *ts: torch.Tensor) -> list[torch.Tensor]:
    """The tensors zero-padded along the head width to Dp (as they are
    when they already have it); each padded one counts in ``pad_copies``."""
    global pad_copies
    out = []
    for t in ts:
        if t.shape[-1] != Dp:
            t = torch.nn.functional.pad(t, (0, Dp - t.shape[-1]))
            pad_copies += 1
        out.append(t)
    return out


def _cut_heads(D: int, *ts: torch.Tensor) -> list[torch.Tensor]:
    """The kernel's outputs with the pad columns past head width D sliced
    off (contiguous, as the wrappers return them)."""
    return [t if t.shape[-1] == D else t[..., :D].contiguous() for t in ts]


# ---------------------------------------------------------------------------
# Plain references
# ---------------------------------------------------------------------------

def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, q_lens: torch.Tensor | None = None,
                  kv_lens: torch.Tensor | None = None,
                  kv_valid: torch.Tensor | None = None,
                  sm_scale: float | None = None) -> torch.Tensor:
    """Masked MHA in plain PyTorch. q: [B,H,Tq,D]; k,v: [B,Hkv,Tk,D].

    ``kv_valid`` [B, Tk] bool masks arbitrary key positions; ``kv_lens`` is
    the right-padding special case. The causal mask is bottom-right
    aligned (key j is visible to row i iff j <= i + Tk - Tq)."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    scale = _scale(sm_scale, D)
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    dev = q.device
    mask = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & torch.ones((Tq, Tk), dtype=torch.bool,
                                 device=dev).tril(Tk - Tq)
    if kv_lens is not None:
        kv_ok = torch.arange(Tk, device=dev)[None, :] < kv_lens.to(dev)[:, None]
        mask = mask & kv_ok[:, None, None, :]
    if kv_valid is not None:
        mask = mask & kv_valid.to(dev)[:, None, None, :]
    if q_lens is not None:
        q_ok = torch.arange(Tq, device=dev)[None, :] < q_lens.to(dev)[:, None]
        mask = mask & q_ok[:, None, :, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # Rows with no valid key become uniform after a softmax over NEG_INF;
    # zero them.
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    return torch.matmul(p, v.float()).to(q.dtype)


def _flash_mask(B: int, Tq: int, Tk: int, q_lens, kv_lens, causal: bool,
                device: torch.device) -> torch.Tensor:
    """[B, 1, Tq, Tk] bool: the kernels' mask (q_len, kv_len, top-left
    causal)."""
    ql = _lens(q_lens, Tq, B, device).clamp(0, Tq)
    kl = _lens(kv_lens, Tk, B, device).clamp(0, Tk)
    qi = torch.arange(Tq, device=device)
    kj = torch.arange(Tk, device=device)
    mask = (kj[None, :] < kl[:, None])[:, None, None, :]           # [B,1,1,Tk]
    mask = mask & (qi[None, :] < ql[:, None])[:, None, :, None]    # [B,1,Tq,Tk]
    if causal:
        mask = mask & (kj[None, :] <= qi[:, None])[None, None]
    return mask


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_lens: torch.Tensor | None = None, kv_lens: torch.Tensor | None = None,
    causal: bool = False, sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernel: (O [B,H,Tq,D] in q's dtype,
    lse [B,H,Tq] f32), with the kernel's masking and rounding.

    Scores are f32 (products of bf16 inputs are exact in f32), the causal
    mask is top-left aligned like the Pallas kernel's, and P is cast to the
    value dtype before the PV product, as the kernel does. Rows at or past
    q_len and rows with no valid key give O = 0 and lse = +inf."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if causal and Tq != Tk:
        raise ValueError(f"causal flash attention needs Tq == Tk, got {Tq}, {Tk}")
    g = H // Hkv
    scale = _scale(sm_scale, D)
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale     # [B,H,Tq,Tk]
    mask = _flash_mask(B, Tq, Tk, q_lens, kv_lens, causal, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    valid = torch.isfinite(m)                                      # [B,H,Tq,1]
    p = torch.exp(s - torch.where(valid, m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vf)
    o = torch.where(valid, o / torch.where(valid, l, 1.0), 0.0)
    lse = torch.where(valid, m + torch.log(l), float("inf"))[..., 0]
    return o.to(q.dtype), lse


def _bwd_mask(q, k, q_lens, kv_lens, causal):
    B, _, Tq, _ = q.shape
    Tk = k.shape[2]
    if causal and Tq != Tk:
        raise ValueError(f"causal flash attention needs Tq == Tk, got {Tq}, {Tk}")
    return _flash_mask(B, Tq, Tk, q_lens, kv_lens, causal, q.device)


def _bwd_terms(q, k, v, lse, delta, do, mask, sm_scale):
    """(P, dS, dO with rows without keys zeroed) [B,H,Tq,Tk] f32 as both
    backward kernels recompute them."""
    g = q.shape[1] // k.shape[1]
    scale = _scale(sm_scale, q.shape[-1])
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    # rows past q_len carry nothing back (their dO is never read)
    dof = torch.where(mask.any(dim=-1, keepdim=True), do.float(), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    return p, p * (dp - delta[..., None]), dof


def flash_bwd_dq_reference(q, k, v, o, lse, do, q_lens=None, kv_lens=None,
                           causal=False, sm_scale=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dQ kernel: (scale * (dS in K's dtype) K,
    delta), with delta = rowsum(dO * O) [B,H,Tq] f32 from the saved O, 0
    on rows past q_len and rows without keys."""
    mask = _bwd_mask(q, k, q_lens, kv_lens, causal)
    dof = torch.where(mask.any(dim=-1, keepdim=True), do.float(), 0.0)
    delta = (dof * o.float()).sum(dim=-1)
    _, ds, _ = _bwd_terms(q, k, v, lse, delta, do, mask, sm_scale)
    kf = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    dq = torch.matmul(ds.to(k.dtype).float(), kf)
    return (dq * _scale(sm_scale, q.shape[-1])).to(q.dtype), delta


def flash_bwd_dkv_reference(q, k, v, lse, delta, do, q_lens=None,
                            kv_lens=None, causal=False, sm_scale=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dK/dV kernel: dK = (scale * dS in q's
    dtype)^T Q and dV = (P in dO's dtype)^T dO, summed over each kv head's
    query heads, with delta from :func:`flash_bwd_dq_reference`."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    mask = _bwd_mask(q, k, q_lens, kv_lens, causal)
    p, ds, dof = _bwd_terms(q, k, v, lse, delta, do, mask, sm_scale)
    ds = (ds * _scale(sm_scale, D)).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())             # [B,H,Tk,D]
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dk = dk.reshape(B, Hkv, H // Hkv, Tk, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, H // Hkv, Tk, D).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, q_lens: torch.Tensor | None = None,
    kv_lens: torch.Tensor | None = None, causal: bool = False,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of both backward kernels: (dq, dk, dv) from the
    forward's inputs, its saved O and lse, and dO, with the kernels'
    masking and rounding (P recomputed from lse; delta = rowsum(dO * O) in
    f32 from the saved O). Rows at or past q_len get dq = 0."""
    dq, delta = flash_bwd_dq_reference(q, k, v, o, lse, do, q_lens, kv_lens,
                                       causal, sm_scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, lse, delta, do, q_lens, kv_lens,
                                     causal, sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_N_PTRS = {"avsr_flash_fwd": 7, "avsr_flash_bwd_dq": 10, "avsr_flash_bwd_dkv": 10}


def _kernel_fn(source: str, symbol: str):
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, built on first
    use; each takes its pointers, then B, H, Hkv, Tq, Tk, D, is_f32,
    causal, the scale and the stream."""
    from avsr_tpu_torch.ops import _build

    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * _N_PTRS[symbol] + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(name: str, q, k, v, causal: bool) -> tuple[int, ...]:
    """Validates the operands every kernel takes; returns (B, H, Hkv, Tq,
    Tk, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA, not {q.device}")
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes bfloat16 or float32 operands "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not kernel_takes(D) or k.shape != (B, Hkv, Tk, D) or v.shape != k.shape:
        raise ValueError(f"{name} shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}: need "
                         f"D a multiple of 64 and k, v of one shape")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if causal and Tq != Tk:
        raise ValueError(f"causal flash attention needs Tq == Tk, got {Tq}, {Tk}")
    return B, H, Hkv, Tq, Tk, D


def _check_ptrs(name: str, dev: torch.device, **tensors) -> None:
    for key, t in tensors.items():
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be a contiguous, 16-byte "
                             f"aligned tensor on {dev}")


def _launch(source: str, symbol: str, ptrs: list[torch.Tensor], dims,
            dtype: torch.dtype, causal: bool, scale: float,
            dev: torch.device) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev), trace_range(symbol.removeprefix("avsr_")):
        err = _kernel_fn(source, symbol)(
            *[t.data_ptr() for t in ptrs], *dims, _DTYPES[dtype], int(causal),
            float(scale), stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def _cuda_lens(q_lens, kv_lens, B: int, Tq: int, Tk: int, dev):
    ql = _lens(q_lens, Tq, B, dev).contiguous()
    kl = _lens(kv_lens, Tk, B, dev).contiguous()
    if ql.shape != (B,) or kl.shape != (B,):
        raise ValueError("q_lens and kv_lens must have shape [B]")
    return ql, kl


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_lens: torch.Tensor | None = None, kv_lens: torch.Tensor | None = None,
    causal: bool = False, sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: (O [B,H,Tq,D], lse [B,H,Tq] f32).

    q: [B,H,Tq,D], k/v: [B,Hkv,Tk,D], contiguous, bfloat16 or float32,
    D a multiple of 64; causal needs Tq == Tk. Through 512 a width that is
    not compiled runs the next wider kernel: in bfloat16 on the operands as
    they are (its TMA tensor maps zero-fill past D and store O at D, so no
    copy is made), in float32 on operands zero-padded to the compiled
    width, whose pad columns are sliced off O (the scalar kernels read by
    pointer).
    Ragged tails (q_lens, kv_lens) are masked inside the kernel; no row is
    padded. A CPU tensor takes
    :func:`flash_attention_reference`; a CUDA tensor launches the kernel
    (on the current stream) or raises. The kernel's output has no
    gradient, so a CUDA input that requires one raises while grad mode is
    on: :func:`attention` (through :class:`FlashAttention`) is the
    differentiable path."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, q_lens, kv_lens, causal,
                                         sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention records no gradient; call attention() or "
            "FlashAttention.apply for a differentiable kernel path")
    B, H, Hkv, Tq, Tk, D = _check_qkv("flash_attention", q, k, v, causal)
    _check_ptrs("flash_attention", q.device, q=q, k=k, v=v)
    ql, kl = _cuda_lens(q_lens, kv_lens, B, Tq, Tk, q.device)
    Dw = operand_width(D, q.dtype)
    qp, kp, vp = _pad_heads(Dw, q, k, v)
    out = torch.empty_like(qp)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "avsr_flash_fwd", [qp, kp, vp, ql, kl, out, lse],
            (B, H, Hkv, Tq, Tk, Dw), q.dtype, causal, _scale(sm_scale, D),
            q.device)
    global launches
    launches += 1
    if Dw != D:
        (out,) = _cut_heads(D, out)
    return out, lse


def _check_bwd(name: str, q, k, v, do, causal, **rows):
    """Validates the backward's operands; ``rows`` are the [B, H, Tq] f32
    ones (lse, delta). Returns (B, H, Hkv, Tq, Tk, D)."""
    dims = _check_qkv(name, q, k, v, causal)
    B, H, _, Tq, _, _ = dims
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do must match q's shape and dtype")
    for key, t in rows.items():
        if t.shape != (B, H, Tq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32 of shape {(B, H, Tq)}")
    _check_ptrs(name, q.device, q=q, k=k, v=v, do=do, **rows)
    return dims


def flash_bwd_dq(q, k, v, o, lse, do, q_lens=None, kv_lens=None,
                 causal: bool = False, sm_scale: float | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dQ [B,H,Tq,D] in q's dtype, delta [B,H,Tq] f32) from the forward's
    q, k, v, its O and lse, and dO (all contiguous, one dtype); delta =
    rowsum(dO * O), 0 past q_len, is what :func:`flash_bwd_dkv` reads. A
    CPU tensor takes :func:`flash_bwd_dq_reference`; a CUDA tensor launches
    the kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, o, lse, do, q_lens, kv_lens,
                                      causal, sm_scale)
    dims = _check_bwd("flash_bwd_dq", q, k, v, do, causal, lse=lse)
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError("flash_bwd_dq: o must match q's shape and dtype")
    _check_ptrs("flash_bwd_dq", q.device, o=o)
    B, H, Hkv, Tq, Tk, D = dims
    ql, kl = _cuda_lens(q_lens, kv_lens, B, Tq, Tk, q.device)
    Dp = kernel_width(D)
    qp, kp, vp, op, dop = _pad_heads(Dp, q, k, v, o, do)
    dq = torch.empty_like(qp)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch("flash_bwd", "avsr_flash_bwd_dq",
            [qp, kp, vp, op, lse, dop, ql, kl, dq, delta],
            (B, H, Hkv, Tq, Tk, Dp), q.dtype, causal, _scale(sm_scale, D), q.device)
    global dq_launches
    dq_launches += 1
    (dq,) = _cut_heads(D, dq)
    return dq, delta


def flash_bwd_dkv(q, k, v, lse, delta, do, q_lens=None, kv_lens=None,
                  causal: bool = False, sm_scale: float | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B,Hkv,Tk,D] in k's and v's dtype, from the forward's q, k,
    v and lse, the delta of :func:`flash_bwd_dq` and dO. A CPU tensor takes
    :func:`flash_bwd_dkv_reference`; a CUDA tensor launches the kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, lse, delta, do, q_lens,
                                       kv_lens, causal, sm_scale)
    dims = _check_bwd("flash_bwd_dkv", q, k, v, do, causal, lse=lse,
                      delta=delta)
    B, H, Hkv, Tq, Tk, D = dims
    ql, kl = _cuda_lens(q_lens, kv_lens, B, Tq, Tk, q.device)
    Dp = kernel_width(D)
    qp, kp, vp, dop = _pad_heads(Dp, q, k, v, do)
    dk = torch.empty_like(kp)
    dv = torch.empty_like(vp)
    _launch("flash_bwd", "avsr_flash_bwd_dkv",
            [qp, kp, vp, lse, delta, dop, ql, kl, dk, dv],
            (B, H, Hkv, Tq, Tk, Dp), q.dtype, causal, _scale(sm_scale, D), q.device)
    global dkv_launches
    dkv_launches += 1
    dk, dv = _cut_heads(D, dk, dv)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """O = flash attention of (q, k, v) with the kernels' backward, the
    counterpart of the JAX ``_flash_core`` custom VJP: the forward launches
    ``flash_fwd`` and saves q, k, v, O and lse; the backward launches the
    dQ and dK/dV kernels. On CPU tensors the same Function runs the plain
    versions. ``FlashAttention.apply(q, k, v, q_lens, kv_lens, causal,
    sm_scale)``; q, k, v contiguous."""

    @staticmethod
    def forward(ctx, q, k, v, q_lens, kv_lens, causal, sm_scale):
        o, lse = flash_attention(q, k, v, q_lens, kv_lens, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (q_lens, kv_lens, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # dO arrives as the gradient of a transpose-reshape in the model:
        # not contiguous, and the kernels read it by rows
        do = do.contiguous()
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def ring_span(sp, Tq: int, Tk: int | None = None,
              kv_valid: torch.Tensor | None = None) -> tuple[int, int] | None:
    """This rank's chunk [c0, c1) of a block stack over ``Tq`` query and
    ``Tk`` (default Tq) key positions under the sp group ``sp``, or None.
    The JAX package's ring predicate: with an sp group above 1 the stack
    rings when no ``kv_valid`` mask is set, Tq == Tk and T % sp == 0;
    otherwise it runs unsharded, and the reason is logged once, in JAX's
    words."""
    if sp is None or sp.size == 1:
        return None
    Tk = Tq if Tk is None else Tk
    n = sp.size
    if kv_valid is None and Tq == Tk and Tq % n == 0:
        c = Tq // n
        return sp.rank * c, (sp.rank + 1) * c
    reason = ("kv_valid mask set" if kv_valid is not None
              else f"Tq={Tq} != Tk={Tk}" if Tq != Tk
              else f"T={Tq} %% sp={n} != 0")
    if reason not in _ring_fallback_warned:
        _ring_fallback_warned.add(reason)
        logging.getLogger("avsr.ops.attention").warning(
            "mesh.sp=%d configured but ring attention fell back to the "
            "non-ring path at this site (%s) — the sp axis buys nothing "
            "here.", n, reason)
    return None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, q_lens: torch.Tensor | None = None,
              kv_lens: torch.Tensor | None = None,
              kv_valid: torch.Tensor | None = None,
              sm_scale: float | None = None,
              use_kernel: str = "auto", sp=None) -> torch.Tensor:
    """The flash kernels where the JAX package would take its Pallas kernel
    (Tq and Tk >= 256, no ``kv_valid`` mask, a head width that is a multiple
    of 64: :func:`kernel_takes`), through :class:`FlashAttention` so that
    gradients flow; else :func:`mha_reference`. ``use_kernel``: "auto" (the
    kernel for CUDA tensors), "always", or "never" — the counterpart of
    ``use_pallas``.

    ``sp`` (an sp group above 1): q, k and v are this rank's chunks of a
    sequence the stack sharded (:func:`ring_span`), ``q_lens`` and
    ``kv_lens`` global; ring attention over the group (counted in
    ``ring_dispatch_count``)."""
    if use_kernel not in ("auto", "always", "never"):
        raise ValueError(f"use_kernel must be auto|always|never, got {use_kernel!r}")
    if sp is not None and sp.size > 1:
        from avsr_tpu_torch.ops.ring_attention import ring_attention

        global ring_dispatch_count
        ring_dispatch_count += 1
        return ring_attention(q, k, v, group=sp, causal=causal, kv_lens=kv_lens,
                              q_lens=q_lens, sm_scale=sm_scale, use_kernel=use_kernel)
    want = use_kernel == "always" or (use_kernel == "auto" and q.is_cuda)
    if (want and kv_valid is None and kernel_takes(q.shape[-1])
            and q.shape[2] >= MIN_KERNEL_SEQ and k.shape[2] >= MIN_KERNEL_SEQ):
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), q_lens, kv_lens, causal,
                                    sm_scale)
    return mha_reference(q, k, v, causal=causal, q_lens=q_lens,
                         kv_lens=kv_lens, kv_valid=kv_valid, sm_scale=sm_scale)
