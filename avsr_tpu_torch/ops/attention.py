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
  * ``attention`` — the dispatch, with the JAX package's predicate.

Every kernel wrapper takes its plain version for a CPU tensor, and for a
CUDA tensor launches its kernel (on the current stream) or raises. All
shapes are [batch, heads, seq, head_dim]; GQA needs H % Hkv == 0. Rows at
or past ``q_len`` and rows with no valid key give O = 0 (and lse = +inf)
in every function here, and a zero dQ.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

# Launches of each CUDA kernel (incremented once per launch, nowhere else).
launches = 0          # flash_fwd
dq_launches = 0       # flash_bwd dQ
dkv_launches = 0      # flash_bwd dK/dV

# Kernel dispatch thresholds of the JAX package (attention.py:565-571). They
# were set on a TPU, where the Pallas kernel loses to XLA below ~256 tokens;
# the port keeps them as the reference's rule until measured on the card.
MIN_KERNEL_SEQ = 256
# The head widths the CUDA kernels take: 64 (Whisper, HuBERT, CLIP, the
# LLM), 128, and 256 (the connectors' 8 heads over the 2048-wide LLM). The
# JAX rule sends every multiple of 64 to its kernel; the port sends 192 and
# 512 (no shipped config reaches them) to mha_reference.
KERNEL_HEAD_DIMS = (64, 128, 256)


def _lens(lens: torch.Tensor | None, n: int, batch: int,
          device: torch.device) -> torch.Tensor:
    if lens is None:
        return torch.full((batch,), n, dtype=torch.int32, device=device)
    return lens.to(device=device, dtype=torch.int32)


def _scale(sm_scale: float | None, D: int) -> float:
    return sm_scale if sm_scale is not None else D ** -0.5


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
    if D not in KERNEL_HEAD_DIMS or k.shape != (B, Hkv, Tk, D) or v.shape != k.shape:
        raise ValueError(f"{name} shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}: need "
                         f"D in {KERNEL_HEAD_DIMS} and k, v of one shape")
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
    with torch.cuda.device(dev):
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
    D in {64, 128, 256}; causal needs Tq == Tk. Ragged tails (q_lens, kv_lens)
    are masked inside the kernel; nothing is padded. A CPU tensor takes
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
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "avsr_flash_fwd", [q, k, v, ql, kl, out, lse],
            (B, H, Hkv, Tq, Tk, D), q.dtype, causal, _scale(sm_scale, D),
            q.device)
    global launches
    launches += 1
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
    B, H, _, Tq, Tk, D = dims
    ql, kl = _cuda_lens(q_lens, kv_lens, B, Tq, Tk, q.device)
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch("flash_bwd", "avsr_flash_bwd_dq",
            [q, k, v, o, lse, do, ql, kl, dq, delta], dims, q.dtype, causal,
            _scale(sm_scale, D), q.device)
    global dq_launches
    dq_launches += 1
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
    B, _, _, Tq, Tk, D = dims
    ql, kl = _cuda_lens(q_lens, kv_lens, B, Tq, Tk, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd", "avsr_flash_bwd_dkv",
            [q, k, v, lse, delta, do, ql, kl, dk, dv], dims, q.dtype, causal,
            _scale(sm_scale, D), q.device)
    global dkv_launches
    dkv_launches += 1
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

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, q_lens: torch.Tensor | None = None,
              kv_lens: torch.Tensor | None = None,
              kv_valid: torch.Tensor | None = None,
              sm_scale: float | None = None,
              use_kernel: str = "auto") -> torch.Tensor:
    """The flash kernels where the JAX package would take its Pallas kernel
    (Tq and Tk >= 256, no ``kv_valid`` mask) and the kernels take the head
    width (64, 128 or 256; JAX takes any multiple of 64), through
    :class:`FlashAttention` so that gradients flow; else
    :func:`mha_reference`. ``use_kernel``: "auto" (the kernel for CUDA
    tensors), "always", or "never" — the counterpart of ``use_pallas``."""
    if use_kernel not in ("auto", "always", "never"):
        raise ValueError(f"use_kernel must be auto|always|never, got {use_kernel!r}")
    want = use_kernel == "always" or (use_kernel == "auto" and q.is_cuda)
    if (want and kv_valid is None and q.shape[-1] in KERNEL_HEAD_DIMS
            and q.shape[2] >= MIN_KERNEL_SEQ and k.shape[2] >= MIN_KERNEL_SEQ):
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), q_lens, kv_lens, causal,
                                    sm_scale)
    return mha_reference(q, k, v, causal=causal, q_lens=q_lens,
                         kv_lens=kv_lens, kv_valid=kv_valid, sm_scale=sm_scale)
