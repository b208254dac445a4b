"""Attention ops: plain PyTorch references + the Hopper flash-attention kernel.

The counterpart of ``avsr_tpu/ops/attention.py``:

  * ``mha_reference`` — masked multi-head attention in plain PyTorch (f32
    scores), the port of the JAX ``mha_reference``. It serves every shape
    the kernel does not take (CLIP at T=50, ``kv_valid`` masks).
  * ``flash_attention`` — the wrapper of the CUDA kernel
    ``csrc/flash_fwd.cu`` (the port of the Pallas ``_flash_fwd_kernel``):
    returns O and the per-row logsumexp. For a CUDA tensor it launches the
    kernel or raises; only a CPU tensor takes the plain version,
    ``flash_attention_reference``.
  * ``attention`` — the dispatch, with the JAX package's predicate.

All shapes are [batch, heads, seq, head_dim]; GQA needs H % Hkv == 0.
Rows at or past ``q_len`` and rows with no valid key give O = 0 (and
lse = +inf) in every function here.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

# Launches of the CUDA kernel (incremented once per launch, nowhere else).
launches = 0

# Kernel dispatch thresholds of the JAX package (attention.py:565-571). They
# were set on a TPU, where the Pallas kernel loses to XLA below ~256 tokens;
# the port keeps them as the reference's rule until measured on the card.
MIN_KERNEL_SEQ = 256


def _lens(lens: torch.Tensor | None, n: int, batch: int,
          device: torch.device) -> torch.Tensor:
    if lens is None:
        return torch.full((batch,), n, dtype=torch.int32, device=device)
    return lens.to(device=device, dtype=torch.int32)


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
    scale = sm_scale if sm_scale is not None else D ** -0.5
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


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_lens: torch.Tensor | None = None, kv_lens: torch.Tensor | None = None,
    causal: bool = False, sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: (O [B,H,Tq,D] in q's dtype,
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
    scale = sm_scale if sm_scale is not None else D ** -0.5
    dev = q.device
    ql = _lens(q_lens, Tq, B, dev).clamp(0, Tq)
    kl = _lens(kv_lens, Tk, B, dev).clamp(0, Tk)
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale     # [B,H,Tq,Tk]
    qi = torch.arange(Tq, device=dev)
    kj = torch.arange(Tk, device=dev)
    mask = (kj[None, :] < kl[:, None])[:, None, None, :]           # [B,1,1,Tk]
    mask = mask & (qi[None, :] < ql[:, None])[:, None, :, None]    # [B,1,Tq,Tk]
    if causal:
        mask = mask & (kj[None, :] <= qi[:, None])[None, None]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    valid = torch.isfinite(m)                                      # [B,H,Tq,1]
    p = torch.exp(s - torch.where(valid, m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vf)
    o = torch.where(valid, o / torch.where(valid, l, 1.0), 0.0)
    lse = torch.where(valid, m + torch.log(l), float("inf"))[..., 0]
    return o.to(q.dtype), lse


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _kernel_fn():
    from avsr_tpu_torch.ops import _build

    fn = _build.load("flash_fwd").avsr_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_lens: torch.Tensor | None = None, kv_lens: torch.Tensor | None = None,
    causal: bool = False, sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: (O [B,H,Tq,D], lse [B,H,Tq] f32).

    q: [B,H,Tq,D], k/v: [B,Hkv,Tk,D], contiguous, bfloat16 or float32,
    D in {64, 128}; causal needs Tq == Tk. Ragged tails (q_lens, kv_lens)
    are masked inside the kernel; nothing is padded. A CPU tensor takes
    :func:`flash_attention_reference`; a CUDA tensor launches the kernel
    (on the current stream) or raises."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, q_lens, kv_lens, causal,
                                         sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA, not {q.device}")
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bfloat16 or float32 operands "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in (64, 128) or k.shape != (B, Hkv, Tk, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}: need "
                         "D in (64, 128) and k, v of one shape")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if causal and Tq != Tk:
        raise ValueError(f"causal flash attention needs Tq == Tk, got {Tq}, {Tk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")
    ql = _lens(q_lens, Tq, B, q.device).contiguous()
    kl = _lens(kv_lens, Tk, B, q.device).contiguous()
    if ql.shape != (B,) or kl.shape != (B,):
        raise ValueError("q_lens and kv_lens must have shape [B]")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           ql.data_ptr(), kl.data_ptr(), out.data_ptr(),
                           lse.data_ptr(), B, H, Hkv, Tq, Tk, D,
                           _DTYPES[q.dtype], int(causal), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out, lse


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, q_lens: torch.Tensor | None = None,
              kv_lens: torch.Tensor | None = None,
              kv_valid: torch.Tensor | None = None,
              sm_scale: float | None = None,
              use_kernel: str = "auto") -> torch.Tensor:
    """The flash kernel where the JAX package would take its Pallas kernel
    (head_dim % 64 == 0, Tq and Tk >= 256, no ``kv_valid`` mask), else
    :func:`mha_reference`. ``use_kernel``: "auto" (the kernel for CUDA
    tensors), "always", or "never" — the counterpart of ``use_pallas``."""
    if use_kernel not in ("auto", "always", "never"):
        raise ValueError(f"use_kernel must be auto|always|never, got {use_kernel!r}")
    want = use_kernel == "always" or (use_kernel == "auto" and q.is_cuda)
    if (want and kv_valid is None and q.shape[-1] % 64 == 0
            and q.shape[2] >= MIN_KERNEL_SEQ and k.shape[2] >= MIN_KERNEL_SEQ):
        out, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                 q_lens, kv_lens, causal, sm_scale)
        return out
    return mha_reference(q, k, v, causal=causal, q_lens=q_lens,
                         kv_lens=kv_lens, kv_valid=kv_valid, sm_scale=sm_scale)
