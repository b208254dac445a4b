"""Shared transformer building blocks, the port of ``avsr_tpu/models/layers.py``.

Parameters are plain nested dicts of tensors with the JAX package's key
paths and layouts (dense ``w`` is [d_in, d_out]); apply functions are
plain functions over them. Matmuls run in the activation dtype; layer
norms keep f32 statistics and return the input dtype.

Init functions draw from an explicit ``torch.Generator`` and create their
tensors on that generator's device.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from avsr_tpu_torch.mesh.sharding import gather_tree
from avsr_tpu_torch.ops.attention import attention

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def xavier_uniform(gen: torch.Generator, shape: tuple[int, ...],
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    limit = (6.0 / (shape[0] + shape[-1])) ** 0.5
    return torch.empty(shape, dtype=dtype, device=gen.device).uniform_(
        -limit, limit, generator=gen)


def normal_init(gen: torch.Generator, shape: tuple[int, ...], std: float = 0.02,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=gen.device).normal_(
        0.0, std, generator=gen)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = True,
               dtype: torch.dtype = torch.float32) -> Params:
    """Linear layer params: w [d_in, d_out] xavier-uniform (+ b [d_out])."""
    p: Params = {"w": xavier_uniform(gen, (d_in, d_out), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def norm_init(gen: torch.Generator, dim: int, *,
              dtype: torch.dtype = torch.float32) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=gen.device),
            "b": torch.zeros((dim,), dtype=dtype, device=gen.device)}


# ---------------------------------------------------------------------------
# Primitive apply functions
# ---------------------------------------------------------------------------

def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b, computing in x.dtype."""
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def layer_norm(p: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics, output in x.dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["b"].float()
    return y.to(x.dtype)


def rms_norm(p: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (llama-style) with f32 statistics."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu, as Whisper and CLIP use it."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, T, H*D] -> [B, H, T, D]."""
    B, T, _ = x.shape
    return x.reshape(B, T, n_heads, -1).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] -> [B, T, H*D]."""
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


# ---------------------------------------------------------------------------
# Multi-head attention block (encoder-style, bidirectional, padding-masked)
# ---------------------------------------------------------------------------

def mha_init(gen: torch.Generator, d_model: int, *, k_bias: bool = True,
             dtype: torch.dtype = torch.float32) -> Params:
    return {
        "q": dense_init(gen, d_model, d_model, dtype=dtype),
        "k": dense_init(gen, d_model, d_model, bias=k_bias, dtype=dtype),
        "v": dense_init(gen, d_model, d_model, dtype=dtype),
        "o": dense_init(gen, d_model, d_model, dtype=dtype),
    }


def mha_apply(p: Params, x: torch.Tensor, *, n_heads: int,
              kv: torch.Tensor | None = None,
              lengths: torch.Tensor | None = None,
              kv_lengths: torch.Tensor | None = None,
              kv_valid: torch.Tensor | None = None,
              use_kernel: str = "auto") -> torch.Tensor:
    """Bidirectional self-attention (``kv`` None) or cross-attention over
    [B, T, D] activations. Queries past ``lengths`` and keys past
    ``kv_lengths`` (``lengths`` for self-attention) are masked;
    ``kv_valid`` [B, Tk] masks arbitrary key positions (it always takes
    mha_reference, as in JAX)."""
    src = x if kv is None else kv
    q = split_heads(dense(p["q"], x), n_heads)
    k = split_heads(dense(p["k"], src), n_heads)
    v = split_heads(dense(p["v"], src), n_heads)
    out = attention(q, k, v, q_lens=lengths,
                    kv_lens=kv_lengths if kv is not None else lengths,
                    kv_valid=kv_valid, use_kernel=use_kernel)
    return dense(p["o"], merge_heads(out))


# ---------------------------------------------------------------------------
# Pre-LN encoder block (Whisper/CLIP-style)
# ---------------------------------------------------------------------------

def encoder_block_init(gen: torch.Generator, d_model: int, ffn_dim: int, *,
                       k_bias: bool = True,
                       dtype: torch.dtype = torch.float32) -> Params:
    return {
        "attn": mha_init(gen, d_model, k_bias=k_bias, dtype=dtype),
        "ln1": norm_init(gen, d_model, dtype=dtype),
        "fc1": dense_init(gen, d_model, ffn_dim, dtype=dtype),
        "fc2": dense_init(gen, ffn_dim, d_model, dtype=dtype),
        "ln2": norm_init(gen, d_model, dtype=dtype),
    }


def encoder_block_apply(p: Params, x: torch.Tensor, *, n_heads: int,
                        lengths: torch.Tensor | None = None, act=gelu,
                        use_kernel: str = "auto") -> torch.Tensor:
    h = layer_norm(p["ln1"], x)
    x = x + mha_apply(p["attn"], h, n_heads=n_heads, lengths=lengths,
                      use_kernel=use_kernel)
    h = layer_norm(p["ln2"], x)
    return x + dense(p["fc2"], act(dense(p["fc1"], h)))


def gathered_block(p: Params, x: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`encoder_block_apply` with the block's sharded leaves (fsdp)
    gathered first: inside a remat'ed block the recomputation gathers them
    again rather than keeping them."""
    return encoder_block_apply(gather_tree(p), x, **kw)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def sinusoid_position_embedding(length: int, dim: int,
                                device: str | torch.device = "cpu") -> torch.Tensor:
    """Whisper-style sinusoidal PE [length, dim], f32."""
    log_timescale = math.log(10000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2, dtype=torch.float32,
                                                  device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=-1)
