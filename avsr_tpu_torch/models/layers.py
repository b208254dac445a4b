"""Shared transformer building blocks, the port of ``avsr_tpu/models/layers.py``.

Parameters are plain nested dicts of tensors with the JAX package's key
paths and layouts (dense ``w`` is [d_in, d_out]); apply functions are
plain functions over them. Matmuls run in the activation dtype; layer
norms keep f32 statistics and return the input dtype.

Init functions draw from an explicit ``torch.Generator`` and create their
tensors on that generator's device.
"""

from __future__ import annotations

import logging
import math
from typing import Any

import torch
import torch.nn.functional as F

from avsr_tpu_torch.mesh.collectives import copy_to_tp, reduce_from_tp
from avsr_tpu_torch.mesh.sharding import gather_tree, tp_group
from avsr_tpu_torch.ops.attention import attention

Params = dict[str, Any]

log = logging.getLogger("avsr_tpu_torch.models")


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

def split_leaf(t: torch.Tensor, tp, dim: int = -1) -> torch.Tensor:
    """This tp rank's slice along ``dim`` of a replicated leaf that a
    Megatron block uses in parts (a column-parallel bias, a LoRA factor);
    its gradient is summed over the group (``copy_to_tp``), so it counts
    once. Without a group (None, or of one rank): ``t``."""
    if tp is None or tp.size == 1:
        return t
    return copy_to_tp(t, tp).chunk(tp.size, dim=dim)[tp.rank]


def dense(p: Params, x: torch.Tensor, tp=None, *, row: bool = False) -> torch.Tensor:
    """x @ w + b, computing in x.dtype. Under tensor parallelism (``tp``, a
    Megatron block's group) ``w`` is this rank's column slice, and the
    replicated bias is cut to the same columns; with ``row`` it is this
    rank's row slice over its slice of the input features, the partial
    products are summed over the group (``reduce_from_tp``) and the bias is
    added once, after the sum."""
    y = torch.matmul(x, p["w"].to(x.dtype))
    if row:
        y = reduce_from_tp(y, tp)
    if "b" in p:
        y = y + (p["b"] if row else split_leaf(p["b"], tp)).to(x.dtype)
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
              use_kernel: str = "auto", tp=None, sp=None) -> torch.Tensor:
    """Bidirectional self-attention (``kv`` None) or cross-attention over
    [B, T, D] activations. Queries past ``lengths`` and keys past
    ``kv_lengths`` (``lengths`` for self-attention) are masked;
    ``kv_valid`` [B, Tk] masks arbitrary key positions (it always takes
    mha_reference, as in JAX). Under tp (Megatron) q, k and v are
    column-parallel and o row-parallel: attention runs on the rank's
    ``n_heads / tp`` heads, and the result is summed over the group. Under
    sp (a group of a stack that sharded its sequence, ``ring_span``) x is
    this rank's chunk, ``lengths`` global, and attention is the ring."""
    src = x if kv is None else kv
    heads = n_heads // (tp.size if tp is not None else 1)
    q = split_heads(dense(p["q"], x, tp), heads)
    k = split_heads(dense(p["k"], src, tp), heads)
    v = split_heads(dense(p["v"], src, tp), heads)
    out = attention(q, k, v, q_lens=lengths,
                    kv_lens=kv_lengths if kv is not None else lengths,
                    kv_valid=kv_valid, use_kernel=use_kernel, sp=sp)
    return dense(p["o"], merge_heads(out), tp, row=True)


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
                        use_kernel: str = "auto", tp=None, sp=None) -> torch.Tensor:
    """A pre-LN block. Under tp (Megatron) it runs on this rank's slices:
    fc1 column-parallel, fc2 row-parallel (see :func:`mha_apply`), one
    all-reduce after the attention and one after the MLP (their backward:
    one all-reduce each of the normed inputs' gradients). Under sp x is
    this rank's chunk of the sequence and attention the ring."""
    h = copy_to_tp(layer_norm(p["ln1"], x), tp)
    x = x + mha_apply(p["attn"], h, n_heads=n_heads, lengths=lengths,
                      use_kernel=use_kernel, tp=tp, sp=sp)
    h = copy_to_tp(layer_norm(p["ln2"], x), tp)
    return x + dense(p["fc2"], act(dense(p["fc1"], h, tp)), tp, row=True)


_WHOLE_LOGGED: set[tuple[int, int]] = set()


def gathered_block(p: Params, x: torch.Tensor, *, n_heads: int, **kw) -> torch.Tensor:
    """One Whisper or CLIP block with its fsdp-sharded leaves gathered
    first (inside a remat'ed block the recomputation gathers them again
    rather than keeping them). Under tp it runs Megatron on its slices; a
    block whose heads do not divide by tp (CLIP-B/32's 12 at tp=8) gathers
    its tp slices too and runs whole, as the JAX package computes it,
    logged once per shape."""
    p = gather_tree(p, keep_tp=True)
    tp = tp_group(p)
    if tp is not None and n_heads % tp.size:
        if (n_heads, tp.size) not in _WHOLE_LOGGED:
            _WHOLE_LOGGED.add((n_heads, tp.size))
            log.warning("an encoder block's %d heads do not divide over tp=%d: "
                        "it gathers its slices and runs whole on every rank",
                        n_heads, tp.size)
        p, tp = gather_tree(p), None
    return encoder_block_apply(p, x, n_heads=n_heads, tp=tp, **kw)


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
