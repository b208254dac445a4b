"""Llama-family causal LM with LoRA and a KV cache, the port of
``avsr_tpu/models/llama.py`` (dense FFN, 2-D LoRA adapters).

GQA attention (n_kv_heads <= n_heads), RoPE (rotate-half, HF convention),
RMSNorm, SiLU-gated MLP, tied embeddings. ``llama_apply`` runs the full
causal sequence (the prefill; its attention is the flash kernel at
T >= 256) and can write the KV cache; ``llama_decode_step`` is the
single-token step, whose attention stays plain PyTorch because the JAX
package leaves it to XLA.

Cache layout: ``[L, B, Hkv, M, Dh]`` (position-major, the natural layout
for torch matmuls; the JAX package's position-minor ``[.., Dh, M]`` was
chosen for TPU lanes). ``llama_decode_step`` writes the new column IN
PLACE into the cache it is given and returns that same cache.

Still to be ported: MoE FFN layers, the pipeline path, the fused decode
layout, the int8 cache, and the prefill-continue / split-cache steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from avsr_tpu_torch.core.config import LLMConfig, LoRAConfig
from avsr_tpu_torch.models.layers import Params, normal_init, rms_norm
from avsr_tpu_torch.ops.attention import attention

# Vocab rows per chunk when bf16 logits are accumulated in f32 (bounds the
# f32 copy of the head that is live at once to ~134 MB at d=2048).
LOGITS_CHUNK = 16384


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., T] -> (cos, sin) each [..., T, head_dim] f32 (the
    half-dim frequencies duplicated, used with rotate_half)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv_t = torch.from_numpy(np.asarray(inv, dtype=np.float32)).to(positions.device)
    ang = positions.float()[..., None] * inv_t
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, T, D]; cos/sin [B, T, D] or [T, D], cast to x.dtype first."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, None].to(x.dtype)
    sin = sin[:, None].to(x.dtype)
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


# ---------------------------------------------------------------------------
# Projections with optional LoRA
# ---------------------------------------------------------------------------

def proj(p: Params, x: torch.Tensor, *, lora_scale: float = 0.0) -> torch.Tensor:
    """x @ W (no bias) + lora_scale * (x @ a) @ b when the node has LoRA,
    in x.dtype."""
    dt = x.dtype
    y = torch.matmul(x, p["w"].to(dt))
    if lora_scale and "lora" in p:
        a, b = p["lora"]["a"], p["lora"]["b"]
        if a.ndim != 2:
            raise NotImplementedError("per-row LoRA adapter banks are not yet ported")
        y = y + lora_scale * torch.matmul(torch.matmul(x, a.to(dt)), b.to(dt))
    return y


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_llama(gen: torch.Generator, cfg: LLMConfig,
               dtype: torch.dtype = torch.float32) -> Params:
    if cfg.moe_experts:
        raise NotImplementedError("MoE LLM layers are not yet ported")
    d = cfg.d_model
    hd = d // cfg.n_heads
    kvd = cfg.n_kv_heads * hd
    dev = gen.device

    def lin(din: int, dout: int) -> Params:
        return {"w": normal_init(gen, (din, dout), std=0.02, dtype=dtype)}

    def ones() -> Params:
        return {"scale": torch.ones((d,), dtype=dtype, device=dev)}

    layers = [{
        "ln_attn": ones(),
        "q": lin(d, d), "k": lin(d, kvd), "v": lin(d, kvd), "o": lin(d, d),
        "ln_mlp": ones(),
        "gate": lin(d, cfg.ffn_dim), "up": lin(d, cfg.ffn_dim),
        "down": lin(cfg.ffn_dim, d),
    } for _ in range(cfg.n_layers)]
    params: Params = {
        "embed": normal_init(gen, (cfg.vocab_size, d), std=0.02, dtype=dtype),
        "layers": layers,
        "ln_f": ones(),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = lin(d, cfg.vocab_size)
    return params


_LORA_NAMES = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o",
               "gate_proj": "gate", "up_proj": "up", "down_proj": "down"}


def add_lora(gen: torch.Generator, params: Params, cfg: LLMConfig,
             lora: LoRAConfig, dtype: torch.dtype = torch.float32) -> Params:
    """Attach LoRA adapters (a ~ N(0, 1/r) * init_scale, b = 0) to the
    target projections; returns a new tree sharing the base weights."""
    del cfg
    targets = [_LORA_NAMES.get(t, t) for t in lora.target_modules]
    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        for t in targets:
            if t not in layer:
                continue
            w = layer[t]["w"]
            a = normal_init(gen, (w.shape[0], lora.r), std=1.0 / lora.r,
                            dtype=dtype) * lora.init_scale
            b = torch.zeros((lora.r, w.shape[1]), dtype=dtype, device=w.device)
            layer[t] = {"w": w, "lora": {"a": a, "b": b}}
        layers.append(layer)
    return {**params, "layers": layers}


def lora_scale(lora: LoRAConfig | None) -> float:
    return lora.alpha / lora.r if lora is not None and lora.use_lora else 0.0


def _proj_qkv(layer: Params, h: torch.Tensor, ls: float):
    return (proj(layer["q"], h, lora_scale=ls),
            proj(layer["k"], h, lora_scale=ls),
            proj(layer["v"], h, lora_scale=ls))


def _proj_mlp(layer: Params, h: torch.Tensor, ls: float) -> torch.Tensor:
    """silu(gate) * up."""
    return (F.silu(proj(layer["gate"], h, lora_scale=ls))
            * proj(layer["up"], h, lora_scale=ls))


def _ffn(layer: Params, x: torch.Tensor, cfg: LLMConfig, ls: float) -> torch.Tensor:
    """Post-attention SwiGLU residual: x + down(silu(gate) * up)(ln(x))."""
    h = rms_norm(layer["ln_mlp"], x, eps=cfg.rms_eps)
    return x + proj(layer["down"], _proj_mlp(layer, h, ls), lora_scale=ls)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Decode cache [L, B, Hkv, M, Dh], updated in place by decode steps."""

    k: torch.Tensor
    v: torch.Tensor


def init_cache(cfg: LLMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> KVCache:
    hd = cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Full sequence (prefill)
# ---------------------------------------------------------------------------

def _block(layer: Params, x: torch.Tensor, cos, sin, cfg: LLMConfig,
           lengths: torch.Tensor | None, ls: float, use_kernel: str):
    B, T, d = x.shape
    hd = d // cfg.n_heads
    h = rms_norm(layer["ln_attn"], x, eps=cfg.rms_eps)
    q, k, v = _proj_qkv(layer, h, ls)
    q = q.reshape(B, T, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attention(q, k, v, causal=True, q_lens=lengths, kv_lens=lengths,
                     use_kernel=use_kernel)
    attn = attn.transpose(1, 2).reshape(B, T, d)
    x = x + proj(layer["o"], attn, lora_scale=ls)
    return _ffn(layer, x, cfg, ls), (k, v)


def llama_apply(params: Params, cfg: LLMConfig, *, inputs_embeds: torch.Tensor,
                lengths: torch.Tensor | None = None,
                lora: LoRAConfig | None = None,
                compute_dtype: torch.dtype = torch.float32,
                use_kernel: str = "auto", return_cache: bool = False,
                cache_len: int | None = None,
                output: str = "logits") -> tuple[torch.Tensor, KVCache | None]:
    """Full causal forward over [B, T, d] embeddings -> (logits [B,T,V] or
    final normed hidden [B,T,d] with ``output="hidden"``, cache or None).

    ``return_cache`` writes each layer's post-RoPE K/V into a cache of
    ``cache_len`` positions (default T) in ``compute_dtype``."""
    B, T, d = inputs_embeds.shape
    if T > cfg.max_seq_len:
        raise ValueError(
            f"sequence length {T} exceeds llm.max_seq_len={cfg.max_seq_len}")
    x = inputs_embeds.to(compute_dtype)
    cos, sin = rope_cos_sin(torch.arange(T, device=x.device), d // cfg.n_heads,
                            cfg.rope_theta)
    ls = lora_scale(lora)
    cache = (init_cache(cfg, B, cache_len or T, compute_dtype, x.device)
             if return_cache else None)
    for i, layer in enumerate(params["layers"]):
        x, (k, v) = _block(layer, x, cos, sin, cfg, lengths, ls, use_kernel)
        if cache is not None:
            cache.k[i, :, :, :T] = k
            cache.v[i, :, :, :T] = v
    x = rms_norm(params["ln_f"], x, eps=cfg.rms_eps)
    out = x if output == "hidden" else compute_logits(params, cfg, x)
    return out, cache


def _head_rows(params: Params, cfg: LLMConfig) -> torch.Tensor:
    """The output projection as [V, d] rows (the tied embedding, or the
    transposed untied head)."""
    head = params.get("lm_head")
    if cfg.tie_embeddings or head is None:
        return params["embed"]
    return head["w"].T


def compute_logits(params: Params, cfg: LLMConfig, x: torch.Tensor) -> torch.Tensor:
    """Final hidden -> f32 vocab logits, f32 accumulation.

    The JAX package multiplies at the wider of the two dtypes with an f32
    result; products of bf16 values are exact in f32, so both cases equal
    ``x.float() @ w.float()``. A non-f32 head is upcast one vocab chunk at
    a time, so no f32 copy of the whole head is ever live."""
    w = _head_rows(params, cfg)
    xf = x.float()
    if w.dtype == torch.float32:
        return torch.matmul(xf, w.T)
    out = torch.empty((*x.shape[:-1], w.shape[0]), dtype=torch.float32,
                      device=x.device)
    for s in range(0, w.shape[0], LOGITS_CHUNK):
        e = min(s + LOGITS_CHUNK, w.shape[0])
        out[..., s:e] = torch.matmul(xf, w[s:e].float().T)
    return out


def embed_tokens(params: Params, tokens: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather the rows first, then cast (the table is cast once at load)."""
    return params["embed"][tokens].to(dtype)


# ---------------------------------------------------------------------------
# Single decode step with KV cache
# ---------------------------------------------------------------------------

def _gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_lens: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention: q [B,H,1,D] vs cache k/v [B,Hkv,M,D].

    Query heads are grouped over their kv head (no repeat of K/V). Scores
    and outputs accumulate in f32 from exact products of the cache dtype,
    as the JAX einsums with preferred_element_type=f32 do; q is scaled in
    f32 and then cast to the cache dtype, as there."""
    B, H, _, D = q.shape
    Hkv, M = k.shape[1], k.shape[2]
    qg = (q.float() * (D ** -0.5)).to(k.dtype).reshape(B, Hkv, H // Hkv, D)
    s = torch.matmul(qg.float(), k.float().transpose(-1, -2))      # [B,Hkv,g,M]
    mask = (torch.arange(M, device=q.device)[None, :] < kv_lens[:, None])
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())             # [B,Hkv,g,D]
    return o.reshape(B, H, 1, D).to(q.dtype)


def llama_decode_step(params: Params, cfg: LLMConfig, *, x: torch.Tensor,
                      cache: KVCache, cur_lens: torch.Tensor,
                      lora: LoRAConfig | None = None,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> tuple[torch.Tensor, KVCache]:
    """One causal step for x [B, 1, d] at positions ``cur_lens`` [B]:
    writes its K/V into column cur_lens[b] of ``cache`` (in place), attends
    to cache[:cur_len + 1], and returns (logits [B, V] f32, cache)."""
    B = x.shape[0]
    d = cfg.d_model
    hd = d // cfg.n_heads
    x = x.to(compute_dtype)
    pos = cur_lens.long()
    cos, sin = rope_cos_sin(pos[:, None], hd, cfg.rope_theta)
    ls = lora_scale(lora)
    b_idx = torch.arange(B, device=x.device)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(layer["ln_attn"], x, eps=cfg.rms_eps)
        q, k, v = _proj_qkv(layer, h, ls)
        q = apply_rope(q.reshape(B, 1, cfg.n_heads, hd).transpose(1, 2), cos, sin)
        k = apply_rope(k.reshape(B, 1, cfg.n_kv_heads, hd).transpose(1, 2), cos, sin)
        v = v.reshape(B, 1, cfg.n_kv_heads, hd).transpose(1, 2)
        k_i, v_i = cache.k[i], cache.v[i]                          # views
        k_i[b_idx, :, pos] = k[:, :, 0].to(k_i.dtype)
        v_i[b_idx, :, pos] = v[:, :, 0].to(v_i.dtype)
        attn = _gqa_decode_attention(q, k_i, v_i, kv_lens=pos + 1)
        x = x + proj(layer["o"], attn.transpose(1, 2).reshape(B, 1, d),
                     lora_scale=ls)
        x = _ffn(layer, x, cfg, ls)
    x = rms_norm(params["ln_f"], x, eps=cfg.rms_eps)
    return compute_logits(params, cfg, x)[:, 0], cache
