"""Batched generation from an embeddings prefix, the port of
``avsr_tpu/infer/generate.py::generate_tokens`` (greedy and
temperature/top-p sampling).

  * prefill — one ``llama_apply`` over the packed [prompt][features] prefix
    (right-padded, per-sample lengths), which writes the KV cache;
  * decode — a loop of single-token steps with per-sample write positions,
    greedy or temperature + top-p, that stops once every row has emitted
    EOS.

Quantized serving: ``prepare_params_for_decode`` gives the decode layout
(fused q|k|v and gate|up, optionally an int8/int4 lm head), and
``kv_cache_dtype="int8"`` quantizes the cache after the prefill. With
quantized weights every product of the decode step and the head goes
through the Hopper kernels of ``ops/qmatmul.py``.

The loop is eager PyTorch and reads ``done.all()`` on the host once per
token; capturing the step in a CUDA graph is later work. Beam search,
speculative decoding and the streaming continuation are still to be
ported.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from avsr_tpu_torch.core.config import ModelConfig
from avsr_tpu_torch.models import llama as L
from avsr_tpu_torch.models.avsr import Batch, build_prefix, encode
from avsr_tpu_torch.models.layers import Params
from avsr_tpu_torch.ops.quant import quantize_llm

NEG_INF = -1e30


class GenOut(NamedTuple):
    tokens: torch.Tensor     # [B, max_new] generated ids (eos after EOS)
    lengths: torch.Tensor    # [B] valid generated tokens (incl. EOS)


def prepare_params_for_decode(params: Params, model_cfg: ModelConfig,
                              lm_head_bits: int = 0) -> Params:
    """The one-time inference layout: q|k|v and gate|up of the LLM fused
    (``llama.fuse_decode_layout``), so a decode step makes 4 projection
    products per layer instead of 7, and with ``lm_head_bits``
    (decode.lm_head_bits) the hidden -> vocab projection quantized
    (``quantize_llm``; its scale stays f32)."""
    llm = params["llm"]
    if lm_head_bits:
        llm = quantize_llm(llm, 0, lm_head_bits=lm_head_bits)
    return {**params, "llm": L.fuse_decode_layout(llm)}


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the nucleus; keeps at least the top-1 token."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    k = (cum - probs < top_p).sum(dim=-1, keepdim=True)      # >= 1
    thresh = torch.gather(sorted_logits, -1, k - 1)
    return torch.where(logits < thresh, NEG_INF, logits)


def _sample_or_greedy(logits: torch.Tensor, temperature: float, top_p: float,
                      generator: torch.Generator | None) -> torch.Tensor:
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_p < 1.0:
        logits = _top_p_filter(logits, top_p)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate_tokens(params: Params, model_cfg: ModelConfig, batch: Batch, *,
                    max_new_tokens: int = 100, temperature: float = 0.0,
                    top_p: float = 0.9, eos_id: int = 2,
                    generator: torch.Generator | None = None,
                    compute_dtype: torch.dtype = torch.float32,
                    use_kernel: str = "auto", kv_cache_dtype: str = "bfloat16",
                    stats: dict | None = None) -> GenOut:
    """Greedy (temperature=0) or nucleus-sampled generation.

    ``generator`` (on the batch's device) drives sampling; without it the
    call is greedy. ``use_kernel`` picks the kernels of the attention and
    of the quantized products. ``kv_cache_dtype="int8"`` quantizes the KV
    cache after the prefill (``llama.quantize_cache``); the decoded rows
    reuse the prefill's scales. ``stats``, when given, receives the phase
    times in seconds (``encode_s``, ``prefill_s``, ``decode_s``, each
    ending in a device synchronize), ``decode_steps`` and the last-position
    prefill logits (``prefill_logits`` [B, V] f32)."""
    dt = compute_dtype
    cfg = model_cfg.llm
    lora = model_cfg.lora if model_cfg.lora.use_lora else None
    t0 = time.perf_counter()
    enc = encode(params, model_cfg, batch, compute_dtype=dt, use_kernel=use_kernel)
    prefix, prefix_lens = build_prefix(params, model_cfg, batch, enc,
                                       compute_dtype=dt)
    dev = prefix.device
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
        stats["encode_s"] = t1 - t0
        t0 = t1
    B, Tpre = prefix.shape[:2]
    # cache positions rounded up to 128, as the JAX package sizes its cache
    M = -(-(Tpre + max_new_tokens) // 128) * 128
    hidden, cache = L.llama_apply(
        params["llm"], cfg, inputs_embeds=prefix, lengths=prefix_lens, lora=lora,
        compute_dtype=dt, use_kernel=use_kernel, return_cache=True, cache_len=M,
        output="hidden")
    if kv_cache_dtype == "int8":
        cache = L.quantize_cache(cache)
    elif kv_cache_dtype != "bfloat16":
        raise ValueError(f"kv_cache_dtype must be bfloat16|int8, got {kv_cache_dtype!r}")
    # project only the last valid position to vocab (avoids [B, Tpre, V])
    h_last = hidden[torch.arange(B, device=dev), prefix_lens.long() - 1][:, None]
    logits = L.compute_logits(params["llm"], cfg, h_last, use_kernel)[:, 0]
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
        stats["prefill_logits"] = logits.clone()
        t0 = t1

    tokens = torch.full((B, max_new_tokens), eos_id, dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    cur = prefix_lens.long()
    steps = 0
    for step in range(max_new_tokens):
        nxt = _sample_or_greedy(logits, temperature, top_p, generator)
        nxt = torch.where(done, eos_id, nxt)
        tokens[:, step] = nxt
        done |= nxt == eos_id
        # The last token needs no forward pass after it.
        if step + 1 == max_new_tokens or bool(done.all()):
            break
        emb = L.embed_tokens(params["llm"], nxt[:, None], dt)
        logits, cache = L.llama_decode_step(params["llm"], cfg, x=emb, cache=cache,
                                            cur_lens=cur, lora=lora,
                                            compute_dtype=dt, use_kernel=use_kernel)
        cur = cur + 1
        steps += 1
    if stats is not None:
        _sync(dev)
        stats["decode_s"] = time.perf_counter() - t0
        stats["decode_steps"] = steps

    is_eos = tokens == eos_id
    first_eos = is_eos.int().argmax(dim=-1)
    lengths = torch.where(is_eos.any(dim=-1), first_eos + 1, max_new_tokens)
    return GenOut(tokens, lengths.to(torch.int32))
