"""Batched generation from an embeddings prefix, the port of
``avsr_tpu/infer/generate.py``.

  * prefill — one ``llama_apply`` over the packed [prompt][features] prefix
    (right-padded, per-sample lengths), which writes the KV cache;
  * decode — a loop of single-token steps with per-sample write positions,
    greedy or temperature + top-p, that stops once every row has emitted
    EOS (``generate_tokens``, through ``_decode_loop``);
  * streaming continuation — ``prefill_extend`` freezes a block into a
    persistent cache and ``generate_continue`` decodes from a frozen
    history plus a fresh tail (``llama_prefill_continue``);
  * beam — ``beam_search`` keeps the prefix cache [B]-rowed, shared by the
    W beams, and gathers only a per-beam suffix cache on beam switches
    (``llama_decode_step_split``), with length-normalised scores;
  * ``generate`` dispatches on the decode config (speculative decoding is
    ``infer/speculative.py``).

Quantized serving: ``prepare_params_for_decode`` gives the decode layout
(fused q|k|v and gate|up, optionally an int8/int4 lm head), and
``kv_cache_dtype="int8"`` quantizes the cache after the prefill (beam
search: the prefix cache). With quantized weights every product of at
most 64 rows (a decode step, a beam step of B*W rows) and the head goes
through the Hopper kernels of ``ops/qmatmul.py``.

The loops are eager PyTorch and read their stop condition on the host
once per token; capturing the step in a CUDA graph is later work.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from avsr_tpu_torch.core.config import DecodeConfig, ModelConfig
from avsr_tpu_torch.core.logging import trace_range
from avsr_tpu_torch.mesh.sharding import shard_params
from avsr_tpu_torch.models import llama as L
from avsr_tpu_torch.models.avsr import Batch, build_prefix, encode
from avsr_tpu_torch.models.layers import Params
from avsr_tpu_torch.ops.quant import quantize_llm

NEG_INF = -1e30


class GenOut(NamedTuple):
    tokens: torch.Tensor     # [B, max_new] generated ids (eos after EOS)
    lengths: torch.Tensor    # [B] valid generated tokens (incl. EOS)


def prepare_params_for_decode(params: Params, model_cfg: ModelConfig,
                              lm_head_bits: int = 0, mesh=None) -> Params:
    """The one-time inference layout: q|k|v and gate|up of the LLM fused
    (``llama.fuse_decode_layout``), so a decode step makes 4 projection
    products per layer instead of 7, and with ``lm_head_bits``
    (decode.lm_head_bits) the hidden -> vocab projection quantized
    (``quantize_llm``; its scale stays f32). With a ``mesh`` whose tp is
    above 1 the tree is cut to this rank's tp slices after the head is
    quantized (so its scales are one card's) and before the fusion (each
    rank fuses its own slices); what fsdp would shard stays whole."""
    llm = params["llm"]
    if lm_head_bits:
        llm = quantize_llm(llm, 0, lm_head_bits=lm_head_bits)
    params = {**params, "llm": llm}
    if mesh is not None:
        params = shard_params(params, mesh, axes=("tp",))
    return {**params, "llm": L.fuse_decode_layout(params["llm"])}


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
                    stats: dict | None = None, sp=None) -> GenOut:
    """Greedy (temperature=0) or nucleus-sampled generation.

    ``generator`` (on the batch's device) drives sampling; without it the
    call is greedy. ``use_kernel`` picks the kernels of the attention and
    of the quantized products. ``kv_cache_dtype="int8"`` quantizes the KV
    cache after the prefill (``llama.quantize_cache``); the decoded rows
    reuse the prefill's scales. ``stats``, when given, receives the phase
    times in seconds (``encode_s``, ``prefill_s``, ``decode_s``, each
    ending in a device synchronize), ``decode_steps`` and the last-position
    prefill logits (``prefill_logits`` [B, V] f32).

    ``sp`` (the mesh's sp group, as JAX threads its mesh) shards the
    sequences of the encoders' block stacks and of the prefill (ring
    attention), where JAX's ring engages; the prefill's cache holds every
    layer's K/V gathered whole, and the token loop runs unchanged on every
    rank of the group, which takes the same tokens."""
    dt = compute_dtype
    cfg = model_cfg.llm
    lora = model_cfg.lora if model_cfg.lora.use_lora else None
    t0 = time.perf_counter()
    enc = encode(params, model_cfg, batch, compute_dtype=dt, use_kernel=use_kernel,
                 moe_rowwise=True, sp=sp)
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
        output="hidden", moe_rowwise=True, sp=sp)
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

    out, _, steps = _decode_loop(params, model_cfg, logits, cache, prefix_lens.long(),
                                 max_new_tokens=max_new_tokens, temperature=temperature,
                                 top_p=top_p, eos_id=eos_id, generator=generator,
                                 dt=dt, use_kernel=use_kernel)
    if stats is not None:
        _sync(dev)
        stats["decode_s"] = time.perf_counter() - t0
        stats["decode_steps"] = steps
    return out


def _decode_loop(params: Params, model_cfg: ModelConfig, logits: torch.Tensor,
                 cache: L.KVCache, cur: torch.Tensor, *, max_new_tokens: int,
                 temperature: float, top_p: float, eos_id: int,
                 generator: torch.Generator | None, dt: torch.dtype,
                 use_kernel: str) -> tuple[GenOut, L.KVCache, int]:
    """The greedy/sampled token loop shared by ``generate_tokens`` and
    ``generate_continue``: from the ``logits`` [B, V] of the last prefilled
    position, single-token ``llama_decode_step``s over ``cache`` starting
    at positions ``cur`` [B]. Returns (tokens and lengths, the cache, the
    decode steps taken)."""
    cfg = model_cfg.llm
    lora = model_cfg.lora if model_cfg.lora.use_lora else None
    B, dev = logits.shape[0], logits.device
    tokens = torch.full((B, max_new_tokens), eos_id, dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    steps = 0
    with trace_range("avsr::decode_loop"):
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
    return GenOut(tokens, _lengths(tokens, eos_id)), cache, steps


def _lengths(tokens: torch.Tensor, eos_id: int) -> torch.Tensor:
    """Valid tokens per row of [..., N]: through the first EOS, else N."""
    is_eos = tokens == eos_id
    first_eos = is_eos.int().argmax(dim=-1)
    return torch.where(is_eos.any(dim=-1), first_eos + 1,
                       tokens.shape[-1]).to(torch.int32)


def _check_fits(cache: L.KVCache, base_lens: torch.Tensor, rows: int) -> None:
    M = cache.k.shape[3]
    need = int(base_lens.max()) + rows
    if need > M:
        raise ValueError(f"the cache holds {M} positions; this block needs {need}")


# ---------------------------------------------------------------------------
# Streaming continuation (chunked prefill + decode over a persistent cache)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def prefill_extend(params: Params, model_cfg: ModelConfig, cache: L.KVCache,
                   base_lens: torch.Tensor, embeds: torch.Tensor,
                   lens: torch.Tensor, *,
                   compute_dtype: torch.dtype = torch.float32,
                   use_kernel: str = "auto") -> L.KVCache:
    """Freeze a block into the persistent cache (streaming serving): one
    chunked prefill of ``embeds`` [B, T, d] (``lens`` valid rows) after
    ``base_lens`` frozen tokens, hidden states discarded. Returns the
    cache, extended in place; the new frozen length is ``base_lens +
    lens`` (the caller's bookkeeping)."""
    _check_fits(cache, base_lens, embeds.shape[1])
    _, cache = L.llama_prefill_continue(
        params["llm"], model_cfg.llm, x=embeds, cache=cache, base_lens=base_lens,
        tail_lens=lens, lora=model_cfg.lora if model_cfg.lora.use_lora else None,
        compute_dtype=compute_dtype, use_kernel=use_kernel)
    return cache


@torch.inference_mode()
def generate_continue(params: Params, model_cfg: ModelConfig, cache: L.KVCache,
                      base_lens: torch.Tensor, tail_embeds: torch.Tensor,
                      tail_lens: torch.Tensor, *, max_new_tokens: int = 100,
                      temperature: float = 0.0, top_p: float = 0.9,
                      eos_id: int = 2, generator: torch.Generator | None = None,
                      compute_dtype: torch.dtype = torch.float32,
                      use_kernel: str = "auto") -> tuple[GenOut, L.KVCache]:
    """Decode from a frozen history plus a fresh tail: a chunked prefill of
    ``tail_embeds`` [B, T, d] (``tail_lens`` valid rows) after
    ``base_lens`` cached tokens, then the token loop of
    ``generate_tokens``. A chunk costs O(tail + max_new_tokens), whatever
    the history; the frozen columns (< base_lens) are never rewritten, so
    the returned cache can seed the next chunk with a larger
    ``base_lens``. The cache must hold base_lens + T + max_new_tokens - 1
    positions (the last token is never written)."""
    dt = compute_dtype
    cfg = model_cfg.llm
    B, T = tail_embeds.shape[:2]
    _check_fits(cache, base_lens, T + max(max_new_tokens - 1, 0))
    hidden, cache = L.llama_prefill_continue(
        params["llm"], cfg, x=tail_embeds, cache=cache, base_lens=base_lens,
        tail_lens=tail_lens, lora=model_cfg.lora if model_cfg.lora.use_lora else None,
        compute_dtype=dt, use_kernel=use_kernel)
    last_row = (tail_lens.long() - 1).clamp(min=0)
    h_last = hidden[torch.arange(B, device=hidden.device), last_row][:, None]
    last = L.compute_logits(params["llm"], cfg, h_last, use_kernel)[:, 0]
    out, cache, _ = _decode_loop(
        params, model_cfg, last, cache, base_lens.long() + tail_lens.long(),
        max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
        eos_id=eos_id, generator=generator, dt=dt, use_kernel=use_kernel)
    return out, cache


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis of f32 ``x``: the k largest in
    descending order, ties broken toward the lower index (``torch.topk``
    promises no order among ties). Each value's bits become an integer
    key of the same order, joined with its reversed index into one unique
    int64 key."""
    n = x.shape[-1]
    bits = x.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    rev = n - 1 - torch.arange(n, device=x.device)
    idx = (key * (1 << 32) + rev).topk(k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


@torch.inference_mode()
def beam_search(params: Params, model_cfg: ModelConfig, batch: Batch, *,
                max_new_tokens: int = 100, num_beams: int = 5,
                length_penalty: float = 1.0, eos_id: int = 2,
                compute_dtype: torch.dtype = torch.float32,
                use_kernel: str = "auto", kv_cache_dtype: str = "bfloat16",
                stats: dict | None = None, sp=None) -> GenOut:
    """Length-normalised beam search over the embeddings prefix.

    The KV cache is split: the prefix cache keeps [B] rows (Mp = ceil128(
    prefix) columns), shared by the W beams and never gathered, and only a
    per-beam suffix cache of Ms = ceil128(max_new_tokens) columns is
    reindexed on beam switches (``llama_decode_step_split``, the pending
    K/V landed at the next gather by ``merge_new_columns``). Scoring is the
    JAX package's: log-probabilities summed per beam, finished beams
    extended only by EOS at no cost, the best beam picked by score /
    max(length, 1) ** ``length_penalty``; ``eos_id`` < 0 never finishes.
    ``kv_cache_dtype="int8"`` quantizes the prefix cache. ``stats`` takes
    the phase times (``encode_s``, ``prefill_s``, ``decode_s``),
    ``decode_steps``, ``prefill_logits`` and the final beam ``scores``
    [B, W]. ``sp`` shards the encoders and the prefill as in
    :func:`generate_tokens`."""
    dt = compute_dtype
    cfg = model_cfg.llm
    lora = model_cfg.lora if model_cfg.lora.use_lora else None
    W = num_beams
    t0 = time.perf_counter()
    enc = encode(params, model_cfg, batch, compute_dtype=dt, use_kernel=use_kernel,
                 moe_rowwise=True, sp=sp)
    prefix, prefix_lens = build_prefix(params, model_cfg, batch, enc, compute_dtype=dt)
    dev = prefix.device
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
        stats["encode_s"] = t1 - t0
        t0 = t1
    B, Tpre = prefix.shape[:2]
    Mp = -(-Tpre // 128) * 128
    Ms = -(-max_new_tokens // 128) * 128
    hidden, pre_cache = L.llama_apply(
        params["llm"], cfg, inputs_embeds=prefix, lengths=prefix_lens, lora=lora,
        compute_dtype=dt, use_kernel=use_kernel, return_cache=True, cache_len=Mp,
        output="hidden", moe_rowwise=True, sp=sp)
    h_last = hidden[torch.arange(B, device=dev), prefix_lens.long() - 1][:, None]
    last = L.compute_logits(params["llm"], cfg, h_last, use_kernel)[:, 0]
    if kv_cache_dtype == "int8":
        pre_cache = L.quantize_cache(pre_cache)
    elif kv_cache_dtype != "bfloat16":
        raise ValueError(f"kv_cache_dtype must be bfloat16|int8, got {kv_cache_dtype!r}")
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
        stats["prefill_logits"] = last.clone()
        t0 = t1

    hd = cfg.d_model // cfg.n_heads
    nkv = L.local_heads(cfg, L.llm_tp(params["llm"]))[1]
    suf_shape = (cfg.n_layers, B * W, nkv, Ms, hd)
    suf_cache = L.KVCache(torch.zeros(suf_shape, dtype=dt, device=dev),
                          torch.zeros(suf_shape, dtype=dt, device=dev))
    kv_pending = (torch.zeros(suf_shape[:3] + (hd,), dtype=dt, device=dev),) * 2
    V = last.shape[-1]
    # beam 0 real, the others -inf, so that step 0 takes the top W of beam 0
    scores = torch.full((B, W), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    tokens = torch.full((B, W, max_new_tokens), eos_id, dtype=torch.int64, device=dev)
    done = torch.zeros((B, W), dtype=torch.bool, device=dev)
    eos_only = torch.full((V,), NEG_INF, dtype=torch.float32, device=dev)
    eos_only[eos_id] = 0.0        # eos_id -1 marks the last column, as in JAX
    row0 = (torch.arange(B, device=dev) * W)[:, None]
    logits = last.repeat_interleave(W, dim=0)                          # [B*W, V]
    steps = 0
    for step in range(max_new_tokens):
        logp = torch.log_softmax(logits, dim=-1).reshape(B, W, V)
        logp = torch.where(done[..., None], eos_only, logp)
        scores, top_idx = _top_k((scores[..., None] + logp).reshape(B, W * V), W)
        src_beam = top_idx // V
        new_tok = top_idx % V
        gather = (row0 + src_beam).reshape(-1)                         # [B*W]
        suf_cache = L.merge_new_columns(suf_cache, *kv_pending, gather, step - 1)
        tokens = torch.take_along_dim(tokens, src_beam[..., None], dim=1)
        done = torch.take_along_dim(done, src_beam, dim=1)
        tokens[:, :, step] = torch.where(done, eos_id, new_tok)
        done = done | (new_tok == eos_id)
        # The last token needs no forward pass after it.
        if step + 1 == max_new_tokens or bool(done.all()):
            break
        emb = L.embed_tokens(params["llm"], new_tok.reshape(-1)[:, None], dt)
        logits, kv_pending = L.llama_decode_step_split(
            params["llm"], cfg, x=emb, prefix_cache=pre_cache, suffix_cache=suf_cache,
            prefix_lens=prefix_lens, step=step, lora=lora, compute_dtype=dt,
            use_kernel=use_kernel)
        steps += 1

    lens = _lengths(tokens, eos_id)                                    # [B, W]
    norm = scores / lens.float().clamp(min=1.0) ** length_penalty
    best = norm.argmax(dim=-1)
    b_idx = torch.arange(B, device=dev)
    if stats is not None:
        _sync(dev)
        stats["decode_s"] = time.perf_counter() - t0
        stats["decode_steps"] = steps
        stats["scores"] = scores
    return GenOut(tokens[b_idx, best], lens[b_idx, best])


def generate(params: Params, model_cfg: ModelConfig, batch: Batch,
             decode_cfg: DecodeConfig, *, eos_id: int,
             generator: torch.Generator | None = None,
             compute_dtype: torch.dtype = torch.float32, use_kernel: str = "auto",
             draft_params: Params | None = None,
             draft_model_cfg: ModelConfig | None = None,
             draft_shares_prefix: bool | None = None, sp=None) -> GenOut:
    """The decode config's protocol: speculative decoding when
    ``decode.speculative`` is set and a draft is given (built once by the
    caller: ``infer/speculative.py::make_draft_params``, or
    ``make_layerskip_draft`` with its ``draft_model_cfg``), beam search for
    ``num_beams`` > 1, else greedy or sampled ``generate_tokens``; each
    with the sp group ``sp``."""
    d = decode_cfg
    if d.speculative and draft_params is not None:
        from avsr_tpu_torch.infer.speculative import speculative_generate

        return speculative_generate(
            params, draft_params, model_cfg, batch, gamma=d.spec_gamma,
            max_new_tokens=d.max_new_tokens, temperature=d.temperature,
            top_p=d.top_p, generator=generator, eos_id=eos_id,
            compute_dtype=compute_dtype, use_kernel=use_kernel,
            draft_model_cfg=draft_model_cfg,
            draft_shares_prefix=draft_shares_prefix, sp=sp)
    if d.num_beams > 1:
        return beam_search(params, model_cfg, batch, max_new_tokens=d.max_new_tokens,
                           num_beams=d.num_beams, length_penalty=d.length_penalty,
                           eos_id=eos_id, compute_dtype=compute_dtype,
                           use_kernel=use_kernel, kv_cache_dtype=d.kv_cache_dtype, sp=sp)
    return generate_tokens(params, model_cfg, batch, max_new_tokens=d.max_new_tokens,
                           temperature=d.temperature, top_p=d.top_p, eos_id=eos_id,
                           generator=generator, compute_dtype=compute_dtype,
                           use_kernel=use_kernel, kv_cache_dtype=d.kv_cache_dtype, sp=sp)
