"""Lossless speculative decoding, the port of ``avsr_tpu/infer/speculative.py``:
a cheap draft proposes, the full model verifies.

  * a DRAFT model proposes ``gamma`` tokens autoregressively: by default
    the same LLM with int8/int4 weight-only projections and head
    (``make_draft_params``; its decode steps run the qmatmul kernels), or
    the target's first k blocks (``make_layerskip_draft``), or a separately
    trained smaller model (``cli/distill.py``) with its own prefix;
  * the TARGET verifies all gamma proposals in ONE chunked prefill pass
    (``llama_prefill_continue``) over gamma + 1 positions;
  * greedy: the longest prefix of proposals that matches the target's
    argmax is accepted, plus the target's own next token, so the output is
    token for token that of ``generate_tokens``; sampling: the rejection
    scheme of Leviathan et al., whose emitted stream is distributed as the
    target's sampling for any draft.

Both caches are indexed by position and the verify attention masks by
position, so the columns written for rejected proposals are dead until the
next round overwrites them.

The loop is eager PyTorch: a round is one optional catch-up draft step,
1 + gamma draft steps and one verify pass, and it reads its stop flags on
the host once per round. The randomness of sampling is drawn from a
``torch.Generator`` on the batch's device; the accept/replace decision
itself is a deterministic function of those draws (``rejection_draws``,
``rejection_apply``).
"""

from __future__ import annotations

import dataclasses

import torch

from avsr_tpu_torch.core.config import ModelConfig
from avsr_tpu_torch.infer.generate import GenOut, _top_p_filter
from avsr_tpu_torch.mesh.sharding import shard_params
from avsr_tpu_torch.models import llama as L
from avsr_tpu_torch.models.avsr import Batch, build_prefix, encode
from avsr_tpu_torch.models.layers import Params
from avsr_tpu_torch.ops.quant import is_quantized, quantize_llm


def _dist(logits: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """The sampling distribution: temperature, nucleus filter, softmax."""
    z = logits.float() / temperature
    if top_p < 1.0:
        z = _top_p_filter(z, top_p)
    return torch.softmax(z, dim=-1)


def _gumbel(shape: tuple[int, ...], generator: torch.Generator,
            device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def _categorical(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A draw from each row of ``probs`` (argmax of log-probs + Gumbel
    noise, as ``jax.random.categorical`` draws)."""
    g = _gumbel(tuple(probs.shape), generator, probs.device)
    return torch.argmax(torch.log(probs + 1e-30) + g, dim=-1)


def rejection_draws(B: int, G: int, V: int, generator: torch.Generator,
                    device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The randomness of one accept/replace decision: uniforms u [B, G]
    for the accept tests and Gumbel noise g [B, V] for the replacement
    draw (the JAX step draws ``uniform(ku, (B, G))`` and
    ``categorical(kr, x)`` = argmax(x + ``gumbel(kr, x.shape)``))."""
    u = torch.rand((B, G), generator=generator, device=device)
    return u, _gumbel((B, V), generator, device)


def rejection_apply(drafts: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                    u: torch.Tensor, g: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One speculative-sampling accept/replace decision (Leviathan et
    al.), given its draws. drafts [B, G] ~ q; q [B, G, V] the draft's
    sampling distributions; p [B, G+1, V] the target's. Returns (m [B]
    leading accepts, cand [B, G+1]) with cand[:, :m] the accepted drafts
    and cand[:, m] the replacement, drawn from max(p - q, 0) normalised,
    with q padded by zeros at the bonus slot (where that is p). The
    emitted stream is distributed as p for any q: q(x) min(1, p/q) +
    P(reject) resid(x) = p(x)."""
    B, G = drafts.shape
    qd = torch.gather(q, -1, drafts[..., None])[..., 0]
    pd = torch.gather(p[:, :G], -1, drafts[..., None])[..., 0]
    accept = u * qd < pd                          # u < min(1, p/q), division-free
    m = torch.cumprod(accept.int(), dim=1).sum(dim=1)
    q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], dim=1)
    rows = torch.arange(B, device=p.device)
    p_m, q_m = p[rows, m], q_pad[rows, m]
    resid = (p_m - q_m).clamp(min=0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rs > 1e-9, resid / rs, p_m)   # p == q: draw from p
    r = torch.argmax(torch.log(resid + 1e-30) + g, dim=-1)
    j = torch.arange(G + 1, device=p.device)[None, :]
    pad = torch.cat([drafts, drafts[:, -1:]], dim=1)
    return m, torch.where(j == m[:, None], r[:, None], pad)


def break_even_tokens_per_pass(model_cfg: ModelConfig, *, bits: int, gamma: int,
                               draft_layers: int = 0) -> float:
    """The tokens per verify pass that a speculative configuration must
    exceed to beat greedy decoding, by the JAX package's bandwidth model: a
    draft step costs (bits / 16) * (L_draft / L) of a bf16 target step and
    a verify pass about one target step, so a round costs gamma *
    cost_ratio + 1 target steps. The ceiling is gamma + 1; passing is
    necessary, not sufficient."""
    n_layers = model_cfg.llm.n_layers
    l_draft = draft_layers if draft_layers > 0 else n_layers
    return gamma * (bits / 16.0) * (l_draft / n_layers) + 1.0


def make_draft_params(params: Params, model_cfg: ModelConfig, bits: int = 8,
                      mesh=None) -> Params:
    """The self-draft: the same LLM with LoRA merged, its projections and
    its head quantized to ``bits`` and laid out for decode (q|k|v and
    gate|up fused), so a draft step makes 4 qmatmul launches per layer and
    one for the head. Takes the raw tree (unfused, unquantized) and refuses
    any other, as the JAX package does. Under a ``mesh`` with tp the
    quantized LLM is cut to this rank's tp slices before the fusion (the
    draft's encoders are the tree's own)."""
    llm = params["llm"]
    layer0 = llm["layers"][0]
    if "qkv" in layer0 or "gateup" in layer0:
        raise ValueError(
            "make_draft_params needs the raw params tree, not the fused "
            "decode layout (build the draft before "
            "prepare_params_for_decode)")
    if any(is_quantized(v) for v in layer0.values()):
        raise ValueError(
            "make_draft_params needs unquantized params (the target is "
            "already quantized; there is no cheaper self-draft to build "
            "— pass a layer-skip or separate draft instead)")
    if model_cfg.lora.use_lora:
        llm = L.merge_lora(llm, model_cfg.lora)
    llm = quantize_llm(llm, bits, lm_head_bits=bits)
    if mesh is not None:
        llm = shard_params({"llm": llm}, mesh, axes=("tp",))["llm"]
    return {**params, "llm": L.fuse_decode_layout(llm)}


def make_layerskip_draft(params: Params, model_cfg: ModelConfig,
                         n_layers: int) -> tuple[Params, ModelConfig]:
    """The early-exit self-draft: the target's first ``n_layers`` blocks
    with its final norm and head. The tree shares every tensor with the
    target; pass the returned (params, config) to
    :func:`speculative_generate`."""
    L_full = model_cfg.llm.n_layers
    if not 1 <= n_layers < L_full:
        raise ValueError(f"n_layers must be in [1, {L_full - 1}]")
    llm = {**params["llm"], "layers": list(params["llm"]["layers"])[:n_layers]}
    dcfg = dataclasses.replace(
        model_cfg, llm=dataclasses.replace(model_cfg.llm, n_layers=n_layers))
    return {**params, "llm": llm}, dcfg


def _prefill(params: Params, mc: ModelConfig, prefix: torch.Tensor,
             lens: torch.Tensor, extra: int, lora, dt: torch.dtype,
             use_kernel: str, sp=None) -> tuple[torch.Tensor, L.KVCache]:
    M = -(-(prefix.shape[1] + extra) // 128) * 128
    return L.llama_apply(params["llm"], mc.llm, inputs_embeds=prefix, lengths=lens,
                         lora=lora, compute_dtype=dt, use_kernel=use_kernel,
                         return_cache=True, cache_len=M, output="hidden",
                         moe_rowwise=True, sp=sp)


@torch.inference_mode()
def speculative_generate(params: Params, draft_params: Params, model_cfg: ModelConfig,
                         batch: Batch, *, gamma: int = 4, max_new_tokens: int = 100,
                         eos_id: int = 2, compute_dtype: torch.dtype = torch.float32,
                         use_kernel: str = "auto", draft_lora: bool = False,
                         return_stats: bool = False, temperature: float = 0.0,
                         top_p: float = 1.0, generator: torch.Generator | None = None,
                         draft_model_cfg: ModelConfig | None = None,
                         draft_shares_prefix: bool | None = None, sp=None):
    """Speculative generation in about 1 / (accepted + 1) as many target
    passes.

    ``temperature`` 0: greedy, token for token ``generate_tokens``.
    ``temperature`` > 0: speculative sampling (``rejection_apply``), whose
    stream is distributed as the target's sampling with the same
    temperature and top_p, for any draft; its draws come from
    ``generator`` (on the batch's device; a fresh one seeded 0 without it).

    ``draft_params`` may be any params tree; correctness never depends on
    it. A draft of another architecture passes ``draft_model_cfg``; a
    draft of the target's width reuses the target's prefix embeddings
    (``draft_shares_prefix``, by default when the widths match), any other
    encodes its own. ``draft_lora`` applies the LoRA config to the draft
    too (off for the self-draft, which merged it). ``return_stats`` also
    returns {``verify_passes``, ``tokens_per_pass`` (tokens past the
    prefill's first, per row and pass), ``draft_steps`` (single-token
    draft decode steps taken)}. ``sp`` (the mesh's sp group) shards the
    encoders' and both prefills' sequences, as JAX threads its mesh there;
    the verify passes and draft steps run whole on every rank."""
    dt = compute_dtype
    cfg = model_cfg.llm
    dcfg = draft_model_cfg or model_cfg
    dllm = dcfg.llm
    if dllm.vocab_size != cfg.vocab_size:
        raise ValueError(
            "draft and target must share a vocabulary "
            f"(draft {dllm.vocab_size} vs target {cfg.vocab_size})")
    if draft_shares_prefix is None:
        draft_shares_prefix = dllm.d_model == cfg.d_model
    if draft_shares_prefix and dllm.d_model != cfg.d_model:
        raise ValueError(
            "draft_shares_prefix requires matching d_model "
            f"({dllm.d_model} vs {cfg.d_model})")
    lora = model_cfg.lora if model_cfg.lora.use_lora else None
    dlora = (dcfg.lora if dcfg.lora.use_lora else None) if draft_lora else None
    G = gamma

    # target prefill, as in generate_tokens
    enc = encode(params, model_cfg, batch, compute_dtype=dt, use_kernel=use_kernel,
                 moe_rowwise=True, sp=sp)
    prefix, prefix_lens = build_prefix(params, model_cfg, batch, enc, compute_dtype=dt)
    dev = prefix.device
    B = prefix.shape[0]
    extra = max_new_tokens + G + 2
    hidden, t_cache = _prefill(params, model_cfg, prefix, prefix_lens, extra, lora, dt,
                               use_kernel, sp)
    b_idx = torch.arange(B, device=dev)
    last = L.compute_logits(params["llm"], cfg,
                            hidden[b_idx, prefix_lens.long() - 1][:, None], use_kernel)[:, 0]
    del hidden

    # draft prefill: the target's prefix, or the draft's own encoders
    if draft_shares_prefix:
        d_prefix, d_plens = prefix, prefix_lens
    else:
        d_enc = encode(draft_params, dcfg, batch, compute_dtype=dt, use_kernel=use_kernel,
                       moe_rowwise=True, sp=sp)
        d_prefix, d_plens = build_prefix(draft_params, dcfg, batch, d_enc,
                                         compute_dtype=dt)
    _, d_cache = _prefill(draft_params, dcfg, d_prefix, d_plens, extra, dlora, dt,
                          use_kernel, sp)
    del d_prefix, prefix

    P = prefix_lens.long()
    Pd = d_plens.long()
    sampling = temperature > 0.0
    if sampling and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if sampling:
        e0 = _categorical(_dist(last, temperature, top_p), generator)
    else:
        e0 = torch.argmax(last, dim=-1)
    Tbuf = max_new_tokens + G + 1
    tokens = torch.full((B, Tbuf), eos_id, dtype=torch.int64, device=dev)
    tokens[:, 0] = e0
    out_pos = torch.ones((B,), dtype=torch.int64, device=dev)
    done = (e0 == eos_id) | (max_new_tokens <= 1)
    # tokens emitted that the draft cache lacks (1 or 2, the stream's tail)
    gap = torch.ones((B,), dtype=torch.int64, device=dev)
    j = torch.arange(G + 1, device=dev)[None, :]
    full_tail = torch.full((B,), G + 1, dtype=torch.int64, device=dev)

    def draft_step(tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        nonlocal draft_steps
        draft_steps += 1
        emb = L.embed_tokens(draft_params["llm"], tok[:, None], dt)
        return L.llama_decode_step(draft_params["llm"], dllm, x=emb, cache=d_cache,
                                   cur_lens=pos, lora=dlora, compute_dtype=dt,
                                   use_kernel=use_kernel)[0]

    draft_steps = iters = 0
    all_done, catch_up = bool(done.all()), False
    while not all_done:
        n = out_pos
        e_prev = tokens[b_idx, n - 1]
        # Catch up the pending tail with single-token decode steps, which
        # keep a quantized draft on the qmatmul kernels. With gap 1 step A
        # repeats step B (same token, same position), so it runs only when
        # some row has gap 2; the other rows then rewrite a column as it is.
        if catch_up:
            tok_a = torch.where(gap == 2, tokens[b_idx, (n - 2).clamp(min=0)], e_prev)
            draft_step(tok_a, torch.where(gap == 2, Pd + n - 2, Pd + n - 1))
        dlog = draft_step(e_prev, Pd + n - 1)
        drafts, qprobs = [], []
        for i in range(G):
            if sampling:
                qprobs.append(_dist(dlog, temperature, top_p))
                tok = _categorical(qprobs[-1], generator)
            else:
                tok = torch.argmax(dlog, dim=-1)
            drafts.append(tok)
            dlog = draft_step(tok, Pd + n + i)
        drafts = torch.stack(drafts, dim=1)                          # [B, G]

        # verify: one target pass over [e_{n-1}, d_1 .. d_G]
        vemb = L.embed_tokens(params["llm"], torch.cat([e_prev[:, None], drafts], 1), dt)
        vh, t_cache = L.llama_prefill_continue(
            params["llm"], cfg, x=vemb, cache=t_cache, base_lens=P + n - 1,
            tail_lens=full_tail, lora=lora, compute_dtype=dt, use_kernel=use_kernel)
        vlog = L.compute_logits(params["llm"], cfg, vh, use_kernel)      # [B, G+1, V]
        iters += 1

        # accept the longest valid prefix and one token more
        if sampling:
            p = _dist(vlog, temperature, top_p)
            u, g = rejection_draws(B, G, p.shape[-1], generator, dev)
            m, a = rejection_apply(drafts, torch.stack(qprobs, dim=1), p, u, g)
        else:
            a = torch.argmax(vlog, dim=-1)                               # [B, G+1]
            m = torch.cumprod((drafts == a[:, :G]).int(), dim=1).sum(dim=1)
        ok = j <= m[:, None]
        is_eos = ((a == eos_id) & ok).int()
        eos_before = torch.cumsum(is_eos, dim=1) - is_eos
        emit = ok & (eos_before == 0) & ~done[:, None] & ((n[:, None] + j) < max_new_tokens)
        n_emit = emit.sum(dim=1)
        idx = (n[:, None] + j).clamp(0, Tbuf - 1)
        tokens[b_idx[:, None], idx] = torch.where(emit, a, tokens[b_idx[:, None], idx])
        out_pos = out_pos + n_emit
        done = (done | (emit & (a == eos_id)).any(dim=1) | (out_pos >= max_new_tokens)
                | (n_emit == 0))
        # The draft consumed e_{n-1} and d_1 .. d_{G-1}; of the tokens just
        # emitted it lacks the last one, or after a full accept two.
        gap = torch.where(done, gap, torch.where(n_emit == G + 1, 2, 1))
        all_done, catch_up = (int(f) for f in torch.stack(
            [done.all(), (gap == 2).any()]).tolist())

    lengths = out_pos.clamp(max=max_new_tokens).to(torch.int32)
    out = GenOut(tokens[:, :max_new_tokens], lengths)
    if not return_stats:
        return out
    emitted = float(lengths.float().sum()) - B
    return out, {"verify_passes": iters, "draft_steps": draft_steps,
                 "tokens_per_pass": emitted / max(iters * B, 1.0)}
