"""AVSR model composition, the port of ``avsr_tpu/models/avsr.py``:
Whisper or HuBERT/Wav2Vec2 + CLIP + connectors + Llama(+LoRA): two
single-input connectors fused by ``weighted_sum`` (any ``fusion_mode``
other than ``concat_seq``, as in JAX) or ``concat_seq``, or one dual-input
connector that fuses audio and video itself; the packed
[prompt][features] prefix that generation prefills, and the training
``forward`` (packed causal-LM loss on the label positions).

The other video encoders (ResNet, EfficientNet, AV-HuBERT) and MoE (the
``moe`` connector and the LLM's MoE FFN) are still to be ported.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from avsr_tpu_torch.convert import param_count
from avsr_tpu_torch.core.config import ModelConfig
from avsr_tpu_torch.models import llama as llama_mod
from avsr_tpu_torch.models.clip_vit import clip_vit_apply, init_clip_vit
from avsr_tpu_torch.models.connectors import get_connector, upsample_to
from avsr_tpu_torch.models.hubert import init_speech_ssl, speech_ssl_apply
from avsr_tpu_torch.models.layers import Params
from avsr_tpu_torch.models.whisper_encoder import (
    init_whisper_encoder,
    whisper_encoder_apply,
)


class Batch(NamedTuple):
    """One batch on the device. Unused modality fields may be None."""

    mel: torch.Tensor | None = None            # [B, n_mels, Tmel]
    mel_lens: torch.Tensor | None = None       # [B] (mel frames)
    frames: torch.Tensor | None = None         # [B, Tv, 3, S, S]
    frame_lens: torch.Tensor | None = None     # [B]
    prompt_tokens: torch.Tensor | None = None  # [Tp] or [B, Tp] (incl. BOS)
    labels: torch.Tensor | None = None         # [B, Tl]
    label_lens: torch.Tensor | None = None     # [B]
    # raw-waveform front end (audio_encoder hubert/wav2vec2; mel unused then)
    wave: torch.Tensor | None = None           # [B, T_samples] f32
    wave_lens: torch.Tensor | None = None      # [B] (samples)


class EncodeOut(NamedTuple):
    features: torch.Tensor                     # [B, Tf, d_llm]
    lengths: torch.Tensor                      # [B]


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.video_encoder != "clip" and cfg.modality in ("video", "both"):
        raise NotImplementedError(
            f"video_encoder {cfg.video_encoder!r} is not yet ported to "
            "avsr_tpu_torch (ported: clip)")
    if cfg.llm.moe_experts or cfg.connector_type == "moe":
        raise NotImplementedError("MoE layers are not yet ported")


# ---------------------------------------------------------------------------
# Static-shape segment packing
# ---------------------------------------------------------------------------

def pack_segments(segments: list[tuple[torch.Tensor, torch.Tensor]]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenate right-padded segments, squeezing out mid-sequence padding.

    segments: list of (emb [B, T_s, d], lens [B]). Returns
      packed    [B, sum(T_s), d] — valid items contiguous from position 0
      total     [B]              — per-sample packed length
      seg_start [B, n_segments]  — packed start offset of each segment
    A pure gather with static shapes."""
    dev = segments[0][0].device
    caps = [int(e.shape[1]) for e, _ in segments]
    Ttot = sum(caps)
    src = torch.cat([e for e, _ in segments], dim=1)                 # [B,Ttot,d]
    lens = torch.stack([l.to(device=dev, dtype=torch.int64)
                        for _, l in segments], dim=1)                # [B,S]
    seg_start = torch.cumsum(lens, dim=1) - lens
    total = lens.sum(dim=1)
    src_start = torch.tensor([sum(caps[:i]) for i in range(len(caps))],
                             dtype=torch.int64, device=dev)
    j = torch.arange(Ttot, device=dev)[None, :]                      # [1,Ttot]
    seg_end = seg_start + lens
    seg_id = (j[:, :, None] >= seg_end[:, None, :]).sum(dim=-1)      # [B,Ttot]
    seg_id = seg_id.clamp(0, len(caps) - 1)
    src_idx = src_start[seg_id] + j - torch.gather(seg_start, 1, seg_id)
    src_idx = src_idx.clamp(0, Ttot - 1)
    packed = torch.gather(src, 1, src_idx[..., None].expand(-1, -1, src.shape[-1]))
    return packed, total.to(torch.int32), seg_start.to(torch.int32)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_avsr_model(cfg: ModelConfig, *, seed: int = 0,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype = torch.float32) -> Params:
    """Random init from ``seed`` on ``device``, every leaf in ``dtype``.

    The JAX decode path keeps trainable leaves (connectors, LoRA) in f32
    and casts frozen ones to the compute dtype; since every apply function
    casts a weight to the activation dtype before its matmul, storing all
    leaves in the compute dtype gives the same numbers at half the bytes."""
    _check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    conn = get_connector(cfg.connector_type)
    d_llm = cfg.llm.d_model
    params: Params = {}
    if cfg.modality in ("audio", "both"):
        if cfg.audio_encoder == "whisper":
            params["whisper"] = init_whisper_encoder(gen, cfg.whisper, dtype)
        else:   # hubert / wav2vec2 share one module
            params[cfg.audio_encoder] = init_speech_ssl(gen, cfg.ssl, dtype)
        if not conn.dual:
            params["audio_connector"] = conn.init(gen, cfg.audio_dim, d_llm, cfg, dtype)
    if cfg.modality in ("video", "both"):
        params["clip"] = init_clip_vit(gen, cfg.clip, dtype)
        if not conn.dual:
            params["video_connector"] = conn.init(gen, cfg.video_dim, d_llm, cfg, dtype)
    if conn.dual:
        params["connector"] = conn.init(gen, cfg.audio_dim, cfg.video_dim, d_llm,
                                        cfg, dtype)
    llm = llama_mod.init_llama(gen, cfg.llm, dtype)
    if cfg.lora.use_lora:
        llm = llama_mod.add_lora(gen, llm, cfg.llm, cfg.lora, dtype)
    params["llm"] = llm
    return params


# ---------------------------------------------------------------------------
# Encode (audio / video / fusion) -> LLM-space features
# ---------------------------------------------------------------------------

def _cap_seq(enc: EncodeOut, max_seq_len: int) -> EncodeOut:
    """Honor ModelConfig.max_seq_len as a hard cap on the fused features."""
    if enc.features.shape[1] <= max_seq_len:
        return enc
    return EncodeOut(enc.features[:, :max_seq_len],
                     enc.lengths.clamp(max=max_seq_len))


def encode(params: Params, cfg: ModelConfig, batch: Batch, *,
           compute_dtype: torch.dtype = torch.float32,
           use_kernel: str = "auto", remat: bool = False) -> EncodeOut:
    """Run the modality encoders + connectors and fuse them. Frozen
    encoders run under ``torch.no_grad()`` (the JAX ``stop_gradient``):
    no backward graph is built for them. ``model.unfreeze_layer_norms``
    trains their layer norms, so then they run with grad (and ``remat``
    recomputes their blocks in the backward), as the JAX package drops its
    ``stop_gradient`` for that knob."""
    _check_ported(cfg)
    conn = get_connector(cfg.connector_type)
    frozen = (torch.no_grad() if cfg.freeze_encoders and not cfg.unfreeze_layer_norms
              else contextlib.nullcontext())
    feats = alens = vfeats = vlens = None
    if cfg.modality in ("audio", "both"):
        with frozen:
            if cfg.audio_encoder == "whisper":
                feats, alens = whisper_encoder_apply(
                    params["whisper"], batch.mel, cfg.whisper,
                    mel_lengths=batch.mel_lens, compute_dtype=compute_dtype,
                    use_kernel=use_kernel, remat=remat)
            else:
                feats, alens = speech_ssl_apply(
                    params[cfg.audio_encoder], batch.wave, cfg.ssl,
                    wave_lengths=batch.wave_lens, compute_dtype=compute_dtype,
                    use_kernel=use_kernel, remat=remat)
    if cfg.modality in ("video", "both"):
        with frozen:
            vfeats = clip_vit_apply(params["clip"], batch.frames, cfg.clip,
                                    compute_dtype=compute_dtype,
                                    use_kernel=use_kernel, remat=remat)
        vlens = (batch.frame_lens.to(torch.int32) if batch.frame_lens is not None
                 else torch.full((vfeats.shape[0],), vfeats.shape[1],
                                 dtype=torch.int32, device=vfeats.device))

    if conn.dual:
        out, lens = conn.apply(params["connector"], feats, vfeats, alens, vlens,
                               use_kernel=use_kernel)
        return _cap_seq(EncodeOut(out, lens), cfg.max_seq_len)
    if cfg.modality == "audio":
        out, lens = conn.apply(params["audio_connector"], feats, alens,
                               use_kernel=use_kernel)
        return _cap_seq(EncodeOut(out, lens), cfg.max_seq_len)
    if cfg.modality == "video":
        out, lens = conn.apply(params["video_connector"], vfeats, vlens,
                               use_kernel=use_kernel)
        return _cap_seq(EncodeOut(out, lens), cfg.max_seq_len)
    a_out, a_lens = conn.apply(params["audio_connector"], feats, alens,
                               use_kernel=use_kernel)
    v_out, v_lens = conn.apply(params["video_connector"], vfeats, vlens,
                               use_kernel=use_kernel)
    if cfg.fusion_mode == "concat_seq":
        packed, total, _ = pack_segments([(a_out, a_lens), (v_out, v_lens)])
        return _cap_seq(EncodeOut(packed, total), cfg.max_seq_len)
    # weighted_sum, and every other fusion_mode (JAX sends them all here):
    # video onto the audio time grid, then
    # fusion_scale * audio + (1 - fusion_scale) * video.
    v_up = upsample_to(v_out, v_lens, a_out.shape[1], a_lens)
    fused = cfg.fusion_scale * a_out + (1.0 - cfg.fusion_scale) * v_up
    return _cap_seq(EncodeOut(fused, a_lens), cfg.max_seq_len)


def build_prefix(params: Params, cfg: ModelConfig, batch: Batch, enc: EncodeOut,
                 *, compute_dtype: torch.dtype = torch.float32
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """[prompt embeds][features] packed -> (embeds [B, Tp+Tf, d], lens [B])."""
    B = enc.features.shape[0]
    prompt = batch.prompt_tokens.to(enc.features.device)
    if prompt.ndim == 1:
        prompt = prompt[None].expand(B, -1)
    p_emb = llama_mod.embed_tokens(params["llm"], prompt.long(), compute_dtype)
    p_lens = torch.full((B,), prompt.shape[1], dtype=torch.int32,
                        device=p_emb.device)
    packed, total, _ = pack_segments(
        [(p_emb, p_lens), (enc.features.to(compute_dtype), enc.lengths)])
    return packed, total


# ---------------------------------------------------------------------------
# Forward: packed causal-LM loss
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, batch: Batch, *,
            compute_dtype: torch.dtype = torch.float32,
            use_kernel: str = "auto", remat: bool = False,
            dropout_seed: int | None = None, return_logits: bool = False
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Training/eval forward: (mean CE loss over label tokens, metrics).

    Packs [prompt][features][labels] per row (padding squeezed out), pads
    the packed width to a multiple of 16 as the JAX package does (so that
    positions match it), runs the LLM to its final hidden states, and
    projects to the vocabulary only the rows that predict a label: label
    token i sits at packed position label_start + i and is predicted from
    the hidden state at label_start + i - 1. Metrics: ``loss``,
    ``accuracy``, ``label_tokens`` and ``feat_len_mean``; with
    ``return_logits`` also ``label_logits`` [B, Tl, V] f32 and their
    validity mask ``label_mask`` [B, Tl] (draft distillation matches a
    student against a teacher's)."""
    enc = encode(params, cfg, batch, compute_dtype=compute_dtype,
                 use_kernel=use_kernel, remat=remat)
    B = enc.features.shape[0]
    dev = enc.features.device
    prompt = batch.prompt_tokens.to(dev)
    if prompt.ndim == 1:
        prompt = prompt[None].expand(B, -1)
    p_emb = llama_mod.embed_tokens(params["llm"], prompt.long(), compute_dtype)
    p_lens = torch.full((B,), prompt.shape[1], dtype=torch.int32, device=dev)
    labels = batch.labels.to(dev).long()
    lab_emb = llama_mod.embed_tokens(params["llm"], labels, compute_dtype)
    lab_lens = batch.label_lens.to(dev).to(torch.int32)
    packed, total, seg_start = pack_segments([
        (p_emb, p_lens),
        (enc.features.to(compute_dtype), enc.lengths),
        (lab_emb, lab_lens),
    ])
    packed = F.pad(packed, (0, 0, 0, -packed.shape[1] % 16))
    Ttot = packed.shape[1]
    hidden, _ = llama_mod.llama_apply(
        params["llm"], cfg.llm, inputs_embeds=packed, lengths=total,
        lora=cfg.lora if cfg.lora.use_lora else None,
        compute_dtype=compute_dtype, use_kernel=use_kernel, remat=remat,
        dropout_seed=dropout_seed, output="hidden")

    Tl = labels.shape[1]
    i = torch.arange(Tl, device=dev)[None, :]
    pred_pos = (seg_start[:, 2:3].long() + i - 1).clamp(0, Ttot - 1)  # [B, Tl]
    h_pred = torch.gather(hidden, 1, pred_pos[..., None].expand(-1, -1, hidden.shape[-1]))
    logits = llama_mod.compute_logits(params["llm"], cfg.llm, h_pred)  # [B,Tl,V]

    mask = (i < lab_lens[:, None]).float()
    logp = torch.log_softmax(logits, dim=-1)
    pred_lp = torch.gather(logp, -1, labels[..., None])[..., 0]
    n_tokens = mask.sum().clamp(min=1.0)
    loss = -(pred_lp * mask).sum() / n_tokens
    correct = (logits.argmax(dim=-1) == labels).float()
    metrics = {"loss": loss,
               "accuracy": (correct * mask).sum() / n_tokens,
               "label_tokens": n_tokens,
               "feat_len_mean": enc.lengths.float().mean()}
    if return_logits:
        metrics["label_logits"] = logits
        metrics["label_mask"] = mask
    return loss, metrics


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def summarize(params: Params, cfg: ModelConfig) -> dict[str, Any]:
    # train depends on models, not the reverse
    from avsr_tpu_torch.train.state import count_trainable

    trainable, total = count_trainable(params, cfg)
    return {
        "total_params": total,
        "per_component": {k: param_count(v) for k, v in params.items()},
        "trainable_params": trainable,
        "modality": cfg.modality,
        "connector": cfg.connector_type,
    }
