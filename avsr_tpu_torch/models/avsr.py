"""AVSR model composition, the port of ``avsr_tpu/models/avsr.py``:
Whisper or HuBERT/Wav2Vec2 + CLIP, ResNet, EfficientNet or AV-HuBERT +
connectors + Llama(+LoRA): two single-input connectors fused by
``weighted_sum`` (any ``fusion_mode`` other than ``concat_seq``, as in
JAX) or ``concat_seq``, or one dual-input connector that fuses audio and
video itself; the packed [prompt][features] prefix that generation
prefills, and the training ``forward`` (packed causal-LM loss on the label
positions, plus the MoE router losses of the ``moe`` connector and the
LLM's MoE blocks).
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from avsr_tpu_torch.convert import param_count
from avsr_tpu_torch.core.config import ModelConfig
from avsr_tpu_torch.mesh.sharding import RowShard, gather_tree
from avsr_tpu_torch.models import llama as llama_mod
from avsr_tpu_torch.models.avhubert import avhubert_apply, init_avhubert
from avsr_tpu_torch.models.clip_vit import clip_vit_apply, init_clip_vit
from avsr_tpu_torch.models.connectors import get_connector, upsample_to
from avsr_tpu_torch.models.efficientnet import efficientnet_apply, init_efficientnet
from avsr_tpu_torch.models.hubert import init_speech_ssl, speech_ssl_apply
from avsr_tpu_torch.models.layers import Params
from avsr_tpu_torch.models.resnet import init_resnet, resnet_apply
from avsr_tpu_torch.models.whisper_encoder import (
    init_whisper_encoder,
    whisper_encoder_apply,
)
from avsr_tpu_torch.ops import moe
from avsr_tpu_torch.ops.attention import ring_span

# Params-tree keys of the (freezable) encoder subtrees, by config name.
ENCODER_KEYS = ("whisper", "hubert", "wav2vec2", "clip", "resnet",
                "efficientnet", "avhubert")
_VIDEO_INIT = {"clip": init_clip_vit, "resnet": init_resnet,
               "efficientnet": init_efficientnet, "avhubert": init_avhubert}


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
    # the MoE connector's {"moe_lb", "moe_z"}; None for the dense ones
    aux: dict | None = None


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
        enc = cfg.video_encoder
        params[enc] = _VIDEO_INIT[enc](gen, getattr(cfg, enc), dtype)
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
                     enc.lengths.clamp(max=max_seq_len), enc.aux)


def _conn_out(ret: tuple) -> tuple:
    """A connector's (y, lens) or (y, lens, aux) as (y, lens, aux)."""
    return ret if len(ret) == 3 else (*ret, {})


def encode_video(params: Params, cfg: ModelConfig, batch: Batch, *,
                 compute_dtype: torch.dtype, use_kernel: str, remat: bool,
                 sp=None) -> torch.Tensor:
    """The configured video encoder: frames [B, T, 3, S, S] -> [B, T, d];
    AV-HuBERT's blocks under the sp group ``sp`` (CLIP, ResNet and
    EfficientNet get no mesh, as in JAX)."""
    enc = cfg.video_encoder
    kw = dict(compute_dtype=compute_dtype, remat=remat)
    if enc == "clip":
        return clip_vit_apply(params["clip"], batch.frames, cfg.clip,
                              use_kernel=use_kernel, **kw)
    if enc == "resnet":
        return resnet_apply(params["resnet"], batch.frames, cfg.resnet, **kw)
    if enc == "efficientnet":
        return efficientnet_apply(params["efficientnet"], batch.frames, cfg.efficientnet,
                                  **kw)
    return avhubert_apply(params["avhubert"], batch.frames, cfg.avhubert,
                          frame_lengths=batch.frame_lens, use_kernel=use_kernel, sp=sp, **kw)


def encode(params: Params, cfg: ModelConfig, batch: Batch, *,
           compute_dtype: torch.dtype = torch.float32,
           use_kernel: str = "auto", remat: bool = False,
           moe_rowwise: bool = False, sp=None, moe_group=None) -> EncodeOut:
    """Run the modality encoders + connectors and fuse them. Frozen
    encoders run under ``torch.no_grad()`` (the JAX ``stop_gradient``):
    no backward graph is built for them. ``model.unfreeze_layer_norms``
    trains their layer norms, so then they run with grad (and ``remat``
    recomputes their blocks in the backward), as the JAX package drops its
    ``stop_gradient`` for that knob; so does the video branch when
    ``finetune_avhubert_layers`` names AV-HuBERT blocks to train.
    ``moe_rowwise`` (inference callers) routes the MoE connector row by
    row, so a request's features do not depend on its batch; two
    single-input MoE connectors' aux losses are averaged. Sharded leaves
    (fsdp, ``mesh/sharding.py``) are gathered where they are used. ``sp``
    (the mesh's sp group) shards the sequence of the Whisper, HuBERT/
    Wav2Vec2 and AV-HuBERT block stacks (ring attention), as JAX threads
    its mesh into them; their outputs come back whole. ``moe_group`` (the
    data group of a training rank) routes the MoE connector's training
    routing over every rank's rows, and its experts keep their ep
    slices."""
    conn = get_connector(cfg.connector_type)
    # under fsdp and tp the other encoders and the connectors gather their
    # whole subtree here; Whisper and CLIP gather (fsdp) or run Megatron
    # (tp) block by block
    params = {k: v if k in ("whisper", "clip", "llm") else gather_tree(v, keep_ep=True)
              for k, v in params.items()}
    frozen = cfg.freeze_encoders and not cfg.unfreeze_layer_norms
    tune_avhubert = cfg.video_encoder == "avhubert" and bool(cfg.finetune_avhubert_layers)

    def grad_ctx(stop: bool):
        return torch.no_grad() if stop else contextlib.nullcontext()

    feats = alens = vfeats = vlens = None
    if cfg.modality in ("audio", "both"):
        with grad_ctx(frozen):
            if cfg.audio_encoder == "whisper":
                feats, alens = whisper_encoder_apply(
                    params["whisper"], batch.mel, cfg.whisper,
                    mel_lengths=batch.mel_lens, compute_dtype=compute_dtype,
                    use_kernel=use_kernel, remat=remat, sp=sp)
            else:
                feats, alens = speech_ssl_apply(
                    params[cfg.audio_encoder], batch.wave, cfg.ssl,
                    wave_lengths=batch.wave_lens, compute_dtype=compute_dtype,
                    use_kernel=use_kernel, remat=remat, sp=sp)
    if cfg.modality in ("video", "both"):
        with grad_ctx(frozen and not tune_avhubert):
            vfeats = encode_video(params, cfg, batch, compute_dtype=compute_dtype,
                                  use_kernel=use_kernel, remat=remat, sp=sp)
        vlens = (batch.frame_lens.to(torch.int32) if batch.frame_lens is not None
                 else torch.full((vfeats.shape[0],), vfeats.shape[1],
                                 dtype=torch.int32, device=vfeats.device))

    ckw = dict(use_kernel=use_kernel, model_cfg=cfg, moe_rowwise=moe_rowwise,
               moe_routing=moe.Routing(moe_group) if moe_group is not None else None)
    if conn.dual:
        out, lens, aux = _conn_out(conn.apply(params["connector"], feats, vfeats,
                                              alens, vlens, **ckw))
        return _cap_seq(EncodeOut(out, lens, aux), cfg.max_seq_len)
    if cfg.modality == "audio":
        out, lens, aux = _conn_out(conn.apply(params["audio_connector"], feats, alens,
                                              **ckw))
        return _cap_seq(EncodeOut(out, lens, aux), cfg.max_seq_len)
    if cfg.modality == "video":
        out, lens, aux = _conn_out(conn.apply(params["video_connector"], vfeats, vlens,
                                              **ckw))
        return _cap_seq(EncodeOut(out, lens, aux), cfg.max_seq_len)
    a_out, a_lens, a_aux = _conn_out(conn.apply(params["audio_connector"], feats,
                                                alens, **ckw))
    v_out, v_lens, v_aux = _conn_out(conn.apply(params["video_connector"], vfeats,
                                                vlens, **ckw))
    aux = {k: 0.5 * (a_aux[k] + v_aux[k]) for k in a_aux}
    if cfg.fusion_mode == "concat_seq":
        packed, total, _ = pack_segments([(a_out, a_lens), (v_out, v_lens)])
        return _cap_seq(EncodeOut(packed, total, aux), cfg.max_seq_len)
    # weighted_sum, and every other fusion_mode (JAX sends them all here):
    # video onto the audio time grid, then
    # fusion_scale * audio + (1 - fusion_scale) * video.
    v_up = upsample_to(v_out, v_lens, a_out.shape[1], a_lens)
    fused = cfg.fusion_scale * a_out + (1.0 - cfg.fusion_scale) * v_up
    return _cap_seq(EncodeOut(fused, a_lens, aux), cfg.max_seq_len)


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
            dropout_seed: int | None = None, return_logits: bool = False,
            shard: RowShard | None = None, sp=None, pp=None
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
    student against a teacher's). With MoE (the connector, the LLM or
    both) the loss adds ``moe_aux_weight`` * lb + ``moe_z_weight`` * z,
    where lb and z sum the connector's and the LLM's router losses, and
    the metrics report them as ``moe_lb`` and ``moe_z``.

    ``shard`` (a rank of a multi-process run, ``mesh/sharding.py``): the
    batch is rows ``shard.start`` on of a global batch of ``shard.total``.
    The label-token count is then the global batch's (summed over
    ``shard.group``), so ``loss`` and ``accuracy`` are this rank's shares
    of the global values, which sum to them, and the dropout masks are
    these rows' masks of the global batch. The embedding and the head
    gather their fsdp-sharded leaves once here; under tp they keep their
    vocab slices, and the label-position logits come back gathered over
    the vocabulary (``llama.compute_logits``), so the log-sum-exp, the
    target's logit and the argmax (ties to the lowest index, as
    ``jnp.argmax``) are one card's. The gather was chosen over a
    vocab-parallel cross-entropy: it gives the same bits with no new loss
    code, and the [B, Tl, V] label logits it moves are small beside a
    step's activations.

    ``sp`` (the mesh's sp group, sequence parallelism): the encoders' and
    the LLM's block stacks run on this rank's chunk of their sequences
    (ring attention, ``encode`` and ``llama.llama_apply``), and the final
    norm, the head and the cross-entropy stay on this rank's chunk of the
    packed positions: it scores the labels predicted there (the positions
    of a row's labels are contiguous, so at most min(Tl, chunk) of them), a
    [B, min(Tl, chunk), V] block of logits rather than the whole sequence's.
    ``loss``, ``accuracy`` and the label-token count are then this rank's
    shares, summed over ``shard.group`` (the data and sp groups) or, without
    a shard, over ``sp``; their sum is one card's.

    ``pp`` (the mesh's pp group, pipeline parallelism): the encoders, the
    connectors and the packing run on every rank, the LLM's blocks in
    stages (``llama.llama_apply``; only stage 0's packed input enters the
    pipeline, so the gradients of everything before it are stage 0's), and
    every rank scores the same rows from the returned hidden states. Each
    stage counts its rows' label tokens, so the count summed over
    ``shard.group`` (which holds the pp group) or ``pp`` is the global one
    times the stages: ``loss`` and ``accuracy`` are each rank's
    ``1 / pp`` share, and ``label_tokens`` reports the global count.

    Mixture of experts across processes: the connector routes over the
    data group's rows and the LLM over the data group's (and under sp the
    ring's chunks'), so ``moe_lb`` and ``moe_z`` are the global batch's, the
    same on every rank that shares them. Each rank adds ``1 / n`` of them
    to its loss and reports ``1 / n`` in its metrics, n the ranks whose
    losses sum (``shard.group``): their losses sum to one card's, and since
    the routing sums' gradients are summed over the routing group
    (``collectives.sum_over``) every rank's router and token gradients are
    its own tokens' share of one card's, counted once when
    ``train/step.py::reduce_grads`` sums them (the connector's, which every
    sp and pp rank of a data position computes, included)."""
    llm = params["llm"]
    params = {**params, "llm": {**gather_tree({k: v for k, v in llm.items() if k != "layers"},
                                              keep_tp=True),
                                "layers": llm["layers"]}}
    enc = encode(params, cfg, batch, compute_dtype=compute_dtype,
                 use_kernel=use_kernel, remat=remat, sp=sp,
                 moe_group=shard.data if shard is not None else None)
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
    llm_moe = cfg.llm.moe_experts > 0
    span = ring_span(sp, Ttot)
    # the LLM's tokens route over every rank's rows, and the ring's chunks
    llm_group = None if shard is None else shard.group if span is not None else shard.data
    hidden, _, *llm_aux = llama_mod.llama_apply(
        params["llm"], cfg.llm, inputs_embeds=packed, lengths=total,
        lora=cfg.lora if cfg.lora.use_lora else None,
        compute_dtype=compute_dtype, use_kernel=use_kernel, remat=remat,
        dropout_seed=dropout_seed, output="hidden", return_aux=llm_moe,
        dropout_row0=shard.start if shard is not None else 0, sp=sp,
        gather_hidden=False, pp=pp, global_rows=shard.total if shard is not None else None,
        moe_group=llm_group)

    Tl = labels.shape[1]
    i = torch.arange(Tl, device=dev)[None, :]
    pred_pos = (seg_start[:, 2:3].long() + i - 1).clamp(0, Ttot - 1)  # [B, Tl]
    mask = (i < lab_lens[:, None]).float()
    if span is not None:
        if return_logits:
            raise NotImplementedError("return_logits reads every label's logits; "
                                      "it runs without mesh.sp")
        # this rank's labels: a contiguous run of each row's, from ``first``
        c0, c1 = span
        own = (pred_pos >= c0) & (pred_pos < c1)
        first = own.int().argmax(dim=1, keepdim=True)                  # [B, 1]
        j = first + torch.arange(min(Tl, c1 - c0), device=dev)[None, :]
        inside = j < Tl
        j = j.clamp(max=Tl - 1)
        mask = mask.gather(1, j) * (own.gather(1, j) & inside).float()
        labels = labels.gather(1, j)
        pred_pos = (pred_pos.gather(1, j) - c0).clamp(0, c1 - c0 - 1)
    h_pred = torch.gather(hidden, 1, pred_pos[..., None].expand(-1, -1, hidden.shape[-1]))
    logits = llama_mod.compute_logits(params["llm"], cfg.llm, h_pred)  # [B,Tl,V]

    logp = torch.log_softmax(logits, dim=-1)
    pred_lp = torch.gather(logp, -1, labels[..., None])[..., 0]
    n_tokens = mask.sum()
    stages = pp.size if pp is not None else 1
    group = (shard.group if shard is not None
             else sp if span is not None else pp if stages > 1 else None)
    if group is not None:
        n_tokens = group.all_reduce(n_tokens.detach().clone())
    n_tokens = n_tokens.clamp(min=1.0)
    loss = -(pred_lp * mask).sum() / n_tokens
    correct = (logits.argmax(dim=-1) == labels).float()
    metrics = {"loss": loss,
               "accuracy": (correct * mask).sum() / n_tokens,
               "label_tokens": n_tokens / stages,
               "feat_len_mean": enc.lengths.float().mean()}
    if return_logits:
        metrics["label_logits"] = logits
        metrics["label_mask"] = mask
    # the MoE router losses, weighted into the optimized loss so that the
    # routers learn a balanced dispatch (the metrics keep them unweighted)
    enc_aux = enc.aux or {}
    moe_lb, moe_z = enc_aux.get("moe_lb"), enc_aux.get("moe_z")
    if llm_aux:
        moe_lb = llm_aux[0]["moe_lb"] + (0.0 if moe_lb is None else moe_lb)
        moe_z = llm_aux[0]["moe_z"] + (0.0 if moe_z is None else moe_z)
    if moe_lb is not None:
        share = 1.0 / group.size if group is not None else 1.0
        moe_lb, moe_z = moe_lb * share, moe_z * share
        loss = loss + (cfg.moe_aux_weight * moe_lb + cfg.moe_z_weight * moe_z).to(loss.dtype)
        metrics.update(moe_lb=moe_lb, moe_z=moe_z, loss=loss)
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
