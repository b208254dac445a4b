"""HuBERT / Wav2Vec2 speech encoders, the port of ``avsr_tpu/models/hubert.py``.

One module covers both families (they share the wav2vec2 geometry; HuBERT
differs only in pretraining), selected by ``model.audio_encoder``:

    waveform [B, T] --7 x conv1d (gelu; group or layer norm)--> [B, 512, T/320]
    --LN + linear--> [B, T', d] --(+ grouped conv positional embedding)-->
    N x transformer blocks (post-LN for *-base, pre-LN for the *-large
    "stable layer norm" checkpoints) --> [B, T', d]

It reads the raw waveform (``featurize`` passes it through for these
encoders), not log-mel. Output lengths follow HF's ``_get_feat_extract_output_lengths``
floor arithmetic, and attention masks the padding through
``ops/attention.py::attention``: at 10 s (499 frames, padded to 512 rows)
that is the flash kernel. The convolutions are ``torch`` calls, as they
are XLA convolutions in the JAX package. ``remat`` recomputes each block
in the backward while grad mode is on. Under sp (``mesh.sp``) the ranks of
the group run the blocks on their chunks of the padded rows, with ring
attention, and gather them after the stack (``ssl_encoder_apply``; AV-
HuBERT's blocks share it).
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from avsr_tpu_torch.core.config import SpeechSSLConfig
from avsr_tpu_torch.core.hf_files import Prefixed
from avsr_tpu_torch.mesh.collectives import gather_from_sp, scatter_to_sp
from avsr_tpu_torch.models.layers import (
    Params,
    dense,
    dense_init,
    gelu,
    layer_norm,
    mha_apply,
    mha_init,
    norm_init,
)
from avsr_tpu_torch.ops.attention import ring_span


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_speech_ssl(gen: torch.Generator, cfg: SpeechSSLConfig,
                    dtype: torch.dtype = torch.float32) -> Params:
    dev = gen.device
    convs = []
    c_in = 1
    for i, (c_out, k) in enumerate(zip(cfg.conv_dims, cfg.conv_kernels)):
        p: Params = {"w": torch.empty((c_out, c_in, k), dtype=dtype, device=dev).normal_(
            0.0, (c_in * k) ** -0.5, generator=gen)}
        if cfg.conv_bias:
            p["b"] = torch.zeros((c_out,), dtype=dtype, device=dev)
        if (cfg.feat_extract_norm == "group" and i == 0) or \
                cfg.feat_extract_norm == "layer":
            p["norm"] = norm_init(gen, c_out, dtype=dtype)
        convs.append(p)
        c_in = c_out
    params: Params = {
        "fe": convs,
        "proj_ln": norm_init(gen, cfg.conv_dims[-1], dtype=dtype),
        "proj": dense_init(gen, cfg.conv_dims[-1], cfg.d_model, dtype=dtype),
    }
    params.update(ssl_encoder_init(
        gen, cfg.d_model, n_layers=cfg.n_layers, ffn_mult=cfg.ffn_mult,
        pos_conv_kernel=cfg.pos_conv_kernel, pos_conv_groups=cfg.pos_conv_groups,
        dtype=dtype))
    return params


def ssl_encoder_init(gen: torch.Generator, d: int, *, n_layers: int, ffn_mult: int,
                     pos_conv_kernel: int, pos_conv_groups: int,
                     dtype: torch.dtype = torch.float32) -> Params:
    """The positional conv + transformer stack."""
    dev = gen.device
    fan_in = d // pos_conv_groups * pos_conv_kernel
    return {
        "pos_conv": {
            "w": torch.empty((d, d // pos_conv_groups, pos_conv_kernel), dtype=dtype,
                             device=dev).normal_(0.0, fan_in ** -0.5, generator=gen),
            "b": torch.zeros((d,), dtype=dtype, device=dev),
        },
        "ln": norm_init(gen, d, dtype=dtype),
        "blocks": [{
            "attn": mha_init(gen, d, dtype=dtype),
            "ln1": norm_init(gen, d, dtype=dtype),
            "fc1": dense_init(gen, d, d * ffn_mult, dtype=dtype),
            "fc2": dense_init(gen, d * ffn_mult, d, dtype=dtype),
            "ln2": norm_init(gen, d, dtype=dtype),
        } for _ in range(n_layers)],
    }


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def feat_extract_output_lengths(cfg: SpeechSSLConfig,
                                lengths: torch.Tensor) -> torch.Tensor:
    """HF ``Wav2Vec2Model._get_feat_extract_output_lengths`` floor arithmetic."""
    out = lengths.to(torch.int32)
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        out = torch.div(out - k, s, rounding_mode="floor") + 1
    return out.clamp(min=0)


def _channel_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm with one group per channel over [B, C, T] (an instance
    norm), in f32 whatever the compute dtype."""
    y = F.group_norm(x.float(), x.shape[1], p["scale"].float(), p["b"].float(),
                     eps=1e-5)
    return y.to(x.dtype)


def _feature_extractor(params: Params, wave: torch.Tensor,
                       cfg: SpeechSSLConfig) -> torch.Tensor:
    """[B, T] waveform -> [B, C, T/prod(strides)] conv features."""
    x = wave[:, None, :]                                    # [B, 1, T]
    for i, p in enumerate(params["fe"]):
        x = F.conv1d(x, p["w"].to(x.dtype), stride=cfg.conv_strides[i])
        if "b" in p:
            x = x + p["b"].to(x.dtype)[None, :, None]
        if "norm" in p:
            if cfg.feat_extract_norm == "group" and i == 0:
                x = _channel_norm(p["norm"], x)
            else:   # layer-norm mode: LN over the channel axis
                x = layer_norm(p["norm"], x.transpose(1, 2)).transpose(1, 2)
        x = gelu(x)
    return x


def _pos_conv(params: Params, x: torch.Tensor, kernel: int,
              groups: int) -> torch.Tensor:
    """Grouped conv positional embedding (HF Wav2Vec2PositionalConvEmbedding)."""
    y = F.conv1d(x.transpose(1, 2), params["pos_conv"]["w"].to(x.dtype),
                 padding=kernel // 2, groups=groups)
    y = y + params["pos_conv"]["b"].to(x.dtype)[None, :, None]
    if kernel % 2 == 0:                 # HF trims one step for even kernels
        y = y[:, :, :-1]
    return gelu(y.transpose(1, 2))


def speech_ssl_apply(params: Params, wave: torch.Tensor, cfg: SpeechSSLConfig, *,
                     wave_lengths: torch.Tensor | None = None,
                     compute_dtype: torch.dtype = torch.float32,
                     use_kernel: str = "auto", remat: bool = False, sp=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """wave [B, T] -> (features [B, T', d], feat_lengths [B]); ``sp`` the
    sequence-parallel group of the blocks."""
    B, T = wave.shape
    x = wave.to(compute_dtype)
    if cfg.normalize_input:
        # per-utterance zero mean, unit variance over the valid region (HF
        # Wav2Vec2FeatureExtractor do_normalize=True)
        if wave_lengths is None:
            mean = x.mean(dim=-1, keepdim=True)
            var = x.var(dim=-1, keepdim=True, unbiased=False)
        else:
            valid = (torch.arange(T, device=x.device)[None, :]
                     < wave_lengths.to(x.device)[:, None]).to(x.dtype)
            n = valid.sum(dim=-1, keepdim=True).clamp(min=1.0)
            mean = (x * valid).sum(dim=-1, keepdim=True) / n
            var = ((x - mean).square() * valid).sum(dim=-1, keepdim=True) / n
            x = x * valid
        x = (x - mean) * torch.rsqrt(var + 1e-7)
        if wave_lengths is not None:
            x = x * valid

    x = _feature_extractor(params, x, cfg).transpose(1, 2)  # [B, T', C]
    Tf = x.shape[1]
    if wave_lengths is None:
        feat_lengths = torch.full((B,), Tf, dtype=torch.int32, device=x.device)
    else:
        feat_lengths = feat_extract_output_lengths(
            cfg, wave_lengths.to(x.device)).clamp(0, Tf)

    x = dense(params["proj"], layer_norm(params["proj_ln"], x))  # [B, T', d]
    x = ssl_encoder_apply(
        params, x, feat_lengths, n_heads=cfg.n_heads,
        do_stable_layer_norm=cfg.do_stable_layer_norm,
        pos_conv_kernel=cfg.pos_conv_kernel, pos_conv_groups=cfg.pos_conv_groups,
        mask_before_pos_conv=wave_lengths is not None,
        use_kernel=use_kernel, remat=remat, sp=sp)
    return x, feat_lengths


def _block(bp: Params, x: torch.Tensor, *, n_heads: int, lengths: torch.Tensor,
           stable: bool, use_kernel: str, sp=None) -> torch.Tensor:
    attn = functools.partial(mha_apply, n_heads=n_heads, lengths=lengths,
                             use_kernel=use_kernel, sp=sp)
    if stable:                                  # pre-LN (*-large)
        x = x + attn(bp["attn"], layer_norm(bp["ln1"], x))
        h = layer_norm(bp["ln2"], x)
        return x + dense(bp["fc2"], gelu(dense(bp["fc1"], h)))
    # post-LN (*-base)
    x = layer_norm(bp["ln1"], x + attn(bp["attn"], x))
    return layer_norm(bp["ln2"], x + dense(bp["fc2"], gelu(dense(bp["fc1"], x))))


def ssl_encoder_apply(params: Params, x: torch.Tensor, lengths: torch.Tensor, *,
                      n_heads: int, do_stable_layer_norm: bool,
                      pos_conv_kernel: int, pos_conv_groups: int,
                      mask_before_pos_conv: bool = True, use_kernel: str = "auto",
                      remat: bool = False, sp=None) -> torch.Tensor:
    """The positional conv + transformer stack: [B, T, d] -> [B, T, d];
    under the sp group ``sp`` the blocks run on this rank's chunk of the
    padded rows where JAX's ring would engage (``ring_span``), else whole."""
    Tf = x.shape[1]
    # HF zeroes padded positions before the positional conv, so that padding
    # cannot leak into valid frames through the 128-wide kernel
    if mask_before_pos_conv:
        valid = torch.arange(Tf, device=x.device)[None, :] < lengths[:, None]
        x = x * valid.to(x.dtype)[..., None]
    x = x + _pos_conv(params, x, pos_conv_kernel, pos_conv_groups)

    # Align the width to 16 once (10 s gives 499 frames -> 512 rows), as the
    # JAX package does for its kernel's tile; rows past ``lengths`` are
    # masked in attention and sliced off after the stack.
    pad_t = -Tf % 16
    if pad_t:
        x = F.pad(x, (0, 0, 0, pad_t))
    if not do_stable_layer_norm:                # *-base: LN before the stack
        x = layer_norm(params["ln"], x)
    sp = sp if ring_span(sp, x.shape[1]) else None
    x = scatter_to_sp(x, sp, 1)
    block = functools.partial(_block, n_heads=n_heads, lengths=lengths,
                              stable=do_stable_layer_norm, use_kernel=use_kernel, sp=sp)
    for bp in params["blocks"]:
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, bp, x, use_reentrant=False)
        else:
            x = block(bp, x)
    x = gather_from_sp(x, sp, 1)
    if pad_t:
        x = x[:, :Tf]
    if do_stable_layer_norm:                    # *-large: LN after the stack
        x = layer_norm(params["ln"], x)
    return x


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------

def weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch's ``weight_norm(dim=2)``: g * v / ||v||, the norm per kernel
    tap over the other two axes, in f32."""
    g, v = g.float(), v.float()
    norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
    return g * v / norm.clamp(min=1e-12)


def convert_hf_speech_ssl(state_dict: dict[str, Any], cfg: SpeechSSLConfig) -> Params:
    """An HF ``Wav2Vec2Model`` / ``HubertModel`` state dict -> the port's tree.

    Both families share key names (``feature_extractor.conv_layers.*``,
    ``feature_projection.*``, ``encoder.pos_conv_embed.*``,
    ``encoder.layers.*``), with or without a ``wav2vec2.`` / ``hubert.``
    prefix. The positional conv's weight norm is resolved from the legacy
    (``weight_g``/``weight_v``) or the parametrized
    (``parametrizations.weight.original0/1``) names. Dense weights
    ``[out, in]`` become ``[in, out]``; conv kernels keep ``[O, I, K]``."""
    sd = Prefixed(state_dict, ("wav2vec2.", "hubert.", ""))
    key, arr, lin, ln = sd.key, sd.arr, sd.lin, sd.ln

    convs = []
    for i in range(len(cfg.conv_dims)):
        pre = f"feature_extractor.conv_layers.{i}."
        p: Params = {"w": arr(pre + "conv.weight")}
        if key(pre + "conv.bias") is not None:
            p["b"] = arr(pre + "conv.bias")
        if key(pre + "layer_norm.weight") is not None:
            p["norm"] = ln(pre + "layer_norm")
        convs.append(p)

    pc = "encoder.pos_conv_embed.conv."
    if key(pc + "weight_g") is not None:
        g, v = arr(pc + "weight_g"), arr(pc + "weight_v")
    else:
        g = arr(pc + "parametrizations.weight.original0")
        v = arr(pc + "parametrizations.weight.original1")

    blocks = []
    for i in range(cfg.n_layers):
        pre = f"encoder.layers.{i}."
        blocks.append({
            "attn": {
                "q": lin(pre + "attention.q_proj"),
                "k": lin(pre + "attention.k_proj"),
                "v": lin(pre + "attention.v_proj"),
                "o": lin(pre + "attention.out_proj"),
            },
            "ln1": ln(pre + "layer_norm"),
            "fc1": lin(pre + "feed_forward.intermediate_dense"),
            "fc2": lin(pre + "feed_forward.output_dense"),
            "ln2": ln(pre + "final_layer_norm"),
        })
    return {
        "fe": convs,
        "proj_ln": ln("feature_projection.layer_norm"),
        "proj": lin("feature_projection.projection"),
        "pos_conv": {"w": weight_norm(g, v), "b": arr(pc + "bias")},
        "ln": ln("encoder.layer_norm"),
        "blocks": blocks,
    }
