"""Whisper audio encoder, the port of ``avsr_tpu/models/whisper_encoder.py``.

    log-mel [B, n_mels, T] --conv1(gelu)--> [B, d, T] --conv2(s2, gelu)-->
    [B, d, T/2] --(+ sinusoidal PE)--> N x pre-LN transformer blocks --> LN

k_proj has no bias, gelu is exact-erf. Attention masks padding with the
per-utterance feature lengths; at Tq = Tk >= 256 it runs the flash kernel.
``remat`` recomputes each block in the backward (``torch.utils.checkpoint``,
the counterpart of ``jax.checkpoint``) while grad mode is on. Under fsdp
each block gathers its sharded leaves when it runs (again in the
recomputation). Under tp each block runs Megatron on its slices
(``models/layers.py::encoder_block_apply``: 16 heads over tp=2 give 8 a
rank); the convolutions, the positions and the final norm stay whole.
Under sp (``mesh.sp``) each rank of the group runs the blocks on its
contiguous chunk of the padded rows, attention the ring over the group
(``ops/ring_attention.py``), and the chunks are gathered before the final
norm; where JAX's ring would not engage (rows not a multiple of sp) the
stack runs whole on every rank, as JAX's warning says.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from avsr_tpu_torch.core.config import WhisperConfig
from avsr_tpu_torch.core.hf_files import Prefixed
from avsr_tpu_torch.mesh.collectives import gather_from_sp, scatter_to_sp
from avsr_tpu_torch.models.layers import (
    Params,
    encoder_block_init,
    gathered_block,
    gelu,
    layer_norm,
    norm_init,
    sinusoid_position_embedding,
)
from avsr_tpu_torch.ops.attention import ring_span


def init_whisper_encoder(gen: torch.Generator, cfg: WhisperConfig,
                         dtype: torch.dtype = torch.float32) -> Params:
    d = cfg.d_model
    dev = gen.device

    def conv(c_in: int) -> Params:
        w = torch.empty((d, c_in, 3), dtype=dtype, device=dev).normal_(
            0.0, (c_in * 3) ** -0.5, generator=gen)
        return {"w": w, "b": torch.zeros((d,), dtype=dtype, device=dev)}

    return {
        "conv1": conv(cfg.n_mels),
        "conv2": conv(d),
        "pos": sinusoid_position_embedding(cfg.max_source_positions, d,
                                           dev).to(dtype),
        "blocks": [encoder_block_init(gen, d, d * cfg.ffn_mult, k_bias=False,
                                      dtype=dtype)
                   for _ in range(cfg.n_layers)],
        "ln_post": norm_init(gen, d, dtype=dtype),
    }


def _conv1d(p: Params, x: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """[B, C_in, T] -> [B, C_out, T'] with kernel [C_out, C_in, K], pad=1."""
    y = F.conv1d(x, p["w"].to(x.dtype), stride=stride, padding=1)
    return y + p["b"].to(x.dtype)[None, :, None]


def whisper_encoder_apply(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
                          *, mel_lengths: torch.Tensor | None = None,
                          compute_dtype: torch.dtype = torch.float32,
                          use_kernel: str = "auto", remat: bool = False, sp=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """mel [B, n_mels, T] -> (features [B, ceil(T/2), d], feat_lengths [B]);
    ``sp`` the sequence-parallel group (see the module docstring)."""
    B = mel.shape[0]
    x = mel.to(compute_dtype)
    x = gelu(_conv1d(params["conv1"], x))
    x = gelu(_conv1d(params["conv2"], x, stride=2))     # [B, d, T//2]
    x = x.transpose(1, 2)                               # [B, Tf, d]
    Tf = x.shape[1]
    x = x + params["pos"][:Tf].to(compute_dtype)[None]

    if mel_lengths is None:
        feat_lengths = torch.full((B,), Tf, dtype=torch.int32, device=x.device)
    else:
        feat_lengths = ((mel_lengths.to(torch.int32) + 1) // 2).clamp(0, Tf)

    # Align the width to 16 once (10 s of audio gives Tf=500 -> 512), as the
    # JAX package does for its kernel's tile; rows past feat_lengths are
    # masked in attention and sliced off after the stack.
    pad_t = -Tf % 16
    if pad_t:
        x = F.pad(x, (0, 0, 0, pad_t))
    sp = sp if ring_span(sp, x.shape[1]) else None
    x = scatter_to_sp(x, sp, 1)
    block = functools.partial(gathered_block, n_heads=cfg.n_heads, lengths=feat_lengths,
                              act=gelu, use_kernel=use_kernel, sp=sp)
    for bp in params["blocks"]:
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, bp, x, use_reentrant=False)
        else:
            x = block(bp, x)
    x = gather_from_sp(x, sp, 1)
    if pad_t:
        x = x[:, :Tf]
    return layer_norm(params["ln_post"], x), feat_lengths


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------

def convert_hf_whisper_encoder(state_dict: dict[str, Any], cfg: WhisperConfig) -> Params:
    """An HF ``WhisperModel`` (or ``WhisperForConditionalGeneration``, or
    encoder-only) state dict -> the port's tree. Keys with or without the
    ``model.encoder.`` / ``encoder.`` prefix; dense weights ``[out, in]``
    become ``[in, out]``, conv kernels keep ``[out, in, k]``."""
    sd = Prefixed(state_dict, ("model.encoder.", "encoder.", ""))
    arr, lin, ln = sd.arr, sd.lin, sd.ln

    blocks = []
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        blocks.append({
            "attn": {
                "q": lin(pre + "self_attn.q_proj"),
                "k": lin(pre + "self_attn.k_proj", bias=False),
                "v": lin(pre + "self_attn.v_proj"),
                "o": lin(pre + "self_attn.out_proj"),
            },
            "ln1": ln(pre + "self_attn_layer_norm"),
            "fc1": lin(pre + "fc1"),
            "fc2": lin(pre + "fc2"),
            "ln2": ln(pre + "final_layer_norm"),
        })
    return {
        "conv1": {"w": arr("conv1.weight"), "b": arr("conv1.bias")},
        "conv2": {"w": arr("conv2.weight"), "b": arr("conv2.bias")},
        "pos": arr("embed_positions.weight"),
        "blocks": blocks,
        "ln_post": ln("layer_norm"),
    }
