"""CLIP ViT vision encoder, the port of ``avsr_tpu/models/clip_vit.py``.

    frames [B, T, 3, S, S] -> patchify (one matmul) -> +CLS +learned
    positions -> pre-LN -> N x pre-LN blocks (quick-gelu) -> CLS per frame

``ln_post`` is kept in the parameter tree for checkpoint parity; the CLS
feature the model consumes is taken before it.

At CLIP-B/32 a frame is 50 tokens, below the kernel's 256-token threshold,
so attention takes the plain path, as in the JAX package. ``remat``
recomputes each block in the backward while grad mode is on. Under fsdp
each block gathers its sharded leaves when it runs; under tp each block
runs Megatron on its slices (12 heads over tp=2 or 4; over 8 it gathers
and runs whole) and the patch projection, sharded by its columns, is
gathered where it is used.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from avsr_tpu_torch.core.config import ClipConfig
from avsr_tpu_torch.core.hf_files import Prefixed
from avsr_tpu_torch.mesh.sharding import gather_leaf
from avsr_tpu_torch.models.layers import (
    Params,
    encoder_block_init,
    gathered_block,
    layer_norm,
    norm_init,
    normal_init,
    quick_gelu,
)


def num_patches(cfg: ClipConfig) -> int:
    return (cfg.image_size // cfg.patch_size) ** 2


def init_clip_vit(gen: torch.Generator, cfg: ClipConfig,
                  dtype: torch.dtype = torch.float32) -> Params:
    d = cfg.d_model
    return {
        "patch": {"w": normal_init(gen, (cfg.patch_size * cfg.patch_size * 3, d),
                                   std=d ** -0.5, dtype=dtype)},
        "cls": normal_init(gen, (d,), std=d ** -0.5, dtype=dtype),
        "pos": normal_init(gen, (num_patches(cfg) + 1, d), std=0.02, dtype=dtype),
        "ln_pre": norm_init(gen, d, dtype=dtype),
        "blocks": [encoder_block_init(gen, d, d * cfg.ffn_mult, dtype=dtype)
                   for _ in range(cfg.n_layers)],
        "ln_post": norm_init(gen, d, dtype=dtype),
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[N, 3, S, S] -> [N, (S/p)^2, 3*p*p], (c, ph, pw) flattened in order."""
    N, C, S, _ = images.shape
    g = S // patch
    x = images.reshape(N, C, g, patch, g, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)                 # [N, g, g, C, p, p]
    return x.reshape(N, g * g, C * patch * patch)


def clip_vit_apply(params: Params, frames: torch.Tensor, cfg: ClipConfig, *,
                   compute_dtype: torch.dtype = torch.float32,
                   use_kernel: str = "auto", remat: bool = False) -> torch.Tensor:
    """frames [B, T, 3, S, S] -> per-frame features [B, T, d]: the CLS token
    of the last hidden state, without post-LN (the reference's feature)."""
    B, T = frames.shape[:2]
    flat = frames.reshape(B * T, *frames.shape[2:]).to(compute_dtype)

    x = patchify(flat, cfg.patch_size)
    x = torch.matmul(x, gather_leaf(params["patch"]["w"]).to(compute_dtype))
    cls = params["cls"].to(compute_dtype).expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)                  # [N, P+1, d]
    x = x + params["pos"].to(compute_dtype)[None]
    x = layer_norm(params["ln_pre"], x)
    block = functools.partial(gathered_block, n_heads=cfg.n_heads,
                              act=quick_gelu, use_kernel=use_kernel)
    for bp in params["blocks"]:
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, bp, x, use_reentrant=False)
        else:
            x = block(bp, x)
    return x[:, 0].reshape(B, T, -1)


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------

def convert_hf_clip_vision(state_dict: dict[str, Any], cfg: ClipConfig) -> Params:
    """An HF ``CLIPVisionModel`` (or ``CLIPModel``) state dict -> the port's
    tree. The patch conv ``[d, 3, p, p]`` becomes the patchify matmul's
    ``[3 * p * p, d]`` in (c, ph, pw) order; dense weights are transposed."""
    sd = Prefixed(state_dict, ("vision_model.", "clip.vision_model.", ""))
    arr, lin, ln = sd.arr, sd.lin, sd.ln

    conv = arr("embeddings.patch_embedding.weight")     # [d, 3, p, p]
    blocks = []
    for i in range(cfg.n_layers):
        pre = f"encoder.layers.{i}."
        blocks.append({
            "attn": {
                "q": lin(pre + "self_attn.q_proj"),
                "k": lin(pre + "self_attn.k_proj"),
                "v": lin(pre + "self_attn.v_proj"),
                "o": lin(pre + "self_attn.out_proj"),
            },
            "ln1": ln(pre + "layer_norm1"),
            "fc1": lin(pre + "mlp.fc1"),
            "fc2": lin(pre + "mlp.fc2"),
            "ln2": ln(pre + "layer_norm2"),
        })
    return {
        "patch": {"w": conv.reshape(conv.shape[0], -1).T.contiguous()},
        "cls": arr("embeddings.class_embedding"),
        "pos": arr("embeddings.position_embedding.weight"),
        "ln_pre": ln("pre_layrnorm"),
        "blocks": blocks,
        "ln_post": ln("post_layernorm"),
    }
