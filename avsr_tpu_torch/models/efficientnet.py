"""EfficientNet video encoder, the port of ``avsr_tpu/models/efficientnet.py``.

Each frame runs the MBConv trunk and its pooled top embedding is that
frame's feature, the same [B, T, d] contract as CLIP and ResNet. Padded
frames run through the trunk too, as in the JAX package.

The numerics are HF ``transformers.EfficientNetModel``'s
(google/efficientnet-b*), with its TF-style asymmetric padding: the stem
zero-pads (0, 1, 0, 1) before a VALID stride-2 conv, and a stride-2
depthwise conv pads (k//2 - 1, k//2) per side (``adjust_padding``; the
blocks listed in ``depthwise_padding`` pad symmetrically). ``F.conv2d``
pads only symmetrically, so the pads are explicit ``F.pad`` calls.
BatchNorm (eps 1e-3) runs in inference mode from the running statistics,
folded in f32 as ResNet's. Squeeze-excite acts on the 1 x 1 mean, and
stochastic depth is the identity at inference.

The convolutions are ``torch`` calls (cuDNN on the card), as they are XLA
convolutions in the JAX package. ``remat`` recomputes the trunk in the
backward while grad mode is on.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from avsr_tpu_torch.core.config import EfficientNetConfig
from avsr_tpu_torch.core.hf_files import Prefixed
from avsr_tpu_torch.models.layers import Params
from avsr_tpu_torch.models.resnet import bn_fold, bn_init, conv_init, hf_bn

BN_EPS = 1e-3          # HF's batch_norm_eps for EfficientNet


# ---------------------------------------------------------------------------
# Static block plan (HF EfficientNetEncoder.__init__)
# ---------------------------------------------------------------------------

def round_filters(cfg: EfficientNetConfig, num_channels: int) -> int:
    """Width-multiplier channel rounding (HF modeling_efficientnet)."""
    divisor = cfg.depth_divisor
    num_channels *= cfg.width_coefficient
    new_dim = max(divisor, int(num_channels + divisor / 2) // divisor * divisor)
    if new_dim < 0.9 * num_channels:
        new_dim += divisor
    return int(new_dim)


class BlockPlan(NamedTuple):
    in_dim: int
    out_dim: int
    stride: int
    kernel: int
    expand_ratio: int
    id_skip: bool          # the first block of a stage: no residual
    adjust_padding: bool   # asymmetric (k//2 - 1, k//2) pad at stride 2


def block_plan(cfg: EfficientNetConfig) -> list[BlockPlan]:
    plans: list[BlockPlan] = []
    for i in range(len(cfg.in_channels)):
        in_dim = round_filters(cfg, cfg.in_channels[i])
        out_dim = round_filters(cfg, cfg.out_channels[i])
        for j in range(int(math.ceil(cfg.depth_coefficient * cfg.num_block_repeats[i]))):
            plans.append(BlockPlan(
                in_dim=out_dim if j > 0 else in_dim, out_dim=out_dim,
                stride=1 if j > 0 else cfg.strides[i], kernel=cfg.kernel_sizes[i],
                expand_ratio=cfg.expand_ratios[i], id_skip=j == 0,
                adjust_padding=len(plans) not in cfg.depthwise_padding))
    return plans


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_efficientnet(gen: torch.Generator, cfg: EfficientNetConfig,
                      dtype: torch.dtype = torch.float32) -> Params:
    plans = block_plan(cfg)
    top = round_filters(cfg, 1280)
    # HF builds top_conv at round_filters(1280) and top_bn at hidden_dim;
    # every published b* checkpoint keeps them equal
    if top != cfg.hidden_dim:
        raise ValueError(f"efficientnet.hidden_dim must equal round_filters(1280)={top}, "
                         f"got {cfg.hidden_dim}")
    stem_dim = round_filters(cfg, 32)
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)  # noqa: E731
    blocks = []
    for p in plans:
        exp = p.in_dim * p.expand_ratio
        dim_se = max(1, int(p.in_dim * cfg.squeeze_expansion_ratio))
        b: Params = {}
        if p.expand_ratio != 1:
            b["expand"] = {"conv": {"w": conv_init(gen, (exp, p.in_dim, 1, 1), dtype)},
                           "bn": bn_init(gen, exp, dtype)}
        b["dw"] = {"conv": {"w": conv_init(gen, (exp, 1, p.kernel, p.kernel), dtype)},
                   "bn": bn_init(gen, exp, dtype)}
        b["se"] = {"reduce": {"w": conv_init(gen, (dim_se, exp, 1, 1), dtype),
                              "b": zeros(dim_se)},
                   "expand": {"w": conv_init(gen, (exp, dim_se, 1, 1), dtype),
                              "b": zeros(exp)}}
        b["project"] = {"conv": {"w": conv_init(gen, (p.out_dim, exp, 1, 1), dtype)},
                        "bn": bn_init(gen, p.out_dim, dtype)}
        blocks.append(b)
    return {
        "stem": {"conv": {"w": conv_init(gen, (stem_dim, 3, 3, 3), dtype)},
                 "bn": bn_init(gen, stem_dim, dtype)},
        "blocks": blocks,
        "top": {"conv": {"w": conv_init(gen, (top, plans[-1].out_dim, 1, 1), dtype)},
                "bn": bn_init(gen, cfg.hidden_dim, dtype)},
    }


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _bn(p: Params, x: torch.Tensor) -> torch.Tensor:
    return bn_fold(p, x, BN_EPS)


def _conv(w: torch.Tensor, x: torch.Tensor, *, stride: int = 1, pad: tuple | None = None,
          groups: int = 1) -> torch.Tensor:
    """A conv with TF's SAME padding (``pad`` None; stride 1, odd kernels)
    or an explicit (lo, hi) pad of both spatial axes before a VALID conv."""
    if pad is None:
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=w.shape[-1] // 2,
                        groups=groups)
    lo, hi = pad
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w.to(x.dtype), stride=stride,
                    groups=groups)


def _block(b: Params, x: torch.Tensor, p: BlockPlan) -> torch.Tensor:
    inputs = x
    if p.expand_ratio != 1:
        x = F.silu(_bn(b["expand"]["bn"], _conv(b["expand"]["conv"]["w"], x)))
    k = p.kernel
    pad = None
    if p.stride == 2:
        pad = (k // 2 - 1, k // 2) if p.adjust_padding else (k // 2, k // 2)
    x = _conv(b["dw"]["conv"]["w"], x, stride=p.stride, pad=pad, groups=x.shape[1])
    x = F.silu(_bn(b["dw"]["bn"], x))
    # squeeze-excite over the expanded features
    se = b["se"]
    s = x.mean(dim=(2, 3), keepdim=True)
    s = F.silu(_conv(se["reduce"]["w"], s) + se["reduce"]["b"].to(x.dtype)[None, :, None, None])
    s = torch.sigmoid(_conv(se["expand"]["w"], s)
                      + se["expand"]["b"].to(x.dtype)[None, :, None, None])
    x = _bn(b["project"]["bn"], _conv(b["project"]["conv"]["w"], x * s))
    if p.stride == 1 and not p.id_skip:
        x = x + inputs
    return x


def _trunk(params: Params, x: torch.Tensor, cfg: EfficientNetConfig) -> torch.Tensor:
    """[N, 3, S, S] -> pooled [N, hidden_dim]."""
    x = _conv(params["stem"]["conv"]["w"], x, stride=2, pad=(0, 1))   # ZeroPad2d(0,1,0,1)
    x = F.silu(_bn(params["stem"]["bn"], x))
    for b, p in zip(params["blocks"], block_plan(cfg)):
        x = _block(b, x, p)
    x = F.silu(_bn(params["top"]["bn"], _conv(params["top"]["conv"]["w"], x)))
    return x.mean(dim=(2, 3))


def efficientnet_apply(params: Params, frames: torch.Tensor, cfg: EfficientNetConfig, *,
                       compute_dtype: torch.dtype = torch.float32,
                       remat: bool = False) -> torch.Tensor:
    """frames [B, T, 3, S, S] (or [N, 3, S, S]) -> per-frame features
    [B, T, hidden_dim] (or [N, d])."""
    squeeze_time = frames.ndim == 4
    if squeeze_time:
        frames = frames[:, None]
    B, T = frames.shape[:2]
    flat = frames.reshape(B * T, *frames.shape[2:]).to(compute_dtype)
    if remat and torch.is_grad_enabled():
        pooled = checkpoint(_trunk, params, flat, cfg, use_reentrant=False)
    else:
        pooled = _trunk(params, flat, cfg)
    out = pooled.reshape(B, T, -1)
    return out[:, 0] if squeeze_time else out


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------

def convert_hf_efficientnet(state_dict: dict[str, Any], cfg: EfficientNetConfig) -> Params:
    """An HF ``EfficientNetModel`` or ``EfficientNetForImageClassification``
    (google/efficientnet-b*) state dict -> the port's tree. The
    ``efficientnet.`` prefix is optional; the classifier and
    ``num_batches_tracked`` are not read."""
    sd = Prefixed(state_dict, ("efficientnet.", ""))
    arr = sd.arr
    blocks = []
    for i, p in enumerate(block_plan(cfg)):
        pre = f"encoder.blocks.{i}."
        b: Params = {}
        if p.expand_ratio != 1:
            b["expand"] = {"conv": {"w": arr(pre + "expansion.expand_conv.weight")},
                           "bn": hf_bn(sd, pre + "expansion.expand_bn")}
        b["dw"] = {"conv": {"w": arr(pre + "depthwise_conv.depthwise_conv.weight")},
                   "bn": hf_bn(sd, pre + "depthwise_conv.depthwise_norm")}
        b["se"] = {"reduce": {"w": arr(pre + "squeeze_excite.reduce.weight"),
                              "b": arr(pre + "squeeze_excite.reduce.bias")},
                   "expand": {"w": arr(pre + "squeeze_excite.expand.weight"),
                              "b": arr(pre + "squeeze_excite.expand.bias")}}
        b["project"] = {"conv": {"w": arr(pre + "projection.project_conv.weight")},
                        "bn": hf_bn(sd, pre + "projection.project_bn")}
        blocks.append(b)
    return {
        "stem": {"conv": {"w": arr("embeddings.convolution.weight")},
                 "bn": hf_bn(sd, "embeddings.batchnorm")},
        "blocks": blocks,
        "top": {"conv": {"w": arr("encoder.top_conv.weight")},
                "bn": hf_bn(sd, "encoder.top_bn")},
    }
