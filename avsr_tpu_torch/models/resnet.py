"""ResNet video encoder, the port of ``avsr_tpu/models/resnet.py``.

Each video frame goes through the trunk (stem conv, max pool, residual
stages, global mean) and its pooled embedding is that frame's feature, the
same [B, T, d] contract as CLIP. Padded frames run through the trunk too,
as in the JAX package; the connector masks them by ``frame_lens``.

The numerics are HF ``transformers.ResNetModel``'s, with ``bottleneck``
(resnet-50+) and ``basic`` (resnet-18/34) layers. BatchNorm runs in
inference mode from the stored running statistics, folded to a scale and
shift in f32 and then cast to the activation dtype, as JAX folds it. A
layer that carries ``prelus`` (AV-HuBERT's trunk, which reuses
:func:`resnet_stages`) takes per-channel PReLU in place of ReLU.

The convolutions are ``torch`` calls (cuDNN on the card), as they are XLA
convolutions in the JAX package: no Pallas kernel covers them. ``remat``
recomputes the trunk in the backward while grad mode is on.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from avsr_tpu_torch.core.config import ResNetConfig
from avsr_tpu_torch.core.hf_files import Prefixed
from avsr_tpu_torch.models.layers import Params


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def conv_init(gen: torch.Generator, shape: tuple[int, ...],
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """He-normal conv kernel [O, I, *k] (fan in = I * prod(k))."""
    fan_in = 1
    for n in shape[1:]:
        fan_in *= n
    return torch.empty(shape, dtype=dtype, device=gen.device).normal_(
        0.0, (2.0 / max(fan_in, 1)) ** 0.5, generator=gen)


def bn_init(gen: torch.Generator, c: int, dtype: torch.dtype = torch.float32) -> Params:
    dev = gen.device
    return {"scale": torch.ones((c,), dtype=dtype, device=dev),
            "b": torch.zeros((c,), dtype=dtype, device=dev),
            "mean": torch.zeros((c,), dtype=dtype, device=dev),
            "var": torch.ones((c,), dtype=dtype, device=dev)}


def _conv_bn_init(gen: torch.Generator, c_out: int, c_in: int, k: int,
                  dtype: torch.dtype) -> Params:
    return {"conv": {"w": conv_init(gen, (c_out, c_in, k, k), dtype)},
            "bn": bn_init(gen, c_out, dtype)}


def _layer_init(gen: torch.Generator, c_in: int, c_out: int, stride: int,
                cfg: ResNetConfig, dtype: torch.dtype) -> Params:
    p: Params = {}
    if cfg.layer_type == "bottleneck":
        mid = c_out // cfg.reduction
        p["convs"] = [_conv_bn_init(gen, mid, c_in, 1, dtype),
                      _conv_bn_init(gen, mid, mid, 3, dtype),
                      _conv_bn_init(gen, c_out, mid, 1, dtype)]
    else:                                       # basic (resnet-18/34)
        p["convs"] = [_conv_bn_init(gen, c_out, c_in, 3, dtype),
                      _conv_bn_init(gen, c_out, c_out, 3, dtype)]
    if c_in != c_out or stride != 1:
        p["shortcut"] = _conv_bn_init(gen, c_out, c_in, 1, dtype)
    return p


def _first_stride(cfg: ResNetConfig, si: int) -> int:
    """The stride of stage ``si``'s first layer."""
    if si == 0:
        return 2 if cfg.downsample_in_first_stage else 1
    return 2


def init_resnet_stages(gen: torch.Generator, cfg: ResNetConfig,
                       dtype: torch.dtype = torch.float32) -> list:
    stages = []
    c_in = cfg.embedding_size
    for si, (c_out, depth) in enumerate(zip(cfg.hidden_sizes, cfg.depths)):
        stages.append([_layer_init(gen, c_in if li == 0 else c_out, c_out,
                                   _first_stride(cfg, si) if li == 0 else 1, cfg, dtype)
                       for li in range(depth)])
        c_in = c_out
    return stages


def init_resnet(gen: torch.Generator, cfg: ResNetConfig,
                dtype: torch.dtype = torch.float32) -> Params:
    return {"stem": _conv_bn_init(gen, cfg.embedding_size, 3, 7, dtype),
            "stages": init_resnet_stages(gen, cfg, dtype)}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def bn_fold(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm over dim 1: the running statistics folded
    to a scale and shift in f32, cast to x's dtype, then x * scale + shift."""
    inv = torch.rsqrt(p["var"].float() + eps)
    scale = p["scale"].float() * inv
    shift = p["b"].float() - p["mean"].float() * p["scale"].float() * inv
    view = (1, -1) + (1,) * (x.ndim - 2)
    return x * scale.to(x.dtype).view(view) + shift.to(x.dtype).view(view)


def prelu(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU over dim 1: x where x >= 0, else a * x."""
    a = a.to(x.dtype).view((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x >= 0, x, a * x)


def _conv_bn(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = p["conv"]["w"]
    y = F.conv2d(x, w.to(x.dtype), stride=stride, padding=w.shape[-1] // 2)
    return bn_fold(p["bn"], y)


def _act(p: Params, x: torch.Tensor, i: int) -> torch.Tensor:
    """ReLU, or the layer's i-th PReLU when it carries ``prelus``."""
    return prelu(p["prelus"][i], x) if "prelus" in p else F.relu(x)


def _layer_apply(p: Params, x: torch.Tensor, stride: int,
                 cfg: ResNetConfig) -> torch.Tensor:
    res = _conv_bn(p["shortcut"], x, stride) if "shortcut" in p else x
    if cfg.layer_type == "bottleneck":
        y = _act(p, _conv_bn(p["convs"][0], x), 0)
        y = _act(p, _conv_bn(p["convs"][1], y, stride), 1)
        y = _conv_bn(p["convs"][2], y)
        return _act(p, y + res, 2)
    y = _act(p, _conv_bn(p["convs"][0], x, stride), 0)
    y = _conv_bn(p["convs"][1], y)
    return _act(p, y + res, 1)


def resnet_stages(stages: list, x: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """The residual stages only (no stem, no pool): [N, C, H, W] ->
    [N, hidden_sizes[-1], H', W']. AV-HuBERT's front end, which has a 3-D
    stem of its own, reuses it."""
    for si, layers in enumerate(stages):
        for li, lp in enumerate(layers):
            x = _layer_apply(lp, x, _first_stride(cfg, si) if li == 0 else 1, cfg)
    return x


def _trunk(params: Params, x: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """[N, 3, S, S] -> pooled [N, hidden_sizes[-1]]."""
    x = F.relu(_conv_bn(params["stem"], x, 2))
    x = F.max_pool2d(x, 3, 2, 1)                # pads with -inf, as torch's MaxPool2d
    x = resnet_stages(params["stages"], x, cfg)
    return x.mean(dim=(2, 3))                   # AdaptiveAvgPool2d((1, 1))


def resnet_apply(params: Params, frames: torch.Tensor, cfg: ResNetConfig, *,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False) -> torch.Tensor:
    """frames [B, T, 3, S, S] (or [N, 3, S, S]) -> per-frame features
    [B, T, hidden_sizes[-1]] (or [N, d])."""
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

def hf_bn(sd: Prefixed, name: str) -> Params:
    """A torch BatchNorm's weight, bias and running statistics."""
    return {"scale": sd.arr(name + ".weight"), "b": sd.arr(name + ".bias"),
            "mean": sd.arr(name + ".running_mean"), "var": sd.arr(name + ".running_var")}


def convert_hf_resnet(state_dict: dict[str, Any], cfg: ResNetConfig) -> Params:
    """An HF ``ResNetModel`` or ``ResNetForImageClassification``
    (microsoft/resnet-*) state dict -> the port's tree. The ``resnet.``
    prefix is optional; the classifier and ``num_batches_tracked`` are not
    read."""
    sd = Prefixed(state_dict, ("resnet.", ""))

    def conv_bn(name: str) -> Params:
        return {"conv": {"w": sd.arr(name + ".convolution.weight")},
                "bn": hf_bn(sd, name + ".normalization")}

    n_convs = 3 if cfg.layer_type == "bottleneck" else 2
    stages = []
    for si, depth in enumerate(cfg.depths):
        layers = []
        for li in range(depth):
            pre = f"encoder.stages.{si}.layers.{li}."
            p: Params = {"convs": [conv_bn(pre + f"layer.{ci}") for ci in range(n_convs)]}
            if sd.key(pre + "shortcut.convolution.weight") is not None:
                p["shortcut"] = conv_bn(pre + "shortcut")
            layers.append(p)
        stages.append(layers)
    return {"stem": conv_bn("embedder.embedder"), "stages": stages}
