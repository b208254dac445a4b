"""Video-frame normalization on the device, the port of
``avsr_tpu/ops/image.py::normalize_frames`` and of its compact link format.

The host ships uint8 frames, already resized and cropped to S x S; the
rescale to [0, 1], the mean/std normalization with the statistics the
video encoder expects (``stats``: ``clip``, ``imagenet`` for ResNet,
``inception`` for EfficientNet, ``avhubert``) and the channels-first
transpose run on the device.

The compact link format (``data.compact_transfer``) ships frames as planar
YUV420 instead: ``rgb_to_yuv420_np`` packs them on the host (the numpy
fallback of ``native.rgb_to_yuv420``), ``normalize_yuv420_frames``
reconstructs RGB on the device and normalizes it in the same pass.
"""

from __future__ import annotations

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# HF's image processors for microsoft/resnet-*
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# HF's EfficientNetImageProcessor defaults
INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)
# AV-HuBERT's gray lip-crop statistics broadcast to RGB (the encoder averages
# the channels to gray, which commutes with this)
AVHUBERT_MEAN = (0.421, 0.421, 0.421)
AVHUBERT_STD = (0.165, 0.165, 0.165)

STATS = {"clip": (CLIP_MEAN, CLIP_STD),
         "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
         "inception": (INCEPTION_MEAN, INCEPTION_STD),
         "avhubert": (AVHUBERT_MEAN, AVHUBERT_STD)}


def _normalize(x: torch.Tensor, dtype: torch.dtype, stats: str) -> torch.Tensor:
    """f32 [..., S, S, 3] in [0, 1] -> (x - mean) / std as [..., 3, S, S]."""
    mean, std = (torch.tensor(s, dtype=torch.float32, device=x.device)
                 for s in STATS[stats])
    return ((x - mean) / std).movedim(-1, -3).to(dtype)


def normalize_frames(frames: torch.Tensor, dtype: torch.dtype = torch.float32,
                     stats: str = "clip") -> torch.Tensor:
    """uint8 [B,T,S,S,3] -> normalized [B,T,3,S,S] in ``dtype``."""
    return _normalize(frames.float() / 255.0, dtype, stats)


def rgb_to_yuv420_np(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Planar YUV420 packing in numpy (the fallback of
    ``native.rgb_to_yuv420``): u8 [..., S, S, 3] RGB -> (Y u8 [..., S, S],
    UV u8 [..., S/2, S/2, 2]). Full-range BT.601 matrix; chroma is the 2x2
    box average."""
    f = frames.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    S = frames.shape[-2]
    lead = frames.shape[:-3]
    uv = np.stack([u, v], axis=-1)
    uv = uv.reshape(*lead, S // 2, 2, S // 2, 2, 2).mean(axis=(-4, -2))
    to_u8 = lambda x: np.clip(np.rint(x), 0, 255).astype(np.uint8)  # noqa: E731
    return to_u8(y), to_u8(uv)


def normalize_yuv420_frames(y: torch.Tensor, uv: torch.Tensor,
                            dtype: torch.dtype = torch.float32,
                            stats: str = "clip") -> torch.Tensor:
    """Planar YUV420 -> normalized [B,T,3,S,S] on the tensors' device:
    the inverse of the packing (nearest-neighbour chroma upsample, BT.601
    full-range matrix), then the [0, 1] rescale and the normalization."""
    yf = y.float()
    uvf = uv.float() - 128.0
    uvf = uvf.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
    u, v = uvf[..., 0], uvf[..., 1]
    r = yf + 1.402 * v
    g = yf - 0.344136 * u - 0.714136 * v
    b = yf + 1.772 * u
    x = torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0) / 255.0
    return _normalize(x, dtype, stats)
