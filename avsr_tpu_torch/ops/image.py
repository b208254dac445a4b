"""Video-frame preprocessing on the device, the port of
``avsr_tpu/ops/image.py``: the normalization of host-resized frames, its
compact link format, and the whole resize, crop and normalize of raw
frames.

The host ships uint8 frames, already resized and cropped to S x S; the
rescale to [0, 1], the mean/std normalization with the statistics the
video encoder expects (``stats``: ``clip``, ``imagenet`` for ResNet,
``inception`` for EfficientNet, ``avhubert``) and the channels-first
transpose run on the device.

The compact link format (``data.compact_transfer``) ships frames as planar
YUV420 instead: ``rgb_to_yuv420_np`` packs them on the host (the numpy
fallback of ``native.rgb_to_yuv420``), ``normalize_yuv420_frames``
reconstructs RGB on the device and normalizes it in the same pass.

``preprocess_frames`` takes raw uint8 frames of any size on the device: a
bilinear resize of the shortest side to S (half-pixel centres, no
antialiasing, as ``jax.image.resize(..., antialias=False)`` and cv2's
INTER_LINEAR; JAX's weight matrices, so the two agree to f32 rounding), a
centre crop to S x S, then the same normalization. It is plain torch on
the tensor's device: the JAX package has no Pallas kernel here either.
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


def _resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """The [n_in, n_out] bilinear weights of ``jax.image.resize(...,
    antialias=False)``, computed as it computes them in f32: the triangle
    kernel at the half-pixel sample positions, each column normalized to
    sum 1, zero where a sample falls outside the input."""
    inv = float(np.float32(1.0 / (n_out / n_in)))
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - (sample[None, :] - src[:, None]).abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def preprocess_frames(frames: torch.Tensor, image_size: int = 224,
                      dtype: torch.dtype = torch.float32,
                      stats: str = "clip") -> torch.Tensor:
    """uint8 [T,H,W,3] (or [B,T,H,W,3]) -> [T,3,S,S] (or [B,T,3,S,S]) in
    ``dtype`` on the frames' device: the shortest side resized to S
    (bilinear, no antialiasing; a product with :func:`_resize_weights` per
    resized axis, as JAX contracts it), the centre S x S crop, the [0, 1]
    rescale and ``stats``'s normalization."""
    batched = frames.dim() == 5
    if not batched:
        frames = frames[None]
    B, T, H, W, C = frames.shape
    S = image_size
    if H <= W:
        new_h, new_w = S, max(S, int(round(W * S / H)))
    else:
        new_h, new_w = max(S, int(round(H * S / W))), S
    x = frames.float() / 255.0
    if new_h != H:
        x = torch.einsum("bthwc,hk->btkwc", x, _resize_weights(H, new_h, x.device))
    if new_w != W:
        x = torch.einsum("bthwc,wk->bthkc", x, _resize_weights(W, new_w, x.device))
    top, left = (new_h - S) // 2, (new_w - S) // 2
    x = _normalize(x[:, :, top:top + S, left:left + S], dtype, stats)
    return x if batched else x[0]


def sample_frame_indices(num_frames: int, target: int) -> np.ndarray:
    """``target`` frame indices spread uniformly over a clip (all of them
    when it has no more)."""
    if num_frames <= target:
        return np.arange(num_frames)
    return np.linspace(0, num_frames - 1, target).round().astype(np.int64)
