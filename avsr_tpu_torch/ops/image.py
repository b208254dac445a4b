"""Video-frame normalization on the device, the port of
``avsr_tpu/ops/image.py::normalize_frames``.

The host ships uint8 frames, already resized and cropped to S x S; the
rescale to [0, 1], the CLIP mean/std normalization and the channels-first
transpose run on the device.
"""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_frames(frames: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B,T,S,S,3] -> CLIP-normalized [B,T,3,S,S] in ``dtype``."""
    mean, std = (torch.tensor(s, dtype=torch.float32, device=frames.device)
                 for s in (CLIP_MEAN, CLIP_STD))
    x = frames.float() / 255.0
    x = (x - mean) / std
    return x.permute(0, 1, 4, 2, 3).to(dtype)
