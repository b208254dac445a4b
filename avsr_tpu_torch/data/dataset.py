"""The synthetic AV dataset, a copy of
``avsr_tpu/data/dataset.py::SyntheticAVSRDataset``.

Deterministic random samples with byte-tokenizable transcripts, so the
whole serving path (including WER) runs with no media assets; the same
seed and index give the same sample as the JAX package's dataset.
``resize_crop_frames`` brings decoded frames to the model's image size on
the host. The manifest dataset is still to be ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from avsr_tpu_torch.core.config import DataConfig


@dataclass
class Sample:
    utt_id: str
    audio: np.ndarray | None       # float32 [n_samples] @ 16 kHz
    frames: np.ndarray | None      # uint8 [T, S, S, 3]
    text: str
    tokens: list[int]              # label token ids (no BOS, with EOS)


def resize_crop_frames(frames: np.ndarray, size: int) -> np.ndarray:
    """uint8 [T,H,W,3] -> uint8 [T,size,size,3]: shortest-side bilinear
    resize (half-pixel centres, no antialiasing, as cv2's INTER_LINEAR)
    and a centre crop, on the host's CPU with torch (the JAX package uses
    cv2 or its native library; values may differ by one step of 255).
    Frames already at ``size`` come back as they are."""
    T, H, W, _ = frames.shape
    if H == size and W == size:
        return frames
    if H <= W:
        nh, nw = size, max(size, int(round(W * size / H)))
    else:
        nh, nw = max(size, int(round(H * size / W))), size
    x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    y = y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    top, left = (nh - size) // 2, (nw - size) // 2
    return np.ascontiguousarray(y[:, top:top + size, left:left + size].numpy())


_WORDS = ("the quick brown fox jumps over a lazy dog while seven wizards "
          "brew hazy potions at midnight near the old stone bridge").split()


class SyntheticAVSRDataset:
    """Deterministic random AV samples with real text transcripts."""

    def __init__(self, cfg: DataConfig, tokenizer, split: str = "train",
                 modality: str = "both", image_size: int = 224,
                 seed: int = 0) -> None:
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.modality = modality
        self.image_size = image_size
        self.size = (cfg.synthetic_size if split == "train"
                     else max(cfg.synthetic_size // 5, 2))
        self.seed = seed + (0 if split == "train" else 10_000)

    def __len__(self) -> int:
        return self.size

    def transcript(self, idx: int) -> str:
        rng = np.random.default_rng(self.seed + idx)
        n = int(rng.integers(2, 8))
        return " ".join(rng.choice(_WORDS, n))

    def __getitem__(self, idx: int) -> Sample:
        rng = np.random.default_rng(self.seed + idx)
        text = self.transcript(idx)
        audio = frames = None
        if self.modality in ("audio", "both"):
            n = int(rng.integers(8000, min(self.cfg.max_audio_length, 48000)))
            t = np.arange(n, dtype=np.float32) / 16000.0
            f0 = float(rng.uniform(80, 300))
            audio = (0.3 * np.sin(2 * np.pi * f0 * t)
                     + 0.05 * rng.standard_normal(n)).astype(np.float32)
        if self.modality in ("video", "both"):
            T = int(rng.integers(4, min(self.cfg.max_video_length, 16) + 1))
            frames = rng.integers(
                0, 256, (T, self.image_size, self.image_size, 3)).astype(np.uint8)
        tokens = self.tokenizer.encode(text, add_eos=True)
        if len(tokens) > self.cfg.max_label_length:
            tokens = (tokens[: self.cfg.max_label_length - 1]
                      + [self.tokenizer.eos_id])
        return Sample(f"synthetic/{idx:05d}", audio, frames, text, tokens)
