"""Datasets, the port of ``avsr_tpu/data/dataset.py``: the LRS3-style
manifest dataset and the synthetic one.

The host side stays thin: it decodes media and emits raw uint8 frames and
float32 waveforms; log-mel and image normalization run on the device
(``ops/logmel.py``, ``ops/image.py``).

``ManifestAVSRDataset`` reads a split's manifest and labels (``valid``
reads ``val_*``), keeps the reference's resilience (a corrupt or missing
sample walks forward over up to ``MAX_RETRY_WALK`` indices before raising)
and, with ``defer_audio`` (the default when the native library is
available), leaves WAV decode to the loader, which decodes each batch in
one native call. ``SyntheticAVSRDataset`` gives deterministic random
samples with byte-tokenizable transcripts, the same as the JAX package's
for the same seed and index. Both give ``length_hints`` (a sample's audio
samples and video frames without reading it), which multi-process loaders
agree on buckets from. ``build_dataset`` picks one by
``data.synthetic``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from avsr_tpu_torch import native
from avsr_tpu_torch.core.config import DataConfig
from avsr_tpu_torch.data.audio_io import load_audio
from avsr_tpu_torch.data.manifest import load_labels, load_manifest
from avsr_tpu_torch.data.video_io import load_frames

MAX_RETRY_WALK = 10


@dataclass
class Sample:
    utt_id: str
    audio: np.ndarray | None       # float32 [n_samples] @ 16 kHz
    frames: np.ndarray | None      # uint8 [T, S, S, 3] (host-resized)
    text: str
    tokens: list[int]              # label token ids (no BOS, with EOS)
    # set instead of ``audio`` when the decode is left to the loader's
    # native batch decode (native.decode_wav_batch)
    audio_path: str | None = None


class ManifestAVSRDataset:
    def __init__(self, cfg: DataConfig, tokenizer, split: str = "train",
                 modality: str = "both", image_size: int = 224,
                 defer_audio: bool | None = None) -> None:
        """``defer_audio`` (default: the native library is available)
        leaves WAV decode to the DataLoader, which decodes each batch in
        one threaded native call."""
        key = split.replace("valid", "val")
        manifest_name = getattr(cfg, f"{key}_manifest", None) or f"{split}.tsv"
        labels_name = getattr(cfg, f"{key}_labels", None) or f"{split}.wrd"
        base = _discover_data_dir(Path(cfg.path), manifest_name)
        self.root, self.entries = load_manifest(base / manifest_name)
        self.texts = load_labels(base / labels_name)
        if len(self.texts) != len(self.entries):
            raise ValueError(f"{split}: {len(self.entries)} manifest rows vs "
                             f"{len(self.texts)} label lines")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.modality = modality
        self.image_size = image_size
        self.defer_audio = native.available() if defer_audio is None else defer_audio

    def __len__(self) -> int:
        return len(self.entries)

    def length_hints(self, idx: int) -> tuple[int, int]:
        """(audio_samples, video_frames) from the manifest's metadata alone,
        without reading media: the loaders of a multi-process run agree on
        a batch's bucket from these (``DataLoader(data_shard=)``)."""
        e = self.entries[idx]
        return e.num_samples, e.num_frames

    def __getitem__(self, idx: int) -> Sample:
        last_err: Exception | None = None
        for probe in range(MAX_RETRY_WALK):
            i = (idx + probe) % len(self.entries)
            try:
                return self._load(i)
            except Exception as e:  # noqa: BLE001 — the reference's retry walk
                last_err = e
        raise IOError(f"failed to load sample {idx} after {MAX_RETRY_WALK} "
                      "retries") from last_err

    def _load(self, i: int) -> Sample:
        e = self.entries[i]
        text = self.texts[i]
        audio = frames = audio_path = None
        if self.modality in ("audio", "both"):
            path = self.root / e.audio_path
            if self.defer_audio:
                if not path.is_file():   # keep the retry walk on missing files
                    raise FileNotFoundError(path)
                audio_path = str(path)
            else:
                audio = load_audio(path, max_samples=self.cfg.max_audio_length)
        if self.modality in ("video", "both"):
            raw = load_frames(self.root / e.video_path, self.cfg.max_video_length)
            frames = resize_crop_frames(raw, self.image_size)
        tokens = _label_tokens(self.tokenizer, text, self.cfg.max_label_length)
        return Sample(e.utt_id, audio, frames, text, tokens, audio_path=audio_path)


def _label_tokens(tok, text: str, max_len: int) -> list[int]:
    """``text`` with EOS, cut to ``max_len`` ids with the EOS kept."""
    tokens = tok.encode(text, add_eos=True)
    if len(tokens) > max_len:
        tokens = tokens[: max_len - 1] + [tok.eos_id]
    return tokens


def _discover_data_dir(path: Path, manifest_name: str) -> Path:
    """The directory holding the manifest: root, root/train or root/data."""
    for cand in (path, path / "train", path / "data"):
        if (cand / manifest_name).exists():
            return cand
    raise FileNotFoundError(f"{manifest_name} not found under {path}")


def resize_crop_frames(frames: np.ndarray, size: int) -> np.ndarray:
    """uint8 [T,H,W,3] -> uint8 [T,size,size,3]: shortest-side bilinear
    resize and a centre crop on the host, so the host->device copy stays
    uint8. The JAX package's dispatch: cv2 on hosts of fewer than 4 cores
    (its SIMD bilinear wins there), the native library's threads otherwise;
    torch's bilinear (half-pixel centres, no antialiasing) when neither is
    there. The routes may differ by one step of 255. Frames already at
    ``size`` come back as they are."""
    T, H, W, _ = frames.shape
    if H == size and W == size:
        return frames
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None or (os.cpu_count() or 1) >= 4:
        out = native.resize_crop_frames(frames, size)
        if out is not None:
            return out
    if H <= W:
        nh, nw = size, max(size, int(round(W * size / H)))
    else:
        nh, nw = max(size, int(round(H * size / W))), size
    if cv2 is not None:
        out = np.empty((T, nh, nw, 3), np.uint8)
        for t in range(T):
            out[t] = cv2.resize(frames[t], (nw, nh), interpolation=cv2.INTER_LINEAR)
    else:
        x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).float()
        y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
        out = y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()
    top, left = (nh - size) // 2, (nw - size) // 2
    return np.ascontiguousarray(out[:, top:top + size, left:left + size])


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

    def length_hints(self, idx: int) -> tuple[int, int]:
        """(audio_samples, video_frames) without making the sample: the
        draws of :meth:`__getitem__` replayed in order (``transcript`` has
        a generator of its own), so the hints are exact."""
        rng = np.random.default_rng(self.seed + idx)
        n_a = n_v = 0
        if self.modality in ("audio", "both"):
            n_a = int(rng.integers(8000, min(self.cfg.max_audio_length, 48000)))
        if self.modality in ("video", "both"):
            n_v = int(rng.integers(4, min(self.cfg.max_video_length, 16) + 1))
        return n_a, n_v

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
        tokens = _label_tokens(self.tokenizer, text, self.cfg.max_label_length)
        return Sample(f"synthetic/{idx:05d}", audio, frames, text, tokens)


def build_dataset(cfg: DataConfig, tokenizer, **kw):
    """The synthetic dataset with ``data.synthetic``, else the manifest
    dataset; ``kw`` (``split``, ``modality``, ``image_size``) goes to it."""
    cls = SyntheticAVSRDataset if cfg.synthetic else ManifestAVSRDataset
    return cls(cfg, tokenizer, **kw)
