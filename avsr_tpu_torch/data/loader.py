"""Collate and on-device featurize, the port of the corresponding parts of
``avsr_tpu/data/loader.py``.

  * ``collate`` pads raw waveforms and uint8 frames up to a length bucket
    (``DataConfig.audio_buckets``/``video_buckets``), pads labels with
    pad_id and carries explicit lengths, and tiles the prompt ids.
  * ``featurize`` moves a host batch to the device and computes the
    log-mel and the normalized frames there.
  * ``iter_batches`` walks a dataset in order, wrap-padding the final short
    batch (its repeated rows get label length 0).

The threaded prefetching loader, shuffling, multi-host sharding and the
compact int16/YUV420 link format are still to be ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from avsr_tpu_torch.core.config import DataConfig
from avsr_tpu_torch.data.dataset import Sample
from avsr_tpu_torch.models.avsr import Batch
from avsr_tpu_torch.ops.image import normalize_frames
from avsr_tpu_torch.ops.logmel import HOP_LENGTH, log_mel_spectrogram


@dataclass
class HostBatch:
    """Padded numpy batch, before the device."""

    utt_ids: list[str]
    texts: list[str]
    audio: np.ndarray | None       # [B, S_a] f32
    audio_lens: np.ndarray | None  # [B]
    frames: np.ndarray | None      # [B, T_v, S, S, 3] u8
    frame_lens: np.ndarray | None  # [B]
    labels: np.ndarray             # [B, L] int32 (pad_id-padded)
    label_lens: np.ndarray         # [B]
    prompt: np.ndarray             # [B, Tp] int32


def pick_bucket(value: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def collate(samples: list[Sample], cfg: DataConfig, prompt_ids: list[int],
            pad_id: int) -> HostBatch:
    """Pad a list of samples to the smallest static bucket shapes that fit."""
    if cfg.compact_transfer:
        raise NotImplementedError("data.compact_transfer is not yet ported")
    B = len(samples)
    audio = audio_lens = frames = frame_lens = None
    if samples[0].audio is not None:
        mel_lens = [min(s.audio.shape[0], cfg.max_audio_length) // HOP_LENGTH
                    for s in samples]
        bucket = pick_bucket(max(mel_lens), cfg.audio_buckets)
        S_a = bucket * HOP_LENGTH
        audio = np.zeros((B, S_a), np.float32)
        audio_lens = np.zeros((B,), np.int32)
        for i, s in enumerate(samples):
            n = min(s.audio.shape[0], S_a)
            audio[i, :n] = s.audio[:n]
            audio_lens[i] = n
    if samples[0].frames is not None:
        t_lens = [s.frames.shape[0] for s in samples]
        bucket = pick_bucket(max(t_lens), cfg.video_buckets)
        S = samples[0].frames.shape[1]
        frames = np.zeros((B, bucket, S, S, 3), np.uint8)
        frame_lens = np.zeros((B,), np.int32)
        for i, s in enumerate(samples):
            t = min(s.frames.shape[0], bucket)
            frames[i, :t] = s.frames[:t]
            frame_lens[i] = t
    L = cfg.max_label_length
    labels = np.full((B, L), pad_id, np.int32)
    label_lens = np.zeros((B,), np.int32)
    for i, s in enumerate(samples):
        n = min(len(s.tokens), L)
        labels[i, :n] = s.tokens[:n]
        label_lens[i] = n
    prompt = np.tile(np.asarray(prompt_ids, np.int32)[None], (B, 1))
    return HostBatch([s.utt_id for s in samples], [s.text for s in samples],
                     audio, audio_lens, frames, frame_lens, labels, label_lens,
                     prompt)


def featurize(hb: HostBatch, device: str | torch.device = "cuda",
              compute_dtype: torch.dtype = torch.float32) -> Batch:
    """Host batch -> device Batch: log-mel and frame normalization on the
    device."""
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    mel = mel_lens = vframes = None
    if hb.audio is not None:
        audio_lens = dev(hb.audio_lens)
        mel = log_mel_spectrogram(dev(hb.audio), audio_lens)
        mel_lens = audio_lens // HOP_LENGTH
    if hb.frames is not None:
        vframes = normalize_frames(dev(hb.frames), dtype=compute_dtype)
    return Batch(mel=mel, mel_lens=mel_lens, frames=vframes,
                 frame_lens=dev(hb.frame_lens) if hb.frame_lens is not None else None,
                 prompt_tokens=dev(hb.prompt), labels=dev(hb.labels),
                 label_lens=dev(hb.label_lens))


def iter_batches(ds, cfg: DataConfig, tokenizer, prompt: str, batch_size: int,
                 *, device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.float32
                 ) -> Iterator[tuple[HostBatch, Batch]]:
    """(HostBatch, device Batch) over ``ds`` in order. The final short batch
    is filled by wrapping to the dataset head; those rows get label length
    0 and repeat utterance ids that a consumer skips."""
    prompt_ids = tokenizer.encode(prompt, add_bos=True)
    n = len(ds)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        n_real = len(idx)
        idx += [i % n for i in range(batch_size - n_real)]
        hb = collate([ds[i] for i in idx], cfg, prompt_ids, tokenizer.pad_id)
        hb.label_lens[n_real:] = 0
        yield hb, featurize(hb, device, compute_dtype)
