"""Collate and on-device featurize, the port of the corresponding parts of
``avsr_tpu/data/loader.py``.

  * ``collate`` pads raw waveforms and uint8 frames up to a length bucket
    (``DataConfig.audio_buckets``/``video_buckets``), pads labels with
    pad_id and carries explicit lengths, and tiles the prompt ids.
  * ``featurize`` moves a host batch to the device and computes the
    log-mel and the normalized frames there.
  * ``DataLoader`` walks a dataset in a per-epoch shuffled order (numpy's
    ``default_rng(seed + epoch)``, so the order is the JAX loader's) or in
    order, wrap-padding the final short batch (its repeated rows get label
    length 0), with one prefetching worker thread that collates and
    featurizes ahead of the consumer. Its position (``state``,
    ``set_position``) lets a resumed run replay an epoch's order and skip
    the batches already consumed, without loading them.

Multi-host sharding and the compact int16/YUV420 link format are still to
be ported.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np
import torch

from avsr_tpu_torch.core.config import DataConfig, ModelConfig
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


# Batches the worker thread prepares ahead of the consumer.
PREFETCH = 2


class DataLoader:
    """Bucketed, prefetching loader yielding (HostBatch, device Batch)."""

    def __init__(self, dataset, cfg: DataConfig, tokenizer, *,
                 model_cfg: ModelConfig, batch_size: int | None = None,
                 shuffle: bool = True, seed: int = 0,
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.float32) -> None:
        self.ds = dataset
        self.cfg = cfg
        self.batch_size = batch_size or cfg.batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.device = device
        self.compute_dtype = compute_dtype
        self.pad_id = tokenizer.pad_id
        self.prompt_ids = tokenizer.encode(model_cfg.prompt, add_bos=True)
        self._epoch = 0
        self._skip = 0        # batches to skip on the next epoch (resume)
        self._yielded = 0     # batches handed out in the current epoch

    def state(self) -> dict[str, int]:
        """The position: the epoch, and the batches already handed out in
        it (batches the worker read ahead do not count)."""
        return {"epoch": self._epoch, "batches": self._yielded}

    def set_position(self, epoch: int, batches: int) -> None:
        """Resume at (epoch, batch): the next ``iter()`` replays epoch
        ``epoch``'s shuffle and skips its first ``batches`` batches without
        loading their samples."""
        self._epoch = epoch - 1   # __iter__ increments
        self._skip = max(batches, 0)

    def __len__(self) -> int:
        return -(-len(self.ds) // self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx

    def _host_batches(self, skip: int = 0) -> Iterator[HostBatch]:
        order = self._order()
        bs = self.batch_size
        for start in range(skip * bs, len(order), bs):
            chunk = order[start:start + bs]
            n_real = len(chunk)
            if n_real < bs:
                # wrap to the epoch head for a static batch size; the
                # repeated rows get label length 0, so the loss weighs them
                # zero (decode skips their repeated utterance ids)
                chunk = np.concatenate([chunk, order[: bs - n_real]])
            hb = collate([self.ds[int(i)] for i in chunk], self.cfg,
                         self.prompt_ids, self.pad_id)
            hb.label_lens[n_real:] = 0
            yield hb

    def __iter__(self) -> Iterator[tuple[HostBatch, Batch]]:
        """One worker thread collates and featurizes (host -> device copy
        and the on-device log-mel) up to ``PREFETCH`` batches ahead."""
        self._epoch += 1
        skip, self._skip = self._skip, 0
        self._yielded = skip
        q: queue.Queue[Any] = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def worker() -> None:
            try:
                for hb in self._host_batches(skip):
                    if stop.is_set():
                        return
                    q.put((hb, featurize(hb, self.device, self.compute_dtype)))
            except Exception as e:  # noqa: BLE001 — re-raised in the consumer
                q.put(e)
            finally:
                q.put(None)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                self._yielded += 1
                yield item
        finally:
            stop.set()
            while th.is_alive():      # drain so that the worker can exit
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            th.join()
