"""Batching, length bucketing, on-device featurize and prefetch, the port
of ``avsr_tpu/data/loader.py``.

  * ``collate`` pads raw waveforms and uint8 frames up to a length bucket
    (``DataConfig.audio_buckets``/``video_buckets``), pads labels with
    pad_id and carries explicit lengths, and tiles the prompt ids. With ``data.compact_transfer`` it packs the link format:
    int16 PCM audio and planar YUV420 frames (~2.3x fewer host->device
    bytes for an AV batch).
  * ``featurize`` moves a host batch to the device and computes the
    log-mel (or, for the HuBERT/Wav2Vec2 encoders its config names, passes
    the padded waveform through) and the frames normalized with the
    statistics of the video encoder it names (``image_stats_for``) there
    (reconstructing f32 audio and RGB frames from the compact format
    first).
  * ``DataLoader`` walks a dataset in a per-epoch shuffled order (numpy's
    ``default_rng(seed + epoch)``, so the order is the JAX loader's) or in
    order, wrap-padding the final short batch (its repeated rows get label
    length 0). It loads a batch's samples over ``data.num_workers``
    threads, decodes the WAVs a manifest dataset deferred in one native
    batch call, and runs one prefetching worker thread that collates and
    featurizes ahead of the consumer. Its position (``state``,
    ``set_position``) lets a resumed run replay an epoch's order and skip
    the batches already consumed, without loading them.

With ``data_shard=(rank, world)`` (one process per card,
``mesh/multihost.py``) ``batch_size`` stays the global batch: every rank
walks the same shuffle and yields only its contiguous rows of each global
batch, collated to the bucket that the whole chunk's ``length_hints``
metadata implies (``_metadata_buckets``), so every rank pads to the same
shapes without reading another rank's media.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Any, Iterator

import numpy as np
import torch

from avsr_tpu_torch import native
from avsr_tpu_torch.core.config import DataConfig, ModelConfig
from avsr_tpu_torch.data.audio_io import load_audio
from avsr_tpu_torch.data.dataset import MAX_RETRY_WALK, Sample
from avsr_tpu_torch.mesh.multihost import local_rows
from avsr_tpu_torch.models.avsr import Batch
from avsr_tpu_torch.ops.image import (normalize_frames, normalize_yuv420_frames,
                                      rgb_to_yuv420_np)
from avsr_tpu_torch.ops.logmel import HOP_LENGTH, log_mel_spectrogram


@dataclass
class HostBatch:
    """Padded numpy batch, before the device."""

    utt_ids: list[str]
    texts: list[str]
    audio: np.ndarray | None       # [B, S_a] f32 (i16 with compact_transfer)
    audio_lens: np.ndarray | None  # [B]
    frames: np.ndarray | None      # [B, T_v, S, S, 3] u8
    frame_lens: np.ndarray | None  # [B]
    labels: np.ndarray             # [B, L] int32 (pad_id-padded)
    label_lens: np.ndarray         # [B]
    prompt: np.ndarray             # [B, Tp] int32
    # planar YUV420 link format (data.compact_transfer; replaces ``frames``)
    frames_y: np.ndarray | None = None   # [B, T_v, S, S] u8
    frames_uv: np.ndarray | None = None  # [B, T_v, S/2, S/2, 2] u8


def pick_bucket(value: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def collate(samples: list[Sample], cfg: DataConfig, prompt_ids: list[int],
            pad_id: int, *, audio_bucket: int | None = None,
            video_bucket: int | None = None) -> HostBatch:
    """Pad a list of samples to the smallest static bucket shapes that fit,
    or to ``audio_bucket`` (mel frames) / ``video_bucket`` (frames) when
    given: a multi-process loader takes them from the global chunk's
    metadata, so that every rank collates its rows to the same shapes."""
    B = len(samples)
    audio = audio_lens = frames = frame_lens = None
    if samples[0].audio is not None:
        mel_lens = [min(s.audio.shape[0], cfg.max_audio_length) // HOP_LENGTH
                    for s in samples]
        bucket = audio_bucket or pick_bucket(max(mel_lens), cfg.audio_buckets)
        S_a = bucket * HOP_LENGTH
        audio = np.zeros((B, S_a), np.float32)
        audio_lens = np.zeros((B,), np.int32)
        for i, s in enumerate(samples):
            n = min(s.audio.shape[0], S_a)
            audio[i, :n] = s.audio[:n]
            audio_lens[i] = n
    if samples[0].frames is not None:
        t_lens = [s.frames.shape[0] for s in samples]
        bucket = video_bucket or pick_bucket(max(t_lens), cfg.video_buckets)
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

    frames_y = frames_uv = None
    if cfg.compact_transfer:
        if audio is not None:
            # int16 PCM: bit-exact round trip for WAV-PCM16 sources (their
            # decoder made these floats as v / 32768), half the bytes
            audio = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
        if frames is not None:
            packed = native.rgb_to_yuv420(frames)
            frames_y, frames_uv = packed if packed is not None else rgb_to_yuv420_np(frames)
            frames = None
    prompt = np.tile(np.asarray(prompt_ids, np.int32)[None], (B, 1))
    return HostBatch([s.utt_id for s in samples], [s.text for s in samples],
                     audio, audio_lens, frames, frame_lens, labels, label_lens,
                     prompt, frames_y, frames_uv)


def _pcm16_to_f32(audio: torch.Tensor) -> torch.Tensor:
    """int16 PCM of the link format -> the f32 waveform the front end reads
    (the exact inverse of the collate quantization for PCM16 sources)."""
    return audio.float() / 32768.0


def audio_frontend_for(model_cfg: ModelConfig | None) -> str:
    """The front end the configured audio encoder reads: ``wave`` (the
    padded f32 waveform, for HuBERT/Wav2Vec2, which own their conv front
    end) or ``mel`` (Whisper, or no config)."""
    if model_cfg is not None and model_cfg.audio_encoder in ("hubert", "wav2vec2"):
        return "wave"
    return "mel"


def image_stats_for(model_cfg: ModelConfig | None) -> str:
    """The normalization statistics the configured video encoder expects."""
    encoder = model_cfg.video_encoder if model_cfg is not None else "clip"
    return {"resnet": "imagenet", "efficientnet": "inception",
            "avhubert": "avhubert"}.get(encoder, "clip")


def featurize(hb: HostBatch, device: str | torch.device = "cuda",
              compute_dtype: torch.dtype = torch.float32,
              model_cfg: ModelConfig | None = None,
              image_stats: str | None = None) -> Batch:
    """Host batch -> device Batch: the audio front end and frame
    normalization on the device. The audio front end is the one
    ``model_cfg.audio_encoder`` consumes (:func:`audio_frontend_for`): the
    padded f32 waveform and its lengths, or the log-mel. Frames are normalized with
    ``image_stats``, by default the statistics of
    ``model_cfg.video_encoder`` (CLIP's without a config)."""
    stats = image_stats or image_stats_for(model_cfg)
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    mel = mel_lens = vframes = wave = wave_lens = None
    if hb.audio is not None:
        audio = dev(hb.audio)
        if audio.dtype == torch.int16:      # compact_transfer PCM
            audio = _pcm16_to_f32(audio)
        audio_lens = dev(hb.audio_lens)
        if audio_frontend_for(model_cfg) == "wave":
            wave, wave_lens = audio, audio_lens
        else:
            mel = log_mel_spectrogram(audio, audio_lens)
            mel_lens = audio_lens // HOP_LENGTH
    if hb.frames is not None:
        vframes = normalize_frames(dev(hb.frames), dtype=compute_dtype, stats=stats)
    elif hb.frames_y is not None:           # compact_transfer YUV420
        vframes = normalize_yuv420_frames(dev(hb.frames_y), dev(hb.frames_uv),
                                          dtype=compute_dtype, stats=stats)
    return Batch(mel=mel, mel_lens=mel_lens, frames=vframes,
                 frame_lens=dev(hb.frame_lens) if hb.frame_lens is not None else None,
                 prompt_tokens=dev(hb.prompt), labels=dev(hb.labels),
                 label_lens=dev(hb.label_lens), wave=wave, wave_lens=wave_lens)


class DataLoader:
    """Bucketed, prefetching loader yielding (HostBatch, device Batch)."""

    def __init__(self, dataset, cfg: DataConfig, tokenizer, *,
                 model_cfg: ModelConfig, batch_size: int | None = None,
                 shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2, drop_last: bool = False,
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.float32,
                 data_shard: tuple[int, int] | None = None) -> None:
        """``prefetch``: the batches the worker thread prepares ahead of the
        consumer (the queue's depth; 0 leaves it unbounded, as the JAX
        loader's ``queue.Queue`` does). ``drop_last``: leave out an epoch's
        short last batch instead of wrapping it to the epoch's head (in
        ``__len__`` and in the walk). ``data_shard=(rank, world)``: a loader
        of one process of a multi-process run (see the module docstring),
        with the JAX package's checks."""
        self.ds = dataset
        self.cfg = cfg
        self.batch_size = batch_size or cfg.batch_size
        self.data_shard = data_shard
        if data_shard is not None:
            idx, count = data_shard
            if not 0 <= idx < count:
                raise ValueError(f"data_shard {data_shard}: index out of range")
            if self.batch_size % count != 0:
                raise ValueError(
                    f"global batch size {self.batch_size} must divide the "
                    f"{count} data-loading processes")
            if not hasattr(dataset, "length_hints"):
                raise ValueError(
                    f"{type(dataset).__name__} has no length_hints(); "
                    "multi-host bucket agreement needs per-sample length "
                    "metadata (manifest num_frames/num_samples columns)")
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.device = device
        self.compute_dtype = compute_dtype
        self.model_cfg = model_cfg
        self.pad_id = tokenizer.pad_id
        self.prompt_ids = tokenizer.encode(model_cfg.prompt, add_bos=True)
        self._epoch = 0
        self._pool: ThreadPoolExecutor | None = None
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
        full, short = divmod(len(self.ds), self.batch_size)
        return full + (short > 0 and not self.drop_last)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx

    def _metadata_buckets(self, chunk: np.ndarray) -> tuple[int | None, int | None]:
        """(audio, video) buckets of a global chunk from the dataset's
        ``length_hints`` alone: the same on every rank, since the chunk's
        indices and the metadata are shared."""
        hints = [self.ds.length_hints(int(i)) for i in chunk]
        ab = vb = None
        if any(h[0] > 0 for h in hints):
            mels = [min(h[0], self.cfg.max_audio_length) // HOP_LENGTH for h in hints]
            ab = pick_bucket(max(mels), self.cfg.audio_buckets)
        if any(h[1] > 0 for h in hints):
            ts = [min(h[1], self.cfg.max_video_length) for h in hints]
            vb = pick_bucket(max(ts), self.cfg.video_buckets)
        return ab, vb

    def _host_batches(self, skip: int = 0) -> Iterator[HostBatch]:
        order = self._order()
        bs = self.batch_size
        for start in range(skip * bs, len(order), bs):
            chunk = order[start:start + bs]
            n_real = len(chunk)
            if n_real < bs and self.drop_last:
                break
            if n_real < bs:
                # wrap to the epoch head for a static batch size; the
                # repeated rows get label length 0, so the loss weighs them
                # zero (decode skips their repeated utterance ids)
                chunk = np.concatenate([chunk, order[: bs - n_real]])
            buckets: dict[str, int | None] = {}
            lo = 0
            if self.data_shard is not None:
                # a split smaller than the batch wraps more than once, so
                # that every rank has its rows; the shapes from the whole
                # chunk's metadata, then this rank's rows
                chunk = np.resize(chunk, bs)
                ab, vb = self._metadata_buckets(chunk)
                buckets = {"audio_bucket": ab, "video_bucket": vb}
                lo, hi = local_rows(bs, self.data_shard)
                chunk = chunk[lo:hi]
            samples = self._resolve_audio(self._fetch(chunk), chunk)
            hb = collate(samples, self.cfg, self.prompt_ids, self.pad_id, **buckets)
            # the wrap boundary is a global row: zero this rank's rows past it
            hb.label_lens[max(n_real - lo, 0):] = 0
            yield hb

    def _fetch(self, chunk: np.ndarray) -> list[Sample]:
        """The chunk's samples, loaded over ``data.num_workers`` threads
        when it is above 1 (media decode and resize release the GIL)."""
        if self.cfg.num_workers <= 1 or len(chunk) <= 1:
            return [self.ds[int(i)] for i in chunk]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.cfg.num_workers)
        return list(self._pool.map(lambda i: self.ds[int(i)], chunk))

    def close(self) -> None:
        """Stop the fetch threads (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):   # a backstop for loaders never closed
        try:
            self.close()
        except Exception:   # noqa: BLE001 — interpreter shutdown
            pass

    def _resolve_audio(self, samples: list[Sample], idxs: np.ndarray) -> list[Sample]:
        """Decode the WAVs the dataset deferred: the whole group in one
        native threaded call, then a per-file Python decode of a row the
        native decoder failed, then the dataset's retry walk forward from a
        row that stays corrupt."""
        pend = [i for i, s in enumerate(samples) if s.audio is None and s.audio_path]
        if not pend:
            return samples
        cap = self.cfg.max_audio_length
        res = native.decode_wav_batch([samples[i].audio_path for i in pend],
                                      max_samples=cap)
        out, lens = res if res is not None else (None, None)
        for j, i in enumerate(pend):
            if out is not None and lens[j] > 0:
                samples[i] = replace(samples[i], audio=out[j, :lens[j]].copy())
                continue
            try:
                samples[i] = replace(samples[i], audio=load_audio(
                    samples[i].audio_path, max_samples=cap))
                continue
            except Exception:  # noqa: BLE001 — any decode fault walks forward
                pass
            last_err: Exception | None = None
            for probe in range(1, MAX_RETRY_WALK + 1):
                try:
                    rep = self.ds[(int(idxs[i]) + probe) % len(self.ds)]
                    if rep.audio is None and rep.audio_path:
                        rep = replace(rep, audio=load_audio(rep.audio_path,
                                                            max_samples=cap))
                    samples[i] = rep
                    break
                except Exception as e:  # noqa: BLE001 — the retry walk
                    last_err = e
            else:
                raise IOError(f"failed to decode {samples[i].audio_path} and "
                              f"{MAX_RETRY_WALK} subsequent samples") from last_err
        return samples

    def __iter__(self) -> Iterator[tuple[HostBatch, Batch]]:
        """One worker thread collates and featurizes (host -> device copy
        and the on-device log-mel) up to ``prefetch`` batches ahead."""
        self._epoch += 1
        skip, self._skip = self._skip, 0
        self._yielded = skip
        q: queue.Queue[Any] = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker() -> None:
            try:
                for hb in self._host_batches(skip):
                    if stop.is_set():
                        return
                    q.put((hb, featurize(hb, self.device, self.compute_dtype,
                                         self.model_cfg)))
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
