"""Streaming AVSR transcription: chunked feeds, LocalAgreement commits, the
port of ``avsr_tpu/infer/streaming.py``.

  * keep an audio (and optional video-frame) buffer; on every chunk,
    re-encode the buffered media and greedy-decode a full hypothesis;
  * COMMIT only the longest common prefix of the last ``agree_n``
    hypotheses; committed tokens are monotonic — once emitted they are
    never retracted;
  * when the buffer would outgrow the decode window (the largest
    audio/video length bucket), the current window's full hypothesis is
    committed and the buffer resets — long streams become a sequence of
    window segments;
  * ``finalize()`` decodes the complete buffer once more and APPENDS its
    suffix past the committed prefix. When the running hypotheses were
    prefix-stable the result equals the offline transcript; when not, the
    already-emitted prefix wins — monotonicity is the contract.

Deltas are emitted as decoded token suffixes; ``committed_text`` (a decode
of all committed tokens) stays the authoritative transcript.

Blockwise mode (``decode.stream_block_s > 0``, any modality): completed
fixed-size media blocks are encoded once and their connector features
frozen into a persistent LLM KV cache (``infer/generate.py::
prefill_extend``); each chunk then pays one block encode at most, a
chunked prefill of [un-frozen tail | the last 64 committed tokens]
(``generate_continue``), and an EOS-bounded decode of the new suffix — a
flat per-chunk cost across the window. A block spans ``stream_block_s``
seconds of EVERY active modality (audio at 16 kHz, video at
``decode.stream_video_fps``), and freezes only once BOTH streams have
covered its span (the slower-arriving modality gates it). Blocks are
encoded (and fused) independently, so encoder context does not span block
boundaries; the exact mode (``stream_block_s=0``) keeps finalize ==
offline decode.

``generate_continue`` writes the persistent cache in place past the frozen
frontier (the tail and its decode); those columns are masked for every
later chunk and rewritten by the next freeze, so the frozen history is
what the JAX package's functional cache holds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from avsr_tpu_torch.core.config import AVSRConfig
from avsr_tpu_torch.data.dataset import Sample
from avsr_tpu_torch.data.loader import collate, featurize
from avsr_tpu_torch.infer.generate import generate_continue, generate_tokens, prefill_extend
from avsr_tpu_torch.models import llama as L
from avsr_tpu_torch.models.avsr import Batch, encode
from avsr_tpu_torch.ops.logmel import HOP_LENGTH


def _common_prefix(a: list[int], b: list[int]) -> list[int]:
    out = []
    for x, y in zip(a, b):
        if x != y:
            break
        out.append(x)
    return out


@dataclass
class StreamingTranscriber:
    """Incremental transcription over a growing media buffer.

    ``feed`` returns the text committed by that chunk (possibly empty);
    ``finalize`` flushes the remainder. ``committed_tokens`` /
    ``committed_text`` are monotonic: once committed, never retracted.
    Runs on the device of ``params``.
    """

    params: object
    cfg: AVSRConfig
    tok: object
    agree_n: int = 2
    _audio: np.ndarray | None = None
    _frames: np.ndarray | None = None
    _hyps: list[list[int]] = field(default_factory=list)
    _committed: list[int] = field(default_factory=list)
    _segment_tokens: list[int] = field(default_factory=list)
    # blockwise mode: persistent LLM KV cache over [prompt][frozen feature
    # blocks]
    _cache: L.KVCache | None = None
    _base_len: int = 0             # frozen tokens in the cache
    _frozen_samples: int = 0       # audio samples already frozen as blocks
    _frozen_frames: int = 0        # video frames already frozen as blocks

    def feed(self, audio: np.ndarray | None = None,
             frames: np.ndarray | None = None) -> str:
        """Append a chunk (audio float32 [n] @16 kHz and/or frames uint8
        [T, S, S, 3]) and return newly committed text.

        A chunk larger than the decode window is split into window-sized
        pieces fed in sequence (same time fraction across modalities), so
        no media is ever silently dropped."""
        audio = None if audio is None else np.asarray(audio, np.float32)
        frames = None if frames is None else np.asarray(frames, np.uint8)
        n = 1
        if audio is not None:
            n = max(n, -(-audio.shape[0] // self._audio_window))
        if frames is not None:
            n = max(n, -(-frames.shape[0] // self._video_window))
        if n == 1:
            return self._feed_one(audio, frames)
        emitted = ""
        for i in range(n):
            a = (audio[audio.shape[0] * i // n: audio.shape[0] * (i + 1) // n]
                 if audio is not None else None)
            f = (frames[frames.shape[0] * i // n: frames.shape[0] * (i + 1) // n]
                 if frames is not None else None)
            emitted += self._feed_one(a, f)
        return emitted

    def _feed_one(self, audio: np.ndarray | None, frames: np.ndarray | None) -> str:
        emitted = self._maybe_rollover(audio, frames)
        self._buffer(audio, frames)
        if not self._have_media():
            # modality=both with only one stream arrived so far
            return emitted
        hyp = self._hypothesis()
        self._hyps.append(hyp)
        self._hyps = self._hyps[-self.agree_n:]
        if len(self._hyps) == self.agree_n:
            agreed = self._hyps[0]
            for h in self._hyps[1:]:
                agreed = _common_prefix(agreed, h)
            # monotonic: only extend past what is already committed
            if (len(agreed) > len(self._segment_tokens)
                    and agreed[: len(self._segment_tokens)] == self._segment_tokens):
                emitted += self._commit(agreed[len(self._segment_tokens):])
        return emitted

    def finalize(self) -> str:
        """Decode the full buffer once more and append its suffix past the
        committed prefix."""
        if self._audio is None and self._frames is None:
            return ""
        if not self._have_media():
            return ""
        full = self._hypothesis()
        return self._commit(full[len(self._segment_tokens):])

    @property
    def committed_tokens(self) -> list[int]:
        return list(self._committed)

    @property
    def committed_text(self) -> str:
        return self.tok.decode(self._committed)

    # -- internals --------------------------------------------------------

    @property
    def _device(self) -> torch.device:
        return self.params["llm"]["embed"].device

    @property
    def _dt(self) -> torch.dtype:
        return getattr(torch, self.cfg.runtime.compute_dtype)

    @property
    def _audio_window(self) -> int:
        return self.cfg.data.audio_buckets[-1] * HOP_LENGTH

    @property
    def _video_window(self) -> int:
        return self.cfg.data.video_buckets[-1]

    def _commit(self, new_tokens: list[int]) -> str:
        if not new_tokens:
            return ""
        self._segment_tokens.extend(new_tokens)
        self._committed.extend(new_tokens)
        return self.tok.decode(new_tokens)

    def _maybe_rollover(self, audio, frames) -> str:
        """Segment boundary: if this chunk would push the buffer past the
        decode window, commit the current window's full transcript and
        start a fresh segment."""
        over_a = (audio is not None and self._audio is not None
                  and self._audio.shape[0] + audio.shape[0] > self._audio_window)
        over_v = (frames is not None and self._frames is not None
                  and self._frames.shape[0] + frames.shape[0] > self._video_window)
        if not (over_a or over_v):
            return ""
        full = self._hypothesis()
        out = self._commit(full[len(self._segment_tokens):])
        self._audio = None
        self._frames = None
        self._hyps = []
        self._segment_tokens = []
        self._cache = None
        self._base_len = 0
        self._frozen_samples = 0
        self._frozen_frames = 0
        return out

    def _buffer(self, audio, frames) -> None:
        if audio is not None:
            self._audio = audio if self._audio is None else np.concatenate([self._audio, audio])
            self._audio = self._audio[: self._audio_window]
        if frames is not None:
            self._frames = (frames if self._frames is None
                            else np.concatenate([self._frames, frames]))
            self._frames = self._frames[: self._video_window]

    def _featurize_media(self, audio: np.ndarray | None, frames: np.ndarray | None) -> Batch:
        """collate + featurize one sample (bucketed shapes)."""
        sample = Sample("stream", audio, frames, "", [self.tok.eos_id])
        prompt_ids = self.tok.encode(self.cfg.model.prompt, add_bos=True)
        hb = collate([sample], self.cfg.data, prompt_ids, self.tok.pad_id)
        return featurize(hb, self._device, self._dt, self.cfg.model)

    @staticmethod
    def _ids(out) -> list[int]:
        """A one-row GenOut's tokens, without the trailing EOS."""
        n = int(out.lengths[0])
        return [int(t) for t in out.tokens[0, :n].tolist()]

    def _decode_buffer(self) -> list[int]:
        out = generate_tokens(
            self.params, self.cfg.model, self._featurize_media(self._audio, self._frames),
            max_new_tokens=self.cfg.decode.max_new_tokens, eos_id=self.tok.eos_id,
            compute_dtype=self._dt, use_kernel=self.cfg.runtime.use_pallas,
            kv_cache_dtype=self.cfg.decode.kv_cache_dtype)
        toks = self._ids(out)
        # drop the trailing EOS from the hypothesis stream
        if toks and toks[-1] == self.tok.eos_id:
            toks = toks[:-1]
        return toks

    # -- blockwise mode (decode.stream_block_s > 0) -----------------------

    @property
    def _blockwise(self) -> bool:
        return self.cfg.decode.stream_block_s > 0

    def _hypothesis(self) -> list[int]:
        return self._decode_incremental() if self._blockwise else self._decode_buffer()

    @property
    def _block_samples(self) -> int:
        return int(round(self.cfg.decode.stream_block_s * 16000))

    @property
    def _block_frames(self) -> int:
        return max(int(round(self.cfg.decode.stream_block_s
                             * self.cfg.decode.stream_video_fps)), 1)

    @property
    def _needs(self) -> tuple[bool, bool]:
        m = self.cfg.model.modality
        return m in ("audio", "both"), m in ("video", "both")

    def _have_media(self) -> bool:
        """Every stream the modality needs has arrived at least once."""
        need_a, need_v = self._needs
        if need_a and self._audio is None:
            return False
        if need_v and self._frames is None:
            return False
        return True

    def _encode_features(self, batch: Batch) -> tuple[torch.Tensor, int]:
        """Connector features [1, Tf, d] of one media block and their
        valid length."""
        enc = encode(self.params, self.cfg.model, batch, compute_dtype=self._dt,
                     use_kernel=self.cfg.runtime.use_pallas, moe_rowwise=True)
        return enc.features.to(self._dt), int(enc.lengths[0])

    def _ensure_cache(self) -> None:
        """First decode of a segment: allocate the persistent KV cache and
        freeze the prompt as its first block. Capacity covers the prompt, a
        full window of features at mel-frame granularity (>= 2x the actual
        count; the slack absorbs per-block bucket padding and the committed
        tokens re-fed as tail), and the decode budget."""
        if self._cache is not None:
            return
        need_a, need_v = self._needs
        prompt_ids = self.tok.encode(self.cfg.model.prompt, add_bos=True)
        cap = (len(prompt_ids)
               + (self.cfg.data.audio_buckets[-1] if need_a else 0)
               + (self.cfg.data.video_buckets[-1] if need_v else 0)
               + 2 * self.cfg.decode.max_new_tokens + 128)
        M = -(-cap // 128) * 128
        dev = self._device
        cache = L.init_cache(self.cfg.model.llm, 1, M, self._dt, dev)
        emb = L.embed_tokens(self.params["llm"],
                             torch.tensor([prompt_ids], device=dev), self._dt)
        self._cache = prefill_extend(
            self.params, self.cfg.model, cache, torch.zeros((1,), dtype=torch.int64, device=dev),
            emb, torch.tensor([len(prompt_ids)], device=dev), compute_dtype=self._dt,
            use_kernel=self.cfg.runtime.use_pallas)
        self._base_len = len(prompt_ids)

    def _block_ready(self) -> bool:
        """A block freezes only once EVERY active modality has covered its
        span past the frozen frontier, with a non-empty tail left behind
        (the decoder always conditions on some un-frozen media)."""
        need_a, need_v = self._needs
        ok = True
        if need_a:
            ok &= (self._audio is not None
                   and self._audio.shape[0] - self._frozen_samples > self._block_samples)
        if need_v:
            ok &= (self._frames is not None
                   and self._frames.shape[0] - self._frozen_frames > self._block_frames)
        return ok

    def _freeze_block(self) -> None:
        """Encode one completed block (every active modality's slice of the
        same span, fused block-locally for modality 'both') and extend the
        persistent cache."""
        need_a, need_v = self._needs
        a = f = None
        if need_a:
            a = self._audio[self._frozen_samples: self._frozen_samples + self._block_samples]
            self._frozen_samples += self._block_samples
        if need_v:
            f = self._frames[self._frozen_frames: self._frozen_frames + self._block_frames]
            self._frozen_frames += self._block_frames
        feat, n = self._encode_features(self._featurize_media(a, f))
        M = self._cache.k.shape[3]
        if self._base_len + feat.shape[1] > M:
            raise RuntimeError(
                f"blockwise stream cache overflow (frozen {self._base_len} "
                f"+ block {feat.shape[1]} > capacity {M}); raise "
                "decode.stream_block_s or shrink data.audio_buckets")
        dev = self._device
        self._cache = prefill_extend(
            self.params, self.cfg.model, self._cache,
            torch.tensor([self._base_len], device=dev), feat, torch.tensor([n], device=dev),
            compute_dtype=self._dt, use_kernel=self.cfg.runtime.use_pallas)
        self._base_len += n

    def _decode_incremental(self) -> list[int]:
        """Blockwise hypothesis: committed segment tokens (teacher-forced)
        + a fresh continuation decoded over [frozen blocks | tail]: one
        block encode at most, a chunked prefill of [tail features | the
        last 64 committed tokens] and a decode that exits at EOS."""
        if self._audio is None and self._frames is None:
            return list(self._segment_tokens)
        self._ensure_cache()
        while self._block_ready():
            self._freeze_block()
        need_a, need_v = self._needs
        tail_a = self._audio[self._frozen_samples:] if need_a else None
        tail_f = self._frames[self._frozen_frames:] if need_v else None
        feat, n = self._encode_features(self._featurize_media(tail_a, tail_f))
        parts = [feat[0, :n]]
        seg = list(self._segment_tokens)
        # only the last 64 committed tokens as text context: the model
        # conditions on ALL the audio through the frozen cache
        ctx = seg[-64:]
        dev = self._device
        if ctx:
            parts.append(L.embed_tokens(self.params["llm"], torch.tensor(ctx, device=dev),
                                        self._dt))
        tail = torch.cat(parts, dim=0)[None]
        T = tail.shape[1]
        M = self._cache.k.shape[3]
        max_new = self.cfg.decode.max_new_tokens
        if T > M - self._base_len - max_new:
            raise RuntimeError(
                f"blockwise stream cache overflow (frozen {self._base_len} "
                f"+ tail {T} + decode budget {max_new} > capacity {M}); raise "
                "decode.stream_block_s or shrink data.audio_buckets")
        out, _ = generate_continue(
            self.params, self.cfg.model, self._cache, torch.tensor([self._base_len], device=dev),
            tail, torch.tensor([T], device=dev), max_new_tokens=max_new,
            eos_id=self.tok.eos_id, compute_dtype=self._dt,
            use_kernel=self.cfg.runtime.use_pallas)
        toks = self._ids(out)
        if toks and toks[-1] == self.tok.eos_id:
            toks = toks[:-1]
        return seg + toks
