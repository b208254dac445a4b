"""SpecAugment: time and frequency masking of log-mel features, the port of
``avsr_tpu/ops/specaugment.py``.

Split into a draw and an apply. :func:`draw_specaugment` draws each
utterance's spans (``time_masks`` spans of up to ``time_width`` frames
inside its valid frames) and bands (``freq_masks`` bands of up to
``freq_width`` mel bins) from an explicit ``torch.Generator`` on the
batch's device, with the JAX package's distributions; :func:`apply_specaugment`
is deterministic given them: masked cells take the utterance's mean over
its valid frames, and padding frames (>= mel_lens) come back bit-identical.
The port does not reproduce JAX's random stream, only these semantics, so
tests hand the apply the draws that JAX makes from its key.

Applied on the training path only (``train/step.py`` gates it on the
dropout seed), never at eval or inference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Spans(NamedTuple):
    """Per utterance, ``n`` spans [start, start + width) of one axis."""

    start: torch.Tensor     # [B, n] int64
    width: torch.Tensor     # [B, n] int64


class SpecDraws(NamedTuple):
    time: Spans | None      # over frames
    freq: Spans | None      # over mel bins


def draw_spans(gen: torch.Generator, n: int, max_width: int,
               limits: torch.Tensor, rows: tuple[int, int] | None = None) -> Spans:
    """``n`` spans per row, each of width U[0, max_width] (cut to the row's
    limit) and inside [0, limits_b): the start is floor(u * (limit - w + 1))
    for u ~ U[0, 1), as the JAX ``_mask_any`` draws it. ``rows=(start,
    total)``: the batch is rows start on of a batch of ``total``, whose
    draws are made and sliced (a rank of a multi-process run)."""
    B = limits.shape[0]
    dev = limits.device
    lo, total = rows or (0, B)
    w = torch.randint(0, max_width + 1, (total, n), generator=gen, device=dev)[lo:lo + B]
    w = torch.minimum(w, limits[:, None].long())
    u = torch.rand((total, n), generator=gen, device=dev)[lo:lo + B]
    start = torch.floor(u * (limits[:, None] - w + 1).float()).long()
    return Spans(start, w)


def span_mask(spans: Spans, size: int) -> torch.Tensor:
    """[B, size] bool: the union of each row's spans."""
    pos = torch.arange(size, device=spans.start.device)[None, None, :]
    hit = (pos >= spans.start[..., None]) & (pos < (spans.start + spans.width)[..., None])
    return hit.any(dim=1)


def _lengths(mel: torch.Tensor, mel_lens: torch.Tensor | None) -> torch.Tensor:
    B, _, T = mel.shape
    if mel_lens is None:
        return torch.full((B,), T, dtype=torch.int64, device=mel.device)
    return mel_lens.to(device=mel.device, dtype=torch.int64)


def draw_specaugment(mel: torch.Tensor, mel_lens: torch.Tensor | None,
                     gen: torch.Generator, *, time_masks: int = 2,
                     time_width: int = 50, freq_masks: int = 2,
                     freq_width: int = 12,
                     rows: tuple[int, int] | None = None) -> SpecDraws:
    """The spans and bands of one batch (time first, then frequency);
    ``rows`` as in :func:`draw_spans`."""
    B, F, _ = mel.shape
    lens = _lengths(mel, mel_lens)
    tspans = (draw_spans(gen, time_masks, time_width, lens, rows)
              if time_masks > 0 and time_width > 0 else None)
    fspans = (draw_spans(gen, freq_masks, freq_width,
                         torch.full((B,), F, dtype=torch.int64, device=mel.device), rows)
              if freq_masks > 0 and freq_width > 0 else None)
    return SpecDraws(tspans, fspans)


def apply_specaugment(mel: torch.Tensor, mel_lens: torch.Tensor | None,
                      draws: SpecDraws) -> torch.Tensor:
    """mel [B, F, T] with the drawn spans and bands replaced by each
    utterance's mean over its valid frames; padding frames untouched."""
    B, F, T = mel.shape
    lens = _lengths(mel, mel_lens)
    valid_t = torch.arange(T, device=mel.device)[None, :] < lens[:, None]   # [B, T]
    denom = lens.clamp(min=1).to(mel.dtype) * F
    mean = ((mel * valid_t[:, None, :]).sum(dim=(1, 2)) / denom)[:, None, None]
    tmask = (span_mask(draws.time, T) if draws.time is not None
             else torch.zeros((B, T), dtype=torch.bool, device=mel.device))
    fmask = (span_mask(draws.freq, F) if draws.freq is not None
             else torch.zeros((B, F), dtype=torch.bool, device=mel.device))
    hit = (tmask[:, None, :] | fmask[:, :, None]) & valid_t[:, None, :]
    return torch.where(hit, mean.to(mel.dtype), mel)


def specaugment(mel: torch.Tensor, mel_lens: torch.Tensor | None,
                gen: torch.Generator, **kw) -> torch.Tensor:
    """:func:`apply_specaugment` of :func:`draw_specaugment` (``kw``: its
    mask counts and widths, and ``rows``)."""
    return apply_specaugment(mel, mel_lens, draw_specaugment(mel, mel_lens, gen, **kw))
