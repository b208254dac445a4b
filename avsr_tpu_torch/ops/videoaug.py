"""Video augmentation, time-consistent per utterance, the port of
``avsr_tpu/ops/videoaug.py``.

Split into a draw and an apply. :func:`draw_video_augment` draws, per
utterance and shared by all its frames, from an explicit
``torch.Generator`` on the batch's device: a horizontal flip with p = 0.5,
an integer shift (dy, dx) ~ U[-max_shift, max_shift] (zero-filled borders:
a random crop of a frame padded by ``max_shift``), a contrast factor
U[1 - contrast, 1 + contrast] and a brightness offset U[-brightness,
brightness]; :func:`apply_video_augment` is deterministic given them.
Contrast and brightness act on the normalized pixel scale the featurize
path produces, so one implementation serves every encoder's input
convention. Padding frames (t >= frame_lens) come back bit-identical. The
port does not reproduce JAX's random stream, only these semantics, so
tests hand the apply the draws that JAX makes from its key.

Applied on the training path only (``train/step.py`` gates it on the
dropout seed), never at eval or inference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class VideoDraws(NamedTuple):
    flip: torch.Tensor | None         # [B] bool
    shift: torch.Tensor | None        # [B, 2] int64, (dy, dx)
    contrast: torch.Tensor | None     # [B] in the frames' dtype
    brightness: torch.Tensor | None   # [B] in the frames' dtype
    max_shift: int = 0


def draw_video_augment(frames: torch.Tensor, gen: torch.Generator, *,
                       max_shift: int = 8, flip: bool = True,
                       brightness: float = 0.1, contrast: float = 0.1,
                       rows: tuple[int, int] | None = None) -> VideoDraws:
    """The transforms of one batch of frames [B, T, C, H, W], drawn in the
    order flip, shift, contrast, brightness. ``rows=(start, total)``: the
    batch is rows start on of a batch of ``total``, whose draws are made
    and sliced (a rank of a multi-process run)."""
    B, dev, dt = frames.shape[0], frames.device, frames.dtype
    lo, total = rows or (0, B)

    def rand(*shape: int) -> torch.Tensor:
        return torch.rand((total, *shape), generator=gen, device=dev)[lo:lo + B]

    def uniform(a: float, b: float) -> torch.Tensor:
        return (a + (b - a) * rand()).to(dt)

    do_flip = (rand() < 0.5) if flip else None
    m = int(max_shift)
    shift = (torch.randint(-m, m + 1, (total, 2), generator=gen, device=dev)[lo:lo + B]
             if m > 0 else None)
    c = uniform(1.0 - contrast, 1.0 + contrast) if contrast > 0 else None
    b = uniform(-brightness, brightness) if brightness > 0 else None
    return VideoDraws(do_flip, shift, c, b, m)


def apply_video_augment(frames: torch.Tensor, frame_lens: torch.Tensor | None,
                        draws: VideoDraws) -> torch.Tensor:
    """frames [B, T, C, H, W] -> the same shape and dtype, flipped, shifted,
    then scaled by the contrast and offset by the brightness; frames at or
    past ``frame_lens`` untouched."""
    B, T, C, H, W = frames.shape
    out = frames
    if draws.flip is not None:
        out = torch.where(draws.flip[:, None, None, None, None], out.flip(-1), out)
    if draws.shift is not None:
        m = draws.max_shift
        padded = F.pad(out, (m, m, m, m))                      # [B,T,C,H+2m,W+2m]
        dev = frames.device
        rows = (m + draws.shift[:, 0])[:, None] + torch.arange(H, device=dev)
        cols = (m + draws.shift[:, 1])[:, None] + torch.arange(W, device=dev)
        out = padded.gather(3, rows[:, None, None, :, None].expand(B, T, C, H, W + 2 * m))
        out = out.gather(4, cols[:, None, None, None, :].expand(B, T, C, H, W))
    if draws.contrast is not None:
        out = out * draws.contrast[:, None, None, None, None]
    if draws.brightness is not None:
        out = out + draws.brightness[:, None, None, None, None]
    if frame_lens is not None:
        valid = (torch.arange(T, device=frames.device)[None, :]
                 < frame_lens.to(frames.device)[:, None])        # [B, T]
        out = torch.where(valid[:, :, None, None, None], out, frames)
    return out.to(frames.dtype)


def video_augment(frames: torch.Tensor, frame_lens: torch.Tensor | None,
                  gen: torch.Generator, **kw) -> torch.Tensor:
    """:func:`apply_video_augment` of :func:`draw_video_augment` (``kw``:
    its knobs, and ``rows``)."""
    return apply_video_augment(frames, frame_lens, draw_video_augment(frames, gen, **kw))
