"""Whisper log-mel spectrogram on the device, the port of ``avsr_tpu/ops/logmel.py``.

The DFT is a matmul against a Hann-windowed cos/sin basis (n_fft=400, so a
dense DFT costs ~0.5 GFLOP per 30 s utterance), followed by the mel
projection and Whisper's log compression (log10, clamp to the
per-utterance max - 8, then (x + 4) / 4). All of it in float32, as the JAX
package runs it at HIGHEST precision; a caller on the card keeps TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).

The JAX package leaves this to XLA (no Pallas kernel), so the port runs it
as plain PyTorch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80


def hz_to_mel(hz: np.ndarray | float) -> np.ndarray:
    """Slaney-scale mel (librosa default): linear below 1 kHz, log above."""
    hz = np.asarray(hz, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (hz - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(hz >= min_log_hz,
                    min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep,
                    mel)


def mel_to_hz(mel: np.ndarray) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    hz = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)),
                    hz)


@functools.lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                   sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_mels, n_fft//2+1]."""
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2, n_freq)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def dft_basis(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Hann-windowed real-DFT basis matrices [n_fft, n_fft//2+1]."""
    n_freq = n_fft // 2 + 1
    window = np.hanning(n_fft + 1)[:-1]  # periodic hann
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    wc = (window[:, None] * np.cos(ang)).astype(np.float32)
    ws = (window[:, None] * np.sin(ang)).astype(np.float32)
    return wc, ws


def frame_signal(audio: torch.Tensor, n_fft: int = N_FFT,
                 hop: int = HOP_LENGTH) -> torch.Tensor:
    """[B, n_samples] -> centered overlapping frames [B, T, n_fft].

    Reflect-pads n_fft//2 on both sides and drops the final frame like
    Whisper, so n_samples=480000 -> T=3000."""
    pad = n_fft // 2
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = audio.shape[-1] // hop
    return x.unfold(-1, n_fft, hop)[:, :n_frames]


def log_mel_spectrogram(audio: torch.Tensor,
                        audio_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Batched Whisper log-mel: [B, n_samples] f32 -> [B, n_mels, T] f32.

    ``audio_lengths`` (in samples) restricts the per-utterance max used in
    the dynamic-range clamp to valid frames."""
    if audio.ndim == 1:
        audio = audio[None]
    audio = audio.float()
    dev = audio.device
    frames = frame_signal(audio)                           # [B, T, n_fft]
    wc, ws = (torch.from_numpy(m).to(dev) for m in dft_basis())
    fb = torch.from_numpy(mel_filterbank()).to(dev)
    re = torch.matmul(frames, wc)
    im = torch.matmul(frames, ws)
    power = re * re + im * im                              # [B, T, n_freq]
    mel = torch.matmul(power, fb.T)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    if audio_lengths is not None:
        valid = (torch.arange(frames.shape[1], device=dev)[None, :]
                 < (audio_lengths.to(dev)[:, None] // HOP_LENGTH))
        masked = torch.where(valid[..., None], log_spec, float("-inf"))
        peak = masked.amax(dim=(1, 2), keepdim=True)
    else:
        peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(1, 2)                        # [B, n_mels, T]

