"""Host-side audio I/O, a copy of ``avsr_tpu/data/audio_io.py``:
dependency-free WAV reading + resampling.

WAV parsing is implemented directly (RIFF PCM 8/16/24/32 + IEEE float, the
extensible format tag, mono-ized by averaging); resampling to 16 kHz uses
scipy's polyphase resampler. The JAX package's C++ batch decoder is
ported as ``native/__init__.py::decode_wav_batch``; this module is its
numerics reference and the fallback without the native library.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np

TARGET_SR = 16_000


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a RIFF WAV file -> (float32 mono samples in [-1, 1], sample_rate)."""
    path = str(path)
    with open(path, "rb") as fh:
        header = fh.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk = fh.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            if cid == b"fmt ":
                fmt = fh.read(size)
            elif cid == b"data":
                data = fh.read(size)
            else:
                fh.seek(size + (size & 1), 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, n_ch, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_fmt == 0xFFFE and len(fmt) >= 40:   # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = struct.unpack("<H", fmt[24:26])[0]

    if audio_fmt == 1:       # PCM int
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, "u1").reshape(-1, 3)
            as32 = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            as32 = np.where(as32 & 0x800000, as32 - (1 << 24), as32)
            x = as32.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_fmt == 3:     # IEEE float
        x = np.frombuffer(data, "<f4").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {audio_fmt}")

    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x), sr


def resample(x: np.ndarray, sr: int, target_sr: int = TARGET_SR) -> np.ndarray:
    if sr == target_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(x, target_sr // g, sr // g).astype(np.float32)


def load_audio(path: str | Path, target_sr: int = TARGET_SR,
               max_samples: int | None = None) -> np.ndarray:
    """Load + mono-ize + resample; truncate to ``max_samples`` (ref caps
    audio at 30 s — simple_dataset.py:31)."""
    x, sr = read_wav(path)
    x = resample(x, sr, target_sr)
    if max_samples is not None and x.shape[0] > max_samples:
        x = x[:max_samples]
    return x


def wav_num_samples(path: str | Path) -> int:
    """Sample count at the file's native rate, from the RIFF header only
    (no audio data is read) — used for manifest num_samples columns."""
    with open(path, "rb") as fh:
        if fh.read(12)[:4] != b"RIFF":
            raise ValueError(f"{path}: not RIFF")
        n_ch = bits = 0
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = fh.read(size)
                _, n_ch, _, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
            elif cid == b"data":
                if not n_ch:
                    raise ValueError(f"{path}: data before fmt")
                return size // (n_ch * max(bits // 8, 1))
            else:
                fh.seek(size + (size & 1), 1)
    raise ValueError(f"{path}: no data chunk")


def write_wav(path: str | Path, x: np.ndarray, sr: int = TARGET_SR) -> None:
    """PCM16 writer (test fixtures + ref save_audio equivalent media.py:155)."""
    x16 = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x16.tobytes())
