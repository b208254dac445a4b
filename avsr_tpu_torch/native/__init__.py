"""ctypes loader for the native C++ data helpers (``avsr_native.cpp``), the
port of ``avsr_tpu/native/__init__.py``.

The library is built at first use with ``g++ -O3`` (no ``-march=native``)
into ``avsr_tpu_torch/build/libavsr_native-<hash>.so``, the hash covering
the source and the flags, so an edited source is rebuilt and a stale
library never loads. This is host code, not a device kernel: every entry
point returns None when the library is unavailable (no ``g++``, or
``AVSR_NO_NATIVE`` set), and the callers then take their Python fallback
(``data/audio_io.py``, ``ops/image.py::rgb_to_yuv420_np``), as the JAX
package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("avsr_tpu_torch.native")

SRC = Path(__file__).resolve().parent / "avsr_native.cpp"
BUILD_DIR = SRC.parent.parent / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
ABI_VERSION = 3

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libavsr_native-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        log.warning("native build failed (%s); using the Python fallback", e)
        return False
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return True


def load() -> ctypes.CDLL | None:
    """The native library (built on first use), or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("AVSR_NO_NATIVE"):
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("native load failed: %s", e)
            return None
        lib.avsr_decode_wav_batch.restype = ctypes.c_int
        lib.avsr_decode_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.avsr_resize_crop_frames.restype = None
        lib.avsr_resize_crop_frames.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int]
        lib.avsr_rgb_to_yuv420.restype = None
        lib.avsr_rgb_to_yuv420.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int]
        lib.avsr_native_abi_version.restype = ctypes.c_int
        lib.avsr_native_abi_version.argtypes = []
        if lib.avsr_native_abi_version() != ABI_VERSION:
            log.warning("native ABI mismatch; using the Python fallback")
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_wav_batch(paths: list[str | Path], target_sr: int = 16_000,
                     max_samples: int = 480_000, num_threads: int = 0,
                     out: np.ndarray | None = None,
                     ) -> tuple[np.ndarray, np.ndarray] | None:
    """Native multithreaded batch decode -> ([B, max_samples] f32, lens).

    ``out`` may be a preallocated C-contiguous [B, max_samples] f32 buffer.
    Failed rows come back zero-length (the caller applies the retry walk);
    returns None only when the library itself is unavailable."""
    lib = load()
    if lib is None:
        return None
    B = len(paths)
    if out is None:
        out = np.zeros((B, max_samples), np.float32)
    if (out.shape != (B, max_samples) or out.dtype != np.float32
            or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous f32 [{B}, {max_samples}], "
                         f"got {out.dtype} {out.shape}")
    lens = np.zeros(B, np.int32)
    c_paths = (ctypes.c_char_p * B)(*[str(p).encode() for p in paths])
    lib.avsr_decode_wav_batch(c_paths, B, target_sr, _ptr(out, ctypes.c_float),
                              max_samples, _ptr(lens, ctypes.c_int32), num_threads)
    return out, lens


def resize_crop_frames(frames: np.ndarray, size: int,
                       num_threads: int = 0) -> np.ndarray | None:
    """Native shortest-side bilinear resize + centre crop, threaded over
    frames: u8 [T, H, W, 3] -> u8 [T, size, size, 3]."""
    lib = load()
    if lib is None:
        return None
    T, H, W, C = frames.shape
    if C != 3 or frames.dtype != np.uint8:
        raise ValueError(f"expected u8 [T, H, W, 3], got {frames.dtype} {frames.shape}")
    if H == size and W == size:
        return frames
    frames = np.ascontiguousarray(frames)
    out = np.empty((T, size, size, 3), np.uint8)
    lib.avsr_resize_crop_frames(_ptr(frames, ctypes.c_uint8), T, H, W,
                                _ptr(out, ctypes.c_uint8), size, num_threads)
    return out


def rgb_to_yuv420(frames: np.ndarray,
                  num_threads: int = 0) -> tuple[np.ndarray, np.ndarray] | None:
    """Native planar YUV420 packing of the compact link format:
    u8 [..., S, S, 3] RGB -> (Y u8 [..., S, S], UV u8 [..., S/2, S/2, 2]),
    1.5 bytes a pixel instead of 3. Leading dims flatten into the threaded
    frame loop; ``ops/image.py::rgb_to_yuv420_np`` is the fallback."""
    lib = load()
    if lib is None:
        return None
    *lead, S, S2, C = frames.shape
    if C != 3 or S != S2 or S % 2 or frames.dtype != np.uint8:
        raise ValueError(f"expected u8 [..., S, S, 3] with even S, got "
                         f"{frames.dtype} {frames.shape}")
    T = int(np.prod(lead)) if lead else 1
    frames = np.ascontiguousarray(frames)
    y = np.empty((*lead, S, S), np.uint8)
    uv = np.empty((*lead, S // 2, S // 2, 2), np.uint8)
    lib.avsr_rgb_to_yuv420(_ptr(frames, ctypes.c_uint8), T, S,
                           _ptr(y, ctypes.c_uint8), _ptr(uv, ctypes.c_uint8),
                           num_threads)
    return y, uv
