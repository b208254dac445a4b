"""The port's native data library vs the JAX package's (CPU).

Both build ``avsr_native.cpp`` (ABI version 3) with g++: the port's copy
into ``avsr_tpu_torch/build/``. The same source gives the same bits, so
WAV decode (with resampling), frame resize and the YUV420 packing must be
equal to JAX's exactly, on inputs made from a seed with numpy; decode
against the Python reader within JAX's own bounds.
"""

import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from avsr_tpu import native as jnative
from avsr_tpu.data.audio_io import write_wav
from avsr_tpu_torch import native as tnative
from avsr_tpu_torch.data.audio_io import load_audio

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def libs():
    if not (jnative.available() and tnative.available()):
        pytest.skip("native library unavailable (no g++)")


def noise_wav(path, sr, secs, seed, channels=1):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((int(sr * secs), channels))).astype(np.float32)
    x16 = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x16.tobytes())


def test_library_builds_into_the_port_build_dir(libs):
    lib = tnative.library_path()
    assert lib.parent == REPO / "avsr_tpu_torch" / "build" and lib.is_file()
    assert "-march=native" not in tnative.GXX_FLAGS and "-O3" in tnative.GXX_FLAGS
    assert tnative.load().avsr_native_abi_version() == tnative.ABI_VERSION == 3


@pytest.mark.parametrize("sr,channels", [(16000, 1), (8000, 1), (48000, 1), (44100, 2)])
def test_decode_wav_equals_jax(libs, tmp_path, sr, channels):
    noise_wav(tmp_path / "a.wav", sr, 0.7, seed=sr, channels=channels)
    out, lens = tnative.decode_wav_batch([tmp_path / "a.wav", tmp_path / "missing.wav"],
                                         16000, max_samples=16000)
    want = jnative.decode_wav(tmp_path / "a.wav", 16000, max_samples=16000)
    assert abs(lens[0] - 11200) <= 4 and lens[1] == 0
    np.testing.assert_array_equal(out[0, :lens[0]], want)


def test_decode_wav_batch_equals_jax(libs, tmp_path):
    paths = []
    for i, sr in enumerate((16000, 48000, 8000, 16000)):
        p = tmp_path / f"u{i}.wav"
        noise_wav(p, sr, 0.3 + 0.1 * i, seed=i)
        paths.append(p)
    (tmp_path / "bad.wav").write_bytes(b"garbage")
    paths.insert(2, tmp_path / "bad.wav")
    want, want_lens = jnative.decode_wav_batch(paths, 16000, max_samples=8000)
    for threads in (0, 1, 3):
        out, lens = tnative.decode_wav_batch(paths, 16000, max_samples=8000,
                                             num_threads=threads)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(lens, want_lens)
    assert lens[2] == 0 and not out[2].any()          # the failed row
    assert lens[0] == 4800 and not out[0, 4800:].any()   # zeroed padding
    buf = np.full((5, 8000), 7.0, np.float32)
    out, _ = tnative.decode_wav_batch(paths, 16000, max_samples=8000, out=buf)
    assert out is buf
    with pytest.raises(ValueError, match="C-contiguous f32"):
        tnative.decode_wav_batch(paths, 16000, max_samples=8000,
                                 out=np.zeros((5, 8000), np.float64))


def native_decode(path):
    out, lens = tnative.decode_wav_batch([path])
    return out[0, :lens[0]]


def test_native_decode_against_python(libs, tmp_path):
    t = np.arange(16000, dtype=np.float32) / 16000
    write_wav(tmp_path / "a.wav", (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32))
    np.testing.assert_allclose(native_decode(tmp_path / "a.wav"),
                               load_audio(tmp_path / "a.wav"), atol=1e-6)
    t = np.arange(8000, dtype=np.float32) / 8000
    write_wav(tmp_path / "b.wav", (0.5 * np.sin(2 * np.pi * 150 * t)).astype(np.float32),
              8000)
    got, ref = native_decode(tmp_path / "b.wav"), load_audio(tmp_path / "b.wav")
    n = min(len(got), len(ref))
    assert np.abs(got[:n] - ref[:n])[200:n - 200].max() < 5e-3   # scipy's polyphase


@pytest.mark.parametrize("shape", [(5, 37, 53), (3, 96, 96), (2, 60, 40), (2, 8, 12)])
def test_resize_crop_frames_equals_jax(libs, shape):
    frames = np.random.default_rng(1).integers(0, 256, (*shape, 3)).astype(np.uint8)
    want = jnative.resize_crop_frames(frames, 16)
    for threads in (0, 1, 2):
        np.testing.assert_array_equal(tnative.resize_crop_frames(frames, 16, threads), want)
    same = frames[:, :8, :8]
    assert tnative.resize_crop_frames(same, 8) is same
    with pytest.raises(ValueError, match=r"u8 \[T, H, W, 3\]"):
        tnative.resize_crop_frames(frames.astype(np.float32), 16)


def test_rgb_to_yuv420_equals_jax(libs):
    frames = np.random.default_rng(2).integers(0, 256, (2, 3, 16, 16, 3)).astype(np.uint8)
    for t, j in zip(tnative.rgb_to_yuv420(frames), jnative.rgb_to_yuv420(frames)):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    with pytest.raises(ValueError, match="even S"):
        tnative.rgb_to_yuv420(frames[..., :15, :15, :])


def test_no_native_env_disables_the_library():
    probe = ("from avsr_tpu_torch import native; print(native.available(), "
             "native.decode_wav_batch(['x.wav']), native.rgb_to_yuv420(None))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "AVSR_NO_NATIVE": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "None", "None"]
