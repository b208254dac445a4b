"""Media save and extract helpers, a copy of ``avsr_tpu/data/media.py``:

  * ``save_audio``: the dependency-free PCM16 WAV writer
    (``audio_io.write_wav``);
  * ``save_video``: cv2's VideoWriter (mp4v), cv2 imported when called (a
    host without cv2, such as the H100's, raises its ``ImportError``);
  * ``extract_audio_from_video``: an ``ffmpeg`` subprocess when the binary
    is on PATH, else a ``RuntimeError`` that says so;
  * ``save_results``: the JSON results writer.
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
from pathlib import Path
from typing import Any

import numpy as np

from avsr_tpu_torch.data.audio_io import TARGET_SR, load_audio, write_wav

log = logging.getLogger("avsr_tpu_torch.media")

save_audio = write_wav


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def extract_audio_from_video(video_path: str | Path,
                             out_wav: str | Path | None = None,
                             sample_rate: int = TARGET_SR) -> np.ndarray:
    """The audio track of a video as mono f32 at ``sample_rate``, written
    to ``out_wav`` (the video's path with ``.wav`` by default) and
    returned. Needs ``ffmpeg``; raises ``RuntimeError`` without it."""
    video_path = Path(video_path)
    out_wav = Path(out_wav) if out_wav else video_path.with_suffix(".wav")
    if not ffmpeg_available():
        raise RuntimeError(
            f"cannot extract audio from {video_path}: ffmpeg not found on "
            "PATH (provide a sibling .wav per the manifest instead)")
    cmd = ["ffmpeg", "-y", "-i", str(video_path), "-vn",
           "-acodec", "pcm_s16le", "-ar", str(sample_rate), "-ac", "1",
           str(out_wav)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 or not out_wav.exists():
        raise RuntimeError(f"ffmpeg failed on {video_path}: {proc.stderr[-500:]}")
    return load_audio(out_wav, target_sr=sample_rate)


def save_video(frames: np.ndarray, path: str | Path, fps: float = 25.0) -> None:
    """uint8 [T, H, W, 3] RGB -> an mp4 file."""
    import cv2

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    T, H, W, _ = frames.shape
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    try:
        for t in range(T):
            writer.write(cv2.cvtColor(frames[t], cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    if not path.exists():
        raise IOError(f"failed to write video {path}")


def save_results(results: dict[str, Any] | list[Any], path: str | Path) -> None:
    """Writes ``results`` as indented JSON (anything else as its string)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(results, fh, indent=2, default=str)
    log.info("results saved to %s", path)
