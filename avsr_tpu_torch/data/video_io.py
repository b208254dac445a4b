"""Host-side video I/O, a copy of ``avsr_tpu/data/video_io.py``: frame
extraction for the CLIP encoder.

The host only decodes and uniformly samples frames as uint8
(``data/dataset.py::resize_crop_frames`` then resizes them); normalization
happens on the device (``ops/image.py``).

Supports ``.npy`` arrays [T, H, W, 3] uint8 and video files through cv2
(mp4/avi/...), imported only when a video file is read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from avsr_tpu_torch.ops.image import sample_frame_indices


def load_frames(path: str | Path, max_frames: int) -> np.ndarray:
    """-> uint8 [T, H, W, 3] RGB, T <= max_frames."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path)
        if arr.ndim != 4 or arr.shape[-1] != 3:
            raise ValueError(f"{path}: expected [T,H,W,3], got {arr.shape}")
        idx = sample_frame_indices(arr.shape[0], max_frames)
        return np.ascontiguousarray(arr[idx]).astype(np.uint8)
    return _load_frames_cv2(path, max_frames)


def _load_frames_cv2(path: Path, max_frames: int) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total > 0:
            wanted = set(sample_frame_indices(total, max_frames).tolist())
            frames = []
            i = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if i in wanted:
                    frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                i += 1
        else:  # stream without frame count: read all, then sample
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            idx = sample_frame_indices(len(frames), max_frames)
            frames = [frames[j] for j in idx]
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames).astype(np.uint8)
