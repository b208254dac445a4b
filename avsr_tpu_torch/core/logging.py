"""Metrics logging of the Trainer, a copy of the corresponding parts of
``avsr_tpu/core/logging.py``: the per-step loss CSV, a windowed
tokens/s + utterances/s meter, the loss-stability monitor behind the
emergency checkpoint, and the loss history (JSON, and a PNG where
matplotlib imports).
"""

from __future__ import annotations

import csv
import json
import math
import time
from collections import deque
from pathlib import Path
from typing import Any


class CSVLogger:
    """Append-only CSV metrics log (``loss_log.csv``)."""

    def __init__(self, path: str | Path, fieldnames: list[str]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.fieldnames = fieldnames
        if not self.path.exists():
            with open(self.path, "w", newline="") as fh:
                csv.DictWriter(fh, fieldnames=fieldnames).writeheader()
            return
        # An existing file with another header is rewritten with this one,
        # so that appended rows stay aligned with the columns.
        with open(self.path, newline="") as fh:
            reader = csv.DictReader(fh)
            if (reader.fieldnames or []) == fieldnames:
                return
            rows = list(reader)
        with open(self.path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=fieldnames)
            writer.writeheader()
            for row in rows:
                writer.writerow({k: row.get(k, "") for k in fieldnames})

    def log(self, **row: Any) -> None:
        with open(self.path, "a", newline="") as fh:
            csv.DictWriter(fh, fieldnames=self.fieldnames).writerow(
                {k: row.get(k, "") for k in self.fieldnames})


class ThroughputMeter:
    """Rolling tokens/s + utterances/s + step-time meter (window-averaged,
    host clock between calls)."""

    def __init__(self, window: int = 50):
        self._events: deque[tuple[float, int, int]] = deque(maxlen=window)
        self._last = time.perf_counter()

    def step(self, n_tokens: int, n_utts: int) -> dict[str, float]:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._events.append((dt, n_tokens, n_utts))
        total_t = sum(e[0] for e in self._events) or 1e-9
        return {
            "step_time_s": dt,
            "tokens_per_sec": sum(e[1] for e in self._events) / total_t,
            "utts_per_sec": sum(e[2] for e in self._events) / total_t,
        }



class LossStabilityMonitor:
    """Reports instability after ``max_bad`` consecutive non-finite losses;
    keeps the last ``window`` losses."""

    def __init__(self, window: int = 5, max_bad: int = 3):
        self.window: deque[float] = deque(maxlen=window)
        self.max_bad = max_bad
        self.consecutive_bad = 0

    def update(self, loss: float) -> bool:
        """True when an emergency checkpoint should be taken."""
        finite = math.isfinite(loss)
        self.window.append(loss if finite else float("nan"))
        self.consecutive_bad = 0 if finite else self.consecutive_bad + 1
        return self.consecutive_bad >= self.max_bad


def save_loss_plot(losses: dict[str, list[float]], out_dir: str | Path) -> None:
    """``loss_history.json`` ({"train": [...], "val": [...]}) always, and
    ``loss_curve.png`` when matplotlib imports."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "loss_history.json", "w") as fh:
        json.dump(losses, fh)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, series in losses.items():
        if series:
            ax.plot(series, label=name)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    fig.savefig(out / "loss_curve.png", dpi=100, bbox_inches="tight")
    plt.close(fig)
