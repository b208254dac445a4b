"""The training loop, the port of ``avsr_tpu/train/loop.py::Trainer``:
epochs, shape-keyed accumulation groups, the unstable-step guard, the loss
log and CSV, and each epoch's validation loss.

A group of ``grad_accum_steps`` loader batches of one shape makes one
optimizer step; at the end of an epoch each partial group of n batches
steps as it is, each batch weighing 1 / n (the JAX Trainer pads it to its
compiled shape with zero-weight copies, which gives the same update).

Still to be ported, and refused by the constructor when the config asks
for them: checkpoints (the port writes none, so ``training.save_every_steps``
must be 0), resume, in-training WER eval and WER-based best-metric
selection, early stopping, profiling, and training on a quantized base
(``model.use_4bit`` / ``use_8bit``, QLoRA; the port serves such a base). ``training.save_every_secs``, the
JAX Trainer's timed checkpoint, has no effect here; its default (two hours)
is on in every config, so the constructor logs a warning instead of
refusing it. Preemption handling is not ported either.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import numpy as np
import torch

from avsr_tpu_torch.core.config import AVSRConfig
from avsr_tpu_torch.core.logging import CSVLogger, ThroughputMeter
from avsr_tpu_torch.data.loader import DataLoader
from avsr_tpu_torch.models.avsr import Batch
from avsr_tpu_torch.train.state import count_trainable, create_train_state
from avsr_tpu_torch.train.step import make_eval_step, make_train_step

log = logging.getLogger("avsr_tpu_torch.train")

CSV_FIELDS = ["step", "epoch", "split", "loss", "accuracy", "wer", "grad_norm",
              "lr_step_time_s", "tokens_per_sec", "utts_per_sec", "skipped"]


def check_supported(cfg: AVSRConfig) -> None:
    t = cfg.training
    asked = {"training.save_every_steps (checkpoints; set it to 0)":
             t.save_every_steps != 0,
             "training.resume_from": bool(t.resume_from),
             "training.eval_wer_every_epochs": t.eval_wer_every_epochs > 0,
             "training.best_metric=wer": t.best_metric != "loss",
             "training.early_stop_patience": t.early_stop_patience > 0,
             "runtime.profile_dir": bool(cfg.runtime.profile_dir),
             "model.use_4bit / model.use_8bit (QLoRA training)":
             cfg.model.use_4bit or cfg.model.use_8bit}
    wanted = [k for k, v in asked.items() if v]
    if wanted:
        raise NotImplementedError(
            f"{', '.join(wanted)}: not yet ported to avsr_tpu_torch")


class Trainer:
    def __init__(self, cfg: AVSRConfig, params, train_loader: DataLoader,
                 val_loader: DataLoader | None = None):
        check_supported(cfg)
        self.cfg = cfg
        t = cfg.training
        if t.save_every_secs < float("inf"):
            log.warning("training.save_every_secs=%s: the port writes no "
                        "timed checkpoint", t.save_every_secs)
        steps_per_epoch = max(len(train_loader) // max(t.grad_accum_steps, 1), 1)
        self.total_steps = (t.max_steps if t.max_steps > 0
                            else steps_per_epoch * t.num_epochs)
        self.state = create_train_state(params, cfg, self.total_steps)
        self.train_step = make_train_step(cfg)
        self.eval_step = make_eval_step(cfg)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.csv = CSVLogger(Path(t.checkpoint_dir) / "loss_log.csv", CSV_FIELDS)
        self.meter = ThroughputMeter()
        self.history: list[float] = []      # train losses, one per step
        self.best_val = float("inf")
        self._rng = np.random.default_rng(t.seed)   # dropout seeds per step
        self._unstable = 0
        trainable, total = count_trainable(params, cfg.model)
        log.info("model: %.2fM params, %.2fM trainable (%.1f%%)",
                 total / 1e6, trainable / 1e6, 100 * trainable / max(total, 1))

    def train(self) -> dict[str, Any]:
        accum = max(self.cfg.training.grad_accum_steps, 1)
        epoch = 0
        while self.state.step < self.total_steps:
            epoch += 1
            # batches of different length buckets have different shapes;
            # accumulate per shape so every stacked group is homogeneous
            groups: dict[tuple, list[Batch]] = {}
            for _, batch in self.train_loader:
                key = tuple(None if x is None else tuple(x.shape) for x in batch)
                group = groups.setdefault(key, [])
                group.append(batch)
                if len(group) < accum:
                    continue
                del groups[key]
                self._guarded_step(group, epoch)
                if self.state.step >= self.total_steps:
                    break
            for group in groups.values():
                if self.state.step >= self.total_steps:
                    break
                self._guarded_step(group, epoch)
            self._end_of_epoch(epoch)
        return {"steps": self.state.step, "epochs": epoch,
                "best_val": self.best_val}

    def _guarded_step(self, micro_batches: list[Batch], epoch: int) -> dict[str, float]:
        metrics = self._step(micro_batches, epoch)
        if metrics["skipped"]:
            self._unstable += 1
            if self._unstable > self.cfg.training.max_unstable_batches:
                raise RuntimeError(
                    f"too many unstable steps ({self._unstable}), aborting")
        else:
            self._unstable = 0
        return metrics

    def _step(self, micro_batches: list[Batch], epoch: int) -> dict[str, float]:
        t = self.cfg.training
        n = len(micro_batches)
        stacked = Batch(*[None if xs[0] is None else torch.stack(xs)
                          for xs in zip(*micro_batches)])
        m = self.train_step(self.state, stacked, int(self._rng.integers(2**63)))
        step = self.state.step
        self.history.append(m["loss"])
        labels = micro_batches[0].label_lens
        thr = self.meter.step(int(labels.sum()) * n, labels.shape[0] * n)
        if step % max(t.log_interval, 1) == 0 or step == 1:
            log.info("step %d/%d | loss %.4f | acc %.3f | gnorm %.2f | "
                     "%.1f tok/s | %.2f utt/s", step, self.total_steps,
                     m["loss"], m["accuracy"], m["grad_norm"],
                     thr["tokens_per_sec"], thr["utts_per_sec"])
        self.csv.log(step=step, epoch=epoch, split="train", **m,
                     lr_step_time_s=round(thr["step_time_s"], 4),
                     tokens_per_sec=round(thr["tokens_per_sec"], 1),
                     utts_per_sec=round(thr["utts_per_sec"], 3))
        return m

    def _end_of_epoch(self, epoch: int) -> None:
        if self.val_loader is None:
            return
        losses, accs = [], []
        for _, batch in self.val_loader:
            out = self.eval_step(self.state.params, batch)
            losses.append(out["loss"] if np.isfinite(out["loss"]) else 1e6)
            accs.append(out["accuracy"])
        if not losses:
            return
        val_loss = float(np.mean(losses))
        self.best_val = min(self.best_val, val_loss)
        log.info("epoch %d | val loss %.4f | val acc %.3f", epoch, val_loss,
                 float(np.mean(accs)))
        self.csv.log(step=self.state.step, epoch=epoch, split="val",
                     loss=val_loss, accuracy=float(np.mean(accs)))
