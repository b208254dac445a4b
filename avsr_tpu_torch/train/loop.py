"""The training loop, the port of ``avsr_tpu/train/loop.py::Trainer``:
epochs, shape-keyed accumulation groups, the unstable-step guard, the loss
log and CSV, each epoch's validation loss, in-training WER, best-metric
selection and early stopping, checkpoints and resume, preemption, and a
profiler trace.

A group of ``grad_accum_steps`` loader batches of one shape makes one
optimizer step; at the end of an epoch each partial group of n batches
steps as it is, each batch weighing 1 / n (the JAX Trainer pads it to its
compiled shape with zero-weight copies, which gives the same update).

Checkpoints (``train/checkpoint.py``, the port's own format) go to
``training.checkpoint_dir/ckpt``: every ``save_every_steps`` steps, every
``save_every_secs`` seconds, at the end (``final``), on a better
validation metric (``best``), on SIGTERM (``preempt``: the handler sets a
flag, the step in flight finishes, the run saves and stops; installed on
the main thread only and restored when ``train`` exits), and in an
emergency (three non-finite losses in a row, or an exception escaping
``train``). Each carries the loader position and the best-metric and
early-stop progress, so :meth:`Trainer.maybe_resume` continues mid-epoch
without repeating a sample.

Dropout seeds restart from ``training.seed`` on resume, as the JAX
Trainer's dropout key does. Training on a quantized base (QLoRA,
``model.use_4bit`` / ``use_8bit``) is still to be ported and refused.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from avsr_tpu_torch.core.config import AVSRConfig
from avsr_tpu_torch.core.logging import (CSVLogger, LossStabilityMonitor,
                                         ThroughputMeter, save_loss_plot)
from avsr_tpu_torch.data.loader import DataLoader
from avsr_tpu_torch.models.avsr import Batch
from avsr_tpu_torch.train.checkpoint import CheckpointManager
from avsr_tpu_torch.train.state import count_trainable, create_train_state
from avsr_tpu_torch.train.step import make_eval_step, make_train_step

log = logging.getLogger("avsr_tpu_torch.train")

CSV_FIELDS = ["step", "epoch", "split", "loss", "accuracy", "wer", "grad_norm",
              "lr_step_time_s", "tokens_per_sec", "utts_per_sec", "skipped"]

# runtime.profile_dir traces these steps (past the first steps' warm-up)
PROFILE_STEPS = (4, 7)


def check_supported(cfg: AVSRConfig) -> None:
    if cfg.model.use_4bit or cfg.model.use_8bit:
        raise NotImplementedError(
            "model.use_4bit / model.use_8bit (QLoRA training): not yet "
            "ported to avsr_tpu_torch")


class _Preempted(Exception):
    pass


class _EarlyStopped(Exception):
    pass


class Trainer:
    def __init__(self, cfg: AVSRConfig, params, train_loader: DataLoader,
                 val_loader: DataLoader | None = None, tok=None):
        check_supported(cfg)
        self.cfg = cfg
        t = cfg.training
        steps_per_epoch = max(len(train_loader) // max(t.grad_accum_steps, 1), 1)
        self.total_steps = (t.max_steps if t.max_steps > 0
                            else steps_per_epoch * t.num_epochs)
        self.state = create_train_state(params, cfg, self.total_steps)
        self.train_step = make_train_step(cfg)
        self.eval_step = make_eval_step(cfg)
        self.train_loader = train_loader
        self.val_loader = val_loader
        out = Path(t.checkpoint_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.ckpt = CheckpointManager(out / "ckpt", cfg, keep=t.keep_checkpoints)
        self.csv = CSVLogger(out / "loss_log.csv", CSV_FIELDS)
        self.monitor = LossStabilityMonitor(window=t.loss_stability_window,
                                            max_bad=3)
        self.meter = ThroughputMeter()
        self.history: dict[str, list[float]] = {"train": [], "val": []}
        self.best_val = float("inf")
        self.tok = tok
        self.best_wer = float("inf")
        self._evals_no_improve = 0
        if t.eval_wer_every_epochs > 0 and tok is None and val_loader is not None:
            log.warning("eval_wer_every_epochs set but the Trainer got no "
                        "tokenizer: in-training WER eval disabled")
        self._last_time_ckpt = time.time()
        self._rng = np.random.default_rng(t.seed)   # dropout seeds per step
        self._profiler: torch.profiler.profile | None = None
        self._start_epoch = 0
        self._preempted = False
        self._groups: dict[tuple, list[Batch]] = {}
        self._cuda = any(p.is_cuda for p in self.state.optimizer.leaves)
        trainable, total = count_trainable(params, cfg.model)
        log.info("model: %.2fM params, %.2fM trainable (%.1f%%)",
                 total / 1e6, trainable / 1e6, 100 * trainable / max(total, 1))

    # ------------------------------------------------------------------

    def maybe_resume(self) -> bool:
        """Restores ``training.resume_from``, or this run's own checkpoint
        directory when it holds a step: the train state in place, the
        best-metric and early-stop progress, and the loader's position."""
        src = self.cfg.training.resume_from or (
            str(self.ckpt.dir) if self.ckpt.latest_step() is not None else "")
        if not src:
            return False
        mngr = self.ckpt if src == str(self.ckpt.dir) else CheckpointManager(src)
        try:
            mngr.restore(self.state)
        except FileNotFoundError:
            return False
        meta = mngr.read_meta(self.state.step) or {}
        fit = meta.get("fit_state")
        if fit:
            self.best_val = float(fit.get("best_val", self.best_val))
            self.best_wer = float(fit.get("best_wer", self.best_wer))
            self._evals_no_improve = int(fit.get("evals_no_improve",
                                                 self._evals_no_improve))
        ds = meta.get("data_state")
        if ds:
            self.train_loader.set_position(ds["epoch"], ds["batches"])
            self._start_epoch = max(ds["epoch"] - 1, 0)
            log.info("resumed from step %d (epoch %d, batch %d)",
                     self.state.step, ds["epoch"], ds["batches"])
        else:
            log.info("resumed from step %d", self.state.step)
        return True

    # ------------------------------------------------------------------

    def train(self) -> dict[str, Any]:
        accum = max(self.cfg.training.grad_accum_steps, 1)
        epoch = self._start_epoch
        self._unstable = 0
        self._install_preemption_handler()
        try:
            while self.state.step < self.total_steps:
                epoch += 1
                # batches of different length buckets have different
                # shapes; accumulate per shape so every stacked group is
                # homogeneous
                self._groups = {}
                for _, batch in self.train_loader:
                    key = tuple(None if x is None else tuple(x.shape) for x in batch)
                    group = self._groups.setdefault(key, [])
                    group.append(batch)
                    if len(group) < accum:
                        continue
                    del self._groups[key]
                    self._guarded_step(group, epoch)
                    if self.state.step >= self.total_steps:
                        break
                if self.state.step < self.total_steps:
                    for group in list(self._groups.values()):
                        if self.state.step >= self.total_steps:
                            break
                        self._guarded_step(group, epoch)
                    self._groups = {}
                self._end_of_epoch(epoch)
        except _Preempted:
            log.info("stopped on preemption at step %d: resume to continue",
                     self.state.step)
        except _EarlyStopped:
            log.info("early stop at epoch %d: no %s improvement in %d evals "
                     "(best loss %.4f, best WER %.4f)", epoch,
                     self.cfg.training.best_metric, self._evals_no_improve,
                     self.best_val, self.best_wer)
        except (KeyboardInterrupt, Exception):
            log.exception("training interrupted: emergency checkpoint")
            self.ckpt.save(self.state, tag="emergency",
                           data_state=self._data_state(),
                           fit_state=self._fit_state())
            self.ckpt.wait()
            raise
        finally:
            self._stop_profiler()
            self._restore_sigterm_handler()
        if not self._preempted:   # the preempt path saved this step already
            self.ckpt.save(self.state, tag="final",
                           is_best=not np.isfinite(self.best_val),
                           data_state=self._data_state(),
                           fit_state=self._fit_state())
        self.ckpt.wait()
        save_loss_plot(self.history, Path(self.cfg.training.checkpoint_dir))
        return {"steps": self.state.step, "epochs": epoch,
                "best_val": self.best_val, "best_wer": self.best_wer}

    # ------------------------------------------------------------------

    def _data_state(self) -> dict[str, int]:
        """The loader position for a checkpoint. Batches taken into
        accumulation groups that have not stepped yet are not in the
        params, so the position rewinds past them and they replay on
        resume."""
        st = self.train_loader.state()
        pending = sum(len(g) for g in self._groups.values())
        return {"epoch": st["epoch"], "batches": max(st["batches"] - pending, 0)}

    def _fit_state(self) -> dict[str, float | int]:
        """Best-metric and early-stop progress, so that a resumed run keeps
        its patience count and does not overwrite ``best`` with a worse
        model."""
        return {"best_val": self.best_val, "best_wer": self.best_wer,
                "evals_no_improve": self._evals_no_improve}

    def _save(self, metrics: dict[str, float] | None = None, **kw) -> None:
        self.ckpt.save(self.state, metrics=metrics, data_state=self._data_state(),
                       fit_state=self._fit_state(), **kw)

    # ------------------------------------------------------------------

    def _guarded_step(self, micro_batches: list[Batch], epoch: int) -> dict[str, float]:
        metrics = self._step(micro_batches, epoch)
        if metrics["skipped"]:
            self._unstable += 1
            if self._unstable > self.cfg.training.max_unstable_batches:
                raise RuntimeError(
                    f"too many unstable steps ({self._unstable}), aborting")
        else:
            self._unstable = 0
        if self.monitor.update(metrics["loss"]):
            log.error("loss unstable: emergency checkpoint")
            self._save(metrics, tag="emergency")
        return metrics

    def _step(self, micro_batches: list[Batch], epoch: int) -> dict[str, float]:
        t = self.cfg.training
        n = len(micro_batches)
        stacked = Batch(*[None if xs[0] is None else torch.stack(xs)
                          for xs in zip(*micro_batches)])
        m = self.train_step(self.state, stacked, int(self._rng.integers(2**63)))
        step = self.state.step
        self.history["train"].append(m["loss"])
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
        if t.save_every_steps > 0 and step % t.save_every_steps == 0:
            self._save(m)
        if time.time() - self._last_time_ckpt > t.save_every_secs:
            self._save(m, tag="timed")
            self._last_time_ckpt = time.time()
        self._maybe_profile(step)
        if step % 100 == 0:
            self._log_device_memory(step)
        if self._preempted:
            log.warning("preemption signal: checkpoint and clean stop")
            self._save(m, tag="preempt")
            self.ckpt.wait()
            raise _Preempted
        return m

    # ------------------------------------------------------------------

    def _install_preemption_handler(self) -> None:
        """SIGTERM sets a flag that the next step boundary acts on. Only the
        main thread may install a handler (tests may run elsewhere)."""
        self._preempted = False
        self._sigterm_installed = False
        if threading.current_thread() is not threading.main_thread():
            return

        def on_term(signum, frame):
            del signum, frame
            self._preempted = True

        self._old_sigterm = signal.signal(signal.SIGTERM, on_term)
        self._own_sigterm = on_term
        self._sigterm_installed = True

    def _restore_sigterm_handler(self) -> None:
        """Puts back the handler that :meth:`_install_preemption_handler`
        replaced, unless someone bound another one since: a finished
        Trainer that kept its handler would swallow the process's SIGTERM.
        A previous handler of None (set from C) restores as SIG_DFL."""
        if not self._sigterm_installed:
            return
        self._sigterm_installed = False
        if signal.getsignal(signal.SIGTERM) is self._own_sigterm:
            signal.signal(signal.SIGTERM, signal.SIG_DFL if self._old_sigterm is None
                          else self._old_sigterm)

    def _log_device_memory(self, step: int) -> None:
        if not self._cuda:
            return
        stats = torch.cuda.memory_stats()
        log.info("step %d | device mem %.2f GiB (peak %.2f / reserved %.2f)",
                 step, stats.get("allocated_bytes.all.current", 0) / 2**30,
                 stats.get("allocated_bytes.all.peak", 0) / 2**30,
                 stats.get("reserved_bytes.all.current", 0) / 2**30)

    def _maybe_profile(self, step: int) -> None:
        """``runtime.profile_dir``: a ``torch.profiler`` trace (CPU, and the
        card's activity when the run is on one) of the steps after
        ``PROFILE_STEPS[0]`` through ``PROFILE_STEPS[1]``, exported as a
        Chrome trace."""
        pdir = self.cfg.runtime.profile_dir
        if not pdir:
            return
        first, last = PROFILE_STEPS
        if step == first and self._profiler is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self._cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
            log.info("profiler: tracing steps %d-%d -> %s", first, last, pdir)
        elif step == last:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        prof.stop()
        pdir = Path(self.cfg.runtime.profile_dir)
        pdir.mkdir(parents=True, exist_ok=True)
        path = pdir / f"trace_step{self.state.step}.json"
        prof.export_chrome_trace(str(path))
        log.info("profiler: trace written to %s", path)

    # ------------------------------------------------------------------

    def _end_of_epoch(self, epoch: int) -> None:
        if self.val_loader is None:
            return
        t = self.cfg.training
        losses, accs = [], []
        for _, batch in self.val_loader:
            out = self.eval_step(self.state.params, batch)
            losses.append(out["loss"] if np.isfinite(out["loss"]) else 1e6)
            accs.append(out["accuracy"])
        if not losses:
            return
        val_loss = float(np.mean(losses))
        self.history["val"].append(val_loss)
        log.info("epoch %d | val loss %.4f | val acc %.3f", epoch, val_loss,
                 float(np.mean(accs)))
        self.csv.log(step=self.state.step, epoch=epoch, split="val",
                     loss=val_loss, accuracy=float(np.mean(accs)))
        val_wer = None
        if (t.eval_wer_every_epochs > 0 and self.tok is not None
                and epoch % t.eval_wer_every_epochs == 0):
            val_wer = self._eval_wer(epoch)

        # best_metric="wer" compares only on epochs that ran a WER eval;
        # "loss" compares every epoch. Both bests are tracked either way.
        if t.best_metric == "wer":
            if val_wer is None:
                self.best_val = min(self.best_val, val_loss)
                return
            improved = val_wer < self.best_wer
            metrics = {"val_wer": val_wer, "val_loss": val_loss}
        else:
            improved = val_loss < self.best_val
            metrics = {"val_loss": val_loss}
            if val_wer is not None:
                metrics["val_wer"] = val_wer
        self.best_val = min(self.best_val, val_loss)
        if val_wer is not None:
            self.best_wer = min(self.best_wer, val_wer)
        if improved:
            self._evals_no_improve = 0
            self.ckpt.save(self.state, metrics=metrics, is_best=True, tag="best",
                           fit_state=self._fit_state())
        else:
            self._evals_no_improve += 1
            if 0 < t.early_stop_patience <= self._evals_no_improve:
                raise _EarlyStopped

    def _eval_wer(self, epoch: int) -> float:
        """Greedy-decodes up to ``eval_wer_max_utts`` validation utterances
        with the current params and returns the corpus WER; each utterance
        counts once (the last batch is wrap-padded)."""
        from avsr_tpu_torch.infer.generate import generate_tokens
        from avsr_tpu_torch.infer.wer import WERAccumulator

        t, d = self.cfg.training, self.cfg.decode
        acc = WERAccumulator()
        seen: set[str] = set()
        t0 = time.perf_counter()
        for hb, batch in self.val_loader:
            out = generate_tokens(
                self.state.params, self.cfg.model, batch,
                max_new_tokens=d.max_new_tokens, eos_id=self.tok.eos_id,
                compute_dtype=getattr(torch, self.cfg.runtime.compute_dtype),
                use_kernel=self.cfg.runtime.use_pallas,
                kv_cache_dtype=d.kv_cache_dtype)
            tokens = out.tokens.cpu().numpy()
            lens = out.lengths.cpu().numpy()
            for i, (utt, ref) in enumerate(zip(hb.utt_ids, hb.texts)):
                if utt in seen:
                    continue
                seen.add(utt)
                acc.add(ref, self.tok.decode(tokens[i, : lens[i]]))
            if acc.utterances >= t.eval_wer_max_utts:
                break
        log.info("epoch %d | val WER %.4f CER %.4f (%d utts, %.3fs)", epoch,
                 acc.wer, acc.cer, acc.utterances, time.perf_counter() - t0)
        self.csv.log(step=self.state.step, epoch=epoch, split="val_wer",
                     wer=round(acc.wer, 4))
        return acc.wer
