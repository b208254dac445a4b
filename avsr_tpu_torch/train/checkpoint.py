"""Checkpoints of the port's Trainer: the counterpart of
``avsr_tpu/train/checkpoint.py``, with its API and semantics, in a format
of the port's own (the JAX package writes Orbax directories, which this
module does not read).

A checkpoint directory holds:

  {step}/params.pt     the parameter tree (``torch.save``)
  {step}/train.pt      {"step", "opt_state"}: the step and the optimizer
  meta_{step}.json     step, time, metrics, tag, is_best, and data_state,
                       fit_state and config when given
  best.json            the meta of the newest save with ``is_best``

A params export (:func:`export_params`) is a directory with one
``params.pt``, so a step directory can be read as an export too
(:func:`load_params`). Files are read with ``torch.load(weights_only=True)``
to the CPU, so a checkpoint written on the card loads on a host without
one, and back.

As with Orbax (``enable_async_checkpointing``, and 0.11's rule that a save
at a step not newer than the newest saved step writes nothing):

  * ``save`` returns once the tensors are copied to the host (pinned
    buffers, reused from save to save, then a synchronize: the optimizer
    updates the live tensors in place, so the next step must not reach a
    checkpoint), and a writer thread puts them on disk; ``wait`` joins it
    and raises what it raised;
  * a save at a step that is not newer than the newest saved step writes
    only the JSON (the Trainer's ``final`` and ``best`` saves often fall on
    a step that ``save_every_steps`` already wrote);
  * a step directory is written under a temporary name and renamed, so
    ``latest_step`` never sees a half-written step;
  * retention keeps the newest ``keep`` steps, best or not (``best.json``
    can name a step that retention removed, as in the JAX package).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any

import torch

from avsr_tpu_torch.core.config import AVSRConfig, to_dict
from avsr_tpu_torch.train.state import (TrainState, check_like, path_leaves,
                                        tree_map_with_path)

log = logging.getLogger("avsr_tpu_torch.train.checkpoint")

PARAMS_FILE = "params.pt"
TRAIN_FILE = "train.pt"
_TMP = ".tmp-"


def _save_file(obj: Any, path: Path) -> None:
    with open(path, "wb") as fh:
        torch.save(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())


def _load_file(path: Path) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _write_json(path: Path, obj: Any) -> None:
    tmp = path.with_name(_TMP + path.name)
    with open(tmp, "w") as fh:
        json.dump(obj, fh, indent=2)
    os.replace(tmp, path)


def _write_dir(target: Path, files: dict[str, Any]) -> None:
    """Writes ``files`` into a temporary directory beside ``target``, then
    renames it to ``target``."""
    tmp = Path(tempfile.mkdtemp(prefix=_TMP, dir=target.parent))
    try:
        for name, obj in files.items():
            _save_file(obj, tmp / name)
        os.rename(tmp, target)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class CheckpointManager:
    def __init__(self, directory: str | Path, cfg: AVSRConfig | None = None,
                 keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.keep = keep
        self._pinned: dict[str, torch.Tensor] = {}
        self._thread: threading.Thread | None = None
        self._pending: int | None = None
        self._error: BaseException | None = None

    # -- save ---------------------------------------------------------------

    def save(self, state: TrainState, *, metrics: dict[str, Any] | None = None,
             is_best: bool = False, tag: str = "",
             data_state: dict[str, int] | None = None,
             fit_state: dict[str, Any] | None = None) -> None:
        step = int(state.step)
        latest = self.latest_step()
        if latest is None or step > latest:
            self.wait()                 # the pinned buffers are free again
            t0 = time.perf_counter()
            sd = state.state_dict()
            host = self._to_host(sd)
            if any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in path_leaves(sd).values()):
                torch.cuda.synchronize()
            copy_s = time.perf_counter() - t0
            self._pending = step
            self._thread = threading.Thread(
                target=self._write, args=(step, host, copy_s),
                name=f"checkpoint-{step}")
            self._thread.start()
        meta = {
            "step": step,
            "time": time.strftime("%Y-%m-%d %H:%M:%S"),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            "tag": tag,
            "is_best": is_best,
        }
        if data_state is not None:
            meta["data_state"] = data_state
        if fit_state is not None:
            meta["fit_state"] = fit_state
        if self.cfg is not None:
            meta["config"] = to_dict(self.cfg)
        _write_json(self.dir / f"meta_{step}.json", meta)
        if is_best:
            _write_json(self.dir / "best.json", meta)

    def _to_host(self, tree: Any) -> Any:
        """A host copy of ``tree``: CUDA tensors into pinned buffers
        (asynchronous; the caller synchronizes), CPU tensors cloned."""
        def leaf(path: tuple[str, ...], x: Any) -> Any:
            if not isinstance(x, torch.Tensor):
                return x
            t = x.detach()
            if not t.is_cuda:
                return t.clone()
            key = "/".join(path)
            buf = self._pinned.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._pinned[key] = buf
            buf.copy_(t, non_blocking=True)
            return buf

        return tree_map_with_path(leaf, tree)

    def _write(self, step: int, host: dict[str, Any], copy_s: float) -> None:
        try:
            t0 = time.perf_counter()
            _write_dir(self.dir / str(step),
                       {PARAMS_FILE: host["params"],
                        TRAIN_FILE: {"step": step, "opt_state": host["opt_state"]}})
            write_s = time.perf_counter() - t0
            size = sum(f.stat().st_size for f in (self.dir / str(step)).iterdir())
            log.info("checkpoint step %d: %.3f GB, host copy %.3f s, write "
                     "%.3f s", step, size / 1e9, copy_s, write_s)
            for old in self.all_steps()[:-self.keep]:
                gone = self.dir / f"{_TMP}gone-{old}"
                os.rename(self.dir / str(old), gone)
                shutil.rmtree(gone)
        except BaseException as e:  # noqa: BLE001 — raised again by wait()
            self._error = e
        finally:
            self._pending = None

    def wait(self) -> None:
        """Blocks until the last save is on disk; raises its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Saved steps, ascending (a save still being written included)."""
        steps = {int(p.name) for p in self.dir.iterdir()
                 if p.name.isdigit() and p.is_dir()}
        if self._pending is not None:
            steps.add(self._pending)
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_meta(self, step: int) -> dict[str, Any] | None:
        path = self.dir / f"meta_{step}.json"
        if not path.exists():
            return None
        with open(path) as fh:
            return json.load(fh)

    def restore(self, state_like: TrainState,
                step: int | None = None) -> TrainState:
        """Loads ``step`` (the newest by default) into ``state_like``, in
        place, after checking every key path, shape and dtype; returns it."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None or not (self.dir / str(step)).is_dir():
            raise FileNotFoundError(f"no checkpoint of step {step} in {self.dir}")
        t0 = time.perf_counter()
        d = self.dir / str(step)
        train = _load_file(d / TRAIN_FILE)
        state_like.load_state_dict({"step": train["step"],
                                    "params": _load_file(d / PARAMS_FILE),
                                    "opt_state": train["opt_state"]})
        if any(t.is_cuda for t in path_leaves(state_like.params).values()):
            torch.cuda.synchronize()
        log.info("restored step %d from %s in %.3f s", step, d,
                 time.perf_counter() - t0)
        return state_like

    def close(self) -> None:
        self.wait()
        self._pinned.clear()


def export_params(params: Any, path: str | Path) -> None:
    """A params-only export (serving, decode, averaging): ``path/params.pt``."""
    path = Path(path).absolute()
    if path.exists():
        raise FileExistsError(f"{path} exists")
    path.parent.mkdir(parents=True, exist_ok=True)
    host = tree_map_with_path(lambda _, t: t.detach().cpu(), params)
    _write_dir(path, {PARAMS_FILE: host})


def load_params(path: str | Path, params_like: Any = None) -> Any:
    """The params of an export or of a checkpoint's step directory. With
    ``params_like``, the key paths and shapes must match it; floating
    leaves take its dtypes (integer ones must already have them) and every
    leaf its device."""
    params = _load_file(Path(path) / PARAMS_FILE)
    if params_like is None:
        return params
    check_like(params, params_like, what=str(path), dtype=False)
    got = path_leaves(params)

    def take(p: tuple[str, ...], like: torch.Tensor) -> torch.Tensor:
        t = got["/".join(p)]
        if t.dtype != like.dtype and not (t.is_floating_point()
                                          and like.is_floating_point()):
            raise ValueError(f"{path}: {'/'.join(p)} is {t.dtype}, expected {like.dtype}")
        return t.to(device=like.device, dtype=like.dtype, copy=True)

    return tree_map_with_path(take, params_like)
