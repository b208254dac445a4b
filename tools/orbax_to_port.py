"""Convert the JAX package's Orbax checkpoints into the PyTorch port's.

    python -m tools.orbax_to_port SRC DST [--step N | --all] [--config YAML]

SRC is one of the JAX package's two Orbax layouts
(``avsr_tpu/train/checkpoint.py``):

  * a Trainer's ``CheckpointManager`` directory (``{step}/state/`` beside
    ``meta_{step}.json`` and ``best.json``). Its newest step is converted
    (``--step N`` another retained step, ``--all`` every retained one) into
    DST as the port's ``{step}/params.pt`` and ``{step}/train.pt``, and the
    JSON files are copied as they are. The port's train CLI resumes from it
    (``training.checkpoint_dir`` whose ``ckpt/`` is DST, or
    ``training.resume_from=DST``) and every CLI reads it with
    ``--checkpoint DST``. The config is the one in ``meta_{step}.json``, or
    ``--config``.
  * a params-only export (``export_params``): DST becomes the port's export.
    It needs ``--config``.

A step is restored through the JAX package's own
``CheckpointManager.restore`` into the structure that
``create_train_state`` builds for the config, on one device, so a
checkpoint written sharded (fsdp over many devices) comes back whole; an
export is read by the JAX package's ``init_or_load_params``. An int4 run or
export written before JAX's half-split packing is repacked as JAX's
readers repack it. The state is
handed over as numpy to ``avsr_tpu_torch/train/import_state.py``, which maps
optax's state onto the port's optimizer, checks every leaf against the
config and writes the port's files.

This script imports JAX, Orbax and both packages, so it runs where JAX runs:
the host that wrote the checkpoint, or any host with JAX, Orbax and torch.
A host with only PyTorch (the H100's) cannot run it: Orbax's files are
zstd-compressed OCDBT, which needs Orbax to read. Convert there, copy DST.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any

import jax
import numpy as np

from avsr_tpu.cli.common import init_or_load_params
from avsr_tpu.core.config import load_config as jax_load_config
from avsr_tpu.ops.quant import legacy_int4_template, upgrade_legacy_int4
from avsr_tpu.train.checkpoint import CheckpointManager
from avsr_tpu.train.state import create_train_state
from avsr_tpu_torch.core.config import from_dict as port_from_dict
from avsr_tpu_torch.core.config import load_config as port_load_config
from avsr_tpu_torch.train.checkpoint import orbax_layout
from avsr_tpu_torch.train.import_state import (copy_meta, import_export,
                                               import_state, write_step)
from avsr_tpu_torch.train.state import path_leaves


def to_numpy(tree: Any) -> Any:
    """A restored JAX tree as plain numpy: named tuples become
    ``{"_type": class name, field: ...}``, tuples lists, arrays numpy."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"_type": type(tree).__name__,
                **{f: to_numpy(getattr(tree, f)) for f in tree._fields}}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if tree is None:
        return None
    return np.asarray(jax.device_get(tree))


def _on_one_device(abstract: Any) -> Any:
    """Shapes and dtypes placed whole on the first device: Orbax restores
    (and reshards a sharded checkpoint) to them."""
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    return jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=one), abstract)


def _configs(src: Path, step: int | None, config: str | None):
    """(JAX config, port config) from ``--config`` or the step's meta."""
    if config:
        return jax_load_config(config), port_load_config(config)
    meta = src / f"meta_{step}.json"
    if step is None or not meta.exists():
        raise SystemExit(f"{src}: no meta_{step}.json with a config; pass --config")
    tree = json.loads(meta.read_text()).get("config")
    if not tree:
        raise SystemExit(f"{meta} holds no config; pass --config")
    return jax_load_config(None, tree), port_from_dict(tree)


def _gb(path: Path) -> float:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e9


def _restore_step(mngr: CheckpointManager, jcfg, step: int):
    """The run's ``step`` restored into the state that ``create_train_state``
    builds for the config, on one device. An int4 run written before JAX's
    half-split packing restores into its old "qw4" structure and is repacked
    after, as ``init_or_load_params`` restores one."""
    def restore(template):
        like = _on_one_device(jax.eval_shape(lambda: create_train_state(
            template(init_or_load_params(jcfg)), jcfg, 1)[0]))
        return mngr.restore(like, step)

    try:
        return restore(lambda params: params)
    except Exception:  # noqa: BLE001 — Orbax's structure mismatch, as JAX's reader
        if not jcfg.model.use_4bit:
            raise
        state = restore(legacy_int4_template)
        return state._replace(params=upgrade_legacy_int4(state.params))


def convert_run(src: Path, dst: Path, steps: list[int] | None,
                config: str | None) -> list[dict]:
    """Every step of ``steps`` (the newest when None) of the JAX run
    ``src`` into the port's checkpoint directory ``dst``."""
    mngr = CheckpointManager(src)
    retained = mngr.all_steps()
    if not retained:
        raise SystemExit(f"{src}: no checkpoint steps")
    steps = steps or retained[-1:]
    missing = sorted(set(steps) - set(retained))
    if missing:
        raise SystemExit(f"{src}: steps {missing} not retained (have {retained})")
    out = []
    for step in steps:
        t0 = time.perf_counter()
        jcfg, tcfg = _configs(src, step, config)
        state = _restore_step(mngr, jcfg, step)
        sd = import_state({"step": int(state.step), "params": to_numpy(state.params),
                           "opt_state": to_numpy(state.opt_state)},
                          tcfg)
        del state
        target = write_step(dst, sd)
        out.append(dict(step=step, leaves=len(path_leaves(sd["params"])),
                        gb=_gb(target), seconds=time.perf_counter() - t0))
    mngr.close()
    copy_meta(src, dst)
    return out


def convert_export(src: Path, dst: Path, config: str) -> dict:
    """A JAX params export into the port's export ``dst``, read as the JAX
    package's ``init_or_load_params`` reads it (a quantized, full-precision
    or old-layout int4 export of a quantized config alike)."""
    t0 = time.perf_counter()
    jcfg, tcfg = _configs(src, None, config)
    tree = to_numpy(init_or_load_params(jcfg, str(src)))
    import_export(tree, tcfg, dst)
    return dict(step=None, leaves=len(path_leaves(tree)), gb=_gb(dst),
                seconds=time.perf_counter() - t0)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("src", help="the JAX run's CheckpointManager directory or an export")
    p.add_argument("dst", help="the port's checkpoint directory (or export) to write")
    which = p.add_mutually_exclusive_group()
    which.add_argument("--step", type=int, default=None, help="one retained step")
    which.add_argument("--all", action="store_true", help="every retained step")
    p.add_argument("--config", default=None,
                   help="the run's YAML (default: the config in meta_{step}.json)")
    args = p.parse_args(argv)
    src, dst = Path(args.src).absolute(), Path(args.dst).absolute()
    if not orbax_layout(src):
        raise SystemExit(f"{src} is not an Orbax directory of the JAX package")
    if dst.exists() and any(dst.iterdir()):
        raise SystemExit(f"{dst} is not empty")
    if (src / "state").is_dir():
        raise SystemExit(f"{src} is one step of a run: pass the run's directory "
                         f"{src.parent} and --step {src.name}")
    if (src / "_CHECKPOINT_METADATA").exists():       # an export
        if not args.config:
            raise SystemExit("an export carries no config: pass --config")
        rows = [convert_export(src, dst, args.config)]
    else:
        steps = (CheckpointManager(src).all_steps() if args.all
                 else [args.step] if args.step is not None else None)
        rows = convert_run(src, dst, steps, args.config)
    for r in rows:
        print(f"{'export' if r['step'] is None else 'step ' + str(r['step'])}: "
              f"{r['leaves']} leaves, {r['gb']:.3f} GB in {r['seconds']:.2f} s "
              f"({jax.devices()[0].platform}) -> {dst}")
    print(json.dumps({"converted": rows, "dst": str(dst)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
