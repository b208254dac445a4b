"""A JAX run's train state, read into plain numpy, in the port's checkpoint
layout.

The JAX package checkpoints through Orbax (``avsr_tpu/train/checkpoint.py``):
a ``CheckpointManager`` directory of ``{step}/state/`` trees, each holding
``{step, params, opt_state}``, beside ``meta_{step}.json`` and ``best.json``,
and params-only exports. Orbax needs JAX, and its data files are zstd
frames, which Python's standard library cannot read; so the read runs where
JAX runs (``tools/orbax_to_port.py``) and hands over numpy. Everything after
that lives here and runs on any host, the card's included: the mapping of
optax's state onto the port's optimizers (``train/state.py``), the checks
against the config, and the writer of the port's layout
(``train/checkpoint.py``), which ``CheckpointManager.restore``,
``Trainer.maybe_resume`` and every CLI's ``--checkpoint`` then read.

One step of a JAX train state, as this module takes it:

  step       int (the train steps taken, skipped ones included)
  params     the JAX parameter tree: nested dicts and lists whose leaves are
             numpy arrays (bfloat16 through ``ml_dtypes``)
  opt_state  optax's state, every named tuple as {"_type": <class name>,
             <field>: ...}, every tuple as a list, None where optax holds an
             empty node (the frozen leaves' places in a moment tree)

``training.optimizer`` and the optax chain that ``create_optimizer`` builds
for it (``clip_by_global_norm`` first, an ``EmptyState``):

  adamw      ScaleByAdamState(count, mu, nu), MaskedState(EmptyState),
             ScaleByScheduleState(count)
             -> {"count", "leaves": {name: {"step", "exp_avg", "exp_avg_sq"}}}
                (``step`` is the per-leaf float count of torch's AdamW)
  lion       ScaleByLionState(count, mu), MaskedState(EmptyState),
             ScaleByScheduleState(count)
             -> {"count", "leaves": {name: {"mu"}}}
  adafactor  FactoredState(count, v_row, v_col, v), ScaleByScheduleState
             (count), and EmptyState / MaskedState(EmptyState) for the
             stateless transforms; the side a leaf does not use is a (1,)
             placeholder
             -> {"count", "leaves": {name: {"v"} or {"v_row", "v_col"}}}

``count`` is the schedule's count of applied updates; it must equal the
rule's own count and be at most ``step``. Leaf names are the port's key
paths of the trainable partition (``partition_trainable``). A key path, a
shape, a dtype or an optimizer that does not match the config raises a
``ValueError`` that names the leaf; nothing is re-initialised. A QLoRA
run's integer base leaves (the JAX packing, which the port shares) are
carried as they are.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core.config import AVSRConfig
from avsr_tpu_torch.ops.quant import quantize_llm
from avsr_tpu_torch.train.checkpoint import (PARAMS_FILE, TRAIN_FILE, _write_dir,
                                             export_params)
from avsr_tpu_torch.train.state import (factored_dims, partition_trainable,
                                        path_leaves, tree_map_with_path)

# optax's state of each update rule, by training.optimizer
RULE_STATES = {"adamw": "ScaleByAdamState", "lion": "ScaleByLionState",
               "adafactor": "FactoredState"}
# the chain's stateless and schedule nodes
OTHER_STATES = ("EmptyState", "MaskedState", "ScaleByScheduleState")


def like_params(cfg: AVSRConfig) -> Any:
    """The parameter tree a run of ``cfg`` trains, as fake tensors (shapes
    and dtypes, no storage): the init in ``runtime.param_dtype``, the LLM's
    projections quantized when ``model.use_4bit``/``use_8bit`` asks,
    frozen leaves in ``runtime.compute_dtype`` and trainable ones in f32,
    as ``cli/common.py::init_or_load_params`` builds it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.train.state import cast_frozen

    m = cfg.model
    bits = 4 if m.use_4bit else 8 if m.use_8bit else 0
    with FakeTensorMode():
        params = init_avsr_model(m, device="cpu",
                                 dtype=getattr(torch, cfg.runtime.param_dtype))
        if bits:
            params = {**params, "llm": quantize_llm(params["llm"], bits)}
        return cast_frozen(params, m, getattr(torch, cfg.runtime.compute_dtype))


def _check_paths(got: dict[str, Any], want: dict[str, Any], what: str) -> None:
    if got.keys() != want.keys():
        missing = sorted(want.keys() - got.keys())[:5]
        extra = sorted(got.keys() - want.keys())[:5]
        raise ValueError(f"{what}: the key paths differ from the config's "
                         f"(missing {missing}, unexpected {extra})")


def _check_leaf(name: str, t: torch.Tensor, shape: tuple[int, ...],
                dtype: torch.dtype, what: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, the "
                         f"config's is {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: {name} is {t.dtype}, the config's is {dtype}")


def import_params(tree: Any, like: Any, what: str = "params") -> Any:
    """``tree`` (numpy leaves) as the port's tree of CPU tensors, after
    checking every key path, shape and dtype against ``like``."""
    got = path_leaves(tree)
    want = path_leaves(like)
    _check_paths(got, want, what)

    def leaf(path: tuple[str, ...], x: Any) -> Any:
        if x is None:
            return None
        name = "/".join(path)
        t = from_numpy_tree(x, "cpu")
        _check_leaf(name, t, tuple(want[name].shape), want[name].dtype, what)
        return t

    return tree_map_with_path(leaf, tree)


def _typed_nodes(node: Any) -> list[dict[str, Any]]:
    """Every named-tuple node of an optax chain's state, in order (the
    moment trees inside a node are not walked)."""
    if isinstance(node, (list, tuple)):
        return [n for x in node for n in _typed_nodes(x)]
    if isinstance(node, dict) and "_type" in node:
        inner = [n for k, v in node.items() if k != "_type"
                 and (isinstance(v, (list, tuple))
                      or (isinstance(v, dict) and "_type" in v))
                 for n in _typed_nodes(v)]
        return [node, *inner]
    if node is None:
        return []
    raise ValueError(f"opt_state: unexpected node {type(node).__name__} in "
                     "optax's chain")


def _count(x: Any, what: str) -> int:
    arr = np.asarray(x)
    if arr.size != 1 or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"{what} is not an integer scalar ({arr.dtype}, "
                         f"shape {arr.shape})")
    return int(arr.reshape(()))


def _state_tree(rule: dict[str, Any], field: str, names: dict[str, Any],
                optimizer: str) -> dict[str, torch.Tensor]:
    """{name: tensor} of one moment tree of the rule's state."""
    if field not in rule:
        raise ValueError(f"opt_state: {rule['_type']} has no field {field!r}")
    got = {k: from_numpy_tree(v, "cpu") for k, v in path_leaves(rule[field]).items()}
    _check_paths(got, names, f"opt_state {optimizer} {field}")
    return got


def import_opt_state(opt_state: Any, cfg: AVSRConfig, train_like: Any,
                     step: int) -> dict[str, Any]:
    """optax's state of ``training.optimizer`` (see the module docstring)
    as the port optimizer's state dict over the trainable partition
    ``train_like`` (the train side of ``partition_trainable``)."""
    opt = cfg.training.optimizer
    if opt not in RULE_STATES:
        raise ValueError(f"training.optimizer {opt!r} has no optax mapping")
    nodes = _typed_nodes(opt_state)
    kinds = [n["_type"] for n in nodes]
    for k in kinds:
        if k not in OTHER_STATES and k not in RULE_STATES.values():
            raise ValueError(f"opt_state: optax state {k} is not in the chain "
                             f"of training.optimizer={opt!r}")
    rules = [n for n in nodes if n["_type"] in RULE_STATES.values()]
    if len(rules) != 1 or rules[0]["_type"] != RULE_STATES[opt]:
        found = [n["_type"] for n in rules]
        raise ValueError(f"opt_state holds {found}, the config's "
                         f"training.optimizer={opt!r} keeps {RULE_STATES[opt]}")
    rule = rules[0]
    sched = [n for n in nodes if n["_type"] == "ScaleByScheduleState"]
    if len(sched) != 1:
        raise ValueError(f"opt_state: {len(sched)} ScaleByScheduleState nodes, "
                         "expected 1")
    count = _count(sched[0]["count"], "opt_state ScaleByScheduleState.count")
    own = _count(rule["count"], f"opt_state {rule['_type']}.count")
    if own != count:
        raise ValueError(f"opt_state: {rule['_type']}.count {own} differs from "
                         f"the schedule's count {count}")
    if not 0 <= count <= step:
        raise ValueError(f"opt_state: count {count} is not within the run's "
                         f"{step} steps")
    names = path_leaves(train_like)
    leaves: dict[str, dict[str, torch.Tensor]] = {}
    if opt == "adamw":
        mu, nu = (_state_tree(rule, f, names, opt) for f in ("mu", "nu"))
        for n, p in names.items():
            for key, t in (("mu", mu[n]), ("nu", nu[n])):
                _check_leaf(n, t, tuple(p.shape), torch.float32,
                            f"opt_state adamw {key}")
            leaves[n] = {"step": torch.tensor(float(count)), "exp_avg": mu[n],
                         "exp_avg_sq": nu[n]}
    elif opt == "lion":
        mu = _state_tree(rule, "mu", names, opt)
        for n, p in names.items():
            _check_leaf(n, mu[n], tuple(p.shape), torch.float32, "opt_state lion mu")
            leaves[n] = {"mu": mu[n]}
    else:
        vs = {f: _state_tree(rule, f, names, opt) for f in ("v_row", "v_col", "v")}
        for n, p in names.items():
            shape = tuple(p.shape)
            dims = factored_dims(shape)
            if dims is None:
                want = {"v": shape, "v_row": (1,), "v_col": (1,)}
            else:
                d1, d0 = dims
                want = {"v_row": tuple(s for i, s in enumerate(shape) if i != d0),
                        "v_col": tuple(s for i, s in enumerate(shape) if i != d1),
                        "v": (1,)}
            for f, s in want.items():
                _check_leaf(n, vs[f][n], s, torch.float32, f"opt_state adafactor {f}")
            keep = ("v",) if dims is None else ("v_row", "v_col")
            leaves[n] = {f: vs[f][n] for f in keep}
    return {"count": count, "leaves": leaves}


def import_state(state: dict[str, Any], cfg: AVSRConfig) -> dict[str, Any]:
    """One step of a JAX train state (numpy; see the module docstring) as
    the port's ``TrainState.state_dict`` of CPU tensors, checked against
    ``cfg``."""
    like = like_params(cfg)
    step = _count(state["step"], "step")
    params = import_params(state["params"], like)
    train_like, _ = partition_trainable(like, cfg.model)
    return {"step": step, "params": params,
            "opt_state": import_opt_state(state["opt_state"], cfg, train_like, step)}


def write_step(directory: str | Path, sd: dict[str, Any]) -> Path:
    """Writes a state dict of :func:`import_state` as the step directory
    ``{step}/params.pt`` + ``{step}/train.pt`` of the port's checkpoint
    directory ``directory`` (which must not hold that step yet)."""
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    target = directory / str(sd["step"])
    if target.exists():
        raise FileExistsError(f"{target} exists")
    _write_dir(target, {PARAMS_FILE: sd["params"],
                        TRAIN_FILE: {"step": sd["step"], "opt_state": sd["opt_state"]}})
    return target


def copy_meta(src: str | Path, dst: str | Path) -> list[str]:
    """Copies the JAX run's ``meta_*.json`` and ``best.json`` as they are
    (``data_state``, ``fit_state`` and ``config`` included); returns their
    names."""
    src, dst = Path(src), Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    names = sorted(p.name for p in src.glob("meta_*.json"))
    names += ["best.json"] if (src / "best.json").exists() else []
    for name in names:
        shutil.copyfile(src / name, dst / name)
    return names


def import_export(params: Any, cfg: AVSRConfig, path: str | Path) -> None:
    """A JAX params-only export, as the JAX package's ``init_or_load_params``
    reads it for ``cfg`` (numpy), as the port's export at ``path``
    (``export_params``), after checking it against ``cfg``'s tree."""
    export_params(import_params(params, like_params(cfg), what="export"), path)
