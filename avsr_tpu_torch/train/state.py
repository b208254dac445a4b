"""Train state, trainable-parameter selection, schedules and the optimizer,
the port of ``avsr_tpu/train/state.py``.

Parameters are the port's nested dicts/lists of tensors, with the JAX
package's key paths, so the masks here are the JAX masks leaf for leaf.
Freezing is structural, as there: trainable leaves are f32 tensors with
``requires_grad`` and the only ones the optimizer sees; frozen leaves are
stored in the compute dtype and never get a gradient.

The update is optax's ``chain(clip_by_global_norm(max_norm),
adamw(schedule, b1, b2, weight_decay, mask=decay_mask))``: the clip scales
by max_norm / ||g|| only when ||g|| > max_norm (``clip_grad_norm_`` would
add 1e-6 to the norm), and the schedule and Adam's bias correction count
applied updates, so a skipped step moves neither.

A train state goes to a checkpoint and back through its state dict
(:meth:`TrainState.state_dict`, :meth:`TrainState.load_state_dict`): the
step, the parameters, the optimizer's count and AdamW's per-leaf moments.
Loading checks every key path, shape and dtype before it writes anything,
and copies into the live tensors, which the optimizer holds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from avsr_tpu_torch.core.config import AVSRConfig, ModelConfig, TrainingConfig
from avsr_tpu_torch.models.layers import Params

ENCODERS = ("whisper", "hubert", "wav2vec2", "clip", "resnet", "efficientnet",
            "avhubert")


# ---------------------------------------------------------------------------
# Trees by key path
# ---------------------------------------------------------------------------

def tree_map_with_path(fn: Callable[[tuple[str, ...], Any], Any], tree: Any,
                       path: tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts/lists; list indices become
    their decimal strings in the path, as JAX's key paths give them."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves(tree: Any) -> list[Any]:
    """Leaves in key order, None positions dropped."""
    out: list[Any] = []
    tree_map_with_path(lambda _, x: out.append(x) if x is not None else None, tree)
    return out


def path_leaves(tree: Any) -> dict[str, Any]:
    """{"a/b/0/c": leaf} of a tree, None positions dropped."""
    out: dict[str, Any] = {}
    tree_map_with_path(
        lambda p, x: out.__setitem__("/".join(p), x) if x is not None else None,
        tree)
    return out


def check_like(tree: Any, like: Any, *, what: str, dtype: bool = True) -> None:
    """Raise ``ValueError`` unless ``tree`` has exactly the key paths of
    ``like``, with the same shape at each (and the same dtype, when
    ``dtype``)."""
    got, want = path_leaves(tree), path_leaves(like)
    if got.keys() != want.keys():
        missing = sorted(want.keys() - got.keys())[:5]
        extra = sorted(got.keys() - want.keys())[:5]
        raise ValueError(f"{what}: key paths differ (missing {missing}, "
                         f"unexpected {extra})")
    for k, w in want.items():
        g = got[k]
        if not isinstance(g, torch.Tensor) or g.shape != w.shape:
            raise ValueError(f"{what}: {k} has shape "
                             f"{tuple(getattr(g, 'shape', ()))}, expected "
                             f"{tuple(w.shape)}")
        if dtype and g.dtype != w.dtype:
            raise ValueError(f"{what}: {k} is {g.dtype}, expected {w.dtype}")


def trainable_mask(params: Params, cfg: ModelConfig) -> Params:
    """True where the leaf is trained (the JAX package's rule)."""
    def rule(keys: tuple[str, ...], leaf) -> bool:
        del leaf
        top = keys[0]
        if top in ("audio_connector", "video_connector", "connector"):
            return True
        if top in ENCODERS:
            # BatchNorm running statistics are data, not weights
            if keys[-1] in ("mean", "var"):
                return False
            if not cfg.freeze_encoders:
                return True
            if (top == "avhubert" and cfg.finetune_avhubert_layers
                    and len(keys) >= 3 and keys[1] == "blocks"
                    and keys[2].isdigit()
                    and int(keys[2]) in cfg.finetune_avhubert_layers):
                return True
            if cfg.unfreeze_layer_norms and len(keys) >= 2:
                parent = keys[-2]
                if parent.startswith("ln") or parent in ("norm", "proj_ln"):
                    return True
            return False
        if top == "llm":
            if "lora" in keys:
                return cfg.lora.use_lora
            return not cfg.freeze_llm
        return True

    return tree_map_with_path(rule, params)


def partition_trainable(params: Params, cfg: ModelConfig) -> tuple[Params, Params]:
    """(trainable, frozen) trees; each holds None where the other has a leaf.
    Recombine with :func:`combine_trainable`."""
    mask = trainable_mask(params, cfg)
    train = _zip_map(lambda p, m: p if m else None, params, mask)
    frozen = _zip_map(lambda p, m: None if m else p, params, mask)
    return train, frozen


def combine_trainable(train: Params, frozen: Params) -> Params:
    return _zip_map(lambda a, b: b if a is None else a, train, frozen)


def _zip_map(fn, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def decay_mask(params: Params) -> Params:
    """Weight decay only on dense kernels, the leaves named ``w``."""
    return tree_map_with_path(lambda keys, _: bool(keys) and keys[-1] == "w",
                              params)


def cast_frozen(params: Params, cfg: ModelConfig,
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """Frozen floating leaves in ``dtype`` (they are only read, so no f32
    master is needed: half the memory and weight bandwidth), trainable
    leaves in f32."""
    def cast(p: torch.Tensor, trainable: bool) -> torch.Tensor:
        if not p.is_floating_point():
            return p
        return p.to(torch.float32 if trainable else dtype)

    return _zip_map(cast, params, trainable_mask(params, cfg))


def count_trainable(params: Params, cfg: ModelConfig) -> tuple[int, int]:
    """(trainable, total) parameter counts."""
    leaves = tree_leaves(params)
    masks = tree_leaves(trainable_mask(params, cfg))
    total = sum(p.numel() for p in leaves)
    return sum(p.numel() for p, m in zip(leaves, masks) if m), total


# ---------------------------------------------------------------------------
# Schedules: optax's formulas, learning rate as a function of the number of
# updates applied so far
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init

    def sched(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return sched


def _join(first: Callable[[int], float], second: Callable[[int], float],
          boundary: int) -> Callable[[int], float]:
    """optax.join_schedules of two schedules."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def cosine_schedule(cfg: TrainingConfig, total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total, lr / 100)."""
    peak = cfg.learning_rate
    warm = max(cfg.warmup_steps, 1)
    decay = max(total_steps, cfg.warmup_steps + 1) - warm
    alpha = 0.0 if peak == 0.0 else peak * 0.01 / peak   # end / peak, as optax
    if decay <= 0:
        raise ValueError(f"cosine schedule needs decay steps > 0, got {decay}")

    def cosine(count: int) -> float:
        c = min(count, decay)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay))
                       + alpha)
    return _join(_linear(0.0, peak, warm), cosine, warm)


def linear_schedule(cfg: TrainingConfig, total_steps: int) -> Callable[[int], float]:
    warm = max(cfg.warmup_steps, 1)
    return _join(_linear(0.0, cfg.learning_rate, warm),
                 _linear(cfg.learning_rate, 0.0,
                         max(total_steps - cfg.warmup_steps, 1)), warm)


def constant_schedule(cfg: TrainingConfig, total_steps: int) -> Callable[[int], float]:
    del total_steps
    warm = max(cfg.warmup_steps, 1)
    return _join(_linear(0.0, cfg.learning_rate, warm),
                 lambda count: cfg.learning_rate, warm)


SCHEDULES = {"cosine": cosine_schedule, "linear": linear_schedule,
             "constant": constant_schedule}


# ---------------------------------------------------------------------------
# Optimizer and state
# ---------------------------------------------------------------------------

class ClippedAdamW:
    """Global-norm clip, then AdamW with decay groups and a schedule.

    ``count`` is the number of updates applied: the learning rate of the
    next update is ``schedule(count)`` and Adam's bias correction uses
    ``count + 1`` (``torch.optim.AdamW`` keeps the latter per parameter and
    advances it only when it steps)."""

    def __init__(self, leaves: list[torch.Tensor], names: list[str],
                 decay: list[bool], schedule: Callable[[int], float],
                 cfg: TrainingConfig):
        groups = [{"params": [p for p, d in zip(leaves, decay) if d],
                   "weight_decay": cfg.weight_decay},
                  {"params": [p for p, d in zip(leaves, decay) if not d],
                   "weight_decay": 0.0}]
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]],
                                     lr=0.0, betas=(cfg.adam_b1, cfg.adam_b2),
                                     eps=1e-8)
        self.leaves = leaves
        self.names = names          # the leaves' key paths, in the state dict
        self.schedule = schedule
        self.max_norm = cfg.max_grad_norm
        self.count = 0

    def update(self, grads: list[torch.Tensor], grad_norm: torch.Tensor) -> None:
        """Apply one update from f32 ``grads`` (one per leaf) whose global
        norm is ``grad_norm``, in place."""
        clip = grad_norm >= self.max_norm
        for p, g in zip(self.leaves, grads):
            p.grad = torch.where(clip, g / grad_norm * self.max_norm, g)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict[str, Any]:
        """{"count", "leaves": {name: {"step", "exp_avg", "exp_avg_sq"}}},
        the live tensors; a leaf not yet updated gets zero moments at step
        0, which AdamW treats as a fresh state."""
        leaves = {}
        for name, p in zip(self.names, self.leaves):
            st = self.opt.state.get(p) or {}
            zeros = torch.zeros_like(p, memory_format=torch.preserve_format)
            leaves[name] = {"step": st.get("step", torch.tensor(0.0)),
                            "exp_avg": st.get("exp_avg", zeros),
                            "exp_avg_sq": st.get("exp_avg_sq", zeros)}
        return {"count": self.count, "leaves": leaves}

    def check_state_dict(self, sd: dict[str, Any]) -> None:
        like = {name: {"exp_avg": p, "exp_avg_sq": p}
                for name, p in zip(self.names, self.leaves)}
        moments = {name: {k: v[k] for k in ("exp_avg", "exp_avg_sq")}
                   for name, v in sd["leaves"].items()}
        check_like(moments, like, what="optimizer state")
        for name, v in sd["leaves"].items():
            if not isinstance(v["step"], torch.Tensor) or v["step"].dim():
                raise ValueError(f"optimizer state: {name}/step is not a scalar tensor")

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        """Loads what :meth:`state_dict` gave (checked first)."""
        self.check_state_dict(sd)
        index = {}
        for group in self.opt.param_groups:
            for p in group["params"]:
                index[id(p)] = len(index)
        torch_sd = self.opt.state_dict()
        torch_sd["state"] = {
            index[id(p)]: {k: v.detach().clone() for k, v in sd["leaves"][name].items()}
            for name, p in zip(self.names, self.leaves)}
        self.opt.load_state_dict(torch_sd)
        self.count = int(sd["count"])


@dataclass
class TrainState:
    step: int                   # train steps taken, skipped ones included
    params: Params              # updated in place
    optimizer: ClippedAdamW

    def state_dict(self) -> dict[str, Any]:
        """{"step", "params", "opt_state"}: the live tensors (copy them
        before the next update changes them)."""
        return {"step": self.step, "params": self.params,
                "opt_state": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        """Checks every key path, shape and dtype of ``sd`` against this
        state, then copies the values into the live tensors, in place."""
        check_like(sd["params"], self.params, what="params")
        self.optimizer.check_state_dict(sd["opt_state"])
        live = path_leaves(self.params)
        with torch.no_grad():
            for k, v in path_leaves(sd["params"]).items():
                live[k].copy_(v)
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


def create_optimizer(cfg: AVSRConfig, train_params: Params,
                     total_steps: int) -> ClippedAdamW:
    """The optimizer over the trainable partition only (the train side of
    :func:`partition_trainable`)."""
    t = cfg.training
    if t.optimizer != "adamw":
        raise NotImplementedError(f"training.optimizer={t.optimizer!r} is not yet ported")
    if t.schedule not in SCHEDULES:
        raise ValueError(f"training.schedule must be one of {tuple(SCHEDULES)}, "
                         f"got {t.schedule!r}")
    named = path_leaves(train_params)
    decay = tree_leaves(_zip_map(lambda p, d: None if p is None else d,
                                 train_params, decay_mask(train_params)))
    return ClippedAdamW(list(named.values()), list(named), decay,
                        SCHEDULES[t.schedule](t, total_steps), t)


def create_train_state(params: Params, cfg: AVSRConfig,
                       total_steps: int) -> TrainState:
    """Marks the trainable leaves ``requires_grad`` and builds the
    optimizer over them. Trainable leaves must be f32 (:func:`cast_frozen`)."""
    train, _ = partition_trainable(params, cfg.model)
    for p in tree_leaves(train):
        if p.dtype != torch.float32:
            raise TypeError("trainable leaves must be float32 masters; "
                            "apply cast_frozen first")
        p.requires_grad_(True)
    return TrainState(0, params, create_optimizer(cfg, train, total_steps))
