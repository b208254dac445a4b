"""Train state, trainable-parameter selection, schedules and the optimizer,
the port of ``avsr_tpu/train/state.py``.

Parameters are the port's nested dicts/lists of tensors, with the JAX
package's key paths, so the masks here are the JAX masks leaf for leaf.
Freezing is structural, as there: trainable leaves are f32 tensors with
``requires_grad`` and the only ones the optimizer sees; frozen leaves are
stored in the compute dtype and never get a gradient.

The update is optax's ``chain(clip_by_global_norm(max_norm), rule)`` with
the rule of ``training.optimizer`` as the JAX package builds it: adamw,
adafactor or lion, each with the schedule and the decay mask. The clip
scales by max_norm / ||g|| only when ||g|| >= max_norm, and the schedule
and the rules' step counts count applied updates, so a skipped step moves
none of them.

A train state goes to a checkpoint and back through its state dict
(:meth:`TrainState.state_dict`, :meth:`TrainState.load_state_dict`): the
step, the parameters, the optimizer's count and its per-leaf state (AdamW's
moments, adafactor's factored or full second moment, lion's momentum).
Loading checks every key path, shape and dtype before it writes anything,
and copies into the live tensors, which the optimizer holds.

Under fsdp or tp (``mesh/sharding.py``) a sharded trained leaf holds its slice,
and so does its optimizer state: AdamW's moments and lion's momentum
slice as the leaf does, and adafactor's factored moments hold the slice
when they keep the sharded dimension (a moment that averages over it is
whole, and the average is taken over every rank's slice). Adafactor's
factoring, its update clip and its parameter scale use the full leaf's
shape and norms, so the update is the one-card update's slice. The state
dict's tensors are tagged with their slices (for a checkpoint to gather),
and loading takes full tensors and keeps this rank's slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from avsr_tpu_torch.core.config import AVSRConfig, ModelConfig, TrainingConfig
from avsr_tpu_torch.mesh.sharding import (Shard, full_shape, is_sharded, local_part,
                                          shards_of, tag)
from avsr_tpu_torch.models.avsr import ENCODER_KEYS
from avsr_tpu_torch.models.layers import Params



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
        if top in ENCODER_KEYS:
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

class ClippedOptimizer:
    """Global-norm clip, then an update rule with a schedule: optax's
    ``chain(clip_by_global_norm(max_norm), rule)``. Subclasses give the rule
    (:meth:`_apply`) and its per-leaf state.

    ``count`` is the number of updates applied: the learning rate of the
    next update is ``schedule(count)``, and the rules' own step counts
    (Adam's bias correction, adafactor's decay) are ``count + 1``."""

    def __init__(self, leaves: list[torch.Tensor], names: list[str],
                 decay: list[bool], schedule: Callable[[int], float],
                 cfg: TrainingConfig):
        self.leaves = leaves
        self.names = names          # the leaves' key paths, in the state dict
        self.decay = decay          # weight decay on this leaf
        self.schedule = schedule
        self.max_norm = cfg.max_grad_norm
        self.count = 0
        self.shards = [shards_of(p) for p in leaves]   # fsdp and tp slices, or ()

    def update(self, grads: list[torch.Tensor], grad_norm: torch.Tensor) -> None:
        """Apply one update from f32 ``grads`` (one per leaf) whose global
        norm is ``grad_norm``, in place."""
        clip = grad_norm >= self.max_norm
        grads = [torch.where(clip, g / grad_norm * self.max_norm, g) for g in grads]
        with torch.no_grad():
            self._apply(grads, self.schedule(self.count))
        self.count += 1

    def _apply(self, grads: list[torch.Tensor], lr: float) -> None:
        raise NotImplementedError

    # The state of the rules written here: {name: {key: tensor}}, made at
    # construction, updated in place.
    state: dict[str, dict[str, torch.Tensor]]

    def state_dict(self) -> dict[str, Any]:
        """{"count", "leaves": {name: {key: tensor}}}, the live tensors."""
        return {"count": self.count, "leaves": self.state}

    def _state_shard(self, i: int, key: str, t: torch.Tensor) -> tuple[Shard, ...]:
        """The slices that the state tensor ``key`` of leaf ``i`` holds: the
        leaf's own for a tensor of the leaf's shape."""
        return self.shards[i] if t.shape == self.leaves[i].shape else ()

    def tag_state(self, sd: dict[str, Any]) -> dict[str, Any]:
        """``sd`` (this optimizer's state dict) with its sharded tensors
        tagged with their slices."""
        for i, name in enumerate(self.names):
            for key, t in sd["leaves"][name].items():
                tag(t, self._state_shard(i, key, t))
        return sd

    def check_state_dict(self, sd: dict[str, Any]) -> None:
        check_like(sd["leaves"], self.state, what="optimizer state")

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        """Loads what :meth:`state_dict` gave (checked first), in place."""
        self.check_state_dict(sd)
        live = path_leaves(self.state)
        with torch.no_grad():
            for k, v in path_leaves(sd["leaves"]).items():
                live[k].copy_(v)
        self.count = int(sd["count"])


class ClippedAdamW(ClippedOptimizer):
    """optax.adamw(schedule, b1, b2, eps 1e-8, weight_decay, mask) after the
    clip, through ``torch.optim.AdamW`` with one group for the decayed
    leaves and one without (the clip scales by max_norm / ||g|| only when
    ||g|| >= max_norm; ``clip_grad_norm_`` would add 1e-6 to the norm).
    Its bias correction counts applied updates: ``torch.optim.AdamW`` keeps
    the count per parameter and advances it only when it steps."""

    def __init__(self, leaves, names, decay, schedule, cfg: TrainingConfig):
        super().__init__(leaves, names, decay, schedule, cfg)
        groups = [{"params": [p for p, d in zip(leaves, decay) if d],
                   "weight_decay": cfg.weight_decay},
                  {"params": [p for p, d in zip(leaves, decay) if not d],
                   "weight_decay": 0.0}]
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]],
                                     lr=0.0, betas=(cfg.adam_b1, cfg.adam_b2),
                                     eps=1e-8)

    def _apply(self, grads: list[torch.Tensor], lr: float) -> None:
        for p, g in zip(self.leaves, grads):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

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


def factored_dims(shape: tuple[int, ...], min_dim: int = 128
                  ) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest axis (ties by index, as a stable argsort gives them), when the
    second largest has at least ``min_dim`` entries; else None."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim:
        return None
    return order[-2], order[-1]


def _rms(x: torch.Tensor, shards: tuple[Shard, ...] = ()) -> torch.Tensor:
    """The root mean square of a leaf, or with ``shards`` of the full leaf
    whose slice ``x`` is."""
    if not shards:
        return torch.sqrt(torch.mean(x * x))
    total, n = (x * x).sum(), x.numel()
    for s in shards:
        total, n = s.group.all_reduce(total), n * s.group.size
    return torch.sqrt(total / n)


def _mean(x: torch.Tensor, dim: int, shards: tuple[Shard, ...],
          keepdim: bool = False) -> torch.Tensor:
    """The mean of ``x`` over ``dim``; over every rank's slice when ``x``
    holds a slice of ``dim`` (one of ``shards``)."""
    s = next((s for s in shards if s.dim == dim), None)
    if s is None:
        return x.mean(dim=dim, keepdim=keepdim)
    return s.group.all_reduce(x.sum(dim=dim, keepdim=keepdim)) / s.full


class ClippedAdafactor(ClippedOptimizer):
    """optax.adafactor(schedule, weight_decay_rate=weight_decay or None,
    weight_decay_mask=mask) after the clip, with optax's defaults: second
    moments factored into row and column means for a leaf whose second
    largest axis has >= 128 entries (else a full one), decay 1 - t^-0.8 at
    update t, eps 1e-30, the update clipped to block RMS 1, times the
    learning rate, times the leaf's RMS (at least 1e-3), plus
    weight_decay * p on the decayed leaves (not scaled by the learning
    rate, as in optax), no momentum. State per leaf: "v_row" and "v_col"
    (factored) or "v"."""

    EPS = 1e-30
    DECAY = 0.8
    CLIP = 1.0
    MIN_SCALE = 1e-3

    def __init__(self, leaves, names, decay, schedule, cfg: TrainingConfig):
        super().__init__(leaves, names, decay, schedule, cfg)
        self.weight_decay = cfg.weight_decay
        self.state = {}
        for name, p in zip(names, leaves):
            dims = factored_dims(tuple(full_shape(p)))
            if dims is None:
                self.state[name] = {"v": torch.zeros_like(p)}
            else:
                d1, d0 = dims
                self.state[name] = {
                    "v_row": torch.zeros_like(p.sum(dim=d0)),
                    "v_col": torch.zeros_like(p.sum(dim=d1))}

    def _state_shard(self, i: int, key: str, t: torch.Tensor) -> tuple[Shard, ...]:
        dims = factored_dims(tuple(full_shape(self.leaves[i])))
        if key == "v" or dims is None:
            return super()._state_shard(i, key, t)
        gone = dims[1] if key == "v_row" else dims[0]     # the averaged dim
        return tuple(s._replace(dim=s.dim - (s.dim > gone))
                     for s in self.shards[i] if s.dim != gone)

    def _apply(self, grads: list[torch.Tensor], lr: float) -> None:
        t = np.float32(self.count + 1)
        rate = np.float32(1.0) - t ** np.float32(-self.DECAY)
        keep, new = float(rate), float(np.float32(1.0) - rate)
        for i, (name, p, g, dec) in enumerate(zip(self.names, self.leaves, grads,
                                                  self.decay)):
            st = self.state[name]
            sh = self.shards[i]
            g2 = g * g + self.EPS
            dims = factored_dims(tuple(full_shape(p)))
            if dims is None:
                st["v"].mul_(keep).add_(new * g2)
                u = g * st["v"] ** -0.5
            else:
                d1, d0 = dims
                st["v_row"].copy_(keep * st["v_row"] + new * _mean(g2, d0, sh))
                st["v_col"].copy_(keep * st["v_col"] + new * _mean(g2, d1, sh))
                rd1 = d1 - 1 if d1 > d0 else d1
                row_sh = self._state_shard(i, "v_row", st["v_row"])
                row = (st["v_row"] / _mean(st["v_row"], rd1, row_sh, keepdim=True)) ** -0.5
                u = g * row.unsqueeze(d0) * (st["v_col"] ** -0.5).unsqueeze(d1)
            u = u / torch.clamp(_rms(u, sh) / self.CLIP, min=1.0)
            u = u * lr
            p_rms = _rms(p, sh)
            u = u * torch.where(p_rms <= self.MIN_SCALE, self.MIN_SCALE, p_rms)
            if dec and self.weight_decay:
                u = u + self.weight_decay * p
            p.sub_(u)


class ClippedLion(ClippedOptimizer):
    """optax.lion(schedule, b1=adam_b1, b2=0.99, weight_decay, mask) after
    the clip: u = sign((1 - b1) g + b1 m), then m = (1 - b2) g + b2 m,
    plus weight_decay * p on the decayed leaves, times the learning rate.
    State per leaf: "mu"."""

    B2 = 0.99

    def __init__(self, leaves, names, decay, schedule, cfg: TrainingConfig):
        super().__init__(leaves, names, decay, schedule, cfg)
        self.b1 = cfg.adam_b1
        self.weight_decay = cfg.weight_decay
        self.state = {name: {"mu": torch.zeros_like(p)}
                      for name, p in zip(names, leaves)}

    def _apply(self, grads: list[torch.Tensor], lr: float) -> None:
        for name, p, g, dec in zip(self.names, self.leaves, grads, self.decay):
            mu = self.state[name]["mu"]
            u = torch.sign((1.0 - self.b1) * g + self.b1 * mu)
            mu.copy_((1.0 - self.B2) * g + self.B2 * mu)
            if dec:
                u = u + self.weight_decay * p
            p.sub_(lr * u)


OPTIMIZERS = {"adamw": ClippedAdamW, "adafactor": ClippedAdafactor,
              "lion": ClippedLion}


@dataclass
class TrainState:
    step: int                   # train steps taken, skipped ones included
    params: Params              # updated in place
    optimizer: ClippedOptimizer

    def state_dict(self) -> dict[str, Any]:
        """{"step", "params", "opt_state"}: the live tensors (copy them
        before the next update changes them); sharded ones are tagged with
        their slices."""
        return {"step": self.step, "params": self.params,
                "opt_state": self.optimizer.tag_state(self.optimizer.state_dict())}

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        """Checks every key path, shape and dtype of ``sd`` against this
        state, then copies the values into the live tensors, in place. A
        sharded state takes full tensors and keeps its slices."""
        if is_sharded(self.params):
            live = self.state_dict()
            sd = {**sd, "params": _localize(sd["params"], live["params"]),
                  "opt_state": {**sd["opt_state"], "leaves": _localize(
                      sd["opt_state"]["leaves"], live["opt_state"]["leaves"])}}
        check_like(sd["params"], self.params, what="params")
        self.optimizer.check_state_dict(sd["opt_state"])
        live = path_leaves(self.params)
        with torch.no_grad():
            for k, v in path_leaves(sd["params"]).items():
                live[k].copy_(v)
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


def _localize(tree: Any, like: Any) -> Any:
    """``tree`` of full tensors with each leaf cut to the slice that the
    leaf of ``like`` at its path holds (checking the full shape first)."""
    want = path_leaves(like)

    def leaf(path: tuple[str, ...], x: Any) -> Any:
        k = "/".join(path)
        if k not in want or not isinstance(x, torch.Tensor):
            return x
        return local_part(x, want[k], what=k)

    return tree_map_with_path(leaf, tree)


def create_optimizer(cfg: AVSRConfig, train_params: Params,
                     total_steps: int) -> ClippedOptimizer:
    """The optimizer of ``training.optimizer`` over the trainable partition
    only (the train side of :func:`partition_trainable`)."""
    t = cfg.training
    if t.schedule not in SCHEDULES:
        raise ValueError(f"training.schedule must be one of {tuple(SCHEDULES)}, "
                         f"got {t.schedule!r}")
    named = path_leaves(train_params)
    decay = tree_leaves(_zip_map(lambda p, d: None if p is None else d,
                                 train_params, decay_mask(train_params)))
    return OPTIMIZERS[t.optimizer](list(named.values()), list(named), decay,
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
