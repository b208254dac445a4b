"""Train / eval steps with gradient accumulation and the non-finite skip,
the port of ``avsr_tpu/train/step.py``.

A step takes a batch whose leaves carry a leading [accum, micro, ...] axis
(``microbatch``), runs forward and backward per micro-batch, and averages
the f32 gradients of the trainable leaves over the micro-batches. If the
mean loss or the gradients' global norm is not finite, the parameters and
the optimizer are left as they were and only ``state.step`` advances, as
the JAX step's ``lax.cond`` does.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from avsr_tpu_torch.core.config import AVSRConfig
from avsr_tpu_torch.models.avsr import Batch, forward
from avsr_tpu_torch.train.state import TrainState


def _loss_fn(params, cfg: AVSRConfig, batch: Batch, dropout_seed: int | None):
    return forward(params, cfg.model, batch,
                   compute_dtype=getattr(torch, cfg.runtime.compute_dtype),
                   use_kernel=cfg.runtime.use_pallas, remat=cfg.mesh.remat,
                   dropout_seed=dropout_seed)


def micro_seeds(seed: int, n: int) -> list[int]:
    """One dropout seed per micro-batch of a step (the counterpart of
    ``jax.random.split(rng, accum)``)."""
    states = np.random.SeedSequence(seed).spawn(n)
    return [int(s.generate_state(1, np.uint64)[0]) for s in states]


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def make_train_step(cfg: AVSRConfig
                    ) -> Callable[..., dict[str, float]]:
    """``train_step(state, batch, seed) -> metrics`` updates ``state`` in
    place. ``batch`` leaves are [accum, micro, ...] and each micro-batch
    weighs 1 / accum; ``seed`` draws the step's dropout masks. The JAX step
    takes per-micro-batch weights so that it can pad a partial group to its
    compiled shape with zero-weight copies; eager PyTorch runs the partial
    group as it is, which gives the same update. Metrics: ``loss``,
    ``accuracy``, ``grad_norm``, ``skipped``.

    ``stats``, when given, accumulates the seconds spent in ``forward_s``,
    ``backward_s`` and ``optimizer_s`` (host clock, with a device
    synchronize at each boundary)."""

    def train_step(state: TrainState, batch: Batch, seed: int,
                   stats: dict | None = None) -> dict[str, float]:
        accum = next(x for x in batch if x is not None).shape[0]
        w = 1.0 / accum
        leaves = state.optimizer.leaves
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        clock = _Clock(stats, leaves[0].device)
        loss_sum = acc_sum = 0.0
        for mb_i, mseed in enumerate(micro_seeds(seed, accum)):
            mb = Batch(*[None if x is None else x[mb_i] for x in batch])
            loss, metrics = _loss_fn(state.params, cfg, mb, mseed)
            clock.lap("forward_s")
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            for acc, gi in zip(grads, g):
                if gi is not None:
                    acc.add_(gi.float(), alpha=w)
            loss_sum = loss_sum + w * loss.detach().float()
            acc_sum = acc_sum + w * metrics["accuracy"].detach()
            clock.lap("backward_s")
        grad_norm = global_norm(grads)
        finite = bool(torch.isfinite(loss_sum) & torch.isfinite(grad_norm))
        if finite:
            state.optimizer.update(grads, grad_norm)
        state.step += 1
        clock.lap("optimizer_s")
        return {"loss": float(loss_sum), "accuracy": float(acc_sum),
                "grad_norm": float(grad_norm), "skipped": float(not finite)}

    return train_step


class _Clock:
    """Host-clock laps that end in a device synchronize; inert without a
    stats dict."""

    def __init__(self, stats: dict | None, device: torch.device):
        self.stats = stats
        self.device = device
        self.t = time.perf_counter()

    def lap(self, key: str) -> None:
        if self.stats is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stats[key] = self.stats.get(key, 0.0) + now - self.t
        self.t = now


def make_eval_step(cfg: AVSRConfig) -> Callable[..., dict[str, float]]:
    """``eval_step(params, batch) -> {loss, accuracy, label_tokens}``, no
    gradient, no dropout."""

    @torch.no_grad()
    def eval_step(params, batch: Batch) -> dict[str, float]:
        loss, metrics = _loss_fn(params, cfg, batch, None)
        return {"loss": float(loss), "accuracy": float(metrics["accuracy"]),
                "label_tokens": float(metrics["label_tokens"])}

    return eval_step


def microbatch(batch: Batch, accum: int) -> Batch:
    """Reshape [B, ...] -> [accum, B // accum, ...] for accumulation."""
    if batch.prompt_tokens is not None and batch.prompt_tokens.ndim == 1:
        B = batch.labels.shape[0]
        batch = batch._replace(prompt_tokens=batch.prompt_tokens[None].expand(B, -1))

    def split(x: Any):
        if x is None:
            return None
        if x.shape[0] % accum:
            raise ValueError(f"batch of {x.shape[0]} does not split into "
                             f"{accum} micro-batches")
        return x.reshape(accum, x.shape[0] // accum, *x.shape[1:])

    return Batch(*[split(x) for x in batch])
