"""Train / eval steps with gradient accumulation and the non-finite skip,
the port of ``avsr_tpu/train/step.py``.

A step takes a batch whose leaves carry a leading [accum, micro, ...] axis
(``microbatch``), runs forward and backward per micro-batch, and averages
the f32 gradients of the trainable leaves over the micro-batches. If the
mean loss or the gradients' global norm is not finite, the parameters and
the optimizer are left as they were and only ``state.step`` advances, as
the JAX step's ``lax.cond`` does; with ``runtime.debug_nans`` a NaN loss
or gradient norm raises ``FloatingPointError`` instead (as
``jax_debug_nans`` does; an inf alone is still skipped), and so does a NaN
eval loss. ``runtime.prng_impl`` and ``runtime.compilation_cache_dir`` are
XLA settings with no meaning in eager PyTorch: accepted, and no-ops. A
train step (and only a train step: it has a dropout seed) augments its
micro-batches when ``data.specaugment`` or ``data.video_augment`` asks.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from avsr_tpu_torch.core.config import AVSRConfig
from avsr_tpu_torch.core.logging import trace_range
from avsr_tpu_torch.mesh.sharding import (RowShard, check_model, ep_of, row_shard,
                                          shard_of, shards_of, tag)
from avsr_tpu_torch.models.avsr import Batch, forward
from avsr_tpu_torch.ops.specaugment import specaugment
from avsr_tpu_torch.ops.videoaug import video_augment
from avsr_tpu_torch.train.state import TrainState


def augment(cfg: AVSRConfig, batch: Batch, seed: int,
            shard: RowShard | None = None) -> tuple[Batch, int]:
    """SpecAugment (``data.specaugment``) and video augmentation
    (``data.video_augment``) of a training batch, drawn from generators on
    the batch's device seeded from ``seed``; returns the batch and the seed
    left for dropout. As the JAX step splits its dropout key once per
    augmentation, the dropout seed changes only when one is on. With
    ``shard`` the batch is a rank's rows of a global batch and takes those
    rows' draws."""
    d = cfg.data
    rows = (shard.start, shard.total) if shard is not None else None
    spec = d.specaugment and batch.mel is not None
    video = d.video_augment and batch.frames is not None
    if not (spec or video):
        return batch, seed
    seed, spec_seed, video_seed = micro_seeds(seed, 3)
    if spec:
        gen = torch.Generator(device=batch.mel.device).manual_seed(spec_seed)
        batch = batch._replace(mel=specaugment(
            batch.mel, batch.mel_lens, gen, time_masks=d.spec_time_masks,
            time_width=d.spec_time_width, freq_masks=d.spec_freq_masks,
            freq_width=d.spec_freq_width, rows=rows))
    if video:
        gen = torch.Generator(device=batch.frames.device).manual_seed(video_seed)
        batch = batch._replace(frames=video_augment(
            batch.frames, batch.frame_lens, gen, max_shift=d.vid_max_shift,
            flip=d.vid_flip, brightness=d.vid_brightness, contrast=d.vid_contrast,
            rows=rows))
    return batch, seed


def _loss_fn(params, cfg: AVSRConfig, batch: Batch, dropout_seed: int | None,
             shard: RowShard | None = None, sp=None, pp=None):
    if dropout_seed is not None:        # the training path only
        batch, dropout_seed = augment(cfg, batch, dropout_seed, shard)
    return forward(params, cfg.model, batch,
                   compute_dtype=getattr(torch, cfg.runtime.compute_dtype),
                   use_kernel=cfg.runtime.use_pallas, remat=cfg.mesh.remat,
                   dropout_seed=dropout_seed, shard=shard, sp=sp, pp=pp)


def micro_seeds(seed: int, n: int) -> list[int]:
    """One dropout seed per micro-batch of a step (the counterpart of
    ``jax.random.split(rng, accum)``)."""
    states = np.random.SeedSequence(seed).spawn(n)
    return [int(s.generate_state(1, np.uint64)[0]) for s in states]


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32; a sharded
    leaf's slices are summed over the ranks that hold the others (its fsdp
    and its tp group), so a leaf counts once whatever its slicing."""
    total = sum((t.float() ** 2).sum() for t in tensors if not shards_of(t))
    by_groups: dict[tuple, tuple[tuple, list[torch.Tensor]]] = {}
    for t in tensors:
        groups = tuple(s.group for s in shards_of(t))
        if groups:
            by_groups.setdefault(tuple(map(id, groups)), (groups, []))[1].append(t)
    for groups, ts in by_groups.values():
        part = sum((t.float() ** 2).sum() for t in ts)
        for g in groups:
            part = g.all_reduce(part)
        total = total + part
    return torch.sqrt(total)


# elements per all-reduce of the gradients (256 MB of f32)
_BUCKET = 1 << 26


def reduce_grads(grads: list[torch.Tensor], leaves: list[torch.Tensor], mesh) -> None:
    """Sums each gradient over the ranks that hold other rows, other
    chunks of the sequence or other pipeline stages, and its leaf whole or
    the same slice of it (the ``sums`` group: the data, sp and pp groups;
    or the replica group of an fsdp-sharded leaf, whose gather's backward
    already summed the fsdp group's rows, and which holds the sp and pp
    axes too), in place, a bucket of flattened gradients per all-reduce.
    Under sp every rank's gradient is its share of the whole, whether the
    leaf is used inside the sharded block stacks or only on replicated
    tensors (``collectives.py``), so each counts once. A tp rank's gradient
    is already its slice's (or, for a replicated leaf, the whole group's:
    ``collectives.copy_to_tp``), so the tp group takes no part.

    Under pp every gradient is a share too, and each leaf is summed over
    the pp group once: a Llama block's leaves have their whole gradient on
    the stage that runs the block and none elsewhere; whatever feeds the
    stack (the connectors, the encoders, the prompt and label embeddings)
    has its whole gradient on stage 0 alone (``ops/pipeline.py``); and
    what runs after the pipeline's return on every stage (``ln_f``, the
    head, a tied embedding's head use) has ``1 / pp`` of it on each,
    because each stage's loss is ``1 / pp`` of its rows' share
    (``models/avsr.py::forward``) and the return's backward sums the
    stages' gradients of the hidden states (``psum``'s transpose). The
    gradients come back tagged as their leaves, for :func:`global_norm`.

    An ep-sliced leaf (stacked experts, ``mesh.ep``) holds other experts
    than the other ranks of its ep group, and its owner's gradient already
    covers the ep group's tokens (the exchange's backward), so it is summed
    over the same groups without the ep axis (``ep_sums``, or
    ``ep_replica`` when fsdp slices it too)."""
    by_group: dict[int, tuple[Any, list[torch.Tensor]]] = {}
    for g, p in zip(grads, leaves):
        fs, ep = shard_of(p) is not None, ep_of(p) is not None
        group = ((mesh.ep_replica if ep else mesh.replica) if fs
                 else mesh.ep_sums if ep else mesh.sums)
        by_group.setdefault(id(group), (group, []))[1].append(tag(g, shards_of(p)))
    for group, gs in by_group.values():
        if group.size == 1:
            continue
        bucket: list[torch.Tensor] = []
        for i, g in enumerate(gs):
            bucket.append(g)
            if sum(b.numel() for b in bucket) >= _BUCKET or i == len(gs) - 1:
                flat = group.all_reduce(torch.cat([b.reshape(-1) for b in bucket]))
                for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                    b.copy_(part.view_as(b))
                bucket = []


def make_train_step(cfg: AVSRConfig, mesh=None
                    ) -> Callable[..., dict[str, float]]:
    """``train_step(state, batch, seed) -> metrics`` updates ``state`` in
    place. ``batch`` leaves are [accum, micro, ...] and each micro-batch
    weighs 1 / accum; ``seed`` draws the step's dropout masks. The JAX step
    takes per-micro-batch weights so that it can pad a partial group to its
    compiled shape with zero-weight copies; eager PyTorch runs the partial
    group as it is, which gives the same update. Metrics: ``loss``,
    ``accuracy``, ``grad_norm``, ``skipped``, and with MoE (the ``moe``
    connector or ``llm.moe_experts``) the router losses ``moe_lb`` and
    ``moe_z``, summed over the micro-batches with their weights.

    ``stats``, when given, accumulates the seconds spent in ``forward_s``,
    ``backward_s`` and ``optimizer_s`` (host clock, with a device
    synchronize at each boundary).

    With ``mesh`` (``mesh/sharding.py``) the batch holds this rank's rows
    of every micro-batch (the same number on every rank), each rank's loss
    is its share of the global micro-batch's, and the gradients are summed
    over the ranks before the norm, the skip decision and the update,
    which are then the same on every rank; the metrics are the global
    batch's. Under ``mesh.sp`` the ranks of an sp group hold the same rows
    and each its chunk of the sequences (``models/avsr.py::forward``); the
    gradients and the metrics are summed over the data and sp groups
    together (``mesh.sums``). Under ``mesh.pp`` the ranks of a pp group
    hold the same rows, each runs its stage of the LLM (GPipe), and the
    sums span the pp group too (:func:`reduce_grads`)."""
    sp = pp = None
    if mesh is not None:
        check_model(cfg.model, mesh.shape["tp"], pp=mesh.shape["pp"])
        sp, pp = mesh.sp, mesh.pp

    extra_keys = (("moe_lb", "moe_z")
                  if cfg.model.connector_type == "moe" or cfg.model.llm.moe_experts > 0
                  else ())

    def train_step(state: TrainState, batch: Batch, seed: int,
                   stats: dict | None = None) -> dict[str, float]:
        accum = next(x for x in batch if x is not None).shape[0]
        w = 1.0 / accum
        leaves = state.optimizer.leaves
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        clock = _Clock(stats, leaves[0].device)
        loss_sum = acc_sum = 0.0
        extra = dict.fromkeys(extra_keys, 0.0)
        for mb_i, mseed in enumerate(micro_seeds(seed, accum)):
            with trace_range("avsr::micro_batch"):
                mb = Batch(*[None if x is None else x[mb_i] for x in batch])
                shard = row_shard(mesh, mb.labels.shape[0])
                loss, metrics = _loss_fn(state.params, cfg, mb, mseed, shard, sp, pp)
                clock.lap("forward_s")
                g = torch.autograd.grad(loss, leaves, allow_unused=True)
                for acc, gi in zip(grads, g):
                    if gi is not None:
                        acc.add_(gi.float(), alpha=w)
                loss_sum = loss_sum + w * loss.detach().float()
                acc_sum = acc_sum + w * metrics["accuracy"].detach()
                for k in extra_keys:
                    extra[k] = extra[k] + w * metrics[k].detach()
                clock.lap("backward_s")
        if mesh is not None:
            reduce_grads(grads, leaves, mesh)
            sums = mesh.sums.all_reduce(torch.stack([
                torch.as_tensor(v, dtype=torch.float32, device=grads[0].device)
                for v in (loss_sum, acc_sum, *extra.values())]))
            loss_sum, acc_sum, *rest = sums.unbind()
            extra = dict(zip(extra, rest))
        grad_norm = global_norm(grads)
        if cfg.runtime.debug_nans:
            _raise_on_nan("train step", step=state.step, loss=loss_sum,
                          grad_norm=grad_norm)
        finite = bool(torch.isfinite(loss_sum) & torch.isfinite(grad_norm))
        if finite:
            state.optimizer.update(grads, grad_norm)
        state.step += 1
        clock.lap("optimizer_s")
        return {"loss": float(loss_sum), "accuracy": float(acc_sum),
                "grad_norm": float(grad_norm), "skipped": float(not finite),
                **{k: float(v) for k, v in extra.items()}}

    return train_step


def _raise_on_nan(where: str, **values) -> None:
    """``runtime.debug_nans``: raise on a NaN among ``values`` (tensors or
    ints; an inf is not a NaN)."""
    nan = [k for k, v in values.items()
           if isinstance(v, torch.Tensor) and bool(torch.isnan(v).any())]
    if nan:
        shown = ", ".join(f"{k}={float(v) if isinstance(v, torch.Tensor) else v}"
                          for k, v in values.items())
        raise FloatingPointError(f"runtime.debug_nans: NaN {'/'.join(nan)} in the "
                                 f"{where} ({shown})")


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


def make_eval_step(cfg: AVSRConfig, mesh=None) -> Callable[..., dict[str, float]]:
    """``eval_step(params, batch) -> {loss, accuracy, label_tokens}``, no
    gradient, no dropout; with ``mesh`` the batch is this rank's rows and
    the metrics are the global batch's."""

    @torch.no_grad()
    def eval_step(params, batch: Batch) -> dict[str, float]:
        loss, metrics = _loss_fn(params, cfg, batch, None,
                                 row_shard(mesh, batch.labels.shape[0]),
                                 *((mesh.sp, mesh.pp) if mesh is not None else ()))
        acc = metrics["accuracy"]
        if mesh is not None:
            loss, acc = mesh.sums.all_reduce(torch.stack([loss.float(), acc.float()])).unbind()
        if cfg.runtime.debug_nans:
            _raise_on_nan("eval step", loss=loss)
        return {"loss": float(loss), "accuracy": float(acc),
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
