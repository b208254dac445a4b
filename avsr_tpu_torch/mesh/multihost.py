"""One process per card: the process group, this rank's device, and the
rows of each global batch that it loads, the port of
``avsr_tpu/mesh/multihost.py``.

A process follows torchrun's convention: it reads ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
(``LOCAL_WORLD_SIZE`` when set), takes ``cuda:LOCAL_RANK`` and NCCL, or
gloo under ``--device cpu`` or when more local ranks than cards share the
host's cards (``LOCAL_RANK`` modulo the card count). Without that
environment, or with ``WORLD_SIZE=1``, there is no process group and the
run is the single-card port.

Each rank loads its own contiguous rows of every global batch
(``DataLoader(data_shard=process_shard())``, the same shuffle on every
rank, buckets agreed from the dataset's ``length_hints``) and keeps them:
the JAX package needs ``put_global`` and the ``multihost_*_sharder``
functions to stitch process-local rows into global arrays, and here each
rank's rows already are its share of the batch, so they have no
counterpart.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("avsr_tpu_torch.mesh")

# The mesh axes a batch dimension shards over (ep counts as a data axis
# for every dense op, as in the JAX package; it also splits the experts).
DATA_AXES = ("dcn", "dp", "fsdp", "ep")

# a collective that waits longer than this raises (gloo) or aborts the
# process (NCCL's watchdog), so a rank that died fails the others
TIMEOUT = datetime.timedelta(minutes=10)


def world_size() -> int:
    """The world of the process group, or of the environment before it
    exists (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def process_shard() -> tuple[int, int]:
    """(rank, world) — the loader's ``data_shard``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", "0")), world_size()


def data_parallel_ways(mesh) -> int:
    ways = 1
    for ax in DATA_AXES:
        ways *= mesh.shape.get(ax, 1)
    return ways


def local_rows(batch_size: int, shard: tuple[int, int]) -> tuple[int, int]:
    """[lo, hi) rows of a global batch owned by process ``shard[0]`` of
    ``shard[1]``. Contiguous ranges: process p's rows line up with the
    mesh positions of its chips under the standard enumeration, and the
    union over processes is exactly [0, batch_size)."""
    idx, count = shard
    if not 0 <= idx < count:
        raise ValueError(f"data_shard index {idx} not in [0, {count})")
    if batch_size % count != 0:
        raise ValueError(
            f"global batch size {batch_size} must divide the "
            f"{count} data-loading processes")
    per = batch_size // count
    return idx * per, (idx + 1) * per


def init_distributed(device: str | torch.device) -> tuple[torch.device, str | None]:
    """(this rank's device, the backend) from the torchrun environment,
    with the default process group initialized; (``device``, None) and no
    process group when the world is 1. Idempotent."""
    device = torch.device(device)
    world = world_size()
    if world <= 1:
        return device, None
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", cards))
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= cards else "gloo"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ["MASTER_PORT"]
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                rank=rank, world_size=world, timeout=TIMEOUT)
        atexit.register(_destroy)
        log.info("rank %d of %d on %s (%s)", rank, world, device, backend)
    return device, dist.get_backend()


def refuse_world(what: str) -> None:
    """Stops a CLI that runs on one card when started in a world above 1."""
    n = world_size()
    if n > 1:
        raise SystemExit(
            f"{what} runs on one card: WORLD_SIZE={n}. Only the train and "
            "decode CLIs run across processes (mesh.dp, mesh.fsdp, mesh.dcn_dp, "
            "mesh.ep, mesh.tp, mesh.sp, mesh.pp)")


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
