"""The mesh of the data axes and the parameter sharding rules, the port of
``avsr_tpu/mesh/sharding.py`` for ``dp``, ``fsdp`` and ``dcn_dp``.

The JAX package runs one program over every device and lets pjit insert
the collectives; the port runs one process per card, each holding its own
rows of every batch, and makes the collectives itself (``collectives.py``):

  * **the mesh**: axes ``(dcn, dp, fsdp, ep, sp, tp, pp)`` over the world's
    ranks in row-major order, as ``build_mesh`` reshapes the device list,
    with ``dp=-1`` inferred from the world size and JAX's message when the
    product does not match it. A rank's position in the flattened data axes
    (``dcn``, ``dp``, ``fsdp``; ``ep`` counts too, and is 1 here) is its
    rank: its rows of a global batch are the contiguous
    ``multihost.local_rows``;
  * **dp / dcn_dp**: every rank holds every parameter; the gradients of a
    step are summed over all ranks (each rank's loss is its rows' share of
    the global batch's, ``models/avsr.py::forward``);
  * **fsdp**: JAX's rule table, verbatim. A leaf whose spec names ``fsdp``
    keeps only this rank's slice of that dimension (``shard_params``); the
    model gathers it where it is used (``gather_tree``: each Whisper, CLIP
    and Llama block its own leaves, inside the block's remat; every other
    subtree once per forward) through an autograd Function whose backward
    reduce-scatters the gradient of a trained leaf over the fsdp group. The
    slices of one leaf are summed over the ranks that hold the same slice
    (the ``replica`` group) after the step's micro-batches.

The optimizer state of a sharded trained leaf holds the slice
(``train/state.py``); checkpoints hold the full tree (``gather_leaf``) and
are sliced again on load (``local_part``), so a run resumes at any world.
``tp``, ``sp``, ``ep`` and ``pp`` are the next slice (``core/config.py``
refuses them), and so is mixture of experts over the data axes, whose
routing JAX computes over the global batch (:func:`check_model`).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, replace
from typing import Any, NamedTuple

import numpy as np
import torch

from avsr_tpu_torch.core.config import MeshConfig, ModelConfig
from avsr_tpu_torch.mesh.collectives import EchoGroup, make_groups
from avsr_tpu_torch.mesh.multihost import data_parallel_ways

log = logging.getLogger("avsr_tpu_torch.mesh")

AXES = ("dcn", "dp", "fsdp", "ep", "sp", "tp", "pp")


# ---------------------------------------------------------------------------
# Mesh construction
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axis sizes, its coordinates and
    its three groups. ``data``: every rank (the batch splits over all of
    them); ``fsdp``: the ranks that share this rank's ``dcn`` and ``dp``
    coordinates (they hold the slices of one leaf); ``replica``: the ranks
    with this rank's ``fsdp`` coordinate (they hold the same slices)."""

    shape: dict[str, int]
    rank: int
    data: Any
    fsdp: Any
    replica: Any

    @property
    def ways(self) -> int:
        """The ranks the batch splits over."""
        return data_parallel_ways(self)

    @property
    def sharded(self) -> bool:
        return self.shape["fsdp"] > 1

    def echo(self) -> "Mesh":
        """The same layout over groups that never communicate
        (``collectives.EchoGroup``)."""
        return replace(self, data=EchoGroup(self.data.size, self.data.rank),
                       fsdp=EchoGroup(self.fsdp.size, self.fsdp.rank),
                       replica=EchoGroup(self.replica.size, self.replica.rank))


def mesh_shape(cfg: MeshConfig, n: int) -> dict[str, int]:
    """Axis sizes over ``n`` ranks: JAX's ``build_mesh`` arithmetic and
    message."""
    fsdp, tp, sp = max(cfg.fsdp, 1), max(cfg.tp, 1), max(cfg.sp, 1)
    pp, ep = max(cfg.pp, 1), max(cfg.ep, 1)
    dcn = max(cfg.dcn_dp, 1)
    dp = cfg.dp if cfg.dp > 0 else n // (dcn * fsdp * ep * sp * tp * pp)
    if dcn * dp * fsdp * ep * sp * tp * pp != n:
        raise ValueError(
            f"mesh {dcn}x{dp}x{fsdp}x{ep}x{sp}x{tp}x{pp} != {n} devices "
            "(set mesh.dp=-1 to infer)")
    return dict(zip(AXES, (dcn, dp, fsdp, ep, sp, tp, pp)))


def build_mesh(cfg: MeshConfig, *, world: int, rank: int) -> Mesh:
    """The mesh over a process group of ``world`` ranks (initialized:
    ``multihost.init_distributed``) as rank ``rank`` sees it. Every rank
    must call it with the same config: it creates process groups, which
    is collective over the world."""
    shape = mesh_shape(cfg, world)
    # ranks in row-major order over the axes: the fsdp axis is the last
    # one above 1, so a row of this grid is one fsdp group
    fsdp = np.arange(world).reshape(-1, shape["fsdp"])
    mesh = Mesh(shape, rank, data=make_groups([list(range(world))]),
                fsdp=make_groups(fsdp.tolist()), replica=make_groups(fsdp.T.tolist()))
    log.info("mesh: dcn=%d dp=%d fsdp=%d ep=%d sp=%d tp=%d pp=%d over %d ranks",
             *shape.values(), world)
    return mesh


def check_model(cfg: ModelConfig) -> None:
    """Raises for a model the data axes cannot run yet: mixture of experts
    routes with a capacity and balance losses over the global batch in
    JAX, which the port's per-rank routing would change."""
    if cfg.connector_type == "moe" or cfg.llm.moe_experts > 0:
        raise NotImplementedError(
            "mixture of experts across processes routes over the global "
            "batch; it comes with mesh.ep in the next slice of the port. "
            "Run MoE on one card (WORLD_SIZE=1)")


# ---------------------------------------------------------------------------
# Parameter sharding rules (path regex -> spec), JAX's table verbatim
# ---------------------------------------------------------------------------

# Megatron pattern: column-parallel (out-dim tp) for q/k/v/gate/up/fc1,
# row-parallel (in-dim tp) for o/down/fc2. fsdp shards the opposite dim.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"\blora/a/?$",                        (None, None)),
    (r"\blora/b/?$",                        (None, None)),
    (r"\b(q|k|v|qkv|gate|up|gateup|fc1)/(w|qw|qw4h)$", ("fsdp", "tp")),
    (r"\b(o|down|fc2)/(w|qw|qw4h)$",         ("tp", "fsdp")),
    (r"\b(q|k|v|qkv|gate|up|gateup|fc1)/scale$",      ("tp",)),
    (r"\b(o|down|fc2)/scale$",              ("fsdp",)),
    (r"\bembed$",                           ("tp", "fsdp")),   # vocab-sharded
    (r"\blm_head/(w|qw|qw4h)$",              ("fsdp", "tp")),
    (r"\blm_head/scale$",                   ("tp",)),
    # MoE (connector and LLM FFN): stacked expert weights [E, d, f]/[E, f, d]
    # shard E over ep; tp takes the wide ffn dim in the LLM experts (megatron
    # column/row inside each expert), fsdp the other. Routers stay
    # replicated so every token scores every expert locally.
    (r"\bexperts/w1$",                      ("ep", None, "fsdp")),
    (r"\bexperts/w2$",                      ("ep", "fsdp", None)),
    (r"\bexperts/b[12]$",                   ("ep", None)),
    (r"\bexperts/w_(gate|up)$",             ("ep", "fsdp", "tp")),
    (r"\bexperts/w_down$",                  ("ep", "tp", "fsdp")),
    (r"\bconv[12]/w$",                      (None, None, None)),
    (r"\bpatch/w$",                         (None, "tp")),
    (r"\b(inp|out|mid|res|proj_a|proj_v)/w$", (None, None)),
    (r"\bpos$",                             (None, None)),
]


def param_spec(path: str | tuple[str, ...], leaf) -> tuple:
    """The spec of the leaf at ``path`` ("llm/layers/0/q/w" or its parts),
    cut to the leaf's rank; () is replicated. JAX's ``param_spec``."""
    s = path if isinstance(path, str) else "/".join(path)
    for pat, spec in _PARAM_RULES:
        if re.search(pat, s):
            return spec if len(spec) <= leaf.ndim else spec[: leaf.ndim]
    return ()


def fsdp_dim(path: str | tuple[str, ...], leaf) -> int | None:
    """The dimension of the leaf that the fsdp axis shards, if any."""
    spec = param_spec(path, leaf)
    return spec.index("fsdp") if "fsdp" in spec else None


# ---------------------------------------------------------------------------
# Sharded leaves
# ---------------------------------------------------------------------------

class Shard(NamedTuple):
    """A leaf that holds its slice ``index`` of ``group.size`` along
    ``dim``; the full leaf has ``full`` entries there."""

    dim: int
    full: int
    group: Any


_TAG = "_avsr_shard"


def shard_of(t: Any) -> Shard | None:
    return getattr(t, _TAG, None)


def tag(t: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    if shard is not None:
        setattr(t, _TAG, shard)
    return t


def _walk(fn, tree: Any, path: tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _walk(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def shard_params(params: Any, mesh: Mesh) -> Any:
    """A tree whose leaves with an fsdp spec hold this rank's slice (a
    copy, tagged with its :class:`Shard`); the other leaves are the same
    tensors. A dimension that does not divide raises, as
    ``jax.device_put`` does. Without fsdp the tree comes back as it is."""
    if not mesh.sharded:
        return params
    g = mesh.fsdp

    def leaf(path: tuple[str, ...], t: Any) -> Any:
        if not isinstance(t, torch.Tensor):
            return t
        d = fsdp_dim(path, t)
        if d is None:
            return t
        n = t.shape[d]
        if n % g.size:
            raise ValueError(
                f"{'/'.join(path)}: the sharding {param_spec(path, t)} implies "
                f"that the global size of its dimension {d} should be divisible "
                f"by {g.size}, but it is equal to {n} (full shape: {tuple(t.shape)})")
        part = t.detach().chunk(g.size, dim=d)[g.rank].clone()
        return tag(part, Shard(d, n, g))

    return _walk(leaf, params)


class _Gather(torch.autograd.Function):
    """The full leaf from its slices; the backward reduce-scatters the
    gradient over the group (each rank keeps the sum of its slice)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return group.all_gather(local, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.reduce_scatter(grad.contiguous(), ctx.dim), None, None


def gather_leaf(t: Any) -> Any:
    """The full tensor of a sharded leaf (through the autograd Function
    when it needs a gradient), or the leaf itself."""
    s = shard_of(t)
    if s is None:
        return t
    if t.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(t, s.dim, s.group)
    return s.group.all_gather(t, s.dim)


def gather_tree(tree: Any) -> Any:
    """``tree`` with every sharded leaf gathered; new containers, the same
    tensors elsewhere."""
    return _walk(lambda _, t: gather_leaf(t), tree)


def is_sharded(tree: Any) -> bool:
    found = []
    _walk(lambda _, t: found.append(shard_of(t) is not None), tree)
    return any(found)


def full_shape(t: torch.Tensor) -> torch.Size:
    s = shard_of(t)
    if s is None:
        return t.shape
    shape = list(t.shape)
    shape[s.dim] = s.full
    return torch.Size(shape)


def local_part(full: torch.Tensor, like: torch.Tensor, what: str = "") -> torch.Tensor:
    """This rank's slice of ``full`` for the leaf ``like`` (sharded or not);
    raises unless ``full`` has the full leaf's shape."""
    s = shard_of(like)
    want = full_shape(like)
    if full.shape != want:
        raise ValueError(f"{what} has shape {tuple(full.shape)}, expected {tuple(want)}")
    if s is None:
        return full
    return full.chunk(s.group.size, dim=s.dim)[s.group.rank]


# ---------------------------------------------------------------------------
# Rows of a batch and the sums over them
# ---------------------------------------------------------------------------

class RowShard(NamedTuple):
    """This rank's rows of a global batch: they start at global row
    ``start`` of ``total``; ``group`` sums over every rank's rows."""

    start: int
    total: int
    group: Any


def row_shard(mesh: Mesh | None, local_rows: int) -> RowShard | None:
    """The :class:`RowShard` of a rank holding ``local_rows`` rows (every
    rank holds as many), or None without a mesh."""
    if mesh is None:
        return None
    return RowShard(mesh.data.rank * local_rows, mesh.ways * local_rows, mesh.data)


def pad_rows(batch: NamedTuple, ways: int) -> tuple[NamedTuple, int]:
    """(batch with its rows padded to a multiple of ``ways`` by repeating
    the last row, the real rows) for a batch of [B, ...] leaves."""
    B = next(x for x in batch if isinstance(x, torch.Tensor) and x.ndim).shape[0]
    pad = -B % ways

    def f(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0 or not pad:
            return x
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])

    return type(batch)(*[f(x) for x in batch]), B


def take_rows(batch: NamedTuple, lo: int, hi: int) -> NamedTuple:
    """Rows [lo, hi) of every [B, ...] leaf of ``batch``."""
    return type(batch)(*[x[lo:hi] if isinstance(x, torch.Tensor) and x.ndim else x
                         for x in batch])
