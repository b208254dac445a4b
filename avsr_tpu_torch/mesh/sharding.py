"""The mesh and the parameter sharding rules, the port of
``avsr_tpu/mesh/sharding.py`` for ``dp``, ``fsdp``, ``dcn_dp``, ``ep``,
``tp``, ``sp`` and ``pp``.

The JAX package runs one program over every device and lets pjit insert
the collectives; the port runs one process per card, each holding its own
rows of every batch, and makes the collectives itself (``collectives.py``):

  * **the mesh**: axes ``(dcn, dp, fsdp, ep, sp, tp, pp)`` over the world's
    ranks in row-major order, as ``build_mesh`` reshapes the device list,
    with ``dp=-1`` inferred from the world size and JAX's message when the
    product does not match it. Every group is the set of ranks that differ
    only in some axes' coordinates (:func:`mesh_groups`). A rank's position
    in the flattened data axes (``dcn``, ``dp``, ``fsdp``, ``ep``) is its
    rank in the ``data`` group: its rows of a
    global batch are the contiguous ``multihost.local_rows``; the ``tp``
    ranks of a data position hold the same rows;
  * **dp / dcn_dp**: every rank holds every parameter; the gradients of a
    step are summed over the data group (each rank's loss is its rows'
    share of the global batch's, ``models/avsr.py::forward``);
  * **fsdp**: JAX's rule table, verbatim. A leaf whose spec names ``fsdp``
    keeps only this rank's slice of that dimension (``shard_params``); the
    model gathers it where it is used (``gather_tree``: each Whisper, CLIP
    and Llama block its own leaves, inside the block's remat; every other
    subtree once per forward) through an autograd Function whose backward
    reduce-scatters the gradient of a trained leaf over the fsdp group. The
    slices of one leaf are summed over the ranks that hold the same slice
    (the ``replica`` group) after the step's micro-batches;
  * **tp**: the same table's ``tp`` entries. A leaf keeps this rank's
    slice of its ``tp`` dimension too (a leaf may be sliced on two
    dimensions, ``q/w`` ``("fsdp", "tp")``). Whisper, CLIP and Llama blocks
    run Megatron on their slices (``models/layers.py``,
    ``models/llama.py``), the embedding and the head split the vocabulary;
    every other tp-sharded leaf (the connectors, the other encoders, CLIP's
    ``patch/w``, a block whose heads do not divide) is gathered where it
    is used, and the gather's backward keeps this rank's slice of the
    gradient, which every tp rank computed whole. A row-parallel int4 leaf
    (``o|down|fc2`` ``qw4h``, ``("tp", "fsdp")``) is unpacked, cut to the
    rank's rows of the weight and packed again (the half-split packing
    pairs rows i and i + K/2, so a slice of the packed rows is not the
    rank's rows); its gather undoes that exactly;
  * **sp**: no leaf is sliced. The ranks of an ``sp`` group hold the same
    rows (``sp`` is not a data axis) and each holds one contiguous chunk of
    the sequence inside the Whisper, HuBERT/Wav2Vec2, AV-HuBERT and Llama
    block stacks, whose attention is ring attention
    (``ops/ring_attention.py``); a gradient that leaves the stack is a
    partial sum over the group (``collectives.py``), so the gradients and
    the metric sums span the data group and the sp group together (the
    ``sums`` group), and a sliced leaf's slices its ``replica`` group,
    which holds the sp axis too;
  * **pp**: no leaf is sliced either (JAX's table has no ``pp`` rule:
    every device holds the whole model). The ranks of a ``pp`` group hold
    the same rows (``pp`` is not a data axis) and each runs its stage, the
    ``n_layers / pp`` consecutive Llama blocks of its ``pp`` coordinate,
    on microbatches handed from stage to stage (``ops/pipeline.py``);
    everything else runs on every rank. Each rank's loss is ``1 / pp`` of
    its rows' share, and a gradient that leaves the pipeline is this
    rank's part (a layer's on the stage that owns it, the stack's input's
    on stage 0), so the gradients and the metric sums span the pp group
    too (``sums``), and a sliced leaf's ``replica`` group holds it.

  * **ep**: a data axis for every dense op (its ranks hold different
    rows), and the axis of the stacked experts' E dimension: a leaf whose
    spec names ``ep`` (``experts/*``) keeps this rank's E / ep experts, and
    the forward never gathers them (``gather_tree(keep_ep=True)``): the
    MoE blocks send each token's slot to its expert's owner and back
    (``ops/moe.py``, ``collectives.scatter_to_experts``). Such a leaf's
    gradient covers the ep group's tokens on the owner, so its slices are
    summed over the ranks that hold the same experts: its ``replica`` group
    without ``ep`` (``ep_replica``, or ``ep_sums`` when fsdp does not slice
    it). Mixture of experts routes over the global batch on every axis
    (``ops/moe.py::Routing``).

The optimizer state of a sharded trained leaf holds the slice
(``train/state.py``); checkpoints hold the full tree (``gather_leaf``) and
are sliced again on load (``local_part``), so a run resumes at any world.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, fields, replace
from typing import Any, NamedTuple

import numpy as np
import torch

from avsr_tpu_torch.core.config import MeshConfig, ModelConfig
from avsr_tpu_torch.mesh.collectives import EchoGroup, gather_from_tp, make_groups
from avsr_tpu_torch.mesh.multihost import DATA_AXES, data_parallel_ways
from avsr_tpu_torch.ops.quant import _unpack_int4, pack_int4

log = logging.getLogger("avsr_tpu_torch.mesh")

AXES = ("dcn", "dp", "fsdp", "ep", "sp", "tp", "pp")


# ---------------------------------------------------------------------------
# Mesh construction
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axis sizes and its groups.
    ``world``: every rank (decisions every rank must share); ``data``: the
    ranks that hold different rows (this rank's ``tp`` coordinate);
    ``fsdp``: the ranks that differ only in their ``fsdp`` coordinate (they
    hold the slices of one leaf); ``replica``: the ranks with this rank's
    ``fsdp`` and ``tp`` coordinates (they hold the same slices, the sp
    and pp ranks too); ``tp``: the ranks that differ only in their ``tp``
    coordinate (one Megatron group, the same rows); ``sp``: the ranks that
    differ only in their ``sp`` coordinate (the chunks of one sequence, the
    same rows); ``pp``: the ranks that differ only in their ``pp``
    coordinate (the stages of one pipeline, the same rows); ``sums``: the
    data, sp and pp groups together (the ranks whose gradients of a whole
    leaf, loss and token counts add up); ``ep``: the ranks that differ only
    in their ``ep`` coordinate (they hold the slices of the stacked
    experts); ``ep_sums`` and ``ep_replica``: ``sums`` and ``replica``
    without the ep axis (the ranks whose gradients of one expert slice add
    up). Without ``sp``, ``pp``, ``ep`` and ``sums`` the mesh has none of
    these axes: groups of one, and the data group (the ep sums, sums or
    replica)."""

    shape: dict[str, int]
    rank: int
    world: Any
    data: Any
    fsdp: Any
    replica: Any
    tp: Any
    sp: Any = None
    sums: Any = None
    pp: Any = None
    ep: Any = None
    ep_sums: Any = None
    ep_replica: Any = None

    def __post_init__(self):
        for axis in ("sp", "pp", "ep"):
            if getattr(self, axis) is None:
                object.__setattr__(self, axis, EchoGroup(1, 0))
        if self.sums is None:
            object.__setattr__(self, "sums", self.data)
        if self.ep_sums is None:
            object.__setattr__(self, "ep_sums", self.sums)
        if self.ep_replica is None:
            object.__setattr__(self, "ep_replica", self.replica)

    @property
    def ways(self) -> int:
        """The ranks the batch splits over."""
        return data_parallel_ways(self)

    @property
    def sharded(self) -> bool:
        return self.shape["fsdp"] > 1 or self.shape["tp"] > 1

    def echo(self) -> "Mesh":
        """The same layout over groups that never communicate
        (``collectives.EchoGroup``)."""
        groups = {f.name: getattr(self, f.name) for f in fields(self)
                  if f.name not in ("shape", "rank")}
        return replace(self, **{k: EchoGroup(g.size, g.rank) for k, g in groups.items()})


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


# each group: the axes along which its ranks differ
_GROUP_AXES = {"world": AXES, "data": DATA_AXES, "fsdp": ("fsdp",),
               "replica": ("dcn", "dp", "ep", "sp", "pp"), "tp": ("tp",), "sp": ("sp",),
               "sums": (*DATA_AXES, "sp", "pp"), "pp": ("pp",), "ep": ("ep",),
               "ep_sums": ("dcn", "dp", "fsdp", "sp", "pp"),
               "ep_replica": ("dcn", "dp", "sp", "pp")}


def mesh_groups(shape: dict[str, int]) -> dict[str, list[list[int]]]:
    """Every group of the mesh of ``shape`` as lists of ranks: the ranks
    laid out row-major over ``AXES`` (rank r at the coordinates of device r
    in JAX's ``build_mesh``), each group the ranks that share every
    coordinate but those of its axes, in row-major order over those."""
    grid = np.arange(int(np.prod([shape[a] for a in AXES]))).reshape(
        [shape[a] for a in AXES])
    out = {}
    for name, axes in _GROUP_AXES.items():
        vary = [AXES.index(a) for a in axes]
        keep = [i for i in range(len(AXES)) if i not in vary]
        size = int(np.prod([shape[a] for a in axes]))
        out[name] = np.transpose(grid, keep + vary).reshape(-1, size).tolist()
    return out


def build_mesh(cfg: MeshConfig, *, world: int, rank: int) -> Mesh:
    """The mesh over a process group of ``world`` ranks (initialized:
    ``multihost.init_distributed``) as rank ``rank`` sees it. Every rank
    must call it with the same config: it creates process groups, which
    is collective over the world (groups with the same ranks share one)."""
    shape = mesh_shape(cfg, world)
    made: dict[str, Any] = {}
    groups = {}
    for name, lists in mesh_groups(shape).items():
        key = repr(lists)
        if key not in made:
            made[key] = make_groups(lists)
        groups[name] = made[key]
    mesh = Mesh(shape, rank, **groups)
    log.info("mesh: dcn=%d dp=%d fsdp=%d ep=%d sp=%d tp=%d pp=%d over %d ranks",
             *shape.values(), world)
    return mesh


def check_model(cfg: ModelConfig, tp: int = 1, lm_head_bits: int = 0,
                pp: int = 1) -> None:
    """Raises for a model the mesh cannot run: under ``pp`` the JAX
    package refuses MoE blocks in the LLM, with its message (the ``moe``
    connector runs on every stage). Under ``tp`` a Llama's kv heads must
    divide (a rank runs whole kv heads), and so must every tp dimension of
    the model's leaves (:func:`shard_params`' check over the full-size tree
    as fake tensors, one block of each stack, the head quantized with
    ``lm_head_bits`` as ``quantize_llm`` pads it)."""
    if cfg.llm.moe_experts > 0 and pp > 1:
        raise ValueError(
            "llm.moe_experts with mesh.pp > 1 is unsupported (the "
            "GPipe stage scan does not thread MoE aux losses)")
    if tp <= 1:
        return
    if cfg.llm.n_kv_heads % tp:
        raise ValueError(
            f"llm/layers/*/k/w: the sharding ('fsdp', 'tp') implies that the global "
            f"number of kv heads (llm.n_kv_heads) should be divisible by {tp}, but "
            f"it is equal to {cfg.llm.n_kv_heads}")
    from torch._subclasses.fake_tensor import FakeTensorMode

    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.ops.quant import quantize_llm

    one = {k: replace(getattr(cfg, k), n_layers=1) for k in ("whisper", "clip", "llm")}
    with FakeTensorMode():
        tree = init_avsr_model(replace(cfg, **one), device="cpu")
        tree["llm"] = quantize_llm(tree["llm"], 0, lm_head_bits)

    def leaf(path: tuple[str, ...], t: Any) -> None:
        spec = param_spec(path, t)
        if "tp" in spec:
            _check_divides(path, spec, spec.index("tp"), tuple(t.shape), tp)

    _walk(leaf, tree)


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


# ---------------------------------------------------------------------------
# Sharded leaves
# ---------------------------------------------------------------------------

class Shard(NamedTuple):
    """A leaf that holds its slice ``group.rank`` of ``group.size`` along
    ``dim`` over the mesh axis ``axis``; the full leaf has ``full`` entries
    there. ``packed``: the dimension is the half-split int4 packing's, and
    the slice is the rank's rows of the weight, packed again."""

    dim: int
    full: int
    group: Any
    axis: str = "fsdp"
    packed: bool = False


_TAG = "_avsr_shard"


def shards_of(t: Any) -> tuple[Shard, ...]:
    """Every slicing of a leaf, the ``tp`` one first (the order of
    :func:`shard_params`); () for a whole leaf."""
    return getattr(t, _TAG, ())


def shard_of(t: Any) -> Shard | None:
    """The fsdp slicing of a leaf, or None."""
    return next((s for s in shards_of(t) if s.axis == "fsdp"), None)


def tp_of(t: Any) -> Shard | None:
    """The tp slicing of a leaf, or None."""
    return next((s for s in shards_of(t) if s.axis == "tp"), None)


def ep_of(t: Any) -> Shard | None:
    """The ep slicing of a leaf (its E experts), or None."""
    return next((s for s in shards_of(t) if s.axis == "ep"), None)


def tag(t: torch.Tensor, shards: Shard | tuple[Shard, ...] | None) -> torch.Tensor:
    if isinstance(shards, Shard):
        shards = (shards,)
    if shards:
        setattr(t, _TAG, tuple(shards))
    return t


def tp_group(tree: Any, axis: str = "tp") -> Any:
    """The group of the first leaf of ``tree`` sliced on ``axis`` (tp: a
    Megatron block's leaves; ep: the stacked experts), or None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            g = tp_group(v, axis)
            if g is not None:
                return g
        return None
    s = next((s for s in shards_of(tree) if s.axis == axis), None)
    return s.group if s is not None else None


def _walk(fn, tree: Any, path: tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _walk(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _take(t: torch.Tensor, s: Shard, index: int) -> torch.Tensor:
    """Part ``index`` of the full ``t`` under the slicing ``s``."""
    if not s.packed:
        return t.chunk(s.group.size, dim=s.dim)[index]
    rows = _unpack_int4(t)
    return pack_int4(rows.chunk(s.group.size, dim=0)[index])


def _join(parts: torch.Tensor, s: Shard) -> torch.Tensor:
    """The full leaf from every rank's part, concatenated along ``s.dim``."""
    if not s.packed:
        return parts
    return pack_int4(torch.cat([_unpack_int4(p) for p in parts.chunk(s.group.size)]))


def _check_divides(path: tuple[str, ...], spec: tuple, d: int, shape: tuple,
                   ways: int, n: int | None = None) -> None:
    """Raises ``jax.device_put``'s message unless the size ``n`` (by
    default the full shape's) of dimension ``d`` divides over ``ways``."""
    n = shape[d] if n is None else n
    if n % ways:
        raise ValueError(
            f"{'/'.join(path)}: the sharding {spec} implies "
            f"that the global size of its dimension {d} should be divisible "
            f"by {ways}, but it is equal to {n} (full shape: {shape})")


def shard_params(params: Any, mesh: Mesh,
                 axes: tuple[str, ...] = ("fsdp", "tp", "ep")) -> Any:
    """A tree whose leaves with an fsdp, tp or ep spec (of ``axes``) hold
    this rank's slice (a copy, tagged with its slicings, :class:`Shard`);
    the other leaves are the same tensors. A dimension that does not divide
    raises, as ``jax.device_put`` does. Without such an axis above 1 the
    tree comes back as it is. The decode CLI passes ``axes=("tp",)``: it
    holds what fsdp and ep would shard whole."""
    groups = {a: getattr(mesh, a) for a in ("tp", "ep", "fsdp")
              if a in axes and mesh.shape[a] > 1}
    if not groups:
        return params

    def leaf(path: tuple[str, ...], t: Any) -> Any:
        if not isinstance(t, torch.Tensor):
            return t
        spec = param_spec(path, t)
        out, shards = t.detach(), []
        for axis, g in groups.items():     # tp first: the int4 repack reads whole rows
            if axis not in spec:
                continue
            d = spec.index(axis)
            n = out.shape[d]
            _check_divides(path, spec, d, tuple(t.shape), g.size, n)
            s = Shard(d, n, g, axis, packed=axis == "tp" and d == 0 and path[-1] == "qw4h")
            out = _take(out, s, g.rank)
            shards.append(s)
        if not shards:
            return t
        return tag(out.clone(), tuple(shards))

    return _walk(leaf, params)


class _Gather(torch.autograd.Function):
    """The full leaf from its fsdp slices; the backward reduce-scatters the
    gradient over the group (each rank keeps the sum of its slice)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return group.all_gather(local, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.reduce_scatter(grad.contiguous(), ctx.dim), None, None


def _gather_dim(t: torch.Tensor, s: Shard) -> torch.Tensor:
    if t.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(t, s.dim, s.group)
    return s.group.all_gather(t, s.dim)


def gather_leaf(t: Any, keep_tp: bool = False, keep_ep: bool = False) -> Any:
    """The full tensor of a sharded leaf (through autograd Functions when
    it needs a gradient), or the leaf itself. ``keep_tp`` keeps (and tags)
    the tp slice: a Megatron block's view of its leaves; ``keep_ep`` keeps
    (and tags) the ep slice: the experts a MoE block runs on this rank."""
    fs, tp, ep = shard_of(t), tp_of(t), ep_of(t)
    out = t
    if fs is not None:
        out = _gather_dim(out, fs)
    if ep is not None and not keep_ep:
        out = _gather_dim(out, ep)
    kept = tuple(s for s, keep in ((tp, keep_tp), (ep, keep_ep)) if s is not None and keep)
    if tp is not None and not keep_tp:
        if tp.packed:       # integer leaves: never trained
            out = _join(tp.group.all_gather(out, 0), tp)
        else:
            out = gather_from_tp(out, tp.group, tp.dim)
    if out is t:
        return t
    return tag(out, kept)


def gather_tree(tree: Any, keep_tp: bool = False, keep_ep: bool = False) -> Any:
    """``tree`` with every sharded leaf gathered (``keep_tp``, ``keep_ep``:
    but for those slicings); new containers, the same tensors elsewhere."""
    return _walk(lambda _, t: gather_leaf(t, keep_tp, keep_ep), tree)


def is_sharded(tree: Any) -> bool:
    found = []
    _walk(lambda _, t: found.append(bool(shards_of(t))), tree)
    return any(found)


def full_shape(t: torch.Tensor) -> torch.Size:
    shape = list(t.shape)
    for s in shards_of(t):
        shape[s.dim] = s.full
    return torch.Size(shape)


def local_part(full: torch.Tensor, like: torch.Tensor, what: str = "") -> torch.Tensor:
    """This rank's slice of ``full`` for the leaf ``like`` (sharded or not);
    raises unless ``full`` has the full leaf's shape."""
    want = full_shape(like)
    if full.shape != want:
        raise ValueError(f"{what} has shape {tuple(full.shape)}, expected {tuple(want)}")
    for s in shards_of(like):
        full = _take(full, s, s.group.rank)
    return full


# ---------------------------------------------------------------------------
# Rows of a batch and the sums over them
# ---------------------------------------------------------------------------

class RowShard(NamedTuple):
    """This rank's rows of a global batch: they start at global row
    ``start`` of ``total``; ``group`` sums every rank's share (the data,
    sp and pp groups); ``data`` holds the ranks with other rows (the data
    group: whose tokens a MoE block routes with this rank's)."""

    start: int
    total: int
    group: Any
    data: Any = None


def row_shard(mesh: Mesh | None, local_rows: int) -> RowShard | None:
    """The :class:`RowShard` of a rank holding ``local_rows`` rows (every
    rank holds as many), or None without a mesh; its sums span the data, sp
    and pp groups (the ``sums`` group: under sp each rank counts its chunk's
    label tokens, under pp each stage counts its rows' tokens)."""
    if mesh is None:
        return None
    return RowShard(mesh.data.rank * local_rows, mesh.ways * local_rows, mesh.sums,
                    mesh.data)


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
