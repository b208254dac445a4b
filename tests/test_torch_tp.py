"""Tensor parallelism (``mesh.tp``) of the port on the CPU, against one
process and the JAX package's tp mesh.

Unit parity, in one process (the ranks of a group as threads over
:class:`ThreadGroup`, whose collectives sum in rank order):

  * every flagship leaf (float, int4 QLoRA) is sliced on the dimensions
    JAX's ``param_spec`` shards, to JAX's per-device shapes on its
    ``fsdp=2 tp=2`` mesh;
  * the mesh's groups are the coordinates of JAX's device grid for
    ``tp=2``, ``dp=2 tp=2`` and ``fsdp=2 tp=2``;
  * the row-parallel int4 repack, gathered, gives the packed leaf back bit
    for bit, and each slice holds the rank's rows of the weight;
  * each rank's fused decode layout equals the global one's columns of
    the rank;
  * vocab-sharded logits give one card's loss and accuracy, a tie across
    two ranks' vocab slices included (the lowest index, as ``jnp.argmax``);
  * a Megatron encoder block (random biases) equals the whole block, so
    the row-parallel bias is added once; a Llama stack with LoRA dropout
    gives one card's gradients of every LoRA leaf (neither a partial sum
    nor counted twice); a block whose heads do not divide runs whole, and
    a Llama whose kv heads, FFN width or vocabulary do not divide raises.

Whole slices (f32), 2 and 4 gloo ranks as subprocesses
(``torch_multirank_worker.py``) on a free localhost port:

  * ``tp=2``, ``dp=2 tp=2`` and ``fsdp=2 tp=2`` train steps with LoRA
    dropout on equal the port's one-process step: loss |d| < 1e-5, grad
    norm 1e-5 relative, every trainable leaf's gradient (first step) and
    value (after 2 steps) atol 1e-6; with dropout off they equal JAX's step
    on ``build_mesh(..., devices=jax.devices()[:n])`` to
    ``tests/test_mesh.py``'s tolerances (loss 1e-4, LoRA ``b`` 1e-5);
  * QLoRA (int4 base) under ``tp=2`` equals its one-process step, and its
    gathered int4 leaves (row-parallel ones repacked) are the quantized
    tree's bit for bit;
  * ``tp=2`` greedy and beam decodes equal one process's and JAX's
    ``generate_tokens`` / ``beam_search`` token for token, and speculative
    decoding (the int8 self-draft, a layer-skip draft) one process's and
    greedy's; the serving
    preset (int4, int8 head, int8 cache; the plain qmatmul) equals one
    process's tokens, its prefill logits within 1e-5;
  * the train CLI under ``tp=2`` (2 steps, validation and in-training
    WER, the whole LLM trained with adafactor) checkpoints the full tree
    and resumes at world 1 to the run of one process; the decode CLI under
    ``tp=2`` writes one process's HYP lines.
"""

import dataclasses
import importlib
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from torch._subclasses.fake_tensor import FakeTensorMode

from avsr_tpu.core import config as jcfg
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.mesh import sharding as jsharding
from avsr_tpu.models import avsr as javsr
from avsr_tpu.models.avsr import init_avsr_model as jinit
from avsr_tpu.ops.quant import quantize_llm as jquantize_llm
from avsr_tpu.train import state as jstate
from avsr_tpu.train import step as jstep
from avsr_tpu_torch.cli import decode as tcli_decode
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.infer import speculative as tspec
from avsr_tpu_torch.mesh import collectives, sharding
from avsr_tpu_torch.models import layers as tlayers
from avsr_tpu_torch.models import llama as tllama
from avsr_tpu_torch.models.avsr import Batch, init_avsr_model
from avsr_tpu_torch.ops.quant import _unpack_int4, quantize_llm, quantize_tensor
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import CheckpointManager, export_params, load_params

from test_torch_checkpoint_cli import hyp_lines
from test_torch_checkpoint_cli import overrides as cli_overrides
from test_torch_models import np_tree, randomize_lora_b
from test_torch_multirank import (assert_same_run, global_batch, launch,  # noqa: F401
                                  one_process_run, train_over)
from test_torch_qlora import quantized
from test_torch_train import WIDE, configs, jax_paths, port_paths

torch.set_num_threads(1)

jgen = importlib.import_module("avsr_tpu.infer.generate")

# 4 q heads and 2 kv heads (GQA 2:1): 2 and 1 a rank at tp=2
TP = {"model.llm.n_heads": 4, "model.llm.n_kv_heads": 2}
DROPOUT = {"model.lora.dropout": 0.3}
SEEDS = (11, 12)
EOS = 257
STEP_RUNS = {   # name: (world, overrides beyond TP, weights)
    "tp2": (2, {**DROPOUT, "mesh.tp": 2}, "float"),
    "tp2_no_dropout": (2, {"mesh.tp": 2}, "float"),
    "qlora_tp2": (2, {**DROPOUT, "mesh.tp": 2, "model.use_4bit": "true"}, "int4"),
    "dp2_tp2": (4, {**DROPOUT, "mesh.tp": 2, "mesh.remat": "true"}, "float"),
    "fsdp2_tp2": (4, {**DROPOUT, "mesh.tp": 2, "mesh.fsdp": 2}, "float"),
    "dp2_tp2_no_dropout": (4, {"mesh.tp": 2}, "float"),
    "fsdp2_tp2_no_dropout": (4, {"mesh.tp": 2, "mesh.fsdp": 2}, "float"),
}
PRESET = {"model.use_4bit": "true", "decode.lm_head_bits": 8, "decode.kv_cache_dtype": "int8"}
DECODE_RUNS = {"f32": ({}, "float"), "preset": (PRESET, "int4")}
SPEC_DRAFTS = (0, 1)    # the int8 self-draft, a 1-block layer-skip draft
GREEDY_TOKENS, BEAM_TOKENS, BEAMS = 10, 8, 3


# ---------------------------------------------------------------------------
# Ranks as threads of this process
# ---------------------------------------------------------------------------

class _Shared:
    def __init__(self, n: int):
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n, timeout=120)


class ThreadGroup:
    """A group whose ranks are threads of this process: every collective
    exchanges the ranks' tensors through shared slots, and sums in rank
    order, so every rank gets the same bits."""

    def __init__(self, shared: _Shared, rank: int, ranks: list[int]):
        self.shared, self.rank, self.ranks = shared, rank, ranks
        self.size = len(ranks)

    def _exchange(self, t):
        sh = self.shared
        sh.barrier.wait()
        sh.slots[self.rank] = t
        sh.barrier.wait()
        vals = list(sh.slots)
        sh.barrier.wait()
        return vals

    def all_reduce(self, t, op="sum"):
        vals = self._exchange(t.detach().clone())
        f = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op]
        out = vals[0]
        for v in vals[1:]:
            out = f(out, v)
        return t.copy_(out)

    def broadcast(self, t, src=0):
        return t.copy_(self._exchange(t.detach().clone())[src])

    def all_gather(self, t, dim=0):
        return torch.cat(self._exchange(t.detach().contiguous()), dim=dim)

    def reduce_scatter(self, t, dim=0):
        vals = self._exchange(t.detach().clone())
        return sum(vals[1:], vals[0]).chunk(self.size, dim=dim)[self.rank].contiguous()

    def shift(self, ts, offset=1):
        vals = self._exchange([t.detach().clone() for t in ts])
        return vals[(self.rank - offset) % self.size]


def thread_meshes(shape: dict) -> list[sharding.Mesh]:
    """A :class:`sharding.Mesh` per rank of ``shape``, over thread groups
    laid out as ``mesh_groups`` lays out the process groups."""
    groups = sharding.mesh_groups(shape)
    shared = {tuple(lst): _Shared(len(lst)) for lists in groups.values() for lst in lists}
    meshes = []
    for r in range(len(groups["world"][0])):
        kw = {}
        for name, lists in groups.items():
            lst = next(lst for lst in lists if r in lst)
            kw[name] = ThreadGroup(shared[tuple(lst)], lst.index(r), lst)
        meshes.append(sharding.Mesh(dict(shape), r, **kw))
    return meshes


def on_ranks(shape: dict, fn) -> list:
    """``fn(mesh)`` on one thread per rank of ``shape``; the results."""
    meshes = thread_meshes(shape)
    out, errors = [None] * len(meshes), []

    def body(r):
        try:
            out[r] = fn(meshes[r])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            for g in {id(m.world): m.world for m in meshes}.values():
                g.shared.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def tp_shape(tp: int = 2, dp: int = 1, fsdp: int = 1) -> dict:
    return dict(zip(sharding.AXES, (1, dp, fsdp, 1, 1, tp, 1)))


def echo_mesh(shape: dict, rank: int) -> sharding.Mesh:
    """Rank ``rank``'s mesh of ``shape`` over groups that never talk (for
    slicing alone)."""
    groups = sharding.mesh_groups(shape)
    kw = {}
    for name, lists in groups.items():
        lst = next(lst for lst in lists if rank in lst)
        kw[name] = collectives.EchoGroup(len(lst), lst.index(rank))
    return sharding.Mesh(dict(shape), rank, **kw)


# ---------------------------------------------------------------------------
# Specs, groups, slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["flagship", "qlora"])
def test_flagship_leaves_slice_as_jax_shards_them(form):
    """At full width, from shapes alone: every flagship leaf's slice under
    ``fsdp=2 tp=2`` has the per-device shape of JAX's NamedSharding of the
    leaf's ``param_spec`` on its 4-device mesh, and its tp dimension is
    the spec's."""
    jc = jcfg.load_config("avsr_tpu/configs/base.yaml", [])
    mesh4 = jsharding.build_mesh(jcfg.MeshConfig(dp=1, fsdp=2, tp=2), devices=jax.devices()[:4])

    def jtree():
        p = jinit(jax.random.key(0), jc.model)
        return {**p, "llm": jquantize_llm(p["llm"], 4)} if form == "qlora" else p

    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.eval_shape(jtree))[0]:
        key = tuple(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path)
        spec = jsharding.param_spec(path, leaf)
        want[key] = (NamedSharding(mesh4, spec).shard_shape(leaf.shape),
                     spec.index("tp") if "tp" in spec else None)
    with FakeTensorMode():
        p = init_avsr_model(tcfg.flagship().model, device="cpu")
        if form == "qlora":
            p = {**p, "llm": quantize_llm(p["llm"], 4)}
        local = port_paths(sharding.shard_params(p, echo_mesh(tp_shape(fsdp=2), 3)))
    assert local.keys() == want.keys()
    tp_dims = {}
    for k, t in local.items():
        s = sharding.tp_of(t)
        assert (tuple(t.shape), s.dim if s else None) == want[k], k
        tp_dims[k[-2:]] = s.dim if s else None
    assert tp_dims[("q", "w" if form == "flagship" else "qw4h")] == 1
    assert tp_dims[("down", "w" if form == "flagship" else "qw4h")] == 0
    assert tp_dims[("llm", "embed")] == 0 and tp_dims[("patch", "w")] == 1


@pytest.mark.parametrize("axes", [dict(tp=2), dict(dp=2, tp=2), dict(fsdp=2, tp=2)],
                         ids=["tp2", "dp2_tp2", "fsdp2_tp2"])
def test_mesh_groups_are_jax_device_grid_coordinates(axes):
    """Rank r sits at the coordinates of device r of JAX's ``build_mesh``;
    each group holds the ranks that share every coordinate but its axes'
    (``data``: dcn, dp, fsdp; ``tp``: tp; ...), in the grid's order."""
    n = int(np.prod(list(axes.values())))
    jmesh = jsharding.build_mesh(jcfg.MeshConfig(dp=axes.get("dp", 1), **{
        k: v for k, v in axes.items() if k != "dp"}), devices=jax.devices()[:n])
    ids = {d.id: i for i, d in enumerate(jax.devices()[:n])}
    grid = np.vectorize(lambda d: ids[d.id])(jmesh.devices)
    shape = sharding.mesh_shape(tcfg.MeshConfig(**{"dp": axes.get("dp", 1), **axes}), n)
    assert dict(jmesh.shape) == shape
    got = sharding.mesh_groups(shape)
    names = list(jmesh.axis_names)
    for group, vary in (("world", names), ("data", ["dcn", "dp", "fsdp", "ep"]),
                        ("fsdp", ["fsdp"]), ("replica", ["dcn", "dp", "ep"]), ("tp", ["tp"])):
        keep = [i for i, a in enumerate(names) if a not in vary]
        idx = [names.index(a) for a in vary]
        want = np.transpose(grid, keep + idx).reshape(-1, int(np.prod(
            [grid.shape[i] for i in idx]))).tolist()
        assert got[group] == want, group
    assert got["tp"] == ([[0, 1], [2, 3]] if n == 4 else [[0, 1]])


def test_int4_row_parallel_repack_round_trips():
    """A row-parallel ``qw4h`` leaf (``("tp", "fsdp")``) is unpacked, cut
    to the rank's rows of the weight and packed again; the gather undoes it
    bit for bit, and the ranks' products sum to the whole one."""
    w = torch.randn(64, 24, generator=torch.Generator().manual_seed(0))
    leaf = quantize_tensor(w, 4)
    tree = {"llm": {"layers": [{"down": leaf}]}}
    parts = [sharding.shard_params(tree, echo_mesh(tp_shape(), r))["llm"]["layers"][0]["down"]
             for r in range(2)]
    full = _unpack_int4(leaf["qw4h"])
    for r, part in enumerate(parts):
        s = sharding.tp_of(part["qw4h"])
        assert s.packed and s.dim == 0 and s.full == 32
        assert part["qw4h"].shape == (16, 24) and sharding.tp_of(part["scale"]) is None
        assert torch.equal(_unpack_int4(part["qw4h"]), full[32 * r: 32 * (r + 1)])
    joined = sharding._join(torch.cat([p["qw4h"] for p in parts]),
                            sharding.tp_of(parts[0]["qw4h"]))
    assert torch.equal(joined, leaf["qw4h"])
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(1))
    from avsr_tpu_torch.ops.quant import qdot
    whole = qdot(x, leaf)
    split = sum(qdot(x[:, 32 * r: 32 * (r + 1)], parts[r]) for r in range(2))
    torch.testing.assert_close(split, whole, atol=1e-5, rtol=1e-5)


def tiny_llm(extra=(), seed=0):
    cfg = tcfg.load_config("avsr_tpu/configs/tiny_cpu.yaml", [
        "model.llm.d_model=64", "model.llm.n_heads=4", "model.llm.n_kv_heads=2",
        "model.llm.n_layers=2", "model.lora.dropout=0.3",
        "model.lora.target_modules=[q_proj,k_proj,v_proj,o_proj,gate_proj,up_proj,down_proj]",
        *extra])
    p = init_avsr_model(cfg.model, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for path, t in tstate.path_leaves(p).items():
        if path.endswith("lora/b"):
            t.normal_(0.0, 0.05, generator=g)
    return cfg, p


def test_per_rank_fused_layout_equals_global_columns():
    """Each rank fuses its own q|k|v and gate|up slices (int4 too): its
    fused leaves are the rank's columns of each part of the global fused
    layout, and its fused product with LoRA gives those columns of the
    global product."""
    cfg, p = tiny_llm()
    llm = p["llm"]
    glob = tllama.fuse_decode_layout(llm)["layers"][0]
    widths = {"qkv": (64, 32, 32), "gateup": (64, 64)}
    h = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(2))
    ls = tllama.lora_scale(cfg.model.lora)
    for r in range(2):
        mesh = echo_mesh(tp_shape(), r)
        mine = tllama.fuse_decode_layout(sharding.shard_params({"llm": llm}, mesh)["llm"])
        lyr = mine["layers"][0]
        for name, ws in widths.items():
            offs = np.concatenate([[0], np.cumsum(ws)])
            cols = torch.cat([torch.arange(a + r * (b - a) // 2, a + (r + 1) * (b - a) // 2)
                              for a, b in zip(offs[:-1], offs[1:])])
            assert torch.equal(lyr[name]["w"], glob[name]["w"][:, cols]), name
            with torch.no_grad():
                got = tllama.proj(lyr[name], h, lora_scale=ls, tp=mesh.tp)
                want = tllama.proj(glob[name], h, lora_scale=ls)[..., cols]
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
        assert "o" in lyr and sharding.tp_of(lyr["o"]["w"]).dim == 0


def test_vocab_sharded_logits_give_one_card_loss_accuracy_and_ties():
    """The head split over the vocabulary (tied embedding, and an int8
    head) gives the full logits on every rank; the loss and accuracy of
    ``models/avsr.py::forward``'s formula equal one card's, and a tie
    across the two ranks' vocab slices (a zero hidden state: every logit
    0) goes to the lowest global index, as ``jnp.argmax``, not to a rank's
    own first index."""
    cfg, p = tiny_llm()
    llm = p["llm"]
    V = cfg.model.llm.vocab_size
    x = torch.randn(2, 6, 64, generator=torch.Generator().manual_seed(3))
    x[0, 0] = 0.0
    labels = torch.randint(0, V, (2, 6), generator=torch.Generator().manual_seed(4))
    labels[0, 0] = 200

    def metrics(logits):
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.gather(logp, -1, labels[..., None]).mean()
        return loss, (logits.argmax(-1) == labels).float().mean(), logits.argmax(-1)

    heads = {"tied": llm, "int8": quantize_llm(llm, 0, lm_head_bits=8)}
    for name, tree in heads.items():
        want = tllama.compute_logits(tree, cfg.model.llm, x)
        assert float(want[0, 0, 130]) == float(want[0, 0, 0]) == float(want[0, 0].max())
        got = on_ranks(tp_shape(), lambda m, t=tree: tllama.compute_logits(
            sharding.shard_params({"llm": t}, m)["llm"], cfg.model.llm, x))
        for g in got:
            assert g.shape == want.shape and torch.equal(g, got[0])
            torch.testing.assert_close(g, want, atol=1e-6, rtol=0)
            lw, aw, iw = metrics(want)
            lg, ag, ig = metrics(g)
            assert abs(float(lg - lw)) < 1e-6 and float(ag) == float(aw)
            assert torch.equal(ig, iw) and int(ig[0, 0]) == 0
        assert int(jnp.argmax(jnp.asarray(want[0, 0].numpy()))) == 0


def test_embedding_lookup_over_vocab_slices():
    cfg, p = tiny_llm()
    tokens = torch.tensor([[0, 129, 130, 259, 7]])
    want = tllama.embed_tokens(p["llm"], tokens)
    got = on_ranks(tp_shape(), lambda m: tllama.embed_tokens(
        sharding.shard_params(p, m)["llm"], tokens))
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.parametrize("k_bias", [False, True], ids=["whisper", "clip"])
def test_megatron_encoder_block_equals_whole_block(k_bias):
    """Whisper's (no k bias) and CLIP's block under tp=2, every bias
    random: the output and the input's gradient equal the whole block's,
    so each row-parallel bias (o, fc2) is added once, after the sum."""
    g = torch.Generator().manual_seed(5)
    p = tlayers.encoder_block_init(g, 32, 128, k_bias=k_bias)
    for path, t in tstate.path_leaves(p).items():
        if path.endswith("/b"):
            t.normal_(0.0, 0.5, generator=g)
    x = torch.randn(2, 300, 32, generator=g)
    lens = torch.tensor([300, 211])
    kw = dict(n_heads=4, lengths=lens, use_kernel="always")

    def run(tree):
        xx = x.clone().requires_grad_(True)
        y = tlayers.gathered_block(tree, xx, **kw)
        (y * y).mean().backward()
        return y.detach(), xx.grad

    want = run(p)
    for y, dx in on_ranks(tp_shape(), lambda m: run(
            sharding.shard_params({"blocks": [p]}, m)["blocks"][0])):
        torch.testing.assert_close(y, want[0], atol=2e-6, rtol=0)
        torch.testing.assert_close(dx, want[1], atol=1e-8, rtol=1e-5)


def test_llama_lora_gradients_are_one_cards():
    """A 2-layer Llama with LoRA on all seven projections and dropout on,
    under tp=2: the logits and the gradient of every LoRA leaf and of the
    input equal one card's. A LoRA factor that a rank uses a slice of has
    its gradient summed over the group once (a partial sum, or one counted
    on both ranks, fails here)."""
    cfg, p = tiny_llm()
    llm = p["llm"]
    x = torch.randn(2, 20, 64, generator=torch.Generator().manual_seed(6))
    lens = torch.tensor([20, 13])

    def run(tree):
        leaves = {k: t.detach().clone().requires_grad_(True)
                  for k, t in tstate.path_leaves(tree).items() if "/lora/" in k}
        tree = tstate.tree_map_with_path(
            lambda path, t: leaves.get("/".join(path), t), tree)
        xx = x.clone().requires_grad_(True)
        out, _ = tllama.llama_apply(tree, cfg.model.llm, inputs_embeds=xx, lengths=lens,
                                    lora=cfg.model.lora, dropout_seed=5)
        (out * out).mean().backward()
        return out.detach(), xx.grad, {k: t.grad for k, t in leaves.items()}

    want = run(llm)
    assert len(want[2]) == 28
    for out, dx, grads in on_ranks(tp_shape(), lambda m: run(
            sharding.shard_params({"llm": llm}, m)["llm"])):
        torch.testing.assert_close(out, want[0], atol=1e-6, rtol=0)
        torch.testing.assert_close(dx, want[1], atol=1e-9, rtol=1e-5)
        for k, gw in want[2].items():
            torch.testing.assert_close(grads[k], gw, atol=1e-8, rtol=1e-5, msg=k)


def test_non_dividing_heads_gather_and_llama_refuses(caplog):
    """CLIP-style 3 heads over tp=2 (its 12 over 8): the block gathers its
    slices and runs whole, logged once; a Llama whose kv heads, FFN width or
    (quantized, padded) vocabulary do not divide by tp raises the message
    of ``shard_params``."""
    g = torch.Generator().manual_seed(7)
    p = tlayers.encoder_block_init(g, 24, 96)
    x = torch.randn(2, 10, 24, generator=g)
    want = tlayers.gathered_block(p, x, n_heads=3, act=tlayers.quick_gelu)
    with caplog.at_level(logging.WARNING, logger="avsr_tpu_torch.models"):
        got = on_ranks(tp_shape(), lambda m: tlayers.gathered_block(
            sharding.shard_params({"blocks": [p]}, m)["blocks"][0], x, n_heads=3,
            act=tlayers.quick_gelu))
    for y in got:
        torch.testing.assert_close(y, want, atol=1e-6, rtol=0)
    assert "3 heads do not divide over tp=2" in caplog.text
    m = tcfg.flagship().model
    sharding.check_model(m, 8, lm_head_bits=8)
    for over, what in ((dict(n_kv_heads=1), "kv heads"), (dict(ffn_dim=8191), "dimension 1"),
                       (dict(vocab_size=261), "dimension 0")):
        bad = dataclasses.replace(m, llm=dataclasses.replace(m.llm, **over))
        with pytest.raises(ValueError, match=f"{what}.*should be divisible by 2"):
            sharding.check_model(bad, 2)
    # a vocabulary that divides while the quantized head's padded one does
    # not: 3003 over tp=3 pads to 4096
    w = dict(d_model=192, n_heads=6)
    odd = dataclasses.replace(
        m, whisper=dataclasses.replace(m.whisper, **w), clip=dataclasses.replace(m.clip, **w),
        llm=dataclasses.replace(m.llm, **w, n_kv_heads=3, ffn_dim=384, vocab_size=3003))
    sharding.check_model(odd, 3)
    with pytest.raises(ValueError, match="lm_head/qw.*dimension 1.*divisible by 3.*4096"):
        sharding.check_model(odd, 3, lm_head_bits=8)


# ---------------------------------------------------------------------------
# Whole slices across processes (gloo)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_weights():
    """The JAX init of the tp config (4 q heads, 2 kv heads), LoRA b
    random, as numpy."""
    jc, _ = configs(**TP)
    return randomize_lora_b(np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model)),
                            seed=3)


def port_overrides(extra: dict) -> list[str]:
    return ([f"{k}={v}" for k, v in {**WIDE, **TP, **extra}.items()]
            + ["runtime.use_pallas=always"])


def decode_batch() -> dict[str, np.ndarray]:
    g = global_batch()
    return {k: v[0, :2] for k, v in g.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tp_weights):
    """Every multi-process run of this file: 2 ranks in one job, 4 in
    another."""
    tmp = tmp_path_factory.mktemp("tp")
    files = {"float": tmp / "float.pt", "int4": tmp / "int4.pt"}
    torch.save(from_numpy_tree(tp_weights, "cpu"), files["float"])
    torch.save(from_numpy_tree(quantized(tp_weights, 4), "cpu"), files["int4"])
    np.savez(tmp / "batch.npz", **global_batch())
    np.savez(tmp / "decode.npz", **decode_batch())
    jc = jload_config(None, cli_overrides(tmp / "run", tmp / "dec"))
    cli_w = np_tree(javsr.init_avsr_model(jax.random.key(4), jc.model))
    export_params(from_numpy_tree(cli_w, "cpu"), tmp / "texport")

    def dec_argv(dec_dir, *extra):
        return ["--device", "cpu", *cli_overrides(tmp / "unused", dec_dir), *extra,
                "--checkpoint", str(tmp / "texport"), "--split", "train"]

    jobs: dict[int, list] = {2: [], 4: []}
    for name, (world, extra, w) in STEP_RUNS.items():
        jobs[world].append(dict(kind="step", overrides=port_overrides(extra),
                                weights=str(files[w]), batch=str(tmp / "batch.npz"),
                                seeds=list(SEEDS), out=str(tmp / f"{name}.pt")))
    for name, (extra, w) in DECODE_RUNS.items():
        jobs[2].append(dict(kind="decode", overrides=port_overrides({**extra, "mesh.tp": 2}),
                            weights=str(files[w]), batch=str(tmp / "decode.npz"), eos=EOS,
                            new_tokens=GREEDY_TOKENS, beam_tokens=BEAM_TOKENS, beams=BEAMS,
                            spec=list(SPEC_DRAFTS) if w == "float" else [],
                            out=str(tmp / f"dec_{name}_rank{{rank}}.pt")))
    jobs[2] += [
        dict(kind="cli", cli="train", argv=["--device", "cpu", *train_over(
            tmp / "run_tp", 2, ("mesh.tp=2",))]),
        dict(kind="cli", cli="decode", argv=dec_argv(tmp / "dec_tp", "mesh.tp=2"))]
    for world, job in jobs.items():
        launch(world, job, tmp)
    return dict(tmp=tmp, files=files, dec_argv=dec_argv)


def one_process(extra: dict, w) -> tuple[list[dict], dict, dict]:
    """The port's one-process steps of ``STEP_RUNS``'s config on the global
    batch: (metrics per step, the first step's gradients, trained leaves)."""
    tc = tcfg.load_config("avsr_tpu/configs/tiny_cpu.yaml", port_overrides(
        {k: v for k, v in extra.items() if not k.startswith("mesh.")}))
    params = tstate.cast_frozen(from_numpy_tree(w, "cpu"), tc.model, torch.float32)
    state = tstate.create_train_state(params, tc, 10)
    grads = {}
    update = state.optimizer.update

    def record(gs, norm):
        if not grads:
            grads.update({k: g.clone() for k, g in zip(state.optimizer.names, gs)})
        return update(gs, norm)

    state.optimizer.update = record
    step = tstep.make_train_step(tc)
    batch = Batch(**{k: torch.from_numpy(v) for k, v in global_batch().items()})
    metrics = [step(state, batch, seed) for seed in SEEDS]
    leaves = {"/".join(k): v for k, v in
              port_paths(tstate.partition_trainable(state.params, tc.model)[0]).items()}
    return metrics, grads, leaves


def assert_equal_runs(got: dict, metrics: list[dict], grads: dict, leaves: dict) -> None:
    for g, w in zip(got["metrics"], metrics):
        assert abs(g["loss"] - w["loss"]) < 1e-5, (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-5 * w["grad_norm"], (g, w)
        assert g["skipped"] == w["skipped"] == 0
    assert got["grads"].keys() == grads.keys() == got["leaves"].keys() == leaves.keys()
    assert any(k.endswith("lora/a") for k in leaves) and any(k.endswith("lora/b") for k in leaves)
    for k in leaves:
        torch.testing.assert_close(got["grads"][k], grads[k], atol=1e-6, rtol=0,
                                   msg=lambda m, k=k: f"gradient {k}: {m}")
        torch.testing.assert_close(got["leaves"][k], leaves[k].detach(), atol=1e-6, rtol=0,
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("name", ["tp2", "dp2_tp2", "fsdp2_tp2"])
def test_tp_steps_equal_one_process(runs, tp_weights, name):
    """Megatron blocks, vocab-sharded embedding and head, LoRA dropout
    masks of one card, gradients of replicated LoRA factors summed over the
    tp group once: two steps equal one process's, leaf for leaf."""
    world, extra, _ = STEP_RUNS[name]
    got = torch.load(runs["tmp"] / f"{name}.pt", weights_only=False)
    assert got["shape"]["tp"] == 2 and got["shape"]["fsdp"] == extra.get("mesh.fsdp", 1)
    assert got["shape"]["dp"] == world // 2 // extra.get("mesh.fsdp", 1)
    assert_equal_runs(got, *one_process(extra, tp_weights))


@pytest.mark.parametrize("name", ["tp2", "dp2_tp2", "fsdp2_tp2"])
def test_tp_steps_equal_jax_mesh_step(runs, tp_weights, name):
    """Dropout off: the port's steps over 2 or 4 processes against JAX's
    step on its mesh of the same axes, from the same weights."""
    world, extra, _ = STEP_RUNS[f"{name}_no_dropout"]
    jc, _ = configs(**TP)
    jc = dataclasses.replace(jc, mesh=dataclasses.replace(
        jc.mesh, dp=-1, tp=2, fsdp=extra.get("mesh.fsdp", 1)))
    mesh = jsharding.build_mesh(jc.mesh, devices=jax.devices()[:world])
    state, tx = jstate.create_train_state(jax.tree_util.tree_map(jnp.asarray, tp_weights),
                                          jc, total_steps=10)
    state = jsharding.shard_state(state, mesh)
    step = jstep.make_train_step(jc, tx)
    batch = jsharding.batch_sharder(mesh)(
        javsr.Batch(**{k: jnp.asarray(v) for k, v in global_batch().items()}))
    jm = []
    for seed in SEEDS:
        state, m = step(state, batch, jax.random.key(seed))
        jm.append(m)
    got = torch.load(runs["tmp"] / f"{name}_no_dropout.pt", weights_only=False)
    for g, m in zip(got["metrics"], jm):
        assert abs(g["loss"] - float(m["loss"])) < 1e-4
    want = jax_paths(jstate.partition_trainable(state.params, jc.model)[0])
    bs = [k for k in want if k[-1] == "b"]
    assert bs
    for k in bs:
        np.testing.assert_allclose(got["leaves"]["/".join(k)].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=str(k))


def test_qlora_under_tp_equals_one_process(runs, tp_weights):
    """int4 QLoRA under tp=2: the step equals one process's, and the int4
    leaves gathered from the ranks' slices (column slices; row-parallel
    o and down repacked) are the quantized tree's bit for bit."""
    _, extra, _ = STEP_RUNS["qlora_tp2"]
    got = torch.load(runs["tmp"] / "qlora_tp2.pt", weights_only=False)
    qw = quantized(tp_weights, 4)
    assert_equal_runs(got, *one_process(extra, qw))
    want = {"/".join(k): v for k, v in port_paths(from_numpy_tree(qw, "cpu")).items()}
    packed = [k for k in got["frozen"] if k.endswith("qw4h")]
    assert any("/down/" in k for k in packed) and any("/o/" in k for k in packed)
    assert any("/q/" in k for k in packed)
    for k, v in got["frozen"].items():
        assert torch.equal(v, want[k]), k


def _port_decode(tc, w):
    params = tgen.prepare_params_for_decode(from_numpy_tree(w, "cpu"), tc.model,
                                            tc.decode.lm_head_bits)
    b = Batch(**{k: torch.from_numpy(v) for k, v in decode_batch().items()})
    kw = dict(eos_id=EOS, kv_cache_dtype=tc.decode.kv_cache_dtype, use_kernel="always")
    stats: dict = {}
    g = tgen.generate_tokens(params, tc.model, b, max_new_tokens=GREEDY_TOKENS,
                             stats=stats, **kw)
    beam = tgen.beam_search(params, tc.model, b, num_beams=BEAMS,
                            max_new_tokens=BEAM_TOKENS, **kw)
    return g, beam, stats["prefill_logits"]


def test_tp_decode_equals_one_process_and_jax(runs, tp_weights):
    """f32 greedy and beam search under tp=2 (each rank its heads, its KV
    cache, the vocab-gathered logits): both ranks emit one process's and
    JAX's tokens."""
    tc = tcfg.load_config("avsr_tpu/configs/tiny_cpu.yaml", port_overrides({}))
    g, beam, pre = _port_decode(tc, tp_weights)
    jc, _ = configs(**TP)
    jb = javsr.Batch(**{k: jnp.asarray(v) for k, v in decode_batch().items()})
    jp = jax.tree_util.tree_map(jnp.asarray, tp_weights)
    jg = jgen.generate_tokens(jp, jc.model, jb, max_new_tokens=GREEDY_TOKENS, eos_id=EOS,
                              use_pallas="never")
    jbeam = jgen.beam_search(jp, jc.model, jb, max_new_tokens=BEAM_TOKENS, num_beams=BEAMS,
                             eos_id=EOS, use_pallas="never")
    np.testing.assert_array_equal(g.tokens.numpy(), np.asarray(jg.tokens))
    np.testing.assert_array_equal(beam.tokens.numpy(), np.asarray(jbeam.tokens))
    assert len(set(g.tokens.flatten().tolist())) > 1
    for r in range(2):
        got = torch.load(runs["tmp"] / f"dec_f32_rank{r}.pt", weights_only=False)
        assert got["shape"]["tp"] == 2
        assert torch.equal(got["greedy"], g.tokens) and torch.equal(got["beam"], beam.tokens)
        assert torch.equal(got["greedy_lens"], g.lengths)
        torch.testing.assert_close(got["prefill_logits"], pre, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layers", SPEC_DRAFTS, ids=["self_draft", "layerskip_draft"])
def test_tp_speculative_equals_one_process_and_greedy(runs, tp_weights, layers):
    """Speculative decoding under tp=2 with an int8 draft sliced like the
    target (its int8 head cut over the vocabulary), each verify on the
    vocab-gathered logits: both ranks
    accept and reject in lockstep and emit one process's tokens, which in
    f32 are greedy decoding's."""
    tc = tcfg.load_config("avsr_tpu/configs/tiny_cpu.yaml", port_overrides({}))
    raw = from_numpy_tree(tp_weights, "cpu")
    params = tgen.prepare_params_for_decode(raw, tc.model)
    d_raw, d_cfg = (tspec.make_layerskip_draft(raw, tc.model, layers) if layers
                    else (raw, None))
    draft = tspec.make_draft_params(d_raw, d_cfg or tc.model, bits=8)
    b = Batch(**{k: torch.from_numpy(v) for k, v in decode_batch().items()})
    want = tspec.speculative_generate(params, draft, tc.model, b, gamma=3,
                                      max_new_tokens=GREEDY_TOKENS, eos_id=EOS,
                                      use_kernel="always", draft_model_cfg=d_cfg).tokens
    greedy, _, _ = _port_decode(tc, tp_weights)
    assert torch.equal(want, greedy.tokens)
    for r in range(2):
        got = torch.load(runs["tmp"] / f"dec_f32_rank{r}.pt", weights_only=False)
        assert torch.equal(got["spec"][layers], want)


def test_tp_preset_decode_equals_one_process(runs, tp_weights):
    """The serving preset under tp=2 on the CPU (the qmatmul's plain
    version on column slices and on repacked row slices, the int8 head's
    vocab slices, the int8 cache of the rank's kv heads): one process's
    tokens, its prefill logits within 1e-5."""
    tc = tcfg.load_config("avsr_tpu/configs/tiny_cpu.yaml",
                          port_overrides({k: str(v) for k, v in PRESET.items()}))
    g, beam, pre = _port_decode(tc, quantized(tp_weights, 4))
    for r in range(2):
        got = torch.load(runs["tmp"] / f"dec_preset_rank{r}.pt", weights_only=False)
        assert torch.equal(got["greedy"], g.tokens) and torch.equal(got["beam"], beam.tokens)
        torch.testing.assert_close(got["prefill_logits"], pre, atol=1e-5, rtol=0)


def test_tp_checkpoint_resumes_at_world_one(runs, one_process_run):  # noqa: F811
    """The train CLI under tp=2 (2 steps with validation and in-training
    WER; LoRA and the whole LLM trained with adafactor, its moments held as
    tp slices) writes the full tree from rank 0 alone, and a world-1 run
    resumes it to a third step equal to the one-process run's."""
    run = runs["tmp"] / "run_tp"
    rows = (run / "loss_log.csv").read_text().splitlines()
    assert [r.split(",")[2] for r in rows[1:]] == ["train", "val", "val_wer"] * 2
    assert CheckpointManager(run / "ckpt").latest_step() == 2
    full = load_params(run / "ckpt" / "2")
    assert full["llm"]["embed"].shape == (260, 128)
    assert full["llm"]["layers"][0]["q"]["w"].shape == (128, 128)
    assert tcli_train.main(["--device", "cpu", *train_over(run, 3)]) == 0
    assert_same_run(run, one_process_run)


def test_tp_decode_cli_equals_one_process(runs, tmp_path):
    """The decode CLI on 2 ranks under tp=2: rank 0 writes the HYP lines of
    the one-process decode."""
    assert tcli_decode.main(runs["dec_argv"](tmp_path / "dec1")) == 0
    two = hyp_lines(runs["tmp"] / "dec_tp")
    assert len(two) == 8 and two == hyp_lines(tmp_path / "dec1")
    assert len(list((runs["tmp"] / "dec_tp").glob("wer_*.txt"))) == 1
