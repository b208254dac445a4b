"""Sequence parallelism (``mesh.sp``) of the port on the CPU, against one
process and the JAX package's sp mesh (ring attention).

Unit parity, in one process (the ranks of a group as threads over
``test_torch_tp.ThreadGroup``, whose shift hands each rank its
predecessor's tensors):

  * ``ring_block_reference`` equals JAX's ``_ring_block`` at shifted query
    and key positions, with GQA, causal masks and rows with no key;
  * ``ring_attention`` at sp = 2 and 4, causal or not, Hkv = H and H/4,
    with a kv_len inside chunk 0 and a kv_len of 0 (rows whose every block
    has lse = +inf: no NaN), equals JAX's ``ring_attention``, forward and
    q/k/v gradients, at every row (JAX's ring masks keys only, and so does
    the port's without ``q_lens``), within 5e-5; with ``q_lens`` the rows
    past it are zero and the valid rows unchanged;
  * the sp operators and the shift move what they say, and their gradients
    are the shares that sum to one card's;
  * the Whisper stack and the LLM at sp = 2 equal JAX's under its sp mesh
    and the port's one process at valid rows; the port's ring dispatches
    equal JAX's ``ring_dispatch_count`` over the same forward; at sp = 3 a
    stack whose rows do not divide logs JAX's warning once and equals the
    unsharded stack;
  * the config accepts ``mesh.sp`` and ``mesh.pp``, keeps JAX's pp/sp
    message and refuses ``ep`` (the next slice); MoE under sp is refused;
    the sp and sums groups are JAX's device-grid coordinates.

Whole slices, f32, as gloo subprocesses (``torch_multirank_worker.py``):

  * JAX's ``test_sp_train_step_matches_sp1`` setup (the tiny config, B = 2,
    44 mel frames: 32 Whisper rows and 32 packed LLM rows) at ``sp=4``,
    ``dp=2 sp=2``, ``fsdp=2 sp=2`` (a sliced leaf's gradient summed over
    its replica group, which holds sp) and ``sp=2 tp=2``, and at ``sp=4``
    with ``unfreeze_layer_norms`` (layer norms inside and outside the
    sharded stack train), against JAX's step on its mesh of the same axes
    (loss rtol 1e-5, grad norm rtol 1e-4, LoRA ``b`` atol 1e-6) and the
    port's one process; ``dp=2 sp=2`` with LoRA dropout and remat against
    the port's one process;
  * JAX's ``test_sp2_decode_matches_sp1`` setup (a 24-row prefix, 8
    tokens) at ``sp=2`` and ``sp=2 tp=2``: greedy tokens equal JAX's
    ``generate_tokens`` and one process's, the ring engages in the
    prefill, and each rank's gathered KV cache is one process's (its heads
    under tp); greedy, beam and speculative decoding at ``sp=2`` and
    ``dp=2 sp=2``, and the serving preset at ``sp=2``, give one process's
    tokens and prefill logits;
  * ``probe_backend`` lists the shift and the sp operators, and gloo takes
    them;
  * the train CLI under ``sp=2`` (2 steps, validation and in-training WER)
    resumes at world 1 to one process's run; the decode CLI under
    ``sp=2`` writes one process's HYP lines.
"""

import dataclasses
import importlib
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core import config as jcfg
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.infer.generate import generate_tokens as jgenerate_tokens
from avsr_tpu.mesh import sharding as jsharding
from avsr_tpu.models import avsr as javsr
from avsr_tpu.models import llama as jllama
from avsr_tpu.models import whisper_encoder as jwhisper
from avsr_tpu.ops.ring_attention import _ring_block as jring_block
from avsr_tpu.ops.ring_attention import ring_attention as jring_attention
from avsr_tpu.train import state as jstate
from avsr_tpu.train import step as jstep
from avsr_tpu_torch.cli import decode as tcli_decode
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.infer import speculative as tspec
from avsr_tpu_torch.mesh import collectives, sharding
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.models import llama as tllama
from avsr_tpu_torch.models.whisper_encoder import whisper_encoder_apply
from avsr_tpu_torch.ops.ring_attention import ring_attention, ring_block_reference
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import export_params

from test_torch_checkpoint_cli import hyp_lines
from test_torch_checkpoint_cli import overrides as cli_overrides
from test_torch_models import np_tree, randomize_lora_b
from test_torch_multirank import (assert_same_run, launch, one_process_run,  # noqa: F401
                                  train_over)
from test_torch_qlora import quantized
from test_torch_tp import on_ranks
from test_torch_train import TINY_YAML, jax_paths, port_paths

torch.set_num_threads(1)

jattn = importlib.import_module("avsr_tpu.ops.attention")
tattn = importlib.import_module("avsr_tpu_torch.ops.attention")

SEEDS = (11, 12)
NO_DROPOUT = {"model.lora.dropout": 0.0}
STEP_RUNS = {   # name: (world, overrides beyond NO_DROPOUT, JAX mesh axes or None)
    "sp4": (4, {"mesh.sp": 4}, dict(dp=1, sp=4)),
    "dp2_sp2": (4, {"mesh.dp": 2, "mesh.sp": 2}, dict(dp=2, sp=2)),
    "sp4_unfreeze": (4, {"mesh.sp": 4, "model.unfreeze_layer_norms": "true"},
                     dict(dp=1, sp=4)),
    "dp2_sp2_dropout": (4, {"mesh.dp": 2, "mesh.sp": 2, "model.lora.dropout": 0.3,
                            "mesh.remat": "true"}, None),
    "fsdp2_sp2": (4, {"mesh.fsdp": 2, "mesh.sp": 2}, dict(dp=1, fsdp=2, sp=2)),
    "sp2_tp2": (4, {"mesh.sp": 2, "mesh.tp": 2}, dict(dp=1, sp=2, tp=2)),
}
PREFILL_RUNS = {"sp2": (2, {"mesh.sp": 2}), "sp2_tp2": (4, {"mesh.sp": 2, "mesh.tp": 2})}
PRESET = {"model.use_4bit": "true", "decode.lm_head_bits": 8, "decode.kv_cache_dtype": "int8"}
DECODE_RUNS = {   # name: (world, overrides beyond NO_DROPOUT, weights)
    "sp2": (2, {"mesh.sp": 2}, "float"),
    "dp2_sp2": (4, {"mesh.dp": 2, "mesh.sp": 2}, "float"),
    "preset_sp2": (2, {**PRESET, "mesh.sp": 2}, "int4"),
}
NEW_TOKENS, EOS, BEAMS = 8, 2, 3


def sp_shape(sp: int, dp: int = 1, tp: int = 1) -> dict:
    return dict(zip(sharding.AXES, (1, dp, 1, 1, sp, tp, 1)))


def jmesh(sp: int, dp: int = 1):
    return jsharding.build_mesh(jcfg.MeshConfig(dp=dp, sp=sp),
                                devices=jax.devices()[: dp * sp])


def chunk(t: torch.Tensor, n: int, r: int, dim: int = 2) -> torch.Tensor:
    return t.chunk(n, dim=dim)[r].contiguous()


# ---------------------------------------------------------------------------
# The ring's block and the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,Hkv", [(True, 2), (False, 8), (True, 8), (False, 2)])
def test_ring_block_reference_matches_jax(causal, Hkv):
    """Shifted positions (a block before, at, and after the queries'),
    GQA, and rows with no valid key (kv_len 0, and keys all past it)."""
    rng = np.random.default_rng(1)
    B, H, T, D = 3, 8, 16, 16
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    lens = np.array([0, 21, 40], np.int32)
    for q0, k0 in ((16, 0), (16, 16), (0, 16), (32, 16)):
        want = jring_block(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q0, k0,
                           jnp.asarray(lens), causal, 0.25)
        got = ring_block_reference(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), q0, k0, torch.from_numpy(lens),
                                   causal, 0.25)
        for g, w, name in zip(got, want, ("out", "m", "l")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                       err_msg=f"{name} at q0={q0} k0={k0}")


def _ring_on_ranks(sp, q, k, v, lens, causal, q_lens=None):
    """The port's ring over ``sp`` thread ranks: (O, dq, dk, dv) whole,
    with the loss of JAX's ring test, each rank its chunk's share."""
    T = q.shape[2]
    valid = (torch.arange(T)[None, :] < lens[:, None])[:, None, :, None]

    def rank(mesh):
        r = mesh.sp.rank
        xs = [chunk(t, sp, r).requires_grad_(True) for t in (q, k, v)]
        o = ring_attention(*xs, group=mesh.sp, causal=causal, kv_lens=lens, q_lens=q_lens)
        ((o * chunk(valid, sp, r)) ** 2).sum().backward()
        return o.detach(), *(x.grad for x in xs)

    outs = on_ranks(sp_shape(sp), rank)
    return [torch.cat([o[i] for o in outs], dim=2) for i in range(4)]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("group", [1, 4])
def test_ring_attention_matches_jax(sp, causal, group):
    """Forward and q/k/v gradients against JAX's ring on its sp mesh, at
    every row, atol 5e-5 (JAX's own); a kv_len inside chunk 0 (3), one of 0
    (every block of the row has lse = +inf: zeros and zero gradients, no
    NaN) and a ragged one."""
    rng = np.random.default_rng(7 + sp)
    B, H, T, D = 3, 8, 32, 16
    Hkv = H // group
    qn = rng.standard_normal((B, H, T, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    lens_n = np.array([3, 0, 27], np.int32)
    mesh = jmesh(sp)
    valid = jnp.asarray(np.arange(T)[None, :] < lens_n[:, None])[:, None, :, None]

    def jloss(q, k, v):
        o = jring_attention(q, k, v, mesh=mesh, causal=causal, kv_lens=jnp.asarray(lens_n))
        return ((o * valid) ** 2).sum(), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    q, k, v, lens = (torch.from_numpy(x) for x in (qn, kn, vn, lens_n))
    got = _ring_on_ranks(sp, q, k, v, lens, causal)
    for g, w, name in zip(got, (jo, *jg), ("o", "dq", "dk", "dv")):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=0, err_msg=name)
    assert got[0][1].abs().max() == 0 and got[1][1].abs().max() == 0
    # with q_lens the rows past it are zeros, the valid rows the same
    masked = _ring_on_ranks(sp, q, k, v, lens, causal, q_lens=lens)
    rows = (torch.arange(T)[None, :] < lens[:, None])[:, None, :, None]
    assert torch.equal(masked[0] * ~rows, torch.zeros_like(masked[0]))
    torch.testing.assert_close(masked[0] * rows, got[0] * rows, atol=1e-6, rtol=0)


def test_sp_operators_and_shift():
    """scatter_to_sp keeps the rank's chunk and gather_from_sp joins them;
    ring_shift hands rank r the chunk of rank r - 1 and its gradient goes
    back; each rank's gradient of the replicated input is its share, and
    the shares sum to the whole loss's gradient."""
    n = 4
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 3, generator=gen)
    a = torch.randn(n, 2, 2, 3, generator=gen)
    b = torch.randn(n, 2, 2, 3, generator=gen)
    w = torch.randn(2, 8, 3, generator=gen)

    def rank(mesh):
        sp, r = mesh.sp, mesh.sp.rank
        xr = x.clone().requires_grad_(True)
        c = collectives.scatter_to_sp(xr, sp, 1)
        assert torch.equal(c, chunk(x, n, r, 1))
        s = collectives.ring_shift(c, sp)
        assert torch.equal(s, chunk(x, n, (r - 1) % n, 1))
        z = collectives.gather_from_sp(c * b[r], sp, 1)
        ((s * a[r]).sum() + (z * w).sum()).backward()
        return xr.grad

    grads = on_ranks(sp_shape(n), rank)
    total = sum(grads)
    # d/dx: chunk j reaches rank j + 1 through the shift (a[j + 1]); every
    # rank's loss reads the gathered z, chunk j scaled by b[j]
    want = torch.cat([a[(j + 1) % n] + n * b[j] * chunk(w, n, j, 1) for j in range(n)], 1)
    torch.testing.assert_close(total, want)


# ---------------------------------------------------------------------------
# The stacks, the count, the fallback
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params, port params): the tiny config
    with LoRA dropout off, JAX-initialised (LoRA b randomized)."""
    jc = jload_config(TINY_YAML, {**NO_DROPOUT, "runtime.use_pallas": "never"})
    tc = tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in NO_DROPOUT.items()])
    w = randomize_lora_b(np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model)), seed=3)
    return jc, tc, w


def test_stacks_match_jax_and_one_process(tiny):
    """sp = 2: the Whisper stack (60 mel frames: 30 rows padded to 32, 16
    a rank) and the Llama stack (48 rows) equal JAX's under its sp mesh
    and the port's one process at valid rows; every rank holds the same."""
    jc, tc, w = tiny
    tp = from_numpy_tree(w, "cpu")
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, 80, 60)).astype(np.float32)
    mlens = np.array([60, 37], np.int32)
    mesh = jmesh(2)
    jw, jlens = jax.jit(lambda p, m, n: jwhisper.whisper_encoder_apply(
        p, m, jc.model.whisper, mel_lengths=n, use_pallas="never", mesh=mesh))(
        jax.tree_util.tree_map(jnp.asarray, w["whisper"]), jnp.asarray(mel), jnp.asarray(mlens))
    args = (tp["whisper"], torch.from_numpy(mel), tc.model.whisper)
    one, flens = whisper_encoder_apply(*args, mel_lengths=torch.from_numpy(mlens))
    ranks = on_ranks(sp_shape(2), lambda m: whisper_encoder_apply(
        *args, mel_lengths=torch.from_numpy(mlens), sp=m.sp)[0])
    rows = (torch.arange(one.shape[1])[None, :] < flens[:, None])[..., None]
    assert np.array_equal(np.asarray(jlens), flens.numpy())
    for got in ranks:
        torch.testing.assert_close(got * rows, one * rows, atol=1e-5, rtol=0)
        np.testing.assert_allclose((got * rows).numpy(), np.asarray(jw) * rows.numpy(),
                                   atol=1e-5, rtol=0)

    emb = rng.standard_normal((2, 48, jc.model.llm.d_model)).astype(np.float32)
    elens = np.array([48, 29], np.int32)
    jh = jax.jit(lambda p, e, n: jllama.llama_apply(
        p, jc.model.llm, inputs_embeds=e, lengths=n, lora=jc.model.lora, use_pallas="never",
        output="hidden", mesh=mesh)[0])(
        jax.tree_util.tree_map(jnp.asarray, w["llm"]), jnp.asarray(emb), jnp.asarray(elens))
    kw = dict(inputs_embeds=torch.from_numpy(emb), lengths=torch.from_numpy(elens),
              lora=tc.model.lora, output="hidden")
    one, _ = tllama.llama_apply(tp["llm"], tc.model.llm, **kw)
    ranks = on_ranks(sp_shape(2), lambda m: tllama.llama_apply(tp["llm"], tc.model.llm,
                                                               sp=m.sp, **kw)[0])
    rows = (torch.arange(48)[None, :] < torch.from_numpy(elens)[:, None])[..., None]
    for got in ranks:
        torch.testing.assert_close(got * rows, one * rows, atol=1e-5, rtol=0)
        np.testing.assert_allclose((got * rows).numpy(), np.asarray(jh) * rows.numpy(),
                                   atol=1e-5, rtol=0)


def _np_batch(B=2, mel_frames=44, prompt=(1, 7, 9), label_len=7):
    """JAX's ring tests' batch: B rows of ``mel_frames`` frames (the second
    shorter), ``prompt`` and ragged labels."""
    rng = np.random.default_rng(0)
    return dict(mel=rng.standard_normal((B, 80, mel_frames)).astype(np.float32),
                mel_lens=np.array([mel_frames, 30][:B], np.int32),
                prompt_tokens=np.tile(np.array(prompt, np.int32), (B, 1)),
                labels=rng.integers(0, 64, (B, label_len)).astype(np.int32),
                label_lens=np.array([label_len, 4][:B], np.int32))


def test_ring_count_equals_jax(tiny):
    """One forward of the tiny model at sp = 2 (32 Whisper rows, 32 packed
    rows): the port rings where JAX rings, once per Whisper and Llama
    block (the threads share the counter: each rank counts its own)."""
    jc, tc, w = tiny
    b = _np_batch()
    mesh = jmesh(2)
    before = jattn.ring_dispatch_count      # counted as JAX traces the forward
    jloss, _ = jax.jit(lambda p, bb: javsr.forward(p, jc.model, bb, use_pallas="never",
                                                   mesh=mesh))(
        jax.tree_util.tree_map(jnp.asarray, w),
        javsr.Batch(**{k: jnp.asarray(v) for k, v in b.items()}))
    want = jattn.ring_dispatch_count - before
    tb = tavsr.Batch(**{k: torch.from_numpy(v) for k, v in b.items()})
    tp = from_numpy_tree(w, "cpu")
    before = tattn.ring_dispatch_count
    losses = on_ranks(sp_shape(2), lambda m: tavsr.forward(tp, tc.model, tb, sp=m.sp)[0])
    got = (tattn.ring_dispatch_count - before) / 2
    assert want == got == jc.model.whisper.n_layers + jc.model.llm.n_layers
    one, _ = tavsr.forward(tp, tc.model, tb)
    np.testing.assert_allclose(float(sum(losses)), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(sum(losses)), float(one), rtol=1e-5)


def test_sp3_falls_back_with_jax_warning(tiny, caplog):
    """sp = 3 over 32 Whisper rows: JAX's ring would not engage, so the
    stack runs whole on every rank, equal to the unsharded stack, and
    JAX's warning is logged once (the fallback makes no collective, so the
    ranks run one after another here)."""
    jc, tc, w = tiny
    tp = from_numpy_tree(w, "cpu")
    mel = torch.from_numpy(_np_batch()["mel"])
    one, _ = whisper_encoder_apply(tp["whisper"], mel, tc.model.whisper)
    tattn._ring_fallback_warned.clear()
    jattn._ring_fallback_warned.clear()
    with caplog.at_level(logging.WARNING):
        outs = [whisper_encoder_apply(tp["whisper"], mel, tc.model.whisper,
                                      sp=collectives.EchoGroup(3, r))[0] for r in range(3)]
        mine = [r.getMessage() for r in caplog.records if "ring attention fell back" in
                r.getMessage()]
        caplog.clear()
        jq = jnp.zeros((1, 2, 32, 16))
        jattn.attention(jq, jq, jq, use_pallas="never", mesh=jmesh(3))
        theirs = [r.getMessage() for r in caplog.records if "ring attention fell back" in
                  r.getMessage()]
    for out in outs:
        assert torch.equal(out, one)
    assert len(mine) == 1 and mine == theirs, (mine, theirs)


def test_config_refusals_and_groups():
    """mesh.sp loads, and so do mesh.pp (with JAX's dropout message at
    the default LoRA dropout) and mesh.ep with MoE; pp with sp keeps JAX's
    message; MoE under sp is accepted (it routes over the ring's chunks,
    ``tests/test_torch_ep.py``); the sp and sums groups of dp=2 sp=2 tp=2
    are JAX's device-grid coordinates."""
    assert tcfg.load_config(None, ["mesh.sp=2"]).mesh.sp == 2
    with pytest.raises(ValueError) as theirs:
        jload_config(None, {"mesh.pp": 2, "mesh.sp": 2})
    with pytest.raises(ValueError) as mine:
        tcfg.load_config(None, ["mesh.pp=2", "mesh.sp=2"])
    assert str(mine.value) == str(theirs.value) == "mesh.pp and mesh.sp are mutually exclusive"
    for over in ("mesh.pp=2", "mesh.ep=2 model.connector_type=moe"):
        if over == "mesh.pp=2":
            with pytest.raises(ValueError, match="lora.dropout > 0"):
                tcfg.load_config(None, over.split())
            assert tcfg.load_config(None, [over, "model.lora.dropout=0"]).mesh.pp == 2
        else:
            assert tcfg.load_config(None, over.split()).mesh.ep == 2
    moe = tcfg.load_config(None, ["mesh.sp=2", "model.connector_type=moe",
                                  "model.llm.moe_experts=4"])
    assert moe.mesh.sp == 2 and moe.model.llm.moe_experts == 4
    jm = jsharding.build_mesh(jcfg.MeshConfig(dp=2, sp=2, tp=2), devices=jax.devices()[:8])
    ids = {d.id: i for i, d in enumerate(jax.devices()[:8])}
    grid = np.vectorize(lambda d: ids[d.id])(jm.devices)
    names = list(jm.axis_names)
    got = sharding.mesh_groups(sharding.mesh_shape(tcfg.MeshConfig(dp=2, sp=2, tp=2), 8))
    for group, vary in (("sp", ["sp"]), ("sums", ["dcn", "dp", "fsdp", "ep", "sp"]),
                        ("replica", ["dcn", "dp", "ep", "sp"])):
        keep = [i for i, a in enumerate(names) if a not in vary]
        idx = [names.index(a) for a in vary]
        want = np.transpose(grid, keep + idx).reshape(
            -1, int(np.prod([grid.shape[i] for i in idx]))).tolist()
        assert got[group] == want, group
    assert got["sp"] == [[0, 2], [1, 3], [4, 6], [5, 7]]


# ---------------------------------------------------------------------------
# Whole slices across gloo processes
# ---------------------------------------------------------------------------

def _dec_argv(tmp, dec_dir, *mesh):
    return ["--device", "cpu", *cli_overrides(tmp / "unused", dec_dir,
                                              **{"decode.batch_size": 4}), *mesh,
            "--checkpoint", str(tmp / "texport"), "--split", "train"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny):
    """Every multi-process run of this file (2 ranks in one job, 4 in
    another) and the inputs they read."""
    _, _, w = tiny
    tmp = tmp_path_factory.mktemp("sp")
    torch.save(from_numpy_tree(w, "cpu"), tmp / "w.pt")
    torch.save(from_numpy_tree(quantized(w, 4), "cpu"), tmp / "w4.pt")
    files = {"float": tmp / "w.pt", "int4": tmp / "w4.pt"}
    b = _np_batch()
    np.savez(tmp / "step.npz", **{k: v[None] for k, v in b.items()})
    np.savez(tmp / "dec.npz", **_np_batch(prompt=(1, 7)))
    cli_w = np_tree(javsr.init_avsr_model(
        jax.random.key(4), jload_config(None, cli_overrides(tmp / "r", tmp / "d")).model))
    export_params(from_numpy_tree(cli_w, "cpu"), tmp / "texport")

    jobs: dict[int, list] = {2: [], 4: []}
    for name, (world, extra, _) in STEP_RUNS.items():
        over = [f"{k}={v}" for k, v in {**NO_DROPOUT, **extra}.items()]
        jobs[world].append(dict(kind="step", overrides=over, weights=str(tmp / "w.pt"),
                                batch=str(tmp / "step.npz"), seeds=list(SEEDS),
                                out=str(tmp / f"{name}.pt")))
    for name, (world, extra) in PREFILL_RUNS.items():
        over = [f"{k}={v}" for k, v in {**NO_DROPOUT, **extra}.items()]
        jobs[world].append(dict(kind="prefill", overrides=over, weights=str(tmp / "w.pt"),
                                batch=str(tmp / "dec.npz"), new_tokens=NEW_TOKENS, eos=EOS,
                                out=str(tmp / f"{name}_rank{{rank}}.pt")))
    for name, (world, extra, wname) in DECODE_RUNS.items():
        over = [f"{k}={v}" for k, v in {**NO_DROPOUT, **extra}.items()]
        jobs[world].append(dict(kind="decode", overrides=over, weights=str(files[wname]),
                                batch=str(tmp / "dec.npz"), eos=EOS, new_tokens=NEW_TOKENS,
                                beam_tokens=NEW_TOKENS, beams=BEAMS,
                                spec=[0] if wname == "float" else [],
                                out=str(tmp / f"dec_{name}_rank{{rank}}.pt")))
    jobs[2] += [
        dict(kind="probe", out=str(tmp / "probe.json")),
        dict(kind="cli", cli="train",
             argv=["--device", "cpu", *train_over(tmp / "run_sp2", 2, ("mesh.sp=2",))]),
        dict(kind="cli", cli="decode", argv=_dec_argv(tmp, tmp / "dec_sp2", "mesh.sp=2"))]
    for world, job in jobs.items():
        launch(world, job, tmp)
    return tmp


def _jax_steps(jc, w, axes: dict):
    """JAX's steps of SEEDS on its mesh of ``axes``: (metrics, LoRA b)."""
    jc = dataclasses.replace(jc, mesh=dataclasses.replace(jc.mesh, **axes))
    n = int(np.prod(list(axes.values())))
    mesh = jsharding.build_mesh(jc.mesh, devices=jax.devices()[:n])
    state, tx = jstate.create_train_state(jax.tree_util.tree_map(jnp.asarray, w), jc,
                                          total_steps=10)
    step = jstep.make_train_step(jc, tx, mesh)
    batch = javsr.Batch(**{k: jnp.asarray(v[None]) for k, v in _np_batch().items()})
    metrics = []
    for seed in SEEDS:
        state, m = step(state, batch, jax.random.key(seed))
        metrics.append({k: float(v) for k, v in m.items()})
    train = jax_paths(jstate.partition_trainable(state.params, jc.model)[0])
    return metrics, {k: np.asarray(v) for k, v in train.items()}


def _one_process(extra: dict, w):
    tc = tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in {**NO_DROPOUT, **extra}.items()
                                      if not k.startswith("mesh.")])
    params = tstate.cast_frozen(from_numpy_tree(w, "cpu"), tc.model, torch.float32)
    state = tstate.create_train_state(params, tc, 10)
    step = tstep.make_train_step(tc)
    batch = tavsr.Batch(**{k: torch.from_numpy(v[None]) for k, v in _np_batch().items()})
    metrics = [step(state, batch, seed) for seed in SEEDS]
    return metrics, port_paths(tstate.partition_trainable(state.params, tc.model)[0])


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_sp_train_steps(runs, tiny, name):
    """Each run's 2 steps against the port's one process (loss |d| 1e-5,
    grad norm 1e-5 relative, every trained leaf atol 1e-6) and, without
    dropout, against JAX's step on its mesh of the same axes (loss rtol
    1e-5, grad norm rtol 1e-4, LoRA b atol 1e-6)."""
    jc, _, w = tiny
    world, extra, axes = STEP_RUNS[name]
    got = torch.load(runs / f"{name}.pt", weights_only=False)
    assert got["shape"]["sp"] == extra["mesh.sp"]
    metrics, leaves = _one_process(extra, w)
    for g, m in zip(got["metrics"], metrics):
        assert abs(g["loss"] - m["loss"]) < 1e-5, (g, m)
        assert abs(g["grad_norm"] - m["grad_norm"]) <= 1e-5 * m["grad_norm"], (g, m)
        assert g["skipped"] == m["skipped"] == 0
    assert got["leaves"].keys() == {"/".join(k) for k in leaves}
    if extra.get("model.unfreeze_layer_norms"):
        tuned = [k for k in got["leaves"] if k.startswith("whisper/")]
        assert any("/blocks/" in k for k in tuned) and "whisper/ln_post/scale" in tuned
    for k, v in leaves.items():
        torch.testing.assert_close(got["leaves"]["/".join(k)], v.detach(), atol=1e-6,
                                   rtol=0, msg=lambda m, k=k: f"{k}: {m}")
    if axes is None:
        return
    jm, jleaves = _jax_steps(jload_config(TINY_YAML, {**NO_DROPOUT, **{
        k: v for k, v in extra.items() if not k.startswith("mesh.")}}), w, axes)
    for g, m in zip(got["metrics"], jm):
        np.testing.assert_allclose(g["loss"], m["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], m["grad_norm"], rtol=1e-4)
    bs = [k for k in jleaves if k[-1] == "b"]
    assert bs
    for k in bs:
        np.testing.assert_allclose(got["leaves"]["/".join(k)].numpy(), jleaves[k],
                                   atol=1e-6, rtol=0, err_msg=str(k))


@pytest.mark.parametrize("name", list(PREFILL_RUNS))
def test_sp_decode_matches_jax_and_one_process(runs, tiny, name):
    """JAX's sp decode setup (prompt 2 + 22 Whisper features: a 24-row
    prefix): every rank's greedy tokens equal JAX's ``generate_tokens`` and
    one process's, the ring engaged in the prefill (the Whisper and Llama
    blocks, no fallback), and each rank's KV cache is one process's (its
    kv heads under tp)."""
    jc, tc, w = tiny
    world, extra = PREFILL_RUNS[name]
    b = _np_batch(prompt=(1, 7))
    jout = jgenerate_tokens(jax.tree_util.tree_map(jnp.asarray, w), jc.model,
                            javsr.Batch(**{k: jnp.asarray(v) for k, v in b.items()}),
                            max_new_tokens=NEW_TOKENS, eos_id=EOS, use_pallas="never")
    params = tgen.prepare_params_for_decode(from_numpy_tree(w, "cpu"), tc.model)
    tb = tavsr.Batch(**{k: torch.from_numpy(v) for k, v in b.items()})
    one = tgen.generate_tokens(params, tc.model, tb, max_new_tokens=NEW_TOKENS, eos_id=EOS)
    enc = tavsr.encode(params, tc.model, tb, moe_rowwise=True)
    prefix, lens = tavsr.build_prefix(params, tc.model, tb, enc)
    assert prefix.shape[1] == 24
    _, cache = tllama.llama_apply(params["llm"], tc.model.llm, inputs_embeds=prefix,
                                  lengths=lens, lora=tc.model.lora, return_cache=True,
                                  output="hidden")
    assert np.array_equal(one.tokens.numpy(), np.asarray(jout.tokens))
    nkv = tc.model.llm.n_kv_heads // extra.get("mesh.tp", 1)
    for r in range(world):
        got = torch.load(runs / f"{name}_rank{r}.pt", weights_only=False)
        assert got["rings"] == 2 and got["fallbacks"] == [], got["rings"]
        lo, hi = got["rows"]
        assert np.array_equal(got["tokens"].numpy(), np.asarray(jout.tokens)[lo:hi])
        assert torch.equal(got["lengths"], one.lengths[lo:hi])
        h = (r % extra.get("mesh.tp", 1)) * nkv
        for key, full in (("k", cache.k), ("v", cache.v)):
            torch.testing.assert_close(got[key], full[:, lo:hi, h: h + nkv], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(DECODE_RUNS))
def test_sp_decodes_equal_one_process(runs, tiny, name):
    """Greedy decoding, beam search and, in f32, speculative decoding with
    the int8 self-draft under ``sp=2`` and ``dp=2 sp=2``, and the serving
    preset under ``sp=2`` (int4, the int8 head, an int8 cache gathered
    whole; the qmatmul's plain version): every rank's tokens on its rows
    are one process's, its prefill logits within 1e-5."""
    _, _, w = tiny
    world, extra, wname = DECODE_RUNS[name]
    tc = tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in {**NO_DROPOUT, **extra}.items()
                                      if not k.startswith("mesh.")])
    raw = from_numpy_tree(w if wname == "float" else quantized(w, 4), "cpu")
    params = tgen.prepare_params_for_decode(raw, tc.model, tc.decode.lm_head_bits)
    b = tavsr.Batch(**{k: torch.from_numpy(v) for k, v in _np_batch(prompt=(1, 7)).items()})
    kw = dict(eos_id=EOS, kv_cache_dtype=tc.decode.kv_cache_dtype,
              use_kernel=tc.runtime.use_pallas)
    stats: dict = {}
    greedy = tgen.generate_tokens(params, tc.model, b, max_new_tokens=NEW_TOKENS, stats=stats,
                                  **kw)
    beam = tgen.beam_search(params, tc.model, b, num_beams=BEAMS, max_new_tokens=NEW_TOKENS,
                            **kw)
    spec = (tspec.speculative_generate(params, tspec.make_draft_params(raw, tc.model, bits=8),
                                       tc.model, b, gamma=3, max_new_tokens=NEW_TOKENS,
                                       eos_id=EOS, use_kernel=tc.runtime.use_pallas).tokens
            if wname == "float" else None)
    for r in range(world):
        got = torch.load(runs / f"dec_{name}_rank{r}.pt", weights_only=False)
        rows = slice(*got["rows"])
        assert got["shape"]["sp"] == 2
        assert torch.equal(got["greedy"], greedy.tokens[rows])
        assert torch.equal(got["beam"], beam.tokens[rows])
        torch.testing.assert_close(got["prefill_logits"], stats["prefill_logits"][rows],
                                   atol=1e-5, rtol=0)
        if spec is not None:
            assert torch.equal(got["spec"][0], spec[rows])


def test_probe_lists_the_shift(runs):
    takes = json.loads((runs / "probe.json").read_text())
    want = {f"{n}_{dt}" for n, (_, dts) in collectives.BACKEND_TABLE.items() for dt in dts}
    assert {"shift_float32", "shift_bfloat16", "sp_operators_float32"} <= set(takes)
    assert want <= set(takes) and all(v == "yes" for v in takes.values()), takes


def test_sp_train_cli_resumes_at_world_one(runs, one_process_run):  # noqa: F811
    """A 2-rank train CLI run under sp=2 (2 steps, validation and
    in-training WER every epoch) checkpoints the whole tree and resumes at
    world 1 to a third step: one process's run; rank 0 alone wrote the
    log."""
    run = runs / "run_sp2"
    rows = (run / "loss_log.csv").read_text().splitlines()
    assert [r.split(",")[2] for r in rows[1:]] == ["train", "val", "val_wer"] * 2
    assert tcli_train.main(["--device", "cpu", *train_over(run, 3)]) == 0
    assert_same_run(run, one_process_run)


def test_sp_decode_cli_equals_one_process(runs, tmp_path):
    assert tcli_decode.main(_dec_argv(runs, tmp_path / "dec1")) == 0
    two = hyp_lines(runs / "dec_sp2")
    assert len(two) == 8 and two == hyp_lines(tmp_path / "dec1")
