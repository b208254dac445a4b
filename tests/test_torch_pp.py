"""Pipeline parallelism (``mesh.pp``) of the port on the CPU, against one
process and the JAX package's pp mesh (GPipe over the Llama stack).

Unit parity, in one process (the stages as threads over
``test_torch_tp.ThreadGroup``):

  * ``pipeline_apply`` at S = 2 and 4 on ``tests/test_pipeline.py``'s setup
    (8 rows, 2 layers a stage, a per-row scale as the side input) equals
    JAX's ``pipeline_apply`` on its virtual mesh and the serial loop: in
    float64 the forward (atol 1e-5) and the gradients of x and of every
    layer, summed over the stages (each rank's loss a 1/S share), rtol
    2e-6, atol 1e-4 (JAX's own); in float32 the forward; a rank's rows split into the most equal microbatches up to S
    that divide them (6 rows of a global 12 at S = 4: 3; 2 of a global 4:
    2), equal to the serial loop too; JAX's messages for layers and a
    global batch that do not divide;
  * the Llama stack pipelined at pp = 2 equals one process's at every row,
    and LoRA dropout in a pipelined forward logs JAX's warning once.

Whole slices, f32, as gloo subprocesses (``torch_multirank_worker.py``):

  * JAX's ``test_pp_train_step_matches_pp1`` setup (the tiny config with 4
    LLM layers and LoRA dropout off, B = 4 with ragged mel and label
    lengths, LoRA b randomized) at ``pp=4``, ``dp=2 pp=2`` (with remat),
    ``fsdp=2 pp=2``, ``pp=2 tp=2`` and ``pp=2`` with
    ``unfreeze_layer_norms`` and the whole LLM trained (the encoders' norms
    before the stages, the blocks in them, ``ln_f`` and the tied embedding
    after their return):
    2 steps each equal the port's one process (loss |d| 1e-5, grad norm
    1e-5 relative, every trained leaf atol 1e-6), which equals JAX's
    unsharded step (loss rtol 1e-5, grad norm rtol 1e-4, LoRA b atol 1e-6);
  * the same setup at ``dp=2 pp=4`` (8 ranks: a data rank's 2 rows make 2
    microbatches, where JAX's pipeline makes 4 of the global 4) equals
    JAX's step on its ``dp=2 pp=4`` mesh, and JAX's
    ``test_pp_composes_with_tp_fsdp`` setup (2 LLM layers of 64) at
    ``fsdp=2 tp=2 pp=2`` (8 ranks) equals JAX's step on its mesh of those
    axes and one process;
  * the eval step under ``pp=2`` equals one process's;
  * ``probe_backend`` lists the pipeline's operators, and gloo takes them;
  * the train CLI under ``pp=2`` (2 steps, validation and in-training WER;
    the whole 2-layer LLM trained with adafactor) resumes at world 1 to one
    process's run; the decode CLI under ``pp=2`` writes one process's HYP
    lines;
  * the config raises JAX's four pp messages with JAX's text, and the pp
    group is JAX's device-grid coordinates.

Each multi-process job has its own time limit (``launch``), so a hang in a
backward schedule fails its tests quickly instead of the suite's cap.
"""

import dataclasses
import functools
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core import config as jcfg
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.mesh import sharding as jsharding
from avsr_tpu.models import avsr as javsr
from avsr_tpu.models import llama as jllama
from avsr_tpu.ops.pipeline import pipeline_apply as jpipeline_apply
from avsr_tpu.ops.pipeline import stack_stages as jstack_stages
from avsr_tpu.train import state as jstate
from avsr_tpu.train import step as jstep
from avsr_tpu_torch.cli import decode as tcli_decode
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.mesh import collectives, sharding
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.models import llama as tllama
from avsr_tpu_torch.ops import pipeline as tpipeline
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import export_params

from test_torch_checkpoint_cli import hyp_lines
from test_torch_checkpoint_cli import overrides as cli_overrides
from test_torch_models import np_tree, randomize_lora_b
from test_torch_multirank import assert_same_run, launch, train_over
from test_torch_tp import on_ranks
from test_torch_train import TINY_YAML, jax_paths, port_paths

torch.set_num_threads(1)

SEEDS = (11, 12)
# JAX's test_pp_train_step_matches_pp1 config: tiny_avsr_cfg is tiny_cpu.yaml
# with warmup_steps=2; 4 LLM layers, LoRA dropout off
SETUPS = {
    "pp1": {"model.llm.n_layers": 4, "model.lora.dropout": 0.0, "training.warmup_steps": 2},
    # test_pp_composes_with_tp_fsdp's LLM
    "tp_fsdp": {"model.llm.n_layers": 2, "model.llm.n_heads": 4, "model.llm.n_kv_heads": 2,
                "model.llm.d_model": 64, "model.llm.ffn_dim": 128, "model.lora.dropout": 0.0,
                "training.warmup_steps": 2},
}
# the encoders' norms (before the stack, stage 0's gradient) and the whole
# LLM: its blocks (a stage's), ln_f and the tied embedding (after the
# return: every stage's share; the embedding also stage 0's lookups)
UNFREEZE = {"model.unfreeze_layer_norms": "true", "model.freeze_llm": "false"}
STEP_RUNS = {   # name: (world, setup, overrides beyond it, JAX mesh axes or None)
    "pp4": (4, "pp1", {"mesh.pp": 4}, None),
    "dp2_pp2": (4, "pp1", {"mesh.dp": 2, "mesh.pp": 2, "mesh.remat": "true"}, None),
    "fsdp2_pp2": (4, "pp1", {"mesh.fsdp": 2, "mesh.pp": 2}, None),
    "pp2_tp2": (4, "pp1", {"mesh.pp": 2, "mesh.tp": 2}, None),
    "pp2_unfreeze": (2, "pp1", {"mesh.pp": 2, **UNFREEZE}, None),
    "dp2_pp4": (8, "pp1", {"mesh.dp": 2, "mesh.pp": 4}, dict(dp=2, pp=4)),
    "fsdp2_tp2_pp2": (8, "tp_fsdp", {"mesh.fsdp": 2, "mesh.tp": 2, "mesh.pp": 2},
                      dict(dp=1, fsdp=2, tp=2, pp=2)),
}
JOB_TIMEOUT_S = {2: 240, 4: 240, 8: 300}
CLI_LAYERS = ("model.llm.n_layers=2",)


def pp_shape(pp: int, dp: int = 1) -> dict:
    return dict(zip(sharding.AXES, (1, dp, 1, 1, 1, 1, pp)))


def _over(d: dict) -> list[str]:
    return [f"{k}={v}" for k, v in d.items()]


def _batch() -> dict[str, np.ndarray]:
    """JAX's pp test batch: 4 rows of 44 mel frames (ragged), the prompt
    [1, 7, 9], 7 labels (ragged)."""
    rng = np.random.default_rng(0)
    B = 4
    return dict(mel=rng.standard_normal((B, 80, 44)).astype(np.float32),
                mel_lens=np.array([44, 30, 44, 36], np.int32),
                prompt_tokens=np.tile(np.array([1, 7, 9], np.int32), (B, 1)),
                labels=rng.integers(0, 64, (B, 7)).astype(np.int32),
                label_lens=np.array([7, 4, 6, 5], np.int32))


@functools.lru_cache(maxsize=None)
def _weights(setup: str) -> dict:
    """JAX-initialised weights of ``setup`` (LoRA b randomized), numpy."""
    jc = jload_config(TINY_YAML, SETUPS[setup])
    return randomize_lora_b(np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model)), seed=3)


@functools.lru_cache(maxsize=None)
def _jax_steps(setup: str, axes: tuple = ()):
    """JAX's steps of SEEDS (unsharded, or on its mesh of ``axes``, the
    state and batch sharded as its fsdp/tp test shards them): (metrics,
    trained leaves). Computed once per module."""
    jc = jload_config(TINY_YAML, {**SETUPS[setup], "runtime.use_pallas": "never"})
    mesh = None
    if axes:
        jc = dataclasses.replace(jc, mesh=dataclasses.replace(jc.mesh, **dict(axes)))
        n = int(np.prod([v for _, v in axes]))
        mesh = jsharding.build_mesh(jc.mesh, devices=jax.devices()[:n])
    state, tx = jstate.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, _weights(setup)), jc, total_steps=10)
    batch = javsr.Batch(**{k: jnp.asarray(v[None]) for k, v in _batch().items()})
    if mesh is not None and (jc.mesh.fsdp > 1 or jc.mesh.tp > 1):
        state = jsharding.shard_state(state, mesh)
        batch = jsharding.batch_sharder(mesh)(batch)
    step = jstep.make_train_step(jc, tx, mesh)
    metrics = []
    for seed in SEEDS:
        state, m = step(state, batch, jax.random.key(seed))
        metrics.append({k: float(v) for k, v in m.items()})
    train = jax_paths(jstate.partition_trainable(state.params, jc.model)[0])
    return metrics, {k: np.asarray(v) for k, v in train.items()}


@functools.lru_cache(maxsize=None)
def _one_process(setup: str, unfreeze: bool = False):
    """The port's one-process steps of SEEDS: (metrics, trained leaves,
    the eval step's metrics on the batch before them)."""
    over = {**SETUPS[setup], **(UNFREEZE if unfreeze else {})}
    tc = tcfg.load_config(TINY_YAML, _over(over))
    params = tstate.cast_frozen(from_numpy_tree(_weights(setup), "cpu"), tc.model,
                                torch.float32)
    state = tstate.create_train_state(params, tc, 10)
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    evals = tstep.make_eval_step(tc)(state.params, tavsr.Batch(**b))
    step = tstep.make_train_step(tc)
    batch = tavsr.Batch(**{k: v[None] for k, v in b.items()})
    metrics = [step(state, batch, seed) for seed in SEEDS]
    return metrics, port_paths(tstate.partition_trainable(state.params, tc.model)[0]), evals


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------

def _setup(S: int, B: int = 8, seed: int = 0):
    """``test_pipeline_matches_serial``'s layers (2 a stage), x and scale."""
    rng = np.random.default_rng(seed)
    Lps, d, T = 2, 16, 6
    w = [(rng.standard_normal((d, d)) * 0.2).astype(np.float32) for _ in range(S * Lps)]
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    scale = rng.standard_normal((B,)).astype(np.float32)
    return w, x, scale


def _stage(stage, x_mb, scale_mb):
    for lp in stage:
        x_mb = torch.tanh(x_mb @ lp["w"]) + x_mb
    return x_mb * scale_mb[:, None, None]


def _serial(w, x, scale, S):
    Lps = len(w) // S
    for i in range(0, len(w), Lps):
        x = _stage([{"w": t} for t in w[i:i + Lps]], x, scale)
    return x


def _pipelined(w, x, scale, S, global_rows=None):
    """Each thread rank's (output, x's gradient or None, the layers'
    gradients), with the loss (out ** 2).sum() / S on each rank."""
    def rank(mesh):
        layers = [{"w": torch.from_numpy(t).requires_grad_(True)} for t in w]
        xr = torch.from_numpy(x).requires_grad_(True)
        out = tpipeline.pipeline_apply(_stage, layers, xr, torch.from_numpy(scale),
                                       group=mesh.pp, global_rows=global_rows)
        ((out ** 2).sum() / S).backward()
        return out.detach(), xr.grad, [lp["w"].grad for lp in layers]

    return on_ranks(pp_shape(S), rank)


def _summed(grads):
    present = [g for g in grads if g is not None]
    return sum(present[1:], present[0])


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_apply_matches_jax_and_serial(S):
    """JAX's draws (``test_pipeline_matches_serial``'s at S = 4), in
    float64: the forward (atol 1e-5) and every layer's and x's gradient,
    summed over the stages (rtol 2e-6, atol 1e-4), against JAX's pipeline
    on its virtual mesh and the serial loop; in float32 the forward (atol
    1e-5). The gradients are held in float64 because JAX's tolerance is one
    for a comparison inside one package: in float32 the port's and JAX's
    serial loops alone differ by up to 1.7x it (gradients in the hundreds).
    A layer's gradient lives on the stage that runs it, x's on stage 0."""
    mesh = jsharding.build_mesh(jcfg.MeshConfig(dp=1, pp=S), devices=jax.devices()[:S])

    def jstage(lp_stack, x_mb, scale_mb):
        def body(xx, lp):
            return jnp.tanh(xx @ lp["w"]) + xx, None
        out, _ = jax.lax.scan(body, x_mb, lp_stack)
        return out * scale_mb[:, None, None]

    for dtype in (np.float64, np.float32):
        w, x, scale = (np.asarray(a, dtype) if not isinstance(a, list)
                       else [t.astype(dtype) for t in a] for a in _setup(S))
        with jax.enable_x64(dtype == np.float64):
            def jloss(layers, xx):
                out = jpipeline_apply(jstage, jstack_stages(layers, S), xx, jnp.asarray(scale),
                                      mesh=mesh)
                return (out ** 2).sum(), out

            (_, jout), (jg_layers, jg_x) = jax.jit(jax.value_and_grad(
                jloss, argnums=(0, 1), has_aux=True))([{"w": jnp.asarray(t)} for t in w],
                                                      jnp.asarray(x))
            jout, jg_x = np.asarray(jout), np.asarray(jg_x)
            jg_layers = [np.asarray(g["w"]) for g in jg_layers]
        assert jout.dtype == dtype
        tw = [torch.from_numpy(t).requires_grad_(True) for t in w]
        tx = torch.from_numpy(x).requires_grad_(True)
        ser = _serial(tw, tx, torch.from_numpy(scale), S)
        (ser ** 2).sum().backward()

        ranks = _pipelined(w, x, scale, S)
        for out, _, _ in ranks:     # JAX's test's assert_allclose(atol=1e-5)
            np.testing.assert_allclose(out.numpy(), jout, atol=1e-5)
            np.testing.assert_allclose(out.numpy(), ser.detach().numpy(), atol=1e-5)
        assert [g is not None for _, g, _ in ranks] == [True] + [False] * (S - 1)
        for i in range(S * 2):
            assert [gs[i] is not None for _, _, gs in ranks] == [r == i // 2 for r in range(S)]
        if dtype == np.float32:
            continue
        gx = _summed([g for _, g, _ in ranks]).numpy()
        for want in (jg_x, tx.grad.numpy()):
            np.testing.assert_allclose(gx, want, rtol=2e-6, atol=1e-4)
        for i in range(S * 2):
            g = _summed([gs[i] for _, _, gs in ranks]).numpy()
            for want in (jg_layers[i], tw[i].grad.numpy()):
                np.testing.assert_allclose(g, want, rtol=2e-6, atol=1e-4, err_msg=f"layer {i}")


@pytest.mark.parametrize("rows,global_rows,micro", [(6, 12, 3), (2, 4, 2), (5, 20, 1)])
def test_rank_rows_split_into_fewer_microbatches(rows, global_rows, micro):
    """A rank's rows (of a global batch that JAX's check accepts at S = 4)
    split into the most equal microbatches up to 4 that divide them; the
    output and the gradients equal the serial loop's (float64, at JAX's
    tolerances)."""
    S = 4
    assert tpipeline.split_count(rows, global_rows, S) == micro
    w, x, scale = (np.asarray(a, np.float64) if not isinstance(a, list)
                   else [t.astype(np.float64) for t in a] for a in _setup(S, B=rows, seed=rows))
    tw = [torch.from_numpy(t).requires_grad_(True) for t in w]
    tx = torch.from_numpy(x).requires_grad_(True)
    ser = _serial(tw, tx, torch.from_numpy(scale), S)
    (ser ** 2).sum().backward()
    ranks = _pipelined(w, x, scale, S, global_rows=global_rows)
    for out, _, _ in ranks:
        torch.testing.assert_close(out, ser.detach(), atol=1e-5, rtol=0)
    torch.testing.assert_close(_summed([g for _, g, _ in ranks]), tx.grad, atol=1e-4,
                               rtol=2e-6)
    for i in range(S * 2):
        torch.testing.assert_close(_summed([gs[i] for _, _, gs in ranks]), tw[i].grad,
                                   atol=1e-4, rtol=2e-6)


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_pipeline_messages_are_jax():
    """Layers that do not divide into the stages, and a global batch that
    does not divide into the microbatches, raise JAX's messages."""
    layers = [{"w": np.zeros((2, 2), np.float32)} for _ in range(6)]
    assert (_message(lambda: tpipeline.stage_layers(layers, 4, 0))
            == _message(lambda: jstack_stages(layers, 4)) == "6 layers not divisible by pp=4")
    mesh = jsharding.build_mesh(jcfg.MeshConfig(dp=1, pp=4), devices=jax.devices()[:4])
    want = _message(lambda: jpipeline_apply(lambda p, xx: xx, jstack_stages(layers[:4], 4),
                                            jnp.zeros((6, 2)), mesh=mesh))
    assert want == "batch 6 not divisible by microbatches 4"
    assert _message(lambda: tpipeline.split_count(3, 6, 4)) == want


def test_pipelined_llama_equals_one_process_and_warns(caplog):
    """The tiny Llama stack (4 layers) at pp = 2 over 4 rows of ragged
    lengths: every stage returns one process's hidden states; with LoRA
    dropout asked for, a pipelined forward runs without it and logs JAX's
    warning once."""
    w = _weights("pp1")
    tc = tcfg.load_config(TINY_YAML, _over({**SETUPS["pp1"], "model.lora.dropout": 0.3}))
    llm = from_numpy_tree(w["llm"], "cpu")
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.standard_normal((4, 20, tc.model.llm.d_model)).astype(np.float32))
    lens = torch.tensor([20, 13, 7, 16], dtype=torch.int32)
    kw = dict(inputs_embeds=emb, lengths=lens, lora=tc.model.lora, output="hidden")
    one, _ = tllama.llama_apply(llm, tc.model.llm, **kw)
    outs = on_ranks(pp_shape(2), lambda m: tllama.llama_apply(
        llm, tc.model.llm, dropout_seed=5, pp=m.pp, global_rows=4, **kw)[0])
    for out in outs:
        torch.testing.assert_close(out, one, atol=1e-5, rtol=0)
    # the warning, in one process (stage 0 over a group that never talks)
    tllama._pp_dropout_warned = False
    jllama._pp_dropout_warned = False
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            tllama.llama_apply(llm, tc.model.llm, dropout_seed=5,
                               pp=collectives.EchoGroup(2, 0), **kw)
        mine = [r.getMessage() for r in caplog.records if "mesh.pp" in r.getMessage()]
        caplog.clear()
        jllama._warn_pp_dropout()
        theirs = [r.getMessage() for r in caplog.records if "mesh.pp" in r.getMessage()]
    assert len(mine) == 1 and mine == theirs


# ---------------------------------------------------------------------------
# The config and the groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", [
    {"mesh.pp": 2, "mesh.sp": 2}, {"mesh.pp": 3}, {"mesh.pp": 2},
    {"mesh.pp": 2, "model.llm.moe_experts": 4, "model.lora.dropout": 0.0}],
    ids=["pp_sp", "layers", "dropout", "moe"])
def test_config_raises_jax_pp_messages(over):
    """The four pp refusals of JAX's validate, with its text; pp loads with
    dropout off, and so does the ``moe`` connector under pp with ep."""
    with pytest.raises(ValueError) as theirs:
        jload_config(None, over)
    with pytest.raises(ValueError) as mine:
        tcfg.load_config(None, _over(over))
    assert str(mine.value) == str(theirs.value)
    assert tcfg.load_config(None, ["mesh.pp=2", "model.lora.dropout=0"]).mesh.pp == 2
    cfg = tcfg.load_config(None, ["mesh.ep=2", "mesh.pp=2", "model.lora.dropout=0",
                                  "model.connector_type=moe"])
    assert (cfg.mesh.ep, cfg.mesh.pp) == (2, 2)


@pytest.mark.parametrize("axes", [dict(dp=2, pp=4), dict(fsdp=2, tp=2, pp=2)],
                         ids=["dp2_pp4", "fsdp2_tp2_pp2"])
def test_pp_groups_are_jax_device_grid_coordinates(axes):
    """The pp group holds the ranks that differ only in their pp coordinate
    (consecutive: pp is the innermost axis), and sums and replica hold the
    pp axis, in JAX's device grid."""
    n = int(np.prod(list(axes.values())))
    jm = jsharding.build_mesh(jcfg.MeshConfig(dp=axes.get("dp", 1), **{
        k: v for k, v in axes.items() if k != "dp"}), devices=jax.devices()[:n])
    ids = {d.id: i for i, d in enumerate(jax.devices()[:n])}
    grid = np.vectorize(lambda d: ids[d.id])(jm.devices)
    names = list(jm.axis_names)
    got = sharding.mesh_groups(sharding.mesh_shape(
        tcfg.MeshConfig(**{"dp": axes.get("dp", 1), **axes}), n))
    for group, vary in (("pp", ["pp"]), ("sums", ["dcn", "dp", "fsdp", "ep", "sp", "pp"]),
                        ("replica", ["dcn", "dp", "ep", "sp", "pp"]),
                        ("data", ["dcn", "dp", "fsdp", "ep"])):
        keep = [i for i, a in enumerate(names) if a not in vary]
        idx = [names.index(a) for a in vary]
        want = np.transpose(grid, keep + idx).reshape(
            -1, int(np.prod([grid.shape[i] for i in idx]))).tolist()
        assert got[group] == want, group
    pp = axes["pp"]
    assert got["pp"][0] == list(range(pp))


# ---------------------------------------------------------------------------
# Whole slices across gloo processes
# ---------------------------------------------------------------------------

def _dec_argv(tmp, dec_dir, *mesh):
    return ["--device", "cpu", *cli_overrides(tmp / "unused", dec_dir,
                                              **{"decode.batch_size": 4}),
            *CLI_LAYERS, *mesh, "--checkpoint", str(tmp / "texport"), "--split", "train"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run of this file (2, 4 and 8 ranks, a job
    each) and the inputs they read."""
    tmp = tmp_path_factory.mktemp("pp")
    np.savez(tmp / "step.npz", **{k: v[None] for k, v in _batch().items()})
    for setup in SETUPS:
        torch.save(from_numpy_tree(_weights(setup), "cpu"), tmp / f"w_{setup}.pt")
    jc = jload_config(None, [*cli_overrides(tmp / "r", tmp / "d"), *CLI_LAYERS])
    export_params(from_numpy_tree(np_tree(javsr.init_avsr_model(jax.random.key(4), jc.model)),
                                  "cpu"), tmp / "texport")

    jobs: dict[int, list] = {2: [], 4: [], 8: []}
    for name, (world, setup, extra, _) in STEP_RUNS.items():
        jobs[world].append(dict(kind="step", overrides=_over({**SETUPS[setup], **extra}),
                                weights=str(tmp / f"w_{setup}.pt"), batch=str(tmp / "step.npz"),
                                seeds=list(SEEDS), out=str(tmp / f"{name}.pt"),
                                eval=name == "pp2_unfreeze"))
    jobs[2] += [
        dict(kind="probe", out=str(tmp / "probe.json")),
        dict(kind="cli", cli="train",
             argv=["--device", "cpu", *train_over(tmp / "run_pp2", 2, (*CLI_LAYERS,
                                                                       "mesh.pp=2"))]),
        dict(kind="cli", cli="decode", argv=_dec_argv(tmp, tmp / "dec_pp2", "mesh.pp=2"))]
    for world, job in jobs.items():
        launch(world, job, tmp, timeout=JOB_TIMEOUT_S[world])
    return tmp


@pytest.mark.parametrize("setup", list(SETUPS))
def test_one_process_equals_jax_unsharded(setup):
    """The port's one-process steps, every multi-process run's reference,
    equal JAX's unsharded steps from the same weights."""
    metrics, leaves, _ = _one_process(setup)
    jm, jleaves = _jax_steps(setup)
    for g, m in zip(metrics, jm):
        np.testing.assert_allclose(g["loss"], m["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], m["grad_norm"], rtol=1e-4)
    bs = [k for k in jleaves if k[-1] == "b"]
    assert bs
    for k in bs:
        np.testing.assert_allclose(leaves[k].detach().numpy(), jleaves[k], atol=1e-6, rtol=0,
                                   err_msg=str(k))


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_pp_train_steps(runs, name):
    """Each run's 2 steps against the port's one process (loss |d| 1e-5,
    grad norm 1e-5 relative, every trained leaf atol 1e-6) and, for JAX's
    own pp setups, against JAX's step on its mesh of the same axes (loss
    rtol 1e-5, grad norm rtol 1e-4, LoRA b atol 1e-6)."""
    world, setup, extra, axes = STEP_RUNS[name]
    got = torch.load(runs / f"{name}.pt", weights_only=False)
    assert got["shape"]["pp"] == extra["mesh.pp"]
    assert int(np.prod(list(got["shape"].values()))) == world
    metrics, leaves, _ = _one_process(setup, "model.unfreeze_layer_norms" in extra)
    for g, m in zip(got["metrics"], metrics):
        assert abs(g["loss"] - m["loss"]) < 1e-5, (g, m)
        assert abs(g["grad_norm"] - m["grad_norm"]) <= 1e-5 * m["grad_norm"], (g, m)
        assert g["skipped"] == m["skipped"] == 0
    assert got["leaves"].keys() == {"/".join(k) for k in leaves}
    if "model.unfreeze_layer_norms" in extra:
        tuned = set(got["leaves"])
        assert {"llm/ln_f/scale", "llm/layers/3/ln_attn/scale", "llm/embed",
                "whisper/ln_post/scale"} <= tuned, sorted(tuned)
    for k, v in leaves.items():
        torch.testing.assert_close(got["leaves"]["/".join(k)], v.detach(), atol=1e-6,
                                   rtol=0, msg=lambda m, k=k: f"{k}: {m}")
    if axes is None:
        return
    jm, jleaves = _jax_steps(setup, tuple(axes.items()))
    for g, m in zip(got["metrics"], jm):
        np.testing.assert_allclose(g["loss"], m["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], m["grad_norm"], rtol=1e-4)
    bs = [k for k in jleaves if k[-1] == "b"]
    assert bs
    for k in bs:
        np.testing.assert_allclose(got["leaves"]["/".join(k)].numpy(), jleaves[k],
                                   atol=1e-6, rtol=0, err_msg=str(k))


def test_pp_eval_step_equals_one_process(runs):
    """The eval step under pp=2 (the pipeline without grad): one process's
    loss and accuracy, and the global label-token count (each stage counts
    the rows once)."""
    got = torch.load(runs / "pp2_unfreeze.pt", weights_only=False)["eval"]
    _, _, want = _one_process("pp1", True)
    assert got["label_tokens"] == want["label_tokens"] == float(_batch()["label_lens"].sum())
    assert abs(got["loss"] - want["loss"]) < 1e-6 and abs(got["accuracy"] - want["accuracy"]) < 1e-6


def test_probe_lists_the_pipeline(runs):
    takes = json.loads((runs / "probe.json").read_text())
    want = {f"{n}_{dt}" for n, (_, dts) in collectives.BACKEND_TABLE.items() for dt in dts}
    assert {"pp_operators_float32", "pp_operators_bfloat16"} <= set(takes)
    assert want <= set(takes) and all(v == "yes" for v in takes.values()), takes


@pytest.fixture(scope="module")
def one_process_cli_run(tmp_path_factory):
    """The train CLI in one process at the pp runs' 2 LLM layers: 2 steps,
    then a resume to 3."""
    run = tmp_path_factory.mktemp("pp_one_process") / "run"
    for steps in (2, 3):
        assert tcli_train.main(["--device", "cpu", *train_over(run, steps, CLI_LAYERS)]) == 0
    return run


def test_pp_train_cli_resumes_at_world_one(runs, one_process_cli_run):
    """A 2-rank train CLI run under pp=2 (2 steps, validation and
    in-training WER every epoch) checkpoints the whole tree and resumes at
    world 1 to a third step: one process's run; rank 0 alone wrote the
    log."""
    run = runs / "run_pp2"
    rows = (run / "loss_log.csv").read_text().splitlines()
    assert [r.split(",")[2] for r in rows[1:]] == ["train", "val", "val_wer"] * 2
    assert tcli_train.main(["--device", "cpu", *train_over(run, 3, CLI_LAYERS)]) == 0
    assert_same_run(run, one_process_cli_run)


def test_pp_decode_cli_equals_one_process(runs, tmp_path):
    assert tcli_decode.main(_dec_argv(runs, tmp_path / "dec1")) == 0
    two = hyp_lines(runs / "dec_pp2")
    assert len(two) == 8 and two == hyp_lines(tmp_path / "dec1")
