"""Mixture of experts across processes and expert parallelism (``mesh.ep``)
of the port on the CPU, against one process and the JAX package.

Every model here carries both MoE forms (``SETUP``): the ``moe`` connector
and MoE LLM blocks, 4 experts, top-2, both capacity factors at 0.25, so
that the bounded training routing really drops assignments (each run
counts them). Weights are the JAX init with LoRA ``b`` randomized; inputs
are numpy from a seed; f32.

  * Routing pieces (threads as ranks, ``test_torch_tp.on_ranks``): a global
    batch split by rows, and by rows x sequence chunks, each piece routed
    with its slot offsets (``ops/moe.py::piece_offsets``), the global
    capacity and the group's loss sums, gives the port's one-call
    ``route``'s dispatch, combine, lb and z bit for bit, and JAX's
    ``route`` within 1e-6; without the offsets the pieces' dispatch
    differs.
  * Train steps as gloo subprocesses (``torch_multirank_worker.py``), 2
    steps each: ``dp=2``, ``fsdp=2``, ``ep=2`` and ``sp=2`` (2 ranks),
    ``dp=2 ep=2``, ``fsdp=2 ep=2`` and ``ep=2 tp=2`` (4), ``dp=2 ep=2
    tp=2`` (8, JAX's own mesh of ``test_moe.py`` and ``test_moe_llm.py``),
    and the ``moe`` connector under ``pp=2`` (the LLM dense: JAX refuses
    LLM MoE blocks under pp). Each equals the port's one-process steps
    (loss |d| <= 1e-6; grad norm, ``moe_lb`` and ``moe_z`` 1e-6 relative;
    the first step's gradients of every expert and router leaf within
    ``GRAD_TOL`` relative in norm, a bound derived below from f32's
    rounding; after the steps an expert leaf of each MoE form and
    the MoE block's q LoRA ``b`` 1e-6 relative in norm, and every trained
    leaf within JAX's expert-leaf tolerance, atol 2e-5: Adam moves an entry
    by about the learning rate whatever its gradient's size, so the few
    entries whose gradient sums to near Adam's eps move by a few 1e-6
    under another summation order) and
    JAX's single-device steps at JAX's own tolerances (loss 1e-4,
    ``moe_lb`` rtol 1e-4, expert leaves atol 2e-5). Every rank holds
    [E / ep, ...] of every expert leaf, and the routings dropped
    assignments. A doubled router-loss gradient (each rank adding the
    whole lb and z) fails the router gradients' check.
  * A ring's prefill (threads as ranks, ``mesh.sp=2``) routes each row of
    the LLM's MoE blocks over its chunks (row-wise, with the row's valid
    length and slot offsets over the sp group): the hidden states and the
    KV cache equal one process's (atol 1e-5), with tokens dropped.
  * The config: ``mesh.ep=2`` with MoE loads, and JAX's refusals keep
    their messages; the ep groups are JAX's device-grid coordinates;
    ``probe_backend`` lists the exchange, and gloo takes it.
  * Checkpoints: the train CLI under ``ep=2`` (2 steps, validation and
    in-training WER) writes whole expert leaves and resumes at world 1
    and at ``dp=2`` to a third step equal to the same run in one process.
  * The decode CLI with both MoE forms under ``dp=2``, ``ep=2`` and
    ``tp=2`` writes one process's HYP lines.

The gradients' bound. A sharded step and the one-process step evaluate
the same f32 arithmetic; the splits (rows over dp, fsdp's gathers, tp's
row-parallel partial sums, the ep exchange, sp's chunks) and the GEMM
blockings that follow the shards' shapes change only the order in which
terms are added. A sum of n terms evaluated in any order is within
gamma_(n-1) * sum |x_i| of the exact sum, gamma_k = k u / (1 - k u), u =
2^-24 (Higham, Accuracy and Stability of Numerical Algorithms, 2nd ed.,
eq. 4.4), so two orders are within 2 gamma_(n-1) * sum |x_i| of each other.
A gradient leaf is such a sum over the batch's token positions, and no sum
of the step is longer: at most B x (mel frames + prompt + label tokens) =
4 x (100 + 3 + 7) = 440 terms (``_N_TERMS``). With the summands' own
magnitudes in place of the leaf's (no cancellation) this gives
``GRAD_TOL`` = 2 gamma_439 = 5.23e-5 relative. The runs read 0.3-1.07e-6
(the statistical size of such rounding, sqrt(n) u = 1.25e-6, not its worst
case), which is why the earlier fixed 1e-6 bound failed on some hosts and
passed on others; a doubled router-loss gradient moves the router
gradients by more than 1e-4 (``test_doubled_router_loss_gradient_fails_the_check``).
The gradients cannot be compared in float64 instead: the port's trainable
leaves are f32 masters (``train/state.py``) and its modules compute in f32
by construction.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core import config as jcfg
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.mesh import sharding as jsharding
from avsr_tpu.models import avsr as javsr
from avsr_tpu.ops import moe as jmoe
from avsr_tpu.train import state as jstate
from avsr_tpu.train import step as jstep
from avsr_tpu_torch.cli import decode as tcli_decode
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.mesh import collectives, sharding
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.ops import moe as tmoe
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import CheckpointManager, export_params, load_params

from test_torch_checkpoint_cli import hyp_lines
from test_torch_checkpoint_cli import overrides as cli_overrides
from test_torch_models import np_tree, randomize_lora_b
from test_torch_multirank import assert_same_run, launch, train_over
from test_torch_tp import on_ranks
from test_torch_train import TINY_YAML, jax_paths, port_paths

torch.set_num_threads(1)

SEEDS = (11, 12)
E = 4
SQUEEZE = {"model.moe_capacity_factor": 0.25, "model.llm.moe_capacity_factor": 0.25}
# tiny_cpu.yaml with both MoE forms (JAX's test_moe.py and test_moe_llm.py
# ep setups in one model): the moe connector and every second of 2 LLM
# blocks sparse, 4 experts top-2, the whole LLM trained, LoRA dropout off
SETUP = {"model.connector_type": "moe", "model.moe_experts": E, "model.moe_topk": 2,
         "model.llm.moe_experts": E, "model.llm.moe_topk": 2, "model.llm.n_layers": 2,
         "model.llm.moe_every": 2, "model.freeze_llm": "false", "model.lora.dropout": 0.0,
         "training.warmup_steps": 2, **SQUEEZE}
CONN = {"model.llm.moe_experts": 0}        # the connector alone (pp refuses LLM MoE)
RUNS = {   # name: (world, mesh overrides, the LLM dense)
    "dp2": (2, {"mesh.dp": 2}, False),
    "fsdp2": (2, {"mesh.fsdp": 2}, False),
    "ep2": (2, {"mesh.ep": 2}, False),
    "sp2": (2, {"mesh.sp": 2}, False),
    "pp2_connector": (2, {"mesh.pp": 2}, True),
    "dp2_ep2": (4, {"mesh.dp": 2, "mesh.ep": 2}, False),
    "fsdp2_ep2": (4, {"mesh.fsdp": 2, "mesh.ep": 2}, False),
    "ep2_tp2": (4, {"mesh.ep": 2, "mesh.tp": 2}, False),
    "dp2_ep2_tp2": (8, {"mesh.dp": 2, "mesh.ep": 2, "mesh.tp": 2}, False),
}
JOB_TIMEOUT_S = {2: 300, 4: 240, 8: 300}
# the CLIs' tiny config (test_torch_checkpoint_cli.py) with both MoE forms
CLI_MOE = {"model.connector_type": "moe", "model.moe_experts": E,
           "model.llm.moe_experts": E, **SQUEEZE}
DECODE_MESHES = {"dp2": "mesh.dp=2", "ep2": "mesh.ep=2", "tp2": "mesh.tp=2"}
# The train CLI's validation split has 2 utterances. One process wraps it
# to 4 rows, a mesh to the global batch (np.resize, so that every rank has
# rows); the eval step routes MoE as training does, so the wrapped rows,
# whose label length is 0, still take capacity slots (as JAX's would), and
# the validation loss follows the row count. At a global batch of 4 both
# wraps give the same 4 rows.
CLI_ROWS = 9     # the loss log's rows to step 3 at 2 steps an epoch
CLI_TRAIN = (*[f"{k}={v}" for k, v in CLI_MOE.items()], "data.batch_size=4")
U32 = 2.0 ** -24          # f32's unit roundoff


def _over(d: dict) -> list[str]:
    return [f"{k}={v}" for k, v in d.items()]


def _setup(dense_llm: bool) -> dict:
    return {**SETUP, **(CONN if dense_llm else {})}


def _batch() -> dict[str, np.ndarray]:
    """[1, 4, ...]: ragged mel (100-frame bucket) and labels, a 3-token
    prompt."""
    rng = np.random.default_rng(0)
    B = 4
    return dict(mel=rng.standard_normal((1, B, 80, 100)).astype(np.float32),
                mel_lens=np.array([[100, 62, 88, 76]], np.int32),
                prompt_tokens=np.tile(np.array([1, 7, 9], np.int32), (1, B, 1)),
                labels=rng.integers(0, 64, (1, B, 7)).astype(np.int32),
                label_lens=np.array([[7, 4, 6, 5]], np.int32))


def _reorder_bound(n: int) -> float:
    """2 gamma_(n-1): how far two f32 evaluations of one sum of n terms, in
    any two orders, can be apart, relative to the sum of the terms'
    magnitudes."""
    k = n - 1
    return 2 * k * U32 / (1 - k * U32)


# the longest sum of a step (see the module docstring): B x (mel frames +
# prompt + label tokens) of ``_batch``, 4 x (100 + 3 + 7) = 440
_N_TERMS = int(_batch()["mel"].shape[1] * sum(
    _batch()[k].shape[-1] for k in ("mel", "prompt_tokens", "labels")))
GRAD_TOL = _reorder_bound(_N_TERMS)


@functools.lru_cache(maxsize=None)
def _weights(dense_llm: bool) -> dict:
    jc = jload_config(TINY_YAML, _setup(dense_llm))
    return randomize_lora_b(np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model)),
                            seed=3)


@functools.lru_cache(maxsize=None)
def _jax_steps(dense_llm: bool):
    """JAX's single-device steps of SEEDS: (metrics, trained leaves)."""
    jc = jload_config(TINY_YAML, {**_setup(dense_llm), "runtime.use_pallas": "never"})
    state, tx = jstate.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, _weights(dense_llm)), jc, total_steps=10)
    batch = javsr.Batch(**{k: jnp.asarray(v) for k, v in _batch().items()})
    step = jstep.make_train_step(jc, tx)
    metrics = []
    for seed in SEEDS:
        state, m = step(state, batch, jax.random.key(seed))
        metrics.append({k: float(v) for k, v in m.items()})
    train = jax_paths(jstate.partition_trainable(state.params, jc.model)[0])
    return metrics, {"/".join(k): np.asarray(v) for k, v in train.items()}


@functools.lru_cache(maxsize=None)
def _one_process(dense_llm: bool, doubled_aux: bool = False):
    """The port's one-process steps of SEEDS: (metrics, trained leaves, the
    first step's gradients, the assignments its routings dropped).
    ``doubled_aux``: the first step's gradients with the router losses'
    gradient counted twice (the loss a rank would take if it added the
    global lb and z whole, ``models/avsr.py::forward``, at 2 ranks)."""
    tc = tcfg.load_config(TINY_YAML, _over(_setup(dense_llm)))
    params = tstate.cast_frozen(from_numpy_tree(_weights(dense_llm), "cpu"), tc.model,
                                torch.float32)
    if doubled_aux:
        tc = dataclasses.replace(tc, model=dataclasses.replace(
            tc.model, moe_aux_weight=2 * tc.model.moe_aux_weight,
            moe_z_weight=2 * tc.model.moe_z_weight))
    state = tstate.create_train_state(params, tc, 10)
    grads = {}
    update = state.optimizer.update

    def record(gs, norm):
        if not grads:
            grads.update({k: g.clone() for k, g in zip(state.optimizer.names, gs)})
        return update(gs, norm)

    state.optimizer.update = record
    dropped = [0]
    route = tmoe.route

    def counted(logits, valid, topk, C, **kw):
        out = route(logits, valid, topk, C, **kw)
        dropped[0] += int(valid.sum()) * topk - int(out[0].sum())
        return out

    tmoe.route = counted
    try:
        step = tstep.make_train_step(tc)
        batch = tavsr.Batch(**{k: torch.from_numpy(v) for k, v in _batch().items()})
        metrics = [step(state, batch, seed) for seed in SEEDS]
    finally:
        tmoe.route = route
    leaves = {"/".join(k): v.detach()
              for k, v in port_paths(tstate.partition_trainable(state.params, tc.model)[0]
                                     ).items()}
    return metrics, leaves, grads, dropped[0]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| (0 when both are 0)."""
    d, n = float((a - b).double().norm()), float(b.double().norm())
    return d / n if n else d


# ---------------------------------------------------------------------------
# routing pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pieces", [(4, 1), (2, 2)], ids=["rows", "rows_chunks"])
def test_routing_pieces_equal_global_route(pieces):
    """A global batch of 4 ragged rows of 16 positions (E = 4, top-2, the
    capacity of all 64 tokens at factor 0.25: assignments drop) split over
    ``pieces`` = (data ranks, sequence chunks): each rank routes its rows'
    chunk with its offsets, the global capacity and the group's sums, and
    gets the one-call route's rows of dispatch and combine, and its lb and
    z, bit for bit; the one-call route equals JAX's within 1e-6 (dispatch
    exactly). Without the offsets the pieces' dispatch differs."""
    n_data, chunks = pieces
    rng = np.random.default_rng(7)
    B, T, k = 4, 16, 2
    logits = rng.standard_normal((B, T, E)).astype(np.float32) * 2
    lens = np.array([16, 9, 13, 4])
    valid = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    C = tmoe.capacity(B * T, E, k, 0.25)
    one = tmoe.route(torch.from_numpy(logits).reshape(-1, E),
                     torch.from_numpy(valid).reshape(-1), k, C)
    assert int(valid.sum()) * k - int(one[0].sum()) > 0            # drops
    theirs = jmoe.route(jnp.asarray(logits.reshape(-1, E)), jnp.asarray(valid.reshape(-1)), k, C)
    np.testing.assert_array_equal(one[0].numpy(), np.asarray(theirs[0]))
    for a, b in zip(one[1:], theirs[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)

    Bl, Tc = B // n_data, T // chunks
    idx = torch.arange(B * T).reshape(B, T)

    def rank(mesh):
        g = mesh.sums                 # data-major, chunk-minor, as Routing reads it
        d, s = divmod(g.rank, chunks)
        rows, cols = slice(d * Bl, (d + 1) * Bl), slice(s * Tc, (s + 1) * Tc)
        lg = torch.from_numpy(logits[rows, cols].reshape(-1, E).copy())
        vl = torch.from_numpy(valid[rows, cols].reshape(-1).copy())
        routing = tmoe.Routing(g, chunks)
        got = tmoe.route(lg, vl, k, C, offset=tmoe.piece_offsets(routing, Bl, Tc), group=g)
        bare = tmoe.route(lg, vl, k, C, group=g)
        return got, bare[0], idx[rows, cols].reshape(-1)

    shape = dict(zip(sharding.AXES, (1, n_data, 1, 1, chunks, 1, 1)))
    results = on_ranks(shape, rank)
    for (dispatch, combine, lb, z), _, at in results:
        assert torch.equal(dispatch, one[0][at]) and torch.equal(combine, one[1][at])
        assert torch.equal(lb, one[2]) and torch.equal(z, one[3])
    assert any(not torch.equal(bare, one[0][at]) for _, bare, at in results)


def test_ring_prefill_routes_rows_over_their_chunks():
    """An inference prefill whose rows ring under sp=2 (2 ragged rows of
    32 positions, the LLM's MoE blocks at capacity factor 0.25) equals one
    process's: each row routes its chunks as one row (its valid length
    summed over the ring, its slots offset by the earlier chunk's picks)."""
    from avsr_tpu_torch.models import llama as tllama

    tc = tcfg.load_config(TINY_YAML, _over({**SETUP, "model.llm.moe_every": 1}))
    llm = tllama.init_llama(torch.Generator().manual_seed(0), tc.model.llm)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 32, tc.model.llm.d_model)).astype(np.float32))
    lens = torch.tensor([32, 21], dtype=torch.int32)
    kw = dict(inputs_embeds=x, lengths=lens, return_cache=True, output="hidden",
              moe_rowwise=True)
    route, dropped = tmoe.route, []

    def counted(logits, valid, topk, C, **k):
        out = route(logits, valid, topk, C, **k)
        dropped.append(int(valid.sum()) * topk - int(out[0].sum()))
        return out

    tmoe.route = counted
    try:
        one, cache = tllama.llama_apply(llm, tc.model.llm, **kw)
        ranks = on_ranks(dict(zip(sharding.AXES, (1, 1, 1, 1, 2, 1, 1))),
                         lambda mesh: tllama.llama_apply(llm, tc.model.llm, sp=mesh.sp, **kw))
    finally:
        tmoe.route = route
    assert dropped[0] > 0
    for hidden, c in ranks:
        torch.testing.assert_close(hidden, one, atol=1e-5, rtol=0)
        torch.testing.assert_close(c.k, cache.k, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# train steps across processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process job of this file, one per world size, and the
    inputs they read; a job's failure is reported by the tests that read
    its outputs."""
    tmp = tmp_path_factory.mktemp("ep")
    for dense in (False, True):
        torch.save(from_numpy_tree(_weights(dense), "cpu"), tmp / f"w{int(dense)}.pt")
    np.savez(tmp / "batch.npz", **_batch())
    # the CLIs: the JAX init of their tiny config with both MoE forms
    jc = jload_config(None, cli_overrides(tmp / "run", tmp / "dec", **CLI_MOE))
    export_params(from_numpy_tree(np_tree(javsr.init_avsr_model(jax.random.key(4), jc.model)),
                                  "cpu"), tmp / "export")
    jobs: dict[int, list] = {2: [], 4: [], 8: []}
    for name, (world, mesh, dense) in RUNS.items():
        jobs[world].append(dict(kind="step", overrides=_over({**_setup(dense), **mesh}),
                                weights=str(tmp / f"w{int(dense)}.pt"),
                                batch=str(tmp / "batch.npz"), seeds=list(SEEDS),
                                out=str(tmp / f"{name}.pt")))
    jobs[2].append(dict(kind="probe", out=str(tmp / "probe.json")))
    ep = ("mesh.ep=2", *CLI_TRAIN)
    jobs[2] += [
        dict(kind="cli", cli="train", argv=["--device", "cpu", *train_over(tmp / "run2", 2, ep)]),
        dict(kind="cli", cli="train", argv=["--device", "cpu", *train_over(tmp / "rerun", 2, ep)]),
        dict(kind="cli", cli="train",
             argv=["--device", "cpu", *train_over(tmp / "rerun", 3, ("mesh.dp=2", *CLI_TRAIN))])]
    jobs[2] += [dict(kind="cli", cli="decode", argv=_decode_argv(tmp, tmp / f"dec_{name}",
                                                                over))
                for name, over in DECODE_MESHES.items()]
    failed = {}
    for world, job in jobs.items():
        try:
            launch(world, job, tmp, timeout=JOB_TIMEOUT_S[world])
        except AssertionError as e:
            failed[world] = str(e)
    return dict(tmp=tmp, failed=failed)


def _decode_argv(tmp, dec_dir, *mesh) -> list[str]:
    return ["--device", "cpu", *cli_overrides(tmp / "unused", dec_dir, **CLI_MOE), *mesh,
            "--checkpoint", str(tmp / "export"), "--split", "train"]


def _job(runs, world: int):
    assert world not in runs["failed"], runs["failed"][world]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ep_steps_equal_one_process_and_jax(runs, name):
    """Two steps under ``name``'s mesh equal the port's one-process steps
    and JAX's single-device steps (see the module docstring); every rank
    holds its E / ep experts of every expert leaf, and the steps' routings
    dropped assignments, as the one process's did."""
    world, mesh, dense = RUNS[name]
    _job(runs, world)
    got = torch.load(runs["tmp"] / f"{name}.pt", weights_only=False)
    metrics, leaves, grads, dropped = _one_process(dense)
    assert dropped > 0 and sum(r["dropped"] for r in got["ranks"]) > 0
    ep = got["shape"]["ep"]
    assert [got["shape"][a.split(".")[1]] for a in mesh] == list(mesh.values())
    for r in got["ranks"]:
        assert r["experts"] and all(s[0] == E // ep for s in r["experts"].values()), r
    keys = ("loss", "grad_norm", "moe_lb", "moe_z")
    for g, w in zip(got["metrics"], metrics):
        assert abs(g["loss"] - w["loss"]) <= 1e-6, (g, w)
        for key in keys[1:]:
            assert abs(g[key] - w[key]) <= 1e-6 * abs(w[key]), (key, g, w)
        assert g["skipped"] == w["skipped"] == 0
    routed = [k for k in grads if "/experts/" in k or "/router/" in k]
    assert len([k for k in routed if "/router/" in k]) == (2 if dense else 3)
    for k in routed:
        assert _rel(got["grads"][k], grads[k]) <= GRAD_TOL, (k, _rel(got["grads"][k], grads[k]))
    watched = ["audio_connector/blocks/0/experts/w1", "llm/layers/1/q/lora/b"]
    watched += [] if dense else ["llm/layers/1/experts/w_gate"]
    for k in watched:
        assert _rel(got["leaves"][k], leaves[k]) <= 1e-6, (k, _rel(got["leaves"][k], leaves[k]))
    assert got["leaves"].keys() == leaves.keys()
    for k, v in leaves.items():
        torch.testing.assert_close(got["leaves"][k], v, atol=2e-5, rtol=0,
                                   msg=lambda m, k=k: f"{k}: {m}")
    jm, jleaves = _jax_steps(dense)
    for g, w in zip(got["metrics"], jm):
        assert abs(g["loss"] - w["loss"]) < 1e-4
        np.testing.assert_allclose(g["moe_lb"], w["moe_lb"], rtol=1e-4)
    experts = [k for k in jleaves if "/experts/" in k]
    assert experts
    for k in experts:
        np.testing.assert_allclose(got["leaves"][k].numpy(), jleaves[k], atol=2e-5, err_msg=k)


def test_doubled_router_loss_gradient_fails_the_check(runs):
    """The router gradients' check has teeth: the router losses' gradient
    counted twice moves every router gradient by more than 1e-4, beyond
    ``GRAD_TOL``, the bound the runs are held to."""
    _job(runs, 2)
    got = torch.load(runs["tmp"] / "ep2.pt", weights_only=False)
    doubled = _one_process(False, doubled_aux=True)[2]
    routers = [k for k in doubled if "/router/" in k]
    assert len(routers) == 3
    assert GRAD_TOL < 1e-4
    for k in routers:
        assert _rel(got["grads"][k], doubled[k]) > 1e-4, k


# ---------------------------------------------------------------------------
# config, groups, backend
# ---------------------------------------------------------------------------

def test_ep_config_loads_and_refuses_with_jax_messages():
    """mesh.ep=2 with either MoE form loads (and the moe connector under
    pp); ep with a dense model, experts that do not divide over ep (the
    connector's, the LLM's) and LLM MoE under pp raise JAX's ValueError
    with its text."""
    for over in (["model.connector_type=moe"], ["model.llm.moe_experts=4"],
                 ["model.connector_type=moe", "mesh.pp=2", "model.lora.dropout=0"]):
        assert tcfg.load_config(None, ["mesh.ep=2", *over]).mesh.ep == 2
    for over in ({"mesh.ep": 2}, {"mesh.ep": 2, "model.connector_type": "moe",
                                  "model.moe_experts": 3},
                 {"mesh.ep": 4, "model.llm.moe_experts": 6},
                 {"mesh.pp": 2, "model.llm.moe_experts": 4, "model.lora.dropout": 0.0}):
        with pytest.raises(ValueError) as theirs:
            jload_config(None, over)
        with pytest.raises(ValueError) as mine:
            tcfg.load_config(None, _over(over))
        assert str(mine.value) == str(theirs.value)


def test_ep_groups_are_jax_device_grid_coordinates():
    """Under dp=2 fsdp=2 ep=2 the ep group holds the ranks that differ only
    in their ep coordinate, and ep_sums / ep_replica the ranks that differ
    in the sums' / replica's axes but ep, in JAX's device grid."""
    axes = dict(dp=2, fsdp=2, ep=2)
    jm = jsharding.build_mesh(jcfg.MeshConfig(**axes), devices=jax.devices()[:8])
    ids = {d.id: i for i, d in enumerate(jax.devices()[:8])}
    grid = np.vectorize(lambda d: ids[d.id])(jm.devices)
    names = list(jm.axis_names)
    got = sharding.mesh_groups(sharding.mesh_shape(tcfg.MeshConfig(**axes), 8))
    for group, vary in (("ep", ["ep"]), ("ep_sums", ["dcn", "dp", "fsdp", "sp", "pp"]),
                        ("ep_replica", ["dcn", "dp", "sp", "pp"])):
        keep = [names.index(a) for a in names if a not in vary]
        move = [names.index(a) for a in vary]
        want = np.transpose(grid, keep + move).reshape(-1, int(np.prod(
            [grid.shape[i] for i in move]))).tolist()
        assert sorted(map(sorted, got[group])) == sorted(map(sorted, want)), group


def test_probe_lists_the_expert_exchange(runs):
    _job(runs, 2)
    takes = json.loads((runs["tmp"] / "probe.json").read_text())
    want = {f"{n}_{dt}" for n, (_, dts) in collectives.BACKEND_TABLE.items() for dt in dts}
    assert {"ep_operators_float32", "ep_operators_bfloat16", "all_gather_int64",
            "all_reduce_sum_float64"} <= set(takes)
    assert want <= set(takes) and all(v == "yes" for v in takes.values()), takes


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_run(tmp_path_factory) -> object:
    """The train CLI with both MoE forms in one process: 2 steps, then a
    resume to 3."""
    run = tmp_path_factory.mktemp("ep_one_process") / "run"
    for steps in (2, 3):
        assert tcli_train.main(["--device", "cpu", *train_over(run, steps, CLI_TRAIN)]) == 0
    return run


def test_ep_checkpoint_resumes_at_world_one(runs, one_process_run):
    """A 2-rank train CLI run under ep=2 checkpoints whole expert leaves
    (E of them, gathered over ep by rank 0) and resumes at world 1 to a
    third step: the same run as in one process."""
    _job(runs, 2)
    run2 = runs["tmp"] / "run2"
    assert CheckpointManager(run2 / "ckpt").latest_step() == 2
    full = load_params(run2 / "ckpt" / "2")
    w = full["llm"]["layers"][0]["experts"]["w_gate"]
    assert w.shape[0] == E and full["audio_connector"]["blocks"][0]["experts"]["w1"].shape[0] == E
    assert tcli_train.main(["--device", "cpu", *train_over(run2, 3, CLI_TRAIN)]) == 0
    assert_same_run(run2, one_process_run, n_rows=CLI_ROWS)


def test_ep_checkpoint_resumes_at_dp2(runs, one_process_run):
    """The same 2 steps under ep=2, resumed by 2 ranks under dp=2 (each
    holding every expert) to a third step: the same run as in one
    process."""
    _job(runs, 2)
    assert_same_run(runs["tmp"] / "rerun", one_process_run, n_rows=CLI_ROWS)


@pytest.fixture(scope="module")
def one_process_decode(runs, tmp_path_factory):
    dec = tmp_path_factory.mktemp("ep_dec") / "dec1"
    assert tcli_decode.main(_decode_argv(runs["tmp"], dec)) == 0
    return hyp_lines(dec)


@pytest.mark.parametrize("name", sorted(DECODE_MESHES))
def test_decode_cli_under_mesh_equals_one_process(runs, one_process_decode, name):
    """The decode CLI with both MoE forms on 2 ranks (rows over dp or ep;
    tp slices of the experts, Megatron style) writes one process's HYP
    lines: inference routes each row on its own (row-wise prefills,
    dropless token steps)."""
    _job(runs, 2)
    got = hyp_lines(runs["tmp"] / f"dec_{name}")
    assert len(got) == 8 and got == one_process_decode
