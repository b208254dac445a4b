"""The port across processes on the CPU (gloo): 2 and 4 ranks, each a
subprocess with torchrun's environment on a free localhost port
(``torch_multirank_worker.py``), against one process and the JAX package.

f32 throughout. Train steps (2 steps of 2 micro-batches of 4 rows with
ragged label lengths, the widened tiny config of ``test_torch_train.py``,
JAX-initialised weights):

  * ``dp=2`` (2 ranks) and ``dp=2 fsdp=2`` (4 ranks) with LoRA dropout on
    equal the port's one-process step: loss |d| < 1e-5, grad norm 1e-5
    relative, LoRA ``b`` atol 1e-6. They fail with each rank's loss
    normalised by its own label tokens, or with each rank drawing dropout
    masks for its own rows as if they were a whole batch;
  * ``dp=2 fsdp=2`` with dropout off equals JAX's step on
    ``build_mesh(dp=2, fsdp=2, devices=jax.devices()[:4])`` from the same
    weights, to ``tests/test_mesh.py``'s tolerances (loss 1e-4, ``b``
    atol 1e-5; dropout bits cannot match JAX's);
  * QLoRA (int4) under ``fsdp=2`` and a full fine-tune of the LLM with
    adafactor under ``dp=2 fsdp=2`` (sharded trained leaves: gradients
    reduce-scattered, factored moments over slices) equal their
    one-process steps to the same tolerances, and the gathered int4 leaves
    equal the quantized tree bit for bit.

CLIs (the tiny config of ``test_torch_checkpoint_cli.py``): a 2-rank
decode with a batch of 5 (padded to 6 over the 2 ranks) writes the HYP
lines of the one-process decode and of the JAX decode CLI; a 2-rank train
CLI run under fsdp=2 (2 steps, validation and in-training WER) resumes at
world 1, and another at world 2, to a third step equal to the same run's
in one process (loss log 1e-5 relative, trained leaves atol 1e-6); rank 0
alone wrote the logs.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.cli import decode as jcli_decode
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.mesh import sharding as jsharding
from avsr_tpu.models import avsr as javsr
from avsr_tpu.train import checkpoint as jcheckpoint
from avsr_tpu.train import state as jstate
from avsr_tpu.train import step as jstep
from avsr_tpu_torch.cli import decode as tcli_decode
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.models.avsr import Batch
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import CheckpointManager, export_params, load_params

from test_torch_checkpoint_cli import hyp_lines
from test_torch_checkpoint_cli import overrides as cli_overrides
from test_torch_models import np_tree
from test_torch_qlora import quantized
from test_torch_train import (TINY_YAML, WIDE, configs, jax_paths, port_paths,  # noqa: F401
                              weights)

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
WORKER = TESTS / "torch_multirank_worker.py"
TIMEOUT_S = 300
SEEDS = (11, 12)
DROPOUT = {"model.lora.dropout": 0.3}
RUNS = {   # name: (world, overrides beyond WIDE, weights)
    "dp2": (2, {**DROPOUT}, "float"),
    "qlora_fsdp2": (2, {**DROPOUT, "mesh.fsdp": 2, "model.use_4bit": "true"}, "int4"),
    "dp2_fsdp2": (4, {**DROPOUT, "mesh.fsdp": 2, "mesh.remat": "true"}, "float"),
    "dp2_fsdp2_no_dropout": (4, {"mesh.fsdp": 2}, "float"),
    "dp2_fsdp2_finetune": (4, {**DROPOUT, "mesh.fsdp": 2, "model.freeze_llm": "false",
                               "training.optimizer": "adafactor"}, "float"),
}


def port_overrides(extra: dict) -> list[str]:
    """``test_torch_train.configs``'s port overrides, with ``extra``."""
    return [f"{k}={v}" for k, v in {**WIDE, **extra}.items()] + ["runtime.use_pallas=always"]


def global_batch(B: int = 4, accum: int = 2) -> dict[str, np.ndarray]:
    """[accum, B, ...] numpy leaves: ragged audio, frames and labels."""
    rng = np.random.default_rng(5)
    return dict(
        mel=rng.standard_normal((accum, B, 80, 500)).astype(np.float32),
        mel_lens=rng.integers(250, 501, (accum, B)).astype(np.int32),
        frames=rng.standard_normal((accum, B, 4, 3, 16, 16)).astype(np.float32),
        frame_lens=rng.integers(2, 5, (accum, B)).astype(np.int32),
        prompt_tokens=np.tile(np.array([256, 72, 105, 33, 9], np.int32), (accum, B, 1)),
        labels=rng.integers(0, 258, (accum, B, 24)).astype(np.int32),
        label_lens=np.array([[24, 17, 20, 9], [5, 24, 11, 16]][:accum], np.int32)[:, :B])


class PortTaken(AssertionError):
    """Rank 0 could not listen on the job's port: another process took it."""


def launch(world: int, runs: list[dict], tmp: Path, timeout: float = TIMEOUT_S,
           attempts: int = 3) -> None:
    """Runs ``runs`` in ``world`` worker processes; fails as soon as one
    rank fails (and stops the others), or after ``timeout`` seconds. The
    port is found free here and released before rank 0 listens on it, so
    another process (a parallel test's job) can take it in between: a job
    whose rank 0 finds its address in use starts again on a new port, at
    most ``attempts`` times in all."""
    for attempt in range(attempts):
        try:
            return _launch_once(world, runs, tmp, timeout)
        except PortTaken:
            if attempt == attempts - 1:
                raise


def _launch_once(world: int, runs: list[dict], tmp: Path, timeout: float) -> None:
    job = tmp / f"job{world}.json"
    job.write_text(json.dumps(runs))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # the worker finds the repo itself, so the environment's PYTHONPATH stays
    # as it is; every rank runs on this host, so gloo binds the loopback
    env = {k: v for k, v in os.environ.items() if k not in ("AVSR_TEST_TPU", "XLA_FLAGS")}
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    logs = [tmp / f"rank{r}of{world}.log" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(job)], cwd=TESTS.parent,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
             for r in range(world)]
    t0 = time.monotonic()

    def port_taken() -> bool:
        text = logs[0].read_text(errors="replace")
        return "EADDRINUSE" in text or "address already in use" in text.lower()

    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if 0 in failed and port_taken():
                raise PortTaken(f"port {port} taken before rank 0 of {world} listened")
            assert not failed and time.monotonic() - t0 < timeout, (
                f"rank(s) {failed or 'all (timeout)'} of {world}:\n"
                + "\n".join(logs[r].read_text()[-3000:] for r in (failed or [0])))
            time.sleep(0.2)
        if procs[0].returncode and port_taken():
            raise PortTaken(f"port {port} taken before rank 0 of {world} listened")
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r} of {world}:\n{logs[r].read_text()[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):  # noqa: F811
    """Every multi-process run of this file, 2 ranks in one job and 4 in
    another, and the inputs they read."""
    tmp = tmp_path_factory.mktemp("multirank")
    files = {"float": tmp / "float.pt", "int4": tmp / "int4.pt"}
    torch.save(from_numpy_tree(weights, "cpu"), files["float"])
    torch.save(from_numpy_tree(quantized(weights, 4), "cpu"), files["int4"])
    np.savez(tmp / "batch.npz", **global_batch())

    # the CLIs: the JAX init of their tiny config, exported for both packages
    jc = jload_config(None, cli_overrides(tmp / "run", tmp / "dec"))
    cli_w = np_tree(javsr.init_avsr_model(jax.random.key(4), jc.model))
    export_params(from_numpy_tree(cli_w, "cpu"), tmp / "texport")
    jcheckpoint.export_params(jax.tree_util.tree_map(jnp.asarray, cli_w), tmp / "jexport")

    def dec_argv(dec_dir):
        return ["--device", "cpu", *cli_overrides(tmp / "unused", dec_dir,
                                                  **{"decode.batch_size": 5}),
                "--checkpoint", str(tmp / "texport"), "--split", "train"]

    jobs: dict[int, list] = {2: [], 4: []}
    for name, (world, extra, w) in RUNS.items():
        jobs[world].append(dict(kind="step", overrides=port_overrides(extra),
                                weights=str(files[w]), batch=str(tmp / "batch.npz"),
                                seeds=list(SEEDS), out=str(tmp / f"{name}.pt")))
    fsdp = ("mesh.fsdp=2",)
    jobs[2] += [
        dict(kind="cli", cli="train", argv=["--device", "cpu", *train_over(tmp / "run2", 2, fsdp)]),
        dict(kind="cli", cli="train", argv=["--device", "cpu", *train_over(tmp / "rerun2", 2, fsdp)]),
        dict(kind="cli", cli="train", argv=["--device", "cpu", *train_over(tmp / "rerun2", 3, fsdp)]),
        dict(kind="cli", cli="decode", argv=dec_argv(tmp / "dec2"))]
    for world, job in jobs.items():
        launch(world, job, tmp)
    return dict(tmp=tmp, files=files, cli_w=cli_w, dec_argv=dec_argv)


def train_over(run_dir: Path, max_steps: int, mesh: tuple[str, ...] = ()) -> list[str]:
    """The train CLI's tiny config, the whole LLM trained with adafactor (a
    128-wide LLM, so that its moments are factored) besides LoRA."""
    return cli_overrides(run_dir, run_dir / "dec", **{
        "training.max_steps": max_steps, "training.eval_wer_every_epochs": 1,
        "training.eval_wer_max_utts": 4, "decode.max_new_tokens": 4,
        "model.llm.d_model": 128, "model.llm.ffn_dim": 256, "model.freeze_llm": "false",
        "training.optimizer": "adafactor"}) + list(mesh)


def one_process(extra: dict, w) -> tuple[list[dict], dict]:
    """The port's one-process steps of ``RUNS``'s config on the global batch:
    (metrics per step, trained leaves)."""
    tc = tcfg.load_config(TINY_YAML, port_overrides(extra))
    params = tstate.cast_frozen(from_numpy_tree(w, "cpu"), tc.model, torch.float32)
    state = tstate.create_train_state(params, tc, 10)
    step = tstep.make_train_step(tc)
    batch = Batch(**{k: torch.from_numpy(v) for k, v in global_batch().items()})
    metrics = [step(state, batch, seed) for seed in SEEDS]
    return metrics, port_paths(tstate.partition_trainable(state.params, tc.model)[0])


def assert_equal_runs(got: dict, metrics: list[dict], leaves: dict) -> None:
    for g, w in zip(got["metrics"], metrics):
        assert abs(g["loss"] - w["loss"]) < 1e-5, (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-5 * w["grad_norm"], (g, w)
        assert g["skipped"] == w["skipped"] == 0
    assert got["leaves"].keys() == {"/".join(k) for k in leaves}
    assert any(k[-1] == "b" for k in leaves)
    for k, v in leaves.items():
        torch.testing.assert_close(got["leaves"]["/".join(k)], v.detach(), atol=1e-6,
                                   rtol=0, msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("name", ["dp2", "dp2_fsdp2", "dp2_fsdp2_finetune"])
def test_sharded_steps_equal_one_process(runs, weights, name):  # noqa: F811
    """Each rank's loss is its rows' share of the global batch's (the
    label tokens summed over the ranks) and each rank draws its rows of a
    single card's dropout masks: the steps equal one process's."""
    world, extra, _ = RUNS[name]
    got = torch.load(runs["tmp"] / f"{name}.pt", weights_only=False)
    assert got["shape"]["dp"] == 2 and got["shape"]["fsdp"] == world // 2
    assert_equal_runs(got, *one_process(extra, weights))


def test_qlora_under_fsdp_equals_one_process(runs, weights):  # noqa: F811
    """int4 QLoRA under fsdp=2: the step equals one process's, and the
    int4 leaves gathered from the ranks' slices (the half-split packing,
    sliced along the dimension the rule shards) are the quantized tree's
    bit for bit."""
    world, extra, _ = RUNS["qlora_fsdp2"]
    got = torch.load(runs["tmp"] / "qlora_fsdp2.pt", weights_only=False)
    qw = quantized(weights, 4)
    assert_equal_runs(got, *one_process(extra, qw))
    want = {"/".join(k): v for k, v in port_paths(from_numpy_tree(qw, "cpu")).items()}
    packed = [k for k in got["frozen"] if k.endswith("qw4h")]
    assert packed and any("/down/" in k for k in packed) and any("/q/" in k for k in packed)
    for k, v in got["frozen"].items():
        assert torch.equal(v, want[k]), k


def test_sharded_step_equals_jax_mesh_step(runs, weights):  # noqa: F811
    """dp=2 fsdp=2 over 4 processes against JAX's step on its 4-device
    mesh of the same axes, from the same weights (dropout off)."""
    jc, _ = configs()
    jc = dataclasses.replace(jc, mesh=dataclasses.replace(jc.mesh, dp=2, fsdp=2))
    mesh = jsharding.build_mesh(jc.mesh, devices=jax.devices()[:4])
    state, tx = jstate.create_train_state(jax.tree_util.tree_map(jnp.asarray, weights),
                                          jc, total_steps=10)
    state = jsharding.shard_state(state, mesh)
    step = jstep.make_train_step(jc, tx)
    batch = jsharding.batch_sharder(mesh)(
        javsr.Batch(**{k: jnp.asarray(v) for k, v in global_batch().items()}))
    jm = []
    for seed in SEEDS:
        state, m = step(state, batch, jax.random.key(seed))
        jm.append(m)
    got = torch.load(runs["tmp"] / "dp2_fsdp2_no_dropout.pt", weights_only=False)
    for g, m in zip(got["metrics"], jm):
        assert abs(g["loss"] - float(m["loss"])) < 1e-4
    want = jax_paths(jstate.partition_trainable(state.params, jc.model)[0])
    bs = [k for k in want if k[-1] == "b"]
    assert bs
    for k in bs:
        np.testing.assert_allclose(got["leaves"]["/".join(k)].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=str(k))


def test_two_rank_decode_equals_one_process_and_jax(runs, tmp_path):
    """Batches of 5 over 2 ranks (the last row repeated to 6, its output
    dropped): rank 0 writes the one-process decode's HYP lines and the JAX
    decode CLI's, from the same weights."""
    tmp = runs["tmp"]
    assert tcli_decode.main(runs["dec_argv"](tmp_path / "dec1")) == 0
    jover = cli_overrides(tmp_path / "unused", tmp_path / "jdec", **{"decode.batch_size": 5})
    assert jcli_decode.main(["--checkpoint", str(tmp / "jexport"), "--split", "train",
                             *jover]) == 0
    two = hyp_lines(tmp / "dec2")
    assert len(two) == 8 and two == hyp_lines(tmp_path / "dec1") == hyp_lines(
        tmp_path / "jdec")
    assert len(list((tmp / "dec2").glob("wer_*.txt"))) == 1


@pytest.fixture(scope="module")
def one_process_run(tmp_path_factory) -> Path:
    """The train CLI in one process: 2 steps, then a resume to 3."""
    run = tmp_path_factory.mktemp("one_process") / "run"
    for steps in (2, 3):
        assert tcli_train.main(["--device", "cpu", *train_over(run, steps)]) == 0
    return run


def assert_same_run(got: Path, want: Path, step: int = 3, n_rows: int = 11) -> None:
    """The loss logs row for row (1e-5 relative; ``n_rows`` of them) and the
    trained leaves of the last checkpoint (atol 1e-6)."""
    def rows(d):
        return [r.split(",") for r in (d / "loss_log.csv").read_text().splitlines()[1:]]

    g, w = rows(got), rows(want)
    assert [r[:3] for r in g] == [r[:3] for r in w] and len(w) == n_rows
    for a, b in zip(g, w):
        for i in (3, 4, 5, 6):     # loss, accuracy, wer, grad_norm
            if b[i]:
                assert abs(float(a[i]) - float(b[i])) <= 1e-5 * max(abs(float(b[i])), 1), (a, b)
    tc = tcfg.load_config(None, train_over(got, step))
    final = [load_params(d / "ckpt" / str(step)) for d in (got, want)]
    train = [port_paths(tstate.partition_trainable(p, tc.model)[0]) for p in final]
    assert train[0].keys() == train[1].keys() and train[0]
    for k in train[1]:
        torch.testing.assert_close(train[0][k], train[1][k], atol=1e-6, rtol=0)


def test_two_rank_checkpoint_resumes_at_world_one(runs, one_process_run):
    """A 2-rank train CLI run under fsdp=2 (2 steps, validation and
    in-training WER every epoch; the sharded LLM trained with adafactor)
    checkpoints the full tree and optimizer state, gathered, and resumes at
    world 1 to a third step: the loss log and the trained
    leaves equal those of the same run (2 steps, then a resume to 3) in
    one process. Rank 0 alone wrote the 2-rank run's log (one row per step
    and evaluation)."""
    run2 = runs["tmp"] / "run2"
    rows2 = (run2 / "loss_log.csv").read_text().splitlines()
    assert [r.split(",")[2] for r in rows2[1:]] == ["train", "val", "val_wer"] * 2
    assert CheckpointManager(run2 / "ckpt").latest_step() == 2
    full = load_params(run2 / "ckpt" / "2")
    assert full["llm"]["embed"].shape == (260, 128)      # whole, not a slice
    assert tcli_train.main(["--device", "cpu", *train_over(run2, 3)]) == 0
    assert_same_run(run2, one_process_run)


def test_sharded_run_resumes_sharded(runs, one_process_run):
    """2 ranks under fsdp=2 take 2 steps, stop, and 2 ranks resume the
    checkpoint (each keeping its slices of the leaves and of adafactor's
    moments) to a third step: the same run as in one process."""
    assert_same_run(runs["tmp"] / "rerun2", one_process_run)
