"""One rank of a multi-process CPU run of the port (gloo), started by
``tests/test_torch_multirank.py`` with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).

    python tests/torch_multirank_worker.py JOB.json

A job is a list of runs, made in order in one process:

  * ``step``: train steps (one per seed of ``seeds``) of the port's step
    under the mesh of ``overrides`` (a config over
    ``avsr_tpu/configs/tiny_cpu.yaml``) from the weights in ``weights`` (a
    ``torch.save``d tree) on this rank's rows of the global micro-batches
    in ``batch`` ([accum, B, ...] numpy arrays); rank 0 writes the metrics
    of each step, the trained leaves and the sharded frozen leaves,
    gathered whole, to ``out`` (``torch.save``);
  * ``cli``: ``avsr_tpu_torch.cli.<cli>.main(argv)``, whose return code
    must be 0.
"""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from avsr_tpu_torch.core import config as tcfg  # noqa: E402
from avsr_tpu_torch.mesh import multihost, sharding  # noqa: E402
from avsr_tpu_torch.models.avsr import Batch  # noqa: E402
from avsr_tpu_torch.train import state as tstate  # noqa: E402
from avsr_tpu_torch.train import step as tstep  # noqa: E402

TINY_YAML = REPO / "avsr_tpu" / "configs" / "tiny_cpu.yaml"


def run_step(job: dict) -> None:
    cfg = tcfg.load_config(TINY_YAML, job["overrides"])
    multihost.init_distributed("cpu")
    rank, world = multihost.process_shard()
    mesh = sharding.build_mesh(cfg.mesh, world=world, rank=rank)
    params = torch.load(job["weights"], weights_only=True)
    params = tstate.cast_frozen(params, cfg.model, torch.float32)
    state = tstate.create_train_state(sharding.shard_params(params, mesh), cfg, 10)
    step = tstep.make_train_step(cfg, mesh)
    data = np.load(job["batch"])
    B = data["labels"].shape[1]
    lo, hi = multihost.local_rows(B, (mesh.data.rank, mesh.ways))
    batch = Batch(**{k: torch.from_numpy(np.ascontiguousarray(data[k][:, lo:hi]))
                     for k in data.files})
    metrics = [step(state, batch, seed) for seed in job["seeds"]]
    train, _ = tstate.partition_trainable(state.params, cfg.model)
    with torch.no_grad():
        leaves = {k: sharding.gather_leaf(v).clone()
                  for k, v in tstate.path_leaves(train).items()}
        frozen = {k: sharding.gather_leaf(v).clone()
                  for k, v in tstate.path_leaves(state.params).items()
                  if sharding.shard_of(v) is not None and k not in leaves}
    if rank == 0:
        torch.save({"metrics": metrics, "leaves": leaves, "frozen": frozen,
                    "shape": mesh.shape}, job["out"])


def run_cli(job: dict) -> None:
    mod = importlib.import_module(f"avsr_tpu_torch.cli.{job['cli']}")
    rc = mod.main(job["argv"])
    if rc:
        raise SystemExit(rc)


def main() -> None:
    torch.set_num_threads(1)
    for run in json.loads(Path(sys.argv[1]).read_text()):
        {"step": run_step, "cli": run_cli}[run["kind"]](run)


if __name__ == "__main__":
    main()
