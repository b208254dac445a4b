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
    of each step, the first step's gradients and the trained leaves and
    the sharded frozen leaves after the steps, all gathered whole, to
    ``out`` (``torch.save``), with every rank's shapes of its expert leaves
    and the MoE assignments its routings dropped; with ``eval``, also the
    eval step's metrics on the first micro-batch before the steps;
  * ``decode``: the serving layout of ``weights`` under the mesh of
    ``overrides`` (``prepare_params_for_decode``: quantized head, this
    rank's tp slices, each rank's fused q|k|v and gate|up), then
    ``generate_tokens`` and ``beam_search`` (with the mesh's sp group) on
    this rank's rows of the
    batch in ``batch`` ([B, ...] numpy arrays), and for each draft depth
    of ``spec`` (0: the self-draft, else a layer-skip draft of that many
    blocks; int8, sliced like the target) ``speculative_generate``; every
    rank writes its tokens and prefill logits to ``out`` (``{rank}`` in the
    name);
  * ``prefill``: under the mesh of ``overrides`` (sequence parallelism),
    ``generate_tokens`` of ``weights`` on this rank's rows of ``batch``,
    and the prefill's KV cache (the encoders, the packed prefix and
    ``llama_apply`` with ``return_cache``, as ``generate_tokens`` runs
    them); every rank writes its tokens, its cache, and the ring
    dispatches and fallbacks it made, to ``out``;
  * ``probe``: ``collectives.probe_backend`` on the CPU; rank 0 writes the
    answers to ``out``;
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
from avsr_tpu_torch.infer import generate, speculative  # noqa: E402
from avsr_tpu_torch.mesh import collectives, multihost, sharding  # noqa: E402
from avsr_tpu_torch.models import avsr, llama  # noqa: E402
from avsr_tpu_torch.models.avsr import Batch  # noqa: E402
from avsr_tpu_torch.ops import attention, moe  # noqa: E402
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
    grads = {}
    update = state.optimizer.update

    def record(gs, norm):       # the first step's reduced gradients, whole
        if not grads:
            with torch.no_grad():
                grads.update({k: sharding.gather_leaf(g).clone()
                              for k, g in zip(state.optimizer.names, gs)})
        return update(gs, norm)

    state.optimizer.update = record
    dropped = [0]
    route = moe.route

    def counted(logits, valid, topk, C, **kw):     # the assignments past capacity
        out = route(logits, valid, topk, C, **kw)
        dropped[0] += int(valid.sum()) * topk - int(out[0].sum())
        return out

    moe.route = counted
    data = np.load(job["batch"])
    B = data["labels"].shape[1]
    lo, hi = multihost.local_rows(B, (mesh.data.rank, mesh.ways))
    batch = Batch(**{k: torch.from_numpy(np.ascontiguousarray(data[k][:, lo:hi]))
                     for k in data.files})
    evals = None
    if job.get("eval"):
        first = Batch(*[None if x is None else x[0] for x in batch])
        evals = tstep.make_eval_step(cfg, mesh)(state.params, first)
    metrics = [step(state, batch, seed) for seed in job["seeds"]]
    moe.route = route
    local = {k: tuple(v.shape) for k, v in tstate.path_leaves(state.params).items()
             if "/experts/" in k}
    ranks = mesh.world.all_gather_object({"experts": local, "dropped": dropped[0]})
    train, _ = tstate.partition_trainable(state.params, cfg.model)
    with torch.no_grad():
        leaves = {k: sharding.gather_leaf(v).clone()
                  for k, v in tstate.path_leaves(train).items()}
        frozen = {k: sharding.gather_leaf(v).clone()
                  for k, v in tstate.path_leaves(state.params).items()
                  if sharding.shards_of(v) and k not in leaves}
    if rank == 0:
        torch.save({"metrics": metrics, "leaves": leaves, "frozen": frozen,
                    "grads": grads, "shape": mesh.shape, "eval": evals, "ranks": ranks},
                   job["out"])


def run_decode(job: dict) -> None:
    cfg = tcfg.load_config(TINY_YAML, job["overrides"])
    multihost.init_distributed("cpu")
    rank, world = multihost.process_shard()
    mesh = sharding.build_mesh(cfg.mesh, world=world, rank=rank)
    raw = torch.load(job["weights"], weights_only=True)
    params = generate.prepare_params_for_decode(raw, cfg.model, cfg.decode.lm_head_bits,
                                                mesh=mesh)
    data = np.load(job["batch"])
    lo, hi = multihost.local_rows(data["labels"].shape[0], (mesh.data.rank, mesh.ways))
    batch = Batch(**{k: torch.from_numpy(np.ascontiguousarray(data[k][lo:hi]))
                     for k in data.files})
    kw = dict(eos_id=job["eos"], kv_cache_dtype=cfg.decode.kv_cache_dtype,
              use_kernel=cfg.runtime.use_pallas, sp=mesh.sp)
    stats: dict = {}
    greedy = generate.generate_tokens(params, cfg.model, batch, stats=stats,
                                      max_new_tokens=job["new_tokens"], **kw)
    beam = generate.beam_search(params, cfg.model, batch, num_beams=job["beams"],
                                max_new_tokens=job["beam_tokens"], **kw)
    spec = {}
    for layers in job.get("spec", ()):
        d_raw, d_cfg = (speculative.make_layerskip_draft(raw, cfg.model, layers)
                        if layers else (raw, None))
        draft = speculative.make_draft_params(d_raw, d_cfg or cfg.model, bits=8, mesh=mesh)
        spec[layers] = speculative.speculative_generate(
            params, draft, cfg.model, batch, gamma=3, max_new_tokens=job["new_tokens"],
            eos_id=job["eos"], use_kernel=cfg.runtime.use_pallas,
            draft_model_cfg=d_cfg, sp=mesh.sp).tokens
    torch.save({"greedy": greedy.tokens, "greedy_lens": greedy.lengths,
                "beam": beam.tokens, "beam_lens": beam.lengths, "spec": spec,
                "prefill_logits": stats["prefill_logits"], "shape": mesh.shape,
                "rows": (lo, hi)}, job["out"].format(rank=rank))


def run_prefill(job: dict) -> None:
    cfg = tcfg.load_config(TINY_YAML, job["overrides"])
    multihost.init_distributed("cpu")
    rank, world = multihost.process_shard()
    mesh = sharding.build_mesh(cfg.mesh, world=world, rank=rank)
    params = generate.prepare_params_for_decode(torch.load(job["weights"], weights_only=True),
                                                cfg.model, mesh=mesh)
    data = np.load(job["batch"])
    lo, hi = multihost.local_rows(data["labels"].shape[0], (mesh.data.rank, mesh.ways))
    batch = Batch(**{k: torch.from_numpy(np.ascontiguousarray(data[k][lo:hi]))
                     for k in data.files})
    rings = attention.ring_dispatch_count
    out = generate.generate_tokens(params, cfg.model, batch, max_new_tokens=job["new_tokens"],
                                   eos_id=job["eos"], sp=mesh.sp)
    rings = attention.ring_dispatch_count - rings
    with torch.no_grad():
        enc = avsr.encode(params, cfg.model, batch, moe_rowwise=True, sp=mesh.sp)
        prefix, lens = avsr.build_prefix(params, cfg.model, batch, enc)
        _, cache = llama.llama_apply(params["llm"], cfg.model.llm, inputs_embeds=prefix,
                                     lengths=lens, return_cache=True,
                                     lora=cfg.model.lora if cfg.model.lora.use_lora else None,
                                     output="hidden", sp=mesh.sp)
    torch.save({"tokens": out.tokens, "lengths": out.lengths, "rings": rings,
                "fallbacks": sorted(attention._ring_fallback_warned), "k": cache.k,
                "v": cache.v, "prefix_lens": lens, "rows": (lo, hi), "shape": mesh.shape},
               job["out"].format(rank=rank))


def run_probe(job: dict) -> None:
    multihost.init_distributed("cpu")
    takes = collectives.probe_backend("cpu")
    if multihost.process_shard()[0] == 0:
        Path(job["out"]).write_text(json.dumps(takes))


def run_cli(job: dict) -> None:
    mod = importlib.import_module(f"avsr_tpu_torch.cli.{job['cli']}")
    rc = mod.main(job["argv"])
    if rc:
        raise SystemExit(rc)


def main() -> None:
    torch.set_num_threads(1)
    for run in json.loads(Path(sys.argv[1]).read_text()):
        {"step": run_step, "decode": run_decode, "prefill": run_prefill, "probe": run_probe,
         "cli": run_cli}[run["kind"]](run)


if __name__ == "__main__":
    main()
