"""Training entry point of the PyTorch port, the counterpart of
``avsr_tpu/cli/train.py``:

    python -m avsr_tpu_torch.cli.train --config cfg.yaml --seed 0 \\
        data.synthetic=true training.max_steps=10 training.save_every_steps=5

The weights are a random init from ``--seed`` (trainable leaves f32,
frozen ones in the compute dtype; with ``model.use_4bit`` or ``use_8bit``
the LLM's projections quantized, QLoRA), or with ``--checkpoint`` a params
export (``cli/convert_hf.py``, ``cli/convert_ref_ckpt.py``,
``cli/average.py``) or a trainer checkpoint's newest step over it. ``--mode`` picks a memory preset
(``cli/common.py::MODE_OVERRIDES``), and ``training.auto_batch_size`` sets
``data.batch_size`` from the batch-size probe (``train/probe.py``) on a
second init. The loss log, the loss history and the checkpoints (``ckpt/``,
the port's own format) go to ``training.checkpoint_dir``; a run whose
``ckpt/`` holds a step, or one given ``training.resume_from``, resumes from
it mid-epoch. ``data.synthetic=false`` trains on the manifest corpus
under ``data.path`` (``{train,valid}.{tsv,wrd}``, e.g. written by
``cli/prepare_data.py``); without a valid split it trains without
validation. The tokenizer is ``model.llm_path``'s, or the byte tokenizer.

Across processes, one per card (torchrun's environment; ``mesh.dp``,
``mesh.fsdp``, ``mesh.dcn_dp``, ``mesh.ep``, ``mesh.tp``, ``mesh.sp`` and
``mesh.pp`` over the world, ``mesh.dp=-1`` inferred from it):

    torchrun --nproc_per_node 2 -m avsr_tpu_torch.cli.train ... mesh.fsdp=2
    torchrun --nproc_per_node 2 -m avsr_tpu_torch.cli.train ... mesh.tp=2
    torchrun --nproc_per_node 2 -m avsr_tpu_torch.cli.train ... mesh.sp=2
    torchrun --nproc_per_node 2 -m avsr_tpu_torch.cli.train ... mesh.pp=2 model.lora.dropout=0
    torchrun --nproc_per_node 2 -m avsr_tpu_torch.cli.train ... mesh.ep=2 model.connector_type=moe

each rank loads its rows of every global batch (``data.batch_size`` stays
the global batch; the rows split over the data axes, the tp ranks of a
data position load the same rows and run Megatron blocks on their slices,
and its sp ranks load the same rows and run the block stacks on their
chunks of the sequences with ring attention; its pp ranks load the same
rows and each runs its stage of the LLM's blocks, GPipe; ep is a data
axis whose ranks also split the stacked experts of a MoE model, and every
MoE block routes over the global batch, as JAX's), the probe runs under
the mesh, and rank 0 alone writes the logs and checkpoints (the full
tree, the experts gathered), which resume at any world.
"""

from __future__ import annotations

import dataclasses
import gc
import logging

import torch

from avsr_tpu_torch.cli.common import (base_parser, build_data, init_or_load_params,
                                       init_params, load_cli_config, maybe_mesh)
from avsr_tpu_torch.models.avsr import summarize
from avsr_tpu_torch.train.loop import Trainer
from avsr_tpu_torch.train.probe import find_optimal_batch_size

log = logging.getLogger("avsr_tpu_torch.cli.train")


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Train the AVSR model", modes=True)
    p.add_argument("--checkpoint", default=None,
                   help="initial weights: a params export or trainer checkpoint dir")
    args = p.parse_args(argv)
    cfg = load_cli_config(args, across_processes=True)
    device, mesh = maybe_mesh(cfg, args.device)
    if cfg.training.auto_batch_size:
        probe_params = init_params(cfg, seed=args.seed, device=device)
        best = find_optimal_batch_size(cfg, probe_params, device=device, mesh=mesh)
        del probe_params
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if best > cfg.data.batch_size:
            log.info("auto_batch_size: %d -> %d", cfg.data.batch_size, best)
            cfg = dataclasses.replace(
                cfg, data=dataclasses.replace(cfg.data, batch_size=best))
    tok, _, train_loader = build_data(cfg, "train", device=device, mesh=mesh)
    try:
        _, _, val_loader = build_data(cfg, "valid", shuffle=False, device=device,
                                      mesh=mesh)
    except FileNotFoundError:
        log.warning("no validation split found — training without val")
        val_loader = None

    params = init_or_load_params(cfg, args.checkpoint, seed=args.seed, device=device)
    log.info("model summary: %s", summarize(params, cfg.model))
    trainer = Trainer(cfg, params, train_loader, val_loader, tok=tok, mesh=mesh)
    del params
    try:
        trainer.maybe_resume()
        result = trainer.train()
    finally:
        for loader in (train_loader, val_loader):
            if loader is not None:
                loader.close()
    log.info("done: %s", result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
