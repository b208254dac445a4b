"""Checkpoint averaging, the port of ``avsr_tpu/cli/average.py``: export
the element-wise mean of K trainer checkpoints' params.

    python -m avsr_tpu_torch.cli.average --config cfg.yaml \\
        --checkpoint outputs/avsr/ckpt --last 3 --out outputs/avsr/avg_params

The output is a params export of the port's format: pass it to
``python -m avsr_tpu_torch.cli.decode --checkpoint outputs/avsr/avg_params``.
Averaging runs in float32 and casts back to each leaf's dtype; non-float
leaves must be identical across the checkpoints (the first, oldest, tree's
leaf is kept). Quantized (use_4bit/use_8bit) configs are refused: packed
integer leaves do not average, so average the float run and quantize the
result when loading it.
"""

from __future__ import annotations

import logging
from typing import Any

import torch

from avsr_tpu_torch.cli.common import base_parser
from avsr_tpu_torch.core.config import load_config
from avsr_tpu_torch.models.avsr import init_avsr_model
from avsr_tpu_torch.train.checkpoint import (CheckpointManager, export_params,
                                             load_params)
from avsr_tpu_torch.train.state import cast_frozen

log = logging.getLogger("avsr_tpu_torch.cli.average")


def average_params(trees: list[Any]) -> Any:
    """Element-wise float32 mean over param trees of one structure, cast
    back to each leaf's dtype. Non-float leaves must agree across trees."""
    def avg(*leaves: torch.Tensor) -> torch.Tensor:
        first = leaves[0]
        if not first.is_floating_point():
            if any(not torch.equal(first, other) for other in leaves[1:]):
                raise ValueError("non-float param leaf differs between "
                                 "checkpoints: these runs do not average")
            return first
        acc = sum(x.to(torch.float32) for x in leaves)
        return (acc / len(leaves)).to(first.dtype)

    def zip_all(*nodes: Any) -> Any:
        if isinstance(nodes[0], dict):
            return {k: zip_all(*[n[k] for n in nodes]) for k in nodes[0]}
        if isinstance(nodes[0], (list, tuple)):
            return [zip_all(*xs) for xs in zip(*nodes)]
        return avg(*nodes)

    return zip_all(*trees)


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Average trainer checkpoints into a params export")
    p.add_argument("--checkpoint", required=True,
                   help="trainer checkpoint dir (training.checkpoint_dir/ckpt)")
    p.add_argument("--last", type=int, default=0,
                   help="average the newest N retained steps (0 = all)")
    p.add_argument("--steps", default="",
                   help="comma-separated step list (overrides --last)")
    p.add_argument("--out", required=True, help="params export path")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = load_config(args.config, args.overrides)
    if cfg.model.use_4bit or cfg.model.use_8bit:
        raise SystemExit(
            "average: quantized (use_4bit/use_8bit) checkpoints do not "
            "average; average the float run and quantize at load")

    mngr = CheckpointManager(args.checkpoint)
    steps = mngr.all_steps()
    if args.steps:
        steps = [int(s) for s in args.steps.split(",")]
    elif args.last > 0:
        steps = steps[-args.last:]
    if len(steps) < 2:
        raise SystemExit(f"average: need >= 2 checkpoints, found {steps} in "
                         f"{args.checkpoint}")
    log.info("averaging %d checkpoints: %s", len(steps), steps)
    # the structure, dtypes and device of what the Trainer saved
    like = cast_frozen(init_avsr_model(cfg.model, seed=0, device=args.device,
                                       dtype=getattr(torch, cfg.runtime.param_dtype)),
                       cfg.model, getattr(torch, cfg.runtime.compute_dtype))
    trees = [load_params(mngr.dir / str(s), like) for s in steps]
    export_params(average_params(trees), args.out)
    log.info("averaged params -> %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
