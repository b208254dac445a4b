"""Quick validation entry point, the port of ``avsr_tpu/cli/validate.py``.

Builds the model (a random init from ``--seed``, or ``--checkpoint``), runs
a handful of eval batches through ``train/step.py::make_eval_step`` and
exits non-zero if the average loss is non-finite or degenerate (at least
``DUMMY_LOSS / 2``), the JAX CLI's contract.

    python -m avsr_tpu_torch.cli.validate --synthetic --num_batches 2
    python -m avsr_tpu_torch.cli.validate --checkpoint RUN/ckpt --checkify

``--checkify`` keeps the JAX CLI's flag. JAX runs the loss under
``jax.experimental.checkify`` on its XLA path; here it turns on
``runtime.debug_nans``, so the first NaN loss raises ``FloatingPointError``
naming the step it arose in (``train/step.py::_raise_on_nan``). The check
sits outside the kernels, so they stay on.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from avsr_tpu_torch.cli.common import (base_parser, build_data, init_or_load_params,
                                       load_cli_config)
from avsr_tpu_torch.train.step import make_eval_step

log = logging.getLogger("avsr_tpu_torch.cli.validate")

DUMMY_LOSS = 1e6   # the reference's sentinel (quick_validate.py:285-298)


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Quick-validate a model/checkpoint")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--num_batches", type=int, default=2)
    p.add_argument("--synthetic", action="store_true",
                   help="shorthand for data.synthetic=true")
    p.add_argument("--checkify", action="store_true",
                   help="raise FloatingPointError at the first NaN loss "
                        "(runtime.debug_nans), the JAX CLI's checkify mode")
    args = p.parse_args(argv)
    if args.synthetic:
        args.overrides.append("data.synthetic=true")
    cfg = load_cli_config(args)
    if args.checkify:
        cfg = dataclasses.replace(
            cfg, runtime=dataclasses.replace(cfg.runtime, debug_nans=True))
    device = torch.device(args.device)

    _, _, loader = build_data(cfg, "valid" if not cfg.data.synthetic else "train",
                              shuffle=False, device=device)
    params = init_or_load_params(cfg, args.checkpoint, seed=args.seed, device=device)
    eval_step = make_eval_step(cfg)
    losses = []
    try:
        for i, (_, batch) in enumerate(loader):
            if i >= args.num_batches:
                break
            out = eval_step(params, batch)
            log.info("batch %d: loss %.4f acc %.3f", i, out["loss"], out["accuracy"])
            losses.append(out["loss"])
    finally:
        loader.close()

    avg = float(np.mean(losses)) if losses else float("nan")
    ok = np.isfinite(avg) and avg < DUMMY_LOSS / 2
    print(f"validation {'PASSED' if ok else 'FAILED'}: avg loss {avg:.4f} "
          f"over {len(losses)} batches")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
