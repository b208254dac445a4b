"""Training entry point of the PyTorch port, the counterpart of
``avsr_tpu/cli/train.py``:

    python -m avsr_tpu_torch.cli.train --config cfg.yaml --seed 0 \\
        data.synthetic=true training.max_steps=10 training.save_every_steps=0

The weights are a random init from ``--seed`` (trainable leaves f32,
frozen ones in the compute dtype); the loss log goes to
``training.checkpoint_dir/loss_log.csv``. Checkpoint loading and saving,
the manifest dataset and the other features the Trainer refuses are still
to be ported.
"""

from __future__ import annotations

import logging

import torch

from avsr_tpu_torch.cli.common import base_parser, build_dataset
from avsr_tpu_torch.core.config import load_config
from avsr_tpu_torch.data.loader import DataLoader
from avsr_tpu_torch.data.tokenizer import ByteTokenizer
from avsr_tpu_torch.models.avsr import init_avsr_model, summarize
from avsr_tpu_torch.train.loop import Trainer, check_supported
from avsr_tpu_torch.train.state import cast_frozen

log = logging.getLogger("avsr_tpu_torch.cli.train")


def main(argv: list[str] | None = None) -> int:
    args = base_parser("Train the AVSR model").parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = load_config(args.config, args.overrides)
    check_supported(cfg)
    device = torch.device(args.device)
    dtype = getattr(torch, cfg.runtime.compute_dtype)
    tok = ByteTokenizer()

    def loader(split: str, shuffle: bool) -> DataLoader:
        return DataLoader(build_dataset(cfg, tok, split), cfg.data, tok,
                          model_cfg=cfg.model, shuffle=shuffle,
                          seed=cfg.training.seed, device=device,
                          compute_dtype=dtype)

    params = init_avsr_model(cfg.model, seed=args.seed, device=device,
                             dtype=torch.float32)
    params = cast_frozen(params, cfg.model, dtype)
    log.info("model summary: %s", summarize(params, cfg.model))
    trainer = Trainer(cfg, params, loader("train", True), loader("valid", False))
    result = trainer.train()
    log.info("done: %s", result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
