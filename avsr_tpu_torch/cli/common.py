"""Shared CLI plumbing of the port: the argument parser and the dataset.

``--config file.yaml`` plus positional ``section.key=value`` overrides (CLI
wins over YAML wins over defaults), ``--seed`` for the random weights and
``--device`` (default ``cuda``; tests pass ``cpu``).
"""

from __future__ import annotations

import argparse

from avsr_tpu_torch.core.config import AVSRConfig
from avsr_tpu_torch.data.dataset import SyntheticAVSRDataset


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--device", default="cuda")
    p.add_argument("overrides", nargs="*",
                   help="dotted config overrides, e.g. training.max_steps=10")
    return p


def build_dataset(cfg: AVSRConfig, tok, split: str) -> SyntheticAVSRDataset:
    """The synthetic dataset of ``split`` (the manifest dataset is not yet
    ported)."""
    if not cfg.data.synthetic:
        raise NotImplementedError(
            "the manifest dataset is not yet ported; set data.synthetic=true")
    return SyntheticAVSRDataset(cfg.data, tok, split=split,
                                modality=cfg.model.modality,
                                image_size=cfg.model.image_size)
