"""Shared CLI plumbing of the port: the argument parser, the dataset and
the weights.

``--config file.yaml`` plus positional ``section.key=value`` overrides (CLI
wins over YAML wins over defaults), ``--seed`` for the random weights and
``--device`` (default ``cuda``; tests pass ``cpu``).
"""

from __future__ import annotations

import argparse

import torch

from avsr_tpu_torch.convert import cast_tree
from avsr_tpu_torch.core.config import AVSRConfig
from avsr_tpu_torch.data.dataset import SyntheticAVSRDataset
from avsr_tpu_torch.infer.generate import prepare_params_for_decode
from avsr_tpu_torch.models.avsr import init_avsr_model
from avsr_tpu_torch.models.layers import Params
from avsr_tpu_torch.ops.quant import quantize_llm
from avsr_tpu_torch.train.state import cast_frozen


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


def init_params(cfg: AVSRConfig, *, seed: int,
                device: str | torch.device = "cuda") -> Params:
    """The counterpart of the JAX ``init_or_load_params`` without
    checkpoints: a random init from ``seed`` in ``runtime.param_dtype``,
    the LLM's projections quantized when ``model.use_4bit``/``use_8bit``
    asks, then frozen leaves in ``runtime.compute_dtype`` (integer leaves
    untouched, the projections' f32 scales rounded to it) and trainable
    ones in f32 (``cast_frozen``). The order is the JAX package's, so the
    integers and scales round as they do there."""
    m = cfg.model
    params = init_avsr_model(m, seed=seed, device=device,
                             dtype=getattr(torch, cfg.runtime.param_dtype))
    bits = 4 if m.use_4bit else 8 if m.use_8bit else 0
    if bits:
        params = {**params, "llm": quantize_llm(params["llm"], bits)}
    return cast_frozen(params, m, getattr(torch, cfg.runtime.compute_dtype))


def load_decode_params(cfg: AVSRConfig, *, seed: int,
                       device: str | torch.device = "cuda") -> Params:
    """The serving weights, the counterpart of the JAX
    ``load_decode_params`` without checkpoints: :func:`init_params`, the
    trainable leaves (connectors, LoRA) in the compute dtype too (decode
    never trains, and every use casts them to the activation dtype
    anyway), then ``prepare_params_for_decode`` with
    ``decode.lm_head_bits``, whose head keeps its f32 scale."""
    params = cast_tree(init_params(cfg, seed=seed, device=device),
                       getattr(torch, cfg.runtime.compute_dtype))
    return prepare_params_for_decode(params, cfg.model,
                                     lm_head_bits=cfg.decode.lm_head_bits)
