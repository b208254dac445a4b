"""Shared CLI plumbing of the port: the argument parser, the config (with
logging set up), the tokenizer, dataset and loader of a
split, and the weights (a random init, or a checkpoint of the port's
Trainer or a params export over it: ``cli/average.py``'s, or the
converters' ``cli/convert_hf.py`` and ``cli/convert_ref_ckpt.py``, whose
f32 exports restore into any config of the same geometry and are
quantized after loading for a quantized one).

``load_multilora`` gives the base and the adapter bank of multi-tenant
serving (``cli/serve.py --adapter``).

Multi-process runs (torchrun's environment, ``mesh/multihost.py``):
``maybe_mesh`` is the JAX ``maybe_mesh`` for one process per card (the
process group, this rank's device, the mesh of ``cfg.mesh`` over the
world; None at a world of 1), ``build_data`` gives the train and valid
splits' loaders their ``data_shard`` at a world above 1 (over the data axes:
the tp, sp and pp ranks of a position load the same rows), ranks above 0 log
warnings only, and ``refuse_world`` stops the CLIs that run on one card.

``--config file.yaml`` plus positional ``section.key=value`` overrides (CLI
wins over YAML wins over defaults), ``--seed`` for the random weights,
``--device`` (default ``cuda``; tests pass ``cpu``), ``--log_file`` and
``--verbose``. The train CLI also takes ``--mode``, a memory preset
(:data:`MODE_OVERRIDES`). The tokenizer is ``model.llm_path``'s HF
tokenizer when it is set, the byte tokenizer otherwise.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import torch

from avsr_tpu_torch.convert import cast_tree
from avsr_tpu_torch.core.config import AVSRConfig, load_config
from avsr_tpu_torch.core.logging import setup_logging
from avsr_tpu_torch.data.dataset import build_dataset
from avsr_tpu_torch.data.loader import DataLoader
from avsr_tpu_torch.data.tokenizer import load_tokenizer
from avsr_tpu_torch.infer.adapters import extract_lora, stack_lora_bank, tree_map
from avsr_tpu_torch.infer.generate import prepare_params_for_decode
from avsr_tpu_torch.mesh.multihost import init_distributed, process_shard, refuse_world
from avsr_tpu_torch.mesh.sharding import Mesh, build_mesh, check_model
from avsr_tpu_torch.models.avsr import init_avsr_model
from avsr_tpu_torch.models.layers import Params
from avsr_tpu_torch.ops.quant import quantize_llm
from avsr_tpu_torch.train.checkpoint import CheckpointManager, load_params
from avsr_tpu_torch.train.state import cast_frozen

log = logging.getLogger("avsr_tpu_torch.cli")


# Memory presets, the JAX train CLI's ``--mode`` (the reference's
# train_modes.sh: standard / fp16 / 4bit / max, plus 8bit): each is a list
# of dotted overrides applied before the positional ones, so an explicit
# key=value still wins. bf16 is the half type of the card's tensor cores
# as well, so "fp16" pins the bf16 compute dtype.
MODE_OVERRIDES: dict[str, list[str]] = {
    "standard": [],
    "fp16": ["runtime.compute_dtype=bfloat16"],
    "4bit": ["model.use_4bit=true"],
    "8bit": ["model.use_8bit=true"],
    "max": ["model.use_4bit=true", "mesh.remat=true",
            "training.grad_accum_steps=8", "data.batch_size=1"],
}


def base_parser(description: str, *, modes: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--device", default="cuda")
    p.add_argument("--log_file", default=None)
    p.add_argument("--verbose", action="store_true")
    if modes:
        p.add_argument("--mode", dest="memory_mode", choices=sorted(MODE_OVERRIDES),
                       default=None,
                       help="memory preset (config overrides; an explicit "
                            "key=value still wins)")
    p.add_argument("overrides", nargs="*",
                   help="dotted config overrides, e.g. training.max_steps=10")
    return p


def load_cli_config(args: argparse.Namespace, *,
                    across_processes: bool = False) -> AVSRConfig:
    """The config of parsed CLI arguments: the YAML file, then the
    ``--mode`` preset's overrides, then the positional ones. Sets up
    logging (``--log_file``, ``--verbose``) first. A CLI that does not run
    ``across_processes`` (all but train and decode) stops in a world above
    1 (:func:`refuse_world`)."""
    if not across_processes:
        refuse_world(f"the {Path(sys.argv[0]).stem} CLI")
    level = logging.DEBUG if getattr(args, "verbose", False) else logging.INFO
    if process_shard()[0] > 0:      # a multi-process run logs from rank 0
        level = logging.WARNING
    setup_logging(getattr(args, "log_file", None), level=level)
    overrides = list(args.overrides)
    mode = getattr(args, "memory_mode", None)
    if mode:
        overrides = MODE_OVERRIDES[mode] + overrides
        log.info("mode=%s -> %s", mode, " ".join(MODE_OVERRIDES[mode]) or "(defaults)")
    return load_config(args.config, overrides)


def validate_modality_media(cfg: AVSRConfig, parser: argparse.ArgumentParser, *,
                            have_audio: bool, have_video: bool) -> None:
    """The params tree is built from model.modality, so the media given
    must match it (override model.modality=... to run another mode)."""
    need_audio = cfg.model.modality in ("audio", "both")
    need_video = cfg.model.modality in ("video", "both")
    if (need_audio and not have_audio) or (need_video and not have_video):
        parser.error(
            f"model.modality={cfg.model.modality!r} needs "
            f"{'--audio ' if need_audio else ''}"
            f"{'--video' if need_video else ''} "
            "(or override model.modality=audio/video/both)")


def build_data(cfg: AVSRConfig, split: str = "train", *, shuffle: bool | None = None,
               batch_size: int | None = None, device: str | torch.device = "cuda",
               whole: bool = False, mesh: Mesh | None = None):
    """-> (tokenizer, dataset, loader) of ``split``: ``model.llm_path``'s
    tokenizer, the synthetic or manifest dataset (``data.synthetic``), and
    a loader shuffling the train split only (unless ``shuffle`` says). With
    a ``mesh`` the train and valid loaders yield this rank's rows of each
    global batch (``data_shard``: its position over the data axes, as the
    JAX CLI splits rows over them; the tp ranks of a position load the same
    rows), unless ``whole`` (the decode CLI splits whole batches itself)."""
    tok = load_tokenizer(cfg.model.llm_path or None)
    ds = build_dataset(cfg.data, tok, split=split, modality=cfg.model.modality,
                       image_size=cfg.model.image_size)
    data_shard = None
    if split in ("train", "valid") and mesh is not None and not whole:
        data_shard = (mesh.data.rank, mesh.ways)
    loader = DataLoader(ds, cfg.data, tok, model_cfg=cfg.model, batch_size=batch_size,
                        shuffle=(split == "train") if shuffle is None else shuffle,
                        seed=cfg.training.seed, device=device,
                        compute_dtype=getattr(torch, cfg.runtime.compute_dtype),
                        data_shard=data_shard)
    return tok, ds, loader


def maybe_mesh(cfg: AVSRConfig, device: str | torch.device
               ) -> tuple[torch.device, Mesh | None]:
    """(this rank's device, the mesh) of a multi-process run, the JAX
    ``maybe_mesh`` for one process per card: the process group from
    torchrun's environment and the mesh of ``cfg.mesh`` over its world.
    (``device``, None) at a world of 1: no process group, the single-card
    port."""
    device, backend = init_distributed(device)
    if backend is None:
        return device, None
    check_model(cfg.model, cfg.mesh.tp, cfg.decode.lm_head_bits, cfg.mesh.pp)
    rank, world = process_shard()
    return device, build_mesh(cfg.mesh, world=world, rank=rank)


def init_or_load_params(cfg: AVSRConfig, checkpoint: str | None = None, *,
                        seed: int, device: str | torch.device = "cuda") -> Params:
    """The counterpart of the JAX ``init_or_load_params``: a random init
    from ``seed`` in ``runtime.param_dtype``, the LLM's projections
    quantized when ``model.use_4bit``/``use_8bit`` asks, then, with
    ``checkpoint``, the weights of a trainer checkpoint directory (its
    newest step) or of a params export in their place, and last frozen
    leaves in ``runtime.compute_dtype`` (integer leaves untouched, the
    projections' f32 scales rounded to it) and trainable ones in f32
    (``cast_frozen``). The order is the JAX package's, so the integers and
    scales round as they do there.

    A quantized config restores a quantized checkpoint as it is; a
    full-precision one (a bf16 training run, an average) is restored into
    the float tree and then quantized: train in bf16, serve the preset.
    Checkpoints are the port's own format (``train/checkpoint.py``), so the
    JAX package's repack of legacy interleaved int4 leaves has nothing to
    read here and is not ported."""
    m = cfg.model
    params_fp = init_avsr_model(m, seed=seed, device=device,
                                dtype=getattr(torch, cfg.runtime.param_dtype))
    bits = 4 if m.use_4bit else 8 if m.use_8bit else 0

    def quantize(p: Params) -> Params:
        return {**p, "llm": quantize_llm(p["llm"], bits)}

    params = quantize(params_fp) if bits else params_fp
    if checkpoint:
        if bits:
            try:
                params = _restore(checkpoint, params)
            except ValueError:
                log.info("checkpoint is full-precision: quantizing after restore")
                params = quantize(_restore(checkpoint, params_fp))
        else:
            params = _restore(checkpoint, params)
    return cast_frozen(params, m, getattr(torch, cfg.runtime.compute_dtype))


def init_params(cfg: AVSRConfig, *, seed: int,
                device: str | torch.device = "cuda") -> Params:
    """:func:`init_or_load_params` without a checkpoint."""
    return init_or_load_params(cfg, None, seed=seed, device=device)


def _restore(checkpoint: str, params_like: Params) -> Params:
    """The params of a trainer checkpoint directory (one holding
    ``best.json`` or ``meta_*.json``: its newest step) or of a params
    export, checked against and cast to ``params_like``. A JAX run's Orbax
    directory raises a ``ValueError`` that names ``tools/orbax_to_port.py``."""
    ck = Path(checkpoint)
    if (ck / "best.json").exists() or any(ck.glob("meta_*.json")):
        step = CheckpointManager(ck).latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint step in {ck}")
        ck = ck / str(step)
    return load_params(ck, params_like)


def load_decode_params(cfg: AVSRConfig, checkpoint: str | None = None, *,
                       seed: int, device: str | torch.device = "cuda",
                       return_raw: bool = False,
                       mesh: Mesh | None = None) -> Params | tuple[Params, Params]:
    """The serving weights, the counterpart of the JAX
    ``load_decode_params``: :func:`init_or_load_params`, the trainable
    leaves (connectors, LoRA) in the compute dtype too (decode never
    trains, and every use casts them to the activation dtype anyway), then
    ``prepare_params_for_decode`` with ``decode.lm_head_bits``, whose head
    keeps its f32 scale. ``return_raw`` also returns the tree of
    :func:`init_or_load_params` (speculative decoding builds its self-draft
    from it); it shares the frozen leaves of the serving tree's encoders.
    With a ``mesh`` (tp above 1) the serving tree holds this rank's tp
    slices, cut after the quantization (``prepare_params_for_decode``)."""
    raw = init_or_load_params(cfg, checkpoint, seed=seed, device=device)
    params = prepare_params_for_decode(
        cast_tree(raw, getattr(torch, cfg.runtime.compute_dtype)), cfg.model,
        lm_head_bits=cfg.decode.lm_head_bits, mesh=mesh)
    return (params, raw) if return_raw else params


def load_multilora(cfg: AVSRConfig, checkpoint: str | None, adapter_ckpts: list[str], *,
                   seed: int, device: str | torch.device = "cuda"
                   ) -> tuple[Params, Params | None]:
    """Base params + stacked adapter bank for multi-tenant LoRA serving,
    the JAX ``load_multilora``.

    The base loads RAW (unfused — the per-projection adapters must target
    unconcatenated q/k/v; quantized base leaves from use_4bit/8bit compose
    fine), with only the lm head optionally quantized for serving
    (decode.lm_head_bits keeps the tree structure). Each adapter
    checkpoint is any trainer checkpoint or params export for THIS config
    whose LLM carries lora leaves; only those leaves are read
    (:func:`load_adapter`) and moved to ``device``. Returns
    (params, bank) for ``ServingEngine``/``AVSRServer(adapter_bank=...)``;
    no adapters give no bank (the runtime-onboarding start state)."""
    if not cfg.model.lora.use_lora:
        raise ValueError("--adapter serving needs model.lora.use_lora=true")
    params = init_or_load_params(cfg, checkpoint, seed=seed, device=device)
    if cfg.decode.lm_head_bits:
        params = {**params, "llm": quantize_llm(params["llm"], 0,
                                                lm_head_bits=cfg.decode.lm_head_bits)}
    bank = (stack_lora_bank([tree_map(lambda t: t.to(device), load_adapter(ck))
                             for ck in adapter_ckpts]) if adapter_ckpts else None)
    return params, bank


def load_adapter(checkpoint: str) -> Params:
    """The LoRA leaves (``extract_lora``) of a trainer checkpoint
    directory (its newest step) or a params export, read to the CPU with
    no model built around them: adapter onboarding loads them on a server's
    handler thread, which touches no device."""
    ck = Path(checkpoint)
    if (ck / "best.json").exists() or any(ck.glob("meta_*.json")):
        step = CheckpointManager(ck).latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint step in {ck}")
        ck = ck / str(step)
    return extract_lora(load_params(ck)["llm"])
