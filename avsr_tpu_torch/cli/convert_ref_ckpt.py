"""Convert a reference-trainer checkpoint (``.pt``) into a params export of
the port, the port of ``avsr_tpu/cli/convert_ref_ckpt.py``.

The reference trainer saves ``{epoch, model_state_dict, ...}`` whose
``model_state_dict`` holds ``whisper.*`` and ``clip.*`` (HF encoders),
``llm.*`` (an HF causal LM, peft-wrapped under LoRA) and
``audio_connector.*`` / ``video_connector.*``. What transfers exactly: the
encoder and LLM base weights (through the HF converters), the trained peft
LoRA adapters (``a = Aᵀ``, ``b = Bᵀ``; peft's alpha / r scaling is the
config's ``lora_scale``) and ``simple`` connectors (``w = Wᵀ``). Other
connector types are not weight-compatible with the reference's and stay at
their fresh init, with a warning. Fresh leaves come from ``training.seed``.

    python -m avsr_tpu_torch.cli.convert_ref_ckpt --checkpoint model_best.pt \\
        --out exported [overrides]
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Any

import torch

from avsr_tpu_torch.cli.common import base_parser, load_cli_config
from avsr_tpu_torch.models.avsr import init_avsr_model
from avsr_tpu_torch.models.clip_vit import convert_hf_clip_vision
from avsr_tpu_torch.models.llama import add_lora, convert_hf_llama
from avsr_tpu_torch.models.whisper_encoder import convert_hf_whisper_encoder
from avsr_tpu_torch.train.checkpoint import export_params

log = logging.getLogger("avsr_tpu_torch.cli.convert_ref")

_PREFIXES = ("whisper", "clip", "llm", "audio_connector", "video_connector")


def split_ref_state_dict(sd: dict[str, Any]) -> dict[str, dict[str, Any]]:
    """Group a reference model's state dict by top-level submodule, the
    prefix stripped. Other top-level keys are ignored."""
    out: dict[str, dict[str, Any]] = {p: {} for p in _PREFIXES}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if head in out and rest:
            out[head][rest] = v
    return {k: v for k, v in out.items() if v}


_PEFT_WRAP = "base_model.model."
# "...q_proj.lora_A.default.weight" (the adapter name is optional in older exports)
_LORA_RE = re.compile(r"^(.*)\.lora_(A|B)(?:\.[^.]+)?\.weight$")


def normalize_peft_llm(sd: dict[str, Any]
                       ) -> tuple[dict[str, Any], dict[str, dict[str, Any]]]:
    """A peft LoraModel state dict -> (the plain causal-LM state dict, the
    LoRA map {module path: {"A": [r, d_in], "B": [d_out, r]}}). A state dict
    without peft passes through with an empty map."""
    base: dict[str, Any] = {}
    lora: dict[str, dict[str, Any]] = {}
    for k, v in sd.items():
        if k.startswith(_PEFT_WRAP):
            k = k[len(_PEFT_WRAP):]
        m = _LORA_RE.match(k)
        if m:
            lora.setdefault(m.group(1), {})[m.group(2)] = v
            continue
        # a wrapped Linear's frozen weight: "...q_proj.base_layer.weight"
        base[k.replace(".base_layer.", ".")] = v
    return base, lora


_HF_TO_OURS = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o",
               "gate_proj": "gate", "up_proj": "up", "down_proj": "down"}


def attach_trained_lora(llm_params: dict, lora: dict[str, dict[str, Any]],
                        lora_cfg) -> tuple[dict, int]:
    """Put the checkpoint's trained adapters on the converted LLM, in f32:
    the port computes ``y + (alpha/r) * x @ a @ b`` and peft ``y +
    (alpha/r) * B(A(x))``, so ``a = Aᵀ`` [d_in, r] and ``b = Bᵀ`` [r, d_out].
    The rank must be ``model.lora.r`` (the scale alpha / r comes from the
    config, so another rank would rescale the trained update silently)."""
    n = 0
    for path, ab in lora.items():
        m = re.match(r"^model\.layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)$", path)
        if not m or "A" not in ab or "B" not in ab:
            raise ValueError(f"unrecognized LoRA module in checkpoint: {path}")
        li, tgt = int(m.group(1)), _HF_TO_OURS.get(m.group(2))
        if tgt is None or li >= len(llm_params["layers"]):
            raise ValueError(f"LoRA target {path} has no counterpart here")
        A, B = ab["A"].detach().float(), ab["B"].detach().float()
        if A.shape[0] != lora_cfg.r:
            raise ValueError(
                f"checkpoint LoRA rank {A.shape[0]} != model.lora.r "
                f"{lora_cfg.r} — set model.lora.r (and alpha) to the values "
                "the reference run used")
        llm_params["layers"][li][tgt]["lora"] = {"a": A.T.contiguous(),
                                                 "b": B.T.contiguous()}
        n += 1
    return llm_params, n


def convert_simple_connector(sd: dict[str, Any]) -> dict:
    """The reference's simple connector (one nn.Linear) -> the port's
    ``simple`` connector {"out": {"w" [d_in, d_out], "b"}}, in f32."""
    return {"out": {"w": sd["linear.weight"].detach().float().T.contiguous(),
                    "b": sd["linear.bias"].detach().float().clone()}}


def build_ref_converted_params(cfg, ckpt_path: str, *,
                               device: str | torch.device = "cuda"
                               ) -> tuple[dict, list[str]]:
    """Fresh-init params (on ``device``) with everything transferable from
    a reference trainer checkpoint in their place. Returns (params, notes)."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    if not isinstance(sd, dict) or not any(
            k.partition(".")[0] in _PREFIXES for k in sd):
        raise ValueError(
            f"{ckpt_path} does not look like a reference trainer checkpoint "
            "(expected model_state_dict with whisper./clip./llm./*_connector. "
            "keys)")
    parts = {name: {k: v.to(device) for k, v in part.items()}
             for name, part in split_ref_state_dict(sd).items()}
    epoch = ckpt.get("epoch") if isinstance(ckpt, dict) else None
    log.info("reference checkpoint%s: found %s",
             f" (epoch {epoch})" if epoch is not None else "", ", ".join(sorted(parts)))

    m = cfg.model
    params = init_avsr_model(m, seed=cfg.training.seed, device=device)
    notes: list[str] = []
    if "whisper" in parts and "whisper" in params:
        params["whisper"] = convert_hf_whisper_encoder(parts["whisper"], m.whisper)
        notes.append("whisper")
    if "clip" in parts and "clip" in params:
        params["clip"] = convert_hf_clip_vision(parts["clip"], m.clip)
        notes.append("clip")
    if "llm" in parts:
        base_sd, lora = normalize_peft_llm(parts["llm"])
        llm = convert_hf_llama(base_sd, m.llm)
        if lora:
            if not m.lora.use_lora:
                raise ValueError("checkpoint carries trained LoRA adapters but "
                                 "model.lora.use_lora is false")
            llm, n = attach_trained_lora(llm, lora, m.lora)
            notes.append(f"llm+lora({n})")
        else:
            if m.lora.use_lora:
                gen = torch.Generator(device=device).manual_seed(cfg.training.seed + 1)
                llm = add_lora(gen, llm, m.llm, m.lora)
            notes.append("llm")
        params["llm"] = llm
    for side in ("audio_connector", "video_connector"):
        if side not in parts or side not in params:
            continue
        if m.connector_type == "simple":
            params[side] = convert_simple_connector(parts[side])
            notes.append(side)
        else:
            log.warning("%s: reference %r connector weights are NOT transferable "
                        "(the architecture here differs); leaving it at fresh init",
                        side, m.connector_type)
    return params, notes


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Convert a reference trainer .pt checkpoint to a params export "
                    "of the port")
    p.add_argument("--checkpoint", required=True,
                   help="reference model_best.pt / checkpoint_epoch_N.pt")
    p.add_argument("--out", required=True, help="output params directory")
    args = p.parse_args(argv)
    cfg = load_cli_config(args)
    params, notes = build_ref_converted_params(cfg, args.checkpoint, device=args.device)
    out = Path(args.out).absolute()
    export_params(params, out)
    log.info("params export -> %s (converted: %s)", out, ", ".join(notes))
    print(f"exported params to {out} (converted: {', '.join(notes)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
