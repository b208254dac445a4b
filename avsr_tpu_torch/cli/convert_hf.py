"""Convert local HF checkpoints (Whisper, HuBERT/Wav2Vec2, CLIP, ResNet,
EfficientNet, Llama) and fairseq AV-HuBERT checkpoints into a params export
of the port, the port of ``avsr_tpu/cli/convert_hf.py``.

Each component whose checkpoint is configured (``model.whisper_path``,
``model.audio_encoder_path`` for hubert/wav2vec2, ``model.clip_path``,
``model.video_encoder_path`` for resnet/efficientnet (an HF directory) or
avhubert (a fairseq ``.pt``), ``model.llm_path``) replaces its random init
with the converted weights;
the rest (connectors, LoRA) stays freshly initialized, from
``training.seed`` (the LoRA of a converted Llama from ``training.seed + 1``),
as in the JAX package. The directories are read by ``core/hf_files.py``,
without ``transformers``. The export (``train/checkpoint.py::export_params``)
loads with ``--checkpoint`` into every CLI of the port:

    python -m avsr_tpu_torch.cli.convert_hf --out exported \\
        model.whisper_path=/ckpts/whisper-medium \\
        model.clip_path=/ckpts/clip-vit-base-patch32 \\
        model.llm_path=/ckpts/Llama-3.2-1B
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from avsr_tpu_torch.cli.common import base_parser, load_cli_config
from avsr_tpu_torch.core.hf_files import load_pretrained
from avsr_tpu_torch.models.avhubert import convert_fairseq_avhubert, load_fairseq_checkpoint
from avsr_tpu_torch.models.avsr import init_avsr_model
from avsr_tpu_torch.models.clip_vit import convert_hf_clip_vision
from avsr_tpu_torch.models.efficientnet import convert_hf_efficientnet
from avsr_tpu_torch.models.hubert import convert_hf_speech_ssl
from avsr_tpu_torch.models.llama import add_lora, convert_hf_llama
from avsr_tpu_torch.models.resnet import convert_hf_resnet
from avsr_tpu_torch.models.whisper_encoder import convert_hf_whisper_encoder
from avsr_tpu_torch.train.checkpoint import export_params

log = logging.getLogger("avsr_tpu_torch.cli.convert_hf")


def build_converted_params(cfg, *, device: str | torch.device = "cuda"
                           ) -> tuple[dict, list[str]]:
    """Fresh-init params (f32, on ``device``) with every component whose
    checkpoint is configured replaced by its converted weights. Returns
    (params, notes); notes names the converted components."""
    m = cfg.model
    params = init_avsr_model(m, seed=cfg.training.seed, device=device)
    notes: list[str] = []
    audio = m.modality in ("audio", "both")
    video = m.modality in ("video", "both")

    if m.whisper_path and audio:
        sd, hf = load_pretrained(m.whisper_path, device)
        if hf["d_model"] != m.whisper.d_model:
            raise ValueError(f"whisper d_model mismatch: HF {hf['d_model']} vs config "
                             f"{m.whisper.d_model}")
        params["whisper"] = convert_hf_whisper_encoder(sd, m.whisper)
        notes.append("whisper")
        log.info("converted whisper from %s", m.whisper_path)

    if m.audio_encoder_path and audio and m.audio_encoder in ("hubert", "wav2vec2"):
        sd, hf = load_pretrained(m.audio_encoder_path, device)
        if hf["hidden_size"] != m.ssl.d_model:
            raise ValueError(f"{m.audio_encoder} d_model mismatch: HF {hf['hidden_size']} "
                             f"vs config {m.ssl.d_model}")
        params[m.audio_encoder] = convert_hf_speech_ssl(sd, m.ssl)
        notes.append(m.audio_encoder)
        log.info("converted %s from %s", m.audio_encoder, m.audio_encoder_path)

    if m.video_encoder_path and video and m.video_encoder == "resnet":
        sd, hf = load_pretrained(m.video_encoder_path, device)
        if tuple(hf["hidden_sizes"]) != m.resnet.hidden_sizes:
            raise ValueError(f"resnet hidden_sizes mismatch: HF {hf['hidden_sizes']} "
                             f"vs config {m.resnet.hidden_sizes}")
        params["resnet"] = convert_hf_resnet(sd, m.resnet)
        notes.append("resnet")
        log.info("converted resnet from %s", m.video_encoder_path)

    if m.video_encoder_path and video and m.video_encoder == "efficientnet":
        sd, hf = load_pretrained(m.video_encoder_path, device)
        if hf["hidden_dim"] != m.efficientnet.hidden_dim:
            raise ValueError(f"efficientnet hidden_dim mismatch: HF {hf['hidden_dim']} "
                             f"vs config {m.efficientnet.hidden_dim}")
        params["efficientnet"] = convert_hf_efficientnet(sd, m.efficientnet)
        notes.append("efficientnet")
        log.info("converted efficientnet from %s", m.video_encoder_path)

    if m.video_encoder_path and video and m.video_encoder == "avhubert":
        # AV-HuBERT ships as fairseq .pt checkpoints, not HF directories
        sd = {k: v.to(device) for k, v in
              load_fairseq_checkpoint(m.video_encoder_path).items()}
        params["avhubert"] = convert_fairseq_avhubert(sd, m.avhubert)
        notes.append("avhubert")
        log.info("converted avhubert from fairseq ckpt %s", m.video_encoder_path)

    if m.clip_path and video and m.video_encoder == "clip":
        sd, hf = load_pretrained(m.clip_path, device)
        hf = hf.get("vision_config", hf)         # a CLIPModel directory
        if hf["hidden_size"] != m.clip.d_model:
            raise ValueError(f"clip d_model mismatch: HF {hf['hidden_size']} vs config "
                             f"{m.clip.d_model}")
        params["clip"] = convert_hf_clip_vision(sd, m.clip)
        notes.append("clip")
        log.info("converted clip from %s", m.clip_path)

    if m.llm_path:
        sd, hf = load_pretrained(m.llm_path, device)
        if hf["hidden_size"] != m.llm.d_model:
            raise ValueError(f"llm d_model mismatch: HF {hf['hidden_size']} vs config "
                             f"{m.llm.d_model}")
        llm = convert_hf_llama(sd, m.llm)
        if m.lora.use_lora:
            gen = torch.Generator(device=device).manual_seed(cfg.training.seed + 1)
            llm = add_lora(gen, llm, m.llm, m.lora)
        params["llm"] = llm
        notes.append("llm")
        log.info("converted llm from %s", m.llm_path)
    return params, notes


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Convert local HF checkpoints to a params export of the port")
    p.add_argument("--out", required=True, help="output params directory")
    args = p.parse_args(argv)
    cfg = load_cli_config(args)
    params, notes = build_converted_params(cfg, device=args.device)
    out = Path(args.out).absolute()
    export_params(params, out)
    log.info("params export -> %s (converted: %s; load with --checkpoint %s)",
             out, ", ".join(notes) or "none", out)
    print(f"exported params to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
