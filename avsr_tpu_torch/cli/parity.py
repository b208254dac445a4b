"""Pretrained-weights parity harness, the port of ``avsr_tpu/cli/parity.py``:
convert HF checkpoints, hold each of the port's modules against the
``transformers`` module on one input, optionally decode a real WAV or a
manifest split end to end, and write ``parity_report.json``.

    python -m avsr_tpu_torch.cli.parity --report parity_report.json \\
        [--wav utt.wav [--ref-text "ground truth"]] \\
        [--manifest DIR [--split test]] \\
        model.whisper_path=/ckpts/whisper-medium \\
        model.clip_path=/ckpts/clip-vit-base-patch32 \\
        model.llm_path=/ckpts/Llama-3.2-1B

Per configured component it reads the directory with the export CLI's
reader and converter (``core/hf_files.py``, ``models/*.convert_hf_*``),
runs a deterministic input through the port's module on ``--device`` and
through the ``transformers`` module on the CPU in f32, and records the
max and mean absolute error against :data:`TOLERANCES` (the JAX CLI's).
On the card TF32 is turned off, since the JAX CLI pins f32 matmuls.
``--wav`` greedy-decodes one utterance with the converted model (and
scores it against ``--ref-text``); ``--manifest`` runs the decode CLI's
protocol (``cli/decode.py::run_protocol``) over a manifest split.

Exit status: 0 = every checked module within tolerance; 1 = at least one
out of it; 3 = no assets found (nothing checked). ``transformers`` is
imported only by the checks: on a host without it a configured directory
raises an ``ImportError`` that names the package.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from avsr_tpu_torch.cli.common import base_parser, load_cli_config
from avsr_tpu_torch.cli.convert_hf import build_converted_params
from avsr_tpu_torch.core.hf_files import load_pretrained

log = logging.getLogger("avsr_tpu_torch.cli.parity")

# Per-module max-abs-error tolerances, the JAX CLI's: f32 forwards; the
# encoders compare hidden states (O(1) magnitudes), the LLM vocab logits
# (O(10) at 1B scale, deeper accumulation).
TOLERANCES = {
    "whisper": 2e-3,
    "hubert": 2e-3,
    "wav2vec2": 2e-3,
    "clip": 2e-3,
    "resnet": 2e-3,
    "efficientnet": 2e-3,
    "llm": 5e-2,
}


def _hf(name: str):
    """The ``transformers`` class ``name``: the reference side of a check."""
    try:
        import transformers
    except ImportError as e:
        raise ImportError("the parity harness needs the `transformers` package "
                          "for its reference modules, and it is not installed") from e
    return getattr(transformers, name)


def _err(ours: np.ndarray, ref: np.ndarray) -> dict:
    d = np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64))
    return {
        "max_abs_err": float(d.max()),
        "mean_abs_err": float(d.mean()),
        "ref_abs_mean": float(np.abs(ref).mean()),
    }


def _module_entry(name: str, path: str, ours: torch.Tensor, ref: torch.Tensor) -> dict:
    e = _err(ours.float().cpu().numpy(), ref.numpy())
    tol = TOLERANCES[name]
    entry = {"path": path, "tol_max_abs": tol, **e,
             "pass": bool(e["max_abs_err"] <= tol)}
    log.info("%s: max|err| %.2e (tol %.0e) mean|err| %.2e -> %s",
             name, e["max_abs_err"], tol, e["mean_abs_err"],
             "PASS" if entry["pass"] else "FAIL")
    return entry


@torch.no_grad()
def _check_whisper(m, rng, device) -> dict:
    from avsr_tpu_torch.models.whisper_encoder import (convert_hf_whisper_encoder,
                                                       whisper_encoder_apply)

    model = _hf("WhisperModel").from_pretrained(m.whisper_path, local_files_only=True).eval()
    params = convert_hf_whisper_encoder(load_pretrained(m.whisper_path, device)[0], m.whisper)
    mel = torch.from_numpy(rng.standard_normal(
        (1, m.whisper.n_mels, m.whisper.max_frames)).astype(np.float32))
    ref = model.encoder(mel).last_hidden_state
    del model
    out, _ = whisper_encoder_apply(params, mel.to(device), m.whisper)
    return _module_entry("whisper", m.whisper_path, out, ref)


@torch.no_grad()
def _check_ssl(m, rng, device) -> dict:
    from avsr_tpu_torch.models.hubert import convert_hf_speech_ssl, speech_ssl_apply

    cls = _hf("HubertModel" if m.audio_encoder == "hubert" else "Wav2Vec2Model")
    model = cls.from_pretrained(m.audio_encoder_path, local_files_only=True).eval()
    params = convert_hf_speech_ssl(load_pretrained(m.audio_encoder_path, device)[0], m.ssl)
    wave = torch.from_numpy((0.1 * rng.standard_normal((1, 16000))).astype(np.float32))
    ref = model(wave).last_hidden_state
    del model
    out, _ = speech_ssl_apply(params, wave.to(device), m.ssl)
    return _module_entry(m.audio_encoder, m.audio_encoder_path, out, ref)


@torch.no_grad()
def _check_clip(m, rng, device) -> dict:
    from avsr_tpu_torch.models.clip_vit import clip_vit_apply, convert_hf_clip_vision
    from avsr_tpu_torch.models.layers import layer_norm

    model = _hf("CLIPVisionModel").from_pretrained(m.clip_path, local_files_only=True).eval()
    params = convert_hf_clip_vision(load_pretrained(m.clip_path, device)[0], m.clip)
    imgs = torch.from_numpy(rng.standard_normal(
        (2, 3, m.clip.image_size, m.clip.image_size)).astype(np.float32))
    ref = model(imgs).pooler_output
    del model
    # the port's feature is the CLS token; HF pools it through post-LN
    cls = clip_vit_apply(params, imgs[None].to(device), m.clip)[0]
    return _module_entry("clip", m.clip_path, layer_norm(params["ln_post"], cls), ref)


@torch.no_grad()
def _check_resnet(m, rng, device) -> dict:
    from avsr_tpu_torch.models.resnet import convert_hf_resnet, resnet_apply

    model = _hf("ResNetModel").from_pretrained(m.video_encoder_path,
                                               local_files_only=True).eval()
    params = convert_hf_resnet(load_pretrained(m.video_encoder_path, device)[0], m.resnet)
    imgs = torch.from_numpy(rng.standard_normal(
        (2, 3, m.resnet.image_size, m.resnet.image_size)).astype(np.float32))
    ref = model(imgs).pooler_output.reshape(2, -1)
    del model
    out = resnet_apply(params, imgs.to(device), m.resnet)     # [N,3,S,S] -> [N, d]
    return _module_entry("resnet", m.video_encoder_path, out, ref)


@torch.no_grad()
def _check_efficientnet(m, rng, device) -> dict:
    from avsr_tpu_torch.models.efficientnet import (convert_hf_efficientnet,
                                                    efficientnet_apply)

    model = _hf("EfficientNetModel").from_pretrained(m.video_encoder_path,
                                                     local_files_only=True).eval()
    params = convert_hf_efficientnet(load_pretrained(m.video_encoder_path, device)[0],
                                     m.efficientnet)
    imgs = torch.from_numpy(rng.standard_normal(
        (2, 3, m.efficientnet.image_size, m.efficientnet.image_size)).astype(np.float32))
    ref = model(imgs).pooler_output
    del model
    out = efficientnet_apply(params, imgs.to(device), m.efficientnet)
    return _module_entry("efficientnet", m.video_encoder_path, out, ref)


@torch.no_grad()
def _check_llm(m, rng, device) -> dict:
    from avsr_tpu_torch.models import llama as L

    model = _hf("AutoModelForCausalLM").from_pretrained(
        m.llm_path, local_files_only=True, torch_dtype=torch.float32).eval()
    params = L.convert_hf_llama(load_pretrained(m.llm_path, device)[0], m.llm)
    tokens = torch.from_numpy(rng.integers(0, m.llm.vocab_size, (1, 16)))
    ref = model(tokens).logits
    del model
    logits, _ = L.llama_apply(params, m.llm,
                              inputs_embeds=L.embed_tokens(params, tokens.to(device)))
    return _module_entry("llm", m.llm_path, logits, ref)


def _tokenizer(cfg, what: str):
    """``model.llm_path``'s HF tokenizer, or the byte tokenizer with a
    warning when the directory has no ``tokenizer.json``."""
    from avsr_tpu_torch.data.tokenizer import load_tokenizer

    llm_dir = Path(cfg.model.llm_path) if cfg.model.llm_path else None
    if llm_dir and (llm_dir / "tokenizer.json").exists():
        return load_tokenizer(llm_dir)
    log.warning("no tokenizer.json under %s — decoding with the byte tokenizer "
                "(%s)", llm_dir, what)
    return load_tokenizer(None)


def _decode_wav(cfg, wav: str, ref_text: str | None, device: torch.device) -> dict:
    """Greedy-decode one real WAV with the fully converted model (the
    reference decode.py protocol)."""
    from avsr_tpu_torch.data.audio_io import load_audio
    from avsr_tpu_torch.data.dataset import Sample
    from avsr_tpu_torch.data.loader import collate, featurize
    from avsr_tpu_torch.infer.generate import generate, prepare_params_for_decode

    params, notes = build_converted_params(cfg, device=device)
    params = prepare_params_for_decode(params, cfg.model)
    tok = _tokenizer(cfg, "the transcript will be bytes, not LLM text")
    audio = load_audio(wav, max_samples=cfg.data.max_audio_length)
    hb = collate([Sample("parity", audio, None, "", [tok.eos_id])], cfg.data,
                 tok.encode(cfg.model.prompt, add_bos=True), tok.pad_id)
    dtype = getattr(torch, cfg.runtime.compute_dtype)
    out = generate(params, cfg.model, featurize(hb, device, dtype, cfg.model), cfg.decode,
                   eos_id=tok.eos_id,
                   generator=torch.Generator(device=device).manual_seed(0),
                   compute_dtype=dtype, use_kernel=cfg.runtime.use_pallas)
    text = tok.decode(out.tokens[0, : int(out.lengths[0])].tolist())
    log.info("E2E transcript (%s): %r", wav, text)
    entry = {"wav": wav, "converted": notes, "transcript": text}
    if ref_text is not None:
        from avsr_tpu_torch.infer.wer import wer
        entry["ref"] = ref_text
        entry["wer"] = wer(ref_text, text)
        log.info("E2E WER vs --ref-text: %.3f", entry["wer"])
    return entry


def _decode_manifest(cfg, manifest_dir: str, split: str, device: torch.device) -> dict:
    """The decode CLI's protocol on the converted weights: batched greedy
    decode over ``{split}.tsv``/``{split}.wrd``, corpus WER/CER and the
    ``results_{ts}.txt`` + ``wer_{ts}.txt`` artifacts."""
    from avsr_tpu_torch.cli.decode import run_protocol
    from avsr_tpu_torch.data.dataset import build_dataset
    from avsr_tpu_torch.data.loader import DataLoader
    from avsr_tpu_torch.infer.generate import prepare_params_for_decode

    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, path=str(manifest_dir), synthetic=False))
    params, notes = build_converted_params(cfg, device=device)
    params = prepare_params_for_decode(params, cfg.model)
    tok = _tokenizer(cfg, "WER will not be meaningful")
    ds = build_dataset(cfg.data, tok, split=split, modality=cfg.model.modality,
                       image_size=cfg.model.image_size)
    loader = DataLoader(ds, cfg.data, tok, model_cfg=cfg.model,
                        batch_size=cfg.decode.batch_size, shuffle=False, device=device,
                        compute_dtype=getattr(torch, cfg.runtime.compute_dtype))
    stats: dict = {}
    try:
        run_protocol(cfg, params, tok, ds, loader, stats_out=stats)
    finally:
        loader.close()
    log.info("manifest eval (%s/%s): WER %.4f over %d utts", manifest_dir, split,
             stats.get("wer", float("nan")), stats.get("utterances", 0))
    return {"manifest": str(manifest_dir), "split": split, "converted": notes, **stats}


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Pretrained-weights parity harness (HF torch vs avsr_tpu_torch)")
    p.add_argument("--report", default="parity_report.json")
    p.add_argument("--wav", default=None,
                   help="real WAV for the end-to-end decode check")
    p.add_argument("--ref-text", default=None,
                   help="reference transcript for --wav (records WER)")
    p.add_argument("--manifest", default=None,
                   help="LRS3-style manifest dir: run the full reference "
                        "eval protocol (batch decode + corpus WER + "
                        "results_/wer_ artifacts) on converted weights")
    p.add_argument("--split", default="test",
                   help="manifest split for --manifest (default: test)")
    args = p.parse_args(argv)
    cfg = load_cli_config(args)
    m = cfg.model
    device = torch.device(args.device)
    if device.type == "cuda":       # full f32 products, as the HF reference's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)

    checks = [
        ("whisper", m.whisper_path,
         m.modality in ("audio", "both") and m.audio_encoder == "whisper",
         _check_whisper),
        (m.audio_encoder, m.audio_encoder_path,
         m.modality in ("audio", "both")
         and m.audio_encoder in ("hubert", "wav2vec2"), _check_ssl),
        ("clip", m.clip_path,
         m.modality in ("video", "both") and m.video_encoder == "clip",
         _check_clip),
        ("resnet", m.video_encoder_path,
         m.modality in ("video", "both") and m.video_encoder == "resnet",
         _check_resnet),
        ("efficientnet", m.video_encoder_path,
         m.modality in ("video", "both")
         and m.video_encoder == "efficientnet", _check_efficientnet),
        ("llm", m.llm_path, True, _check_llm),
    ]

    report: dict = {"timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                    "matmul_precision": "highest", "modules": {}}
    for name, path, active, fn in checks:
        if not (path and active):
            continue
        if not Path(path).exists():
            log.warning("%s: path %s does not exist — skipping", name, path)
            continue
        report["modules"][name] = fn(m, rng, device)

    if args.wav:
        if not report["modules"]:
            log.warning("--wav given but no checkpoint paths resolved")
        else:
            report["e2e"] = _decode_wav(cfg, args.wav, args.ref_text, device)

    if args.manifest:
        if not report["modules"]:
            log.warning("--manifest given but no checkpoint paths resolved")
        else:
            report["eval"] = _decode_manifest(cfg, args.manifest, args.split, device)

    if not report["modules"]:
        print("parity: no pretrained assets found — nothing checked "
              "(set model.whisper_path / model.clip_path / model.llm_path)")
        return 3

    report["all_pass"] = all(v["pass"] for v in report["modules"].values())
    out = Path(args.report)
    out.write_text(json.dumps(report, indent=2))
    log.info("report -> %s", out)
    status = "PASS" if report["all_pass"] else "FAIL"
    print(f"parity {status}: "
          + ", ".join(f"{k} {v['max_abs_err']:.2e}/{v['tol_max_abs']:.0e}"
                      for k, v in report["modules"].items())
          + (f" | transcript: {report['e2e']['transcript']!r}"
             if "e2e" in report else "")
          + (f" | eval WER {report['eval']['wer']:.4f} "
             f"({report['eval']['utterances']} utts)"
             if "eval" in report else ""))
    return 0 if report["all_pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
