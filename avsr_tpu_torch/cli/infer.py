"""Single-utterance inference: media file(s) in, transcript out, the port of
``avsr_tpu/cli/infer.py``.

    python -m avsr_tpu_torch.cli.infer --checkpoint ckpt/ --audio utt.wav \\
        [--video utt.npy] [overrides]

Prints the transcript on stdout; the decode is the decode CLI's
(``infer/generate.py::generate``: greedy, sampled or beam search, by the
config). Without ``--checkpoint`` the weights are a random init from
``--seed``; ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import logging

import torch

from avsr_tpu_torch.cli.common import (base_parser, load_cli_config, load_decode_params,
                                       validate_modality_media)
from avsr_tpu_torch.data.audio_io import load_audio
from avsr_tpu_torch.data.dataset import Sample, resize_crop_frames
from avsr_tpu_torch.data.loader import collate, featurize
from avsr_tpu_torch.data.tokenizer import load_tokenizer
from avsr_tpu_torch.data.video_io import load_frames
from avsr_tpu_torch.infer.generate import generate

log = logging.getLogger("avsr_tpu_torch.cli.infer")


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Transcribe one utterance")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--audio", default=None, help="WAV path")
    p.add_argument("--video", default=None, help="video path (mp4/npy)")
    args = p.parse_args(argv)
    cfg = load_cli_config(args)
    if not args.audio and not args.video:
        p.error("at least one of --audio / --video is required")
    validate_modality_media(cfg, p, have_audio=bool(args.audio), have_video=bool(args.video))
    if not args.checkpoint:
        log.warning("no --checkpoint: transcribing with RANDOM weights "
                    "(smoke-test mode — output is meaningless)")

    device = torch.device(args.device)
    dtype = getattr(torch, cfg.runtime.compute_dtype)
    tok = load_tokenizer(cfg.model.llm_path or None)
    audio = (load_audio(args.audio, max_samples=cfg.data.max_audio_length)
             if args.audio else None)
    frames = None
    if args.video:
        frames = resize_crop_frames(load_frames(args.video, cfg.data.max_video_length),
                                    cfg.model.image_size)
    hb = collate([Sample("cli", audio, frames, "", [tok.eos_id])], cfg.data,
                 tok.encode(cfg.model.prompt, add_bos=True), tok.pad_id)
    params = load_decode_params(cfg, args.checkpoint, seed=args.seed, device=device)
    batch = featurize(hb, device, dtype, cfg.model)
    out = generate(params, cfg.model, batch, cfg.decode,
                   eos_id=tok.eos_id,
                   generator=torch.Generator(device=device).manual_seed(cfg.training.seed),
                   compute_dtype=dtype, use_kernel=cfg.runtime.use_pallas)
    print(tok.decode(out.tokens[0, : int(out.lengths[0])].tolist()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
