"""Simulated-real-time streaming transcription of a media file, the port of
``avsr_tpu/cli/stream.py``.

Feeds the audio (and optional video frames) of one utterance to
``infer/streaming.py::StreamingTranscriber`` in ``--chunk-s`` second
chunks, printing each chunk's committed text as it stabilizes — what a
live captioner would render — then the final transcript.

    python -m avsr_tpu_torch.cli.stream --seed 0 --audio utt.wav \\
        --chunk-s 1.0 [decode.stream_block_s=2]

``decode.stream_block_s > 0`` selects the blockwise mode (blocks frozen
into a persistent KV cache). Without ``--checkpoint`` the weights are a
random init from ``--seed``; ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import logging

import torch

from avsr_tpu_torch.cli.common import (base_parser, load_cli_config, load_decode_params,
                                       validate_modality_media)
from avsr_tpu_torch.data.audio_io import load_audio
from avsr_tpu_torch.data.dataset import resize_crop_frames
from avsr_tpu_torch.data.tokenizer import load_tokenizer
from avsr_tpu_torch.data.video_io import load_frames
from avsr_tpu_torch.infer.streaming import StreamingTranscriber

log = logging.getLogger("avsr_tpu_torch.cli.stream")

SAMPLE_RATE = 16_000


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Stream-transcribe one utterance in chunks")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--audio", default=None, help="WAV path")
    p.add_argument("--video", default=None, help="video path (mp4/npy)")
    p.add_argument("--chunk-s", type=float, default=1.0, help="seconds of media per feed")
    p.add_argument("--agree", type=int, default=2, help="LocalAgreement-n commit policy")
    p.add_argument("--fps", type=float, default=25.0, help="video frame rate for chunking")
    args = p.parse_args(argv)
    cfg = load_cli_config(args)
    if not args.audio and not args.video:
        p.error("at least one of --audio / --video is required")
    validate_modality_media(cfg, p, have_audio=bool(args.audio), have_video=bool(args.video))

    tok = load_tokenizer(cfg.model.llm_path or None)
    params = load_decode_params(cfg, args.checkpoint, seed=args.seed,
                                device=torch.device(args.device))
    st = StreamingTranscriber(params, cfg, tok, agree_n=args.agree)

    audio = (load_audio(args.audio, max_samples=cfg.data.max_audio_length)
             if args.audio else None)
    frames = None
    if args.video:
        frames = resize_crop_frames(load_frames(args.video, cfg.data.max_video_length),
                                    cfg.model.image_size)

    hop_a = max(int(args.chunk_s * SAMPLE_RATE), 1)
    hop_v = max(int(args.chunk_s * args.fps), 1)
    n_a = audio.shape[0] if audio is not None else 0
    n_v = frames.shape[0] if frames is not None else 0
    n_chunks = max(-(-n_a // hop_a) if n_a else 0, -(-n_v // hop_v) if n_v else 0)
    for i in range(n_chunks):
        a = audio[i * hop_a:(i + 1) * hop_a] if audio is not None else None
        v = frames[i * hop_v:(i + 1) * hop_v] if frames is not None else None
        if a is not None and a.size == 0:
            a = None
        if v is not None and v.shape[0] == 0:
            v = None
        new = st.feed(audio=a, frames=v)
        if new:
            print(f"[t={(i + 1) * args.chunk_s:5.1f}s] {new}", flush=True)
    tail = st.finalize()
    if tail:
        print(f"[final ] {tail}", flush=True)
    print(st.committed_text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
