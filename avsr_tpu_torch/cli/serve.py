"""Serve transcription over HTTP (continuous batching under the hood), the
port of ``avsr_tpu/cli/serve.py``: one resident engine (slot pool, staged
prefill, mid-flight refill), JSON over stdlib HTTP, per-request sampling
knobs; concurrent clients share the pool.

    python -m avsr_tpu_torch.cli.serve --seed 0 --port 8017 \\
        decode.engine_slots=8

    curl -s localhost:8017/v1/health
    curl -s -X POST localhost:8017/v1/transcribe \\
        -d '{"audio_path": "/data/utt.wav", "max_new_tokens": 64}'

Without ``--checkpoint`` the weights are a random init from ``--seed``.
``--device`` defaults to ``cuda``; the engine's scheduler thread is the
only thread that touches the card.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from avsr_tpu_torch.cli.common import (base_parser, load_cli_config, load_decode_params,
                                       load_multilora)
from avsr_tpu_torch.data.dataset import Sample
from avsr_tpu_torch.data.tokenizer import load_tokenizer
from avsr_tpu_torch.infer.server import AVSRServer

log = logging.getLogger("avsr_tpu_torch.cli.serve")


def build_server(argv: list[str] | None = None) -> AVSRServer:
    """The server of a command line, built and not yet started."""
    p = base_parser("HTTP transcription server")
    p.add_argument("--checkpoint", default=None, help="trainer checkpoint dir or params export")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8017)
    p.add_argument("--slots", type=int, default=0,
                   help="decode slot pool size (default: decode.engine_slots or 4)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the engine's warmup run before serving")
    p.add_argument("--adapter", action="append", default=None, metavar="CKPT",
                   help="LoRA adapter checkpoint (repeatable): serve K fine-tunes "
                        "from ONE resident base — requests pick theirs with "
                        '{"adapter": k} in flag order')
    p.add_argument("--token", default=None,
                   help="require 'Authorization: Bearer <token>' on POST routes "
                        "(health/stats stay open for probes)")
    p.add_argument("--allow-onboarding", action="store_true",
                   help="keep the base in the raw (unfused) layout so POST "
                        "/v1/adapters can onboard tenants at runtime even when no "
                        "--adapter was given (the fused serving layout cannot "
                        "accept per-proj adapters)")
    args = p.parse_args(argv)
    cfg = load_cli_config(args)
    device = torch.device(args.device)
    tok = load_tokenizer(cfg.model.llm_path or None)
    bank = None
    if args.adapter or args.allow_onboarding:
        params, bank = load_multilora(cfg, args.checkpoint, args.adapter or [],
                                      seed=args.seed, device=device)
        log.info("multi-tenant serving: %d adapters over one raw base "
                 "(runtime onboarding via POST /v1/adapters)", len(args.adapter or []))
    else:
        params = load_decode_params(cfg, args.checkpoint, seed=args.seed, device=device)
    if args.checkpoint is None:
        log.warning("no --checkpoint: serving RANDOM-INIT weights (smoke/bench mode)")
    warmup = None
    if not args.no_warmup:
        n = min(cfg.data.max_audio_length, 16000)
        warmup = Sample("warmup", np.zeros((n,), np.float32), None, "", [tok.eos_id])
    return AVSRServer(params, cfg, tok, host=args.host, port=args.port,
                      num_slots=args.slots or None, warmup_sample=warmup,
                      adapter_bank=bank, auth_token=args.token)


def main(argv: list[str] | None = None) -> int:
    server = build_server(argv)
    server.start()
    print(f"ready: http://{server.host}:{server.port}  "
          f"(POST /v1/transcribe, GET /v1/health)", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
