"""Decoding / WER evaluation entry point of the PyTorch port.

The counterpart of ``avsr_tpu/cli/decode.py`` for static batches with greedy
or sampled decoding: runs batched generation over a split, streams HYP/REF
pairs, and writes ``results_{ts}.txt`` + ``wer_{ts}.txt`` with the corpus
WER and CER, the same artifacts as the JAX package.

    python -m avsr_tpu_torch.cli.decode --config cfg.yaml --seed 0 \\
        data.synthetic=true decode.max_new_tokens=16

The serving preset adds ``model.use_4bit=true decode.lm_head_bits=8
decode.kv_cache_dtype=int8`` (int4 projections, int8 head, int8 KV cache).
Weights are a random init from ``--seed`` in the decode layout
(``cli/common.py::load_decode_params``); checkpoint loading, the manifest
dataset, beam search, the continuous-batching engine and speculative
decoding are still to be ported.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import torch

from avsr_tpu_torch.cli.common import base_parser, build_dataset, load_decode_params
from avsr_tpu_torch.core.config import AVSRConfig, load_config
from avsr_tpu_torch.data.loader import DataLoader
from avsr_tpu_torch.data.tokenizer import ByteTokenizer
from avsr_tpu_torch.infer.generate import generate_tokens
from avsr_tpu_torch.infer.wer import WERAccumulator

log = logging.getLogger("avsr_tpu_torch.cli.decode")


def _parser() -> argparse.ArgumentParser:
    p = base_parser("Decode a split and compute WER")
    p.add_argument("--split", default="test")
    return p


def _check_supported(cfg: AVSRConfig) -> None:
    d = cfg.decode
    if d.num_beams > 1 or d.engine_slots or d.speculative:
        raise NotImplementedError(
            "beam search, the serving engine and speculative decoding are "
            "not yet ported")


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = load_config(args.config, args.overrides)
    _check_supported(cfg)
    device = torch.device(args.device)
    tok = ByteTokenizer()
    ds = build_dataset(cfg, tok, args.split)
    params = load_decode_params(cfg, seed=args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return run_protocol(cfg, params, tok, ds, device=device, generator=gen)


def run_protocol(cfg: AVSRConfig, params, tok, ds, *, device: torch.device,
                 generator: torch.Generator | None = None) -> int:
    """Batched decode over ``ds`` with per-utterance HYP/REF lines and the
    corpus WER/CER summary, written to ``decode.output_dir``."""
    out_dir = Path(cfg.decode.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    results_path = out_dir / f"results_{ts}.txt"
    wer_path = out_dir / f"wer_{ts}.txt"
    dtype = getattr(torch, cfg.runtime.compute_dtype)
    d = cfg.decode
    acc = WERAccumulator()
    t0 = time.perf_counter()
    seen: set[str] = set()
    with open(results_path, "w") as rf:
        for hb, batch in DataLoader(ds, cfg.data, tok, model_cfg=cfg.model,
                                    batch_size=d.batch_size, shuffle=False,
                                    device=device, compute_dtype=dtype):
            out = generate_tokens(params, cfg.model, batch,
                                  max_new_tokens=d.max_new_tokens,
                                  temperature=d.temperature, top_p=d.top_p,
                                  eos_id=tok.eos_id, generator=generator,
                                  compute_dtype=dtype,
                                  use_kernel=cfg.runtime.use_pallas,
                                  kv_cache_dtype=d.kv_cache_dtype)
            tokens = out.tokens.cpu().numpy()
            lens = out.lengths.cpu().numpy()
            for i, (utt, ref) in enumerate(zip(hb.utt_ids, hb.texts)):
                if utt in seen:   # final short batch is wrap-padded
                    continue
                seen.add(utt)
                hyp = tok.decode(tokens[i, : lens[i]])
                u_wer = acc.add(ref, hyp)
                log.info("utt %s | WER %.3f", utt, u_wer)
                print(f"UTT: {utt}", file=rf)
                print(f"REF: {ref}", file=rf)
                print(f"HYP: {hyp}", file=rf)
                print(f"WER: {u_wer:.4f}", file=rf)
                print("", file=rf)
    dt = time.perf_counter() - t0
    summary = (
        f"utterances: {acc.utterances}\n"
        f"reference words: {acc.ref_words}\n"
        f"word errors: {acc.edits}\n"
        f"WER: {acc.wer:.4f}\n"
        f"CER: {acc.cer:.4f}\n"
        f"decode time: {dt:.1f}s ({acc.utterances / max(dt, 1e-9):.2f} utt/s)\n")
    wer_path.write_text(summary)
    log.info("overall WER %.4f CER %.4f (%d utts) -> %s", acc.wer, acc.cer,
             acc.utterances, wer_path)
    print(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
