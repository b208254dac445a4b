"""Decoding / WER evaluation entry point of the PyTorch port.

The counterpart of ``avsr_tpu/cli/decode.py`` for static batches: runs
batched generation over a split (greedy, sampled, beam search or
speculative decoding, ``infer/generate.py::generate``), streams HYP/REF
pairs, and writes ``results_{ts}.txt`` + ``wer_{ts}.txt`` with the corpus
WER and CER, the same artifacts as the JAX package.

    python -m avsr_tpu_torch.cli.decode --config cfg.yaml --seed 0 \\
        data.synthetic=true decode.max_new_tokens=16 \\
        --checkpoint outputs/avsr/ckpt decode.num_beams=5

The serving preset adds ``model.use_4bit=true decode.lm_head_bits=8
decode.kv_cache_dtype=int8`` (int4 projections, int8 head, int8 KV cache),
with beams too. ``decode.speculative=true`` decodes with a draft: the
target quantized to ``decode.spec_draft_bits`` (the self-draft), its first
``decode.spec_draft_layers`` blocks so quantized (layer-skip), or a
trained draft (``decode.spec_draft_checkpoint`` and
``decode.spec_draft_config``, written by ``cli/distill.py``), which
encodes its own prefix. ``--checkpoint`` names a trainer checkpoint
directory of the port (its newest step is read) or a params export
(``cli/average.py``, ``cli/convert_hf.py``, ``cli/convert_ref_ckpt.py``);
without it the weights are a random init from
``--seed``. A quantized config quantizes a full-precision checkpoint after
loading it. Either way the weights end in the decode layout
(``cli/common.py::load_decode_params``). ``decode.engine_slots=S``
decodes through the continuous-batching engine (``infer/engine.py``, S
slots refilled mid-flight; with ``decode.speculative`` its slots
speculate) instead of static batches; the HYP lines are the same.
``data.synthetic=false`` decodes the manifest split under ``data.path``
and scores the references of its ``.wrd`` file; the wrap-padded rows of
the last batch are scored once. The tokenizer is ``model.llm_path``'s, or
the byte tokenizer.

Across processes (``torchrun --nproc_per_node N -m avsr_tpu_torch.cli.decode
...``, ``mesh.dp``/``mesh.fsdp``/``mesh.dcn_dp``/``mesh.ep``/``mesh.tp``/``mesh.sp``/
``mesh.pp`` over the world) every rank loads each batch and decodes its contiguous share
of the rows (split over the data axes, ``ep`` included) on its own card; rank 0 gathers the
hypotheses in dataset order and alone writes the results and WER files.
JAX's ``infer_batch_sharder`` replicates a batch that does not divide the
data-parallel ways (with a warning); here the batch is padded to a
multiple of the ways by repeating its last row and the padded rows'
outputs are dropped. Every rank holds what fsdp and ep would shard whole
(a MoE model's experts too: inference routes each row on its own, so the
tokens are one card's and only the memory differs), which
is what gathering an fsdp-sharded tree once at load gives (a gather per
layer inside the token loop would cost two collectives per layer per
token). Under ``mesh.tp`` the ranks of a tp group decode the same rows and
keep their tp slices: the Megatron blocks, their KV cache heads and the
vocab-sharded embedding and head, whose logits are gathered, so every
rank takes the same next token (greedy, beam and speculative alike; the
speculative draft is sliced too). Under ``mesh.sp`` the ranks of an sp
group decode the same rows, each running the encoders' and the prefill's
block stacks on its chunk of the sequence (ring attention) where JAX's
ring engages, with the prefill's KV cache gathered whole on every rank;
one rank of each data position's hypotheses is gathered (over the data
group). Under ``mesh.pp`` the ranks of a pp group decode the same rows
through the whole stack, as JAX's decoding does (it pipelines only the
forward without a cache). Greedy, beam and speculative hypotheses
are a row's own, so they equal the single-card decode's (in f32);
sampling draws from each rank's generator.
The continuous-batching engine (``decode.engine_slots``) runs on one card.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import torch

from avsr_tpu_torch.cli.common import (base_parser, build_data, init_or_load_params,
                                       load_cli_config, load_decode_params, maybe_mesh,
                                       refuse_world)
from avsr_tpu_torch.core.config import AVSRConfig, ModelConfig, load_config
from avsr_tpu_torch.data.loader import DataLoader
from avsr_tpu_torch.infer.engine import ServingEngine
from avsr_tpu_torch.infer.generate import generate
from avsr_tpu_torch.infer.speculative import (break_even_tokens_per_pass,
                                              make_draft_params, make_layerskip_draft)
from avsr_tpu_torch.infer.wer import WERAccumulator
from avsr_tpu_torch.mesh.multihost import local_rows
from avsr_tpu_torch.mesh.sharding import pad_rows, take_rows
from avsr_tpu_torch.models.layers import Params

log = logging.getLogger("avsr_tpu_torch.cli.decode")


def _parser() -> argparse.ArgumentParser:
    p = base_parser("Decode a split and compute WER")
    p.add_argument("--split", default="test")
    p.add_argument("--checkpoint", default=None,
                   help="trainer checkpoint dir or params export")
    return p


def _warn_if_speculative_loses(cfg: AVSRConfig,
                               draft_model_cfg: ModelConfig | None = None) -> None:
    """The JAX decode CLI's warning, message for message: decode.speculative
    in a regime that the cost model (``break_even_tokens_per_pass``) or the
    JAX package's measurements say must lose. The text equals greedy's by
    construction, so such a setting only costs throughput. With a trained
    draft, ``draft_model_cfg`` gives its true depth to the cost model."""
    d = cfg.decode
    gamma = d.spec_gamma
    trained = bool(d.spec_draft_checkpoint)
    draft_layers = d.spec_draft_layers
    if trained and draft_model_cfg is not None:
        draft_layers = min(draft_model_cfg.llm.n_layers, cfg.model.llm.n_layers)
    need = break_even_tokens_per_pass(cfg.model, bits=d.spec_draft_bits, gamma=gamma,
                                      draft_layers=draft_layers)
    ceiling = gamma + 1.0
    batch = d.engine_slots if d.engine_slots > 0 else d.batch_size
    if need >= ceiling:
        log.warning(
            "speculative config (int%d, gamma=%d, draft_layers=%d) can "
            "NEVER win: the cost model needs E[tokens/pass] > %.2f but the "
            "acceptance ceiling is %.0f (gamma+1). A round costs "
            "gamma*cost_ratio+1 target-steps; use fewer draft bits, "
            "layer-skip, or smaller gamma (docs/serving.md).",
            d.spec_draft_bits, gamma, d.spec_draft_layers, need, ceiling)
    elif batch >= 4:
        log.warning(
            "speculative at batch %d is a MEASURED LOSS on this geometry "
            "regardless of draft quality (at batch 8 the crossover is "
            "unreachable at ANY acceptance rate — the verify pass is no "
            "longer bandwidth-free at batch >= 4 and every draft dispatch "
            "pays host RTT). Output is token-identical to greedy, so this "
            "setting only slows decoding; it profits, if anywhere, at "
            "batch 1-2 latency. See docs/serving.md 'Measured honesty'.",
            batch)
    elif trained:
        log.info(
            "speculative at batch %d with a trained separate draft "
            "(depth %d/%d, int%d): profitable when measured acceptance "
            "exceeds %.2f tokens/pass (ceiling %.0f) — check "
            "distill_report.json teacher_agree or return_stats "
            "(docs/serving.md: a task-trained 1/2-depth draft measured "
            "4.75/5).",
            batch, draft_layers, cfg.model.llm.n_layers,
            d.spec_draft_bits, need, ceiling)
    else:
        log.warning(
            "speculative at batch %d profits ONLY with a trained draft: "
            "measured B=1 verdict is ~4 tokens/pass to break even "
            "(best random-init config 0.79x greedy; cost model needs "
            "E[tokens/pass] > %.2f, ceiling %.0f). Check your draft's "
            "acceptance with return_stats before enabling; see "
            "docs/serving.md 'Measured honesty'.",
            batch, need, ceiling)


def load_draft(cfg: AVSRConfig, checkpoint: str | None, *, seed: int,
               device: torch.device, mesh=None
               ) -> tuple[Params, Params, ModelConfig | None]:
    """(target params in the decode layout, draft params, the draft's
    model config or None) for ``decode.speculative``, built as the JAX
    decode CLI builds them: a trained draft from
    ``decode.spec_draft_checkpoint`` with its own config, else the
    target's raw tree (cut to its first ``decode.spec_draft_layers``
    blocks for layer-skip), quantized to ``decode.spec_draft_bits``. Under
    a ``mesh`` with tp both hold this rank's tp slices."""
    d = cfg.decode
    if d.spec_draft_checkpoint:
        params = load_decode_params(cfg, checkpoint, seed=seed, device=device, mesh=mesh)
        dcfg_full = load_config(d.spec_draft_config)
        draft_cfg = dcfg_full.model
        if draft_cfg.llm.vocab_size != cfg.model.llm.vocab_size:
            raise SystemExit(
                "spec_draft_checkpoint vocab mismatch: "
                f"{draft_cfg.llm.vocab_size} vs {cfg.model.llm.vocab_size}")
        d_raw = init_or_load_params(dcfg_full, d.spec_draft_checkpoint, seed=seed,
                                    device=device)
        return params, make_draft_params(d_raw, draft_cfg, bits=d.spec_draft_bits,
                                         mesh=mesh), draft_cfg
    params, raw = load_decode_params(cfg, checkpoint, seed=seed, device=device,
                                     return_raw=True, mesh=mesh)
    draft_cfg = None
    if d.spec_draft_layers > 0:
        raw, draft_cfg = make_layerskip_draft(raw, cfg.model, d.spec_draft_layers)
    return params, make_draft_params(raw, draft_cfg or cfg.model,
                                     bits=d.spec_draft_bits, mesh=mesh), draft_cfg


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    cfg = load_cli_config(args, across_processes=True)
    if cfg.decode.engine_slots > 0:
        refuse_world("the continuous-batching engine (decode.engine_slots)")
    device, mesh = maybe_mesh(cfg, args.device)
    tok, ds, loader = build_data(cfg, args.split, shuffle=False,
                                 batch_size=cfg.decode.batch_size, device=device,
                                 whole=True)
    d = cfg.decode
    draft_params = draft_cfg = None
    if d.speculative:
        params, draft_params, draft_cfg = load_draft(cfg, args.checkpoint,
                                                     seed=args.seed, device=device,
                                                     mesh=mesh)
        log.info("speculative decode: int%d %s-draft, gamma=%d", d.spec_draft_bits,
                 "trained-separate" if d.spec_draft_checkpoint
                 else f"{d.spec_draft_layers}-layer-skip" if d.spec_draft_layers
                 else "self", d.spec_gamma)
        _warn_if_speculative_loses(cfg, draft_model_cfg=draft_cfg)
    else:
        params = load_decode_params(cfg, args.checkpoint, seed=args.seed,
                                    device=device, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    # a trained draft ran its own encoders in training; the target's prefix
    # would feed it activations it never learned to read
    try:
        return run_protocol(cfg, params, tok, ds, loader, generator=gen,
                            draft_params=draft_params, draft_model_cfg=draft_cfg,
                            draft_shares_prefix=False if d.spec_draft_checkpoint else None,
                            mesh=mesh)
    finally:
        loader.close()


def run_protocol(cfg: AVSRConfig, params, tok, ds, loader: DataLoader, *,
                 generator: torch.Generator | None = None,
                 draft_params: Params | None = None,
                 draft_model_cfg: ModelConfig | None = None,
                 draft_shares_prefix: bool | None = None,
                 stats_out: dict | None = None, mesh=None) -> int:
    """Batched decode over ``ds`` (``generate``: greedy, sampled, beam or,
    with a draft, speculative; or the serving engine with
    ``decode.engine_slots``) with per-utterance HYP/REF lines and the
    corpus WER/CER summary, written to ``decode.output_dir``. ``stats_out``
    receives ``wer``, ``cer``, ``utterances``, ``decode_s`` and the two
    files' paths (``cli/parity.py --manifest`` reports them). With
    ``mesh`` each rank decodes its rows of every batch and rank 0 writes
    (see the module docstring)."""
    rows = _decode_rows(cfg, params, tok, loader, mesh, generator=generator,
                        draft_params=draft_params, draft_model_cfg=draft_model_cfg,
                        draft_shares_prefix=draft_shares_prefix)
    if mesh is not None and mesh.rank > 0:
        for _ in rows:
            pass
        return 0
    out_dir = Path(cfg.decode.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    results_path = out_dir / f"results_{ts}.txt"
    wer_path = out_dir / f"wer_{ts}.txt"
    d = cfg.decode
    acc = WERAccumulator()
    t0 = time.perf_counter()

    def record(rf, utt: str, ref: str, hyp: str) -> None:
        u_wer = acc.add(ref, hyp)
        log.info("utt %s | WER %.3f", utt, u_wer)
        print(f"UTT: {utt}", file=rf)
        print(f"REF: {ref}", file=rf)
        print(f"HYP: {hyp}", file=rf)
        print(f"WER: {u_wer:.4f}", file=rf)
        print("", file=rf)

    if d.engine_slots > 0:
        # continuous batching: a fixed slot pool, refilled mid-flight as
        # transcripts finish — no head-of-line blocking on ragged lengths
        eng = ServingEngine(params, cfg, tok, num_slots=d.engine_slots,
                            seed=cfg.training.seed, draft_params=draft_params,
                            draft_model_cfg=draft_model_cfg,
                            spec_gamma=d.spec_gamma if d.speculative else 0)
        # decode.temperature/top_p apply engine-wide; the engine API also
        # takes them per request
        with open(results_path, "w") as rf:
            for start in range(0, len(ds), 256):   # bound host memory
                samples = [ds[i] for i in range(start, min(start + 256, len(ds)))]
                ids_all = eng.transcribe(
                    samples, temperature_per_request=[d.temperature] * len(samples),
                    top_p_per_request=[d.top_p] * len(samples))
                for sample, ids in zip(samples, ids_all):
                    record(rf, sample.utt_id, sample.text, tok.decode(ids))
        log.info("engine stats: %s", eng.stats())
        eng.close()
        return _summarize(acc, time.perf_counter() - t0, wer_path, results_path, stats_out)

    seen: set[str] = set()
    with open(results_path, "w") as rf:
        for utt_ids, texts, hyps in rows:
            for utt, ref, hyp in zip(utt_ids, texts, hyps):
                if utt in seen:   # final short batch is wrap-padded
                    continue
                seen.add(utt)
                record(rf, utt, ref, hyp)
    return _summarize(acc, time.perf_counter() - t0, wer_path, results_path, stats_out)


def _decode_rows(cfg: AVSRConfig, params, tok, loader: DataLoader, mesh=None, **kw):
    """Yields (utterance ids, references, hypotheses) per batch of
    ``loader``; with ``mesh`` this rank decodes its rows of the batch
    padded to a multiple of the ways, and every rank gets every row's
    hypothesis (so every rank must run it to its end)."""
    d = cfg.decode
    dtype = getattr(torch, cfg.runtime.compute_dtype)
    for hb, batch in loader:
        n = len(hb.utt_ids)
        if mesh is not None:
            batch, _ = pad_rows(batch, mesh.ways)
            lo, hi = local_rows(batch.labels.shape[0], (mesh.data.rank, mesh.ways))
            batch = take_rows(batch, lo, hi)
        out = generate(params, cfg.model, batch, d, eos_id=tok.eos_id,
                       compute_dtype=dtype, use_kernel=cfg.runtime.use_pallas,
                       sp=mesh.sp if mesh is not None else None, **kw)
        tokens = out.tokens.cpu().numpy()
        lens = out.lengths.cpu().numpy()
        hyps = [tok.decode(tokens[i, : lens[i]]) for i in range(tokens.shape[0])]
        if mesh is not None:
            hyps = [h for part in mesh.data.all_gather_object(hyps) for h in part]
        yield hb.utt_ids, hb.texts, hyps[:n]


def _summarize(acc: WERAccumulator, dt: float, wer_path: Path,
               results_path: Path | None = None, stats_out: dict | None = None) -> int:
    summary = (
        f"utterances: {acc.utterances}\n"
        f"reference words: {acc.ref_words}\n"
        f"word errors: {acc.edits}\n"
        f"WER: {acc.wer:.4f}\n"
        f"CER: {acc.cer:.4f}\n"
        f"decode time: {dt:.1f}s ({acc.utterances / max(dt, 1e-9):.2f} utt/s)\n")
    wer_path.write_text(summary)
    if stats_out is not None:
        stats_out.update(wer=acc.wer, cer=acc.cer, utterances=acc.utterances, decode_s=dt,
                         results_path=str(results_path), wer_path=str(wer_path))
    log.info("overall WER %.4f CER %.4f (%d utts) -> %s", acc.wer, acc.cer,
             acc.utterances, wer_path)
    print(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
