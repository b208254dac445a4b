"""Smoke run of the PyTorch/CUDA port (avsr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

1. Builds every CUDA kernel of the port from the sources in this checkout.
2. Kernel phase: calls each kernel's wrapper at the shapes the serving path
   gives it (bf16) and holds it against its plain PyTorch version, then
   times the kernel and one PyTorch library call that computes the same
   function (a yardstick only; the port never calls it) from replayed CUDA
   graphs, and the plain version eagerly.
3. Main-path phase: the flagship config (Whisper-medium + CLIP-B/32 +
   Llama-3.2-1B with LoRA r=16, modality both) at full width with random
   bf16 weights from --seed; 8 utterances of 10 s audio and 25 video
   frames go through collate -> featurize -> generate_tokens (100 greedy
   tokens). Every kernel launch count is reset just before that run and
   read just after it; the prefill logits are compared with the same call
   with the kernels off.
4. CLI phase: the decode CLI over 8 synthetic utterances writes its
   results and WER files.
5. Backward kernel phase: the dQ and dK/dV kernels at the train step's
   attention shape (bf16, causal GQA) against their plain version (dQ
   hands its delta = rowsum(dO * O) to dK/dV), f32 and edge cases, the
   autograd Function against autograd through the plain attention, and
   times of each kernel, its plain version, its bound and the SDPA
   backward; the flash kernels and SDPA are timed from replayed CUDA
   graphs.
6. Train phase: the flagship train step at full width (random weights from
   --seed, frozen leaves bf16, trainable f32) on 8 x 10 s utterances with
   48-token transcripts: f32 and bf16 gradient parity of the kernel path
   against the plain path, three optimizer steps at base.yaml settings
   (4 x 8 micro-batches, remat, dropout) with exact launch counts per
   step, and a short overfit run whose loss must fall.
7. Train CLI phase: two steps of the train CLI write loss_log.csv.
8. qmatmul kernel phase: the int8 and int4 weight-only matmul kernels at
   every decode shape of the flagship (M = 8: the int4 projections qkv, o,
   gateup, down, the int8 lm head, and the int8 projections of use_8bit)
   against their plain version, edge cases (M of 1, 5, 9, 17 and 64, f32
   x, N off the tile, K off either kernel's k step, a K that does not
   match), the same bits from two launches and from a replayed CUDA graph,
   and the device time of the kernel, its plain version, its bound, one
   bf16 matmul on the dequantized weight and the dequantize-then-matmul
   pair, each from a replayed CUDA graph; each shape's launch plan.
9. Serving-preset phase: the flagship with use_4bit, lm_head_bits=8 and
   an int8 KV cache, built as the decode CLI builds it, on the same 8
   utterances: exact launch counts of one generate_tokens call, decode-step
   logits of the kernel path against the dequantize path (f32 and bf16),
   the serving numbers next to phase 3's and to the same weights
   unquantized.
10. int8 serving phase: the same with use_8bit in place of use_4bit (int8
   projections and head, int8 KV cache): exact launch counts and the same
   decode-step logit gates. Then the decode CLI with the preset overrides.
11. Checkpoint phase, through the CLIs at full width (LoRA dropout off):
   run A trains 2 steps with a checkpoint each, validation and in-training
   WER; run B resumes it for a third step; run C takes 3 steps
   uninterrupted, and B's third step must equal C's (its batches, loss and
   trainable leaves). The decode CLI reads the checkpoint in bf16 (the
   connector and LoRA leaves it loaded equal B's) and with the serving
   preset (quantized after loading), each followed by one generate_tokens
   call with exact launch counts; the average CLI's export of the last two
   steps is their f32 mean and decodes; a run sent SIGTERM after step 1
   saves a preempt checkpoint at step 2 and the next run resumes from it.
   Prints the checkpoint's size and its save, restore and WER-eval times,
   and removes every directory it wrote.

The build's ptxas report is printed per kernel, and any kernel that spills
fails the run.

Prints the card's name and power limit, one JSON line with every kernel's
numbers, and as its last line {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result; so does a
host without a CUDA device or a directory without the package.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import logging
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bytes/s
# base.yaml's values where they differ from the config defaults: the
# flagship config through CLI overrides (the card's host has no PyYAML)
FLAGSHIP_OVERRIDES = ("data.audio_buckets=1000,2000,3000",
                      "model.max_seq_len=1536", "training.grad_accum_steps=4")
# the serving preset of docs/serving.md
PRESET_OVERRIDES = ("model.use_4bit=true", "decode.lm_head_bits=8",
                    "decode.kv_cache_dtype=int8")
# the preset with int8 projections (model.use_8bit)
INT8_OVERRIDES = ("model.use_8bit=true", "decode.lm_head_bits=8",
                  "decode.kv_cache_dtype=int8")


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events around the whole run, after a warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def capture_stream():
    """The one side stream of every timed capture: cuBLAS keeps a workspace
    (32 MiB on Hopper) for each stream it has run on until the process
    ends, so a new stream per capture would hold memory that later phases'
    peak-memory readings count."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fns, reps: int = 20) -> float:
    """Device time per call of ``fns`` (called in turn, max(reps,
    len(fns)) calls in all) captured in one CUDA graph and replayed three
    times: the host's launch pace is not in the time, which matters for
    kernels of a few microseconds."""
    import torch

    reps = max(reps, len(fns))
    side = capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:                     # warm-up outside the capture
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def kernel_label(ptxas_line: str) -> str:
    """'flash_fwd_bf16_kernel<64>' from ptxas's 'Compiling entry function'
    line (the mangled name of a kernel in an anonymous namespace: the
    source's hash, the name's length, the name, its template arguments)."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", ptxas_line)
    if m is None:
        return "?"
    rest = ptxas_line[m.end():]
    name, args = rest[:int(m.group(1))], rest[int(m.group(1)):]
    if not args.startswith("I"):
        return name
    args = args[1:].split("Ev")[0]
    kinds = (["bf16"] if "bfloat16" in args else []) + (["f32"] if args.startswith("f") else [])
    return f"{name}<{', '.join(kinds + re.findall(r'L[ib](\d+)E', args))}>"


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def attn_bounds(q, k, q_lens, kv_lens, causal: bool
                ) -> dict[str, tuple[float, float]]:
    """(ms for the operations, ms for the bytes) of the forward, dQ and
    dK/dV kernels on this data, at the card's peaks. Operations: 4, 6 and
    8 * D FLOPs per valid (row, key) pair over the bf16 rate. Bytes: each
    input read once and each output written once, over the memory rate.
    The kernels read only the rows below q_len (q, dO, O, lse, delta) and
    kv_len (k, v) and write every row of their outputs (O, lse, dq, delta,
    dk, dv), so inputs count their valid rows and outputs their full size.
    dQ writes delta = rowsum(dO * O); dK/dV reads it instead of O. The
    least time the card could take is the larger of the two."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    es = q.element_size()
    pairs = rows_q = rows_k = 0
    for ql, kl in zip(q_lens.tolist(), kv_lens.tolist()):
        ql, kl = min(max(ql, 0), Tq), min(max(kl, 0), Tk)
        rows_q, rows_k = rows_q + ql, rows_k + kl
        if not causal:
            pairs += ql * kl
        elif ql <= kl:
            pairs += ql * (ql + 1) / 2
        else:
            pairs += kl * (kl + 1) / 2 + (ql - kl) * kl
    q_in = rows_q * H * D * es            # one of q, dO, O (valid rows)
    kv_in = 2 * rows_k * Hkv * D * es     # k and v (valid rows)
    row_in = rows_q * H * 4               # one of lse, delta (valid rows)
    row_out = B * H * Tq * 4              # all of lse or delta
    nbytes = {"fwd": q_in + kv_in + q.numel() * es + row_out,
              # q, dO, O, k, v, lse in; dq and delta out
              "dq": 3 * q_in + kv_in + row_in + q.numel() * es + row_out,
              # q, dO, k, v, lse, delta in; dk and dv out
              "dkv": 2 * q_in + kv_in + 2 * row_in + 2 * k.numel() * es}
    flops = {"fwd": 4, "dq": 6, "dkv": 8}
    return {n: (flops[n] * H * D * pairs / PEAK_BF16_FLOPS * 1e3,
                nbytes[n] / PEAK_BYTES * 1e3) for n in flops}


def sdpa_ms(q, k, v, lens, causal: bool, do=None) -> dict:
    """Times of one PyTorch call that computes the kernel's function at
    uniform lengths ``lens`` (the forward; with ``do``, the backward of q,
    k and v together). Two calls are timed and the faster one is the
    yardstick: SDPA with the same boolean mask over the padded width (K/V
    repeated for GQA), which rules out the flash backend, and SDPA on the valid
    rows alone with ``is_causal`` and ``enable_gqa`` on the flash backend.
    Set-up (repeat, slices, the backward's forward) is not timed; each call
    is timed from a replayed CUDA graph (``graph_ms``), as the kernels are.
    The port never calls SDPA."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, H, T, _ = q.shape
    n = int(lens[0])
    check(bool((lens == n).all()), "the SDPA yardstick needs uniform lengths")
    idx = torch.arange(T, device=q.device)
    valid = idx[None, :] < lens[:, None]
    mask = valid[:, None, :, None] & valid[:, None, None, :]
    if causal:
        mask = mask & (idx[None, :] <= idx[:, None])
    G = H // k.shape[1]
    calls = {
        "masked": ((q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)),
                   dict(attn_mask=mask), contextlib.nullcontext),
        "flash": (tuple(t[:, :, :n].contiguous() for t in (q, k, v)),
                  dict(is_causal=causal, enable_gqa=True),
                  lambda: sdpa_kernel(SDPBackend.FLASH_ATTENTION)),
    }
    res = {}
    for name, (args, kw, backend) in calls.items():
        with backend():
            if do is None:
                res[name] = graph_ms([lambda: F.scaled_dot_product_attention(*args, **kw)])
                continue
            # the forward on the capture stream, so that its backward (which
            # autograd runs on the forward's stream) is captured too
            side = capture_stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                leaves = [t.detach().requires_grad_() for t in args]
                out = F.scaled_dot_product_attention(*leaves, **kw)
            torch.cuda.current_stream().wait_stream(side)
            g = do if name == "masked" else do[:, :, :n].contiguous()
            res[name] = graph_ms([lambda: torch.autograd.grad(out, leaves, g,
                                                              retain_graph=True)],
                                 reps=10)
    best = min(res, key=res.get)
    return dict(ms=res[best], call=best, masked_ms=res["masked"],
                flash_ms=res["flash"])


def kernel_phase(seed: int, main_lens: dict[str, int]) -> list[dict]:
    import torch

    from avsr_tpu_torch.ops import attention as A

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    shapes = [
        # name, B, H, Hkv, T, causal, launches per generate_tokens call
        ("whisper", 8, 16, 16, 512, False, 24),
        ("llm_prefill", 8, 32, 8, 533, True, 16),
    ]
    rows = []
    for name, B, H, Hkv, T, causal, per_call in shapes:
        D = 64
        q, k, v = (torch.randn((B, h, T, D), generator=gen, device=dev,
                               dtype=torch.bfloat16) for h in (H, Hkv, Hkv))
        ragged = rng.integers(T // 2, T + 1, B)
        ragged[0] = T
        lens_sets = {
            "ragged": torch.tensor(ragged, dtype=torch.int32, device=dev),
            "main": torch.full((B,), main_lens[name], dtype=torch.int32, device=dev),
        }
        err = lse_max = 0.0
        for tag, lens in lens_sets.items():
            o, lse = A.flash_attention(q, k, v, lens, lens, causal)
            o_r, lse_r = A.flash_attention_reference(q, k, v, lens, lens, causal)
            torch.cuda.synchronize()
            check(torch.isfinite(o.float()).all().item(), f"{name}/{tag}: O not finite")
            e = (o.float() - o_r.float()).abs()
            check(bool((e <= 2e-2 + 2e-2 * o_r.float().abs()).all()),
                  f"{name}/{tag}: O off by {e.max().item():.3e} (atol=rtol=2e-2)")
            fin = torch.isfinite(lse_r)
            check(torch.equal(fin, torch.isfinite(lse)),
                  f"{name}/{tag}: lse +inf rows differ")
            lse_err = (lse[fin] - lse_r[fin]).abs().max().item()
            check(lse_err <= 1e-3, f"{name}/{tag}: lse off by {lse_err:.3e} (atol 1e-3)")
            err = max(err, e.max().item())
            lse_max = max(lse_max, lse_err)
            print(f"kernel {name} [{tag} lens {lens.tolist()}]: max|dO| "
                  f"{e.max().item():.3e}, max|dlse| {lse_err:.3e}")

        lens = lens_sets["main"]
        ms = graph_ms([lambda: A.flash_attention(q, k, v, lens, lens, causal)])
        plain_ms = time_ms(
            lambda: A.flash_attention_reference(q, k, v, lens, lens, causal), 5)
        lib = sdpa_ms(q, k, v, lens, causal)
        ops_ms, bytes_ms = attn_bounds(q, k, lens, lens, causal)["fwd"]
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        row = dict(shape=name, q=list(q.shape), kv=list(k.shape), causal=causal,
                   lens=main_lens[name], launches_per_call=per_call,
                   max_abs_err=err, max_lse_err=lse_max, ms=ms, plain_ms=plain_ms,
                   library_ms=lib["ms"], library=lib, bound_ms=bound_ms,
                   bound_by=bound_by, ops_ms=ops_ms, bytes_ms=bytes_ms)
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f}, SDPA "
              f"{lib['ms']:.4f} [{lib['call']}; masked {lib['masked_ms']:.4f}, "
              f"flash {lib['flash_ms']:.4f}], bound {bound_ms:.4f} by {bound_by})")
        rows.append(row)

    # Edge cases off the main path: f32 with D=128, GQA, an empty row.
    q, k, v = (torch.randn((2, h, 300, 128), generator=gen, device=dev)
               for h in (4, 2, 2))
    for causal, ql, kl in ((True, [300, 0], [300, 0]), (False, [300, 131], [300, 0])):
        ql_t = torch.tensor(ql, device=dev)
        kl_t = torch.tensor(kl, device=dev)
        o, lse = A.flash_attention(q, k, v, ql_t, kl_t, causal)
        o_r, lse_r = A.flash_attention_reference(q, k, v, ql_t, kl_t, causal)
        torch.cuda.synchronize()
        e = (o - o_r).abs().max().item()
        fin = torch.isfinite(lse_r)
        check(e <= 1e-4 and torch.equal(fin, torch.isfinite(lse))
              and (lse[fin] - lse_r[fin]).abs().max().item() <= 1e-4,
              f"f32 D=128 edge case (causal={causal}) off by {e:.3e}")
        check(bool((o[1] == 0).all()), "rows without keys must be zero")
    print("kernel f32/D=128/empty-row edge cases: ok")
    return rows


# ---------------------------------------------------------------------------
# Main-path phase
# ---------------------------------------------------------------------------

def serving_host_batch(cfg, seed: int, B: int = 8, n_samples: int = 160_000,
                       n_frames: int = 25):
    """B utterances of 10 s audio and 25 frames from ``seed``, collated on
    the host (the serving phases' input)."""
    from avsr_tpu_torch.data.dataset import Sample
    from avsr_tpu_torch.data.loader import collate
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples, dtype=np.float32) / 16000.0
    samples = []
    for i in range(B):
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300) * t)
                 + 0.05 * rng.standard_normal(n_samples)).astype(np.float32)
        frames = rng.integers(0, 256, (n_frames, 224, 224, 3), dtype=np.uint8)
        samples.append(Sample(f"smoke/{i}", audio, frames, "", [tok.eos_id]))
    return collate(samples, cfg.data, tok.encode(cfg.model.prompt, add_bos=True),
                   tok.pad_id)


def reset_counts() -> None:
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q

    A.launches = A.dq_launches = A.dkv_launches = 0
    Q.int8_launches = Q.int4_launches = 0


def main_path_phase(seed: int) -> dict:
    import torch

    from avsr_tpu_torch.convert import cast_tree, param_count
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q

    cfg = flagship()
    mc = cfg.model
    B, n_samples, n_frames, new = 8, 160_000, 25, cfg.decode.max_new_tokens
    t0 = time.perf_counter()
    params = init_avsr_model(mc, seed=seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = param_count(params)
    print(f"main path: random init of {n_params / 1e9:.3f} B params (bf16) "
          f"in {time.perf_counter() - t0:.2f} s")

    hb = serving_host_batch(cfg, seed, B, n_samples, n_frames)
    batch = featurize(hb, "cuda", torch.bfloat16)
    tp = hb.prompt.shape[1]
    check(batch.mel.shape == (B, 80, 1000), f"mel shape {tuple(batch.mel.shape)}")
    check(batch.frames.shape == (B, n_frames, 3, 224, 224), "frames shape")

    kw = dict(max_new_tokens=new, eos_id=-1, compute_dtype=torch.bfloat16)
    generate_tokens(params, mc, batch, **{**kw, "max_new_tokens": 4})  # warm-up

    expected = mc.whisper.n_layers + mc.llm.n_layers
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    st: dict = {}
    out = generate_tokens(params, mc, batch, stats=st, **kw)
    launches = A.launches
    check(A.dq_launches == A.dkv_launches == 0,
          "the serving path launched a backward kernel")
    check(Q.int8_launches == Q.int4_launches == 0,
          "the bf16 serving path launched a qmatmul kernel")
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: flash_fwd launches in one generate_tokens call: "
          f"{launches} (expected {mc.whisper.n_layers} Whisper + "
          f"{mc.llm.n_layers} LLM = {expected})")
    check(launches == expected, f"flash_fwd launched {launches} times, not {expected}")

    st_never: dict = {}
    out_never = generate_tokens(params, mc, batch, stats=st_never,
                                use_kernel="never", **kw)
    lk, ln = st["prefill_logits"], st_never["prefill_logits"]
    check(bool(torch.isfinite(lk).all()), "prefill logits not finite")

    # The same weights and inputs in float32, kernel path against plain
    # path: what the kernel changes without bf16 rounding noise.
    p32 = cast_tree(params, torch.float32)
    b32 = featurize(hb, "cuda", torch.float32)
    kw32 = dict(max_new_tokens=1, eos_id=-1, compute_dtype=torch.float32)
    s32k: dict = {}
    s32n: dict = {}
    generate_tokens(p32, mc, b32, stats=s32k, **kw32)
    generate_tokens(p32, mc, b32, stats=s32n, use_kernel="never", **kw32)
    del p32, b32
    ref = s32n["prefill_logits"]          # the most exact logits of the run
    std = ref.std().item()

    def dist(a, b):
        d = (a - b).abs()
        return dict(max=d.max().item(), mean=d.mean().item(),
                    top1_agree=(a.argmax(-1) == b.argmax(-1)).float().mean().item())

    cmp = dict(std_f32=std,
               f32_kernel_vs_plain=dist(s32k["prefill_logits"], ref),
               bf16_kernel_vs_plain=dist(lk, ln),
               bf16_kernel_vs_f32=dist(lk, ref),
               bf16_plain_vs_f32=dist(ln, ref))
    print("main path: prefill logits " + json.dumps(cmp))
    d32 = cmp["f32_kernel_vs_plain"]["max"]
    check(d32 <= 2e-2 * std,
          f"f32 prefill logits: kernel vs plain max|d| {d32:.4e} > 2e-2 * std {std:.4e}")
    # In bf16 each path rounds differently at every layer (the kernel also
    # rounds P to bf16 before PV), so the two drift apart through 40 layers;
    # hold the kernel path to the plain path's own distance from f32.
    ek, en = cmp["bf16_kernel_vs_f32"]["mean"], cmp["bf16_plain_vs_f32"]["mean"]
    check(ek <= 2.0 * en,
          f"bf16 prefill logits: kernel path mean|d| to f32 {ek:.4e} > 2x the "
          f"plain path's {en:.4e}")
    agree = (out.tokens == out_never.tokens).float().mean().item()
    check(out.tokens.shape == (B, new), f"tokens shape {tuple(out.tokens.shape)}")
    check(bool(((out.tokens >= 0) & (out.tokens < mc.llm.vocab_size)).all()),
          "token ids out of range")
    check(bool((out.lengths == new).all()), "eos_id=-1 must run every step")

    steps = st["decode_steps"]
    res = dict(
        batch=B, audio_s=n_samples / 16000, video_frames=n_frames,
        prefix_len=tp + (1000 + 1) // 2, prompt_tokens=tp, max_new_tokens=new,
        encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
        decode_ms=st["decode_s"] * 1e3, decode_steps=steps,
        ms_per_token=st["decode_s"] * 1e3 / steps,
        decode_tokens_per_s=B * steps / st["decode_s"],
        new_tokens_per_s=B * new / (st["encode_s"] + st["prefill_s"] + st["decode_s"]),
        peak_mem_gb=peak / 1e9, flash_launches=launches,
        prefill_logits=cmp, token_agreement_bf16_kernel_vs_plain=agree,
        plain_path=dict(encode_ms=st_never["encode_s"] * 1e3,
                        prefill_ms=st_never["prefill_s"] * 1e3,
                        ms_per_token=st_never["decode_s"] * 1e3 / steps))
    print("main path: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# qmatmul kernel phase
# ---------------------------------------------------------------------------

# name, bits, K, N, launches in one generate_tokens call of each serving
# path: per decode step 16 layers x qkv, o, gateup, down (int4 in the
# preset, int8 in the use_8bit call) and the int8 head, which also runs once
# at the prefill's last position.
def qmm_shapes(n_layers: int, steps: int) -> list[tuple]:
    proj = n_layers * steps
    head = {"serve_preset": steps + 1, "serve_8bit": steps + 1}
    return [("qkv", 4, 2048, 3072, {"serve_preset": proj}),
            ("o", 4, 2048, 2048, {"serve_preset": proj}),
            ("gateup", 4, 2048, 16384, {"serve_preset": proj}),
            ("down", 4, 8192, 2048, {"serve_preset": proj}),
            ("lm_head", 8, 2048, 129024, head),
            ("qkv", 8, 2048, 3072, {"serve_8bit": proj}),
            ("o", 8, 2048, 2048, {"serve_8bit": proj}),
            ("gateup", 8, 2048, 16384, {"serve_8bit": proj}),
            ("down", 8, 8192, 2048, {"serve_8bit": proj})]


def qmm_bound(M: int, K: int, N: int, bits: int) -> tuple[float, float]:
    """(ms for the operations, ms for the bytes) of one launch: 2 M K N
    FLOPs at the bf16 rate; the packed weight, the f32 scale, the bf16 x and
    the f32 output, each once, at the memory rate."""
    nbytes = K * N * bits // 8 + 4 * N + 2 * M * K + 4 * M * N
    return 2 * M * K * N / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def qmm_kernel_phase(seed: int, n_layers: int, steps: int) -> dict:
    import torch

    from avsr_tpu_torch.ops import qmatmul as Q
    from avsr_tpu_torch.ops import quant

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    l2_bytes = 128e6     # timed weights cycle through this much memory: the
    #                      50 MB L2 cannot hold them, as in a decode step
    rows = []
    for name, bits, K, N, by_call in qmm_shapes(n_layers, steps):
        M = 8
        qp = quant.quantize_tensor(0.02 * torch.randn((K, N), generator=gen, device=dev), bits)
        x = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
        y = Q.qmatmul(x, qp)
        ref = Q.qmatmul_reference(x, qp)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), f"qmatmul {name} int{bits}: not finite")
        err = (y - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        check(rel <= 1e-4, f"qmatmul {name} int{bits}: max|d| {err:.3e} = {rel:.3e} "
                           f"x max|ref| > 1e-4")
        wkey = "qw4h" if bits == 4 else "qw"
        wbytes = qp[wkey].numel()
        nodes = [qp] + [{wkey: qp[wkey].clone(), "scale": qp["scale"].clone()}
                        for _ in range(int(np.ceil(l2_bytes / wbytes)) - 1)]
        ms = graph_ms([lambda n=n: Q.qmatmul(x, n) for n in nodes])
        w16 = quant.dequantize(qp, torch.bfloat16)
        w16s = [w16] + [w16.clone() for _ in range(int(np.ceil(l2_bytes / (2 * wbytes))) - 1)]
        library_ms = graph_ms([lambda w=w: torch.matmul(x, w) for w in w16s])
        pair_ms = graph_ms([lambda n=n: torch.matmul(x, quant.dequantize(n, torch.bfloat16))
                            for n in nodes])
        plain_ms = graph_ms([lambda n=n: Q.qmatmul_reference(x, n) for n in nodes])
        del nodes, w16, w16s
        ops_ms, bytes_ms = qmm_bound(M, K, N, bits)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = dict(zip(("splits", "rows_per_cta", "n8_tiles"),
                        Q.int4_plan(M, K // 2, N, sms) if bits == 4 else Q.int8_plan(M, K, N, sms)))
        row = dict(shape=name, bits=bits, M=M, K=K, N=N,
                   launches_per_call=max(by_call.values()), launches_by_call=by_call,
                   max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, dequant_matmul_ms=pair_ms,
                   bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes", plan=plan)
        rows.append(row)
        print(f"qmatmul {name} int{bits} [{M}x{K}] x [{K}x{N}]: {ms * 1e3:.2f} us "
              f"(bound {row['bound_ms'] * 1e3:.2f} by {row['bound_by']}, plain "
              f"{plain_ms * 1e3:.1f}, bf16 matmul {library_ms * 1e3:.2f}, dequant + "
              f"matmul {pair_ms * 1e3:.1f}; {plan}); max|d| "
              f"{err:.3e} = {rel:.2e} x max|ref|")

    # Edge cases off the main path: ragged M (9 and 17 take two n8 tiles of
    # x, 17 also two units along M), f32 x, N and K off the tile (N = 2050
    # is not even a multiple of 4 and N = 1000 not of 16: the byte-load
    # paths; K = 1000 is not a multiple of the int8 kernel's 16-row k step
    # and K/2 = 500 not of the int4 kernel's 8-row one), bf16 output, and a
    # K that does not match the weight.
    edge = 0.0
    for bits in (8, 4):
        for M, K, N, xdt, odt in ((1, 2048, 3072, torch.bfloat16, torch.float32),
                                  (5, 2048, 3072, torch.bfloat16, torch.float32),
                                  (9, 2048, 3072, torch.bfloat16, torch.float32),
                                  (17, 8192, 2048, torch.bfloat16, torch.float32),
                                  (17, 1000, 2050, torch.float32, torch.float32),
                                  (64, 2048, 3072, torch.bfloat16, torch.float32),
                                  (8, 2048, 3072, torch.float32, torch.float32),
                                  (8, 1000, 2050, torch.bfloat16, torch.float32),
                                  (7, 1000, 1000, torch.float32, torch.bfloat16)):
            qp = quant.quantize_tensor(torch.randn((K, N), generator=gen, device=dev), bits)
            qp["scale"] = qp["scale"].to(torch.bfloat16)       # as cast_frozen leaves it
            x = torch.randn((M, K), generator=gen, device=dev).to(xdt)
            y = Q.qmatmul(x, qp, out_dtype=odt)
            ref = Q.qmatmul_reference(x, qp)
            torch.cuda.synchronize()
            rel = ((y.float() - ref).abs().max() / ref.abs().max()).item()
            tol = 1e-4 if odt == torch.float32 else 2 ** -8    # one bf16 rounding
            check(y.shape == (M, N) and y.dtype == odt and rel <= tol,
                  f"qmatmul edge int{bits} M={M} K={K} N={N} x {xdt} out {odt}: "
                  f"{rel:.3e} x max|ref|")
            if odt == torch.float32:
                edge = max(edge, rel)
        try:
            Q.qmatmul(torch.zeros((8, 2048 + 2), device=dev, dtype=torch.bfloat16), qp)
        except ValueError:
            pass
        else:
            raise CheckFailed(f"int{bits}: an x whose K does not match did not raise")
    print(f"qmatmul edge cases (M 1/5/9/17/64, f32 x, N 2050/1000, K 1000, bf16 "
          f"out, K mismatch): ok, worst f32 max|d| {edge:.3e} x max|ref|")

    # The same bits on every run: two launches, and a CUDA graph of one
    # replayed twice (the last CTA of a tile adds its K split in split
    # order; neither kernel adds by float atomics).
    for bits, M, K, N in ((4, 8, 2048, 3072), (4, 8, 8192, 2048), (4, 17, 1000, 2050),
                          (8, 8, 2048, 3072), (8, 8, 2048, 2048), (8, 8, 8192, 2048),
                          (8, 8, 2048, 129024), (8, 17, 1000, 2050)):
        qp = quant.quantize_tensor(torch.randn((K, N), generator=gen, device=dev), bits)
        x = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
        runs = [Q.qmatmul(x, qp), Q.qmatmul(x, qp)]
        side = capture_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            Q.qmatmul(x, qp)      # the stream's counters exist before the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = Q.qmatmul(x, qp)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            runs.append(captured.clone())
        del graph
        check(all(torch.equal(runs[0], r) for r in runs[1:]),
              f"qmatmul int{bits} M={M} K={K} N={N}: launches on the same inputs differ")
    print("qmatmul determinism (two launches and two graph replays, int4 at qkv, "
          "down and M=17 K=1000 N=2050, int8 at qkv, o, down, the head and M=17 "
          "K=1000 N=2050): bit-identical")
    return dict(rows=rows, edge_max_rel_err=edge, deterministic=True)


# ---------------------------------------------------------------------------
# Serving-preset phase
# ---------------------------------------------------------------------------

def decode_step_logits(params, mc, hb, dtype, use_kernels, nxt=None):
    """One prefill (kernels on) into an int8 cache, then one decode step
    per ``use_kernels`` entry on copies of that cache: {use_kernel: logits
    [B, V] f32}, and the step's input token (the greedy one of the
    prefill unless ``nxt`` is given)."""
    import torch

    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.models import llama as L
    from avsr_tpu_torch.models.avsr import build_prefix, encode

    lora = mc.lora if mc.lora.use_lora else None
    with torch.inference_mode():
        batch = featurize(hb, "cuda", dtype)
        enc = encode(params, mc, batch, compute_dtype=dtype)
        prefix, lens = build_prefix(params, mc, batch, enc, compute_dtype=dtype)
        B, T = prefix.shape[:2]
        hidden, cache = L.llama_apply(
            params["llm"], mc.llm, inputs_embeds=prefix, lengths=lens, lora=lora,
            compute_dtype=dtype, return_cache=True, cache_len=-(-(T + 2) // 128) * 128,
            output="hidden")
        cache = L.quantize_cache(cache)
        if nxt is None:
            h_last = hidden[torch.arange(B, device=prefix.device), lens.long() - 1][:, None]
            nxt = L.compute_logits(params["llm"], mc.llm, h_last, "never")[:, 0].argmax(-1)
        emb = L.embed_tokens(params["llm"], nxt[:, None], dtype)
        out = {}
        for uk in use_kernels:
            c = L.KVCache(*(t.clone() for t in cache))
            out[uk] = L.llama_decode_step(params["llm"], mc.llm, x=emb, cache=c,
                                          cur_lens=lens.long(), lora=lora,
                                          compute_dtype=dtype, use_kernel=uk)[0]
    return out, nxt


def preset_phase(seed: int, bf16: dict, qmm: dict, overrides=PRESET_OVERRIDES,
                 tag: str = "preset", against_bf16_weights: bool = True) -> dict:
    """One generate_tokens call of the flagship with ``overrides`` (a
    quantized serving path): exact launch counts, decode-step logit gates,
    serving numbers; with ``against_bf16_weights``, also the same weights
    unquantized."""
    import torch

    from avsr_tpu_torch.cli.common import load_decode_params
    from avsr_tpu_torch.convert import cast_tree
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q
    from avsr_tpu_torch.ops.quant import quant_bytes

    cfg = flagship(list(overrides))
    mc = cfg.model
    new = cfg.decode.max_new_tokens
    proj_bits = 4 if mc.use_4bit else 8
    t0 = time.perf_counter()
    params = load_decode_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    llm_gb = quant_bytes(params["llm"]) / 1e9
    print(f"{tag}: f32 init, int{proj_bits} quantization, bf16 cast and decode layout "
          f"in {time.perf_counter() - t0:.2f} s; LLM tree {llm_gb:.3f} GB")
    hb = serving_host_batch(cfg, seed)
    batch = featurize(hb, "cuda", torch.bfloat16)
    kw = dict(max_new_tokens=new, eos_id=-1, compute_dtype=torch.bfloat16,
              kv_cache_dtype=cfg.decode.kv_cache_dtype)
    generate_tokens(params, mc, batch, **{**kw, "max_new_tokens": 4})   # warm-up

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    st: dict = {}
    out = generate_tokens(params, mc, batch, stats=st, **kw)
    counts = dict(flash_fwd=A.launches, flash_bwd_dq=A.dq_launches,
                  flash_bwd_dkv=A.dkv_launches, qmatmul_int8=Q.int8_launches,
                  qmatmul_int4=Q.int4_launches)
    peak = torch.cuda.max_memory_allocated()
    steps = st["decode_steps"]
    proj = 4 * mc.llm.n_layers * steps      # qkv, o, gateup, down per layer and step
    want = dict(flash_fwd=mc.whisper.n_layers + mc.llm.n_layers, flash_bwd_dq=0,
                flash_bwd_dkv=0,
                qmatmul_int8=steps + 1 + (proj if proj_bits == 8 else 0),
                qmatmul_int4=proj if proj_bits == 4 else 0)
    print(f"{tag}: launches in one generate_tokens call {counts} (expected {want})")
    check(counts == want, f"{tag} launches {counts}, expected {want}")
    B = batch.mel.shape[0]
    check(out.tokens.shape == (B, new) and bool((out.lengths == new).all()),
          f"{tag} tokens")
    check(bool(((out.tokens >= 0) & (out.tokens < mc.llm.vocab_size)).all()),
          f"{tag} token ids out of range")
    check(bool(torch.isfinite(st["prefill_logits"]).all()), f"{tag} logits not finite")

    # Decode-step logits, kernel path against the dequantize path. In f32
    # the kernels still round x to bf16 (65 products per step) and the
    # dequantize path does not: mean |d| within 1e-2 * std, and max |d| no
    # larger than running the whole step in bf16 moves the logits. In bf16
    # the kernel path is no further from the f32 dequantize logits than 2x
    # the bf16 dequantize path is.
    p32 = cast_tree(params, torch.float32)
    l32, nxt = decode_step_logits(p32, mc, hb, torch.float32, ("auto", "never"))
    del p32
    torch.cuda.empty_cache()
    l16, _ = decode_step_logits(params, mc, hb, torch.bfloat16, ("auto", "never"), nxt)
    ref = l32["never"]
    std = ref.std().item()
    d32 = (l32["auto"] - ref).abs()
    dk, dn = (l16["auto"] - ref).abs(), (l16["never"] - ref).abs()
    step_cmp = dict(std_f32=std, f32_kernel_vs_dequant_max=d32.max().item(),
                    f32_kernel_vs_dequant_mean=d32.mean().item(),
                    f32_mean_ratio_to_std=d32.mean().item() / std,
                    bf16_kernel_vs_f32_mean=dk.mean().item(),
                    bf16_dequant_vs_f32_mean=dn.mean().item(),
                    bf16_kernel_vs_f32_max=dk.max().item(),
                    bf16_dequant_vs_f32_max=dn.max().item(),
                    top1_f32_kernel_vs_dequant=(l32["auto"].argmax(-1) == ref.argmax(-1))
                    .float().mean().item())
    print(f"{tag} decode-step logits " + json.dumps(step_cmp))
    c = step_cmp
    check(c["f32_kernel_vs_dequant_mean"] <= 1e-2 * std,
          f"{tag} f32 decode step: kernel vs dequant mean|d| "
          f"{c['f32_kernel_vs_dequant_mean']:.4e} > 1e-2 * std {std:.4e}")
    check(c["f32_kernel_vs_dequant_max"] <= c["bf16_dequant_vs_f32_max"],
          f"{tag} f32 decode step: kernel vs dequant max|d| "
          f"{c['f32_kernel_vs_dequant_max']:.4e} > the bf16 step's own "
          f"{c['bf16_dequant_vs_f32_max']:.4e}")
    check(c["bf16_kernel_vs_f32_mean"] <= 2.0 * c["bf16_dequant_vs_f32_mean"],
          f"{tag} bf16 decode step: kernel path mean|d| to f32 "
          f"{c['bf16_kernel_vs_f32_mean']:.4e} > 2x the dequantize path's "
          f"{c['bf16_dequant_vs_f32_mean']:.4e}")
    del l32, l16

    shapes = {(r["shape"], r["bits"]): r for r in qmm["rows"]}
    per_step = {key: mc.llm.n_layers * sum(shapes[(n, proj_bits)][key]
                                           for n in ("qkv", "o", "gateup", "down"))
                + shapes[("lm_head", 8)][key]
                for key in ("ms", "bound_ms", "library_ms", "plain_ms")}
    ms_tok = st["decode_s"] * 1e3 / steps
    res = dict(
        config="flagship + " + " ".join(overrides), batch=B, max_new_tokens=new,
        encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
        decode_ms=st["decode_s"] * 1e3, decode_steps=steps, ms_per_token=ms_tok,
        decode_tokens_per_s=B * steps / st["decode_s"],
        new_tokens_per_s=B * new / (st["encode_s"] + st["prefill_s"] + st["decode_s"]),
        peak_mem_gb=peak / 1e9, llm_tree_gb=llm_gb, launches=counts,
        decode_step_logits=step_cmp,
        bf16_phase=dict(encode_ms=bf16["encode_ms"], prefill_ms=bf16["prefill_ms"],
                        ms_per_token=bf16["ms_per_token"],
                        new_tokens_per_s=bf16["new_tokens_per_s"],
                        peak_mem_gb=bf16["peak_mem_gb"]),
        qmatmul_per_step=dict(**per_step, share_of_step=per_step["ms"] / ms_tok))
    if against_bf16_weights:
        # The same random weights unquantized (one f32 init from the seed):
        # how far the quantized path's greedy choices move.
        pb = load_decode_params(flagship(), seed=seed, device="cuda")
        stb: dict = {}
        outb = generate_tokens(pb, mc, batch, stats=stb,
                               **{**kw, "kv_cache_dtype": "bfloat16"})
        del pb
        torch.cuda.empty_cache()
        lq, lb = st["prefill_logits"], stb["prefill_logits"]
        res.update(
            prefill_top1_vs_bf16_weights=(lq.argmax(-1) == lb.argmax(-1)).float().mean().item(),
            prefill_logits_corr_vs_bf16_weights=torch.corrcoef(
                torch.stack([lq.flatten(), lb.flatten()]))[0, 1].item(),
            token_agreement_vs_bf16_weights=(out.tokens == outb.tokens).float().mean().item(),
            bf16_weights_same_init=dict(
                encode_ms=stb["encode_s"] * 1e3, prefill_ms=stb["prefill_s"] * 1e3,
                ms_per_token=stb["decode_s"] * 1e3 / stb["decode_steps"]))
    print(f"{tag}: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Backward kernel phase
# ---------------------------------------------------------------------------

def rel_err(a, ref) -> float:
    """max|a - ref| / max|ref| (f32)."""
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1e-30)).item()


def bwd_kernel_phase(seed: int, main_len: int) -> dict:
    import torch

    from avsr_tpu_torch.ops import attention as A

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)
    # the LLM attention of one train micro-batch: 8 rows packed to 672
    B, H, Hkv, T, D = 8, 32, 8, 672, 64
    q, do = (torch.randn((B, H, T, D), generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, Hkv, T, D), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    ragged = rng.integers(T // 2, T + 1, B)
    ragged[0] = T
    lens_sets = {"ragged": torch.tensor(ragged, dtype=torch.int32, device=dev),
                 "main": torch.full((B,), main_len, dtype=torch.int32, device=dev)}
    errs = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    abs_errs = dict(errs)
    for tag, lens in lens_sets.items():
        o, lse = A.flash_attention(q, k, v, lens, lens, True)
        dq, delta = A.flash_bwd_dq(q, k, v, o, lse, do, lens, lens, True)
        dk, dv = A.flash_bwd_dkv(q, k, v, lse, delta, do, lens, lens, True)
        refs = A.flash_attention_bwd_reference(q, k, v, o, lse, do, lens, lens, True)
        delta_r = A.flash_bwd_dq_reference(q, k, v, o, lse, do, lens, lens, True)[1]
        torch.cuda.synchronize()
        d_err = (delta - delta_r).abs().max().item()
        check(d_err <= 1e-4 * max(1.0, delta_r.abs().max().item()),
              f"bwd {tag}: delta off by {d_err:.3e}")
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            check(bool(torch.isfinite(got.float()).all()), f"bwd {tag}: {name} not finite")
            e = rel_err(got, ref)
            check(e <= 2e-2, f"bwd {tag}: {name} max|d| {e:.3e} x max|ref| > 2e-2")
            errs[name] = max(errs[name], e)
            abs_errs[name] = max(abs_errs[name],
                                 (got.float() - ref.float()).abs().max().item())
        print(f"bwd kernels [{tag} lens {lens.tolist()}]: max|d|/max|ref| "
              + ", ".join(f"{n} {rel_err(g, r):.3e}"
                          for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)))

    # Edge cases off the main path: f32, D=128, GQA, an empty row, Tq != Tk.
    qe, doe = (torch.randn((2, 4, 300, 128), generator=gen, device=dev)
               for _ in range(2))
    ke, ve = (torch.randn((2, 2, 300, 128), generator=gen, device=dev)
              for _ in range(2))
    for causal, ql, kl, tk in ((True, [300, 0], [300, 0], 300),
                               (False, [300, 131], [300, 0], 300),
                               (False, [257, 100], [290, 17], 290)):
        kk, vv = ke[:, :, :tk].contiguous(), ve[:, :, :tk].contiguous()
        qq, dd = qe[:, :, :ql[0]].contiguous(), doe[:, :, :ql[0]].contiguous()
        ql_t, kl_t = torch.tensor(ql, device=dev), torch.tensor(kl, device=dev)
        o, lse = A.flash_attention(qq, kk, vv, ql_t, kl_t, causal)
        dq_e, delta_e = A.flash_bwd_dq(qq, kk, vv, o, lse, dd, ql_t, kl_t, causal)
        got = (dq_e, *A.flash_bwd_dkv(qq, kk, vv, lse, delta_e, dd, ql_t, kl_t, causal))
        refs = A.flash_attention_bwd_reference(qq, kk, vv, o, lse, dd, ql_t,
                                               kl_t, causal)
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv"), got, refs):
            e = rel_err(g, r)
            check(e <= 1e-4, f"f32 D=128 bwd edge case (causal={causal}, "
                             f"lens {ql}/{kl}): {name} off by {e:.3e} x max|ref|")
        check(bool((got[0][1, :, ql[1]:] == 0).all()), "dq rows past q_len must be 0")
    print("bwd kernels f32/D=128/GQA/empty-row/cross edge cases: ok")

    # The autograd Function against autograd through the plain attention.
    qf, kf, vf = (torch.randn((2, h, 320, 64), generator=gen, device=dev)
                  for h in (4, 2, 2))
    gf = torch.randn((2, 4, 320, 64), generator=gen, device=dev)
    lf = torch.tensor([320, 250], device=dev)
    grads = []
    for fn in (lambda q_, k_, v_: A.FlashAttention.apply(q_, k_, v_, lf, lf, True, None),
               lambda q_, k_, v_: A.mha_reference(q_, k_, v_, causal=True,
                                                  q_lens=lf, kv_lens=lf)):
        leaves = [t.clone().requires_grad_() for t in (qf, kf, vf)]
        fn(*leaves).backward(gf)
        grads.append([t.grad for t in leaves])
    fn_err = max(rel_err(a, b) for a, b in zip(*grads))
    check(fn_err <= 1e-4, f"FlashAttention grads off autograd by {fn_err:.3e}")
    print(f"FlashAttention vs autograd through mha_reference (f32): {fn_err:.3e}")

    # Times at the main-path lengths (bf16), kernels from replayed CUDA
    # graphs, plain versions eager (they take milliseconds).
    lens = lens_sets["main"]
    o, lse = A.flash_attention(q, k, v, lens, lens, True)
    _, delta = A.flash_bwd_dq(q, k, v, o, lse, do, lens, lens, True)
    args_dq = (q, k, v, o, lse, do, lens, lens, True)
    args_dkv = (q, k, v, lse, delta, do, lens, lens, True)
    times = {
        "fwd": graph_ms([lambda: A.flash_attention(q, k, v, lens, lens, True)]),
        "dq": graph_ms([lambda: A.flash_bwd_dq(*args_dq)]),
        "dkv": graph_ms([lambda: A.flash_bwd_dkv(*args_dkv)]),
    }
    # the causal imbalance of dK/dV: the same shape without the mask does
    # twice the pairs, so a balanced causal run would take half its time
    o_nc, lse_nc = A.flash_attention(q, k, v, lens, lens, False)
    _, delta_nc = A.flash_bwd_dq(q, k, v, o_nc, lse_nc, do, lens, lens, False)
    dkv_noncausal_ms = graph_ms([lambda: A.flash_bwd_dkv(
        q, k, v, lse_nc, delta_nc, do, lens, lens, False)])
    del o_nc, lse_nc, delta_nc
    plain = {
        "fwd": time_ms(lambda: A.flash_attention_reference(q, k, v, lens, lens, True), 3),
        "dq": time_ms(lambda: A.flash_bwd_dq_reference(*args_dq), 3),
        "dkv": time_ms(lambda: A.flash_bwd_dkv_reference(*args_dkv), 3),
    }
    # library yardstick: the SDPA backward of q, k, v together
    library_bwd = sdpa_ms(q, k, v, lens, True, do)
    library_fwd = sdpa_ms(q, k, v, lens, True)
    bounds = attn_bounds(q, k, lens, lens, True)
    res = {"shape": dict(q=list(q.shape), kv=list(k.shape), causal=True,
                         lens=main_len, dtype="bfloat16"),
           "max_rel_err": errs, "max_abs_err": abs_errs, "edge_fn_err": fn_err,
           "library_bwd_pair": library_bwd, "library_fwd": library_fwd,
           "dkv_noncausal_ms": dkv_noncausal_ms}
    for name in ("fwd", "dq", "dkv"):
        ops_ms, bytes_ms = bounds[name]
        res[name] = dict(ms=times[name], plain_ms=plain[name],
                         bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                         bytes_ms=bytes_ms,
                         bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        print(f"kernel {name} at the train shape: {times[name]:.4f} ms (plain "
              f"{plain[name]:.4f}, bound {res[name]['bound_ms']:.4f} by "
              f"{res[name]['bound_by']})")
    print(f"kernel dkv at the train shape without the causal mask: "
          f"{dkv_noncausal_ms:.4f} ms (half: {dkv_noncausal_ms / 2:.4f}; causal "
          f"{times['dkv']:.4f})")
    for what, lib in (("forward", library_fwd), ("backward of q, k, v", library_bwd)):
        print(f"SDPA {what} at the train shape: {lib['ms']:.4f} ms "
              f"[{lib['call']}; masked {lib['masked_ms']:.4f}, flash "
              f"{lib['flash_ms']:.4f}]")
    return res


# ---------------------------------------------------------------------------
# Train phase
# ---------------------------------------------------------------------------

def train_host_batch(cfg, tok, rng, B: int = 8, n_samples: int = 160_000,
                     n_frames: int = 25, n_label: int = 48):
    """8 utterances of 10 s audio, 25 frames and a transcript of n_label
    tokens (n_label - 1 bytes + EOS), collated on the host."""
    from avsr_tpu_torch.data.dataset import Sample
    from avsr_tpu_torch.data.loader import collate

    t = np.arange(n_samples, dtype=np.float32) / 16000.0
    text = ("the quick brown fox jumps over a lazy dog while seven wizards "
            "brew hazy potions")[: n_label - 1]
    samples = []
    for i in range(B):
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300) * t)
                 + 0.05 * rng.standard_normal(n_samples)).astype(np.float32)
        frames = rng.integers(0, 256, (n_frames, 224, 224, 3), dtype=np.uint8)
        samples.append(Sample(f"train/{i}", audio, frames, text,
                              tok.encode(text, add_eos=True)))
    return collate(samples, cfg.data, tok.encode(cfg.model.prompt, add_bos=True),
                   tok.pad_id)


def _perturb_lora_b(params, gen) -> None:
    """LoRA b is 0 at init, which leaves the gradients of a exactly 0; give
    it values so that the parity checks cover a."""
    import torch

    for layer in params["llm"]["layers"]:
        for node in layer.values():
            if "lora" in node:
                b = node["lora"]["b"]
                b.copy_(0.05 * torch.randn(b.shape, generator=gen,
                                           device=b.device, dtype=b.dtype))


def _grads(params, mc, batch, dtype, use_kernel: str):
    import torch

    from avsr_tpu_torch.models.avsr import forward
    from avsr_tpu_torch.train.state import partition_trainable, tree_leaves

    leaves = tree_leaves(partition_trainable(params, mc)[0])
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = forward(params, mc, batch, compute_dtype=dtype,
                      use_kernel=use_kernel, remat=True)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.item(), [g.float() for g in grads]


def _dist(a: list, b: list) -> float:
    """||a - b|| / ||b|| over all leaves together."""
    import torch

    num = torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(a, b)))
    den = torch.sqrt(sum((y ** 2).sum() for y in b))
    return (num / den).item()


def train_phase(seed: int) -> dict:
    import torch

    from avsr_tpu_torch.convert import param_count
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q
    from avsr_tpu_torch.train.state import (cast_frozen, create_train_state,
                                            partition_trainable, tree_leaves)
    from avsr_tpu_torch.train.step import make_train_step, microbatch

    cfg = flagship()
    mc, accum = cfg.model, cfg.training.grad_accum_steps
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed + 2)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    t0 = time.perf_counter()
    p32 = init_avsr_model(mc, seed=seed, device="cuda", dtype=torch.float32)
    _perturb_lora_b(p32, gen)
    torch.cuda.synchronize()
    print(f"train: random init of {param_count(p32) / 1e9:.3f} B params (f32) "
          f"in {time.perf_counter() - t0:.2f} s")
    hb = train_host_batch(cfg, tok, rng)
    b32 = featurize(hb, "cuda", torch.float32)
    check(tuple(hb.labels.shape) == (8, 128) and hb.label_lens.tolist() == [48] * 8,
          "train batch labels")

    # Gradient parity in f32: the kernel path against the plain path.
    loss_k, g_k = _grads(p32, mc, b32, torch.float32, "auto")
    loss_p, g_p = _grads(p32, mc, b32, torch.float32, "never")
    per_leaf = [_dist([a], [b]) for a, b in zip(g_k, g_p)]
    check(abs(loss_k - loss_p) <= 1e-4 * abs(loss_p),
          f"f32 loss: kernel {loss_k} vs plain {loss_p}")
    check(max(per_leaf) <= 1e-3, f"f32 grads: worst leaf off by {max(per_leaf):.3e}")
    print(f"train f32 parity: loss {loss_k:.6f} vs {loss_p:.6f}; worst leaf "
          f"||dg||/||g|| {max(per_leaf):.3e} over {len(per_leaf)} trainable leaves")

    # Gradient parity in bf16: the kernel path no further from the f32
    # gradients than twice the plain path is.
    params = cast_frozen(p32, mc, torch.bfloat16)
    del p32, b32
    torch.cuda.empty_cache()
    b16 = featurize(hb, "cuda", torch.bfloat16)
    loss_kb, g_kb = _grads(params, mc, b16, torch.bfloat16, "auto")
    loss_pb, g_pb = _grads(params, mc, b16, torch.bfloat16, "never")
    d_k, d_p = _dist(g_kb, g_p), _dist(g_pb, g_p)
    check(d_k <= 2.0 * d_p, f"bf16 grads: kernel path {d_k:.4e} from f32 > 2x "
                            f"the plain path's {d_p:.4e}")
    print(f"train bf16 parity: loss kernel {loss_kb:.6f}, plain {loss_pb:.6f}; "
          f"||g - g_f32||/||g_f32|| kernel {d_k:.4e}, plain {d_p:.4e}")
    parity = dict(f32_loss_kernel=loss_k, f32_loss_plain=loss_p,
                  f32_worst_leaf=max(per_leaf), bf16_loss_kernel=loss_kb,
                  bf16_loss_plain=loss_pb, bf16_kernel_vs_f32=d_k,
                  bf16_plain_vs_f32=d_p)
    del g_k, g_p, g_kb, g_pb

    # Three optimizer steps at base.yaml settings: 4 micro-batches of 8,
    # remat, LoRA dropout, AdamW + cosine + clip.
    micro = [b16] + [featurize(train_host_batch(cfg, tok, rng), "cuda",
                               torch.bfloat16) for _ in range(accum - 1)]
    stacked = type(b16)(*[None if x[0] is None else torch.stack(x)
                          for x in zip(*micro)])
    state = create_train_state(params, cfg, total_steps=1000)
    step = make_train_step(cfg)
    train_p, frozen_p = partition_trainable(params, mc)
    frozen0 = [t.clone() for t in tree_leaves(frozen_p)]
    per_step = {"fwd": accum * (mc.whisper.n_layers + 2 * mc.llm.n_layers),
                "dq": accum * mc.llm.n_layers, "dkv": accum * mc.llm.n_layers}
    reset_counts()
    steps = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        before = (A.launches, A.dq_launches, A.dkv_launches)
        train0 = [t.detach().clone() for t in tree_leaves(train_p)]
        stats: dict = {}
        t0 = time.perf_counter()
        m = step(state, stacked, seed + i, stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = (A.launches - before[0], A.dq_launches - before[1],
               A.dkv_launches - before[2])
        check(got == (per_step["fwd"], per_step["dq"], per_step["dkv"]),
              f"step {i + 1} launches (fwd, dq, dkv) {got}, expected "
              f"{tuple(per_step.values())}")
        check(np.isfinite(m["loss"]) and m["skipped"] == 0.0,
              f"step {i + 1}: loss {m['loss']}, skipped {m['skipped']}")
        changed = any(not torch.equal(a, b) for a, b in zip(train0, tree_leaves(train_p)))
        # the warmup schedule starts at learning rate 0
        check(changed == (i > 0), f"step {i + 1}: trainable leaves changed={changed}")
        steps.append(dict(ms=dt * 1e3, loss=m["loss"], grad_norm=m["grad_norm"],
                          **{k: v * 1e3 for k, v in stats.items()}))
        print(f"train step {i + 1}: {dt * 1e3:.1f} ms, loss {m['loss']:.4f}, "
              f"gnorm {m['grad_norm']:.3f}, launches {got}")
    launches = {"fwd": A.launches, "dq": A.dq_launches, "dkv": A.dkv_launches}
    check(Q.int8_launches == Q.int4_launches == 0,
          "the train step launched a qmatmul kernel")
    peak = torch.cuda.max_memory_allocated()
    check(all(torch.equal(a, b) for a, b in zip(frozen0, tree_leaves(frozen_p))),
          "a frozen leaf changed")
    del frozen0
    n_utt = accum * 8
    last = steps[-1]
    res = dict(batch=f"{accum} x 8", audio_s=10, video_frames=25, label_tokens=48,
               packed_width=672, valid_len=581, steps=steps,
               ms_per_step=last["ms"], utts_per_s=n_utt / last["ms"] * 1e3,
               label_tokens_per_s=n_utt * 48 / last["ms"] * 1e3,
               peak_mem_gb=peak / 1e9, launches=launches,
               launches_per_step=per_step, parity=parity)

    # A short overfit run on one batch: the loss must fall.
    ocfg = flagship(["training.learning_rate=1e-3", "training.warmup_steps=1",
                     "training.grad_accum_steps=1"])
    ostate = create_train_state(params, ocfg, total_steps=100)
    ostep = make_train_step(ocfg)
    losses = [ostep(ostate, microbatch(b16, 1), 100 + i)["loss"] for i in range(5)]
    check(losses[-1] < losses[0], f"overfit losses do not fall: {losses}")
    print(f"train overfit on one batch: losses {[round(x, 4) for x in losses]}")
    res["overfit_losses"] = losses
    print("train: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# CLI phase
# ---------------------------------------------------------------------------

def cli_phase(seed: int, extra: tuple[str, ...] = (), tag: str = "cli") -> None:
    import torch

    from avsr_tpu_torch.cli import decode
    from avsr_tpu_torch.core.config import flagship, load_config

    out_dir = ROOT / "outputs" / "chip_smoke" / time.strftime(f"{tag}_%Y%m%d_%H%M%S")
    # the flagship config through CLI overrides (no YAML parser needed);
    # synthetic_size 40 gives an 8-utterance test split
    run = ["data.synthetic=true", "data.synthetic_size=40",
           "decode.max_new_tokens=16", f"decode.output_dir={out_dir}", *extra]
    flag = list(FLAGSHIP_OVERRIDES)
    check(load_config(None, flag + run) == flagship(run),
          "CLI overrides do not give the flagship config")
    t0 = time.perf_counter()
    rc = decode.main(["--seed", str(seed), "--device", "cuda", *flag, *run])
    torch.cuda.synchronize()
    check(rc == 0, f"decode CLI returned {rc}")
    results = list(out_dir.glob("results_*.txt"))
    wers = list(out_dir.glob("wer_*.txt"))
    check(len(results) == 1 and len(wers) == 1, f"CLI artifacts missing in {out_dir}")
    n_utt = results[0].read_text().count("UTT: ")
    check(n_utt == 8, f"results file holds {n_utt} utterances, not 8")
    check("WER: " in wers[0].read_text(), "WER summary missing")
    print(f"{tag} phase: 8 utterances decoded in {time.perf_counter() - t0:.2f} s; "
          f"wrote {results[0].relative_to(ROOT)} and {wers[0].relative_to(ROOT)}")


def train_cli_phase(seed: int) -> None:
    import shutil

    import torch

    from avsr_tpu_torch.cli import train
    from avsr_tpu_torch.core.config import flagship, load_config

    out_dir = ROOT / "outputs" / "chip_smoke" / time.strftime("train_%Y%m%d_%H%M%S")
    run = ["data.synthetic=true", "training.max_steps=2",
           "training.save_every_steps=0", f"training.checkpoint_dir={out_dir}"]
    flag = list(FLAGSHIP_OVERRIDES)
    check(load_config(None, flag + run) == flagship(run),
          "CLI overrides do not give the flagship config")
    t0 = time.perf_counter()
    try:
        rc = train.main(["--seed", str(seed), "--device", "cuda", *flag, *run])
        torch.cuda.synchronize()
    finally:                          # the final checkpoint holds ~3.5 GB
        shutil.rmtree(out_dir / "ckpt", ignore_errors=True)
    check(rc == 0, f"train CLI returned {rc}")
    rows = (out_dir / "loss_log.csv").read_text().splitlines()
    splits = [r.split(",")[2] for r in rows[1:]]
    check(splits.count("train") == 2, f"loss_log.csv rows: {splits}")
    print(f"train cli phase: 2 steps (4 x 8 synthetic utterances each) and "
          f"validation in {time.perf_counter() - t0:.2f} s; wrote "
          f"{(out_dir / 'loss_log.csv').relative_to(ROOT)}: {rows[1:]}")


# ---------------------------------------------------------------------------
# Checkpoint phase
# ---------------------------------------------------------------------------

class _Records(logging.Handler):
    """Keeps the log records of the port's loggers (the checkpoint, resume
    and WER-eval numbers are logged by the code under test)."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)

    def args(self, prefix: str) -> list[tuple]:
        return [r.args for r in self.records if str(r.msg).startswith(prefix)]


def counts() -> dict[str, int]:
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q

    return dict(flash_fwd=A.launches, flash_bwd_dq=A.dq_launches,
                flash_bwd_dkv=A.dkv_launches, qmatmul_int8=Q.int8_launches,
                qmatmul_int4=Q.int4_launches)


def since(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in counts().items()}


def loss_rows(run_dir: Path) -> list[list[str]]:
    return [r.split(",") for r in (run_dir / "loss_log.csv").read_text().splitlines()[1:]]


def checkpoint_phase(seed: int, bf16: dict, preset: dict) -> dict:
    """train -> checkpoint -> resume -> in-training WER -> decode from the
    checkpoint (bf16 and the serving preset) -> WER, and averaging and
    preemption, through the port's CLIs at the flagship's full width with
    LoRA dropout off (a resumed run restarts its dropout seeds, as the JAX
    Trainer does, so only a run without dropout can equal an uninterrupted
    one). Every directory it writes (about 3.5 GB per checkpoint step) is
    removed at the end."""
    import gc
    import shutil

    import torch

    from avsr_tpu_torch.cli import average, common, decode, train
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import DataLoader, featurize
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.train.checkpoint import load_params
    from avsr_tpu_torch.train.loop import Trainer
    from avsr_tpu_torch.train.state import path_leaves, trainable_mask

    base = ROOT / "outputs" / "chip_smoke" / time.strftime("ckpt_%Y%m%d_%H%M%S")
    ab, c, pre, avg = base / "ab", base / "c", base / "pre", base / "avg"
    flag = ["--seed", str(seed), "--device", "cuda", *FLAGSHIP_OVERRIDES,
            "data.synthetic=true", "model.lora.dropout=0"]
    wer_run = ["training.keep_checkpoints=2", "training.eval_wer_every_epochs=1",
               "training.eval_wer_max_utts=8", "training.best_metric=wer"]
    dec_run = ["data.synthetic_size=40", "decode.max_new_tokens=16"]
    cfg = flagship(["model.lora.dropout=0"])
    mc = cfg.model
    rec = _Records()
    logging.getLogger("avsr_tpu_torch").addHandler(rec)
    orig_iter, orig_prepare = DataLoader.__iter__, common.prepare_params_for_decode
    seen: list[list[str]] = []
    loaded: list = []

    def spy_iter(self):
        for hb, b in orig_iter(self):
            if self.shuffle:                 # the train loader
                seen.append(list(hb.utt_ids))
            yield hb, b

    def spy_prepare(params, *a, **kw):
        loaded[:] = [params, orig_prepare(params, *a, **kw)]
        return loaded[1]

    def train_run(run_dir: Path, *extra: str) -> int:
        seen.clear()
        rc = train.main([*flag, *wer_run, f"training.checkpoint_dir={run_dir}", *extra])
        gc.collect()
        torch.cuda.empty_cache()
        return rc

    def decode_run(out: Path, ckpt: Path, *extra: str) -> None:
        rc = decode.main([*flag, *dec_run, f"decode.output_dir={out}", *extra,
                          "--checkpoint", str(ckpt)])
        check(rc == 0, f"decode CLI --checkpoint {ckpt} returned {rc}")
        res, wer = list(out.glob("results_*.txt")), list(out.glob("wer_*.txt"))
        check(len(res) == 1 and len(wer) == 1, f"decode artifacts missing in {out}")
        check(res[0].read_text().count("UTT: ") == 8, f"{out}: not 8 utterances")
        m = re.search(r"WER: ([0-9.]+)", wer[0].read_text())
        check(m is not None and np.isfinite(float(m.group(1))), f"{out}: no WER")

    hb = serving_host_batch(cfg, seed)
    batch = featurize(hb, "cuda", torch.bfloat16)
    gen_kw = dict(max_new_tokens=cfg.decode.max_new_tokens, eos_id=-1,
                  compute_dtype=torch.bfloat16)
    res: dict = {}
    DataLoader.__iter__ = spy_iter
    common.prepare_params_for_decode = spy_prepare
    reset_counts()
    try:
        # Run A: two steps with a checkpoint each, then validation + WER
        t0 = time.perf_counter()
        check(train_run(ab, "training.max_steps=2", "training.save_every_steps=1") == 0,
              "run A failed")
        res["run_a_s"] = time.perf_counter() - t0
        ck = ab / "ckpt"
        check((ck / "1").is_dir() and (ck / "2").is_dir(), "run A: steps 1 and 2 not saved")
        meta = json.loads((ck / "meta_2.json").read_text())
        check("data_state" in meta and "fit_state" in meta, f"meta_2.json: {sorted(meta)}")
        check((ck / "best.json").exists(), "run A wrote no best.json")
        rows = loss_rows(ab)
        splits = [r[2] for r in rows]
        check(splits.count("train") == 2 and splits.count("val") == 1
              and splits.count("val_wer") == 1, f"run A loss_log rows {splits}")
        wer_a = float(next(r[5] for r in rows if r[2] == "val_wer"))
        check(np.isfinite(wer_a), f"run A val WER {wer_a}")
        res["run_a"] = dict(val_wer=wer_a, data_state=meta["data_state"],
                            fit_state=meta["fit_state"],
                            step_s=[float(r[7]) for r in rows if r[2] == "train"])

        # Run B: the same directory, one step more, resumed
        resumed = len(rec.args("resumed from step"))
        check(train_run(ab, "training.max_steps=3", "training.save_every_steps=1") == 0,
              "run B failed")
        got = rec.args("resumed from step")[resumed:]
        accum = cfg.training.grad_accum_steps
        check(got == [(2, 1, 2 * accum)], f"run B resume log {got}")
        seen_b = list(seen)
        # Run C: a fresh directory, three steps uninterrupted, no save before
        # the end (its step times against run A's show what a save costs)
        check(train_run(c, "training.max_steps=3", "training.save_every_steps=0") == 0,
              "run C failed")
        third = seen[2 * accum:3 * accum]
        check(len(seen_b) == accum and seen_b == third,
              f"run B saw batches {seen_b}, run C's third step {third}")
        pb, pc = (path_leaves(load_params(d / "ckpt" / "3")) for d in (ab, c))
        mask = path_leaves(trainable_mask(load_params(ab / "ckpt" / "3"), mc))
        worst = 0.0
        identical = True
        for k, m in mask.items():
            if m and not torch.equal(pb[k], pc[k]):
                identical = False
                d = (pb[k].float() - pc[k].float()).abs().max().item()
                worst = max(worst, d / max(pc[k].abs().max().item(), 1e-30))
        loss_b = [r[3] for r in loss_rows(ab) if r[2] == "train" and r[0] == "3"]
        loss_c = [r[3] for r in loss_rows(c) if r[2] == "train" and r[0] == "3"]
        check(len(loss_b) == len(loss_c) == 1, "step-3 loss rows")
        check(identical or worst <= 1e-5, f"run B vs run C: max|d|/max|leaf| {worst:.3e}")
        check(identical or abs(float(loss_b[0]) - float(loss_c[0]))
              <= 1e-5 * abs(float(loss_c[0])), f"step-3 loss B {loss_b} vs C {loss_c}")
        rows_c = loss_rows(c)
        res["b_vs_c"] = dict(bit_identical=identical and loss_b == loss_c,
                             worst_rel=worst, loss_b=loss_b[0], loss_c=loss_c[0],
                             trainable_leaves=sum(mask.values()))
        res["run_c"] = dict(step_s=[float(r[7]) for r in rows_c if r[2] == "train"])
        print(f"checkpoint phase: runs A (2 steps), B (resumed, 1 step), C (3 steps); "
              f"B vs C {json.dumps(res['b_vs_c'])}")
        del pb, pc
        shutil.rmtree(c)

        # Decode from the checkpoint, bf16: the leaves the CLI loaded, then
        # one generate_tokens call at phase 3's geometry
        decode_run(base / "dec_bf16", ck)
        b3 = path_leaves(load_params(ck / "3"))
        got_p = path_leaves(loaded[0])
        keys = [k for k in b3 if "lora" in k.split("/") or k.split("/")[0].endswith("connector")]
        check(keys and all(torch.equal(got_p[k], b3[k].to(got_p[k].device, torch.bfloat16))
                           for k in keys),
              "the decode CLI's connector/LoRA leaves differ from run B's step 3")
        del b3, got_p
        params = loaded[1]
        loaded.clear()
        generate_tokens(params, mc, batch, **{**gen_kw, "max_new_tokens": 4})
        before = counts()
        st: dict = {}
        out = generate_tokens(params, mc, batch, stats=st, **gen_kw)
        n = since(before)
        want = {k: 0 for k in n}
        want["flash_fwd"] = mc.whisper.n_layers + mc.llm.n_layers
        check(n == want, f"bf16 from checkpoint: launches {n}, expected {want}")
        check(bool(torch.isfinite(st["prefill_logits"]).all()), "logits not finite")
        res["decode_bf16"] = _serving(st, out, hb, n, bf16)
        del params, out
        gc.collect()
        torch.cuda.empty_cache()

        # The same checkpoint with the serving preset: quantized after restore
        decode_run(base / "dec_preset", ck, *PRESET_OVERRIDES)
        params = loaded[1]
        loaded.clear()
        pcfg = flagship(list(PRESET_OVERRIDES))
        kw = dict(gen_kw, kv_cache_dtype=pcfg.decode.kv_cache_dtype)
        generate_tokens(params, pcfg.model, batch, **{**kw, "max_new_tokens": 4})
        before = counts()
        st = {}
        out = generate_tokens(params, pcfg.model, batch, stats=st, **kw)
        n = since(before)
        steps = st["decode_steps"]
        want = dict(flash_fwd=mc.whisper.n_layers + mc.llm.n_layers, flash_bwd_dq=0,
                    flash_bwd_dkv=0, qmatmul_int8=steps + 1,
                    qmatmul_int4=4 * mc.llm.n_layers * steps)
        check(n == want, f"preset from checkpoint: launches {n}, expected {want}")
        check(bool(torch.isfinite(st["prefill_logits"]).all()), "logits not finite")
        res["decode_preset"] = _serving(st, out, hb, n, preset)
        del params, out
        gc.collect()
        torch.cuda.empty_cache()

        # Average the newest two steps into an export, and decode it
        check(average.main([*flag, "--checkpoint", str(ck), "--last", "2",
                            "--out", str(avg)]) == 0, "average CLI failed")
        pa, p2, p3 = (path_leaves(load_params(d)) for d in (avg, ck / "2", ck / "3"))
        check(pa.keys() == p2.keys(), "averaged export's key paths")
        for k, v in pa.items():
            a, b = p2[k].cuda(), p3[k].cuda()
            want_k = ((a.float() + b.float()) / 2).to(a.dtype)
            check(v.dtype == a.dtype and torch.equal(v.cuda(), want_k),
                  f"averaged leaf {k} is not the f32 mean of steps 2 and 3")
        del pa, p2, p3
        decode_run(base / "dec_avg", avg)
        loaded.clear()
        shutil.rmtree(avg)
        gc.collect()
        torch.cuda.empty_cache()

        # Preemption: SIGTERM after step 1; the run saves at the end of step
        # 2 and stops, and the next run resumes from that checkpoint
        class PreemptedAfterStep1(Trainer):
            def _step(self, micro_batches, epoch):
                m = super()._step(micro_batches, epoch)
                if self.state.step == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                return m

        handler = signal.getsignal(signal.SIGTERM)
        train.Trainer = PreemptedAfterStep1
        try:
            check(train.main([*flag, "training.max_steps=3", "training.save_every_steps=0",
                              f"training.checkpoint_dir={pre}"]) == 0, "preempted run failed")
        finally:
            train.Trainer = Trainer
        gc.collect()
        torch.cuda.empty_cache()
        meta = json.loads((pre / "ckpt" / "meta_2.json").read_text())
        check(meta["tag"] == "preempt" and (pre / "ckpt" / "2").is_dir(),
              f"no preempt checkpoint: {meta['tag']}")
        check(signal.getsignal(signal.SIGTERM) is handler,
              "the Trainer left its SIGTERM handler installed")
        resumed = len(rec.args("resumed from step"))
        check(train.main([*flag, "training.max_steps=3", "training.save_every_steps=0",
                          f"training.checkpoint_dir={pre}"]) == 0, "resumed run failed")
        check([a[0] for a in rec.args("resumed from step")[resumed:]] == [2],
              "the run after the preemption did not resume from step 2")
        steps_pre = [int(r[0]) for r in loss_rows(pre) if r[2] == "train"]
        check(steps_pre == [1, 2, 3], f"preempted and resumed steps {steps_pre}")
        res["preempt"] = dict(steps=steps_pre, data_state=meta["data_state"])
    finally:
        DataLoader.__iter__ = orig_iter
        common.prepare_params_for_decode = orig_prepare
        logging.getLogger("avsr_tpu_torch").removeHandler(rec)
        shutil.rmtree(base, ignore_errors=True)
    check(not base.exists(), f"{base} not removed")
    res["launches"] = counts()
    saves = rec.args("checkpoint step")
    res["saves"] = [dict(step=a[0], gb=a[1], host_copy_s=a[2], write_s=a[3])
                    for a in saves]
    res["restores_s"] = [a[2] for a in rec.args("restored step")]
    res["wer_eval_s"] = [a[4] for a in rec.args("epoch %d | val WER")]
    print(f"checkpoint phase: {saves[0][1]:.3f} GB per step; saves (host copy, write s) "
          f"{[(round(a[2], 3), round(a[3], 3)) for a in saves]}; restores "
          f"{[round(x, 3) for x in res['restores_s']]} s; WER evals (8 utts) "
          f"{[round(x, 3) for x in res['wer_eval_s']]} s")
    print("checkpoint: " + json.dumps(res))
    return res


def _serving(st: dict, out, hb, launches: dict, phase: dict) -> dict:
    """Serving numbers of one generate_tokens call beside an earlier
    phase's."""
    B, steps = len(hb.utt_ids), st["decode_steps"]
    new = out.tokens.shape[1]
    return dict(encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
                ms_per_token=st["decode_s"] * 1e3 / steps,
                new_tokens_per_s=B * new / (st["encode_s"] + st["prefill_s"] + st["decode_s"]),
                launches=launches,
                random_init=dict(encode_ms=phase["encode_ms"], prefill_ms=phase["prefill_ms"],
                                 ms_per_token=phase["ms_per_token"],
                                 new_tokens_per_s=phase["new_tokens_per_s"]))


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the "
              "card", file=sys.stderr)
        return 2
    try:
        from avsr_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: avsr_tpu_torch not found next to this script ({e})",
              file=sys.stderr)
        return 2

    print(gpu_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    # f32 matmuls and convolutions in full f32 (cuDNN's default is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.KERNEL_SOURCES)})")
    spills = []
    for name, log in _build.build_logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = kernel_label(line)
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name} {fn}: {line.strip()}")
                if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                    spills.append(f"{name} {fn}")
    check(not spills, f"kernels that spill registers: {spills}")

    # main-path lengths: 10 s of audio -> 500 Whisper frames; the LLM prefix
    # is 33 prompt tokens (BOS + 32 bytes) + 500 fused features
    rows = kernel_phase(args.seed, {"whisper": 500, "llm_prefill": 533})
    res = main_path_phase(args.seed)
    torch.cuda.empty_cache()
    cli_phase(args.seed)
    torch.cuda.empty_cache()
    # train lengths: 33 prompt tokens + 500 features + 48 label tokens = 581
    # valid of 661 packed, padded to 672
    bwd = bwd_kernel_phase(args.seed, 581)
    torch.cuda.empty_cache()
    train = train_phase(args.seed)
    torch.cuda.empty_cache()
    train_cli_phase(args.seed)
    torch.cuda.empty_cache()
    # Quantized serving last, so that the phases above run as they did
    # before it existed. The flagship LLM has 16 layers; 100 tokens take 99
    # decode steps.
    qmm = qmm_kernel_phase(args.seed, n_layers=16, steps=res["decode_steps"])
    torch.cuda.empty_cache()
    serve = {"serve_preset": preset_phase(args.seed, res, qmm)}
    torch.cuda.empty_cache()
    serve["serve_8bit"] = preset_phase(args.seed, res, qmm, INT8_OVERRIDES, tag="use_8bit",
                                       against_bf16_weights=False)
    torch.cuda.empty_cache()
    cli_phase(args.seed, PRESET_OVERRIDES, tag="preset_cli")
    torch.cuda.empty_cache()
    ckpt = checkpoint_phase(args.seed, res, serve["serve_preset"])
    cl = ckpt["launches"]
    check(all(cl.values()), f"a kernel did not launch on the checkpoint path: {cl}")

    def total(key: str) -> float:
        return sum(r[key] * r["launches_per_call"] for r in rows)

    tl = train["launches"]
    kernels = [dict(
        name="flash_fwd", route="cuda", source="avsr_tpu_torch/csrc/flash_fwd.cu",
        replaces="avsr_tpu/ops/attention.py:98",
        launches=res["flash_launches"] + tl["fwd"] + cl["flash_fwd"],
        launches_by_path={"serve": res["flash_launches"], "train_3_steps": tl["fwd"],
                          "checkpoint": cl["flash_fwd"]},
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_lse_err=max(r["max_lse_err"] for r in rows),
        ms=total("ms"), kernel_ms=total("ms"), plain_ms=total("plain_ms"),
        bound_ms=total("bound_ms"),
        bound_by="operations" if total("ops_ms") >= total("bytes_ms") else "bytes",
        library_ms=total("library_ms"),
        library_is="the faster of SDPA with the boolean mask and SDPA (flash "
                   "backend) on the valid rows, per shape, from a replayed CUDA graph",
        times_are="sums over the launches of one generate_tokens call (device "
                  "time per launch from a replayed CUDA graph x launches)",
        shapes=rows, train_shape={**bwd["fwd"], "library_ms": bwd["library_fwd"]["ms"],
                                  "library": bwd["library_fwd"]})]
    for name, key, line, errs, extra in (
            ("flash_bwd_dq", "dq", 181, ("dq",),
             dict(also_writes="delta = rowsum(dO * O), [B, H, Tq] f32")),
            ("flash_bwd_dkv", "dkv", 241, ("dk", "dv"),
             dict(reads="delta in place of O",
                  noncausal_ms=bwd["dkv_noncausal_ms"]))):
        kernels.append(dict(
            name=name, route="cuda", source="avsr_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"avsr_tpu/ops/attention.py:{line}",
            launches=tl[key] + cl[name],
            launches_by_path={"train_3_steps": tl[key], "checkpoint": cl[name]},
            max_abs_err=max(bwd["max_abs_err"][e] for e in errs),
            max_rel_err=max(bwd["max_rel_err"][e] for e in errs),
            ms=bwd[key]["ms"], plain_ms=bwd[key]["plain_ms"],
            bound_ms=bwd[key]["bound_ms"], bound_by=bwd[key]["bound_by"],
            library_ms=bwd["library_bwd_pair"]["ms"],
            library_is=f"SDPA backward of q, k and v together (dq + dk/dv), "
                       f"the faster call: {bwd['library_bwd_pair']['call']}, from "
                       f"a replayed CUDA graph",
            library=bwd["library_bwd_pair"],
            times_are="per launch at the train shape, from a replayed CUDA graph",
            shape=bwd["shape"], **extra))
    for name, bits, line in (("qmatmul_int8", 8, 120), ("qmatmul_int4", 4, 140)):
        qrows = [r for r in qmm["rows"] if r["bits"] == bits]

        def qtotal(key: str) -> float:
            return sum(r[key] * n for r in qrows for n in r["launches_by_call"].values())

        by_path = {path: out["launches"][name] for path, out in serve.items()}
        by_path["checkpoint"] = cl[name]
        kernels.append(dict(
            name=name, route="cuda", source="avsr_tpu_torch/csrc/qmatmul.cu",
            replaces=f"avsr_tpu/ops/qmatmul.py:{line}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in qrows),
            max_rel_err=max(r["max_rel_err"] for r in qrows),
            edge_max_rel_err=qmm["edge_max_rel_err"],
            ms=qtotal("ms"), plain_ms=qtotal("plain_ms"), bound_ms=qtotal("bound_ms"),
            bound_by="operations" if qtotal("ops_ms") >= qtotal("bytes_ms") else "bytes",
            library_ms=qtotal("library_ms"),
            library_is="torch.matmul of the bf16 x with the weight dequantized to "
                       "bf16 beforehand (cuBLAS), per shape",
            dequant_matmul_ms=qtotal("dequant_matmul_ms"),
            times_are="sums over the launches of one generate_tokens call of each "
                      "serving path (the preset, and use_8bit: device time per launch "
                      "from a replayed CUDA graph x launches)",
            shapes=qrows))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
