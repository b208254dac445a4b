"""Smoke run of the PyTorch/CUDA port (avsr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

1. Builds every CUDA kernel of the port from the sources in this checkout.
2. Kernel phase: calls each kernel's wrapper at the shapes the serving path
   gives it (bf16) and holds it against its plain PyTorch version, then
   times the kernel, the plain version and one PyTorch library call that
   computes the same function (a yardstick only; the port never calls it).
3. Main-path phase: the flagship config (Whisper-medium + CLIP-B/32 +
   Llama-3.2-1B with LoRA r=16, modality both) at full width with random
   bf16 weights from --seed; 8 utterances of 10 s audio and 25 video
   frames go through collate -> featurize -> generate_tokens (100 greedy
   tokens). Every kernel launch count is reset just before that run and
   read just after it; the prefill logits are compared with the same call
   with the kernels off.
4. CLI phase: the decode CLI over 8 synthetic utterances writes its
   results and WER files.

Prints the card's name and power limit, one JSON line with every kernel's
numbers, and as its last line {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result; so does a
host without a CUDA device or a directory without the package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bytes/s


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


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def flash_bound(q, k, q_lens, kv_lens, causal: bool) -> tuple[float, float]:
    """(ms for the operations, ms for the bytes) at the card's peaks: the
    FLOPs of this data's valid (row, key) pairs over the bf16 rate, and
    q + k + v + O + lse bytes (each read or written once) over the memory
    rate. The least time the card could take is the larger of the two."""
    B, H, Tq, D = q.shape
    flops = 0.0
    for ql, kl in zip(q_lens.tolist(), kv_lens.tolist()):
        pairs = ql * (ql + 1) / 2 if causal else ql * kl
        flops += 4.0 * H * D * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + B * H * Tq * 4
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def kernel_phase(seed: int, main_lens: dict[str, int]) -> list[dict]:
    import torch
    import torch.nn.functional as F

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
        ms = time_ms(lambda: A.flash_attention(q, k, v, lens, lens, causal), 20)
        plain_ms = time_ms(
            lambda: A.flash_attention_reference(q, k, v, lens, lens, causal), 5)
        # library yardstick: SDPA with the same boolean mask (K/V repeated
        # for GQA outside the timed region)
        kr = k.repeat_interleave(H // Hkv, dim=1)
        vr = v.repeat_interleave(H // Hkv, dim=1)
        idx = torch.arange(T, device=dev)
        mask = (idx[None, :] < lens[:, None])[:, None, None, :]
        mask = mask & (idx[None, :] < lens[:, None])[:, None, :, None]
        if causal:
            mask = mask & (idx[None, :] <= idx[:, None])
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask), 20)
        ops_ms, bytes_ms = flash_bound(q, k, lens, lens, causal)
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        row = dict(shape=name, q=list(q.shape), kv=list(k.shape), causal=causal,
                   lens=main_lens[name], launches_per_call=per_call,
                   max_abs_err=err, max_lse_err=lse_max, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   ops_ms=ops_ms, bytes_ms=bytes_ms)
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f}, SDPA "
              f"{library_ms:.4f}, bound {bound_ms:.4f} by {bound_by})")
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

def main_path_phase(seed: int) -> dict:
    import torch

    from avsr_tpu_torch.convert import cast_tree, param_count
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.dataset import Sample
    from avsr_tpu_torch.data.loader import collate, featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.ops import attention as A

    cfg = flagship()
    mc = cfg.model
    B, n_samples, n_frames, new = 8, 160_000, 25, cfg.decode.max_new_tokens
    t0 = time.perf_counter()
    params = init_avsr_model(mc, seed=seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = param_count(params)
    print(f"main path: random init of {n_params / 1e9:.3f} B params (bf16) "
          f"in {time.perf_counter() - t0:.2f} s")

    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples, dtype=np.float32) / 16000.0
    samples = []
    for i in range(B):
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300) * t)
                 + 0.05 * rng.standard_normal(n_samples)).astype(np.float32)
        frames = rng.integers(0, 256, (n_frames, 224, 224, 3), dtype=np.uint8)
        samples.append(Sample(f"smoke/{i}", audio, frames, "", [tok.eos_id]))
    hb = collate(samples, cfg.data, tok.encode(mc.prompt, add_bos=True), tok.pad_id)
    batch = featurize(hb, "cuda", torch.bfloat16)
    tp = hb.prompt.shape[1]
    check(batch.mel.shape == (B, 80, 1000), f"mel shape {tuple(batch.mel.shape)}")
    check(batch.frames.shape == (B, n_frames, 3, 224, 224), "frames shape")

    kw = dict(max_new_tokens=new, eos_id=-1, compute_dtype=torch.bfloat16)
    generate_tokens(params, mc, batch, **{**kw, "max_new_tokens": 4})  # warm-up

    expected = mc.whisper.n_layers + mc.llm.n_layers
    torch.cuda.reset_peak_memory_stats()
    A.launches = 0
    st: dict = {}
    out = generate_tokens(params, mc, batch, stats=st, **kw)
    launches = A.launches
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
# CLI phase
# ---------------------------------------------------------------------------

def cli_phase(seed: int) -> None:
    import torch

    from avsr_tpu_torch.cli import decode
    from avsr_tpu_torch.core.config import flagship, load_config

    out_dir = ROOT / "outputs" / "chip_smoke" / time.strftime("cli_%Y%m%d_%H%M%S")
    # the flagship config through CLI overrides (no YAML parser needed);
    # synthetic_size 40 gives an 8-utterance test split
    run = ["data.synthetic=true", "data.synthetic_size=40",
           "decode.max_new_tokens=16", f"decode.output_dir={out_dir}"]
    flag = ["data.audio_buckets=1000,2000,3000", "model.max_seq_len=1536"]
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
    print(f"cli phase: 8 utterances decoded in {time.perf_counter() - t0:.2f} s; "
          f"wrote {results[0].relative_to(ROOT)} and {wers[0].relative_to(ROOT)}")


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
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # main-path lengths: 10 s of audio -> 500 Whisper frames; the LLM prefix
    # is 33 prompt tokens (BOS + 32 bytes) + 500 fused features
    rows = kernel_phase(args.seed, {"whisper": 500, "llm_prefill": 533})
    res = main_path_phase(args.seed)
    torch.cuda.empty_cache()
    cli_phase(args.seed)

    def total(key: str) -> float:
        return sum(r[key] * r["launches_per_call"] for r in rows)

    kernels = [dict(
        name="flash_fwd", route="cuda", source="avsr_tpu_torch/csrc/flash_fwd.cu",
        replaces="avsr_tpu/ops/attention.py:98",
        launches=res["flash_launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_lse_err=max(r["max_lse_err"] for r in rows),
        ms=total("ms"), kernel_ms=total("ms"), plain_ms=total("plain_ms"),
        bound_ms=total("bound_ms"),
        bound_by="operations" if total("ops_ms") >= total("bytes_ms") else "bytes",
        library_ms=total("library_ms"),
        times_are="sums over the launches of one generate_tokens call",
        shapes=rows)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
