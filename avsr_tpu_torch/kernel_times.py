"""Device times of the port's kernels at the main path's shapes.

    python3 avsr_tpu_torch/kernel_times.py [--root DIR] [--seed N]

Times the kernels of the ``avsr_tpu_torch`` package under ``--root`` (by
default the checkout this file lies in; another checkout of the repo, such
as an earlier commit unpacked with ``git archive``, gives its kernels'
times by the same method):
- the flash forward at the Whisper, LLM prefill and LLM train shapes, and
  dQ and dK/dV at the train shape (dK/dV also without the causal mask);
  bf16, B = 8, D = 64;
- the flash forward, dQ and dK/dV at the connectors' shape (the
  ``attention`` and ``adaptive`` connectors: 8 heads of 256 over the 500
  rows Whisper returns for 10 s, non-causal; bf16, B = 8), where the
  package's kernels take D = 256;
- Llama-2-7B's shapes: its prefill and train step (MHA, 32 heads of 128),
  its connectors' (8 heads of 512), and Llama-3.2-3B's connectors' (8 heads
  of 384: the D = 512 kernels on zero-padded operands);
- Llama-2-13B's prefill and train step (40 heads of 128) and the panel
  kernels (D > 512) at its connectors' 8 heads of 640, at 896 and at
  Llama-2-70B's connectors' 8 heads of 1024, and the forward at 2048 (B =
  2), each with the bf16 forward's cluster size (``cluster``);
- the forward at the other widths between the compiled ones (192, 320,
  448; 384 above) at the connectors' shape;
- the per-rank shapes of tensor parallelism at tp = 2 (half the heads:
  Whisper 8 of 16, the LLM 16 over 4 kv heads), the ring blocks of
  sequence parallelism at sp = 2 (a rank's chunk of the 30 s bucket, B = 1:
  Whisper's 752 rows, the LLM's 792, its diagonal block causal) and a
  pipeline stage's block at pp = 2 (one microbatch row of the 30 s bucket:
  [1, 32, 1584, 64] over 8 kv heads, causal, 1581 valid rows);
- the weight-only matmuls at M = 8: int4 and int8 at the flagship's four
  decode projections (qkv, o, gateup, down; int8 is model.use_8bit) and the
  int8 lm head, the 7B's (int4 projections, the int8 head over its vocab
  padded to 32768) and a tp = 2 rank's slices, with the weights
  cycled through 128 MB so that they come from memory and not from the
  50 MB L2, as ``chip_smoke.py::qmm_kernel_phase`` times them.
Inputs come from ``--seed``. Each time is ``chip_smoke.py::graph_ms`` of
this checkout: the device time per launch of a CUDA graph of 20 launches
(or one per weight copy, if more) replayed three times. Beside each kernel
time: its bound (``chip_smoke.py::attn_bounds``, ``qmm_bound``), its plain
version's time (flash: eager, CUDA events; qmatmul: a replayed graph) and
the library call's (SDPA, the backward's of q, k and v together, with the
backend SDPA took; cuBLAS on the dequantized bf16 weight). Prints the
card's name and power limit, then one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent

# name: B, H, Hkv, T, valid rows, causal, D, whether dQ and dK/dV are timed
SHAPES = {
    "whisper": (8, 16, 16, 512, 500, False, 64, False),
    "llm_prefill": (8, 32, 8, 533, 533, True, 64, False),
    "llm_train": (8, 32, 8, 672, 581, True, 64, True),
    "connector": (8, 8, 8, 500, 500, False, 256, True),
    "llm2_prefill": (8, 32, 32, 533, 533, True, 128, False),
    "llm2_train": (8, 32, 32, 672, 581, True, 128, True),
    "connector512": (8, 8, 8, 500, 500, False, 512, True),
    "connector384": (8, 8, 8, 500, 500, False, 384, True),
    "tp2_whisper": (8, 8, 8, 512, 500, False, 64, False),
    "tp2_llm_prefill": (8, 16, 4, 533, 533, True, 64, False),
    "tp2_llm_train": (8, 16, 4, 672, 581, True, 64, True),
    "sp2_whisper_block": (1, 16, 16, 752, 752, False, 64, True),
    "sp2_llm_block": (1, 32, 8, 792, 792, False, 64, True),
    "sp2_llm_diag_block": (1, 32, 8, 792, 792, True, 64, True),
    "pp2_stage_block": (1, 32, 8, 1584, 1581, True, 64, True),
    "llm13_prefill": (8, 40, 40, 533, 533, True, 128, False),
    "llm13_train": (8, 40, 40, 672, 581, True, 128, True),
    "connector640": (8, 8, 8, 500, 500, False, 640, True),
    "connector896": (8, 8, 8, 500, 500, False, 896, True),
    "connector1024": (8, 8, 8, 500, 500, False, 1024, True),
    "panels2048": (2, 8, 8, 500, 500, False, 2048, False),
    "connector192": (8, 8, 8, 500, 500, False, 192, False),
    "connector320": (8, 8, 8, 500, 500, False, 320, False),
    "connector448": (8, 8, 8, 500, 500, False, 448, False),
}
# name: bits, K, N (M = 8)
QMM_SHAPES = {
    "int4_qkv": (4, 2048, 3072),
    "int4_o": (4, 2048, 2048),
    "int4_gateup": (4, 2048, 16384),
    "int4_down": (4, 8192, 2048),
    "int8_qkv": (8, 2048, 3072),
    "int8_o": (8, 2048, 2048),
    "int8_gateup": (8, 2048, 16384),
    "int8_down": (8, 8192, 2048),
    "int8_lm_head": (8, 2048, 129024),
    "llama2_int4_qkv": (4, 4096, 12288),
    "llama2_int4_o": (4, 4096, 4096),
    "llama2_int4_gateup": (4, 4096, 22016),
    "llama2_int4_down": (4, 11008, 4096),
    "llama2_int8_lm_head": (8, 4096, 32768),
    "tp2_int4_qkv": (4, 2048, 1536),
    "tp2_int4_o": (4, 1024, 2048),
    "tp2_int4_gateup": (4, 2048, 8192),
    "tp2_int4_down": (4, 4096, 2048),
    "tp2_int8_lm_head": (8, 2048, 64512),
}
L2_CYCLE_BYTES = 128e6


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=str(HERE))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    A = importlib.import_module("avsr_tpu_torch.ops.attention")
    Q = importlib.import_module("avsr_tpu_torch.ops.qmatmul")
    quant = importlib.import_module("avsr_tpu_torch.ops.quant")
    for mod in (A, Q, quant):
        if not Path(mod.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"imported {mod.__file__}, not the package under {root}")
    # dK/dV reads delta (from dQ) where an earlier version read O
    reads_delta = "delta" in inspect.signature(A.flash_bwd_dkv).parameters
    # the widths the checkout's kernels take (before the panel kernels, a
    # tuple of them)
    takes = getattr(A, "kernel_takes", None) or (
        lambda D: D in getattr(A, "KERNEL_HEAD_DIMS", (64, 128)))

    print(smoke.gpu_line())
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ms, plain, library, bound, backend, cluster = {}, {}, {}, {}, {}, {}
    # the cluster size of the checkout's bf16 forward (0 before it had one)
    kernel_cluster = getattr(A, "kernel_cluster", lambda D, dt: 0)
    for name, (B, H, Hkv, T, n, causal, D, bwd) in SHAPES.items():
        if not takes(D):
            continue            # a checkout whose kernels do not take this width
        q, do = (torch.randn((B, H, T, D), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, Hkv, T, D), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
        bounds = smoke.attn_bounds(q, k, lens, lens, causal)
        ms[f"fwd_{name}"] = smoke.graph_ms(
            [lambda: A.flash_attention(q, k, v, lens, lens, causal)])
        plain[f"fwd_{name}"] = smoke.time_ms(
            lambda: A.flash_attention_reference(q, k, v, lens, lens, causal), 3)
        lib = smoke.sdpa_ms(q, k, v, lens, causal)
        library[f"fwd_{name}"] = lib["ms"]
        backend[f"fwd_{name}"] = lib.get("backend", lib["call"])
        bound[f"fwd_{name}"] = max(bounds["fwd"])
        cluster[f"fwd_{name}"] = kernel_cluster(D, torch.bfloat16)
        if not bwd:
            continue
        lib = smoke.sdpa_ms(q, k, v, lens, causal, do)
        library[f"bwd_{name}"] = lib["ms"]
        backend[f"bwd_{name}"] = lib.get("backend", lib["call"])
        for tag, c in ((("", True), ("_noncausal", False)) if name == "llm_train"
                       else (("", causal),)):
            o, lse = A.flash_attention(q, k, v, lens, lens, c)
            dq_args = (q, k, v, o, lse, do, lens, lens, c)
            if reads_delta:
                _, delta = A.flash_bwd_dq(*dq_args)
                dkv_args = (q, k, v, lse, delta, do, lens, lens, c)
            else:
                dkv_args = dq_args
            if c == causal:
                ms[f"dq_{name}"] = smoke.graph_ms([lambda: A.flash_bwd_dq(*dq_args)])
                plain[f"dq_{name}"] = smoke.time_ms(
                    lambda: A.flash_bwd_dq_reference(*dq_args), 3)
                plain[f"dkv_{name}"] = smoke.time_ms(
                    lambda: A.flash_bwd_dkv_reference(*dkv_args), 3)
                bound[f"dq_{name}"] = max(bounds["dq"])
                bound[f"dkv_{name}"] = max(bounds["dkv"])
            ms[f"dkv_{name}{tag}"] = smoke.graph_ms([lambda: A.flash_bwd_dkv(*dkv_args)])
        del q, k, v, do, o, lse, dq_args, dkv_args
        torch.cuda.empty_cache()
    for name, (bits, K, N) in QMM_SHAPES.items():
        qp = quant.quantize_tensor(
            0.02 * torch.randn((K, N), generator=gen, device="cuda"), bits)
        x = torch.randn((8, K), generator=gen, device="cuda", dtype=torch.bfloat16)
        wkey = "qw4h" if bits == 4 else "qw"
        copies = int(np.ceil(L2_CYCLE_BYTES / qp[wkey].numel()))
        nodes = [qp] + [{wkey: qp[wkey].clone(), "scale": qp["scale"].clone()}
                        for _ in range(copies - 1)]
        key = f"qmatmul_{name}"
        ms[key] = smoke.graph_ms([lambda n=n: Q.qmatmul(x, n) for n in nodes])
        plain[key] = smoke.graph_ms([lambda n=n: Q.qmatmul_reference(x, n) for n in nodes])
        w16 = quant.dequantize(qp, torch.bfloat16)
        w16s = [w16] + [w16.clone() for _ in range(int(np.ceil(copies / 2)) - 1)]
        library[key] = smoke.graph_ms([lambda w=w: torch.matmul(x, w) for w in w16s])
        bound[key] = max(smoke.qmm_bound(8, K, N, bits))
        del nodes, qp, w16, w16s
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(root), "kernels": A.__file__, "ms": ms, "plain_ms": plain,
                      "library_ms": library, "library_backend": backend, "bound_ms": bound,
                      "cluster": cluster}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
