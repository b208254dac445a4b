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
- the weight-only matmuls at M = 8: int4 and int8 at the flagship's four
  decode projections (qkv, o, gateup, down; int8 is model.use_8bit) and the
  int8 lm head, with the weights
  cycled through 128 MB so that they come from memory and not from the
  50 MB L2, as ``chip_smoke.py::qmm_kernel_phase`` times them.
Inputs come from ``--seed``. Each time is ``chip_smoke.py::graph_ms`` of
this checkout: the device time per launch of a CUDA graph of 20 launches
(or one per weight copy, if more) replayed three times. Prints the card's
name and power limit, then one JSON line. Needs a CUDA device.
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

# name: B, H, Hkv, T, valid rows, causal, D
SHAPES = {
    "whisper": (8, 16, 16, 512, 500, False, 64),
    "llm_prefill": (8, 32, 8, 533, 533, True, 64),
    "llm_train": (8, 32, 8, 672, 581, True, 64),
    "connector": (8, 8, 8, 500, 500, False, 256),
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

    print(smoke.gpu_line())
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ms = {}
    for name, (B, H, Hkv, T, n, causal, D) in SHAPES.items():
        if D not in getattr(A, "KERNEL_HEAD_DIMS", (64, 128)):
            continue            # a checkout whose kernels do not take this width
        q, do = (torch.randn((B, H, T, D), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, Hkv, T, D), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
        ms[f"fwd_{name}"] = smoke.graph_ms(
            [lambda: A.flash_attention(q, k, v, lens, lens, causal)])
        if name not in ("llm_train", "connector"):
            continue
        for tag, c in ((("", True), ("_noncausal", False)) if causal
                       else (("", False),)):
            o, lse = A.flash_attention(q, k, v, lens, lens, c)
            dq_args = (q, k, v, o, lse, do, lens, lens, c)
            if reads_delta:
                _, delta = A.flash_bwd_dq(*dq_args)
                dkv_args = (q, k, v, lse, delta, do, lens, lens, c)
            else:
                dkv_args = dq_args
            if c == causal:
                ms[f"dq_{name}"] = smoke.graph_ms([lambda: A.flash_bwd_dq(*dq_args)])
            ms[f"dkv_{name}{tag}"] = smoke.graph_ms([lambda: A.flash_bwd_dkv(*dkv_args)])
    for name, (bits, K, N) in QMM_SHAPES.items():
        qp = quant.quantize_tensor(
            0.02 * torch.randn((K, N), generator=gen, device="cuda"), bits)
        x = torch.randn((8, K), generator=gen, device="cuda", dtype=torch.bfloat16)
        wkey = "qw4h" if bits == 4 else "qw"
        copies = int(np.ceil(L2_CYCLE_BYTES / qp[wkey].numel()))
        nodes = [qp] + [{wkey: qp[wkey].clone(), "scale": qp["scale"].clone()}
                        for _ in range(copies - 1)]
        ms[f"qmatmul_{name}"] = smoke.graph_ms([lambda n=n: Q.qmatmul(x, n) for n in nodes])
        del nodes, qp
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(root), "kernels": A.__file__, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
