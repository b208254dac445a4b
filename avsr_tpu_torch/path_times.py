"""Times of the dense flagship's serving call and train step, per checkout.

    python3 avsr_tpu_torch/path_times.py [--root DIR] [--seed N] [--steps N]

Runs the ``avsr_tpu_torch`` package under ``--root`` (by default the
checkout this file lies in; another checkout of the repo, such as an
earlier commit unpacked with ``git archive``, is timed by the same method):
its kernels built from that checkout's sources, then ``chip_smoke.py``'s
main-path phase (phase 3: the flagship with random bf16 weights from
``--seed``, one ``generate_tokens`` call of B = 8, 10 s audio, 25 frames,
100 tokens, with its gates), then ``--steps`` bf16 LoRA train steps of 8
(accum 1, 48-token transcripts; frozen leaves bf16, trainable f32) as
phase 17 times a connector's. Host-clock times that end in a device
synchronize: the calls are host-paced, so compare two checkouts only in
one call on one card, in turns (parent, change, change, parent), one
process each. Prints the card's name and power limit, then one JSON line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=str(HERE))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=4)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("path_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    build = importlib.import_module("avsr_tpu_torch.ops._build")
    if not Path(build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {build.__file__}, not the package under {root}")
    config = importlib.import_module("avsr_tpu_torch.core.config")
    loader = importlib.import_module("avsr_tpu_torch.data.loader")
    tokenizer = importlib.import_module("avsr_tpu_torch.data.tokenizer")
    avsr = importlib.import_module("avsr_tpu_torch.models.avsr")
    state = importlib.import_module("avsr_tpu_torch.train.state")

    print(smoke.gpu_line())
    build.build_all()
    serve = smoke.main_path_phase(args.seed)
    smoke.settle()
    cfg = config.flagship(["training.grad_accum_steps=1"])
    params = avsr.init_avsr_model(cfg.model, seed=args.seed, device="cuda",
                                  dtype=torch.bfloat16)
    host = smoke.train_host_batch(cfg, tokenizer.ByteTokenizer(),
                                  np.random.default_rng(args.seed + 1701))
    micro = loader.featurize(host, "cuda", torch.bfloat16)
    _, tr = smoke._run_steps(cfg, state.cast_frozen(params, cfg.model, torch.bfloat16),
                             smoke._stack([micro]), args.steps, "train", args.seed)
    print(json.dumps(dict(
        root=str(root), encode_ms=serve["encode_ms"], prefill_ms=serve["prefill_ms"],
        ms_per_token=serve["ms_per_token"], call_peak_gb=serve["peak_mem_gb"],
        train_steps_ms=[s["ms"] for s in tr["steps"]], train_peak_gb=tr["peak_mem_gb"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
