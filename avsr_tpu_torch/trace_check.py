"""Does ``cli/profile.py``'s trace hold every kernel the wrappers launched?

    python3 avsr_tpu_torch/trace_check.py [--root DIR] [--rounds N]

Runs the profile CLI of the checkout at ``--root`` (default: this one;
its ``cli/profile.py`` must have ``trace_events``) in one process,
``--rounds`` times over: a train profile (2 steps) and then a decode
profile (1 call of 32 tokens), on the flagship at the largest buckets, as
``chip_smoke.py``'s phase 20 runs them. A profile whose trace's kernels
by name differ from the wrappers' counters raises in the CLI; this script
catches that, counts it, and keeps that trace under
``outputs/trace_check/``. For every trace it also lists the kernel launch
calls (``cudaLaunchKernel`` and ``cuLaunchKernel``, the ctypes launches
included) among the events that the CLI reads (``trace_events``, less the
guard call that opens each window) whose ``correlation`` no kernel event
carries: their index among the launches and their offset from the first
host event, from one read of the trace (``trace_events``) that also gives
the kernels it counts. It prints one JSON line per profile and a summary
line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

FLAGSHIP = ("data.audio_buckets=1000,2000,3000", "model.max_seq_len=1536",
            "training.grad_accum_steps=4")


def unlinked_launches(events: list[dict]) -> list[dict]:
    """The launches among a trace's ``events`` whose correlation no kernel
    event carries: their API names, indices among the launches and offsets
    (ms from the first host event)."""
    with_kernel = {e["args"]["correlation"] for e in events
                   if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                                  "cuda_driver") and "ts" in e]
    t0 = min(float(e["ts"]) for e in host)
    launches = sorted((e for e in host if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e["name"]), key=lambda e: float(e["ts"]))
    return [dict(launch=e["name"], index=i, of=len(launches),
                 offset_ms=(float(e["ts"]) - t0) / 1e3)
            for i, e in enumerate(launches)
            if e.get("args", {}).get("correlation") not in with_kernel]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    from avsr_tpu_torch.cli import profile

    torch.backends.cuda.matmul.allow_tf32 = False
    runs = [("train", 2, []), ("decode", 1, ["decode.max_new_tokens=32"])]
    outputs = Path(args.root) / "outputs"
    outputs.mkdir(exist_ok=True)
    failed = total = 0
    with tempfile.TemporaryDirectory(dir=outputs) as work:
        for r in range(args.rounds):
            for mode, steps, over in runs:
                out = Path(work) / f"{mode}{r}"
                t0 = time.perf_counter()
                err = None
                try:
                    profile.main(["--seed", str(args.seed), "--device", "cuda", "--mode", mode,
                                  "--steps", str(steps), "--output_dir", str(out),
                                  *FLAGSHIP, *over])
                except RuntimeError as e:       # the CLI's check of trace against counters
                    err = str(e)
                trace = out / f"trace_{mode}.json"
                if err is not None:
                    (outputs / "trace_check").mkdir(exist_ok=True)
                    shutil.copy(trace, outputs / "trace_check" / f"{mode}{r}.json")
                events = profile.trace_events(trace)
                unlinked = unlinked_launches(events)
                total += 1
                failed += err is not None
                print(json.dumps(dict(round=r, mode=mode, seconds=time.perf_counter() - t0,
                                      check_failed=err, kernels=profile.kernel_counts(events),
                                      unlinked=unlinked[:20], n_unlinked=len(unlinked))),
                      flush=True)
    print(json.dumps(dict(root=args.root, profiles=total, failed=failed,
                          card=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
