"""Step profiler, the port of ``avsr_tpu/cli/profile.py``: per-kernel
device-time attribution for the hot loops.

Traces a few steps of the train step (or of a greedy decode) under
``torch.profiler`` (the CPU, plus the card's activity through CUPTI),
keeps the raw Chrome trace next to ``profile_report.json``, reads it back
and ranks device time

  * by category: the port's own kernels by name (``flash_fwd``,
    ``flash_bwd_dq``, ``flash_bwd_dkv``, ``qmatmul_int8``,
    ``qmatmul_int4``), ``gemm`` (cuBLAS/CUTLASS/cuDNN), ``elementwise``,
    ``reduction``, ``copy`` (memcpy, memset, copy kernels), ``other``;
  * by scope: the host op or ``record_function`` range that launched each
    kernel, linked through the trace's correlation ids, behind the
    autograd node that ran it in the backward (``MmBackward0/aten::mm``);
  * by kernel (``top_ops``).

    python -m avsr_tpu_torch.cli.profile --mode train data.batch_size=8
    python -m avsr_tpu_torch.cli.profile --mode decode decode.max_new_tokens=32

The report keeps the JAX CLI's keys, and adds ``kernels_in_trace``: the
port's kernels among the trace's events (the CLI reads the trace once, and
on the card checks them against the wrappers' counters). ``device_busy_ms`` sums the kernel,
memcpy and memset events (``async_dma_ms`` is the memcpy part of it);
``trace_span_ms`` runs from the first device event's start to the last
one's end; ``loop_ms`` is the device time of what was launched inside the
token loop (``avsr::decode_loop``) or a micro-batch's forward and backward
(``avsr::micro_batch``), ``prefix_ms`` the rest. A trace with no device
event (a CPU run) falls back to the host ops' own times (less their
nested ops'), as the JAX CLI falls back to host lines; on the card a trace without kernels is an
error. ``analyze_trace`` also reads the Trainer's trace
(``runtime.profile_dir``).
"""

from __future__ import annotations

import bisect
import collections
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from avsr_tpu_torch.cli.common import (base_parser, init_params, load_cli_config,
                                       load_decode_params)
from avsr_tpu_torch.models.avsr import Batch

log = logging.getLogger("avsr_tpu_torch.cli.profile")

PORT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "qmatmul_int8",
                "qmatmul_int4")
LOOP_RANGES = ("avsr::decode_loop", "avsr::micro_batch")
# Substrings of kernel names (lower case) and of the host ops of a CPU
# trace, by category; the first category that matches wins.
CATEGORIES = (
    *((k, (k,)) for k in PORT_KERNELS),
    ("gemm", ("gemm", "cutlass", "cublas", "xmma", "nvjet", "conv",
              "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")),
    ("copy", ("memcpy", "memset", "copy", "aten::cat", "aten::index", "gather",
              "scatter")),
    ("reduction", ("reduce", "softmax", "norm", "scan", "sort", "topk", "argmax",
                   "aten::sum", "aten::mean", "aten::max", "aten::min", "aten::var")),
    ("elementwise", ("elementwise", "fill", "aten::")),
)
_NODE = "autograd::engine::evaluate_function: "


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Trace + attribute device time for the hot loops")
    p.add_argument("--mode", choices=("train", "decode"), default="train")
    p.add_argument("--steps", type=int, default=4,
                   help="traced step count (after one guard step, left out of the report)")
    p.add_argument("--output_dir", default="outputs/profile")
    p.add_argument("--top", type=int, default=15, help="rows per table")
    args = p.parse_args(argv)
    cfg = load_cli_config(args)
    device = torch.device(args.device)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("this torch build cannot trace the card: "
                               "ProfilerActivity.CUDA (CUPTI) is not supported")
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    run_step = _build_runner(cfg, args.mode, seed=args.seed, device=device)
    trace = out / f"trace_{args.mode}.json"
    wall, launched = trace_steps(run_step, args.steps, acts, trace)
    log.info("traced %d %s steps in %.3fs", args.steps, args.mode, wall)
    log.info("kernel launches over the traced steps (the wrappers' counters): %s",
             launched)

    events = trace_events(trace)            # the trace's one read
    report = analyze_trace(out, top=args.top, events=events)
    report["kernels_in_trace"] = traced = kernel_counts(events)
    if device.type == "cuda":
        if not report["planes"][0].startswith("GPU"):
            raise RuntimeError(f"{trace} holds no device event: CUPTI recorded "
                               "nothing on the card")
        if traced != launched:
            raise RuntimeError(f"the trace's kernels {traced} differ from the "
                               f"wrappers' launches {launched}")
    report["mode"] = args.mode
    report["steps"] = args.steps
    report["wall_s"] = round(wall, 4)
    with open(out / "profile_report.json", "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report, indent=2))
    return 0


# the range of the call that opens a profile's window; the trace's readers
# leave it out (``trace_steps``, ``trace_events``)
GUARD = "avsr::profile_guard"
# the card's events of a trace, timed on the card's clock
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation", "cuda_sync")


def trace_steps(run_step, steps: int, activities: list, trace: Path
                ) -> tuple[float, dict[str, int]]:
    """``steps`` calls of ``run_step`` traced by ``torch.profiler`` into
    the Chrome trace ``trace``, after one more call at the start of the
    same window, under the range :data:`GUARD`, which the trace's readers
    leave out (``trace_events``; it also takes the kernel builds and
    first-use set-up). On the card a window loses the kernel records of its
    first launches (up to 664 of a decode profile's), so the guard call
    takes those losses and what the readers see keeps every kernel of the
    traced steps. Returns (the traced steps' wall seconds, the wrappers'
    launches over them)."""
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(GUARD):
            run_step()
        before = launch_counts()
        wall = 0.0
        for _ in range(steps):
            t0 = time.perf_counter()
            run_step()
            wall += time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    prof.export_chrome_trace(str(trace))
    return wall, launched


def launch_counts() -> dict[str, int]:
    """The kernel wrappers' launch counters, by kernel."""
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q

    return dict(flash_fwd=A.launches, flash_bwd_dq=A.dq_launches,
                flash_bwd_dkv=A.dkv_launches, qmatmul_int8=Q.int8_launches,
                qmatmul_int4=Q.int4_launches)


def _build_runner(cfg, mode: str, *, seed: int, device: torch.device):
    """-> zero-argument callable running ONE step on synthetic data shaped
    by the config's largest buckets, as the JAX CLI builds it: B =
    ``data.batch_size``, 8 prompt tokens, 48 labels, numpy seed 0. Train:
    the port's train step over one micro-batch of B. Decode:
    ``generate_tokens`` over ``decode.max_new_tokens`` with no EOS, on the
    serving weights (``load_decode_params``: the quantized projections, the
    head of ``decode.lm_head_bits``) with ``decode.kv_cache_dtype``."""
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.train.state import create_train_state
    from avsr_tpu_torch.train.step import make_train_step, microbatch

    m, d = cfg.model, cfg.data
    B = d.batch_size
    Ta = d.audio_buckets[-1] if d.audio_buckets else 1000
    Tv = d.video_buckets[-1] if d.video_buckets else 25
    dtype = getattr(torch, cfg.runtime.compute_dtype)
    rng = np.random.default_rng(0)

    def dev(a: np.ndarray, dt: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(a).to(device=device, dtype=dt)

    audio = m.modality in ("audio", "both")
    video = m.modality in ("video", "both")
    mel = rng.standard_normal((B, m.whisper.n_mels, Ta))
    frames = rng.standard_normal((B, Tv, 3, m.image_size, m.image_size))
    full = torch.full((B,), 0, dtype=torch.int32, device=device)
    batch = Batch(
        mel=dev(mel, torch.float32) if audio else None,
        mel_lens=full + Ta if audio else None,
        frames=dev(frames, torch.bfloat16) if video else None,
        frame_lens=full + Tv if video else None,
        prompt_tokens=dev(rng.integers(0, 100, (B, 8)), torch.int32),
        labels=dev(rng.integers(0, 100, (B, 48)), torch.int32),
        label_lens=full + 48)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if mode == "train":
        state = create_train_state(init_params(cfg, seed=seed, device=device), cfg,
                                   total_steps=1000)
        step_fn = make_train_step(cfg)
        mb = microbatch(batch, 1)
        count = iter(range(1, 1 << 30))

        def run() -> None:
            step_fn(state, mb, next(count))
            sync()
        return run

    params = load_decode_params(cfg, seed=seed, device=device)

    def run() -> None:
        generate_tokens(params, m, batch, max_new_tokens=cfg.decode.max_new_tokens,
                        eos_id=-1, compute_dtype=dtype,
                        use_kernel=cfg.runtime.use_pallas,
                        kv_cache_dtype=cfg.decode.kv_cache_dtype)
        sync()
    return run


# ---------------------------------------------------------------------------
# Chrome-trace parsing
# ---------------------------------------------------------------------------

def find_trace(trace_dir: str | Path) -> Path:
    """The newest ``trace*.json`` under ``trace_dir``: this CLI's
    ``trace_{mode}.json`` or the Trainer's ``trace_step{N}.json``."""
    found = sorted(Path(trace_dir).rglob("trace*.json"), key=lambda f: f.stat().st_mtime)
    if not found:
        raise FileNotFoundError(f"no torch.profiler trace (trace*.json) under {trace_dir}")
    return found[-1]


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def trace_events(path: str | Path) -> list[dict]:
    """The complete ("X") events of a trace file, less those of its guard
    call (``trace_steps``): the host's events that start before the
    :data:`GUARD` range ends, and the card's events of the host calls among
    them, found by correlation id. The card's times are never compared with
    the host's: converted to the host's clock, a kernel can start before
    the call that launched it. A trace without the range is read whole."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X"]
    guards = [float(e["ts"]) + float(e.get("dur", 0)) for e in events
              if e.get("name") == GUARD and e.get("cat") == "user_annotation"]
    if not guards:
        return events
    end = max(guards)

    def device(e: dict) -> bool:
        return e.get("cat") in DEVICE_CATS

    early = {e.get("args", {}).get("correlation") for e in events
             if not device(e) and float(e["ts"]) < end}
    early.discard(None)
    return [e for e in events
            if e.get("args", {}).get("correlation") not in early and e.get("name") != GUARD
            and (device(e) or float(e["ts"]) >= end)]


def kernel_counts(events: list[dict]) -> dict[str, int]:
    """Kernel events per port kernel (``PORT_KERNELS``) among ``events``,
    what :func:`trace_events` read from a trace."""
    n = collections.Counter(category(e["name"]) for e in events if e.get("cat") == "kernel")
    return {k: n[k] for k in PORT_KERNELS}


class _Host:
    """The host events of a trace (ops, ``record_function`` ranges, CUDA
    API calls), each with its enclosing event on its thread."""

    def __init__(self, events: list[dict]):
        self.name: list[str] = []
        self.cat: list[str] = []
        self.parent: list[int] = []
        self.ts: list[float] = []
        self.dur: list[float] = []
        self.tid: list = []
        self.self_us: list[float] = []       # an op's time less its ops'
        self.by_corr: dict[int, int] = {}
        threads = collections.defaultdict(list)
        for e in events:
            if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                "cuda_driver"):
                threads[(e.get("pid"), e.get("tid"))].append(e)
        for tid, evs in threads.items():
            evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
            stack: list[int] = []
            for e in evs:
                while stack and self.ts[stack[-1]] + self.dur[stack[-1]] <= e["ts"]:
                    stack.pop()
                i = len(self.name)
                parent = stack[-1] if stack else -1
                self.name.append(e["name"])
                self.cat.append(e["cat"])
                self.parent.append(parent)
                self.ts.append(e["ts"])
                self.dur.append(e.get("dur", 0))
                self.tid.append(tid)
                self.self_us.append(e.get("dur", 0))
                if e["cat"].startswith("cuda_"):
                    self.by_corr[e.get("args", {}).get("correlation")] = i
                elif e["cat"] == "cpu_op":
                    op = parent
                    while op >= 0 and self.cat[op] != "cpu_op":
                        op = self.parent[op]
                    if op >= 0:
                        self.self_us[op] -= e.get("dur", 0)
                stack.append(i)

    def chain(self, i: int) -> list[str]:
        """Names of the events enclosing ``i``, innermost first."""
        out = []
        i = self.parent[i]
        while i >= 0:
            out.append(self.name[i])
            i = self.parent[i]
        return out


def _scope(names: list[str]) -> str:
    """The launching op (innermost), behind its autograd node if any."""
    if not names:
        return "(no host op)"
    node = next((n[len(_NODE):] for n in names if n.startswith(_NODE)), None)
    return f"{node}/{names[0]}" if node and node != names[0] else names[0]


def analyze_trace(trace_dir: str | Path, top: int = 15,
                  events: list[dict] | None = None) -> dict:
    """Aggregate the newest trace under ``trace_dir`` (or its ``events``,
    already read by :func:`trace_events`): device time by kernel, by
    category and by launching scope, the loop/prefix split and the device's
    duty cycle (see the module docstring)."""
    path = find_trace(trace_dir)
    if events is None:
        events = trace_events(path)
    host = _Host(events)
    loops = sorted((host.ts[i], host.ts[i] + host.dur[i])
                   for i in range(len(host.name)) if host.name[i] in LOOP_RANGES)
    loop_starts = [s for s, _ in loops]

    def in_loop(t: float) -> bool:         # the ranges run one after another
        j = bisect.bisect_right(loop_starts, t) - 1
        return j >= 0 and t <= loops[j][1]

    # (name, category, us, start, end, scope, launched at, a memcpy)
    rows = []
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if device:
        planes = sorted({f"GPU {e['args'].get('device')} stream {e['args'].get('stream')}"
                         for e in device})
        for e in device:
            h = host.by_corr.get(e.get("args", {}).get("correlation"))
            names = [] if h is None else host.chain(h)   # the ops around the launch
            cat = "copy" if e["cat"] != "kernel" else category(e["name"])
            rows.append((e["name"], cat, e.get("dur", 0), e["ts"], e["ts"] + e.get("dur", 0),
                         _scope(names), e["ts"] if h is None else host.ts[h],
                         e["cat"] == "gpu_memcpy"))
    else:       # no device activity (a CPU run): each host op's own time
        ops = [i for i in range(len(host.name)) if host.cat[i] == "cpu_op"]
        planes = sorted({f"thread {host.tid[i][1]}" for i in ops})
        for i in ops:
            rows.append((host.name[i], category(host.name[i]), max(host.self_us[i], 0.0),
                         host.ts[i], host.ts[i] + host.dur[i],
                         _scope([host.name[i]] + host.chain(i)), host.ts[i], False))

    by_op: collections.Counter = collections.Counter()
    by_cat: collections.Counter = collections.Counter()
    by_scope: collections.Counter = collections.Counter()
    total = loop = dma = 0.0
    for name, cat, dur, _, _, scope, launched, is_copy in rows:
        by_op[name] += dur
        by_cat[cat] += dur
        by_scope[scope] += dur
        total += dur
        dma += dur if is_copy else 0.0
        loop += dur if in_loop(launched) else 0.0
    span = (max(r[4] for r in rows) - min(r[3] for r in rows)) if rows else 0.0

    def table(counter: collections.Counter) -> list[dict]:
        tot = max(total, 1e-9)
        return [{"name": k, "ms": round(v / 1e3, 3), "pct": round(100 * v / tot, 2)}
                for k, v in counter.most_common(top)]

    busy_ms = total / 1e3
    span_ms = span / 1e3
    return {
        "trace": str(path),
        "planes": planes,
        "device_busy_ms": round(busy_ms, 3),
        "async_dma_ms": round(dma / 1e3, 3),
        "trace_span_ms": round(span_ms, 3),
        "device_duty_cycle": round(busy_ms / span_ms, 3) if span_ms else None,
        "loop_ms": round(loop / 1e3, 3),
        "prefix_ms": round((total - loop) / 1e3, 3),
        "by_category": table(by_cat),
        "by_scope": table(by_scope),
        "top_ops": table(by_op),
    }


if __name__ == "__main__":
    raise SystemExit(main())
