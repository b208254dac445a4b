"""Memory analysis entry point, the port of ``avsr_tpu/cli/analyze_memory.py``.

Per-component parameter memory across precision modes (``fp32``, ``bf16``,
``int8_llm``, ``int4_llm``: GiB per top-level component and ``total_gib``),
the parameter counts, an activation estimate, the device's allocator
statistics (``torch.cuda.memory_stats()``, on the card only) and each
component measured alone on the device, written to ``memory_stats.json``
(and ``memory_analysis.png`` where matplotlib imports).

    python -m avsr_tpu_torch.cli.analyze_memory model.llm.d_model=2048

The analytic part counts the shapes of a fake-tensor init (no bytes are
allocated), so it equals the JAX CLI's report for the same config.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from avsr_tpu_torch.cli.common import base_parser, load_cli_config
from avsr_tpu_torch.models.avsr import init_avsr_model
from avsr_tpu_torch.train.state import count_trainable, tree_leaves

log = logging.getLogger("avsr_tpu_torch.cli.analyze_memory")

BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "int4": 0.5}


def shape_tree(cfg) -> dict:
    """The f32 parameter tree of ``cfg.model`` as fake tensors: shapes and
    dtypes, no storage (the counterpart of ``jax.eval_shape``)."""
    with FakeTensorMode():
        return init_avsr_model(cfg.model, device="cpu")


def component_bytes(params, dtype_bytes: float) -> dict[str, float]:
    """Each top-level component's bytes at ``dtype_bytes`` a parameter."""
    return {name: sum(x.numel() for x in tree_leaves(sub)) * dtype_bytes
            for name, sub in params.items()}


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Analyze component memory usage")
    p.add_argument("--output_dir", default="outputs/memory")
    args = p.parse_args(argv)
    cfg = load_cli_config(args)
    device = torch.device(args.device)

    params = shape_tree(cfg)
    report: dict = {"modality": cfg.model.modality,
                    "connector": cfg.model.connector_type, "modes": {}}
    counts = component_bytes(params, 1)
    # (mode, bytes an LLM parameter, bytes any other parameter)
    for mode, llm, other in (("fp32", 4, 4), ("bf16", 2, 2), ("int8_llm", 1, 2),
                             ("int4_llm", 0.5, 2)):
        comps = {name: round(n * (llm if name == "llm" else other) / 2**30, 4)
                 for name, n in counts.items()}
        comps["total_gib"] = round(sum(comps.values()), 4)
        report["modes"][mode] = comps

    trainable, total = count_trainable(params, cfg.model)
    report["params_total"] = total
    report["params_trainable"] = trainable
    report["activation_estimate_gib"] = activation_estimate(cfg)
    if device.type == "cuda":
        report["device_memory"] = {k: int(v) for k, v in
                                   torch.cuda.memory_stats(device).items()
                                   if isinstance(v, (int, float))}
    report["measured_fp32"] = measured_component_bytes(cfg, device)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "memory_stats.json", "w") as fh:
        json.dump(report, fh, indent=2)
    save_charts(report, out)
    print(json.dumps(report, indent=2))
    return 0


def activation_estimate(cfg) -> dict[str, float]:
    """Rough per-train-step activation memory, the JAX CLI's formula: the
    per-LLM-layer residual-stream tensors kept for the backward (the frozen
    encoders store nothing) plus the encoder outputs, at the compute
    dtype's width, batch ``data.batch_size``, the largest buckets."""
    m, d = cfg.model, cfg.data
    B = d.batch_size
    bytes_el = BYTES.get(cfg.runtime.compute_dtype, 4)
    T_audio = (min(d.audio_buckets[-1], m.whisper.max_frames) // 2
               if m.modality in ("audio", "both") and d.audio_buckets else 0)
    T_video = (d.video_buckets[-1]
               if m.modality in ("video", "both") and d.video_buckets else 0)
    T_fused = min(T_audio + T_video, m.max_seq_len)
    T_pack = T_fused + d.max_label_length + 16          # + prompt margin
    # ~8 stored [B, T, d]-sized tensors per transformer layer w/o remat
    per_layer = 8 * B * T_pack * m.llm.d_model * bytes_el
    ffn = 2 * B * T_pack * m.llm.ffn_dim * bytes_el
    llm = m.llm.n_layers * (per_layer + ffn)
    enc_out = B * T_audio * m.whisper.d_model * bytes_el
    return {
        "llm_no_remat": round(llm / 2**30, 3),
        "llm_remat": round((per_layer + ffn) * 2 / 2**30, 3),
        "encoder_outputs": round(enc_out / 2**30, 4),
        "note": "estimate; mesh.remat trades this for recompute",
    }


def measured_component_bytes(cfg, device: torch.device) -> dict[str, dict[str, int]]:
    """Each top-level component alone on ``device``, one after another: its
    f32 leaves (from the fake-tensor tree's shapes) are allocated, measured
    and freed before the next. ``on_device`` sums the leaves' storage bytes
    (at least the logical bytes); on the card, ``allocator_delta`` is the
    change of ``torch.cuda.memory_allocated`` around the allocation, which
    adds the caching allocator's rounding (the JAX CLI reads
    ``bytes_in_use`` where the backend has it)."""
    cuda = device.type == "cuda"
    out: dict[str, dict[str, int]] = {}
    for name, sub in shape_tree(cfg).items():
        if cuda:
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
        leaves = [torch.empty(x.shape, dtype=x.dtype, device=device)
                  for x in tree_leaves(sub)]
        row = {"on_device": sum(t.untyped_storage().nbytes() for t in leaves)}
        if cuda:
            row["allocator_delta"] = torch.cuda.memory_allocated(device) - base
        out[name] = row
        del leaves               # freed before the next component
    return out


def save_charts(report: dict, out: Path) -> None:
    """Pie (per-component share) + bar (per-mode totals) charts, as the JAX
    CLI draws them; skipped with a warning without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        log.warning("matplotlib unavailable — skipping charts")
        return

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    bf16 = {k: v for k, v in report["modes"]["bf16"].items()
            if k != "total_gib" and v > 0}
    if bf16:
        ax1.pie(bf16.values(), labels=list(bf16), autopct="%1.1f%%",
                startangle=90)
        ax1.set_title("Component memory share (bf16)")
    else:   # sub-MiB components round to 0 GiB (tiny test models)
        ax1.axis("off")

    modes = list(report["modes"])
    totals = [report["modes"][m]["total_gib"] for m in modes]
    bars = ax2.bar(modes, totals, color="#4878cf")
    ax2.bar_label(bars, fmt="%.2f")
    ax2.set_ylabel("GiB")
    ax2.set_title("Total parameter memory by mode")
    fig.tight_layout()
    fig.savefig(out / "memory_analysis.png", dpi=120)
    plt.close(fig)
    log.info("charts -> %s", out / "memory_analysis.png")


if __name__ == "__main__":
    raise SystemExit(main())
