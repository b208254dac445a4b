"""Distil a speculative-decoding draft from a teacher, the port of
``avsr_tpu/cli/distill.py``.

A smaller student (typically fewer LLM layers, the same vocabulary and
modality) learns the teacher's distributions at the label positions: the
KL divergence at temperature ``tau`` (scaled by tau^2), mixed with
``alpha`` x its own hard-label CE. It starts from the teacher's weights
wherever the shapes line up (encoders, embeddings, the first k LLM
blocks). The student's LLM must train (``model.freeze_llm=false``).

    python -m avsr_tpu_torch.cli.distill --config draft.yaml \\
        --teacher-config base.yaml --teacher-checkpoint outputs/avsr/ckpt \\
        --out outputs/draft_export \\
        model.llm.n_layers=4 model.freeze_llm=false model.lora.use_lora=false

``--out`` receives the params export, ``config.yaml`` (JSON text, read by
both packages' ``load_config``) and ``distill_report.json``. Decode with
it: ``python -m avsr_tpu_torch.cli.decode ... decode.speculative=true
decode.spec_draft_checkpoint=outputs/draft_export
decode.spec_draft_config=outputs/draft_export/config.yaml``.
"""

from __future__ import annotations

import json
import logging
import math
import time
from pathlib import Path
from typing import Any, Callable

import torch

from avsr_tpu_torch.cli.common import (base_parser, build_data, init_or_load_params,
                                       load_cli_config)
from avsr_tpu_torch.core.config import AVSRConfig, load_config, save_config
from avsr_tpu_torch.models.avsr import Batch, forward, init_avsr_model
from avsr_tpu_torch.models.layers import Params
from avsr_tpu_torch.train.checkpoint import export_params
from avsr_tpu_torch.train.state import TrainState, create_train_state
from avsr_tpu_torch.train.step import global_norm

log = logging.getLogger("avsr_tpu_torch.cli.distill")


def warm_start(student: Any, teacher: Any) -> tuple[Any, int]:
    """Copy every teacher leaf whose path and shape exist in the student.
    Dict keys match by name and lists (the LLM's layers) by index, so a
    shallower student gets the teacher's first k blocks. Returns (tree,
    leaves copied); copies take the student's dtype and device and share
    no storage with the teacher."""
    copied = 0

    def rec(s, t):
        nonlocal copied
        if isinstance(s, dict) and isinstance(t, dict):
            return {k: rec(v, t[k]) if k in t else v for k, v in s.items()}
        if isinstance(s, list) and isinstance(t, list):
            return [rec(si, ti) for si, ti in zip(s, t)] + list(s[len(t):])
        if isinstance(s, torch.Tensor) and isinstance(t, torch.Tensor) \
                and s.shape == t.shape:
            copied += 1
            return t.to(device=s.device, dtype=s.dtype, copy=True)
        return s

    return rec(student, teacher), copied


def make_distill_step(cfg: AVSRConfig, tcfg: AVSRConfig, *, tau: float,
                      alpha: float) -> Callable[..., dict[str, float]]:
    """``step(state, teacher, batch, seed) -> metrics``, updating ``state``
    in place: KL(teacher || student) at temperature ``tau`` over the label
    positions that hold a label, times tau^2, weighted 1 - ``alpha``, plus
    ``alpha`` x the student's CE; the gradient of the student's trainable
    leaves goes to its clipped optimizer. ``seed`` draws the student's
    dropout. Metrics: ``loss``, ``kl``, ``ce`` and ``agree`` (how often the
    student's argmax is the teacher's, the proxy for acceptance)."""
    cdt = getattr(torch, cfg.runtime.compute_dtype)
    use_kernel = cfg.runtime.use_pallas

    def step(state: TrainState, teacher: Params, batch: Batch,
             seed: int) -> dict[str, float]:
        with torch.no_grad():
            _, t_m = forward(teacher, tcfg.model, batch, compute_dtype=cdt,
                             use_kernel=use_kernel, return_logits=True)
            tl = t_m["label_logits"].float()                         # [B, Tl, V]
            mask = t_m["label_mask"]                                 # [B, Tl]
            n = mask.sum().clamp(min=1.0)
            t_lp = torch.log_softmax(tl / tau, dim=-1)
        ce, s_m = forward(state.params, cfg.model, batch, compute_dtype=cdt,
                          use_kernel=use_kernel, dropout_seed=seed,
                          return_logits=True)
        sl = s_m["label_logits"].float()
        s_lp = torch.log_softmax(sl / tau, dim=-1)
        kl = (torch.exp(t_lp) * (t_lp - s_lp)).sum(dim=-1)          # [B, Tl]
        kl = (kl * mask).sum() / n * (tau * tau)
        loss = alpha * ce + (1.0 - alpha) * kl
        leaves = state.optimizer.leaves
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(leaves, torch.autograd.grad(loss, leaves,
                                                             allow_unused=True))]
        state.optimizer.update(grads, global_norm(grads))
        state.step += 1
        with torch.no_grad():
            agree = ((sl.argmax(-1) == tl.argmax(-1)) * mask).sum() / n
        return {"loss": float(loss.detach()), "kl": float(kl.detach()),
                "ce": float(ce.detach()), "agree": float(agree)}

    return step


def main(argv: list[str] | None = None) -> int:
    p = base_parser("Distil a speculative-decoding draft from a teacher")
    p.add_argument("--teacher-config", required=True, help="teacher config file")
    p.add_argument("--teacher-checkpoint", required=True,
                   help="teacher trainer checkpoint dir or params export")
    p.add_argument("--teacher-override", action="append", default=[],
                   help="dotted override of the teacher config (repeatable)")
    p.add_argument("--out", required=True,
                   help="output dir: params export + config.yaml")
    p.add_argument("--tau", type=float, default=2.0,
                   help="distillation temperature")
    p.add_argument("--alpha", type=float, default=0.3,
                   help="hard-label CE weight (1 - alpha on the KL term)")
    p.add_argument("--no-warm-start", action="store_true",
                   help="random student init instead of copying "
                        "shape-matching teacher weights")
    args = p.parse_args(argv)
    cfg = load_cli_config(args)                        # the student
    tcfg = load_config(args.teacher_config, args.teacher_override)
    if cfg.model.llm.vocab_size != tcfg.model.llm.vocab_size:
        raise SystemExit(
            f"draft/teacher vocab mismatch: {cfg.model.llm.vocab_size} vs "
            f"{tcfg.model.llm.vocab_size} — speculative verify requires a "
            f"shared vocabulary")
    if cfg.model.freeze_llm:
        raise SystemExit(
            "student model.freeze_llm=true: a frozen-LLM draft cannot "
            "distill — set model.freeze_llm=false (and usually "
            "model.lora.use_lora=false) for the student")
    device = torch.device(args.device)

    teacher = init_or_load_params(tcfg, args.teacher_checkpoint, seed=args.seed,
                                  device=device)
    student = init_avsr_model(cfg.model, seed=args.seed + 1, device=device,
                              dtype=getattr(torch, cfg.runtime.param_dtype))
    if not args.no_warm_start:
        student, n_copied = warm_start(student, teacher)
        log.info("warm start: %d leaves copied from the teacher", n_copied)

    _, _, loader = build_data(cfg, "train", device=device)
    if len(loader) == 0:
        raise SystemExit(f"empty train split under data.path={cfg.data.path!r} — "
                         f"nothing to distill on")
    total = (cfg.training.max_steps if cfg.training.max_steps > 0
             else len(loader) * cfg.training.num_epochs)
    if total <= 0:
        raise SystemExit("no training budget: set training.max_steps > 0 or "
                         "training.num_epochs > 0")
    state = create_train_state(student, cfg, total_steps=total)
    step_fn = make_distill_step(cfg, tcfg, tau=args.tau, alpha=args.alpha)

    log.info("distilling %d steps (tau=%.2f alpha=%.2f, teacher %d-layer -> "
             "student %d-layer LLM)", total, args.tau, args.alpha,
             tcfg.model.llm.n_layers, cfg.model.llm.n_layers)
    t0 = time.time()
    done = 0
    m: dict[str, float] = {}
    while done < total:
        for _, batch in loader:
            m = step_fn(state, teacher, batch, cfg.training.seed + done)
            done += 1
            if done % max(1, cfg.training.log_interval) == 0 or done == total:
                log.info("step %d/%d loss %.4f kl %.4f ce %.4f teacher-agree %.3f",
                         done, total, m["loss"], m["kl"], m["ce"], m["agree"])
            if done >= total:
                break
    loader.close()
    if not math.isfinite(m["loss"]):
        log.error("non-finite final loss")
        return 1

    out = Path(args.out)
    export_params(state.params, out)
    save_config(cfg, out / "config.yaml")
    report = {"steps": done, "tau": args.tau, "alpha": args.alpha,
              "loss": m["loss"], "kl": m["kl"], "ce": m["ce"],
              "teacher_agree": m["agree"],
              "teacher_llm_layers": tcfg.model.llm.n_layers,
              "student_llm_layers": cfg.model.llm.n_layers,
              "wall_s": round(time.time() - t0, 1)}
    (out / "distill_report.json").write_text(json.dumps(report, indent=1))
    log.info("draft export -> %s (+ config.yaml, distill_report.json); %.1fs; "
             "final teacher-agree %.3f", out, report["wall_s"], report["teacher_agree"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
