"""The port's tooling CLIs (``cli/validate.py``, ``cli/analyze_memory.py``,
``cli/profile.py``) against the JAX package's, on ``tiny_cpu.yaml`` with
``--device cpu``, and the ``training.best_metric`` checks of the config.

validate: with the JAX params carried across, each batch's loss equals
JAX's ``make_eval_step`` loss in f32 (relative 1e-5); a NaN-poisoned
checkpoint fails the gate (rc 1), or raises under ``--checkify``.
analyze_memory: the analytic report equals the JAX CLI's exactly.
profile: the JAX tests' contract on a CPU trace (host ops stand in for
the device's), the JAX report's key set, and the Trainer's trace read by
the same parser.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from avsr_tpu.cli import analyze_memory as jmem
from avsr_tpu.cli import common as jcommon
from avsr_tpu.cli import profile as jprofile
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.models.avsr import init_avsr_model as jinit
from avsr_tpu.train.step import make_eval_step as jmake_eval_step
from avsr_tpu_torch.cli import analyze_memory as tmem
from avsr_tpu_torch.cli import profile as tprofile
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.cli import validate as tvalidate
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.models.avsr import init_avsr_model as tinit
from avsr_tpu_torch.train.checkpoint import export_params
from avsr_tpu_torch.train.state import path_leaves, tree_leaves

torch.set_num_threads(1)

TINY_PATH = "avsr_tpu/configs/tiny_cpu.yaml"
TINY = ["--config", TINY_PATH]
CPU = ["--device", "cpu"]


@pytest.mark.parametrize("over", [
    ["training.best_metric=wer", "training.eval_wer_every_epochs=0"],
    ["training.best_metric=WER"]], ids=["wer_without_wer_eval", "bad_name"])
def test_best_metric_checks_equal_jax(over):
    """The port's ``validate`` raises the JAX package's two best_metric
    errors, message for message (``avsr_tpu/core/config.py:673-681``)."""
    msgs = []
    for load in (jload_config, tcfg.load_config):
        with pytest.raises(ValueError, match="best_metric") as e:
            load(None, over)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert ("eval_wer_every_epochs" in msgs[0]) == ("wer" in over[0])
    # the valid settings still load
    tcfg.load_config(None, ["training.best_metric=wer", "training.eval_wer_every_epochs=1"])


# ---------------------------------------------------------------------------
# validate
# ---------------------------------------------------------------------------

@pytest.fixture
def records():
    """The port's log records (every CLI's ``setup_logging`` replaces the
    root logger's handlers, so pytest's ``caplog`` sees none)."""
    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.records = []

        def emit(self, record):
            self.records.append(record)

        def args(self, prefix: str) -> list[tuple]:
            return [r.args for r in self.records if str(r.msg).startswith(prefix)]

    keep = Keep()
    logger = logging.getLogger("avsr_tpu_torch")
    logger.addHandler(keep)
    try:
        yield keep
    finally:
        logger.removeHandler(keep)


def test_validate_losses_equal_jax_eval_step(tmp_path, records):
    """The JAX init, exported for the port: the validate CLI's per-batch
    losses equal JAX's ``make_eval_step`` on the JAX loader's batches."""
    jc = jload_config(TINY_PATH, {})
    params = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(0), jc.model))
    export_params(from_numpy_tree(params, "cpu"), tmp_path / "export")
    _, _, loader = jcommon.build_data(jc, "train", shuffle=False)
    eval_step = jmake_eval_step(jc)
    want = [float(eval_step(params, batch)["loss"]) for _, (_, batch) in zip(range(2), loader)]

    rc = tvalidate.main(CPU + TINY + ["--checkpoint", str(tmp_path / "export")])
    assert rc == 0
    got = [a[1] for a in records.args("batch ")]
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("checkify", [False, True])
def test_validate_cli_passes(checkify, capsys):
    """rc 0 on healthy numerics, with and without ``--checkify``
    (``tests/test_config.py::test_validate_cli_checkify``)."""
    rc = tvalidate.main(CPU + TINY + ["--num_batches", "1"]
                        + (["--checkify"] if checkify else []))
    assert rc == 0
    assert "validation PASSED" in capsys.readouterr().out


@pytest.mark.parametrize("checkify", [False, True])
def test_validate_gate_fires_on_nan_checkpoint(tmp_path, checkify, capsys):
    """One LoRA leaf set to NaN: the gate fails (rc 1), and ``--checkify``
    raises at the first NaN loss, naming the eval step."""
    cfg = tcfg.load_config(TINY_PATH, {})
    params = tinit(cfg.model, seed=0, device="cpu")
    lora = [v for k, v in path_leaves(params).items() if "lora" in k]
    assert lora
    lora[0].fill_(float("nan"))
    export_params(params, tmp_path / "poisoned")
    argv = CPU + TINY + ["--checkpoint", str(tmp_path / "poisoned")]
    if checkify:
        with pytest.raises(FloatingPointError, match="NaN loss in the eval step"):
            tvalidate.main(argv + ["--checkify"])
    else:
        assert tvalidate.main(argv) == 1
        assert "validation FAILED: avg loss nan" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# analyze_memory
# ---------------------------------------------------------------------------

def test_analyze_memory_report_equals_jax(tmp_path):
    """``tests/test_cli_analyze_memory.py``'s report test, and the analytic
    part (and the CPU's measured bytes) equal to the JAX CLI's report."""
    argv = TINY + ["model.modality=both"]
    assert jmem.main(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    assert tmem.main(CPU + argv + ["--output_dir", str(tmp_path / "port")]) == 0
    want = json.loads((tmp_path / "jax" / "memory_stats.json").read_text())
    report = json.loads((tmp_path / "port" / "memory_stats.json").read_text())
    for key in ("modality", "connector", "modes", "params_total", "params_trainable",
                "activation_estimate_gib", "measured_fp32"):
        assert report[key] == want[key], key
    assert set(report) == set(want)             # no device_memory on the CPU
    assert set(report["modes"]) == {"fp32", "bf16", "int8_llm", "int4_llm"}
    comps = report["modes"]["fp32"]
    assert {"whisper", "clip", "llm"} <= set(comps)
    assert report["modes"]["int8_llm"]["llm"] < comps["llm"]
    assert report["params_trainable"] < report["params_total"]
    assert "llm_remat" in report["activation_estimate_gib"]
    pytest.importorskip("matplotlib")
    assert (tmp_path / "port" / "memory_analysis.png").exists()


def test_measured_component_bytes():
    """Each component measured alone: at least its logical bytes; no
    allocator column off the card."""
    cfg = tcfg.load_config(TINY_PATH, {})
    measured = tmem.measured_component_bytes(cfg, torch.device("cpu"))
    shapes = tmem.shape_tree(cfg)
    assert set(measured) == set(shapes)
    for name, row in measured.items():
        logical = sum(x.numel() * x.element_size() for x in tree_leaves(shapes[name]))
        assert row["on_device"] >= logical > 0
        assert "allocator_delta" not in row


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------

def test_profile_train_writes_report(tmp_path, records):
    rc = tprofile.main(CPU + TINY + ["--mode", "train", "--steps", "2",
                                     "--output_dir", str(tmp_path)])
    assert rc == 0
    report = json.loads((tmp_path / "profile_report.json").read_text())
    assert report["mode"] == "train"
    assert report["steps"] == 2
    assert report["wall_s"] > 0
    # the trace parsed: its host threads carried timed op events
    assert report["planes"] and report["planes"][0].startswith("thread")
    assert report["device_busy_ms"] > 0
    assert report["top_ops"], "no events aggregated from the trace"
    row = report["top_ops"][0]
    assert set(row) == {"name", "ms", "pct"} and row["ms"] > 0
    assert 0 < report["device_duty_cycle"] <= 1
    # the micro-batch bodies hold the forward and backward, the optimizer
    # update lies outside them
    assert report["loop_ms"] > report["prefix_ms"] > 0
    assert report["loop_ms"] + report["prefix_ms"] == pytest.approx(
        report["device_busy_ms"], abs=2e-3)
    cats = {r["name"] for r in report["by_category"]}
    assert {"gemm", "elementwise"} <= cats
    assert any("Backward" in r["name"] for r in report["by_scope"])
    # the raw trace is kept next to the report; on the CPU no kernel ran
    assert (tmp_path / "trace_train.json").exists()
    assert report["trace"] == str(tmp_path / "trace_train.json")
    assert tprofile.kernel_counts(tprofile.trace_events(tmp_path / "trace_train.json")) == (
        report["kernels_in_trace"]) == dict.fromkeys(tprofile.PORT_KERNELS, 0)
    launched = records.args("kernel launches")
    assert launched == [dict.fromkeys(tprofile.PORT_KERNELS, 0)]


def test_trace_steps_readers_leave_out_the_guard_call(tmp_path):
    """``trace_steps`` opens its window with one more call under the guard
    range, which the written trace keeps and ``trace_events`` leaves out:
    the readers see the traced steps' ops only."""
    x = torch.ones(8, 8)
    trace = tmp_path / "trace.json"
    _, launched = tprofile.trace_steps(lambda: torch.mm(x, x), 3,
                                       [torch.profiler.ProfilerActivity.CPU], trace)
    assert launched == dict.fromkeys(tprofile.PORT_KERNELS, 0)
    raw = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    seen = tprofile.trace_events(trace)
    assert [sum(e["name"] == "aten::mm" for e in ev) for ev in (raw, seen)] == [4, 3]
    assert any(e["name"] == tprofile.GUARD for e in raw)
    assert not any(e["name"] == tprofile.GUARD for e in seen)


def test_trace_events_cut_the_card_by_correlation(tmp_path):
    """The card's events go with the host call that launched them, by
    correlation id, whatever their converted times: a kernel of a guard
    launch that ends after the guard range is left out, and a kernel of a
    traced launch that starts before the range ends is kept."""
    def x(name, cat, ts, dur, corr=None):
        return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur,
                    args={} if corr is None else dict(correlation=corr))

    events = [x(tprofile.GUARD, "user_annotation", 0, 10),
              x(tprofile.GUARD, "gpu_user_annotation", 1, 30),
              x("cudaLaunchKernel", "cuda_runtime", 5, 1, 1),
              x("flash_fwd_bf16_kernel", "kernel", 20, 2, 1),
              x("aten::mm", "cpu_op", 12, 4),
              x("cudaLaunchKernel", "cuda_runtime", 14, 1, 2),
              x("flash_fwd_bf16_kernel", "kernel", 9, 2, 2),
              dict(ph="f", name="ac2g", cat="ac2g", id=2, ts=9)]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps(dict(traceEvents=events)))
    seen = tprofile.trace_events(trace)
    assert [(e["name"], e["ts"]) for e in seen] == [
        ("aten::mm", 12), ("cudaLaunchKernel", 14), ("flash_fwd_bf16_kernel", 9)]
    assert tprofile.kernel_counts(seen)["flash_fwd"] == 1
    trace.write_text(json.dumps(dict(traceEvents=events[2:])))      # no guard: read whole
    assert len(tprofile.trace_events(trace)) == 5


def test_profile_decode_mode_keys_equal_jax(tmp_path):
    """``test_profile_decode_mode``, and the report's keys (and each table
    row's) equal the JAX CLI's on the same config."""
    argv = TINY + ["--mode", "decode", "--steps", "1", "decode.max_new_tokens=4"]
    assert tprofile.main(CPU + argv + ["--output_dir", str(tmp_path / "port")]) == 0
    assert jprofile.main(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    report = json.loads((tmp_path / "port" / "profile_report.json").read_text())
    want = json.loads((tmp_path / "jax" / "profile_report.json").read_text())
    assert report["mode"] == "decode"
    assert report["device_busy_ms"] > 0
    assert report["loop_ms"] > 0 and report["prefix_ms"] > 0     # 3 token steps
    assert set(report) == set(want) | {"kernels_in_trace"}     # the port's addition
    for key in ("by_category", "by_scope", "top_ops"):   # JAX's CPU trace has no scopes
        assert report[key] and all(set(r) == {"name", "ms", "pct"} for r in report[key] + want[key])


def test_analyze_trace_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        tprofile.analyze_trace(tmp_path)


def test_trainer_trace_reads_back(tmp_path):
    """The Trainer's ``runtime.profile_dir`` trace (steps 4-7) goes through
    the same parser."""
    run, pdir = tmp_path / "run", tmp_path / "trace"
    rc = tcli_train.main(CPU + TINY + ["training.max_steps=8", "data.synthetic_size=16",
                                       f"training.checkpoint_dir={run}",
                                       f"runtime.profile_dir={pdir}"])
    assert rc == 0
    report = tprofile.analyze_trace(pdir, top=5)
    assert report["trace"].endswith("trace_step7.json")
    assert report["device_busy_ms"] > 0 and report["loop_ms"] > 0
    assert len(report["top_ops"]) == 5
