"""A JAX run's Orbax checkpoints continued and served by the port (f32, CPU).

The JAX package's train CLI (on the tests' 8-device virtual CPU mesh) takes
2 steps of ``tiny_cpu.yaml`` (the LLM widened to 128, and Whisper too for
adafactor, so that it factors the connector's kernel; LoRA dropout 0) and
saves Orbax checkpoints; ``tools.orbax_to_port`` converts them. For AdamW, Lion, Adafactor, a QLoRA
int4 run and an fsdp-sharded run:

  * every converted leaf equals JAX's restored array exactly (parameters,
    and optax's moments under the port's names);
  * ``meta_*.json`` and ``best.json`` are copied as they are;
  * the port's greedy decode from the converted directory, and from a
    converted ``export_params`` of the same step, gives JAX's hypotheses;
  * the port's train CLI resumes the converted run and JAX's resumes its
    own: step 3's loss agrees to 1e-5 relative and every trained leaf to
    JAX's atol 2e-5, at the same data position and early-stop state.

A config or optimizer that does not match the checkpoint is refused with
the leaf's path, and the port's readers refuse an Orbax directory with a
message that names the tool, writing nothing into it.
"""

import csv
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from avsr_tpu.cli import common as jcommon
from avsr_tpu.cli import decode as jcli_decode
from avsr_tpu.cli import train as jcli_train
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.core.config import save_config as jsave_config
from avsr_tpu.train import checkpoint as jcheckpoint
from avsr_tpu.train import state as jstate
from avsr_tpu_torch.cli import common as tcommon
from avsr_tpu_torch.cli import decode as tcli_decode
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.train import import_state as imp
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train.checkpoint import CheckpointManager, load_params
from avsr_tpu_torch.train.loop import Trainer
from tools import orbax_to_port

from test_torch_checkpoint_cli import hyp_lines
from test_torch_train import REPO, TINY_YAML, jax_paths, port_paths

torch.set_num_threads(1)

CASES = {
    "adamw": {},
    "lion": {"training.optimizer": "lion"},
    "adafactor": {"training.optimizer": "adafactor", "model.whisper.d_model": 128},
    "qlora_int4": {"model.use_4bit": "true"},
    "fsdp": {"mesh.fsdp": 8, "mesh.dp": 1},
}


def overrides(run_dir, dec_dir, **extra):
    over = {
        "data.synthetic_size": 8, "data.batch_size": 8, "data.audio_buckets": "[100]",
        "model.lora.dropout": 0.0, "model.llm.d_model": 128, "model.llm.n_heads": 2,
        "model.llm.n_kv_heads": 1, "model.llm.ffn_dim": 256,
        "training.max_steps": 2, "training.save_every_steps": 1,
        "training.log_interval": 100, "training.checkpoint_dir": str(run_dir),
        "decode.max_new_tokens": 6, "decode.batch_size": 8,
        "decode.output_dir": str(dec_dir)}
    over.update(extra)
    return ["--config", str(TINY_YAML), *[f"{k}={v}" for k, v in over.items()]]


def cfg_of(argv):
    return [a for a in argv if "=" in a]


def loss_at(run_dir, step):
    with open(run_dir / "loss_log.csv") as fh:
        return [float(r["loss"]) for r in csv.DictReader(fh)
                if r["split"] == "train" and int(r["step"]) == step]


def rule_state(opt_state):
    """The optax node of the update rule (Adam, Lion or Adafactor's)."""
    if isinstance(opt_state, tuple) and hasattr(opt_state, "_fields"):
        if type(opt_state).__name__ in imp.RULE_STATES.values():
            return opt_state
        opt_state = tuple(opt_state)
    if isinstance(opt_state, (list, tuple)):
        found = [s for s in map(rule_state, opt_state) if s is not None]
        return found[0] if found else None
    return None


def jax_state(jc, ck, step):
    """JAX's own restore of ``step``: the JAX package's CheckpointManager
    into the state its Trainer builds for the config."""
    st, _ = jstate.create_train_state(jcommon.init_or_load_params(jc), jc, 1)
    return jcheckpoint.CheckpointManager(ck).restore(st, step)


def assert_equal_leaf(got, want, name):
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16, name
        got, want = got.float().numpy(), want.astype(np.float32)
    else:
        got = got.numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_jax_run_converted_resumed_and_served_by_the_port(tmp_path, case):
    jover = overrides(tmp_path / "jrun", tmp_path / "jdec", **CASES[case])
    tover = overrides(tmp_path / "trun", tmp_path / "tdec", **CASES[case])
    jc = jload_config(TINY_YAML, cfg_of(jover))
    assert jcli_train.main(jover) == 0
    jck, tck = tmp_path / "jrun" / "ckpt", tmp_path / "trun" / "ckpt"
    if case == "fsdp":                        # written sharded over 8 devices
        meta = json.loads((jck / "2" / "state" / "_sharding").read_text())
        assert any("fsdp" in str(v) for v in meta.values())
    assert orbax_to_port.main([str(jck), str(tck), "--all"]) == 0

    # every converted leaf equals JAX's restored array
    for step in (1, 2):
        js = jax_state(jc, jck, step)
        got = port_paths(load_params(tck / str(step)))
        want = jax_paths(js.params)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert_equal_leaf(got[k], v, str(k))
        train = torch.load(tck / str(step) / "train.pt", weights_only=True)
        assert train["step"] == step == int(js.step)
        opt = train["opt_state"]
        rule = rule_state(js.opt_state)
        assert opt["count"] == int(rule.count) == step
        fields = {"ScaleByAdamState": {"exp_avg": "mu", "exp_avg_sq": "nu"},
                  "ScaleByLionState": {"mu": "mu"},
                  "FactoredState": {"v": "v", "v_row": "v_row", "v_col": "v_col"}}
        fmap = fields[type(rule).__name__]
        moments = {port: {"/".join(k): v for k, v in jax_paths(getattr(rule, f)).items()}
                   for port, f in fmap.items()}
        n_factored = 0
        for name, st in opt["leaves"].items():
            for key, t in st.items():
                if key == "step":
                    assert t.item() == float(step)
                else:
                    assert_equal_leaf(t, moments[key][name], f"{name}/{key}")
            n_factored += "v_row" in st
        assert set(opt["leaves"]) == set(moments[next(iter(fmap))])
        if case == "adafactor":
            assert 0 < n_factored < len(opt["leaves"])
    for name in ("meta_1.json", "meta_2.json", "best.json"):
        assert (tck / name).read_bytes() == (jck / name).read_bytes(), name

    # greedy decode from the converted run and from a converted export
    assert jcli_decode.main(["--checkpoint", str(jck), "--split", "train", *jover]) == 0
    assert tcli_decode.main(["--device", "cpu", *tover, "--checkpoint", str(tck),
                             "--split", "train"]) == 0
    want_hyps = hyp_lines(tmp_path / "jdec")
    assert len(want_hyps) == 8 and hyp_lines(tmp_path / "tdec") == want_hyps
    jcheckpoint.export_params(jcommon.init_or_load_params(jc, str(jck)),
                              tmp_path / "jexport")
    jsave_config(jc, tmp_path / "config.yaml")
    assert orbax_to_port.main([str(tmp_path / "jexport"), str(tmp_path / "texport"),
                               "--config", str(tmp_path / "config.yaml")]) == 0
    over_exp = overrides(tmp_path / "trun", tmp_path / "tdec_export", **CASES[case])
    assert tcli_decode.main(["--device", "cpu", *over_exp, "--checkpoint",
                             str(tmp_path / "texport"), "--split", "train"]) == 0
    assert hyp_lines(tmp_path / "tdec_export") == want_hyps

    # both packages resume for step 3
    step3 = {"training.max_steps": 3, **CASES[case]}
    assert jcli_train.main(overrides(tmp_path / "jrun", tmp_path / "jdec", **step3)) == 0
    assert tcli_train.main(["--device", "cpu", *overrides(
        tmp_path / "trun", tmp_path / "tdec", **step3)]) == 0
    (lj,), (lt,) = loss_at(tmp_path / "jrun", 3), loss_at(tmp_path / "trun", 3)
    assert loss_at(tmp_path / "trun", 2) == []          # the port ran step 3 only
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    mj, mt = (json.loads((d / "meta_3.json").read_text()) for d in (jck, tck))
    assert mt["data_state"] == mj["data_state"]
    assert mt["fit_state"]["evals_no_improve"] == mj["fit_state"]["evals_no_improve"]
    np.testing.assert_allclose(mt["fit_state"]["best_val"], mj["fit_state"]["best_val"],
                               rtol=1e-5)
    tc = tcfg.load_config(TINY_YAML, cfg_of(tover))
    got = port_paths(load_params(tck / "3"))
    want = jax_paths(jax_state(jc, jck, 3).params)
    mask = port_paths(tstate.trainable_mask(load_params(tck / "3"), tc.model))
    trained = [k for k, m in mask.items() if m]
    assert trained
    for k in trained:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-5,
                                   rtol=0, err_msg=str(k))
        assert not torch.equal(got[k], port_paths(load_params(tck / "2"))[k]), k


def legacy_int4(tree):
    """A JAX QLoRA tree in the int4 layout before the half-split packing:
    every ``qw4h`` leaf as a row-interleaved ``qw4`` one."""
    from avsr_tpu.ops.quant import _unpack_int4

    if isinstance(tree, dict):
        if "qw4h" in tree:
            q = np.asarray(_unpack_int4(tree["qw4h"]))
            packed = ((q[0::2] & 0x0F) | ((q[1::2] & 0x0F) << 4)).astype(np.int8)
            return {"qw4": packed, **{k: v for k, v in tree.items() if k != "qw4h"}}
        return {k: legacy_int4(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [legacy_int4(v) for v in tree]
    return tree


def test_old_layout_int4_run_and_export_convert_as_jax_reads_them(tmp_path):
    """A QLoRA int4 run and export written in JAX's old interleaved ``qw4``
    layout convert to the same port files as the same step in the current
    layout: the converter repacks them as JAX's ``init_or_load_params``
    does."""
    import jax

    over = overrides(tmp_path / "jrun", tmp_path / "jdec", **{
        "model.use_4bit": "true", "training.max_steps": 1})
    jc = jload_config(TINY_YAML, cfg_of(over))
    assert jcli_train.main(over) == 0
    jck = tmp_path / "jrun" / "ckpt"
    js = jax_state(jc, jck, 1)
    old = legacy_int4(js.params)
    assert "qw4" in str(jax_paths(old)) and "qw4h" not in str(jax_paths(old))
    # optax's state over the old tree: JAX's, its frozen places renamed
    old_like, _ = jstate.create_train_state(
        jax.tree_util.tree_map(jax.numpy.asarray, old), jc, 1)
    old_opt = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(old_like.opt_state),
                                           jax.tree_util.tree_leaves(js.opt_state))
    mngr = jcheckpoint.CheckpointManager(tmp_path / "old")
    mngr.save(js._replace(params=old, opt_state=old_opt))
    mngr.close()
    for name in ("meta_1.json", "best.json"):
        (tmp_path / "old" / name).write_bytes((jck / name).read_bytes())
    jcheckpoint.export_params(old, tmp_path / "old_export")
    jcheckpoint.export_params(js.params, tmp_path / "export")
    jsave_config(jc, tmp_path / "config.yaml")
    for src in ("jrun/ckpt", "old", "export", "old_export"):
        extra = ["--config", str(tmp_path / "config.yaml")] if "export" in src else []
        assert orbax_to_port.main([str(tmp_path / src), str(tmp_path / "t" / src),
                                   *extra]) == 0
    for new, old_dir in (("jrun/ckpt/1", "old/1"), ("export", "old_export")):
        want = port_paths(load_params(tmp_path / "t" / new))
        got = port_paths(load_params(tmp_path / "t" / old_dir))
        assert any("qw4h" in k for k in want) and got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    opt_new, opt_old = (torch.load(tmp_path / "t" / d / "1" / "train.pt", weights_only=True)
                        for d in ("jrun/ckpt", "old"))
    assert opt_old["step"] == opt_new["step"] == 1
    assert opt_old["opt_state"]["leaves"].keys() == opt_new["opt_state"]["leaves"].keys()
    for name, st in opt_new["opt_state"]["leaves"].items():
        for key, v in st.items():
            assert torch.equal(opt_old["opt_state"]["leaves"][name][key], v), (name, key)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A 2-step AdamW run of the JAX train CLI and its conversion."""
    root = tmp_path_factory.mktemp("orbax")
    jover = overrides(root / "jrun", root / "jdec")
    assert jcli_train.main(jover) == 0
    return root, root / "jrun" / "ckpt"


def numpy_state(jc, jck, step=2):
    js = jax_state(jc, jck, step)
    return {"step": int(js.step), "params": orbax_to_port.to_numpy(js.params),
            "opt_state": orbax_to_port.to_numpy(js.opt_state)}


@pytest.mark.parametrize("over,match", [
    ({"training.optimizer": "lion"}, "ScaleByAdamState.*lion"),
    ({"model.lora.r": 4}, "lora"),
    ({"model.llm.ffn_dim": 128}, "llm/layers/0/"),
    ({"runtime.compute_dtype": "bfloat16"}, "is torch.float32, the config's is torch.bfloat16"),
    ({"model.use_4bit": "true"}, "key paths differ"),
])
def test_mismatched_config_or_optimizer_is_refused_with_the_leaf(jax_run, over, match):
    root, jck = jax_run
    jover = overrides(root / "jrun", root / "jdec")
    state = numpy_state(jload_config(TINY_YAML, cfg_of(jover)), jck)
    other = tcfg.load_config(TINY_YAML, cfg_of(overrides(root / "x", root / "y", **over)))
    with pytest.raises(ValueError, match=match):
        imp.import_state(state, other)


def test_opt_state_checks(jax_run):
    """The counts must agree with each other and with the step; a moment of
    another shape is refused with its leaf's path."""
    root, jck = jax_run
    jover = overrides(root / "jrun", root / "jdec")
    tc = tcfg.load_config(TINY_YAML, cfg_of(jover))
    state = numpy_state(jload_config(TINY_YAML, cfg_of(jover)), jck)
    sd = imp.import_state(state, tc)
    assert sd["step"] == 2 and sd["opt_state"]["count"] == 2
    rule = state["opt_state"][1][0]
    assert rule["_type"] == "ScaleByAdamState"

    def with_rule(**fields):
        chain = state["opt_state"]
        return dict(state, opt_state=[chain[0], [dict(rule, **fields), *chain[1][1:]]])

    for fields, match in (({"count": np.int32(1)}, "differs from the schedule"),
                          ({"mu": {}}, "missing")):
        with pytest.raises(ValueError, match=match):
            imp.import_state(with_rule(**fields), tc)
    with pytest.raises(ValueError, match="within the run's 1 steps"):
        imp.import_state(dict(state, step=1), tc)
    name = next(iter(sd["opt_state"]["leaves"]))
    mu = tstate.tree_map_with_path(
        lambda p, x: np.zeros((3, 3), np.float32) if "/".join(p) == name else x, rule["mu"])
    with pytest.raises(ValueError, match=f"{name} has shape \\(3, 3\\)"):
        imp.import_state(with_rule(mu=mu), tc)


def _snapshot(path):
    return {str(p.relative_to(path)): p.stat().st_mtime_ns for p in path.rglob("*")}


def test_port_readers_refuse_an_orbax_directory(jax_run, tmp_path):
    """The port's readers given a JAX run's directory (or its step, or an
    export) raise a ValueError that names the converter, where they once
    failed on a missing ``params.pt`` (and ``maybe_resume`` returned False,
    so the run trained from its init and saved into it); nothing is written
    there. The decode CLI exits non-zero with the message."""
    root, jck = jax_run
    jover = overrides(root / "jrun", root / "jdec")
    tc = tcfg.load_config(TINY_YAML, cfg_of(jover))
    before = _snapshot(root / "jrun")
    like = tcommon.init_params(tc, seed=0, device="cpu")
    for fn in (lambda: tcommon._restore(str(jck), like),
               lambda: tcommon._restore(str(jck / "2"), like),
               lambda: tcommon.load_adapter(str(jck)),
               lambda: CheckpointManager(jck).restore(tstate.create_train_state(
                   tstate.cast_frozen(like, tc.model, torch.float32), tc, 3))):
        with pytest.raises(ValueError, match="tools/orbax_to_port.py"):
            fn()
    from test_torch_checkpoint import port_loader
    cfg = tcfg.load_config(TINY_YAML, cfg_of(overrides(root / "jrun", root / "x")))
    with pytest.raises(ValueError, match="tools/orbax_to_port.py"):
        Trainer(cfg, tcommon.init_params(cfg, seed=0, device="cpu"), port_loader(cfg))
    resume = tcfg.load_config(TINY_YAML, cfg_of(overrides(
        tmp_path / "fresh", root / "x", **{"training.resume_from": str(jck)})))
    tr = Trainer(resume, tcommon.init_params(resume, seed=0, device="cpu"),
                 port_loader(resume))
    with pytest.raises(ValueError, match="tools/orbax_to_port.py"):
        tr.maybe_resume()
    out = subprocess.run(
        [sys.executable, "-m", "avsr_tpu_torch.cli.decode", "--device", "cpu",
         *jover[:2], *cfg_of(jover), "--checkpoint", str(jck)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "tools/orbax_to_port.py" in out.stderr
    assert _snapshot(root / "jrun") == before
    assert not any(tmp_path.glob("fresh/ckpt/*"))


def test_chip_smoke_numpy_layout_imports_bit_equal(tmp_path):
    """``chip_smoke.py``'s inverse (a port step in the converter's numpy
    layout, for the card's host) imports back to the step bit for bit, with
    bf16 leaves as ml_dtypes arrays as JAX's restore gives them; the
    imported run then resumes."""
    import chip_smoke

    over = overrides(tmp_path / "run", tmp_path / "dec",
                     **{"runtime.compute_dtype": "bfloat16", "training.max_steps": 2})
    assert tcli_train.main(["--device", "cpu", *over]) == 0
    tc = tcfg.load_config(TINY_YAML, cfg_of(over))
    src = tmp_path / "run" / "ckpt" / "2"
    state = chip_smoke.jax_numpy_state(src, tc)
    kinds = {type(x).__name__ for x in tstate.tree_leaves(state["params"])}
    assert kinds == {"ndarray"}
    sd = imp.import_state(state, tc)
    got, want = port_paths(sd["params"]), port_paths(load_params(src))
    assert any(v.dtype == torch.bfloat16 for v in want.values())
    assert got.keys() == want.keys() and all(torch.equal(got[k], v) for k, v in want.items())
    train = torch.load(src / "train.pt", weights_only=True)["opt_state"]
    assert sd["opt_state"]["count"] == train["count"] == 2
    for name, st in train["leaves"].items():
        for key, v in st.items():
            assert torch.equal(sd["opt_state"]["leaves"][name][key], v), (name, key)
    imp.write_step(tmp_path / "imp" / "ckpt", sd)
    imp.copy_meta(src.parent, tmp_path / "imp" / "ckpt")
    over3 = overrides(tmp_path / "imp", tmp_path / "dec", **{
        "runtime.compute_dtype": "bfloat16", "training.max_steps": 3})
    assert tcli_train.main(["--device", "cpu", *over3]) == 0
    assert loss_at(tmp_path / "imp", 3) and not loss_at(tmp_path / "imp", 2)
