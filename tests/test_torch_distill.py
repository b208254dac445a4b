"""The port's draft distillation vs the JAX package (f32, CPU).

The teacher is ``tests/test_torch_beam.py``'s model (modality both, a
2-layer LLM, an untied head); the student has one LLM layer, a trainable
LLM and no LoRA, and starts from the teacher's first block (warm start).
Weights come from the JAX init through ``convert.from_numpy_tree``; the
batch is numpy from a seed. Tolerances: loss, kl, ce and agree 1e-5
relative or 1e-6 absolute (the KL of a warm-started student is small, a
sum of differences of near-equal log-probabilities); parameters after
two steps 1e-5 (atol and rtol); copied leaves and counts exact; the CLI
chain's hypotheses exact.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.cli import distill as jdistill
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.models import avsr as javsr
from avsr_tpu.train import state as jstate
from avsr_tpu_torch.cli import decode as tdecode
from avsr_tpu_torch.cli import distill as tdistill
from avsr_tpu_torch.cli.common import init_params
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train.checkpoint import export_params

from test_torch_beam import OVERRIDES, TINY_YAML, configs
from test_torch_generate import _fields_equal
from test_torch_models import np_tree, randomize_lora_b
from test_torch_train import jax_paths, port_paths

torch.set_num_threads(1)

STUDENT = {"model.llm.n_layers": 1, "model.freeze_llm": False,
           "model.lora.use_lora": False}


def np_batch(S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        mel=rng.standard_normal((2, 80, 100)).astype(np.float32),
        mel_lens=np.array([100, 62], np.int32),
        frames=rng.standard_normal((2, 4, 3, S, S)).astype(np.float32),
        frame_lens=np.array([4, 3], np.int32),
        prompt_tokens=np.tile(np.array([256, 72, 105], np.int32), (2, 1)),
        labels=rng.integers(0, 258, (2, 6)).astype(np.int32),
        label_lens=np.array([6, 3], np.int32),
    )


@pytest.fixture(scope="module")
def trees():
    """Teacher and student of both packages, from one JAX init each."""
    jt, tt = configs(**{"runtime.use_pallas": "never"})
    js, ts = configs(**STUDENT, **{"runtime.use_pallas": "never"})
    teacher = np_tree(javsr.init_avsr_model(jax.random.key(0), jt.model))
    randomize_lora_b(teacher, seed=2)
    student = np_tree(javsr.init_avsr_model(jax.random.key(1), js.model))
    return dict(jt=jt, tt=tt, js=js, ts=ts, teacher=teacher, student=student)


def test_warm_start_copies_prefix_layers():
    """The JAX test's toy tree: layer 0 and the embedding copied, the
    student's own leaves kept, no teacher-only subtree."""
    teacher = {"llm": {"layers": [{"w": np.ones((2, 2)) * i} for i in range(4)],
                       "embed": np.ones((3, 2))},
               "extra": {"only_teacher": np.ones((1,))}}
    student = {"llm": {"layers": [{"w": np.zeros((2, 2))}], "embed": np.zeros((3, 2)),
                       "student_only": np.zeros((5,))}}
    out_j, n_j = jdistill.warm_start(jax.tree_util.tree_map(jnp.asarray, student),
                                     jax.tree_util.tree_map(jnp.asarray, teacher))
    t_teacher = from_numpy_tree(teacher, "cpu")
    out_t, n_t = tdistill.warm_start(from_numpy_tree(student, "cpu"), t_teacher)
    assert n_t == n_j == 2 and set(out_t) == set(out_j) == {"llm"}
    for path, leaf in port_paths(out_t).items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jax_paths(out_j)[path]))
    assert out_t["llm"]["embed"].data_ptr() != t_teacher["llm"]["embed"].data_ptr()


def test_warm_start_matches_jax_on_the_models(trees):
    out_j, n_j = jdistill.warm_start(
        jax.tree_util.tree_map(jnp.asarray, trees["student"]),
        jax.tree_util.tree_map(jnp.asarray, trees["teacher"]))
    out_t, n_t = tdistill.warm_start(from_numpy_tree(trees["student"], "cpu"),
                                     from_numpy_tree(trees["teacher"], "cpu"))
    assert n_t == n_j > 10
    want = jax_paths(out_j)
    got = port_paths(out_t)
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[path]))
    # the student's one block is the teacher's first
    np.testing.assert_array_equal(out_t["llm"]["layers"][0]["q"]["w"].numpy(),
                                  trees["teacher"]["llm"]["layers"][0]["q"]["w"])


def test_distill_step_matches_jax(trees):
    jt, tt, js, ts = trees["jt"], trees["tt"], trees["js"], trees["ts"]
    batch = np_batch(js.model.clip.image_size)
    student, _ = jdistill.warm_start(
        jax.tree_util.tree_map(jnp.asarray, trees["student"]),
        jax.tree_util.tree_map(jnp.asarray, trees["teacher"]))
    student_np = np_tree(student)
    state_j, tx = jstate.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, student_np), js, 10)
    step_j = jdistill.make_distill_step(js, jt, tx, tau=2.0, alpha=0.3)
    p_t = from_numpy_tree(student_np, "cpu")
    before = {k: v.clone() for k, v in port_paths(p_t).items()}
    state_t = tstate.create_train_state(p_t, ts, 10)
    step_t = tdistill.make_distill_step(ts, tt, tau=2.0, alpha=0.3)
    teacher_j = jax.tree_util.tree_map(jnp.asarray, trees["teacher"])
    teacher_t = from_numpy_tree(trees["teacher"], "cpu")
    # two steps: the warm-up schedule's first learning rate is 0
    for i in range(2):
        state_j, m_j = step_j(state_j, teacher_j,
                              javsr.Batch(**{k: jnp.asarray(v) for k, v in batch.items()}),
                              jax.random.key(i))
        m_t = step_t(state_t, teacher_t,
                     tavsr.Batch(**{k: torch.from_numpy(v) for k, v in batch.items()}), i)
        for key in ("loss", "kl", "ce", "agree"):
            np.testing.assert_allclose(m_t[key], float(m_j[key]), rtol=1e-5, atol=1e-6)
        assert 0.0 < m_t["kl"] and 0.0 <= m_t["agree"] <= 1.0
    assert state_t.step == int(state_j.step) == 2
    mask = port_paths(tstate.trainable_mask(p_t, ts.model))
    after_j = jax_paths(state_j.params)
    moved = 0
    for path, leaf in port_paths(state_t.params).items():
        if mask[path]:
            np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(after_j[path]),
                                       atol=1e-5, rtol=1e-5)
            moved += not torch.equal(leaf, before[path])
        else:
            assert torch.equal(leaf, before[path]), path
    assert moved > 10        # the student's LLM trains


def test_forward_return_logits_leaves_the_loss_unchanged(trees):
    ts = trees["ts"]
    p = from_numpy_tree(trees["student"], "cpu")
    b = tavsr.Batch(**{k: torch.from_numpy(v)
                       for k, v in np_batch(ts.model.clip.image_size).items()})
    loss, m = tavsr.forward(p, ts.model, b)
    loss2, m2 = tavsr.forward(p, ts.model, b, return_logits=True)
    assert torch.equal(loss, loss2) and "label_logits" not in m
    assert m2["label_logits"].shape == (2, 6, ts.model.llm.vocab_size)
    assert m2["label_mask"].tolist() == [[1.0] * 6, [1.0] * 3 + [0.0] * 3]


def _hyps(out_dir) -> list[str]:
    res = next(out_dir.glob("results_*.txt")).read_text()
    return sorted(line for line in res.splitlines() if line.startswith("HYP"))


def test_distill_cli_then_speculative_decode_equals_greedy(tmp_path):
    """A random teacher exported, two distill steps of a 1-layer student,
    then the decode CLI greedy and speculative with the export as the
    trained draft: the same hypotheses."""
    over = [f"{k}={v}" for k, v in OVERRIDES.items()] + ["data.synthetic=true"]
    teacher_cfg = tcfg.load_config(TINY_YAML, over)
    export_params(init_params(teacher_cfg, seed=1, device="cpu"), tmp_path / "teacher")
    tcfg.save_config(teacher_cfg, tmp_path / "teacher.yaml")
    draft = tmp_path / "draft"
    student = over + [f"{k}={v}" for k, v in STUDENT.items()] + ["training.max_steps=2"]
    rc = tdistill.main(["--config", str(TINY_YAML), "--device", "cpu", "--seed", "1",
                        "--teacher-config", str(tmp_path / "teacher.yaml"),
                        "--teacher-checkpoint", str(tmp_path / "teacher"),
                        "--out", str(draft), "--tau", "1.5", *student])
    assert rc == 0
    report = json.loads((draft / "distill_report.json").read_text())
    assert report["steps"] == 2 and report["student_llm_layers"] == 1
    assert np.isfinite(report["loss"])
    assert tcfg.load_config(draft / "config.yaml") == tcfg.load_config(TINY_YAML, student)

    common = ["--config", str(TINY_YAML), "--device", "cpu", "--seed", "1", *over,
              "decode.max_new_tokens=8"]
    assert tdecode.main([*common, f"decode.output_dir={tmp_path / 'g'}"]) == 0
    assert tdecode.main([*common, f"decode.output_dir={tmp_path / 's'}",
                         "decode.speculative=true",
                         f"decode.spec_draft_checkpoint={draft}",
                         f"decode.spec_draft_config={draft / 'config.yaml'}"]) == 0
    assert _hyps(tmp_path / "g") == _hyps(tmp_path / "s")


def test_distill_cli_refuses_a_frozen_student(tmp_path):
    over = [f"{k}={v}" for k, v in OVERRIDES.items()]
    tcfg.save_config(tcfg.load_config(TINY_YAML, over), tmp_path / "t.yaml")
    with pytest.raises(SystemExit, match="freeze_llm"):
        tdistill.main(["--config", str(TINY_YAML), "--device", "cpu",
                       "--teacher-config", str(tmp_path / "t.yaml"),
                       "--teacher-checkpoint", str(tmp_path), "--out", str(tmp_path / "o"),
                       *over])


def test_save_config_is_read_by_both_packages(tmp_path):
    """JSON text, so the port reads it without PyYAML and the JAX package
    with it, to the same values."""
    over = ["decode.speculative=true", "decode.spec_gamma=3", "model.llm.n_layers=4",
            "data.audio_buckets=50,150", "model.freeze_llm=false",
            "training.learning_rate=3e-4"]
    cfg = tcfg.load_config(TINY_YAML, over)
    path = tmp_path / "config.yaml"
    tcfg.save_config(cfg, path)
    json.loads(path.read_text())
    assert tcfg.load_config(path) == cfg
    _fields_equal(cfg, jload_config(path))
    assert dataclasses.asdict(cfg)["data"]["audio_buckets"] == (50, 150)
