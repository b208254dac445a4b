"""The port's train slice vs the JAX package (f32, CPU).

Weights come from the JAX init (LoRA ``b`` randomised, since it is zero
at init and would leave the gradients of ``a`` exactly zero) and reach the
port through ``convert.from_numpy_tree``; inputs are numpy from a seed.
The LLM is 2 layers of d_model 128 with 2 heads of 64 and a packed width
of 288, so the port's attention takes the autograd Function
(``use_kernel="always"``; its plain versions on CPU) while the JAX side
takes its plain reference (``use_pallas="never"``). Dropout is off in
every comparison with JAX (its bits cannot be matched); it has its own
tests. Tolerances: loss 1e-5 relative; each trainable leaf's gradient
||g_port - g_jax|| <= 1e-4 ||g_jax||; parameters after optimizer updates
1e-5 (atol and rtol); schedules 1e-6 relative (optax computes in f32).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.core.registry import SCHEDULES as JSCHEDULES
from avsr_tpu.data.dataset import SyntheticAVSRDataset as JDataset
from avsr_tpu.data.loader import DataLoader as JDataLoader
from avsr_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from avsr_tpu.models import avsr as javsr
from avsr_tpu.train import state as jstate
from avsr_tpu.train import step as jstep
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.data.dataset import SyntheticAVSRDataset
from avsr_tpu_torch.data.loader import DataLoader
from avsr_tpu_torch.data.tokenizer import ByteTokenizer
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.models import llama as tllama
from avsr_tpu_torch.ops import attention as tattn
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.loop import Trainer

from test_torch_models import np_tree, randomize_lora_b

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY_YAML = REPO / "avsr_tpu" / "configs" / "tiny_cpu.yaml"

# tiny_cpu.yaml widened so that the packed width (5 + 250 + 24 -> 288)
# takes the port's kernel path: d_model 128, 2 heads of 64, GQA 2:1
WIDE = {"model.modality": "both", "model.llm.d_model": 128,
        "model.llm.n_heads": 2, "model.llm.n_kv_heads": 1,
        "model.llm.n_layers": 2, "model.llm.ffn_dim": 256,
        "model.llm.max_seq_len": 512, "model.whisper.max_frames": 500,
        "model.lora.dropout": 0.0, "training.warmup_steps": 2}


def configs(**extra):
    """(JAX config, port config) of the same overrides; the JAX side runs
    its plain attention, the port its kernel path (plain versions on CPU)."""
    over = {**WIDE, **extra}
    jc = jload_config(TINY_YAML, {**over, "runtime.use_pallas": "never"})
    tc = tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in over.items()]
                          + ["runtime.use_pallas=always"])
    return jc, tc


def np_batch(seed=0, B=2, label_lens=(24, 17)):
    rng = np.random.default_rng(seed)
    return dict(
        mel=rng.standard_normal((B, 80, 500)).astype(np.float32),
        mel_lens=np.array([500, 380][:B], np.int32),
        frames=rng.standard_normal((B, 4, 3, 16, 16)).astype(np.float32),
        frame_lens=np.array([4, 3][:B], np.int32),
        prompt_tokens=np.tile(np.array([256, 72, 105, 33, 9], np.int32), (B, 1)),
        labels=rng.integers(0, 258, (B, 24)).astype(np.int32),
        label_lens=np.array(label_lens[:B], np.int32),
    )


def jbatch(b):
    return javsr.Batch(**{k: jnp.asarray(v) for k, v in b.items()})


def tbatch(b):
    return tavsr.Batch(**{k: torch.from_numpy(v) for k, v in b.items()})


@pytest.fixture(scope="module")
def weights():
    jc, _ = configs()
    p = np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model))
    return randomize_lora_b(p, seed=3)


def jax_paths(tree):
    """{path: leaf} of a JAX pytree (None positions are empty)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path)] = leaf
    return out


def port_paths(tree):
    out = {}
    tstate.tree_map_with_path(
        lambda p, x: out.__setitem__(p, x) if x is not None else None, tree)
    return out


def rel_dist(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", ["always", "never"])
def test_forward_loss_and_grads_match_jax(weights, use_kernel):
    jc, tc = configs()
    b = np_batch()
    p_j = jax.tree_util.tree_map(jnp.asarray, weights)
    train_j, frozen_j = jstate.partition_trainable(p_j, jc.model)

    def jloss(tp):
        return javsr.forward(jstate.combine_trainable(tp, frozen_j), jc.model,
                             jbatch(b), use_pallas="never")

    (loss_j, m_j), g_j = jax.value_and_grad(jloss, has_aux=True)(train_j)

    p_t = from_numpy_tree(weights, "cpu")
    train_t, _ = tstate.partition_trainable(p_t, tc.model)
    leaves = port_paths(train_t)
    for t in leaves.values():
        t.requires_grad_(True)
    before = tattn.launches
    loss_t, m_t = tavsr.forward(p_t, tc.model, tbatch(b), use_kernel=use_kernel)
    grads = torch.autograd.grad(loss_t, list(leaves.values()))
    assert tattn.launches == before            # CPU: plain versions only

    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for key in ("accuracy", "label_tokens", "feat_len_mean"):
        np.testing.assert_allclose(float(m_t[key]), float(m_j[key]), rtol=1e-6)
    g_j = jax_paths(g_j)
    assert set(g_j) == set(leaves)
    for path, g in zip(leaves, grads):
        assert float(np.abs(g_j[path]).max()) > 0, path   # every leaf is live
        assert rel_dist(g.numpy(), g_j[path]) <= 1e-4, path


def test_forward_packs_to_a_multiple_of_16(weights, monkeypatch):
    _, tc = configs()
    seen = []
    orig = tllama.llama_apply

    def spy(*a, **kw):
        seen.append(kw["inputs_embeds"].shape[1])
        return orig(*a, **kw)

    monkeypatch.setattr(tllama, "llama_apply", spy)
    with torch.no_grad():
        tavsr.forward(from_numpy_tree(weights, "cpu"), tc.model, tbatch(np_batch()))
    assert seen == [288]        # 5 + 250 + 24 = 279, padded to 288


# ---------------------------------------------------------------------------
# masks, casts, counts
# ---------------------------------------------------------------------------

def test_masks_match_jax(weights):
    jc, tc = configs()
    p_j = jax.tree_util.tree_map(jnp.asarray, weights)
    p_t = from_numpy_tree(weights, "cpu")
    for jfn, tfn in ((lambda p: jstate.trainable_mask(p, jc.model),
                      lambda p: tstate.trainable_mask(p, tc.model)),
                     (jstate.decay_mask, tstate.decay_mask)):
        jm, tm = jax_paths(jfn(p_j)), port_paths(tfn(p_t))
        assert jm == tm
        assert any(jm.values()) and not all(jm.values())


def test_cast_frozen_counts_and_summary_match_jax(weights):
    jc, tc = configs()
    p_j = jstate.cast_frozen(jax.tree_util.tree_map(jnp.asarray, weights),
                             jc.model)
    p_t = tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model)
    dt_j = {k: str(v.dtype) for k, v in jax_paths(p_j).items()}
    dt_t = {k: str(v.dtype).replace("torch.", "") for k, v in port_paths(p_t).items()}
    assert dt_j == dt_t
    assert set(dt_t.values()) == {"float32", "bfloat16"}
    assert tstate.count_trainable(p_t, tc.model) == jstate.count_trainable(p_j, jc.model)
    s_j, s_t = javsr.summarize(p_j, jc.model), tavsr.summarize(p_t, tc.model)
    assert s_t == {k: s_j[k] for k in s_t}


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cosine", "linear", "constant"])
def test_schedules_match_optax(name):
    jc, tc = configs(**{"training.schedule": name, "training.warmup_steps": 5,
                        "training.learning_rate": 3e-4})
    js = JSCHEDULES.get(name)(jc.training, 40)
    ts = tstate.SCHEDULES[name](tc.training, 40)
    for step in range(46):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("clipped", [True, False])
def test_updates_match_optax_chain(clipped):
    """Three updates of clip_by_global_norm + AdamW (decay on ``w`` only,
    warmup then cosine) equal optax's, with the clip active or not."""
    jc, tc = configs(**{"training.max_grad_norm": 0.5 if clipped else 1e3,
                        "training.weight_decay": 0.1})
    rng = np.random.default_rng(4)
    params = {"lin": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                      "b": rng.standard_normal(5).astype(np.float32)},
              "ln": [{"scale": rng.standard_normal(5).astype(np.float32)}]}
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        for _ in range(3)]
    tx = jstate.create_optimizer(jc, params, 10)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p_j)
    p_t = from_numpy_tree(params, "cpu")
    opt = tstate.create_optimizer(tc, p_t, 10)
    for g in grads:
        norm = float(optax.global_norm(g))
        assert (norm > tc.training.max_grad_norm) == clipped
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   opt_state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        g_paths = port_paths(from_numpy_tree(g, "cpu"))
        g_t = [g_paths[path] for path in port_paths(p_t)]   # the leaves' order
        opt.update(g_t, tstep.global_norm(g_t))
        for path, leaf in port_paths(p_t).items():
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jax_paths(p_j)[path]),
                                       atol=1e-5, rtol=1e-5)
    assert opt.count == 3
    assert not np.array_equal(port_paths(p_t)[("lin", "w")].numpy(),
                              params["lin"]["w"])


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def test_train_steps_match_jax_with_nonfinite_skip(weights):
    """good, non-finite, good: the port's steps equal the JAX steps. The
    skipped step advances ``step`` but not the schedule or Adam's count (a
    count that moved would give the third step another learning rate)."""
    jc, tc = configs()
    good, bad = np_batch(1), np_batch(1)
    bad["mel"][:] = np.nan
    state_j, tx = jstate.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, weights), jc, 10)
    step_j = jstep.make_train_step(jc, tx)
    p_t = tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model,
                             torch.float32)
    state_t = tstate.create_train_state(p_t, tc, 10)
    step_t = tstep.make_train_step(tc)
    before = {k: v.clone() for k, v in port_paths(p_t).items()}
    for i, b in enumerate((good, bad, good)):
        state_j, m_j = step_j(state_j, jstep.microbatch(jbatch(b), 1),
                              jax.random.key(i))
        m_t = step_t(state_t, tstep.microbatch(tbatch(b), 1), i)
        assert m_t["skipped"] == float(m_j["skipped"]) == float(i == 1)
        assert state_t.step == int(state_j.step) == i + 1
        if i != 1:
            np.testing.assert_allclose(m_t["loss"], float(m_j["loss"]), rtol=1e-5)
            np.testing.assert_allclose(m_t["grad_norm"], float(m_j["grad_norm"]),
                                       rtol=1e-4)
    assert state_t.optimizer.count == 2
    trainable = tstate.trainable_mask(p_t, tc.model)
    mask = port_paths(trainable)
    after_j = jax_paths(state_j.params)
    for path, leaf in port_paths(state_t.params).items():
        if mask[path]:
            np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(after_j[path]),
                                       atol=1e-5, rtol=1e-5)
        else:
            assert torch.equal(leaf, before[path]), path
    lora_b = ("llm", "layers", "0", "q", "lora", "b")
    assert not torch.equal(port_paths(state_t.params)[lora_b], before[lora_b])


def test_weighted_accumulation_equals_full_batch(weights):
    """accum 2 over two halves of equal label counts == accum 1 over the
    whole batch (same loss, same gradient norm, same parameters after two
    updates)."""
    _, tc = configs()
    b = tbatch(np_batch(2, label_lens=(20, 20)))
    results = []
    for accum in (1, 2):
        p = tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model,
                               torch.float32)
        state = tstate.create_train_state(p, tc, 10)
        step = tstep.make_train_step(tc)
        ms = [step(state, tstep.microbatch(b, accum), 0) for _ in range(2)]
        results.append((ms, port_paths(state.params)))
    (m1, p1), (m2, p2) = results
    for a, c in zip(m1, m2):
        np.testing.assert_allclose(a["loss"], c["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], c["grad_norm"], rtol=1e-4)
    for path in p1:
        torch.testing.assert_close(p1[path], p2[path], atol=1e-6, rtol=1e-5)


def test_remat_equals_no_remat_with_dropout(weights):
    """With dropout on, recomputing each block in backward redraws the same
    masks: gradients with remat equal those without, and differ from the
    dropout-free ones (so dropout is live)."""
    _, tc = configs(**{"model.lora.dropout": 0.3})
    b = tbatch(np_batch(3))
    out = {}
    for remat, seed in ((False, 7), (True, 7), (False, None)):
        p = from_numpy_tree(weights, "cpu")
        leaves = port_paths(tstate.partition_trainable(p, tc.model)[0])
        for t in leaves.values():
            t.requires_grad_(True)
        loss, _ = tavsr.forward(p, tc.model, b, use_kernel="always",
                                remat=remat, dropout_seed=seed)
        out[(remat, seed)] = (loss.item(),
                              torch.autograd.grad(loss, list(leaves.values())))
    (l0, g0), (l1, g1), (l2, g2) = out.values()
    assert l0 == l1 and l0 != l2
    for a, c in zip(g0, g1):
        torch.testing.assert_close(a, c, atol=0, rtol=0)
    assert any(not torch.allclose(a, c) for a, c in zip(g0, g2))


def test_lora_dropout_statistics():
    """The mask covers the LoRA branch only: kept inputs scaled by 1/(1-p),
    a keep fraction of 1 - p, and the base product untouched."""
    p, n, d = 0.3, 400, 50
    x = torch.ones((n, d)) * 2.0
    w = torch.eye(d) * 3.0
    node = {"w": w, "lora": {"a": torch.eye(d), "b": torch.eye(d)}}
    gen = torch.Generator().manual_seed(0)
    y = tllama.proj(node, x, lora_scale=1.0, lora_dropout=p, generator=gen)
    branch = y - x @ w                      # = dropout(x)
    kept = branch != 0
    frac = kept.float().mean().item()
    sigma = (p * (1 - p) / (n * d)) ** 0.5
    assert abs(frac - (1 - p)) < 4 * sigma
    torch.testing.assert_close(branch[kept], torch.full_like(branch[kept], 2.0 / (1 - p)))
    plain = tllama.proj(node, x, lora_scale=1.0, lora_dropout=p)   # no generator
    torch.testing.assert_close(plain, x @ w + x)


def test_microbatch_splits_rows():
    b = tbatch(np_batch(B=2))
    mb = tstep.microbatch(b._replace(prompt_tokens=b.prompt_tokens[0]), 2)
    assert mb.mel.shape == (2, 1, 80, 500) and mb.prompt_tokens.shape == (2, 1, 5)
    assert torch.equal(mb.labels[1, 0], b.labels[1])
    with pytest.raises(ValueError):
        tstep.microbatch(b, 3)


# ---------------------------------------------------------------------------
# data, trainer, CLI
# ---------------------------------------------------------------------------

def test_dataloader_order_matches_jax():
    jc = jload_config(TINY_YAML, {"data.synthetic_size": 7})
    tc = tcfg.load_config(TINY_YAML, ["data.synthetic_size=7"])
    jl = JDataLoader(JDataset(jc.data, JByteTokenizer(), modality="audio",
                              image_size=16), jc.data, JByteTokenizer(),
                     model_cfg=jc.model, seed=5)
    tl = DataLoader(SyntheticAVSRDataset(tc.data, ByteTokenizer(),
                                         modality="audio", image_size=16),
                    tc.data, ByteTokenizer(), model_cfg=tc.model, seed=5,
                    device="cpu")
    assert len(tl) == len(jl) == 4
    for _ in range(2):                      # two epochs, two shuffles
        got = [(hb.utt_ids, hb.label_lens.tolist(), tuple(b.mel.shape))
               for hb, b in tl]
        want = [(hb.utt_ids, np.asarray(hb.label_lens).tolist(),
                 tuple(b.mel.shape)) for hb, b in jl]
        assert got == want
        assert got[-1][1][1] == 0           # the wrap-padded row


def test_trainer_three_steps_loss_falls(tmp_path):
    """tiny_cpu.yaml on one repeated batch: three steps, the loss falls
    (the first update has learning rate 0: warmup starts at 0)."""
    cfg = tcfg.load_config(TINY_YAML, ["data.synthetic_size=2",
                                       f"training.checkpoint_dir={tmp_path}"])
    tok = ByteTokenizer()
    ds = SyntheticAVSRDataset(cfg.data, tok, modality="audio", image_size=16)
    loader = DataLoader(ds, cfg.data, tok, model_cfg=cfg.model, device="cpu")
    params = tstate.cast_frozen(
        tavsr.init_avsr_model(cfg.model, seed=0, device="cpu"), cfg.model)
    tr = Trainer(cfg, params, loader)
    out = tr.train()
    assert out["steps"] == 3 and len(tr.history["train"]) == 3
    assert tr.history["train"][-1] < tr.history["train"][0] - 1e-3
    rows = (tmp_path / "loss_log.csv").read_text().splitlines()
    assert rows[0].startswith("step,epoch,split,loss") and len(rows) == 4


def test_train_cli_writes_loss_log(tmp_path):
    rc = tcli_train.main(["--config", str(TINY_YAML), "--device", "cpu",
                          "--seed", "1", "model.modality=both",
                          "training.max_steps=2",
                          f"training.checkpoint_dir={tmp_path}"])
    assert rc == 0
    rows = (tmp_path / "loss_log.csv").read_text().splitlines()
    splits = [r.split(",")[2] for r in rows[1:]]
    assert splits == ["train", "train", "val"]


@pytest.mark.parametrize("override", [
    "mesh.dp=2", "mesh.fsdp=2", "mesh.tp=2", "mesh.sp=2", "mesh.pp=2",
    "training.optimizer=lion", "data.specaugment=true",
    "data.video_augment=true", "model.unfreeze_layer_norms=true",
    "training.auto_batch_size=true"])
def test_unported_config_knobs_raise(override):
    with pytest.raises(NotImplementedError):
        tcfg.load_config(TINY_YAML, [override])


@pytest.mark.parametrize("override", ["model.use_4bit=true", "model.use_8bit=true"])
def test_trainer_refuses_unported_features(tmp_path, override):
    """QLoRA training (a quantized base under the train step) is not yet
    ported."""
    with pytest.raises(NotImplementedError):
        tcli_train.main(["--config", str(TINY_YAML), "--device", "cpu",
                         override, f"training.checkpoint_dir={tmp_path}"])


def test_chip_smoke_overrides_give_the_flagship():
    """chip_smoke.py builds the flagship through CLI overrides (no PyYAML
    on the card's host); they must give exactly flagship()."""
    import chip_smoke

    assert tcfg.load_config(None, list(chip_smoke.FLAGSHIP_OVERRIDES)) == tcfg.flagship()


def test_one_card_mesh_and_donate_are_accepted():
    cfg = tcfg.load_config(TINY_YAML, ["mesh.dp=1", "mesh.donate=true"])
    assert cfg.mesh.donate and cfg.mesh.dp == 1
