"""The port's checkpoints, resume, in-training WER and early stop vs the
JAX package (f32, CPU).

The widened tiny config of ``test_torch_train.py`` (dropout off), the same
JAX-initialised weights on both sides, and each package's own synthetic
dataset and loader (the same samples and shuffle). Tolerances: losses
1e-5 relative and trainable leaves 1e-5 (atol and rtol) against the JAX
Trainer, as in ``test_train_steps_match_jax_with_nonfinite_skip``; the
port against itself (interrupted and resumed against uninterrupted, a
round trip through a checkpoint) bit for bit.
"""

import importlib
import json
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.data.dataset import SyntheticAVSRDataset as JDataset
from avsr_tpu.data.loader import DataLoader as JDataLoader
from avsr_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from avsr_tpu.train import state as jstate
from avsr_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from avsr_tpu.train.loop import Trainer as JTrainer
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.data.dataset import SyntheticAVSRDataset
from avsr_tpu_torch.data.loader import DataLoader
from avsr_tpu_torch.data.tokenizer import ByteTokenizer
from avsr_tpu_torch.models.avsr import init_avsr_model
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import CheckpointManager, load_params
from avsr_tpu_torch.train.loop import Trainer

from test_torch_train import (TINY_YAML, configs, jax_paths, np_batch,
                              port_paths, tbatch, weights)  # noqa: F401

torch.set_num_threads(1)


def port_loader(cfg, split="train", shuffle=True):
    tok = ByteTokenizer()
    ds = SyntheticAVSRDataset(cfg.data, tok, split=split,
                              modality=cfg.model.modality,
                              image_size=cfg.model.image_size)
    return DataLoader(ds, cfg.data, tok, model_cfg=cfg.model, shuffle=shuffle,
                      seed=cfg.training.seed, device="cpu")


def jax_loader(cfg, split="train", shuffle=True):
    tok = JByteTokenizer()
    ds = JDataset(cfg.data, tok, split=split, modality=cfg.model.modality,
                  image_size=cfg.model.clip.image_size)
    return JDataLoader(ds, cfg.data, tok, model_cfg=cfg.model, shuffle=shuffle,
                       seed=cfg.training.seed)


def port_trainer(cfg, weights, val=False):
    params = tstate.cast_frozen(from_numpy_tree(weights, "cpu"), cfg.model,
                                torch.float32)
    return Trainer(cfg, params, port_loader(cfg),
                   port_loader(cfg, "valid", False) if val else None,
                   tok=ByteTokenizer())


def jax_trainer(cfg, weights, val=False):
    params = jax.tree_util.tree_map(jnp.asarray, weights)
    return JTrainer(cfg, params, jax_loader(cfg),
                    jax_loader(cfg, "valid", False) if val else None,
                    tok=JByteTokenizer())


def run_cfgs(path, **extra):
    return configs(**{"training.checkpoint_dir": str(path), **extra})


def tavsr_init(cfg):
    return init_avsr_model(cfg.model, seed=0, device="cpu")


def trainable_leaves(params, cfg):
    mask = port_paths(tstate.trainable_mask(params, cfg.model))
    return {k: v.detach() for k, v in port_paths(params).items() if mask[k]}


# ---------------------------------------------------------------------------
# the checkpoint format
# ---------------------------------------------------------------------------

def test_round_trip_is_bit_equal_and_restores_live_tensors(weights, tmp_path):
    """Save after two steps, restore into a fresh state: params, moments,
    count and step are bit-equal and land in the tensors the optimizer
    holds; the next step from the restored state equals the next step from
    the original and moves the live leaves. Retention keeps the newest
    ``keep`` steps."""
    _, tc = configs()
    batch = tstep.microbatch(tbatch(np_batch(1)), 1)
    step_fn = tstep.make_train_step(tc)

    def fresh():
        return tstate.create_train_state(
            tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model,
                               torch.float32), tc, 10)

    st = fresh()
    mngr = CheckpointManager(tmp_path, tc, keep=2)
    for i in range(2):
        step_fn(st, batch, i)
    mngr.save(st, metrics={"loss": 1.0})
    mngr.wait()

    st2 = fresh()
    live = port_paths(st2.params)
    assert CheckpointManager(tmp_path).restore(st2) is st2
    assert st2.step == 2 and st2.optimizer.count == 2
    for k, v in port_paths(st2.params).items():
        assert v is live[k] and torch.equal(v, port_paths(st.params)[k]), k
    moments, moments2 = (s_.optimizer.state_dict()["leaves"] for s_ in (st, st2))
    assert moments.keys() == moments2.keys()
    for k, v in moments.items():
        for n, t in v.items():
            assert torch.equal(t, moments2[k][n]), (k, n)
    before = {k: v.clone() for k, v in trainable_leaves(st2.params, tc).items()}
    assert step_fn(st, batch, 5)["loss"] == step_fn(st2, batch, 5)["loss"]
    after = trainable_leaves(st2.params, tc)
    assert all(not torch.equal(before[k], after[k]) for k in after)
    for k, v in port_paths(st2.params).items():
        assert torch.equal(v, port_paths(st.params)[k]), k

    for _ in range(2):                     # steps 4 and 5
        step_fn(st, batch, 6)
        mngr.save(st)
    mngr.close()
    assert mngr.all_steps() == [4, 5]
    assert sorted(p.name for p in tmp_path.glob("meta_*.json")) == [
        "meta_2.json", "meta_4.json", "meta_5.json"]
    with pytest.raises(FileNotFoundError):
        mngr.restore(fresh(), step=2)      # retention removed it


def test_restore_checks_every_path_shape_and_dtype(weights, tmp_path):
    """A checkpoint of another tree raises before it writes anything."""
    _, tc = configs()
    st = tstate.create_train_state(
        tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model,
                           torch.float32), tc, 10)
    mngr = CheckpointManager(tmp_path)
    mngr.save(st)
    mngr.wait()
    for over in ({"model.modality": "audio"}, {"model.lora.r": 4}):
        _, other = configs(**over)
        p = tstate.cast_frozen(tavsr_init(other), other.model, torch.float32)
        st_o = tstate.create_train_state(p, other, 10)
        before = {k: v.clone() for k, v in port_paths(st_o.params).items()}
        with pytest.raises(ValueError):
            CheckpointManager(tmp_path).restore(st_o)
        assert all(torch.equal(v, before[k]) for k, v in port_paths(st_o.params).items())
    # the same tree in another dtype
    p16 = tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model,
                             torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        CheckpointManager(tmp_path).restore(tstate.create_train_state(p16, tc, 10))


def test_same_step_save_writes_only_json_and_meta_keys_match_jax(weights, tmp_path):
    """A save at a step not newer than the newest writes no tensors (the
    Orbax rule the JAX manager follows); the meta has the JAX manager's
    keys."""
    jc, tc = configs()
    st = tstate.create_train_state(
        tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model,
                           torch.float32), tc, 10)
    st.step = 2
    mngr = CheckpointManager(tmp_path / "port", tc)
    kw = dict(metrics={"loss": 1.5}, data_state={"epoch": 1, "batches": 2},
              fit_state={"best_val": 1.0, "best_wer": 2.0, "evals_no_improve": 0})
    mngr.save(st, **kw)
    mngr.wait()
    f = tmp_path / "port" / "2" / "params.pt"
    stat = f.stat()
    with torch.no_grad():
        for t in port_paths(st.params).values():
            t.add_(1.0)
    mngr.save(st, is_best=True, tag="final", **kw)
    st.step = 1
    mngr.save(st, tag="older")
    mngr.wait()
    assert mngr.all_steps() == [2]
    assert f.stat().st_mtime_ns == stat.st_mtime_ns and f.stat().st_ino == stat.st_ino
    assert not (tmp_path / "port" / "1").exists()
    meta = mngr.read_meta(2)
    assert meta["tag"] == "final" and meta["is_best"]
    assert json.loads((tmp_path / "port" / "best.json").read_text()) == meta
    assert mngr.read_meta(1)["tag"] == "older"
    loaded = load_params(tmp_path / "port" / "2")
    assert torch.equal(port_paths(loaded)[("llm", "embed")],
                       torch.tensor(weights["llm"]["embed"]))

    jst, _ = jstate.create_train_state(jax.tree_util.tree_map(jnp.asarray, weights),
                                       jc, 10)
    jst = jst._replace(step=jnp.asarray(2, jst.step.dtype))
    jm = JCheckpointManager(tmp_path / "jax", jc)
    jm.save(jst, is_best=True, tag="final", **kw)
    jm.close()
    jmeta = jm.read_meta(2)
    assert set(jmeta) == set(meta)
    for key in ("metrics", "data_state", "fit_state"):
        assert jmeta[key] == meta[key]
    assert set(meta["config"]) == set(jmeta["config"])


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def test_interrupted_run_equals_uninterrupted_and_matches_jax(weights, tmp_path):
    """Two steps, stop, resume to four: bit-equal to four uninterrupted
    steps, and per step equal to the JAX Trainer doing the same."""
    losses, leaves = {}, {}
    for name, runs in (("interrupted", (2, 4)), ("straight", (4,))):
        hist = []
        for max_steps in runs:
            _, tc = run_cfgs(tmp_path / name, **{"training.max_steps": max_steps})
            tr = port_trainer(tc, weights)
            assert tr.maybe_resume() == (max_steps == 4 and name == "interrupted")
            out = tr.train()
            assert out["steps"] == max_steps
            hist += tr.history["train"]
        losses[name], leaves[name] = hist, trainable_leaves(tr.state.params, tc)
    assert losses["interrupted"] == losses["straight"]
    assert len(losses["straight"]) == 4
    for k, v in leaves["straight"].items():
        assert torch.equal(v, leaves["interrupted"][k]), k
    meta = json.loads((tmp_path / "interrupted" / "ckpt" / "meta_2.json").read_text())
    assert meta["data_state"] == {"epoch": 1, "batches": 2} and meta["tag"] == "final"

    jhist = []
    for max_steps in (2, 4):
        jc, _ = run_cfgs(tmp_path / "jax", **{"training.max_steps": max_steps})
        jt = jax_trainer(jc, weights)
        jt.maybe_resume()
        jt.train()
        jhist += jt.history["train"]
    np.testing.assert_allclose(losses["interrupted"], jhist, rtol=1e-5)
    jl = jax_paths(jt.state.params)
    for k, v in leaves["interrupted"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jl[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=str(k))


@pytest.mark.parametrize("epoch,batches", [(1, 0), (1, 3), (2, 1), (3, 4)])
def test_set_position_replays_the_jax_loaders_batches(epoch, batches):
    jc = configs(**{"data.synthetic_size": 9})[0]
    tc = configs(**{"data.synthetic_size": 9})[1]
    tl, jl = port_loader(tc), jax_loader(jc)
    tl.set_position(epoch, batches)
    jl.set_position(epoch, batches)
    got = [hb.utt_ids for hb, _ in tl]
    want = [list(hb.utt_ids) for hb, _ in jl]
    assert got == want and len(got) == 5 - min(batches, 5)
    assert tl.state() == jl.state() == {"epoch": epoch, "batches": 5}


class SpyLoader(DataLoader):
    """Records the utterance ids of every batch handed out."""
    seen: list

    def __iter__(self):
        for hb, b in super().__iter__():
            self.seen.append(hb.utt_ids)
            yield hb, b


@pytest.mark.parametrize("case", ["one_shape", "pending_group"])
def test_midepoch_resume_with_accumulation(weights, tmp_path, case):
    """accum 2, stop after one step, resume. One shape: the resumed run
    sees exactly the rest of the epoch, no sample twice. Two shapes (a
    batch of another bucket still pending when the step fires): the
    position rewinds past the pending batch, which the resumed run
    replays, so no sample is lost."""
    size, bs, seed = (8, 2, 3) if case == "one_shape" else (12, 1, 0)
    over = {"model.modality": "audio", "data.synthetic_size": size,
            "data.batch_size": bs, "training.grad_accum_steps": 2,
            "training.seed": seed}
    seen = []
    for max_steps in (1, 2):
        _, tc = run_cfgs(tmp_path, **{**over, "training.max_steps": max_steps})
        ds = SyntheticAVSRDataset(tc.data, ByteTokenizer(), modality="audio",
                                  image_size=16)
        loader = SpyLoader(ds, tc.data, ByteTokenizer(), model_cfg=tc.model,
                           seed=seed, device="cpu")
        loader.seen = []
        params = tstate.cast_frozen(tavsr_init(tc), tc.model, torch.float32)
        tr = Trainer(tc, params, loader)
        tr.maybe_resume()
        tr.train()
        seen.append(loader.seen)
    order = [hb.utt_ids for hb, _ in port_loader(tc)]      # epoch 1's order
    meta = json.loads((tmp_path / "ckpt" / "meta_1.json").read_text())
    if case == "one_shape":
        assert meta["data_state"] == {"epoch": 1, "batches": 2}
        assert seen == [order[:2], order[2:4]]
        flat = [u for run in seen for b in run for u in b]
        assert sorted(flat) == [f"synthetic/{i:05d}" for i in range(8)]
    else:
        # batches 1 and 3 (bucket 200) step; batch 2 (bucket 100) is pending
        assert meta["data_state"] == {"epoch": 1, "batches": 2}
        assert seen[0] == order[:3]
        assert seen[1][0] == order[2]


def test_preemption_checkpoint_resume_and_handler(weights, tmp_path):
    """The preempted flag (what SIGTERM sets) saves a ``preempt``
    checkpoint at the next step boundary and stops; a fresh Trainer
    resumes from it and finishes. The SIGTERM handler is the Trainer's
    only while ``train`` runs on the main thread."""
    before = signal.getsignal(signal.SIGTERM)
    _, tc = run_cfgs(tmp_path, **{"training.max_steps": 4,
                                  "training.save_every_steps": 0})
    tr = port_trainer(tc, weights)
    orig = tr._step
    during = []

    def step_then_preempt(mbs, epoch):
        m = orig(mbs, epoch)
        during.append(signal.getsignal(signal.SIGTERM))
        if tr.state.step == 1:
            tr._preempted = True       # acted on at the end of step 2
        return m

    tr._step = step_then_preempt
    out = tr.train()
    assert out["steps"] == 2
    assert tr.ckpt.all_steps() == [2] and tr.ckpt.read_meta(2)["tag"] == "preempt"
    assert signal.getsignal(signal.SIGTERM) is before
    if threading.current_thread() is threading.main_thread():
        assert during[0] is not before
    tr2 = port_trainer(tc, weights)
    assert tr2.maybe_resume() and tr2.state.step == 2
    assert tr2.train()["steps"] == 4
    assert signal.getsignal(signal.SIGTERM) is before


def test_emergency_checkpoints(weights, tmp_path):
    """Three non-finite losses in a row write an ``emergency`` checkpoint;
    an exception inside ``train`` writes one and is raised again."""
    _, tc = run_cfgs(tmp_path / "nan", **{"training.max_steps": 4,
                                          "training.save_every_steps": 0})
    tr = port_trainer(tc, weights)
    orig = tr.train_step
    tr.train_step = lambda st, b, seed: orig(st, b._replace(mel=b.mel * np.nan), seed)
    saves = []
    real_save = tr.ckpt.save
    tr.ckpt.save = lambda state, **kw: (saves.append((state.step, kw.get("tag"))),
                                        real_save(state, **kw))
    tr.train()
    assert saves == [(3, "emergency"), (4, "emergency"), (4, "final")]
    assert tr.ckpt.all_steps() == [3, 4]
    assert tr.ckpt.read_meta(3)["tag"] == "emergency"
    assert tr.ckpt.read_meta(4)["tag"] == "final"   # the same step: JSON only
    assert tr.state.optimizer.count == 0
    logged = (tmp_path / "nan" / "loss_log.csv").read_text().splitlines()
    assert [r.split(",")[-1] for r in logged[1:]] == ["1.0"] * 4

    _, tc = run_cfgs(tmp_path / "raise", **{"training.max_steps": 4,
                                            "training.save_every_steps": 0})
    tr = port_trainer(tc, weights)
    orig_step = tr.train_step

    def fail_second(st, b, seed):
        if st.step == 1:
            raise RuntimeError("boom")
        return orig_step(st, b, seed)

    tr.train_step = fail_second
    with pytest.raises(RuntimeError, match="boom"):
        tr.train()
    assert tr.ckpt.all_steps() == [1]
    assert tr.ckpt.read_meta(1)["tag"] == "emergency"
    assert tr.ckpt.read_meta(1)["data_state"] == {"epoch": 1, "batches": 2}


# ---------------------------------------------------------------------------
# in-training WER, best metric, early stop
# ---------------------------------------------------------------------------

def test_eval_wer_matches_jax(weights, tmp_path, monkeypatch):
    """The port's ``val_wer`` and its hypotheses equal the JAX Trainer's
    on the same weights and data."""
    pairs = {"jax": [], "port": []}
    for name, pkg in (("jax", "avsr_tpu"), ("port", "avsr_tpu_torch")):
        mod = importlib.import_module(f"{pkg}.infer.wer")
        orig = mod.WERAccumulator.add

        def spy(self, ref, hyp, _orig=orig, _out=pairs[name]):
            _out.append((ref, hyp))
            return _orig(self, ref, hyp)

        monkeypatch.setattr(mod.WERAccumulator, "add", spy)
    _, tc = run_cfgs(tmp_path / "port", **{"training.eval_wer_every_epochs": 1})
    jc, _ = run_cfgs(tmp_path / "jax", **{"training.eval_wer_every_epochs": 1})
    w_port = port_trainer(tc, weights, val=True)._eval_wer(1)
    w_jax = jax_trainer(jc, weights, val=True)._eval_wer(1)
    assert pairs["port"] == pairs["jax"] and len(pairs["port"]) == 2
    assert w_port == w_jax
    rows = (tmp_path / "port" / "loss_log.csv").read_text().splitlines()
    assert rows[-1].split(",")[2] == "val_wer"


def test_best_wer_early_stop_and_fit_state_resume(weights, tmp_path):
    """best_metric=wer writes best.json at the first eval. With a learning
    rate of 0 the WER stays flat. A run stopped mid-epoch 2 (which evaluates
    as it stops, as the JAX Trainer does) and resumed keeps its patience
    count, so with patience 2 it stops at the end of epoch 2; a count
    reset on resume would run to epoch 4."""
    over = {"training.eval_wer_every_epochs": 1, "training.best_metric": "wer",
            "training.early_stop_patience": 2, "training.learning_rate": 0.0,
            "training.eval_wer_max_utts": 2, "decode.max_new_tokens": 4}
    _, tc = run_cfgs(tmp_path, **{**over, "training.max_steps": 6})
    tr = port_trainer(tc, weights, val=True)
    out = tr.train()
    assert out["epochs"] == 2 and out["steps"] == 6
    best = json.loads((tmp_path / "ckpt" / "best.json").read_text())
    assert best["step"] == 4 and best["tag"] == "best" and "val_wer" in best["metrics"]
    meta = tr.ckpt.read_meta(6)
    assert meta["fit_state"]["evals_no_improve"] == 1
    assert meta["data_state"] == {"epoch": 2, "batches": 2}

    _, tc = run_cfgs(tmp_path, **{**over, "training.max_steps": -1,
                                  "training.num_epochs": 10})
    tr = port_trainer(tc, weights, val=True)
    assert tr.maybe_resume()
    out = tr.train()
    assert out["epochs"] == 2 and out["steps"] == 8
    assert tr.ckpt.read_meta(8)["fit_state"]["evals_no_improve"] == 2
    rows = (tmp_path / "loss_log.csv").read_text().splitlines()
    assert [r.split(",")[2] for r in rows[1:]].count("val_wer") == 3


def test_profile_dir_writes_a_trace(tmp_path):
    """runtime.profile_dir traces steps 4-7 into a Chrome trace; the loss
    history is written beside the loss log."""
    cfg = tcfg.load_config(TINY_YAML, ["training.max_steps=8",
                                       f"training.checkpoint_dir={tmp_path / 'run'}",
                                       f"runtime.profile_dir={tmp_path / 'prof'}"])
    params = tstate.cast_frozen(tavsr_init(cfg), cfg.model, torch.float32)
    Trainer(cfg, params, port_loader(cfg)).train()
    traces = list((tmp_path / "prof").glob("*.json"))
    assert [t.name for t in traces] == ["trace_step7.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    hist = json.loads((tmp_path / "run" / "loss_history.json").read_text())
    assert len(hist["train"]) == 8 and hist["val"] == []
