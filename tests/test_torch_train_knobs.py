"""The port's training knobs vs the JAX package and optax (f32, CPU): the
batch-size probe (``training.auto_batch_size``), ``model.unfreeze_layer_norms``,
SpecAugment and video augmentation (``data.specaugment``,
``data.video_augment``), and the adafactor and lion optimizers.

The widened tiny config and JAX-initialised weights of
``test_torch_train.py``. The augmentations do not reproduce JAX's random
stream: the port's apply gets the draws JAX makes from its key, and its
output must equal JAX's, exactly where only masks, flips and shifts act
and at 1e-6 (relative) where the per-utterance mean, contrast or
brightness enters. Tolerances: unfreeze_layer_norms loss 1e-5 relative and
each trainable leaf's gradient ||g_port - g_jax|| <= 1e-5 ||g_jax||;
adafactor and lion parameters after 5 updates 1e-6 relative (atol 1e-7)
against optax; checkpoints round-trip bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avsr_tpu.models import avsr as javsr
from avsr_tpu.ops import specaugment as jspec
from avsr_tpu.ops import videoaug as jvid
from avsr_tpu.train import probe as jprobe
from avsr_tpu.train import state as jstate
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.ops import specaugment as tspec
from avsr_tpu_torch.ops import videoaug as tvid
from avsr_tpu_torch.train import probe as tprobe
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import CheckpointManager

from test_torch_train import (TINY_YAML, configs, jax_paths, jbatch, np_batch, port_paths,
                              rel_dist, tbatch, weights)  # noqa: F401

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the batch-size probe
# ---------------------------------------------------------------------------

def test_worst_case_batch_matches_jax():
    jc, tc = configs()
    jb = jprobe._worst_case_batch(jc, 3)
    tb = tprobe._worst_case_batch(tc, 3, "cpu")
    for name, j, t in zip(jb._fields, jb, tb):
        assert (j is None) == (t is None), name
        if j is None:
            continue
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), name
    for name in ("mel_lens", "frame_lens", "label_lens"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))


@pytest.mark.parametrize("threshold", [0, 1, 3, 16, 1000])
def test_probe_returns_jax_batch_under_a_fake_oom(monkeypatch, threshold):
    """A step of more than ``threshold`` utterances runs out of memory, on
    either side: both probes try the same sizes and return the same one."""
    from avsr_tpu.train import step as jstep

    jc, tc = configs()
    tried = {"jax": [], "port": []}

    def jax_make(cfg, tx, mesh=None):
        def step(state, batch, rng):
            b = batch.labels.shape[1]
            tried["jax"].append(b)
            if b > threshold:
                raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
            return state, {"loss": jnp.zeros(())}
        return step

    def port_make(cfg, mesh=None):
        def step(state, batch, seed, stats=None):
            b = batch.labels.shape[1]
            tried["port"].append(b)
            if b > threshold:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return {"loss": 0.0}
        return step

    monkeypatch.setattr(jstep, "make_train_step", jax_make)
    monkeypatch.setattr(tstep, "make_train_step", port_make)
    want = jprobe.find_optimal_batch_size(jc, {"w": jnp.zeros((2, 2))}, max_batch=64)
    got = tprobe.find_optimal_batch_size(tc, {"w": torch.zeros(2, 2)}, max_batch=64,
                                         device="cpu")
    assert got == want == (0 if threshold < 1 else min(2 ** int(np.log2(threshold)), 64))
    assert tried["port"] == tried["jax"]


def test_probe_runs_real_steps_and_lets_other_errors_through(weights, monkeypatch):
    _, tc = configs()
    params = tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model, torch.float32)
    assert tprobe.find_optimal_batch_size(tc, params, max_batch=2, device="cpu") == 2

    def broken(cfg, mesh=None):
        def step(state, batch, seed, stats=None):
            raise ValueError("not a memory error")
        return step

    monkeypatch.setattr(tstep, "make_train_step", broken)
    with pytest.raises(ValueError):
        tprobe.find_optimal_batch_size(tc, params, max_batch=2, device="cpu")


def test_train_cli_applies_the_probe(tmp_path, monkeypatch):
    """training.auto_batch_size probes a second init and trains with the
    batch it returns when that is larger."""
    from avsr_tpu_torch.cli import train as tcli_train

    seen = {}

    def fake_probe(cfg, params, **kw):
        seen["probe_params"] = params
        return 4

    def fake_trainer(cfg, params, *a, **kw):
        seen["batch_size"], seen["train_params"] = cfg.data.batch_size, params
        raise SystemExit(0)

    monkeypatch.setattr(tcli_train, "find_optimal_batch_size", fake_probe)
    monkeypatch.setattr(tcli_train, "Trainer", fake_trainer)
    with pytest.raises(SystemExit):
        tcli_train.main(["--device", "cpu", "--config", str(TINY_YAML),
                         "training.auto_batch_size=true",
                         f"training.checkpoint_dir={tmp_path}"])
    assert seen["batch_size"] == 4
    assert seen["probe_params"] is not seen["train_params"]


# ---------------------------------------------------------------------------
# unfreeze_layer_norms
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ln_grads(weights):
    jc, _ = configs(**{"model.unfreeze_layer_norms": "true"})
    p_j = jax.tree_util.tree_map(jnp.asarray, weights)
    train_j, frozen_j = jstate.partition_trainable(p_j, jc.model)

    def jloss(tp):
        return javsr.forward(jstate.combine_trainable(tp, frozen_j), jc.model,
                             jbatch(np_batch()), use_pallas="never")

    (loss, _), g = jax.value_and_grad(jloss, has_aux=True)(train_j)
    return float(loss), jax_paths(g)


@pytest.mark.parametrize("remat", [False, True])
def test_unfreeze_layer_norms_grads_match_jax(weights, jax_ln_grads, remat):
    """The encoders run with grad (the Whisper attention through the
    autograd Function, its blocks recomputed under remat), and every
    encoder layer norm gets JAX's gradient."""
    loss_j, g_j = jax_ln_grads
    _, tc = configs(**{"model.unfreeze_layer_norms": "true"})
    p_t = from_numpy_tree(weights, "cpu")
    leaves = port_paths(tstate.partition_trainable(p_t, tc.model)[0])
    assert set(leaves) == set(g_j)
    ln = [k for k in leaves if k[0] in ("whisper", "clip")]
    assert ln and all(k[-2].startswith("ln") for k in ln)
    for t in leaves.values():
        t.requires_grad_(True)
    loss_t, _ = tavsr.forward(p_t, tc.model, tbatch(np_batch()), use_kernel="always",
                              remat=remat)
    grads = torch.autograd.grad(loss_t, list(leaves.values()), allow_unused=True)
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=1e-5)
    live = 0
    for path, g in zip(leaves, grads):
        want = np.asarray(g_j[path])
        if not np.abs(want).max():          # CLIP's ln_post feeds no output
            assert g is None or not g.abs().max(), path
            continue
        live += path in ln
        assert rel_dist(g.numpy(), want) <= 1e-5, path
    assert live >= len(ln) - 2


# ---------------------------------------------------------------------------
# SpecAugment and video augmentation, given JAX's draws
# ---------------------------------------------------------------------------

def jax_spans(key, n, max_width, limits):
    """The spans JAX's ``_mask_any`` draws from ``key``."""
    kw, ks = jax.random.split(key)
    B = limits.shape[0]
    w = jnp.minimum(jax.random.randint(kw, (B, n), 0, max_width + 1), limits[:, None])
    u = jax.random.uniform(ks, (B, n))
    start = jnp.floor(u * (limits[:, None] - w + 1)).astype(jnp.int32)
    return tspec.Spans(torch.from_numpy(np.array(start)).long(),
                       torch.from_numpy(np.array(w)).long())


@pytest.mark.parametrize("tm,tw,fm,fw", [(2, 10, 2, 4), (3, 50, 0, 0), (0, 0, 2, 12),
                                         (1, 5, 1, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_specaugment_matches_jax_given_its_draws(tm, tw, fm, fw, seed):
    rng = np.random.default_rng(seed)
    B, F, T = 3, 16, 40
    mel = (rng.standard_normal((B, F, T)) + 2.0).astype(np.float32)
    lens = np.array([40, 25, 8], np.int32)
    key = jax.random.key(seed)
    want = np.asarray(jspec.specaugment(jnp.asarray(mel), jnp.asarray(lens), key,
                                        time_masks=tm, time_width=tw,
                                        freq_masks=fm, freq_width=fw))
    kt, kf = jax.random.split(key)
    jl = jnp.asarray(lens)
    draws = tspec.SpecDraws(
        jax_spans(kt, tm, tw, jl) if tm and tw else None,
        jax_spans(kf, fm, fw, jnp.full((B,), F, jnp.int32)) if fm and fw else None)
    if draws.time is not None:        # the masks themselves, exactly
        np.testing.assert_array_equal(
            tspec.span_mask(draws.time, T).numpy(),
            np.asarray(jspec._mask_any(kt, tm, tw, T, jl)))
    got = tspec.apply_specaugment(torch.from_numpy(mel), torch.from_numpy(lens),
                                  draws).numpy()
    np.testing.assert_array_equal(got != mel, want != mel)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for i, n in enumerate(lens):      # padding frames bit-identical
        np.testing.assert_array_equal(got[i, :, n:], mel[i, :, n:])


def jax_video_draws(key, B, m, contrast, brightness, dt=jnp.float32):
    k_flip, k_shift, k_b, k_c = jax.random.split(key, 4)

    def t(x):
        return torch.from_numpy(np.array(x))

    return tvid.VideoDraws(
        flip=t(jax.random.bernoulli(k_flip, 0.5, (B,))),
        shift=t(jax.random.randint(k_shift, (B, 2), -m, m + 1)).long() if m else None,
        contrast=(t(jax.random.uniform(k_c, (B,), minval=1.0 - contrast,
                                       maxval=1.0 + contrast).astype(dt))
                  if contrast else None),
        brightness=(t(jax.random.uniform(k_b, (B,), minval=-brightness,
                                         maxval=brightness).astype(dt))
                    if brightness else None),
        max_shift=m)


@pytest.mark.parametrize("m,contrast,brightness", [(3, 0.0, 0.0), (8, 0.0, 0.0),
                                                   (0, 0.0, 0.0), (4, 0.1, 0.1),
                                                   (2, 0.3, 0.0)])
@pytest.mark.parametrize("seed", [0, 5])
def test_video_augment_matches_jax_given_its_draws(m, contrast, brightness, seed):
    rng = np.random.default_rng(seed)
    B, T, C, H, W = 4, 5, 3, 16, 16
    x = rng.standard_normal((B, T, C, H, W)).astype(np.float32)
    lens = np.array([5, 3, 1, 4], np.int32)
    key = jax.random.key(seed)
    want = np.asarray(jvid.video_augment(jnp.asarray(x), jnp.asarray(lens), key,
                                         max_shift=m, flip=True, contrast=contrast,
                                         brightness=brightness))
    draws = jax_video_draws(key, B, m, contrast, brightness)
    got = tvid.apply_video_augment(torch.from_numpy(x), torch.from_numpy(lens),
                                   draws).numpy()
    if contrast or brightness:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:                               # flips and shifts only: exact
        np.testing.assert_array_equal(got, want)
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(got[i, n:], x[i, n:])


def test_port_draws_are_reproducible_and_in_range():
    x = torch.randn(6, 3, 3, 8, 8)
    mel = torch.randn(6, 16, 40)
    lens = torch.tensor([40, 30, 5, 0, 40, 12])

    def gen(s):
        return torch.Generator().manual_seed(s)

    d1 = tvid.draw_video_augment(x, gen(3), max_shift=2, contrast=0.2, brightness=0.1)
    d2 = tvid.draw_video_augment(x, gen(3), max_shift=2, contrast=0.2, brightness=0.1)
    for a, b in zip(d1[:4], d2[:4]):
        assert torch.equal(a, b)
    assert d1.shift.abs().max() <= 2 and ((d1.contrast - 1).abs() <= 0.2).all()
    assert (d1.brightness.abs() <= 0.1).all() and d1.flip.dtype == torch.bool
    s = tspec.draw_specaugment(mel, lens, gen(4), time_masks=3, time_width=10,
                               freq_masks=2, freq_width=4)
    assert ((s.time.start + s.time.width) <= lens[:, None]).all()
    assert (s.time.width <= 10).all() and (s.freq.start + s.freq.width <= 16).all()
    out = tspec.apply_specaugment(mel, lens, s)
    assert torch.equal(out[3], mel[3])        # an empty utterance is untouched


def test_train_step_augments_only_the_training_path(weights):
    """augment() changes valid cells and frames and leaves padding
    bit-identical; the eval step (no dropout seed) is unchanged by the
    knobs; a train step with both knobs runs."""
    _, tc = configs(**{"data.specaugment": "true", "data.video_augment": "true",
                       "data.spec_time_width": 20})
    _, plain = configs()
    b = tbatch(np_batch(4))
    aug, seed = tstep.augment(tc, b, 11)
    same, seed_plain = tstep.augment(plain, b, 11)
    assert seed != 11 and same is b and seed_plain == 11
    for i in range(2):
        n, f = int(b.mel_lens[i]), int(b.frame_lens[i])
        assert torch.equal(aug.mel[i, :, n:], b.mel[i, :, n:])
        assert not torch.equal(aug.mel[i, :, :n], b.mel[i, :, :n])
        assert torch.equal(aug.frames[i, f:], b.frames[i, f:])
        assert not torch.equal(aug.frames[i, :f], b.frames[i, :f])
    params = tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model, torch.float32)
    ev = [tstep.make_eval_step(c)(params, b) for c in (tc, plain)]
    assert ev[0] == ev[1]
    m = tstep.make_train_step(tc)(tstate.create_train_state(params, tc, 10),
                                  tstep.microbatch(b, 1), 3)
    assert np.isfinite(m["loss"]) and not m["skipped"]


# ---------------------------------------------------------------------------
# adafactor and lion
# ---------------------------------------------------------------------------

def opt_params(rng):
    """A factored matrix each way round (both axes >= 128), a matrix and a
    vector too small to factor, decayed ("w") and undecayed leaves."""
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"big": {"w": f(160, 130), "b": f(130)},
            "tall": [{"w": f(200, 128)}],
            "small": {"w": f(6, 5), "scale": f(5)},
            "lora": {"a": f(130, 4), "b": f(4, 130)}}


@pytest.mark.parametrize("name", ["adafactor", "lion"])
def test_optimizer_matches_optax(name):
    """Five updates of clip_by_global_norm + the rule, with the decay mask
    and warmup then cosine, equal optax's; the clip is active on some."""
    jc, tc = configs(**{"training.optimizer": name, "training.weight_decay": 0.1,
                        "training.max_grad_norm": 20.0, "training.warmup_steps": 2,
                        "training.learning_rate": 1e-2})
    rng = np.random.default_rng(7)
    params = opt_params(rng)
    grads = [jax.tree_util.tree_map(
        lambda x, s=s: (s * rng.standard_normal(x.shape)).astype(np.float32), params)
        for s in (0.01, 1.0, 0.05, 0.3, 0.02)]
    tx = jstate.create_optimizer(jc, params, 10)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p_j)
    p_t = from_numpy_tree(params, "cpu")
    opt = tstate.create_optimizer(tc, p_t, 10)
    assert type(opt).__name__ == {"adafactor": "ClippedAdafactor",
                                  "lion": "ClippedLion"}[name]
    clipped = []
    for g in grads:
        clipped.append(float(optax.global_norm(g)) > tc.training.max_grad_norm)
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        g_paths = port_paths(from_numpy_tree(g, "cpu"))
        g_t = [g_paths[path] for path in port_paths(p_t)]
        opt.update(g_t, tstep.global_norm(g_t))
        for path, leaf in port_paths(p_t).items():
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jax_paths(p_j)[path]),
                                       rtol=1e-6, atol=1e-7, err_msg=str(path))
    assert any(clipped) and not all(clipped)
    if name == "adafactor":
        st = opt.state_dict()["leaves"]
        assert set(st["big/w"]) == {"v_row", "v_col"} and set(st["tall/0/w"]) == {"v_row", "v_col"}
        assert set(st["small/w"]) == {"v"} and set(st["lora/a"]) == {"v"}
        # v_row reduces the largest axis, v_col the second largest
        assert tuple(st["big/w"]["v_row"].shape) == (130,)
        assert tuple(st["tall/0/w"]["v_row"].shape) == (128,)
        assert tuple(st["tall/0/w"]["v_col"].shape) == (200,)


@pytest.mark.parametrize("name", ["adafactor", "lion"])
def test_optimizer_state_round_trips_through_a_checkpoint(name, tmp_path):
    """Two updates, save, restore into a fresh state: the same state dict
    bit for bit, and the next update equal to the uninterrupted one; a
    state dict of another rule is refused."""
    _, tc = configs(**{"training.optimizer": name, "training.weight_decay": 0.1})
    rng = np.random.default_rng(3)
    params = opt_params(rng)
    grads = [port_paths(from_numpy_tree(jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params), "cpu"))
        for _ in range(3)]

    def state():
        st = tstate.TrainState(0, from_numpy_tree(params, "cpu"), None)
        st.optimizer = tstate.create_optimizer(tc, st.params, 10)
        return st

    def update(st, g):
        g_t = [g[path] for path in port_paths(st.params)]
        st.optimizer.update(g_t, tstep.global_norm(g_t))
        st.step += 1

    a = state()
    for g in grads[:2]:
        update(a, g)
    mngr = CheckpointManager(tmp_path / "ckpt", tc)
    mngr.save(a)
    mngr.close()
    b = state()
    CheckpointManager(tmp_path / "ckpt").restore(b)
    sa, sb = a.state_dict(), b.state_dict()
    assert sb["step"] == 2 and sb["opt_state"]["count"] == 2
    assert port_paths(sa["opt_state"]["leaves"]).keys() == port_paths(sb["opt_state"]["leaves"]).keys()
    for k, v in port_paths(sa["opt_state"]["leaves"]).items():
        assert torch.equal(v, port_paths(sb["opt_state"]["leaves"])[k]), k
    update(a, grads[2])
    update(b, grads[2])
    for k, v in port_paths(a.params).items():
        assert torch.equal(v, port_paths(b.params)[k]), k
    other = "lion" if name == "adafactor" else "adafactor"
    _, oc = configs(**{"training.optimizer": other})
    wrong = tstate.create_optimizer(oc, from_numpy_tree(params, "cpu"), 10)
    with pytest.raises(ValueError):
        b.optimizer.load_state_dict(wrong.state_dict())
