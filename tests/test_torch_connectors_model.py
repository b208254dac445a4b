"""The whole model with each connector vs the JAX package (f32, CPU), and
the two repairs that came with the connectors: ``fusion_mode`` and the
dual connectors' modality check.

The widened tiny config of ``test_torch_train.py`` (modality both, LoRA
dropout off) with each connector, JAX-initialised weights (LoRA ``b``
randomised) moved across by ``convert.from_numpy_tree``. Tolerances: the
loss atol/rtol 1e-4 and gradients as in ``test_torch_connectors.py``
(``assert_grads``), encoder features 2e-4 (``ENC_TOL``); masks, counts,
lengths and tokens exactly; a resumed run against an uninterrupted one bit
for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core import config as jcfg
from avsr_tpu.models import avsr as javsr
from avsr_tpu.train import state as jstate
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.data import loader as tloader
from avsr_tpu_torch.infer import engine as tengine
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.infer import speculative as tspec
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.train import state as tstate

from test_torch_checkpoint import port_trainer, run_cfgs, trainable_leaves
from test_torch_connectors import DUAL, SINGLE, assert_grads
from test_torch_engine import Tok, model, ref_t, samples
from test_torch_engine import configs as engine_configs
from test_torch_models import ENC_TOL, TOL, np_tree, randomize_lora_b
from test_torch_streaming import noise, replace
from test_torch_streaming import run_both as stream_both
from test_torch_train import configs, jax_paths, jbatch, np_batch, port_paths, tbatch

torch.set_num_threads(1)


def test_fusion_mode_connector_gives_weighted_sum_features():
    """JAX's encode sends every fusion_mode but concat_seq to weighted_sum;
    the port used to raise for "connector"."""
    jc, tc = configs(**{"model.fusion_mode": "connector"})
    weights = randomize_lora_b(np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model)))
    b = np_batch()
    enc_j = javsr.encode(jax.tree_util.tree_map(jnp.asarray, weights), jc.model, jbatch(b),
                         use_pallas="never")
    p_t = from_numpy_tree(weights, "cpu")
    with torch.no_grad():
        enc_t = tavsr.encode(p_t, tc.model, tbatch(b))
        ws = tavsr.encode(p_t, dataclasses.replace(tc.model, fusion_mode="weighted_sum"),
                          tbatch(b))
    np.testing.assert_allclose(enc_t.features.numpy(), np.asarray(enc_j.features), **ENC_TOL)
    np.testing.assert_array_equal(enc_t.lengths.numpy(), np.asarray(enc_j.lengths))
    assert torch.equal(enc_t.features, ws.features)


@pytest.mark.parametrize("name", DUAL)
@pytest.mark.parametrize("modality", ["audio", "video"])
def test_dual_connector_needs_both_modalities_as_in_jax(name, modality):
    errs = []
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError) as e:
            mod.AVSRConfig(model=mod.ModelConfig(connector_type=name,
                                                 modality=modality)).validate()
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert "requires modality='both'" in errs[1]


# ---------------------------------------------------------------------------
# the whole model, the engine and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SINGLE + DUAL)
def test_forward_loss_grads_and_masks_match_jax(name):
    """The widened tiny config (modality both) with each connector: the
    packed causal-LM loss and every trainable leaf's gradient against JAX,
    the parameter tree (dual connectors under ``params["connector"]``), the
    trainable and weight-decay masks (also with unfreeze_layer_norms), and
    the trainable count."""
    jc, tc = configs(**{"model.connector_type": name})
    weights = randomize_lora_b(np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model)),
                               seed=3)
    p_j = jax.tree_util.tree_map(jnp.asarray, weights)
    p_t = from_numpy_tree(weights, "cpu")
    fresh = tavsr.init_avsr_model(tc.model, seed=0, device="cpu")
    assert port_paths(fresh).keys() == port_paths(p_t).keys()
    assert ("connector" in fresh) == (name in DUAL)

    b = np_batch()
    train_j, frozen_j = jstate.partition_trainable(p_j, jc.model)
    (loss_j, _), g_j = jax.value_and_grad(
        lambda tp: javsr.forward(jstate.combine_trainable(tp, frozen_j), jc.model,
                                 jbatch(b), use_pallas="never"), has_aux=True)(train_j)
    train_t, _ = tstate.partition_trainable(p_t, tc.model)
    leaves = port_paths(train_t)
    for t in leaves.values():
        t.requires_grad_(True)
    loss_t, _ = tavsr.forward(p_t, tc.model, tbatch(b), use_kernel="always")
    # adaptive's pool is not reached at 250 frames (JAX: a zero gradient)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves.values(), torch.autograd.grad(loss_t, list(leaves.values()),
                                             allow_unused=True))]
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    assert_grads(dict(zip(leaves, grads)), jax_paths(g_j))

    for unfreeze in (False, True):
        jm = dataclasses.replace(jc.model, unfreeze_layer_norms=unfreeze)
        tm = dataclasses.replace(tc.model, unfreeze_layer_norms=unfreeze)
        assert (jax_paths(jstate.trainable_mask(p_j, jm))
                == port_paths(tstate.trainable_mask(p_t, tm)))
        assert tstate.count_trainable(p_t, tm) == jstate.count_trainable(p_j, jm)
    assert jax_paths(jstate.decay_mask(p_j)) == port_paths(tstate.decay_mask(p_t))


@pytest.mark.parametrize("name", ["qformer", "attention"])
def test_engine_equals_generate_tokens(name):
    """The continuous-batching engine with a fixed-length (``qformer``) and
    a single-input attention connector: every request token for token equal
    to a standalone ``generate_tokens`` call for it."""
    jc, tc = engine_configs(**{"model.modality": "both", "model.connector_type": name,
                               "model.qformer_queries": 6})
    _, p_t = model(jc)
    tok = Tok()
    ts, _ = samples([8000, 12000, 6400, 9600], seed=8, frames=True)
    eng = tengine.ServingEngine(p_t, tc, tok, num_slots=2, max_new_tokens=5, k_steps=2)
    try:
        got = eng.transcribe(ts)
    finally:
        eng.close()
    for i, s in enumerate(ts):
        assert got[i] == ref_t(p_t, tc, tok, s, 5), i


@pytest.mark.parametrize("draft", ["int8", "layerskip"])
def test_speculative_drafts_reuse_the_dual_connector(draft):
    """The int8 self-draft and the layer-skip draft carry the target's
    connector (the dual ``cross_modal`` here, the same tensors), and greedy
    speculative decoding with them equals greedy decoding."""
    jc, tc = engine_configs(**{"model.modality": "both",
                               "model.connector_type": "cross_modal"})
    _, p_t = model(jc)
    tok = Tok()
    ts, _ = samples([8000, 12000], seed=9, frames=True)
    hb = tloader.collate(ts, tc.data, tok.encode(tc.model.prompt, add_bos=True), tok.pad_id)
    b = tloader.featurize(hb, "cpu", torch.float32)
    if draft == "int8":
        d_p, d_cfg = tspec.make_draft_params(p_t, tc.model, bits=8), None
    else:
        d_p, d_cfg = tspec.make_layerskip_draft(p_t, tc.model, 1)
    assert d_p["connector"] is p_t["connector"]
    greedy = tgen.generate_tokens(p_t, tc.model, b, max_new_tokens=6, eos_id=tok.eos_id)
    out = tspec.speculative_generate(p_t, d_p, tc.model, b, gamma=3, max_new_tokens=6,
                                     eos_id=tok.eos_id, draft_model_cfg=d_cfg)
    assert torch.equal(out.tokens, greedy.tokens) and torch.equal(out.lengths, greedy.lengths)


def test_blockwise_streaming_with_a_fixed_length_connector():
    """Blockwise streaming with ``qformer``: each frozen block gives the
    connector's fixed number of features, as in JAX; every feed commits what
    JAX's transcriber commits."""
    jc, tc = engine_configs(**{"model.modality": "both", "model.connector_type": "qformer",
                               "model.qformer_queries": 6})
    p_j, p_t = model(jc)
    jc, tc = replace(jc, tc, "decode", stream_block_s=0.2, stream_video_fps=10.0,
                     max_new_tokens=5)
    frames = np.random.default_rng(7).integers(0, 256, (8, 16, 16, 3)).astype(np.uint8)
    audio = noise(12800, 7)
    st = stream_both(dict(jc=jc, tc=tc, p_j=p_j, p_t=p_t),
                     [dict(audio=audio[i * 3200:(i + 1) * 3200], frames=frames[2 * i:2 * i + 2])
                      for i in range(4)], agree_n=2)
    assert st._cache is not None and st._frozen_samples >= 3200


def test_resumed_step_with_cross_modal_equals_uninterrupted(tmp_path):
    """One step, stop, resume for a second: bit-equal to two uninterrupted
    steps (LoRA dropout off), with the dual connector's leaves in the
    checkpoint and its video alignment on the grad path."""
    extra = {"model.connector_type": "cross_modal"}
    jc, _ = configs(**extra)
    weights = randomize_lora_b(np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model)),
                               seed=3)
    losses, leaves = {}, {}
    for name, runs in (("interrupted", (1, 2)), ("straight", (2,))):
        hist = []
        for max_steps in runs:
            _, tc = run_cfgs(tmp_path / name, **extra, **{"training.max_steps": max_steps})
            tr = port_trainer(tc, weights)
            assert tr.maybe_resume() == (name == "interrupted" and max_steps == 2)
            assert tr.train()["steps"] == max_steps
            hist += tr.history["train"]
        losses[name], leaves[name] = hist, trainable_leaves(tr.state.params, tc)
    assert losses["interrupted"] == losses["straight"] and len(losses["straight"]) == 2
    assert any(k[0] == "connector" for k in leaves["straight"])
    for k, v in leaves["straight"].items():
        assert torch.equal(v, leaves["interrupted"][k]), k
