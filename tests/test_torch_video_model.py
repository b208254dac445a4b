"""The whole model with the ResNet, EfficientNet and AV-HuBERT video
encoders against the JAX package (f32, CPU): loss and gradients in
``video`` and ``both``, the trainable masks (BatchNorm statistics never
trained), the gradient reaching ``finetune_avhubert_layers``' blocks,
``freeze_encoders=false`` and ``unfreeze_layer_norms`` steps, and greedy,
engine, speculative and beam decodes.

``test_torch_train.py``'s widened tiny config (LoRA dropout off) with each
encoder at a tiny geometry (JAX's ``BOTTLENECK``, ``SCALED`` and
AV-HuBERT ``TINY`` test shapes at 16 x 16 frames), JAX-initialised weights
with random BatchNorm statistics (LoRA ``b`` randomised) moved across by
``convert.from_numpy_tree``. Tolerances: the loss atol/rtol 1e-4 (``TOL``),
gradients per leaf ||g - g_jax|| <= 1e-4 ||g_jax|| (``assert_grads``), a
train step's updated leaves 2e-4 (``STEP_ATOL``); masks, lengths and tokens exactly.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.models import avsr as javsr
from avsr_tpu.train import state as jstate
from avsr_tpu.train import step as jstep
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.data import loader as tloader
from avsr_tpu_torch.data.dataset import Sample
from avsr_tpu_torch.data.tokenizer import ByteTokenizer
from avsr_tpu_torch.infer import engine as tengine
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.infer import speculative as tspec
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep

from test_torch_connectors import assert_grads
from test_torch_models import TOL, np_tree, randomize_lora_b
from test_torch_train import (TINY_YAML, WIDE, configs, jax_paths, jbatch, np_batch,
                              port_paths, tbatch)
from test_torch_video_encoders import jitter_stats

torch.set_num_threads(1)

ENCODERS = {
    "resnet": {"model.resnet.image_size": 16, "model.resnet.embedding_size": 8,
               "model.resnet.hidden_sizes": [16, 32], "model.resnet.depths": [1, 1]},
    "efficientnet": {"model.efficientnet.image_size": 16,
                     "model.efficientnet.width_coefficient": 0.5,
                     "model.efficientnet.in_channels": [32, 16],
                     "model.efficientnet.out_channels": [16, 24],
                     "model.efficientnet.kernel_sizes": [3, 5],
                     "model.efficientnet.strides": [1, 2],
                     "model.efficientnet.num_block_repeats": [1, 2],
                     "model.efficientnet.expand_ratios": [1, 6],
                     "model.efficientnet.hidden_dim": 640},
    "avhubert": {"model.avhubert.image_size": 16, "model.avhubert.frontend_channels": 8,
                 "model.avhubert.trunk_widths": [8, 16], "model.avhubert.trunk_depths": [1, 1],
                 "model.avhubert.d_model": 32, "model.avhubert.n_heads": 2,
                 "model.avhubert.n_layers": 2, "model.avhubert.ffn_mult": 2,
                 "model.avhubert.pos_conv_kernel": 8, "model.avhubert.pos_conv_groups": 2},
}


def enc_configs(encoder: str, **extra):
    return configs(**{"model.video_encoder": encoder, **ENCODERS[encoder], **extra})


def enc_weights(jc, seed: int = 0):
    """JAX's init as numpy, BatchNorm statistics and norm affines jittered,
    LoRA b randomised."""
    p = np_tree(javsr.init_avsr_model(jax.random.key(seed), jc.model))
    enc = jc.model.video_encoder
    p[enc] = jitter_stats(p[enc], seed + 5)
    return randomize_lora_b(p, seed=3)


# AdamW's second step moves each element by up to its learning rate (5e-4)
# whatever the gradient's size, so an element whose gradient is rounding noise
# (the gradients themselves agree to 1e-4 of each leaf's norm) may move
# differently: held to 0.4 of the learning rate
STEP_ATOL = 2e-4


def _grads_both(jc, tc, weights, b):
    """(loss, {path: grad}) of the trainable partition in each package."""
    p_j = jax.tree_util.tree_map(jnp.asarray, weights)
    train_j, frozen_j = jstate.partition_trainable(p_j, jc.model)
    (loss_j, _), g_j = jax.jit(jax.value_and_grad(
        lambda tp: javsr.forward(jstate.combine_trainable(tp, frozen_j), jc.model,
                                 jbatch(b), use_pallas="never"), has_aux=True))(train_j)
    p_t = from_numpy_tree(weights, "cpu")
    train_t, _ = tstate.partition_trainable(p_t, tc.model)
    leaves = port_paths(train_t)
    for t in leaves.values():
        t.requires_grad_(True)
    loss_t, _ = tavsr.forward(p_t, tc.model, tbatch(b), use_kernel="always")
    grads = torch.autograd.grad(loss_t, list(leaves.values()))
    return (float(loss_j), jax_paths(g_j)), (loss_t.item(), dict(zip(leaves, grads)))


@pytest.mark.parametrize("modality", ["video", "both"])
@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_forward_loss_and_grads_match_jax(encoder, modality):
    """The packed causal-LM loss and every trainable leaf's gradient (the
    connectors and LoRA; the encoder frozen) against JAX, and the port's
    random init has JAX's tree."""
    jc, tc = enc_configs(encoder, **{"model.modality": modality})
    weights = enc_weights(jc)
    b = np_batch()
    (loss_j, g_j), (loss_t, g_t) = _grads_both(jc, tc, weights, b)
    np.testing.assert_allclose(loss_t, loss_j, **TOL)
    assert_grads(g_t, g_j)
    fresh = tavsr.init_avsr_model(tc.model, seed=0, device="cpu")
    assert port_paths(fresh).keys() == port_paths(from_numpy_tree(weights, "cpu")).keys()
    assert encoder in fresh and "clip" not in fresh


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_trainable_masks_match_jax_and_bn_statistics_stay_frozen(encoder):
    """``freeze_encoders=false``, ``unfreeze_layer_norms`` and (AV-HuBERT)
    ``finetune_avhubert_layers``: the port's masks and counts are JAX's, and
    no BatchNorm ``mean``/``var`` is ever trainable."""
    jc, tc = enc_configs(encoder, **{"model.modality": "video"})
    weights = enc_weights(jc)
    p_j = jax.tree_util.tree_map(jnp.asarray, weights)
    p_t = from_numpy_tree(weights, "cpu")
    knobs = [dict(freeze_encoders=False), dict(unfreeze_layer_norms=True), {}]
    if encoder == "avhubert":
        knobs.append(dict(finetune_avhubert_layers=(1,)))
    for kw in knobs:
        jm, tm = dataclasses.replace(jc.model, **kw), dataclasses.replace(tc.model, **kw)
        got = port_paths(tstate.trainable_mask(p_t, tm))
        assert got == jax_paths(jstate.trainable_mask(p_j, jm)), kw
        assert tstate.count_trainable(p_t, tm) == jstate.count_trainable(p_j, jm)
        stats = [k for k in got if k[0] == encoder and k[-1] in ("mean", "var")]
        assert stats and not any(got[k] for k in stats), kw
        enc = {k for k, v in got.items() if v and k[0] == encoder}
        if kw.get("freeze_encoders") is False:
            assert ((encoder, "stem", "conv", "w") in enc
                    and len(enc) == sum(1 for k in got if k[0] == encoder) - len(stats))
        elif kw.get("finetune_avhubert_layers"):
            assert enc and all(k[1:3] == ("blocks", "1") for k in enc)
        elif kw.get("unfreeze_layer_norms") and encoder == "avhubert":
            assert ("avhubert", "proj_ln", "scale") in enc and ("avhubert", "ln", "b") in enc
        else:
            assert not enc


@pytest.mark.parametrize("encoder,knob", [
    ("resnet", {"model.freeze_encoders": "false"}),
    ("efficientnet", {"model.freeze_encoders": "false"}),
    ("avhubert", {"model.finetune_avhubert_layers": [1]}),
    ("avhubert", {"model.unfreeze_layer_norms": "true"}),
], ids=["resnet-unfrozen", "efficientnet-unfrozen", "avhubert-finetune_layers",
        "avhubert-unfreeze_layer_norms"])
def test_encoder_gradients_and_train_step_match_jax(encoder, knob):
    """The gradient reaches the encoder's trainable leaves as in JAX (with
    ``finetune_avhubert_layers`` the video branch runs with grad, blocks 1
    only trainable: JAX's ``test_finetune_avhubert_layers_grad_flow``), and
    the train steps of each package update the same leaves to the same
    values over two steps; BatchNorm statistics and the frozen leaves stay
    as they were."""
    jc, tc = enc_configs(encoder, **{"model.modality": "video", **knob})
    weights = enc_weights(jc)
    b = np_batch()
    (loss_j, g_j), (loss_t, g_t) = _grads_both(jc, tc, weights, b)
    np.testing.assert_allclose(loss_t, loss_j, **TOL)
    assert_grads(g_t, g_j)
    enc = {k: g for k, g in g_t.items() if k[0] == encoder}
    assert enc and all(float(g.abs().max()) > 0 for g in enc.values())

    # two steps: the first one's learning rate is 0 (the warm-up)
    state_j, tx = jstate.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, weights), jc, 10)
    step_j = jstep.make_train_step(jc, tx)
    p_t = tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model, torch.float32)
    before = {k: v.clone() for k, v in port_paths(p_t).items()}
    state_t = tstate.create_train_state(p_t, tc, 10)
    step_t = tstep.make_train_step(tc)
    for i in range(2):
        state_j, m_j = step_j(state_j, jstep.microbatch(jbatch(b), 1), jax.random.key(i))
        m_t = step_t(state_t, tstep.microbatch(tbatch(b), 1), i)
        np.testing.assert_allclose(m_t["loss"], float(m_j["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m_t["grad_norm"], float(m_j["grad_norm"]), rtol=1e-4)
    mask = port_paths(tstate.trainable_mask(p_t, tc.model))
    after_j = jax_paths(state_j.params)
    moved = 0
    for path, leaf in port_paths(state_t.params).items():
        if mask[path]:
            np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(after_j[path]),
                                       atol=STEP_ATOL, rtol=1e-5, err_msg=str(path))
            moved += path[0] == encoder and not torch.equal(leaf, before[path])
        else:
            assert torch.equal(leaf, before[path]), path
    assert moved > 0


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

EOS = 10


class Tok(ByteTokenizer):
    """The byte tokenizer with an EOS this model emits mid-stream."""

    def __init__(self) -> None:
        super().__init__()
        self.eos_id = EOS


def _samples(lengths, seed: int):
    rng = np.random.default_rng(seed)
    return [Sample(f"u{i}", (0.3 * rng.standard_normal(n)).astype(np.float32),
                   rng.integers(0, 256, (t, 16, 16, 3)).astype(np.uint8), "", [EOS])
            for i, (n, t) in enumerate(lengths)]


def _decode_setup(encoder):
    jc, tc = enc_configs(encoder, **{"model.llm.n_layers": 2,
                                     "model.llm.tie_embeddings": "false"})
    weights = enc_weights(jc)
    randomize_lora_b(weights, seed=2, scale=0.5)
    return jc, tc, weights


def _batch(tc, tok, samples):
    hb = tloader.collate(samples, tc.data, tok.encode(tc.model.prompt, add_bos=True),
                         tok.pad_id)
    return hb, tloader.featurize(hb, "cpu", torch.float32, tc.model)


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_greedy_decode_is_token_exact_with_jax(encoder):
    """``generate_tokens`` over a featurized batch (each encoder's image
    statistics, ragged frame counts) equals JAX's token for token."""
    from avsr_tpu.data import loader as jloader

    jgen = importlib.import_module("avsr_tpu.infer.generate")
    jc, tc, weights = _decode_setup(encoder)
    tok = Tok()
    hb, b_t = _batch(tc, tok, _samples([(8000, 4), (12000, 3)], seed=3))
    b_j = jloader.featurize(hb, jnp.float32, "mel", jloader.image_stats_for(jc.model))
    np.testing.assert_allclose(b_t.frames.numpy(), np.asarray(b_j.frames), atol=1e-6, rtol=0)
    out_j = jgen.generate_tokens(jax.tree_util.tree_map(jnp.asarray, weights), jc.model, b_j,
                                 max_new_tokens=6, eos_id=EOS, use_pallas="never")
    out_t = tgen.generate_tokens(from_numpy_tree(weights, "cpu"), tc.model, b_t,
                                 max_new_tokens=6, eos_id=EOS)
    np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out_j.tokens))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_engine_speculative_and_beam_equal_greedy(encoder):
    """The engine (2 slots, 4 ragged requests) equals a standalone
    ``generate_tokens`` per request; speculative decoding with the int8
    self-draft and beam search with one beam equal greedy."""
    _, tc, weights = _decode_setup(encoder)
    p_t = from_numpy_tree(weights, "cpu")
    tok = Tok()
    reqs = _samples([(8000, 4), (12000, 3), (6400, 2), (9600, 4)], seed=8)

    def ref(s):
        out = tgen.generate_tokens(p_t, tc.model, _batch(tc, tok, [s])[1], max_new_tokens=5,
                                   eos_id=EOS)
        return out.tokens[0, : int(out.lengths[0])].tolist()

    eng = tengine.ServingEngine(p_t, tc, tok, num_slots=2, max_new_tokens=5, k_steps=2)
    try:
        got = eng.transcribe(reqs)
    finally:
        eng.close()
    for i, s in enumerate(reqs):
        assert got[i] == ref(s), i

    _, b = _batch(tc, tok, reqs[:2])
    greedy = tgen.generate_tokens(p_t, tc.model, b, max_new_tokens=6, eos_id=EOS)
    draft = tspec.make_draft_params(p_t, tc.model, bits=8)
    spec = tspec.speculative_generate(p_t, draft, tc.model, b, gamma=3, max_new_tokens=6,
                                      eos_id=EOS)
    assert torch.equal(spec.tokens, greedy.tokens) and torch.equal(spec.lengths, greedy.lengths)
    beam = tgen.beam_search(p_t, tc.model, b, max_new_tokens=6, num_beams=1, eos_id=EOS)
    assert torch.equal(beam.tokens, greedy.tokens)


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_probe_and_cli_data_follow_the_encoder(encoder):
    """The batch-size probe's worst-case frames, the CLIs' dataset and the
    loader's featurize take the encoder's frame size and statistics, as
    JAX's do (AV-HuBERT: 88 px at full size)."""
    from avsr_tpu.train import probe as jprobe
    from avsr_tpu_torch.cli import common as tcommon
    from avsr_tpu_torch.core import config as tcfg
    from avsr_tpu_torch.train import probe as tprobe

    jc, tc = enc_configs(encoder, **{"model.modality": "video"})
    got = tprobe._worst_case_batch(tc, 2, "cpu").frames
    assert tuple(got.shape) == tuple(jprobe._worst_case_batch(jc, 2).frames.shape)
    assert got.shape[-1] == tc.model.image_size == 16
    _, ds, loader = tcommon.build_data(tc, device="cpu")
    assert ds[0].frames.shape[1:3] == (16, 16)
    hb, b = next(iter(loader))
    want = tloader.featurize(hb, "cpu", torch.float32, image_stats=tloader.image_stats_for(
        tc.model))
    assert torch.equal(b.frames, want.frames)
    full = tcfg.flagship(video_encoder=encoder).model
    assert full.image_size == (88 if encoder == "avhubert" else 224)


def test_decode_cli_with_a_video_encoder_matches_jax(tmp_path):
    """The decode CLI of each package with AV-HuBERT (video only, synthetic
    data, f32 greedy, the same weights): the same hypotheses."""
    from avsr_tpu.cli import decode as jcli_decode
    from avsr_tpu.train import checkpoint as jcheckpoint
    from avsr_tpu_torch.cli import decode as tcli_decode
    from avsr_tpu_torch.train.checkpoint import export_params

    from test_torch_checkpoint_cli import hyp_lines

    over = {"model.modality": "video", "model.video_encoder": "avhubert",
            **ENCODERS["avhubert"], "decode.max_new_tokens": 5, "data.synthetic": "true",
            "data.synthetic_size": 4, "data.batch_size": 4, "decode.batch_size": 4}
    jc, _ = configs(**over)
    weights = enc_weights(jc)
    jcheckpoint.export_params(jax.tree_util.tree_map(jnp.asarray, weights), tmp_path / "jexp")
    export_params(from_numpy_tree(weights, "cpu"), tmp_path / "texp")
    args = ["--config", str(TINY_YAML)] + [
        f"{k}={','.join(map(str, v)) if isinstance(v, list) else v}"
        for k, v in {**WIDE, **over}.items()]
    assert jcli_decode.main([*args, f"decode.output_dir={tmp_path / 'jdec'}",
                             "--checkpoint", str(tmp_path / "jexp"), "--split", "train"]) == 0
    assert tcli_decode.main(["--device", "cpu", *args, f"decode.output_dir={tmp_path / 'tdec'}",
                             "--checkpoint", str(tmp_path / "texp"), "--split", "train"]) == 0
    hyps = hyp_lines(tmp_path / "tdec")
    assert len(hyps) == 4 and hyps == hyp_lines(tmp_path / "jdec")


@pytest.mark.parametrize("block_s", [0.0, 0.2], ids=["exact", "blockwise"])
def test_streaming_with_avhubert_matches_jax(block_s):
    """Streaming with AV-HuBERT (AV-HuBERT's statistics, ragged frame
    counts through ``frame_lengths``), exact re-decode and blockwise (the
    continuation: ``prefill_extend`` + ``generate_continue``): every feed
    and the finalize commit what JAX's transcriber commits."""
    from test_torch_streaming import replace
    from test_torch_streaming import run_both as stream_both

    jc, tc, weights = _decode_setup("avhubert")
    jc, tc = replace(jc, tc, "decode", stream_block_s=block_s, stream_video_fps=10.0,
                     max_new_tokens=5)
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (8, 16, 16, 3)).astype(np.uint8)
    audio = (0.3 * rng.standard_normal(12800)).astype(np.float32)
    m = dict(jc=jc, tc=tc, p_j=jax.tree_util.tree_map(jnp.asarray, weights),
             p_t=from_numpy_tree(weights, "cpu"))
    st = stream_both(m, [dict(audio=audio[i * 3200:(i + 1) * 3200],
                              frames=frames[2 * i:2 * i + 2]) for i in range(4)], agree_n=2)
    assert st.committed_tokens


@pytest.mark.parametrize("encoder", ["resnet", "avhubert"])
def test_infer_and_stream_clis_with_a_video_encoder(encoder, tmp_path, capsys):
    """The one-utterance and streaming CLIs with ``--video``: the frames
    resized to the encoder's size and normalized with its statistics, the
    transcript that of ``generate_tokens`` on the same sample (f32; exact
    streaming commits nothing before its finalize here)."""
    from avsr_tpu_torch.cli import common as tcommon
    from avsr_tpu_torch.cli import infer as tcli_infer
    from avsr_tpu_torch.cli import stream as tcli_stream
    from avsr_tpu_torch.data.audio_io import load_audio, write_wav
    from avsr_tpu_torch.data.dataset import resize_crop_frames
    from avsr_tpu_torch.train.checkpoint import export_params

    over = {"model.video_encoder": encoder, **ENCODERS[encoder],
            "model.llm.tie_embeddings": "false", "decode.max_new_tokens": 6}
    jc, tc = configs(**over)
    export_params(from_numpy_tree(enc_weights(jc), "cpu"), tmp_path / "exp")
    rng = np.random.default_rng(4)
    wav, npy = tmp_path / "u.wav", tmp_path / "u.npy"
    write_wav(wav, (0.3 * rng.standard_normal(12_800)).astype(np.float32))
    raw = rng.integers(0, 256, (5, 24, 20, 3)).astype(np.uint8)
    np.save(npy, raw)

    tok = ByteTokenizer()
    params = tcommon.load_decode_params(tc, str(tmp_path / "exp"), seed=0, device="cpu")
    frames = resize_crop_frames(raw, tc.model.image_size)
    hb = tloader.collate([Sample("u", load_audio(wav), frames, "", [tok.eos_id])], tc.data,
                         tok.encode(tc.model.prompt, add_bos=True), tok.pad_id)
    out = tgen.generate_tokens(params, tc.model, tloader.featurize(hb, "cpu", torch.float32,
                                                                   tc.model),
                               max_new_tokens=6, eos_id=tok.eos_id)
    ids = out.tokens[0, : int(out.lengths[0])].tolist()
    want = tok.decode(ids[:-1] if ids and ids[-1] == tok.eos_id else ids)

    capsys.readouterr()
    args = ["--device", "cpu", "--config", str(TINY_YAML),
            *[f"{k}={','.join(map(str, v)) if isinstance(v, list) else v}"
              for k, v in {**WIDE, **over}.items()],
            "--checkpoint", str(tmp_path / "exp"), "--audio", str(wav), "--video", str(npy)]
    assert tcli_infer.main(args) == 0
    assert capsys.readouterr().out.splitlines()[-1] == want
    assert tcli_stream.main([*args, "--chunk-s", "0.3", "--agree", "9"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == want
