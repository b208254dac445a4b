"""The port's HuBERT / Wav2Vec2 encoder and the ``hubert_base`` composition
against the JAX package (f32, CPU; JAX at ``jax_default_matmul_precision=
highest``, as the suite's conftest sets it).

The same numpy weights (JAX's init, with non-trivial norms and biases) and
the same numpy waveforms go to both packages. Tolerances: the encoder, the
fused features and the loss and logits of ``forward`` 2e-4 atol/rtol (as
``ENC_TOL``), the gradients of the encoder's layer norms under
``unfreeze_layer_norms`` 2e-4 atol / 2e-3 rtol; lengths, masks and
generated tokens exactly.
"""

import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core import config as jcfg
from avsr_tpu.data import loader as jloader
from avsr_tpu.models import avsr as javsr
from avsr_tpu.models import hubert as jhubert
from avsr_tpu.train import state as jstate
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.data import loader as tloader
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.models import hubert as thubert
from avsr_tpu_torch.train import state as tstate

from test_torch_generate import _fields_equal
from test_torch_models import ENC_TOL, close, np_tree, randomize_lora_b, to_port_cfg

torch.set_num_threads(1)

jgen = importlib.import_module("avsr_tpu.infer.generate")
REPO = Path(__file__).resolve().parent.parent
HUBERT_YAML = REPO / "avsr_tpu" / "configs" / "hubert_base.yaml"
EOS = 257   # ByteTokenizer

GEOM = dict(d_model=32, n_heads=2, n_layers=2, ffn_mult=4, conv_dims=(32, 32, 32),
            conv_kernels=(10, 3, 3), conv_strides=(5, 2, 2), pos_conv_kernel=16,
            pos_conv_groups=2)
SSL = {
    "base": dict(GEOM, conv_bias=False, feat_extract_norm="group",
                 do_stable_layer_norm=False),
    "stable": dict(GEOM, conv_bias=True, feat_extract_norm="layer",
                   do_stable_layer_norm=True),
}
# 2000 samples -> 99 frames (3 mod 16: the positional conv's trim and the pad
# to 112 rows both show); 1940 -> 96 (a multiple of 16: no pad)
WAVE_LENS = {2000: [2000, 1377], 1940: [1940, 1940]}


def _ssl_params(kind: str, seed: int = 0):
    """JAX's init of one geometry as numpy, with random norm scales and
    biases and conv biases (zero or one at init)."""
    cfg = jcfg.SpeechSSLConfig(**SSL[kind])
    p = np_tree(jhubert.init_speech_ssl(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed + 10)

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in ("scale", "b") and isinstance(v, np.ndarray):
                    base = 1.0 if k == "scale" else 0.0
                    node[k] = (base + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                else:
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(p)
    return cfg, tcfg.SpeechSSLConfig(**SSL[kind]), p


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
@pytest.mark.parametrize("T", sorted(WAVE_LENS), ids=lambda t: f"T{t}")
@pytest.mark.parametrize("masked", [True, False], ids=["wave_lengths", "full"])
@pytest.mark.parametrize("kind", sorted(SSL))
def test_speech_ssl_apply_matches_jax(kind, masked, T, normalize):
    jc, tc, p = _ssl_params(kind)
    jc = dataclasses.replace(jc, normalize_input=normalize)
    tc = dataclasses.replace(tc, normalize_input=normalize)
    rng = np.random.default_rng(T)
    wave = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
    lens = np.asarray(WAVE_LENS[T], np.int32)
    kw_j = dict(wave_lengths=jnp.asarray(lens)) if masked else {}
    kw_t = dict(wave_lengths=torch.from_numpy(lens)) if masked else {}
    out_j, fl_j = jhubert.speech_ssl_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                           jnp.asarray(wave), jc, use_pallas="never", **kw_j)
    out_t, fl_t = thubert.speech_ssl_apply(from_numpy_tree(p, "cpu"), torch.from_numpy(wave),
                                           tc, **kw_t)
    assert out_t.shape == out_j.shape
    close(out_t, out_j, ENC_TOL)
    np.testing.assert_array_equal(fl_t.numpy(), np.asarray(fl_j))


def test_feat_extract_output_lengths_match_jax():
    lens = np.arange(0, 5000, 7, dtype=np.int32)
    for cfg_j, cfg_t in ((jcfg.SpeechSSLConfig(), tcfg.SpeechSSLConfig()),
                         (jcfg.SpeechSSLConfig(**SSL["base"]),
                          tcfg.SpeechSSLConfig(**SSL["base"]))):
        np.testing.assert_array_equal(
            thubert.feat_extract_output_lengths(cfg_t, torch.from_numpy(lens)).numpy(),
            np.asarray(jhubert.feat_extract_output_lengths(cfg_j, jnp.asarray(lens))))
    # 10 s at 16 kHz is 499 frames (the flash kernel's 512-row pad), 30 s 1499
    full = thubert.feat_extract_output_lengths(tcfg.SpeechSSLConfig(),
                                               torch.tensor([160_000, 480_000]))
    assert full.tolist() == [499, 1499]
    assert tcfg.SpeechSSLConfig().downsample == 320


def test_padded_matches_trimmed():
    """With ``wave_lengths``, a clip padded with zeros gives the trimmed
    clip's features on its valid frames (the layer-norm feature extractor,
    whose statistics are per frame; the group norm's span the whole padded
    axis, as in HF)."""
    _, tc, p = _ssl_params("stable", seed=3)
    p_t = from_numpy_tree(p, "cpu")
    rng = np.random.default_rng(4)
    short = rng.standard_normal((1, 1213)).astype(np.float32)
    pad = np.zeros((1, 2000), np.float32)
    pad[:, :1213] = short
    out_s, fl_s = thubert.speech_ssl_apply(p_t, torch.from_numpy(short), tc)
    out_p, fl_p = thubert.speech_ssl_apply(p_t, torch.from_numpy(pad), tc,
                                           wave_lengths=torch.tensor([1213]))
    n = int(fl_s[0])
    assert int(fl_p[0]) == n and n % 16 != 0
    torch.testing.assert_close(out_p[:, :n], out_s, **ENC_TOL)


# ---------------------------------------------------------------------------
# hubert_base: the config, the composition, the masks, generation
# ---------------------------------------------------------------------------

def test_hubert_base_equals_its_yaml():
    jc = jcfg.load_config(HUBERT_YAML)
    port = tcfg.hubert_base()
    _fields_equal(port, jc)
    assert tcfg.load_config(HUBERT_YAML) == port
    assert port == to_port_cfg(jc, tcfg.AVSRConfig)
    assert port.model.audio_dim == 768


def test_config_checks_match_jax():
    for bad, msg in (({"model.audio_encoder": "mfcc"}, "audio_encoder must be"),
                     ({"model.ssl.feat_extract_norm": "batch"}, "feat_extract_norm"),
                     ({"model.ssl.conv_kernels": [10, 3]}, "lengths differ")):
        with pytest.raises(ValueError, match=msg):
            jcfg.load_config(HUBERT_YAML, bad)
        with pytest.raises(ValueError, match=msg):
            tcfg.hubert_base(_port_overrides(bad))
    # the Whisper-only max_frames check does not bind a wave front end
    big = ["data.audio_buckets=1000,2000,4000"]
    assert tcfg.hubert_base(big).data.audio_buckets[-1] == 4000
    with pytest.raises(ValueError, match="whisper.max_frames"):
        tcfg.flagship(big)


TINY = {"model.ssl.d_model": 32, "model.ssl.n_heads": 2, "model.ssl.n_layers": 2,
        "model.ssl.conv_dims": [32, 32, 32], "model.ssl.conv_kernels": [10, 3, 3],
        "model.ssl.conv_strides": [5, 2, 2], "model.ssl.pos_conv_kernel": 16,
        "model.ssl.pos_conv_groups": 2,
        "model.llm.vocab_size": 260, "model.llm.d_model": 32, "model.llm.n_layers": 2,
        "model.llm.n_heads": 4, "model.llm.n_kv_heads": 2, "model.llm.ffn_dim": 64,
        "model.llm.max_seq_len": 256, "model.lora.r": 2, "model.lora.alpha": 4,
        "runtime.compute_dtype": "float32", "decode.max_new_tokens": 8}


def _port_overrides(tree: dict) -> list[str]:
    return [f"{k}={','.join(map(str, v)) if isinstance(v, list) else v}"
            for k, v in tree.items()]


@pytest.fixture(scope="module")
def tiny_hubert():
    """hubert_base.yaml cut to a tiny width in both packages, one weight
    tree (LoRA b randomised) and one numpy batch of waveforms."""
    jc = jcfg.load_config(HUBERT_YAML, TINY)
    tc = tcfg.hubert_base(_port_overrides(TINY))
    params = np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model))
    randomize_lora_b(params, seed=2)
    rng = np.random.default_rng(0)
    batch = dict(
        wave=(0.3 * rng.standard_normal((2, 2000))).astype(np.float32),
        wave_lens=np.array([2000, 1500], np.int32),
        prompt_tokens=np.tile(np.array([256, 72, 105], np.int32), (2, 1)),
        labels=rng.integers(0, 256, (2, 6)).astype(np.int32),
        label_lens=np.array([6, 4], np.int32),
    )
    return dict(
        jc=jc, tc=tc, np_params=params,
        p_j=jax.tree_util.tree_map(jnp.asarray, params),
        p_t=from_numpy_tree(params, "cpu"),
        b_j=javsr.Batch(**{k: jnp.asarray(v) for k, v in batch.items()}),
        b_t=tavsr.Batch(**{k: torch.from_numpy(v) for k, v in batch.items()}),
    )


def test_init_tree_matches_jax(tiny_hubert):
    """The port's random init has JAX's key paths, shapes and dtypes."""
    p_t = tavsr.init_avsr_model(tiny_hubert["tc"].model, seed=0, device="cpu")
    want = tstate.path_leaves(tiny_hubert["p_t"])
    got = tstate.path_leaves(p_t)
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
               for k in want)
    assert "hubert/pos_conv/w" in got and "whisper/conv1/w" not in got
    s = tavsr.summarize(p_t, tiny_hubert["tc"].model)
    assert s["per_component"]["hubert"] > 0
    assert s["total_params"] == sum(t.numel() for t in got.values())


def test_encode_and_forward_match_jax(tiny_hubert):
    t = tiny_hubert
    enc_j = javsr.encode(t["p_j"], t["jc"].model, t["b_j"], use_pallas="never")
    enc_t = tavsr.encode(t["p_t"], t["tc"].model, t["b_t"])
    close(enc_t.features, enc_j.features, ENC_TOL)
    np.testing.assert_array_equal(enc_t.lengths.numpy(), np.asarray(enc_j.lengths))
    loss_j, m_j = javsr.forward(t["p_j"], t["jc"].model, t["b_j"], use_pallas="never",
                                return_logits=True)
    loss_t, m_t = tavsr.forward(t["p_t"], t["tc"].model, t["b_t"], return_logits=True)
    close(loss_t, loss_j, ENC_TOL)
    close(m_t["label_logits"], m_j["label_logits"], ENC_TOL)
    np.testing.assert_array_equal(m_t["label_mask"].numpy(), np.asarray(m_j["label_mask"]))


@pytest.mark.parametrize("unfreeze", [False, True], ids=["frozen", "unfreeze_layer_norms"])
def test_trainable_masks_match_jax(tiny_hubert, unfreeze):
    jm = dataclasses.replace(tiny_hubert["jc"].model, unfreeze_layer_norms=unfreeze)
    tm = dataclasses.replace(tiny_hubert["tc"].model, unfreeze_layer_norms=unfreeze)
    mask_j = jstate.trainable_mask(tiny_hubert["p_j"], jm)
    want = {"/".join(jstate._path_keys(path)): bool(m)
            for path, m in jax.tree_util.tree_leaves_with_path(mask_j)}
    got = {k: bool(v) for k, v in tstate.path_leaves(
        tstate.trainable_mask(tiny_hubert["p_t"], tm)).items()}
    assert got == want
    enc = sorted(k for k, v in got.items() if v and k.startswith("hubert/"))
    if unfreeze:   # proj_ln, ln, every block's ln1/ln2 and the first conv's norm
        assert "hubert/proj_ln/scale" in enc and "hubert/fe/0/norm/b" in enc
        assert "hubert/blocks/1/ln2/scale" in enc and "hubert/ln/b" in enc
        assert len(enc) == 2 * (3 + 2 * 2)
    else:
        assert enc == []


def test_unfreeze_layer_norms_gradients_match_jax(tiny_hubert):
    """With the encoder frozen but its layer norms trained, the gradient
    reaches them through the whole encoder, as JAX's drops its
    stop_gradient."""
    t = tiny_hubert
    jm = dataclasses.replace(t["jc"].model, unfreeze_layer_norms=True)
    tm = dataclasses.replace(t["tc"].model, unfreeze_layer_norms=True)
    names = ["proj_ln", "ln"]
    g_j = jax.grad(lambda p: javsr.forward(p, jm, t["b_j"], use_pallas="never")[0])(t["p_j"])
    p_t = from_numpy_tree(t["np_params"], "cpu")
    leaves = [p_t["hubert"][n][k] for n in names for k in ("scale", "b")]
    leaves += [p_t["hubert"]["blocks"][0]["ln1"]["scale"]]
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = tavsr.forward(p_t, tm, t["b_t"])
    grads = torch.autograd.grad(loss, leaves)
    want = [g_j["hubert"][n][k] for n in names for k in ("scale", "b")]
    want += [g_j["hubert"]["blocks"][0]["ln1"]["scale"]]
    for g, w in zip(grads, want):
        assert float(np.abs(np.asarray(w)).max()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-3)


def test_generate_tokens_is_token_exact(tiny_hubert):
    t = tiny_hubert
    n = t["jc"].decode.max_new_tokens
    out_j = jgen.generate_tokens(t["p_j"], t["jc"].model, t["b_j"], max_new_tokens=n,
                                 eos_id=EOS, use_pallas="never")
    out_t = tgen.generate_tokens(t["p_t"], t["tc"].model, t["b_t"], max_new_tokens=n,
                                 eos_id=EOS)
    np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out_j.tokens))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))
    assert len(set(out_t.tokens.flatten().tolist())) > 1   # not degenerate


@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compact"])
def test_featurize_wave_front_end_matches_jax(tiny_hubert, compact):
    """``featurize`` with a HuBERT config hands the encoder the padded
    waveform (the compact link's int16 PCM unpacked first), as JAX's
    ``featurize(audio_frontend="wave")`` does."""
    from avsr_tpu_torch.data.dataset import Sample

    rng = np.random.default_rng(5)
    samples = [Sample(f"u{i}", (0.2 * rng.standard_normal(n)).astype(np.float32), None,
                      "", [1, 2]) for i, n in enumerate((16000, 9000))]
    dc = dataclasses.replace(tiny_hubert["tc"].data, audio_buckets=(100, 200),
                             compact_transfer=compact)
    hb = tloader.collate(samples, dc, [256], 0)
    assert jloader.audio_frontend_for(tiny_hubert["jc"].model) == "wave"
    b_t = tloader.featurize(hb, "cpu", torch.float32, tiny_hubert["tc"].model)
    b_j = jloader.featurize(hb, jnp.float32, "wave")
    assert b_t.mel is None and b_j.mel is None
    np.testing.assert_array_equal(b_t.wave.numpy(), np.asarray(b_j.wave))
    np.testing.assert_array_equal(b_t.wave_lens.numpy(), np.asarray(b_j.wave_lens))


@pytest.mark.parametrize("leaf,shape", [
    ("fe/0/w", (32, 1, 10)),            # conv kernel [O, I, K]
    ("fe/2/w", (32, 32, 3)),
    ("pos_conv/w", (32, 16, 16)),       # grouped kernel [d, d / groups, K]
    ("blocks/0/fc1/w", (32, 128)),      # dense [in, out]
    ("fe/0/norm/scale", (32,)),         # the group norm's affine
    ("blocks/1/attn/k/b", (32,)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_convert_carries_hubert_leaves(leaf, shape):
    """``convert.from_numpy_tree`` / ``to_numpy_tree`` carry a JAX HuBERT
    subtree leaf for leaf and layout for layout, in f32 and from JAX's
    bf16 (ml_dtypes) arrays."""
    from avsr_tpu_torch.convert import to_numpy_tree

    _, _, p = _ssl_params("base")
    tree = {"hubert": p}

    def at(t, path):
        for part in path.split("/"):
            t = t[int(part)] if isinstance(t, list) else t[part]
        return t

    want = at(tree, "hubert/" + leaf)
    got = at(from_numpy_tree(tree, "cpu"), "hubert/" + leaf)
    assert want.shape == shape and tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(at(to_numpy_tree(from_numpy_tree(tree, "cpu")),
                                     "hubert/" + leaf), want)
    j16 = np_tree(jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), tree))
    got16 = at(from_numpy_tree(j16, "cpu"), "hubert/" + leaf)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, torch.tensor(want).to(torch.bfloat16))
