"""PyTorch port's modules vs the JAX package, module by module (f32, CPU).

Weights come from the JAX init, pass through numpy (with the LoRA ``b``
randomised, since it is zero at init) and reach the port through
``convert.from_numpy_tree``; inputs are numpy from a seed. Tolerance:
1e-4 atol/rtol per module, 2e-4 for whole encoders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core import config as jcfg
from avsr_tpu.models import clip_vit as jclip
from avsr_tpu.models import layers as jl
from avsr_tpu.models import llama as jllama
from avsr_tpu.models import whisper_encoder as jwhisper
from avsr_tpu.models.connectors import get_connector as jget_connector
from avsr_tpu.ops import image as jimage
from avsr_tpu.ops.logmel import log_mel_spectrogram as jlogmel
from avsr_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.models import clip_vit as tclip
from avsr_tpu_torch.models import layers as tl
from avsr_tpu_torch.models import llama as tllama
from avsr_tpu_torch.models import whisper_encoder as twhisper
from avsr_tpu_torch.models.connectors import get_connector as tget_connector
from avsr_tpu_torch.ops import image as timage
from avsr_tpu_torch.ops.logmel import log_mel_spectrogram as tlogmel

TOL = dict(atol=1e-4, rtol=1e-4)
ENC_TOL = dict(atol=2e-4, rtol=2e-4)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Shared helpers (also used by test_torch_generate.py)
# ---------------------------------------------------------------------------

def np_tree(tree):
    """A JAX pytree -> the same tree of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize_lora_b(tree, seed=0, scale=0.05):
    """Give every LoRA ``b`` (zero at init) random values, in place."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if "lora" in node:
                b = node["lora"]["b"]
                node["lora"]["b"] = (scale * rng.standard_normal(b.shape)
                                     ).astype(b.dtype)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(tree)
    return tree


def to_port_cfg(jax_dc, port_cls):
    """A JAX config dataclass -> the port's dataclass of the same name."""
    names = {f.name for f in dataclasses.fields(port_cls)}
    kw = {}
    for f in dataclasses.fields(jax_dc):
        if f.name not in names:
            continue
        val = getattr(jax_dc, f.name)
        if dataclasses.is_dataclass(val):
            val = to_port_cfg(val, getattr(tcfg, type(val).__name__))
        kw[f.name] = val
    return port_cls(**kw)


def both(arr):
    """numpy -> (jax array, torch tensor)."""
    return jnp.asarray(arr), torch.from_numpy(np.asarray(arr))


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer_params():
    p = np_tree(jl.encoder_block_init(jax.random.key(0), 32, 64, n_heads=4))
    rng = np.random.default_rng(0)
    for sub in ("ln1", "ln2"):   # non-trivial norm params
        p[sub]["scale"] = rng.uniform(0.5, 1.5, 32).astype(np.float32)
        p[sub]["b"] = (0.1 * rng.standard_normal(32)).astype(np.float32)
    return p


@pytest.mark.parametrize("name", ["dense", "layer_norm", "rms_norm", "gelu",
                                  "quick_gelu", "heads"])
def test_layer_primitives(layer_params, name):
    x_j, x_t = both(np.random.default_rng(1).standard_normal((2, 7, 32))
                    .astype(np.float32))
    p_t = from_numpy_tree(layer_params, "cpu")
    p_j = jax.tree_util.tree_map(jnp.asarray, layer_params)
    if name == "dense":
        close(tl.dense(p_t["fc1"], x_t), jl.dense(p_j["fc1"], x_j))
    elif name == "layer_norm":
        close(tl.layer_norm(p_t["ln1"], x_t), jl.layer_norm(p_j["ln1"], x_j))
    elif name == "rms_norm":
        close(tl.rms_norm(p_t["ln1"], x_t), jl.rms_norm(p_j["ln1"], x_j))
    elif name == "gelu":
        close(tl.gelu(x_t), jl.gelu(x_j))
    elif name == "quick_gelu":
        close(tl.quick_gelu(x_t), jl.quick_gelu(x_j))
    else:
        h = tl.split_heads(x_t, 4)
        close(h, jl.split_heads(x_j, 4))
        assert torch.equal(tl.merge_heads(h), x_t)


def test_mha_and_encoder_block(layer_params):
    x_j, x_t = both(np.random.default_rng(2).standard_normal((2, 9, 32))
                    .astype(np.float32))
    lens_j, lens_t = both(np.array([9, 5], np.int32))
    p_t = from_numpy_tree(layer_params, "cpu")
    p_j = jax.tree_util.tree_map(jnp.asarray, layer_params)
    close(tl.mha_apply(p_t["attn"], x_t, n_heads=4, lengths=lens_t),
          jl.mha_apply(p_j["attn"], x_j, n_heads=4, lengths=lens_j))
    close(tl.encoder_block_apply(p_t, x_t, n_heads=4, lengths=lens_t),
          jl.encoder_block_apply(p_j, x_j, n_heads=4, lengths=lens_j))
    close(tl.sinusoid_position_embedding(30, 32),
          jl.sinusoid_position_embedding(30, 32))


# ---------------------------------------------------------------------------
# Front ends
# ---------------------------------------------------------------------------

def test_logmel_matches_jax():
    rng = np.random.default_rng(3)
    audio = (0.3 * rng.standard_normal((2, 4000))).astype(np.float32)
    audio[1, 2500:] = 0.0
    lens = np.array([4000, 2500], np.int32)
    a_j, a_t = both(audio)
    l_j, l_t = both(lens)
    out_t = tlogmel(a_t, l_t)
    assert out_t.shape == (2, 80, 25)
    close(out_t, jlogmel(a_j, l_j))
    close(tlogmel(a_t), jlogmel(a_j))


def test_normalize_frames_matches_jax():
    frames = np.random.default_rng(4).integers(0, 256, (2, 3, 8, 8, 3)
                                               ).astype(np.uint8)
    f_j, f_t = both(frames)
    out = timage.normalize_frames(f_t)
    assert out.shape == (2, 3, 3, 8, 8)
    close(out, jimage.normalize_frames(f_j))


# ---------------------------------------------------------------------------
# Encoders and connector
# ---------------------------------------------------------------------------

def test_whisper_encoder_matches_jax():
    jc = jcfg.WhisperConfig(n_mels=80, d_model=32, n_heads=2, n_layers=2,
                            max_frames=60)
    params = np_tree(jwhisper.init_whisper_encoder(jax.random.key(1), jc))
    mel = np.random.default_rng(5).standard_normal((2, 80, 50)).astype(np.float32)
    m_j, m_t = both(mel)
    ml_j, ml_t = both(np.array([50, 31], np.int32))
    out_j, len_j = jwhisper.whisper_encoder_apply(
        jax.tree_util.tree_map(jnp.asarray, params), m_j, jc, mel_lengths=ml_j)
    out_t, len_t = twhisper.whisper_encoder_apply(
        from_numpy_tree(params, "cpu"), m_t, to_port_cfg(jc, tcfg.WhisperConfig),
        mel_lengths=ml_t)
    assert out_t.shape == (2, 25, 32)
    close(out_t, out_j, ENC_TOL)
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))


def test_clip_vit_matches_jax():
    jc = jcfg.ClipConfig(image_size=16, patch_size=8, d_model=24, n_heads=2,
                         n_layers=2)
    params = np_tree(jclip.init_clip_vit(jax.random.key(2), jc))
    frames = np.random.default_rng(6).standard_normal((2, 3, 3, 16, 16)
                                                      ).astype(np.float32)
    f_j, f_t = both(frames)
    p_t = from_numpy_tree(params, "cpu")
    tc = to_port_cfg(jc, tcfg.ClipConfig)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    out_t = tclip.clip_vit_apply(p_t, f_t, tc)
    assert out_t.shape == (2, 3, 24)
    close(out_t, jclip.clip_vit_apply(p_j, f_j, jc), ENC_TOL)


def test_simple_connector_matches_jax():
    mc = jcfg.ModelConfig()
    params = np_tree(jget_connector("simple").init(jax.random.key(3), 24, 32, mc))
    params["out"]["b"] = np.linspace(-1, 1, 32).astype(np.float32)
    x_j, x_t = both(np.random.default_rng(7).standard_normal((2, 5, 24))
                    .astype(np.float32))
    y_j, l_j = jget_connector("simple").apply(
        jax.tree_util.tree_map(jnp.asarray, params), x_j, jnp.array([5, 3]))
    y_t, l_t = tget_connector("simple").apply(
        from_numpy_tree(params, "cpu"), x_t, torch.tensor([5, 3]))
    close(y_t, y_j)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tget_connector("moe")


# ---------------------------------------------------------------------------
# Llama + LoRA
# ---------------------------------------------------------------------------

JLLM = jcfg.LLMConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_dim=64, max_seq_len=128)
JLORA = jcfg.LoRAConfig(use_lora=True, r=2, alpha=4)


@pytest.fixture(scope="module")
def llm_params():
    p = jllama.init_llama(jax.random.key(4), JLLM)
    p = jllama.add_lora(jax.random.key(5), p, JLLM, JLORA)
    p = randomize_lora_b(np_tree(p), seed=1)
    rng = np.random.default_rng(8)
    for layer in p["layers"]:
        layer["ln_attn"]["scale"] = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def llm_prefill(llm_params):
    """Both packages' prefill over one ragged batch (logits and cache)."""
    T, M = 12, 20
    emb = np.random.default_rng(9).standard_normal((2, T, 32)).astype(np.float32)
    e_j, e_t = both(emb)
    l_j, l_t = both(np.array([12, 7], np.int32))
    p_j = jax.tree_util.tree_map(jnp.asarray, llm_params)
    p_t = from_numpy_tree(llm_params, "cpu")
    tllm = to_port_cfg(JLLM, tcfg.LLMConfig)
    tlora = to_port_cfg(JLORA, tcfg.LoRAConfig)
    out_j, cache_j = jllama.llama_apply(p_j, JLLM, inputs_embeds=e_j, lengths=l_j,
                                        lora=JLORA, return_cache=True,
                                        cache_len=M, use_pallas="never")
    out_t, cache_t = tllama.llama_apply(p_t, tllm, inputs_embeds=e_t, lengths=l_t,
                                        lora=tlora, return_cache=True,
                                        cache_len=M)
    return dict(p_j=p_j, p_t=p_t, tllm=tllm, tlora=tlora, e_j=e_j, e_t=e_t,
                l_j=l_j, l_t=l_t, out_j=out_j, out_t=out_t, cache_j=cache_j,
                cache_t=cache_t)


def test_lora_path_is_live(llm_prefill):
    """The randomised b moves the logits (so the LoRA path is under test)."""
    r = llm_prefill
    out_plain, _ = tllama.llama_apply(r["p_t"], r["tllm"],
                                      inputs_embeds=r["e_t"], lengths=r["l_t"])
    assert (out_plain - r["out_t"]).abs().max() > 1e-3


def test_llama_apply_logits_and_hidden(llm_prefill):
    r = llm_prefill
    close(r["out_t"], r["out_j"])
    h_j, _ = jllama.llama_apply(r["p_j"], JLLM, inputs_embeds=r["e_j"],
                                lengths=r["l_j"], lora=JLORA, output="hidden",
                                use_pallas="never")
    h_t, _ = tllama.llama_apply(r["p_t"], r["tllm"], inputs_embeds=r["e_t"],
                                lengths=r["l_t"], lora=r["tlora"], output="hidden")
    close(h_t, h_j)


def test_llama_apply_cache(llm_prefill):
    r = llm_prefill
    # JAX cache is position-minor [L,B,Hkv,Dh,M]; the port's [L,B,Hkv,M,Dh]
    close(r["cache_t"].k, np.swapaxes(np.asarray(r["cache_j"].k), 3, 4))
    close(r["cache_t"].v, np.swapaxes(np.asarray(r["cache_j"].v), 3, 4))


def test_llama_decode_step(llm_prefill):
    r = llm_prefill
    x = np.random.default_rng(10).standard_normal((2, 1, 32)).astype(np.float32)
    x_j, x_t = both(x)
    logits_j, cache_j = jllama.llama_decode_step(
        r["p_j"], JLLM, x=x_j, cache=r["cache_j"], cur_lens=r["l_j"], lora=JLORA)
    cache_t = tllama.KVCache(r["cache_t"].k.clone(), r["cache_t"].v.clone())
    logits_t, cache_t2 = tllama.llama_decode_step(
        r["p_t"], r["tllm"], x=x_t, cache=cache_t, cur_lens=r["l_t"],
        lora=r["tlora"])
    assert cache_t2.k is cache_t.k            # written in place
    close(logits_t, logits_j)
    close(cache_t.k, np.swapaxes(np.asarray(cache_j.k), 3, 4))
    close(cache_t.v, np.swapaxes(np.asarray(cache_j.v), 3, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_logits(llm_params, monkeypatch, dtype):
    """f32 logits from f32 or bf16 hidden/head; the bf16 head is upcast in
    vocab chunks (chunk shrunk here so several chunks run)."""
    monkeypatch.setattr(tllama, "LOGITS_CHUNK", 24)
    x = np.random.default_rng(11).standard_normal((2, 3, 32)).astype(np.float32)
    p_j = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), llm_params)
    x_j = jnp.asarray(x, dtype)
    p_t = from_numpy_tree(np_tree(p_j), "cpu", getattr(torch, dtype))
    x_t = from_numpy_tree(np.asarray(x_j), "cpu", getattr(torch, dtype))
    out_t = tllama.compute_logits(p_t, to_port_cfg(JLLM, tcfg.LLMConfig), x_t)
    assert out_t.dtype == torch.float32
    close(out_t, jllama.compute_logits(p_j, JLLM, x_j))
    ids = torch.tensor([[3, 63]])
    close(tllama.embed_tokens(p_t, ids), jllama.embed_tokens(p_j, jnp.asarray(ids.numpy())))


def test_convert_round_trip(llm_params):
    t = from_numpy_tree(llm_params, "cpu", torch.bfloat16)
    assert t["layers"][0]["q"]["lora"]["a"].dtype == torch.bfloat16
    back = to_numpy_tree(t)
    np.testing.assert_allclose(back["embed"], llm_params["embed"], rtol=1e-2)
    exact = to_numpy_tree(from_numpy_tree(llm_params, "cpu"))
    np.testing.assert_array_equal(exact["layers"][1]["down"]["w"],
                                  llm_params["layers"][1]["down"]["w"])
