"""The port with the reference's other LLM, Llama-2-7B, and the ``attention``
connector vs the JAX package (f32, CPU).

Llama-2-7B differs from the flagship's Llama-3.2-1B in what these tests hold
at a narrow width: multi-head attention (as many kv heads as query heads)
with heads of 128, an untied head, a vocab of 32000 (the preset's int8 head
pads it to 32768), plain RoPE at theta 1e4 and an ``ffn_dim`` that is an odd
multiple of 256 (11008 = 43 x 256: the int4 half-split puts ``down``'s rows
an odd number of 128-row blocks apart). Its 4096 width gives the attending
connectors 8 heads of 512, the widest the port's kernels take. Here:

  * the ``attention`` connector at d_out 4096 against JAX's
    ``attention_apply`` (output, lengths, every parameter's gradient), on
    the port's kernel route (plain versions on CPU) and plain route;
  * a narrow Llama-2-shaped AVSR (LLM d_model 256: 2 heads of 128 over 2 kv
    heads, ffn 768 = 3 x 256, vocab 32000, untied, theta 1e4) with the
    ``attention`` connector: prefill logits and greedy tokens, a train
    step's loss and gradients, and the serving preset's prefill and
    decode-step logits, each against JAX;
  * a tiny Llama-2-layout HF directory (untied ``lm_head``, full-width k/v)
    converts bit-equal in both packages;
  * both packages' ``load_config`` give one tree for the 7B's overrides.

Weights come from the JAX init through numpy (LoRA ``b`` randomised);
inputs are numpy from a seed. Tolerances: the modules' 1e-4 (logits;
the 4096-wide connector's output 1e-4 rtol and 1e-4 x max|ref| atol, its
f32 sums running over 4096 terms), 2e-4 on prefill logits (whole encoders,
as ``test_torch_generate.py``), loss 1e-5 relative, each gradient leaf
||g - g_jax|| <= 1e-4 ||g_jax|| (``test_torch_connectors.assert_grads``:
an attention key bias, whose exact gradient is 0, against the value
bias's); tokens and converted leaves exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.cli import convert_hf as jconvert
from avsr_tpu.core import config as jcfg
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.models import avsr as javsr
from avsr_tpu.models import llama as jllama
from avsr_tpu.models.connectors import get_connector as jget
from avsr_tpu.ops import quant as jquant
from avsr_tpu.train import state as jstate
from avsr_tpu_torch.cli import convert_hf as tconvert
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.models import llama as tllama
from avsr_tpu_torch.models.connectors import get_connector as tget
from avsr_tpu_torch.ops import attention as tattn
from avsr_tpu_torch.ops import quant as tquant
from avsr_tpu_torch.train import state as tstate

from test_torch_connectors import assert_grads, perturb
from test_torch_convert_hf import _compare
from test_torch_generate import (EOS, _fields_equal, _jax_step_logits, _prefill_and_step,
                                 jgen)
from test_torch_models import ENC_TOL, close, np_tree, randomize_lora_b
from test_torch_train import jax_paths, np_batch, port_paths

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY_YAML = REPO / "avsr_tpu" / "configs" / "tiny_cpu.yaml"
BASE_YAML = REPO / "avsr_tpu" / "configs" / "base.yaml"

# the 7B's overrides, as chip_smoke.py's phase 26 gives them to flagship()
LLAMA2_7B = {"model.llm.vocab_size": 32000, "model.llm.d_model": 4096,
             "model.llm.n_layers": 32, "model.llm.n_heads": 32, "model.llm.n_kv_heads": 32,
             "model.llm.ffn_dim": 11008, "model.llm.rope_theta": 10000.0,
             "model.llm.rms_eps": 1e-5, "model.llm.tie_embeddings": "false",
             "model.llm.max_seq_len": 4096, "model.connector_type": "attention"}
# tiny_cpu.yaml with a narrow Llama-2-shaped LLM and the attention connector;
# 500 mel frames (250 features) + 5 prompt + 24 labels pack to 288 rows, so
# the port's train step takes its kernel route (plain versions on CPU)
NARROW = {"model.modality": "both", "model.connector_type": "attention",
          "model.llm.vocab_size": 32000, "model.llm.d_model": 256, "model.llm.n_layers": 2,
          "model.llm.n_heads": 2, "model.llm.n_kv_heads": 2, "model.llm.ffn_dim": 768,
          "model.llm.rope_theta": 10000.0, "model.llm.rms_eps": 1e-5,
          "model.llm.tie_embeddings": False, "model.llm.max_seq_len": 512,
          "model.whisper.max_frames": 500, "model.lora.dropout": 0.0,
          "decode.max_new_tokens": 6}


def narrow_configs(**extra):
    over = {**NARROW, **extra}
    jc = jload_config(TINY_YAML, {**over, "runtime.use_pallas": "never"})
    tc = tcfg.load_config(TINY_YAML, [f"{k}={str(v).lower() if isinstance(v, bool) else v}"
                                      for k, v in over.items()] + ["runtime.use_pallas=always"])
    return jc, tc


@pytest.fixture(scope="module")
def narrow():
    jc, tc = narrow_configs()
    assert tc.model.llm.d_model // tc.model.llm.n_heads == 128
    # the key's implementation named: the JAX CLIs (setup_runtime) switch the
    # process's default to rbg, which gives other weights
    params = randomize_lora_b(np_tree(javsr.init_avsr_model(
        jax.random.key(0, impl="threefry2x32"), jc.model)), seed=5)
    assert params["llm"]["lm_head"]["w"].shape == (256, 32000)
    b = np_batch(seed=7)
    return dict(jc=jc, tc=tc, params=params, np_batch=b,
                p_j=jax.tree_util.tree_map(jnp.asarray, params),
                p_t=from_numpy_tree(params, "cpu"),
                b_j=javsr.Batch(**{k: jnp.asarray(v) for k, v in b.items()}),
                b_t=tavsr.Batch(**{k: torch.from_numpy(v) for k, v in b.items()}))


# ---------------------------------------------------------------------------
# the attention connector at d_out 4096: heads of 512
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", ["always", "never"])
def test_attention_connector_at_4096_matches_jax(use_kernel, monkeypatch):
    """8 heads of 512 over 256 rows (the dispatch threshold): the port's
    "always" takes ``FlashAttention`` at D = 512 (its plain versions on
    CPU), "never" ``mha_reference``; JAX its plain attention."""
    calls = []
    orig = tattn.FlashAttention.apply
    monkeypatch.setattr(tattn.FlashAttention, "apply",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    mc = jcfg.ModelConfig(connector_hidden_mult=1)
    d_in, d_out, T = 16, 4096, 256
    params = perturb(np_tree(jget("attention").init(jax.random.key(3), d_in, d_out, mc)), 3)
    x = np.random.default_rng(4).standard_normal((2, T, d_in)).astype(np.float32)
    lens = np.array([T, 190], np.int32)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    y_j, l_j = jget("attention").apply(p_j, jnp.asarray(x), jnp.asarray(lens),
                                       use_pallas="never")
    w = np.random.default_rng(5).standard_normal(y_j.shape).astype(np.float32)
    g_j = jax.grad(lambda p: jnp.sum(jget("attention").apply(
        p, jnp.asarray(x), jnp.asarray(lens), use_pallas="never")[0] * w))(p_j)

    p_t = from_numpy_tree(params, "cpu")
    leaves = port_paths(p_t)
    for t in leaves.values():
        t.requires_grad_(True)
    y_t, l_t = tget("attention").apply(p_t, torch.from_numpy(x), torch.from_numpy(lens),
                                       use_kernel=use_kernel)
    g_t = torch.autograd.grad((y_t * torch.from_numpy(w)).sum(), list(leaves.values()))
    assert [tuple(s) for s in calls] == ([(2, 8, T, 512)] if use_kernel == "always" else [])
    # f32 sums over 4096-long rows in another order: atol relative to the
    # output's scale
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=1e-4 * float(np.abs(y_j).max()), rtol=1e-4)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    assert_grads(dict(zip(leaves, g_t)), jax_paths(g_j))


# ---------------------------------------------------------------------------
# a narrow Llama-2-shaped AVSR
# ---------------------------------------------------------------------------

def test_prefill_logits_and_greedy_tokens_match_jax(narrow):
    r = narrow
    n = r["jc"].decode.max_new_tokens
    out_j = jgen.generate_tokens(r["p_j"], r["jc"].model, r["b_j"], max_new_tokens=n,
                                 eos_id=EOS, use_pallas="never")
    stats = {}
    out_t = tgen.generate_tokens(r["p_t"], r["tc"].model, r["b_t"], max_new_tokens=n,
                                 eos_id=EOS, stats=stats)
    np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out_j.tokens))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))
    steps = _jax_step_logits(r["p_j"], r["jc"].model, r["b_j"], n)
    assert steps[0].shape[-1] == 32000
    for lg in steps:           # a clear top-1 at every step: no near-tie can flip it
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 1e-3)
    close(stats["prefill_logits"], steps[0], ENC_TOL)
    assert len(set(out_t.tokens.flatten().tolist())) > 1


def test_train_loss_and_grads_match_jax(narrow):
    """One train forward and its gradients on the packed 288-row width:
    the port's kernel route at D = 128 (MHA) in the LLM, JAX's plain one."""
    r = narrow
    jc, tc = r["jc"], r["tc"]
    train_j, frozen_j = jstate.partition_trainable(r["p_j"], jc.model)

    def jloss(tp):
        return javsr.forward(jstate.combine_trainable(tp, frozen_j), jc.model, r["b_j"],
                             use_pallas="never")

    (loss_j, _), g_j = jax.value_and_grad(jloss, has_aux=True)(train_j)
    p_t = from_numpy_tree(r["params"], "cpu")
    train_t, _ = tstate.partition_trainable(p_t, tc.model)
    leaves = port_paths(train_t)
    for t in leaves.values():
        t.requires_grad_(True)
    loss_t, _ = tavsr.forward(p_t, tc.model, r["b_t"], use_kernel="always")
    grads = torch.autograd.grad(loss_t, list(leaves.values()))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    g_j = jax_paths(g_j)
    # every leaf is live but the connectors' attention key biases, whose
    # exact gradient is 0 (assert_grads holds them to the value biases')
    assert all(float(np.abs(g).max()) > 0 for k, g in g_j.items() if k[-2:] != ("k", "b"))
    assert_grads(dict(zip(leaves, grads)), g_j)


def test_serving_preset_logits_match_jax(narrow):
    """int4 projections (``down`` at K = 768: half-split rows 384 apart),
    the int8 head over the vocab padded to 32768, the int8 KV cache and the
    fused decode layout: prefill and decode-step logits."""
    r = narrow
    over = {"model.use_4bit": True, "decode.lm_head_bits": 8, "decode.kv_cache_dtype": "int8"}
    jc, tc = narrow_configs(**over)
    p_j = dict(r["p_j"], llm=jquant.quantize_llm(r["p_j"]["llm"], 4))
    p_t = dict(r["p_t"], llm=tquant.quantize_llm(r["p_t"]["llm"], 4))
    p_j = jgen.prepare_params_for_decode(p_j, jc.model, lm_head_bits=8)
    p_t = tgen.prepare_params_for_decode(p_t, tc.model, lm_head_bits=8)
    assert tuple(p_t["llm"]["lm_head"]["qw"].shape) == (256, 32768)
    lj, sj = _prefill_and_step(p_j, jc.model, r["b_j"], enc_mod=javsr, llm_mod=jllama,
                               port=False)
    lt, st = _prefill_and_step(p_t, tc.model, r["b_t"], enc_mod=tavsr, llm_mod=tllama,
                               port=True)
    assert lt.shape == (2, 32000)
    close(lt, lj)
    close(st, sj)


# ---------------------------------------------------------------------------
# conversion and config
# ---------------------------------------------------------------------------

def test_llama2_layout_hf_directory_converts_bit_equal(tmp_path):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    hf = LlamaForCausalLM(LlamaConfig(
        vocab_size=320, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, intermediate_size=192, tie_word_embeddings=False,
        rope_theta=10000.0, rms_norm_eps=1e-5, attention_bias=False,
        mlp_bias=False)).eval()
    hf.save_pretrained(tmp_path / "llm")
    over = [f"model.llm_path={tmp_path / 'llm'}", "model.llm.vocab_size=320",
            "model.llm.d_model=64", "model.llm.n_layers=2", "model.llm.n_heads=2",
            "model.llm.n_kv_heads=2", "model.llm.ffn_dim=192", "model.llm.rope_theta=10000.0",
            "model.llm.tie_embeddings=false"]
    jc, tc = jload_config(TINY_YAML, over), tcfg.load_config(TINY_YAML, over)
    p_j, notes_j = jconvert.build_converted_params(jc)
    p_t, notes_t = tconvert.build_converted_params(tc, device="cpu")
    assert notes_t == notes_j == ["llm"]
    _compare(p_j, p_t, notes_t)
    sd = hf.state_dict()
    assert torch.equal(p_t["llm"]["lm_head"]["w"], sd["lm_head.weight"].T)
    assert not torch.equal(p_t["llm"]["lm_head"]["w"], p_t["llm"]["embed"].T)
    assert p_t["llm"]["layers"][0]["k"]["w"].shape == (64, 64)       # full-width k/v


def test_7b_overrides_give_one_config_in_both_packages():
    over = [f"{k}={v}" for k, v in LLAMA2_7B.items()]
    jc = jload_config(BASE_YAML, over)
    port = tcfg.load_config(BASE_YAML, over)
    _fields_equal(port, jc)
    assert tcfg.flagship(over) == port
    llm = port.model.llm
    assert (llm.d_model // llm.n_heads, llm.n_kv_heads, llm.tie_embeddings) == (128, 32, False)
