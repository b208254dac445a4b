"""The port with Llama-2-13B and the ``attention`` connector vs the JAX
package (f32, CPU).

Llama-2-13B (``meta-llama/Llama-2-13b-hf``'s ``config.json``: d_model 5120,
40 blocks of 40 MHA heads of 128, ffn 13824, vocab 32000, an untied head,
RoPE theta 1e4) gives the attending connectors 8 heads of 640: wider than
the 512 the compiled kernels take, so the panel kernels run them. Here, at
the full width of 5120 and one LLM block:

  * a 13B-shaped AVSR (audio only; the LLM's 40 heads of 128 over 40 kv
    heads, ffn 256, vocab 512, untied; the ``attention`` connector with 8
    heads of 640 and a 5120-wide MLP) from JAX's init through the port's
    converter: prefill logits and greedy tokens, and a train step's loss
    and every trainable gradient, each against JAX. The port takes its
    kernel route (``FlashAttention``, the plain versions on CPU tensors):
    D = 640 in the connector over 260 Whisper frames, D = 128 in the LLM
    over the packed rows; JAX its plain attention;
  * both packages' ``load_config`` give one tree for the 13B's overrides.

Weights come from the JAX init through numpy (LoRA ``b`` randomised);
inputs are numpy from a seed. Tolerances as ``test_torch_llama2.py``'s:
prefill logits 2e-4 (whole encoders), loss 1e-5 relative, each gradient
leaf ||g - g_jax|| <= 1e-4 ||g_jax|| (``test_torch_connectors.assert_grads``),
tokens exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.models import avsr as javsr
from avsr_tpu.models import llama as jllama
from avsr_tpu.train import state as jstate
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.ops import attention as tattn
from avsr_tpu_torch.train import state as tstate

from test_torch_connectors import assert_grads
from test_torch_generate import EOS, _fields_equal, jgen
from test_torch_models import ENC_TOL, close, np_tree, randomize_lora_b
from test_torch_train import jax_paths, port_paths

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY_YAML = REPO / "avsr_tpu" / "configs" / "tiny_cpu.yaml"
BASE_YAML = REPO / "avsr_tpu" / "configs" / "base.yaml"

# the 13B's overrides, as chip_smoke.py's phase 27 gives them to flagship()
LLAMA2_13B = {"model.llm.vocab_size": 32000, "model.llm.d_model": 5120,
              "model.llm.n_layers": 40, "model.llm.n_heads": 40, "model.llm.n_kv_heads": 40,
              "model.llm.ffn_dim": 13824, "model.llm.rope_theta": 10000.0,
              "model.llm.rms_eps": 1e-5, "model.llm.tie_embeddings": "false",
              "model.llm.max_seq_len": 4096, "model.connector_type": "attention"}
# tiny_cpu.yaml at the 13B's width with one LLM block; 520 mel frames give
# 260 Whisper frames (the connector's attention at D = 640 reaches the
# 256-row dispatch threshold) and 5 prompt + 260 + 24 labels pack to 304
N_MEL = 520
WIDE13 = {"model.modality": "audio", "model.connector_type": "attention",
          "model.connector_hidden_mult": 1,
          "model.llm.vocab_size": 512, "model.llm.d_model": 5120, "model.llm.n_layers": 1,
          "model.llm.n_heads": 40, "model.llm.n_kv_heads": 40, "model.llm.ffn_dim": 256,
          "model.llm.rope_theta": 10000.0, "model.llm.rms_eps": 1e-5,
          "model.llm.tie_embeddings": False, "model.llm.max_seq_len": 512,
          "model.whisper.max_frames": N_MEL, "model.lora.dropout": 0.0}
N_NEW = 3


def _batch(seed=7):
    """One utterance of 488 of the 520 mel frames (the connector's keys
    past 244 masked) and 17 of 24 label tokens."""
    rng = np.random.default_rng(seed)
    return dict(
        mel=rng.standard_normal((1, 80, N_MEL)).astype(np.float32),
        mel_lens=np.array([488], np.int32),
        frames=rng.standard_normal((1, 4, 3, 16, 16)).astype(np.float32),
        frame_lens=np.array([4], np.int32),
        prompt_tokens=np.array([[256, 72, 105, 33, 9]], np.int32),
        labels=rng.integers(0, 258, (1, 24)).astype(np.int32),
        label_lens=np.array([17], np.int32))


@pytest.fixture(scope="module")
def wide13():
    jc = jload_config(TINY_YAML, {**WIDE13, "runtime.use_pallas": "never"})
    tc = tcfg.load_config(TINY_YAML, [f"{k}={str(v).lower() if isinstance(v, bool) else v}"
                                      for k, v in WIDE13.items()]
                          + ["runtime.use_pallas=always"])
    assert tc.model.llm.d_model // tc.model.llm.n_heads == 128
    # the key's implementation named: the JAX CLIs (setup_runtime) switch the
    # process's default to rbg, which gives other weights
    params = randomize_lora_b(np_tree(javsr.init_avsr_model(
        jax.random.key(0, impl="threefry2x32"), jc.model)), seed=5)
    assert params["llm"]["lm_head"]["w"].shape == (5120, 512)
    b = _batch()
    return dict(jc=jc, tc=tc, params=params,
                p_j=jax.tree_util.tree_map(jnp.asarray, params),
                p_t=from_numpy_tree(params, "cpu"),
                b_j=javsr.Batch(**{k: jnp.asarray(v) for k, v in b.items()}),
                b_t=tavsr.Batch(**{k: torch.from_numpy(v) for k, v in b.items()}))


def _spy(monkeypatch) -> list:
    """The shapes of q at each ``FlashAttention`` call (the kernel route)."""
    calls = []
    orig = tattn.FlashAttention.apply
    monkeypatch.setattr(tattn.FlashAttention, "apply",
                        lambda *a: calls.append(tuple(a[0].shape)) or orig(*a))
    return calls


def _jax_prefill_logits(p, cfg, batch):
    """JAX's logits at each row's last prefix position (one jitted call)."""

    def f(p, batch):
        enc = javsr.encode(p, cfg, batch, use_pallas="never")
        prefix, plens = javsr.build_prefix(p, cfg, batch, enc)
        logits, _ = jllama.llama_apply(p["llm"], cfg.llm, inputs_embeds=prefix,
                                       lengths=plens, lora=cfg.lora, use_pallas="never")
        return jnp.take_along_axis(logits, (plens - 1)[:, None, None], axis=1)[:, 0]

    return np.asarray(jax.jit(f)(p, batch))


def test_prefill_logits_and_greedy_tokens_match_jax(wide13, monkeypatch):
    r = wide13
    calls = _spy(monkeypatch)
    out_j = jgen.generate_tokens(r["p_j"], r["jc"].model, r["b_j"], max_new_tokens=N_NEW,
                                 eos_id=EOS, use_pallas="never")
    stats = {}
    out_t = tgen.generate_tokens(r["p_t"], r["tc"].model, r["b_t"], max_new_tokens=N_NEW,
                                 eos_id=EOS, stats=stats, use_kernel="always")
    # the connector's 8 heads of 640 and the LLM's prefill, both on the kernel
    # route (Whisper's 2 heads of 16 take mha_reference)
    assert calls == [(1, 8, N_MEL // 2, 640), (1, 40, 5 + N_MEL // 2, 128)], calls
    np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out_j.tokens))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))
    lg = _jax_prefill_logits(r["p_j"], r["jc"].model, r["b_j"])
    top2 = np.sort(lg, axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-3)    # no near-tie at the first token
    close(stats["prefill_logits"], lg, ENC_TOL)
    assert len(set(out_t.tokens.flatten().tolist())) > 1


def test_train_loss_and_grads_match_jax(wide13, monkeypatch):
    """One train forward and its gradients: the connector's attention at
    D = 640 and the LLM's at D = 128 over the 304 packed rows on the port's
    kernel route (``FlashAttention``'s backward: the dQ and dK/dV plain
    versions), JAX's plain one."""
    r = wide13
    jc, tc = r["jc"], r["tc"]
    train_j, frozen_j = jstate.partition_trainable(r["p_j"], jc.model)

    def jloss(tp):
        return javsr.forward(jstate.combine_trainable(tp, frozen_j), jc.model, r["b_j"],
                             use_pallas="never")

    (loss_j, _), g_j = jax.value_and_grad(jloss, has_aux=True)(train_j)
    calls = _spy(monkeypatch)
    p_t = from_numpy_tree(r["params"], "cpu")
    train_t, _ = tstate.partition_trainable(p_t, tc.model)
    leaves = port_paths(train_t)
    for t in leaves.values():
        t.requires_grad_(True)
    loss_t, _ = tavsr.forward(p_t, tc.model, r["b_t"], use_kernel="always")
    grads = torch.autograd.grad(loss_t, list(leaves.values()))
    assert calls == [(1, 8, N_MEL // 2, 640), (1, 40, 304, 128)], calls
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    g_j = jax_paths(g_j)
    assert any(k[0] == "audio_connector" for k in g_j)
    assert all(float(np.abs(g).max()) > 0 for k, g in g_j.items() if k[-2:] != ("k", "b"))
    assert_grads(dict(zip(leaves, grads)), g_j)


def test_13b_overrides_give_one_config_in_both_packages():
    """The 13B's overrides give one config in both packages, and the one
    ``chip_smoke.py``'s phase 27 runs."""
    import chip_smoke

    over = [f"{k}={v}" for k, v in LLAMA2_13B.items()]
    jc = jload_config(BASE_YAML, over)
    port = tcfg.flagship(over)
    _fields_equal(port, jc)
    assert tcfg.flagship(list(chip_smoke.LLAMA2_13B_OVERRIDES)) == port
    llm = port.model.llm
    assert (llm.d_model // llm.n_heads, llm.n_kv_heads, llm.tie_embeddings) == (128, 40, False)
    # the attending connectors' 8 heads over the 5120-wide LLM
    assert llm.d_model // 8 == 640 and tattn.kernel_takes(640)
