"""The port's beam search, split-cache steps and streaming continuation vs
the JAX package (f32, CPU).

Weights come from the JAX init of tiny_cpu.yaml with modality both, a
2-layer LLM and an untied head (a tied random head repeats one token;
LoRA ``b`` randomised) and reach the port through
``convert.from_numpy_tree``; inputs are numpy from a seed. The JAX cache
is position-minor [L, B, Hkv, Dh, M], the port's [L, B, Hkv, M, Dh].
EOS is a token the greedy stream emits mid-way (``pick_eos``), so rows
and beams finish at different steps. Tolerances: 1e-4 atol/rtol on hidden states, logits and
cache columns; exact equality on tokens and lengths.
"""

import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.models import avsr as javsr
from avsr_tpu.models import llama as jllama
from avsr_tpu.ops import quant as jquant
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.models import llama as tllama
from avsr_tpu_torch.ops import quant as tquant

from test_torch_models import close, np_tree, randomize_lora_b

torch.set_num_threads(1)

jgen = importlib.import_module("avsr_tpu.infer.generate")

REPO = Path(__file__).resolve().parent.parent
TINY_YAML = REPO / "avsr_tpu" / "configs" / "tiny_cpu.yaml"
OVERRIDES = {"model.modality": "both", "model.llm.n_layers": 2,
             "model.llm.tie_embeddings": False}


def configs(**extra):
    over = {**OVERRIDES, **extra}
    return (jload_config(TINY_YAML, over),
            tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in over.items()]))


def np_batch(S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        mel=rng.standard_normal((2, 80, 100)).astype(np.float32),
        mel_lens=np.array([100, 62], np.int32),
        frames=rng.standard_normal((2, 4, 3, S, S)).astype(np.float32),
        frame_lens=np.array([4, 3], np.int32),
        prompt_tokens=np.tile(np.array([256, 72, 105], np.int32), (2, 1)),
    )


def pair(params: dict, batch: dict, jc, tc) -> dict:
    return dict(
        jc=jc, tc=tc,
        p_j=jax.tree_util.tree_map(jnp.asarray, params),
        p_t=from_numpy_tree(params, "cpu"),
        b_j=javsr.Batch(**{k: jnp.asarray(v) for k, v in batch.items()}),
        b_t=tavsr.Batch(**{k: torch.from_numpy(v) for k, v in batch.items()}))


def pick_eos(r: dict) -> int:
    """A token of the port's greedy stream that row 0 first emits as late
    as possible (after step 1), so that EOS ends rows and beams at
    different steps. The weights, and so the stream, depend on the JAX
    PRNG settings the process runs with."""
    row = tgen.generate_tokens(r["p_t"], r["tc"].model, r["b_t"], max_new_tokens=10,
                               eos_id=-1).tokens[0].tolist()
    firsts = sorted({t: row.index(t) for t in row}.items(), key=lambda kv: kv[1])
    late = [t for t, i in firsts if i >= 2]
    return late[-1] if late else firsts[-1][0]


@pytest.fixture(scope="module")
def tiny():
    jc, tc = configs()
    params = np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model))
    randomize_lora_b(params, seed=2)
    r = pair(params, np_batch(jc.model.clip.image_size), jc, tc)
    r["eos"] = pick_eos(r)
    return r


def to_jax_cache(t: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.swapaxes(t, -1, -2))


def to_port(j) -> np.ndarray:
    return np.swapaxes(np.asarray(j), -1, -2)


def test_prefill_continue_matches_jax(tiny):
    """Ragged history and tail lengths over a cache whose every column
    holds stale values: the hidden rows of the valid tail and the whole
    cache after the write."""
    cfg = tiny["jc"].model.llm
    rng = np.random.default_rng(5)
    B, T, M = 2, 4, 16
    hd = cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, B, cfg.n_kv_heads, M, hd)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    base, tail = np.array([3, 9], np.int32), np.array([4, 2], np.int32)
    h_j, c_j = jllama.llama_prefill_continue(
        tiny["p_j"]["llm"], cfg, x=jnp.asarray(x),
        cache=jllama.KVCache(to_jax_cache(k0), to_jax_cache(v0)),
        base_lens=jnp.asarray(base), tail_lens=jnp.asarray(tail),
        lora=tiny["jc"].model.lora)
    cache_t = tllama.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    h_t, c_t = tllama.llama_prefill_continue(
        tiny["p_t"]["llm"], tiny["tc"].model.llm, x=torch.from_numpy(x),
        cache=cache_t, base_lens=torch.from_numpy(base),
        tail_lens=torch.from_numpy(tail), lora=tiny["tc"].model.lora)
    assert c_t.k is cache_t.k                  # written in place
    for b in range(B):
        close(h_t[b, :tail[b]], np.asarray(h_j)[b, :tail[b]])
    close(c_t.k, to_port(c_j.k))
    close(c_t.v, to_port(c_j.v))
    # the columns before the tail and past base + T kept their stale values
    for b in range(B):
        untouched = np.r_[0:base[b], base[b] + T:M]
        np.testing.assert_array_equal(c_t.k[:, b].numpy()[:, :, untouched],
                                      k0[:, b][:, :, untouched])


def test_decode_step_split_and_merge_match_jax(tiny):
    """One split-cache beam step (a ragged [B]-row prefix, a W-beam suffix
    with stale columns past ``step``), its logits and new columns, then
    the beam gather landing them. (The int8 prefix runs a bf16 product that
    the JAX package's CPU backend executes only inside its beam loop: it is
    held to JAX through ``beam_search`` below.)"""
    cfg_j, cfg_t = tiny["jc"].model, tiny["tc"].model
    llm = cfg_j.llm
    rng = np.random.default_rng(6)
    B, W, Mp, Ms, step = 2, 3, 8, 4, 2
    hd = llm.d_model // llm.n_heads
    pre = [rng.standard_normal((llm.n_layers, B, llm.n_kv_heads, Mp, hd))
           .astype(np.float32) for _ in range(2)]
    suf = [rng.standard_normal((llm.n_layers, B * W, llm.n_kv_heads, Ms, hd))
           .astype(np.float32) for _ in range(2)]
    x = rng.standard_normal((B * W, 1, llm.d_model)).astype(np.float32)
    plens = np.array([5, 8], np.int32)
    pre_j = jllama.KVCache(*(to_jax_cache(t) for t in pre))
    pre_t = tllama.KVCache(*(torch.from_numpy(t) for t in pre))
    lg_j, (k_j, v_j) = jllama.llama_decode_step_split(
        tiny["p_j"]["llm"], llm, x=jnp.asarray(x), prefix_cache=pre_j,
        suffix_cache=jllama.KVCache(*(to_jax_cache(t) for t in suf)),
        prefix_lens=jnp.asarray(plens), step=jnp.int32(step), lora=cfg_j.lora)
    suf_t = tllama.KVCache(*(torch.from_numpy(t) for t in suf))
    lg_t, (k_t, v_t) = tllama.llama_decode_step_split(
        tiny["p_t"]["llm"], cfg_t.llm, x=torch.from_numpy(x), prefix_cache=pre_t,
        suffix_cache=suf_t, prefix_lens=torch.from_numpy(plens), step=step,
        lora=cfg_t.lora)
    close(lg_t, lg_j)
    close(k_t, k_j)
    close(v_t, v_j)
    np.testing.assert_array_equal(suf_t.k.numpy(), suf[0])    # nothing written
    gather = np.array([2, 2, 0, 4, 3, 3])
    for col in (step, -1):
        m_j = jllama.merge_new_columns(
            jllama.KVCache(*(to_jax_cache(t) for t in suf)), k_j, v_j,
            jnp.asarray(gather), jnp.int32(col))
        m_t = tllama.merge_new_columns(suf_t, k_t, v_t, torch.from_numpy(gather), col)
        close(m_t.k, to_port(m_j.k))
        close(m_t.v, to_port(m_j.v))


@pytest.fixture(scope="module")
def tiny_4bit(tiny):
    """The serving preset of the same tree: int4 projections, int8 head,
    int8 prefix cache; each package quantizes it its own way (the leaves
    agree exactly: test_torch_quant.py)."""
    over = {"model.use_4bit": True, "decode.lm_head_bits": 8,
            "decode.kv_cache_dtype": "int8"}
    jc, tc = configs(**over)
    p_j = dict(tiny["p_j"], llm=jquant.quantize_llm(tiny["p_j"]["llm"], 4))
    p_t = dict(tiny["p_t"], llm=tquant.quantize_llm(tiny["p_t"]["llm"], 4))
    return dict(tiny, jc=jc, tc=tc,
                p_j=jgen.prepare_params_for_decode(p_j, jc.model, lm_head_bits=8),
                p_t=tgen.prepare_params_for_decode(p_t, tc.model, lm_head_bits=8))


@pytest.mark.parametrize("model,W,lp,kv", [
    ("f32", 3, 1.0, "bfloat16"),
    ("f32", 3, 0.5, "bfloat16"),
    ("f32", 1, 1.0, "bfloat16"),
    ("f32", 3, 1.0, "int8"),
    ("use_4bit", 3, 1.0, "int8"),
])
def test_beam_search_matches_jax(tiny, tiny_4bit, model, W, lp, kv):
    r = tiny if model == "f32" else tiny_4bit
    kw = dict(max_new_tokens=10, num_beams=W, length_penalty=lp, eos_id=r["eos"],
              kv_cache_dtype=kv)
    out_j = jgen.beam_search(r["p_j"], r["jc"].model, r["b_j"], use_pallas="never", **kw)
    stats = {}
    out_t = tgen.beam_search(r["p_t"], r["tc"].model, r["b_t"], stats=stats, **kw)
    np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out_j.tokens))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))
    assert stats["scores"].shape == (2, W)
    assert stats["decode_steps"] <= 9


def test_beam_finishes_and_w1_equals_greedy(tiny):
    """W = 1 is greedy token for token; the greedy stream emits EOS, so
    beams of the other tests end at it and take the EOS-only extension."""
    kw = dict(max_new_tokens=10, eos_id=tiny["eos"])
    greedy = tgen.generate_tokens(tiny["p_t"], tiny["tc"].model, tiny["b_t"], **kw)
    beam1 = tgen.beam_search(tiny["p_t"], tiny["tc"].model, tiny["b_t"], num_beams=1, **kw)
    np.testing.assert_array_equal(beam1.tokens.numpy(), greedy.tokens.numpy())
    np.testing.assert_array_equal(beam1.lengths.numpy(), greedy.lengths.numpy())
    assert (greedy.tokens == tiny["eos"]).any()
    assert len(set(greedy.tokens.flatten().tolist())) > 2        # not degenerate


def test_generate_dispatch(tiny):
    d = tiny["tc"].decode
    beam_cfg = dataclasses.replace(d, num_beams=3, max_new_tokens=6)
    a = tgen.generate(tiny["p_t"], tiny["tc"].model, tiny["b_t"], beam_cfg, eos_id=tiny["eos"])
    b = tgen.beam_search(tiny["p_t"], tiny["tc"].model, tiny["b_t"], max_new_tokens=6,
                         num_beams=3, eos_id=tiny["eos"])
    np.testing.assert_array_equal(a.tokens.numpy(), b.tokens.numpy())


def test_generate_continue_matches_jax_and_full_prefix(tiny):
    """prefill_extend of the prefix's first S rows into an empty cache,
    then generate_continue over the rest: the tokens and lengths of JAX's
    chain and of generate_tokens over the whole prefix."""
    N, S = 8, 3
    full = tgen.generate_tokens(tiny["p_t"], tiny["tc"].model, tiny["b_t"],
                                max_new_tokens=N, eos_id=tiny["eos"])
    enc = tavsr.encode(tiny["p_t"], tiny["tc"].model, tiny["b_t"])
    prefix, plens = tavsr.build_prefix(tiny["p_t"], tiny["tc"].model, tiny["b_t"], enc)
    B, Tpre = prefix.shape[:2]
    M = -(-(Tpre + N) // 128) * 128
    llm = tiny["tc"].model.llm
    cache = tllama.init_cache(llm, B, M, torch.float32, "cpu")
    base = torch.full((B,), S, dtype=torch.int32)
    cache = tgen.prefill_extend(tiny["p_t"], tiny["tc"].model, cache,
                                torch.zeros((B,), dtype=torch.int32), prefix[:, :S], base)
    out_t, _ = tgen.generate_continue(tiny["p_t"], tiny["tc"].model, cache, base,
                                      prefix[:, S:], plens - S, max_new_tokens=N,
                                      eos_id=tiny["eos"])
    np.testing.assert_array_equal(out_t.tokens.numpy(), full.tokens.numpy())
    np.testing.assert_array_equal(out_t.lengths.numpy(), full.lengths.numpy())

    p_j, m_j = tiny["p_j"], tiny["jc"].model
    enc_j = javsr.encode(p_j, m_j, tiny["b_j"], use_pallas="never")
    pre_j, plens_j = javsr.build_prefix(p_j, m_j, tiny["b_j"], enc_j)
    hd = llm.d_model // llm.n_heads
    zeros = jnp.zeros((llm.n_layers, B, llm.n_kv_heads, hd, M), jnp.float32)
    cache_j = jgen.prefill_extend(p_j, m_j, jllama.KVCache(zeros, zeros),
                                  jnp.zeros((B,), jnp.int32), pre_j[:, :S],
                                  jnp.full((B,), S, jnp.int32))
    out_j, _ = jgen.generate_continue(p_j, m_j, cache_j, jnp.full((B,), S, jnp.int32),
                                      pre_j[:, S:], (plens_j - S).astype(jnp.int32),
                                      max_new_tokens=N, eos_id=tiny["eos"])
    np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out_j.tokens))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))


def test_continue_refuses_a_cache_too_short(tiny):
    llm = tiny["tc"].model.llm
    cache = tllama.init_cache(llm, 2, 8, torch.float32, "cpu")
    x = torch.zeros((2, 4, llm.d_model))
    with pytest.raises(ValueError, match="holds 8 positions"):
        tgen.prefill_extend(tiny["p_t"], tiny["tc"].model, cache,
                            torch.tensor([5, 2]), x, torch.tensor([4, 4]))


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e30, 3.0, -1e30, 0.0, -0.5]])
    vals, idx = tgen._top_k(x, 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4, 0, 6]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    vals, idx = tgen._top_k(x, 8)
    assert idx.tolist() == np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 8)[1]).tolist()


@pytest.mark.parametrize("extra", [
    [],
    ["model.use_4bit=true", "decode.lm_head_bits=8", "decode.kv_cache_dtype=int8"],
], ids=["bf16", "serving_preset"])
def test_decode_cli_beams_write_artifacts(tmp_path, extra):
    from avsr_tpu_torch.cli import decode as tdecode

    rc = tdecode.main(["--config", str(TINY_YAML), "--device", "cpu", "--seed", "1",
                       "model.modality=both", "data.synthetic=true", "decode.num_beams=5",
                       "decode.max_new_tokens=4", f"decode.output_dir={tmp_path}", *extra])
    assert rc == 0
    results = list(tmp_path.glob("results_*.txt"))
    assert len(results) == 1 and results[0].read_text().count("HYP: ") == 2
    assert "utterances: 2" in next(tmp_path.glob("wer_*.txt")).read_text()
