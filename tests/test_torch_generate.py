"""PyTorch port's composition and serving path vs the JAX package (f32, CPU).

Tolerances: 2e-4 atol/rtol on encoder features and prefixes, 1e-4 on the
quantized serving preset's prefill and decode-step logits, exact integer
equality on packing, lengths and generated tokens.
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
from avsr_tpu_torch.cli import decode as tdecode
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.models import llama as tllama
from avsr_tpu_torch.ops import quant as tquant

from test_torch_models import ENC_TOL, close, np_tree, randomize_lora_b, to_port_cfg

torch.set_num_threads(1)

# the JAX package's infer/__init__ re-exports a function named ``generate``
jgen = importlib.import_module("avsr_tpu.infer.generate")

REPO = Path(__file__).resolve().parent.parent
TINY_YAML = REPO / "avsr_tpu" / "configs" / "tiny_cpu.yaml"
BASE_YAML = REPO / "avsr_tpu" / "configs" / "base.yaml"
EOS = 257   # ByteTokenizer


@pytest.fixture(scope="module")
def tiny():
    """tiny_cpu.yaml with modality=both: JAX and port configs, one weight
    tree (LoRA b randomised), and one numpy batch."""
    jc = jload_config(TINY_YAML, {"model.modality": "both"})
    tc = tcfg.load_config(TINY_YAML, ["model.modality=both"])
    params = np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model))
    randomize_lora_b(params, seed=2)
    rng = np.random.default_rng(0)
    S = jc.model.clip.image_size
    batch = dict(
        mel=rng.standard_normal((2, 80, 100)).astype(np.float32),
        mel_lens=np.array([100, 62], np.int32),
        frames=rng.standard_normal((2, 4, 3, S, S)).astype(np.float32),
        frame_lens=np.array([4, 3], np.int32),
        prompt_tokens=np.tile(np.array([256, 72, 105], np.int32), (2, 1)),
    )
    return dict(
        jc=jc, tc=tc,
        p_j=jax.tree_util.tree_map(jnp.asarray, params),
        p_t=from_numpy_tree(params, "cpu"),
        b_j=javsr.Batch(**{k: jnp.asarray(v) for k, v in batch.items()}),
        b_t=tavsr.Batch(**{k: torch.from_numpy(v) for k, v in batch.items()}),
    )


def test_pack_segments_matches_jax():
    rng = np.random.default_rng(1)
    caps, lens = [5, 7, 3], [np.array([3, 0]), np.array([7, 2]), np.array([1, 3])]
    segs = [(rng.standard_normal((2, c, 4)).astype(np.float32), l.astype(np.int32))
            for c, l in zip(caps, lens)]
    out_j = javsr.pack_segments([(jnp.asarray(e), jnp.asarray(l)) for e, l in segs])
    out_t = tavsr.pack_segments([(torch.from_numpy(e), torch.from_numpy(l))
                                 for e, l in segs])
    for t, j in zip(out_t, out_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("fusion", ["weighted_sum", "concat_seq"])
def test_encode_and_build_prefix(tiny, fusion):
    jm = dataclasses.replace(tiny["jc"].model, fusion_mode=fusion)
    tm = dataclasses.replace(tiny["tc"].model, fusion_mode=fusion)
    enc_j = javsr.encode(tiny["p_j"], jm, tiny["b_j"], use_pallas="never")
    enc_t = tavsr.encode(tiny["p_t"], tm, tiny["b_t"])
    close(enc_t.features, enc_j.features, ENC_TOL)
    np.testing.assert_array_equal(enc_t.lengths.numpy(), np.asarray(enc_j.lengths))
    pre_j, plen_j = javsr.build_prefix(tiny["p_j"], jm, tiny["b_j"], enc_j)
    pre_t, plen_t = tavsr.build_prefix(tiny["p_t"], tm, tiny["b_t"], enc_t)
    close(pre_t, pre_j, ENC_TOL)
    np.testing.assert_array_equal(plen_t.numpy(), np.asarray(plen_j))


def _jax_step_logits(p, cfg, batch, n, kv_int8=False):
    """Greedy step logits of the JAX package, step by step (the oracle of
    the margin check)."""
    enc = javsr.encode(p, cfg, batch, use_pallas="never")
    prefix, plens = javsr.build_prefix(p, cfg, batch, enc)
    logits_all, cache = jllama.llama_apply(
        p["llm"], cfg.llm, inputs_embeds=prefix, lengths=plens, lora=cfg.lora,
        return_cache=True, cache_len=prefix.shape[1] + n, use_pallas="never")
    if kv_int8:
        cache = jllama.quantize_cache(cache)
    logits = jnp.take_along_axis(logits_all, (plens - 1)[:, None, None], axis=1)[:, 0]
    cur, out = plens, []
    for _ in range(n):
        out.append(np.asarray(logits))
        nxt = jnp.argmax(logits, axis=-1)
        logits, cache = jllama.llama_decode_step(
            p["llm"], cfg.llm, x=jllama.embed_tokens(p["llm"], nxt[:, None]),
            cache=cache, cur_lens=cur, lora=cfg.lora)
        cur = cur + 1
    return out


def test_greedy_generate_is_token_exact(tiny):
    n = tiny["jc"].decode.max_new_tokens
    out_j = jgen.generate_tokens(tiny["p_j"], tiny["jc"].model, tiny["b_j"],
                                 max_new_tokens=n, eos_id=EOS, use_pallas="never")
    stats = {}
    out_t = tgen.generate_tokens(tiny["p_t"], tiny["tc"].model, tiny["b_t"],
                                 max_new_tokens=n, eos_id=EOS, stats=stats)
    np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out_j.tokens))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))
    # every step of the JAX run has a clear top-1 (no near-tie can flip it)
    steps = _jax_step_logits(tiny["p_j"], tiny["jc"].model, tiny["b_j"], n)
    for lg in steps:
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 1e-3)
    close(stats["prefill_logits"], steps[0], ENC_TOL)
    assert len(set(out_t.tokens.flatten().tolist())) > 1   # not degenerate


# ---------------------------------------------------------------------------
# The quantized serving preset: int4 (or int8) projections, int8 head, int8
# KV cache, the fused decode layout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[4, 8], ids=["use_4bit", "use_8bit"])
def tiny_q(request, tiny):
    """Each package quantizes the same f32 tree its own way and prepares it
    for decode with lm_head_bits=8 (the leaves agree exactly:
    test_torch_quant.py)."""
    bits = request.param
    flag = "use_4bit" if bits == 4 else "use_8bit"
    jc = jload_config(TINY_YAML, {"model.modality": "both", f"model.{flag}": True,
                                  "decode.lm_head_bits": 8,
                                  "decode.kv_cache_dtype": "int8"})
    tc = tcfg.load_config(TINY_YAML, ["model.modality=both", f"model.{flag}=true",
                                      "decode.lm_head_bits=8",
                                      "decode.kv_cache_dtype=int8"])
    p_j = dict(tiny["p_j"], llm=jquant.quantize_llm(tiny["p_j"]["llm"], bits))
    p_t = dict(tiny["p_t"], llm=tquant.quantize_llm(tiny["p_t"]["llm"], bits))
    return dict(tiny, jc=jc, tc=tc,
                p_j=jgen.prepare_params_for_decode(p_j, jc.model, lm_head_bits=8),
                p_t=tgen.prepare_params_for_decode(p_t, tc.model, lm_head_bits=8))


def _prefill_and_step(p, cfg, batch, *, enc_mod, llm_mod, port, use_kernel="auto"):
    """Prefill logits at each row's last position, the int8-quantized
    cache, and the logits of one decode step on the greedy token."""
    kw = {} if port else {"use_pallas": "never"}
    enc = enc_mod.encode(p, cfg, batch, **kw)
    prefix, plens = enc_mod.build_prefix(p, cfg, batch, enc)
    lora = cfg.lora
    hidden, cache = llm_mod.llama_apply(
        p["llm"], cfg.llm, inputs_embeds=prefix, lengths=plens, lora=lora,
        return_cache=True, cache_len=prefix.shape[1] + 4, output="hidden", **kw)
    cache = llm_mod.quantize_cache(cache)
    B = prefix.shape[0]
    if port:
        h_last = hidden[torch.arange(B), plens.long() - 1][:, None]
        logits = llm_mod.compute_logits(p["llm"], cfg.llm, h_last, use_kernel)[:, 0]
        nxt = logits.argmax(-1)
        step, _ = llm_mod.llama_decode_step(
            p["llm"], cfg.llm, x=llm_mod.embed_tokens(p["llm"], nxt[:, None]),
            cache=cache, cur_lens=plens, lora=lora, use_kernel=use_kernel)
        return logits, step
    h_last = jnp.take_along_axis(hidden, (plens - 1)[:, None, None], axis=1)
    logits = llm_mod.compute_logits(p["llm"], cfg.llm, h_last)[:, 0]
    nxt = jnp.argmax(logits, axis=-1)
    step, _ = llm_mod.llama_decode_step(
        p["llm"], cfg.llm, x=llm_mod.embed_tokens(p["llm"], nxt[:, None]),
        cache=cache, cur_lens=plens, lora=lora)
    return logits, step


def test_quantized_prefill_and_decode_step_logits(tiny_q):
    r = tiny_q
    lj, sj = _prefill_and_step(r["p_j"], r["jc"].model, r["b_j"], enc_mod=javsr,
                               llm_mod=jllama, port=False)
    lt, st = _prefill_and_step(r["p_t"], r["tc"].model, r["b_t"], enc_mod=tavsr,
                               llm_mod=tllama, port=True)
    close(lt, lj)
    close(st, sj)


def test_quantized_greedy_generate_is_token_exact(tiny_q):
    r = tiny_q
    n = r["jc"].decode.max_new_tokens
    out_j = jgen.generate_tokens(r["p_j"], r["jc"].model, r["b_j"], max_new_tokens=n,
                                 eos_id=EOS, use_pallas="never", kv_cache_dtype="int8")
    out_t = tgen.generate_tokens(r["p_t"], r["tc"].model, r["b_t"], max_new_tokens=n,
                                 eos_id=EOS, kv_cache_dtype="int8")
    np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out_j.tokens))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))
    steps = _jax_step_logits(r["p_j"], r["jc"].model, r["b_j"], n, kv_int8=True)
    for lg in steps:
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 1e-3)
    assert len(set(out_t.tokens.flatten().tolist())) > 1


def test_quantized_always_path_near_auto(tiny_q):
    """"always" sends every product of <= 64 rows through the kernels'
    plain version, which rounds x to bf16 (relative 2^-9) where the CPU's
    "auto" dequantizes in f32: logits within 2e-2 * their std."""
    r = tiny_q
    lt, st = _prefill_and_step(r["p_t"], r["tc"].model, r["b_t"], enc_mod=tavsr,
                               llm_mod=tllama, port=True)
    la, sa = _prefill_and_step(r["p_t"], r["tc"].model, r["b_t"], enc_mod=tavsr,
                               llm_mod=tllama, port=True, use_kernel="always")
    for auto, always in ((lt, la), (st, sa)):
        d = (auto - always).abs().max().item()
        assert 0 < d <= 2e-2 * auto.std().item(), (d, auto.std().item())


def test_sampling_and_eos_lengths(tiny):
    gen = torch.Generator().manual_seed(0)
    out = tgen.generate_tokens(tiny["p_t"], tiny["tc"].model, tiny["b_t"],
                               max_new_tokens=6, temperature=0.8, top_p=0.9,
                               eos_id=EOS, generator=gen)
    assert out.tokens.shape == (2, 6)
    t = out.tokens.numpy()
    for b in range(2):
        hit = np.where(t[b] == EOS)[0]
        if hit.size:
            assert np.all(t[b, hit[0]:] == EOS)
            assert out.lengths[b] == hit[0] + 1
        else:
            assert out.lengths[b] == 6


def test_top_p_filter_matches_jax():
    logits = np.random.default_rng(3).standard_normal((3, 50)).astype(np.float32)
    for top_p in (0.1, 0.5, 0.9):
        j = jgen._top_p_filter(jnp.asarray(logits), top_p)
        t = tgen._top_p_filter(torch.from_numpy(logits), top_p)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_cli_decode_writes_artifacts(tmp_path):
    rc = tdecode.main([
        "--config", str(TINY_YAML), "--device", "cpu", "--seed", "1",
        "model.modality=both", "data.synthetic=true",
        "decode.max_new_tokens=4", f"decode.output_dir={tmp_path}"])
    assert rc == 0
    results = list(tmp_path.glob("results_*.txt"))
    wers = list(tmp_path.glob("wer_*.txt"))
    assert len(results) == 1 and len(wers) == 1
    assert results[0].read_text().count("UTT: ") == 2
    assert "utterances: 2" in wers[0].read_text()


def test_cli_decode_serving_preset_writes_artifacts(tmp_path):
    rc = tdecode.main([
        "--config", str(TINY_YAML), "--device", "cpu", "--seed", "1",
        "model.modality=both", "data.synthetic=true", "model.use_4bit=true",
        "decode.lm_head_bits=8", "decode.kv_cache_dtype=int8",
        "decode.max_new_tokens=4", f"decode.output_dir={tmp_path}"])
    assert rc == 0
    assert len(list(tmp_path.glob("results_*.txt"))) == 1
    wers = list(tmp_path.glob("wer_*.txt"))
    assert len(wers) == 1 and "utterances: 2" in wers[0].read_text()


def _fields_equal(port_dc, jax_dc, path=""):
    for f in dataclasses.fields(port_dc):
        pv, jv = getattr(port_dc, f.name), getattr(jax_dc, f.name)
        if dataclasses.is_dataclass(pv):
            _fields_equal(pv, jv, f"{path}{f.name}.")
        else:
            assert pv == jv, f"{path}{f.name}: {pv!r} != {jv!r}"


def test_flagship_equals_base_yaml():
    jc = jload_config(BASE_YAML)
    port = tcfg.flagship()
    _fields_equal(port, jc)
    assert tcfg.load_config(BASE_YAML) == port
    assert port == to_port_cfg(jc, tcfg.AVSRConfig)
