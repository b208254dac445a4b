"""The port's speculative decoding vs the JAX package (f32, CPU), mirroring
``tests/test_speculative.py``.

The contract is the strong one: for any draft, greedy speculative decoding
gives token for token the stream of plain greedy ``generate_tokens``, of
the port and of JAX's ``speculative_generate``. Weights come from the JAX
init (``tests/test_torch_beam.py``'s model: modality both, a 2-layer LLM,
an untied head, LoRA ``b`` randomised) through ``convert.from_numpy_tree``.
The accept/replace decision of sampling is held to JAX's
``_rejection_step`` given JAX's own draws (exact), and to the target
distribution statistically (L1 < 0.03 over 30 000 draws). Tokens and
lengths: exact equality; the cost model: 1e-12 relative.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.cli import decode as jdecode
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.infer import speculative as jspec
from avsr_tpu.models import avsr as javsr
from avsr_tpu_torch.cli import decode as tdecode
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.infer import speculative as tspec

from test_torch_beam import TINY_YAML, configs, np_batch, pair, pick_eos
from test_torch_models import np_tree, randomize_lora_b

torch.set_num_threads(1)

# a genuinely smaller draft: its own widths and encoders, so its own prefix
SMALL = {"model.llm.d_model": 16, "model.llm.n_heads": 2, "model.llm.n_kv_heads": 1,
         "model.llm.ffn_dim": 32, "model.llm.n_layers": 1,
         "model.whisper.d_model": 16, "model.whisper.n_heads": 2}


@pytest.fixture(scope="module")
def tiny():
    jc, tc = configs()
    params = np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model))
    randomize_lora_b(params, seed=2)
    r = pair(params, np_batch(jc.model.clip.image_size), jc, tc)
    other = np_tree(javsr.init_avsr_model(jax.random.key(99), jc.model))
    r["random"] = pair(other, np_batch(jc.model.clip.image_size), jc, tc)
    sj, st = configs(**SMALL)
    small = np_tree(javsr.init_avsr_model(jax.random.key(5), sj.model))
    r["small"] = dict(pair(small, np_batch(jc.model.clip.image_size), sj, st))
    r["eos"] = pick_eos(r)
    return r


def drafts(r, kind):
    """(JAX draft params, port draft params, JAX draft config, port draft
    config) of each kind."""
    jm, tm = r["jc"].model, r["tc"].model
    if kind == "identical":
        return r["p_j"], r["p_t"], None, None
    if kind == "random":
        return r["random"]["p_j"], r["random"]["p_t"], None, None
    if kind in ("int8", "int4"):
        bits = int(kind[3:])
        return (jspec.make_draft_params(r["p_j"], jm, bits=bits),
                tspec.make_draft_params(r["p_t"], tm, bits=bits), None, None)
    if kind == "layerskip":
        dj, dcj = jspec.make_layerskip_draft(r["p_j"], jm, 1)
        dt, dct = tspec.make_layerskip_draft(r["p_t"], tm, 1)
        assert dt["llm"]["layers"][0] is r["p_t"]["llm"]["layers"][0]
        assert dct.llm.n_layers == 1
        return dj, dt, dcj, dct
    s = r["small"]
    return s["p_j"], s["p_t"], s["jc"].model, s["tc"].model


@pytest.mark.parametrize("kind,gamma,n", [
    ("identical", 4, 10), ("identical", 4, 1), ("random", 4, 10), ("int8", 1, 10),
    ("int8", 4, 10), ("int4", 8, 10), ("layerskip", 4, 10), ("separate", 4, 10)])
def test_greedy_speculative_is_lossless(tiny, kind, gamma, n):
    r = tiny
    dj, dt, dcj, dct = drafts(r, kind)
    greedy = tgen.generate_tokens(r["p_t"], r["tc"].model, r["b_t"],
                                  max_new_tokens=n, eos_id=r["eos"])
    out_t, st = tspec.speculative_generate(
        r["p_t"], dt, r["tc"].model, r["b_t"], gamma=gamma, max_new_tokens=n,
        eos_id=r["eos"], draft_model_cfg=dct, return_stats=True)
    out_j, sj = jspec.speculative_generate(
        r["p_j"], dj, r["jc"].model, r["b_j"], gamma=gamma, max_new_tokens=n,
        eos_id=r["eos"], use_pallas="never", draft_model_cfg=dcj, return_stats=True)
    for out in (greedy, out_j):
        np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out.tokens))
        np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out.lengths))
    if kind in ("identical", "random"):      # the same proposals on both sides
        assert st["verify_passes"] == int(sj["verify_passes"])
        np.testing.assert_allclose(st["tokens_per_pass"], float(sj["tokens_per_pass"]),
                                   rtol=1e-6)
    if n == 1:
        assert st["verify_passes"] == 0 and out_t.lengths.max() <= 1


def test_rejection_apply_equals_jax_given_its_draws():
    B, G, V = 64, 3, 12
    rng = np.random.default_rng(3)
    p = rng.dirichlet(np.ones(V) * 0.5, (B, G + 1)).astype(np.float32)
    q = rng.dirichlet(np.ones(V) * 0.5, (B, G)).astype(np.float32)
    q[:8] = p[:8, :G]                          # p == q rows: the residual is p
    drafts = rng.integers(0, V, (B, G)).astype(np.int32)
    for seed in range(3):
        key = jax.random.key(seed)
        m_j, cand_j = jspec._rejection_step(jnp.asarray(drafts), jnp.asarray(q),
                                            jnp.asarray(p), key)
        ku, kr = jax.random.split(key)
        u = np.asarray(jax.random.uniform(ku, (B, G)))
        g = np.asarray(jax.random.gumbel(kr, (B, V)))
        m_t, cand_t = tspec.rejection_apply(torch.from_numpy(drafts).long(),
                                            torch.from_numpy(q), torch.from_numpy(p),
                                            torch.from_numpy(u), torch.from_numpy(g))
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
        np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
        assert 0 < (m_t.numpy() == G).sum() < B      # both outcomes occur


def test_rejection_step_is_exactly_target_distributed():
    """The first emitted token of the port's draws and apply follows p,
    not q, for a fixed (p, q) over a small vocabulary."""
    V, G, N = 12, 3, 30_000
    gen = torch.Generator().manual_seed(7)
    p1 = torch.softmax(2.0 * torch.randn(V, generator=gen), -1)
    q1 = torch.softmax(2.0 * torch.randn(V, generator=gen), -1)
    p, q = p1.expand(N, G + 1, V), q1.expand(N, G, V)
    drafts = torch.multinomial(q1, N * G, replacement=True, generator=gen).reshape(N, G)
    u, g = tspec.rejection_draws(N, G, V, gen, torch.device("cpu"))
    _, cand = tspec.rejection_apply(drafts, q, p, u, g)
    emp = torch.bincount(cand[:, 0], minlength=V).double() / N
    assert (emp - p1.double()).abs().sum() < 0.03
    assert (emp - q1.double()).abs().sum() > 0.05


def test_sampled_speculative_is_reproducible(tiny):
    r = tiny
    dt = tspec.make_draft_params(r["p_t"], r["tc"].model, bits=8)

    def run(seed):
        return tspec.speculative_generate(
            r["p_t"], dt, r["tc"].model, r["b_t"], gamma=3, max_new_tokens=10,
            eos_id=r["eos"], temperature=0.8, top_p=0.9,
            generator=torch.Generator().manual_seed(seed)).tokens

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(((a >= 0) & (a < r["tc"].model.llm.vocab_size)).all())


@pytest.mark.parametrize("bits,gamma,layers", [(8, 4, 0), (4, 4, 0), (8, 4, 1),
                                               (4, 8, 1), (8, 1, 0)])
def test_break_even_tokens_per_pass_equals_jax(tiny, bits, gamma, layers):
    np.testing.assert_allclose(
        tspec.break_even_tokens_per_pass(tiny["tc"].model, bits=bits, gamma=gamma,
                                         draft_layers=layers),
        jspec.break_even_tokens_per_pass(tiny["jc"].model, bits=bits, gamma=gamma,
                                         draft_layers=layers), rtol=1e-12)


@pytest.mark.parametrize("batch", [8, 1])
def test_decode_cli_warns_as_jax_does(caplog, batch):
    over = {"decode.speculative": True, "decode.batch_size": batch}
    jc = jload_config(TINY_YAML, over)
    tc = tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in over.items()])
    with caplog.at_level(logging.INFO):
        jdecode._warn_if_speculative_loses(jc)
        tdecode._warn_if_speculative_loses(tc)
    msgs = {name: [(r.levelno, r.getMessage()) for r in caplog.records if r.name == name]
            for name in ("avsr.cli.decode", "avsr_tpu_torch.cli.decode")}
    assert msgs["avsr.cli.decode"] == msgs["avsr_tpu_torch.cli.decode"]
    want = "MEASURED LOSS" if batch >= 4 else "trained draft"
    assert any(want in m and lvl == logging.WARNING
               for lvl, m in msgs["avsr_tpu_torch.cli.decode"])


@pytest.mark.parametrize("over", [
    {"decode.spec_draft_checkpoint": "/x", "decode.spec_draft_config": "/x/c.yaml"},
    {"decode.speculative": True, "decode.num_beams": 3},
    {"decode.speculative": True, "model.use_4bit": True},
    {"decode.speculative": True, "decode.spec_draft_bits": 6},
    {"decode.speculative": True, "decode.spec_gamma": 0},
    {"decode.speculative": True, "decode.spec_draft_layers": 1},
    {"decode.speculative": True, "decode.kv_cache_dtype": "int8"},
    {"decode.speculative": True, "decode.engine_slots": 2, "decode.temperature": 0.5},
    {"decode.speculative": True, "decode.spec_draft_checkpoint": "/x"},
    {"decode.speculative": True, "model.llm.n_layers": 2,
     "decode.spec_draft_checkpoint": "/x", "decode.spec_draft_config": "/x/c.yaml",
     "decode.spec_draft_layers": 1},
    {"decode.speculative": True, "decode.spec_draft_checkpoint": "/x",
     "decode.spec_draft_config": "/x/c.yaml", "decode.engine_slots": 2},
], ids=["draft_without_speculative", "beams", "quantized_target", "bits", "gamma",
        "layers_range", "int8_cache", "engine_sampling", "checkpoint_alone",
        "checkpoint_and_layers", "checkpoint_engine"])
def test_validation_errors_match_jax(over):
    with pytest.raises(ValueError) as ej:
        jload_config(TINY_YAML, over)
    with pytest.raises(ValueError) as et:
        tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in over.items()])
    assert str(et.value) == str(ej.value)


def test_make_draft_params_refuses_fused_or_quantized(tiny):
    tm = tiny["tc"].model
    fused = tgen.prepare_params_for_decode(tiny["p_t"], tm)
    with pytest.raises(ValueError, match="raw params tree"):
        tspec.make_draft_params(fused, tm)
    draft = tspec.make_draft_params(tiny["p_t"], tm, bits=8)
    with pytest.raises(ValueError, match="unquantized"):
        tspec.make_draft_params({**draft, "llm": {**draft["llm"], "layers": [
            {"o": layer["o"]} for layer in draft["llm"]["layers"]]}}, tm)
    with pytest.raises(ValueError, match="n_layers must be in"):
        tspec.make_layerskip_draft(tiny["p_t"], tm, 2)


def _hyps(out_dir) -> list[str]:
    res = next(out_dir.glob("results_*.txt")).read_text()
    return sorted(line for line in res.splitlines() if line.startswith("HYP"))


@pytest.mark.parametrize("extra", [
    ["decode.speculative=true"],
    ["decode.speculative=true", "decode.spec_draft_bits=4", "decode.spec_gamma=2"],
    ["decode.speculative=true", "decode.spec_draft_layers=1"],
], ids=["self_int8", "self_int4", "layerskip"])
def test_decode_cli_speculative_equals_greedy(tmp_path, extra):
    common = ["--config", str(TINY_YAML), "--device", "cpu", "--seed", "1",
              "model.modality=both", "model.llm.n_layers=2", "data.synthetic=true",
              "decode.max_new_tokens=8"]
    assert tdecode.main([*common, f"decode.output_dir={tmp_path / 'g'}"]) == 0
    assert tdecode.main([*common, *extra, f"decode.output_dir={tmp_path / 's'}"]) == 0
    assert _hyps(tmp_path / "g") == _hyps(tmp_path / "s")


@pytest.mark.parametrize("extra", [
    ["decode.engine_slots=3"],
    ["decode.engine_slots=3", "decode.speculative=true", "decode.spec_gamma=2"],
    ["decode.engine_slots=3", "decode.speculative=true", "decode.spec_gamma=2",
     "decode.spec_draft_layers=1"],
], ids=["engine", "engine_spec", "engine_layerskip"])
def test_decode_cli_engine_matches_static(tmp_path, extra):
    """The counterpart of JAX's ``test_cli_decode_engine_matches_static``
    (and of its speculative-engine case): the decode CLI through the
    serving engine writes the HYP lines of the static batches."""
    common = ["--config", str(TINY_YAML), "--device", "cpu", "--seed", "1",
              "--split", "train", "model.modality=both", "model.llm.n_layers=2",
              "data.synthetic=true", "decode.max_new_tokens=6"]
    assert tdecode.main([*common, f"decode.output_dir={tmp_path / 'static'}"]) == 0
    assert tdecode.main([*common, *extra, f"decode.output_dir={tmp_path / 'eng'}"]) == 0
    assert _hyps(tmp_path / "static") == _hyps(tmp_path / "eng")
    assert len(_hyps(tmp_path / "eng")) == 8


@pytest.mark.parametrize("over", ["model.llm.moe_experts=4", "model.connector_type=moe",
                                  "data.compact_transfer=true"])
def test_engine_path_refuses_moe_and_the_compact_link(tmp_path, over):
    """MoE (the LLM's blocks, the connector) and the compact link format are
    ported: the engine path of the decode CLI decodes with each and gives
    the static path's HYP lines (MoE's own decode tests:
    test_torch_moe_llm.py)."""
    common = ["--config", str(TINY_YAML), "--device", "cpu", "data.synthetic=true", over]
    assert tdecode.main([*common, f"decode.output_dir={tmp_path / 'static'}"]) == 0
    assert tdecode.main([*common, "decode.engine_slots=2",
                         f"decode.output_dir={tmp_path / 'eng'}"]) == 0
    assert _hyps(tmp_path / "static") == _hyps(tmp_path / "eng")
    assert len(_hyps(tmp_path / "eng")) == 2


@pytest.mark.parametrize("bits", [8, 4])
def test_draft_head_leaves_are_contiguous(bits):
    """A tied head is quantized from the transposed embedding; with a
    vocabulary that needs no padding (4096) no copy made it contiguous,
    and the card's qmatmul refuses strided leaves (found on the H100 by
    ``test_split_decode_step_kernel_path_matches_dequantize_path``)."""
    from avsr_tpu_torch.core.config import LLMConfig
    from avsr_tpu_torch.models import llama as tllama
    from avsr_tpu_torch.ops import quant as tquant

    cfg = LLMConfig(vocab_size=4096, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
                    ffn_dim=64)
    llm = tllama.init_llama(torch.Generator().manual_seed(0), cfg)
    q = tquant.quantize_llm(llm, bits, lm_head_bits=bits)
    leaves = [q["lm_head"]] + [n for n in q["layers"][0].values() if tquant.is_quantized(n)]
    assert len(leaves) == 8
    assert all(t.is_contiguous() for node in leaves for t in node.values())
    np.testing.assert_array_equal(
        tquant.dequantize(q["lm_head"], torch.float32).numpy(),
        tquant.dequantize(tquant.quantize_tensor(llm["embed"].T.contiguous(), bits),
                          torch.float32).numpy())
