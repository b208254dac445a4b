"""The LLM's MoE FFN blocks (``llm.moe_experts``) and MoE through every
decode path of the port vs the JAX package (f32, CPU), the counterparts of
``tests/test_moe_llm.py``'s single-device cases and of
``tests/test_engine.py::test_engine_moe_token_exact`` (the ``ep`` mesh
case runs across processes in ``tests/test_torch_ep.py``).

Weights come from the JAX init through ``convert.from_numpy_tree``. The
decode paths run tiny_cpu.yaml with modality both, a 2-layer LLM and an
untied head (``test_torch_beam.py``'s model) with BOTH forms: the ``moe``
connector and MoE LLM blocks, 4 experts, top-2, and the capacity factors
at 0.25 (``SQUEEZE``) so that the bounded capacities really drop tokens.
Tolerances: llama_apply's logits and the decode step's 1e-4 atol/rtol
(``TOL``), aux losses 1e-5 relative, gradients ||g - g_jax|| <= 1e-4
||g_jax|| per leaf; remat against no remat, and the composition and
padding independence of the inference routings, exactly; tokens and HYP
lines exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.cli import convert_hf as jconvert
from avsr_tpu.core import config as jcfg
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.infer import engine as jengine
from avsr_tpu.infer import speculative as jspec
from avsr_tpu.models import avsr as javsr
from avsr_tpu.models import llama as jllama
from avsr_tpu.ops import quant as jquant
from avsr_tpu.train import state as jstate
from avsr_tpu.train import step as jstep
from avsr_tpu_torch.cli import convert_hf as tconvert
from avsr_tpu_torch.cli import decode as tdecode
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.infer import engine as tengine
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.infer import speculative as tspec
from avsr_tpu_torch.models import llama as tllama
from avsr_tpu_torch.ops import quant as tquant
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep

from test_torch_beam import configs as beam_configs
from test_torch_beam import jgen, np_batch, pair, pick_eos
from test_torch_convert_hf import _compare, _over, _paths, hf_dirs  # noqa: F401 (fixture)
from test_torch_engine import Tok, ref_j, ref_t, samples
from test_torch_engine import configs as engine_configs
from test_torch_engine import model as engine_model
from test_torch_models import TOL, np_tree, randomize_lora_b, to_port_cfg
from test_torch_speculative import TINY_YAML, _hyps
from test_torch_streaming import noise, replace
from test_torch_streaming import run_both as stream_both
from test_torch_train import configs as train_configs
from test_torch_train import jax_paths, jbatch, port_paths, rel_dist, tbatch
from test_torch_train import np_batch as train_batch

torch.set_num_threads(1)

GRAD_TOL = 1e-4
JLLM = jcfg.LLMConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                      ffn_dim=64, max_seq_len=128, moe_experts=4, moe_topk=2)
# both MoE forms, each capacity squeezed so that the bounded routings drop tokens
BOTH = {"model.connector_type": "moe", "model.moe_experts": 4, "model.moe_topk": 2,
        "model.llm.moe_experts": 4, "model.llm.moe_topk": 2}
SQUEEZE = {"model.moe_capacity_factor": 0.25, "model.llm.moe_capacity_factor": 0.25}


def llm_pair(jcfg_llm, seed=1):
    """(JAX params, port params, port config) of one LLM init, perturbed
    so that the norm scales matter."""
    p = np_tree(jllama.init_llama(jax.random.key(seed), jcfg_llm))
    rng = np.random.default_rng(seed)
    for layer in p["layers"]:
        layer["ln_mlp"]["scale"] = rng.uniform(0.5, 1.5, jcfg_llm.d_model).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, p), from_numpy_tree(p, "cpu"),
            to_port_cfg(jcfg_llm, tcfg.LLMConfig))


# ---------------------------------------------------------------------------
# the LLM's MoE blocks
# ---------------------------------------------------------------------------

def test_init_tree_and_interleave_match_jax():
    cfg = dataclasses.replace(JLLM, n_layers=4, moe_every=2)
    tc = to_port_cfg(cfg, tcfg.LLMConfig)
    p_j = np_tree(jllama.init_llama(jax.random.key(0), cfg))
    p_t = tllama.init_llama(torch.Generator().manual_seed(0), tc)
    assert [jllama.is_moe_layer(cfg, i) for i in range(4)] == \
        [tllama.is_moe_layer(tc, i) for i in range(4)] == [False, True, False, True]
    got, want = port_paths(p_t), jax_paths(p_j)
    assert got.keys() == want.keys()
    assert list(p_t["layers"][1]) == ["ln_attn", "q", "k", "v", "o", "ln_mlp", "router",
                                      "experts"]           # JAX's order
    assert list(p_t["layers"][1]["experts"]) == ["w_gate", "w_up", "w_down"]
    assert all(tuple(got[k].shape) == want[k].shape for k in want)
    assert "gateup" not in tllama.fuse_decode_layout(p_t)["layers"][1]
    lora = tcfg.LoRAConfig(use_lora=True, r=2, target_modules=("q_proj", "gate_proj"))
    with_lora = tllama.add_lora(torch.Generator().manual_seed(1), p_t, tc, lora)
    assert "lora" in with_lora["layers"][0]["gate"]
    assert "gate" not in with_lora["layers"][1] and "lora" in with_lora["layers"][1]["q"]


def test_single_expert_matches_dense():
    """E=1, topk=1, generous capacity: the MoE blocks equal dense blocks
    built from expert 0's weights, in the port and in JAX; lb is 1.0."""
    dense_cfg = dataclasses.replace(JLLM, moe_experts=0)
    moe_cfg = dataclasses.replace(JLLM, moe_experts=1, moe_topk=1, moe_capacity_factor=4.0)
    dense = np_tree(jllama.init_llama(jax.random.key(0), dense_cfg))
    moe = {**dense, "layers": []}
    for layer in dense["layers"]:
        nl = {k: v for k, v in layer.items() if k not in ("gate", "up", "down")}
        nl["router"] = {"w": np.zeros((dense_cfg.d_model, 1), np.float32)}
        nl["experts"] = {"w_gate": layer["gate"]["w"][None], "w_up": layer["up"]["w"][None],
                         "w_down": layer["down"]["w"][None]}
        moe["layers"].append(nl)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((2, 12, 32)).astype(np.float32)
    lens = np.array([12, 7], np.int32)
    ref, _ = tllama.llama_apply(from_numpy_tree(dense, "cpu"),
                                to_port_cfg(dense_cfg, tcfg.LLMConfig),
                                inputs_embeds=torch.from_numpy(emb),
                                lengths=torch.from_numpy(lens))
    got, _, aux = tllama.llama_apply(from_numpy_tree(moe, "cpu"),
                                     to_port_cfg(moe_cfg, tcfg.LLMConfig),
                                     inputs_embeds=torch.from_numpy(emb),
                                     lengths=torch.from_numpy(lens), return_aux=True)
    got_j, _, aux_j = jllama.llama_apply(jax.tree_util.tree_map(jnp.asarray, moe), moe_cfg,
                                         inputs_embeds=jnp.asarray(emb),
                                         lengths=jnp.asarray(lens), use_pallas="never",
                                         return_aux=True)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n].numpy(), ref[b, :n].numpy(),
                                   atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(got_j), **TOL)
    assert aux["moe_lb"].item() == pytest.approx(1.0, rel=1e-5)
    assert aux["moe_lb"].item() == pytest.approx(float(aux_j["moe_lb"]), rel=1e-5)


@pytest.mark.parametrize("rowwise", [False, True], ids=["train", "rowwise"])
@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_llama_apply_matches_jax(rowwise, factor):
    """Logits and aux losses with ragged lengths, in the flattened training
    routing and the row-wise prefill routing, generous and squeezed."""
    cfg = dataclasses.replace(JLLM, moe_capacity_factor=factor)
    p_j, p_t, tc = llm_pair(cfg)
    emb = np.random.default_rng(1).standard_normal((3, 16, 32)).astype(np.float32)
    lens = np.array([16, 11, 4], np.int32)
    out_j, _, aux_j = jllama.llama_apply(p_j, cfg, inputs_embeds=jnp.asarray(emb),
                                         lengths=jnp.asarray(lens), use_pallas="never",
                                         return_aux=True, moe_rowwise=rowwise)
    out_t, _, aux_t = tllama.llama_apply(p_t, tc, inputs_embeds=torch.from_numpy(emb),
                                         lengths=torch.from_numpy(lens), return_aux=True,
                                         moe_rowwise=rowwise)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(out_t[b, :n].numpy(), np.asarray(out_j)[b, :n], **TOL)
    for k in ("moe_lb", "moe_z"):
        assert aux_t[k].item() == pytest.approx(float(aux_j[k]), rel=1e-5)


def test_remat_keeps_the_aux_losses_and_their_gradients():
    """A remat forward's moe_lb / moe_z and every gradient (the routers'
    included, which reach them only through the aux) equal the forward
    without remat bit for bit, and JAX's within the tolerance."""
    cfg = dataclasses.replace(JLLM, moe_every=2, moe_capacity_factor=0.5)
    p_j, p_t, tc = llm_pair(cfg, seed=3)
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((2, 12, 32)).astype(np.float32)
    lens = np.array([12, 9], np.int32)
    w = rng.standard_normal((2, 12, cfg.vocab_size)).astype(np.float32)

    def port(remat):
        leaves = port_paths(p_t)
        for t in leaves.values():
            t.requires_grad_(True)
        out, _, aux = tllama.llama_apply(p_t, tc, inputs_embeds=torch.from_numpy(emb),
                                         lengths=torch.from_numpy(lens), remat=remat,
                                         return_aux=True)
        loss = (out * torch.from_numpy(w)).sum() + aux["moe_lb"] + aux["moe_z"]
        return aux, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    aux0, g0 = port(False)
    aux1, g1 = port(True)
    for k in ("moe_lb", "moe_z"):
        assert torch.equal(aux0[k], aux1[k])
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert g1[("layers", "1", "router", "w")].abs().sum() > 0

    def jloss(p):
        out, _, aux = jllama.llama_apply(p, cfg, inputs_embeds=jnp.asarray(emb),
                                         lengths=jnp.asarray(lens), use_pallas="never",
                                         remat=True, return_aux=True)
        return jnp.sum(out * w) + aux["moe_lb"] + aux["moe_z"]

    g_j = jax_paths(jax.grad(jloss)(p_j))
    for path, g in g1.items():
        assert rel_dist(g.numpy(), g_j[path]) <= GRAD_TOL, path


def test_moe_decode_step_matches_full_forward():
    """A KV-cache decode step through MoE blocks (dropless routing) equals
    the teacher-forced logits, and JAX's step."""
    p_j, p_t, tc = llm_pair(JLLM)
    rng = np.random.default_rng(3)
    B, T = 2, 8
    tokens = rng.integers(0, JLLM.vocab_size, (B, T))
    nxt = rng.integers(0, JLLM.vocab_size, (B, 1))
    _, cache = tllama.llama_apply(p_t, tc, inputs_embeds=tllama.embed_tokens(
        p_t, torch.from_numpy(tokens)), return_cache=True, cache_len=16, moe_rowwise=True)
    step, _ = tllama.llama_decode_step(p_t, tc, x=tllama.embed_tokens(
        p_t, torch.from_numpy(nxt)), cache=cache, cur_lens=torch.full((B,), T))
    full, _ = tllama.llama_apply(p_t, tc, inputs_embeds=tllama.embed_tokens(
        p_t, torch.from_numpy(np.concatenate([tokens, nxt], 1))))
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(), atol=3e-4, rtol=3e-3)
    _, cache_j = jllama.llama_apply(p_j, JLLM, inputs_embeds=jllama.embed_tokens(
        p_j, jnp.asarray(tokens)), return_cache=True, cache_len=16, use_pallas="never",
        moe_rowwise=True)
    step_j, _ = jllama.llama_decode_step(p_j, JLLM, x=jllama.embed_tokens(
        p_j, jnp.asarray(nxt)), cache=cache_j, cur_lens=jnp.full((B,), T))
    np.testing.assert_allclose(step.numpy(), np.asarray(step_j), **TOL)


def test_moe_dropless_composition_independent():
    """The dropless capacity makes a token's output independent of what
    else shares the call; the bounded capacity at 0.25 does drop tokens
    here (else the first check would be vacuous). Both as in JAX."""
    cfg = dataclasses.replace(JLLM, moe_capacity_factor=0.25)
    p_j, p_t, tc = llm_pair(cfg)
    layer_t = next(lay for lay in p_t["layers"] if "experts" in lay)
    layer_j = next(lay for lay in p_j["layers"] if "experts" in lay)
    h = np.random.default_rng(4).standard_normal((4, 8, 32)).astype(np.float32)
    solo, _, _ = tllama._moe_mlp(layer_t, torch.from_numpy(h[:1]), tc, dropless=True)
    batched, _, _ = tllama._moe_mlp(layer_t, torch.from_numpy(h), tc, dropless=True)
    assert torch.equal(batched[:1], solo)
    capped, _, _ = tllama._moe_mlp(layer_t, torch.from_numpy(h), tc)
    assert not np.allclose(capped.numpy(), batched.numpy(), atol=1e-5)
    for dropless, got in ((True, batched), (False, capped)):
        want, _, _ = jllama._moe_mlp(layer_j, jnp.asarray(h), cfg, dropless=dropless)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_rowwise_padding_independent():
    """Row-wise routing drops the same tokens however far the row is
    padded (the cutoff comes from the valid length); the squeeze really
    drops tokens for this row (a generous capacity differs). As in JAX."""
    cfg = dataclasses.replace(JLLM, moe_capacity_factor=0.25)
    p_j, p_t, tc = llm_pair(cfg)
    layer_t = next(lay for lay in p_t["layers"] if "experts" in lay)
    layer_j = next(lay for lay in p_j["layers"] if "experts" in lay)
    nv = 24
    h = np.random.default_rng(5).standard_normal((1, nv, 32)).astype(np.float32)

    def padded(T):
        hp = np.zeros((1, T, 32), np.float32)
        hp[:, :nv] = h
        valid = np.arange(T)[None, :] < nv
        y, _, _ = tllama._moe_mlp(layer_t, torch.from_numpy(hp), tc,
                                  valid=torch.from_numpy(valid), rowwise=True)
        y_j, _, _ = jllama._moe_mlp(layer_j, jnp.asarray(hp), cfg, valid=jnp.asarray(valid),
                                    rowwise=True)
        np.testing.assert_allclose(y[:, :nv].numpy(), np.asarray(y_j)[:, :nv], **TOL)
        return y[:, :nv]

    short, long = padded(32), padded(96)
    assert torch.equal(long, short)
    free, _, _ = tllama._moe_mlp(layer_t, torch.from_numpy(h),
                                 dataclasses.replace(tc, moe_capacity_factor=4.0),
                                 valid=torch.ones((1, nv), dtype=torch.bool), rowwise=True)
    assert not np.allclose(free.numpy(), short.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_interleave_train_steps_match_jax(remat):
    """moe_every=2 (block 0 dense, block 1 MoE), the LLM unfrozen, and the
    moe connector: two train steps of 2 micro-batches each, whose loss,
    moe_lb and moe_z (summed with the micro-batch weights), grad norm and
    updated parameters equal JAX's; the experts and routers train, and the
    LLM's stay frozen under freeze_llm."""
    over = {**BOTH, "model.llm.moe_every": 2, "model.freeze_llm": False,
            "mesh.remat": remat, "training.grad_accum_steps": 2}
    jc, tc = train_configs(**over)
    assert tllama.is_moe_layer(tc.model.llm, 1) and not tllama.is_moe_layer(tc.model.llm, 0)
    weights = randomize_lora_b(np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model)),
                               seed=3)
    assert "experts" in weights["llm"]["layers"][1] and "gate" in weights["llm"]["layers"][0]
    state_j, tx = jstate.create_train_state(jax.tree_util.tree_map(jnp.asarray, weights),
                                            jc, 10)
    step_j = jstep.make_train_step(jc, tx)
    p_t = tstate.cast_frozen(from_numpy_tree(weights, "cpu"), tc.model, torch.float32)
    state_t = tstate.create_train_state(p_t, tc, 10)
    step_t = tstep.make_train_step(tc)
    before = {k: v.clone() for k, v in port_paths(p_t).items()}
    for i in range(2):
        b = train_batch(i)
        state_j, m_j = step_j(state_j, jstep.microbatch(jbatch(b), 2), jax.random.key(i))
        m_t = step_t(state_t, tstep.microbatch(tbatch(b), 2), i)
        for k in ("loss", "moe_lb", "moe_z"):
            np.testing.assert_allclose(m_t[k], float(m_j[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(m_t["grad_norm"], float(m_j["grad_norm"]), rtol=1e-4)
    after_j = jax_paths(state_j.params)
    for path, leaf in port_paths(state_t.params).items():
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(after_j[path]),
                                   atol=1e-5, rtol=1e-5, err_msg=str(path))
    moved = port_paths(state_t.params)
    for path in (("llm", "layers", "1", "experts", "w_gate"), ("llm", "layers", "1", "router", "w"),
                 ("audio_connector", "blocks", "0", "experts", "w1")):
        assert not torch.equal(moved[path], before[path]), path
    frozen = dataclasses.replace(tc.model, freeze_llm=True)
    mask = port_paths(tstate.trainable_mask(p_t, frozen))
    assert not mask[("llm", "layers", "1", "experts", "w_gate")]
    assert mask[("video_connector", "blocks", "1", "router", "w")]
    assert mask == jax_paths(jstate.trainable_mask(jax.tree_util.tree_map(jnp.asarray, weights),
                                                   dataclasses.replace(jc.model,
                                                                       freeze_llm=True)))
    cast = port_paths(tstate.cast_frozen(p_t, frozen, torch.bfloat16))
    assert cast[("llm", "layers", "1", "experts", "w_up")].dtype == torch.bfloat16
    assert cast[("audio_connector", "blocks", "0", "experts", "w2")].dtype == torch.float32


def test_train_cli_logs_moe_metrics(tmp_path):
    """The train CLI with both MoE forms runs its steps with finite losses."""
    run = tmp_path / "run"
    assert tcli_train.main(["--config", str(TINY_YAML), "--device", "cpu", "--seed", "0",
                            *[f"{k}={v}" for k, v in BOTH.items()],
                            "model.llm.n_layers=2", "training.max_steps=2",
                            f"training.checkpoint_dir={run}"]) == 0
    rows = [r.split(",") for r in (run / "loss_log.csv").read_text().splitlines()[1:]]
    train = [r for r in rows if r[2] == "train"]
    assert len(train) == 2 and all(np.isfinite(float(r[3])) for r in train)


# ---------------------------------------------------------------------------
# decoding: both forms, squeezed capacities
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jc, tc = beam_configs(**BOTH, **SQUEEZE)
    params = np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model))
    randomize_lora_b(params, seed=2)
    r = pair(params, np_batch(jc.model.clip.image_size), jc, tc)
    r["eos"] = pick_eos(r)
    return r


@pytest.mark.parametrize("kind", ["f32", "preset"])
def test_generate_tokens_matches_jax(tiny, kind):
    """Greedy generate_tokens token for token JAX's, in f32 and with the
    serving preset (int4 projections, int8 head and cache: the routers and
    experts stay float, and a MoE block makes 2 quantized products)."""
    r = tiny
    p_j, p_t, kw = r["p_j"], r["p_t"], {}
    if kind == "preset":
        p_j = jgen.prepare_params_for_decode(
            dict(p_j, llm=jquant.quantize_llm(p_j["llm"], 4)), r["jc"].model, lm_head_bits=8)
        p_t = tgen.prepare_params_for_decode(
            dict(p_t, llm=tquant.quantize_llm(p_t["llm"], 4)), r["tc"].model, lm_head_bits=8)
        moe_layer = p_t["llm"]["layers"][0]
        assert sorted(k for k, v in moe_layer.items() if tquant.is_quantized(v)) == ["o", "qkv"]
        assert moe_layer["experts"]["w_gate"].dtype == torch.float32
        kw = dict(kv_cache_dtype="int8")
    out_t = tgen.generate_tokens(p_t, r["tc"].model, r["b_t"], max_new_tokens=10,
                                 eos_id=r["eos"], **kw)
    out_j = jgen.generate_tokens(p_j, r["jc"].model, r["b_j"], max_new_tokens=10,
                                 eos_id=r["eos"], use_pallas="never", **kw)
    np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out_j.tokens))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))


def test_quantize_llm_leaves_routers_and_experts_float(tiny):
    """quantize_llm quantizes the projections JAX's does, leaf for leaf, and
    leaves every router and expert stack as it was."""
    for bits in (8, 4):
        q_j = jax_paths(jquant.quantize_llm(tiny["p_j"]["llm"], bits, lm_head_bits=8))
        q_t = port_paths(tquant.quantize_llm(tiny["p_t"]["llm"], bits, lm_head_bits=8))
        assert q_t.keys() == q_j.keys()
        for k, v in q_t.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(q_j[k]), err_msg=str(k))
            if "experts" in k or "router" in k:
                assert v.dtype == torch.float32
        assert ("layers", "0", "q", "qw4h" if bits == 4 else "qw") in q_t


@pytest.mark.parametrize("W", [3, 1])
def test_beam_search_matches_jax(tiny, W):
    r = tiny
    kw = dict(max_new_tokens=6, num_beams=W, eos_id=r["eos"])
    out_t = tgen.beam_search(r["p_t"], r["tc"].model, r["b_t"], **kw)
    out_j = jgen.beam_search(r["p_j"], r["jc"].model, r["b_j"], use_pallas="never", **kw)
    np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out_j.tokens))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))


@pytest.mark.parametrize("kind", ["int8", "int4", "layerskip"])
def test_speculative_is_lossless_and_matches_jax(tiny, kind):
    """Speculative decoding over a MoE target (the row-wise prefill, the
    dropless verify pass and draft steps) equals greedy and JAX's, with
    the quantized self-drafts and the layer-skip draft over MoE blocks."""
    r = tiny
    jm, tm = r["jc"].model, r["tc"].model
    dcj = dct = None
    if kind == "layerskip":
        dj, dcj = jspec.make_layerskip_draft(r["p_j"], jm, 1)
        dt, dct = tspec.make_layerskip_draft(r["p_t"], tm, 1)
    else:
        bits = int(kind[3:])
        dj = jspec.make_draft_params(r["p_j"], jm, bits=bits)
        dt = tspec.make_draft_params(r["p_t"], tm, bits=bits)
        assert "experts" in dt["llm"]["layers"][0]
    greedy = tgen.generate_tokens(r["p_t"], tm, r["b_t"], max_new_tokens=10, eos_id=r["eos"])
    out_t = tspec.speculative_generate(r["p_t"], dt, tm, r["b_t"], gamma=3, max_new_tokens=10,
                                       eos_id=r["eos"], draft_model_cfg=dct)
    out_j = jspec.speculative_generate(r["p_j"], dj, jm, r["b_j"], gamma=3, max_new_tokens=10,
                                       eos_id=r["eos"], use_pallas="never",
                                       draft_model_cfg=dcj)
    for out in (greedy, out_j):
        np.testing.assert_array_equal(out_t.tokens.numpy(), np.asarray(out.tokens))


# ---------------------------------------------------------------------------
# serving: the engine, speculative slots, streaming, the decode CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_moe():
    """tiny_cpu.yaml (audio, 2-layer LLM, untied head) with both forms and
    the squeezed capacities, as JAX's test_engine_moe_token_exact."""
    jc, tc = engine_configs(**BOTH, **SQUEEZE)
    p_j, p_t = engine_model(jc)
    return dict(jc=jc, tc=tc, p_j=p_j, p_t=p_t, tok=Tok())


def test_engine_moe_token_exact(engine_moe):
    """Staged (batched) encode and prefill and chunked decode with mixed
    length buckets (samples 0 and 1 stage together at bucket 200, sample 0
    alone pads to 100): every request equals the port's and JAX's
    standalone generate_tokens, and JAX's engine."""
    m = engine_moe
    ts, js = samples([4800, 24000, 8000, 6400], seed=3)
    eng = tengine.ServingEngine(m["p_t"], m["tc"], m["tok"], num_slots=2, max_new_tokens=5,
                                k_steps=2)
    try:
        got = eng.transcribe(ts)
    finally:
        eng.close()
    jeng = jengine.ServingEngine(m["p_j"], m["jc"], m["tok"], num_slots=2, max_new_tokens=5,
                                 k_steps=2)
    assert got == jeng.transcribe(js)
    for i, (t, j) in enumerate(zip(ts, js)):
        want = ref_t(m["p_t"], m["tc"], m["tok"], t, 5)
        assert got[i] == want == ref_j(m["p_j"], m["jc"], m["tok"], j, 5), i


def test_engine_speculative_slots_token_exact(engine_moe):
    """Speculative slots (int8 self-draft, one [S, gamma+1] dropless verify
    pass a round) over MoE: every request equals standalone greedy."""
    m = engine_moe
    ts, _ = samples([4800, 16000, 8000], seed=4)
    draft = tspec.make_draft_params(m["p_t"], m["tc"].model, bits=8)
    eng = tengine.ServingEngine(m["p_t"], m["tc"], m["tok"], num_slots=2, max_new_tokens=6,
                                k_steps=3, draft_params=draft, spec_gamma=3, spec_rounds=2)
    try:
        got = eng.transcribe(ts)
    finally:
        eng.close()
    for i, s in enumerate(ts):
        assert got[i] == ref_t(m["p_t"], m["tc"], m["tok"], s, 6), i


@pytest.mark.parametrize("block_s", [0.0, 0.2], ids=["exact", "blockwise"])
def test_streaming_matches_jax(engine_moe, block_s):
    """Streaming transcription over MoE (the row-wise encode; blockwise:
    frozen blocks through the dropless prefill_extend) commits JAX's
    tokens at every feed."""
    m = engine_moe
    jc, tc = replace(m["jc"], m["tc"], "decode", stream_block_s=block_s, max_new_tokens=6)
    audio = noise(12800, 5)
    st = stream_both(m, [dict(audio=audio[i * 3200:(i + 1) * 3200]) for i in range(4)],
                     agree_n=2, jc=jc, tc=tc)
    assert st.committed_tokens is not None


@pytest.mark.parametrize("extra", [[], ["decode.speculative=true", "decode.spec_gamma=2"]],
                         ids=["engine", "engine_spec"])
def test_decode_cli_engine_matches_static(tmp_path, extra):
    """The decode CLI with both MoE forms through the serving engine writes
    the static batches' HYP lines."""
    common = ["--config", str(TINY_YAML), "--device", "cpu", "--seed", "1", "--split", "train",
              *[f"{k}={v}" for k, v in {**BOTH, **SQUEEZE}.items()],
              "model.llm.n_layers=2", "data.synthetic=true", "decode.max_new_tokens=6"]
    assert tdecode.main([*common, f"decode.output_dir={tmp_path / 'static'}"]) == 0
    assert tdecode.main([*common, "decode.engine_slots=3", *extra,
                         f"decode.output_dir={tmp_path / 'eng'}"]) == 0
    assert _hyps(tmp_path / "static") == _hyps(tmp_path / "eng")
    assert len(_hyps(tmp_path / "eng")) == 8


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

def test_convert_hf_with_moe_llm_gives_jax_dense_tree(hf_dirs):
    """``convert_hf`` with llm.moe_experts > 0 does what JAX's does: the
    dense HF Llama is converted over the init tree (no block keeps
    ``experts``: the MoE config's ``_ffn`` takes the dense branch there),
    and the moe connector stays freshly initialised. The converted trees
    are equal, and so are both packages' logits through the MoE config."""
    over = _over(**_paths(hf_dirs["safetensors"], "av"), **{
        "model.connector_type": "moe", "model.moe_experts": 4,
        "model.llm.moe_experts": 4, "model.llm.moe_every": 1})
    jc, tc = jload_config(None, over), tcfg.load_config(None, over)
    p_j, notes_j = jconvert.build_converted_params(jc)
    p_t, notes_t = tconvert.build_converted_params(tc, device="cpu")
    assert notes_t == notes_j == ["whisper", "clip", "llm"]
    _compare(p_j, p_t, notes_t)
    assert all("experts" not in lay and "gate" in lay for lay in p_t["llm"]["layers"])
    assert "experts" in p_t["audio_connector"]["blocks"][0]
    emb = np.random.default_rng(6).standard_normal((2, 10, 32)).astype(np.float32)
    out_t, _, aux_t = tllama.llama_apply(p_t["llm"], tc.model.llm,
                                         inputs_embeds=torch.from_numpy(emb), return_aux=True)
    out_j, _, aux_j = jllama.llama_apply(p_j["llm"], jc.model.llm, inputs_embeds=jnp.asarray(emb),
                                         use_pallas="never", return_aux=True)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **TOL)
    assert aux_t["moe_lb"].item() == float(aux_j["moe_lb"]) == 0.0
