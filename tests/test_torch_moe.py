"""The port's MoE routing (``ops/moe.py``) and ``moe`` connector vs the JAX
package (f32, CPU), the counterparts of ``tests/test_moe.py``'s
single-device cases (the ``ep`` mesh cases run across processes in
``tests/test_torch_ep.py``).

Parameters come from the JAX init (every leaf moved off its init by numpy
noise, so that biases and norm scales matter) through
``convert.from_numpy_tree``; inputs are numpy from a seed. Tolerances:
``route``'s dispatch and slot choices exactly (the top-k order and the
integer slot positions must make JAX's choices), its combine and losses
1e-6; the connector's outputs and aux 1e-5 (atol and rtol), gradients
||g - g_jax|| <= 1e-4 ||g_jax|| per leaf; the whole model's loss 1e-5
relative; lengths exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core import config as jcfg
from avsr_tpu.models import avsr as javsr
from avsr_tpu.models.connectors import moe_apply as jmoe_apply
from avsr_tpu.models.connectors import moe_init as jmoe_init
from avsr_tpu.ops import moe as jmoe
from avsr_tpu.train import state as jstate
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.models.connectors import get_connector as tget
from avsr_tpu_torch.models.connectors import moe_apply, moe_init
from avsr_tpu_torch.models.layers import dense, gelu, layer_norm
from avsr_tpu_torch.ops import moe as tmoe
from avsr_tpu_torch.train import state as tstate

from test_torch_connectors import perturb
from test_torch_models import np_tree, randomize_lora_b
from test_torch_train import configs, jax_paths, jbatch, np_batch, port_paths, rel_dist, tbatch

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4


def moe_cfg(**kw):
    base = dict(connector_type="moe", moe_experts=4, moe_topk=2, modality="audio")
    base.update(kw)
    return jcfg.ModelConfig(**base)


# ---------------------------------------------------------------------------
# ops/moe.py
# ---------------------------------------------------------------------------

def test_capacity_functions_match_jax():
    ns = np.arange(0, 70, 3)
    for E in (1, 3, 4, 8):
        for topk in (1, 2):
            for factor in (1e-6, 0.25, 1.0, 1.25, 4.0):
                for n in ns:
                    assert tmoe.capacity(int(n), E, topk, factor) == jmoe.capacity(
                        int(n), E, topk, factor)
                dyn_j = jmoe.capacity_dyn(jnp.asarray(ns, jnp.int32), E, topk, factor)
                dyn_t = tmoe.capacity_dyn(torch.from_numpy(ns), E, topk, factor)
                np.testing.assert_array_equal(dyn_t.numpy(), np.asarray(dyn_j))
                # the row cutoff never exceeds the padded width's slot dim
                assert int(dyn_t.max()) <= tmoe.capacity(int(ns.max()), E, topk, factor)
            for n in ns:
                assert tmoe.dropless_capacity(int(n), topk) == jmoe.dropless_capacity(
                    int(n), topk)


def _route_inputs(case):
    rng = np.random.default_rng(3)
    N, E = 24, 4
    logits = rng.standard_normal((N, E)).astype(np.float32)
    valid = np.ones(N, np.float32)
    cap = None
    if case == "padding":
        valid[17:] = 0
        logits[17:] *= 100.0
    elif case == "all_tie":                   # an all-zero router: every logit ties
        logits[:] = 0.0
        valid[20:] = 0
    elif case == "cap":
        valid[19:] = 0
        cap = 8
    return logits, valid, cap


@pytest.mark.parametrize("case", ["plain", "padding", "all_tie", "cap"])
@pytest.mark.parametrize("topk", [1, 2])
def test_route_matches_jax(case, topk):
    """dispatch (exactly), combine, lb and z, and the gradients of a
    weighted sum of combine, lb and z with respect to the logits."""
    logits, valid, cap = _route_inputs(case)
    C = 16
    w = np.random.default_rng(4).standard_normal((logits.shape[0], 4, C)).astype(np.float32)

    def jloss(lg):
        d, c, lb, z = jmoe.route(lg, jnp.asarray(valid), topk, C,
                                 cap=None if cap is None else jnp.int32(cap))
        return jnp.sum(c * w) + lb + z, (d, c, lb, z)

    (_, out_j), g_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    lg_t = torch.from_numpy(logits).requires_grad_(True)
    out_t = tmoe.route(lg_t, torch.from_numpy(valid), topk, C,
                       cap=None if cap is None else torch.tensor(cap))
    g_t, = torch.autograd.grad((out_t[1] * torch.from_numpy(w)).sum() + out_t[2] + out_t[3],
                               lg_t)
    np.testing.assert_array_equal(out_t[0].detach().numpy(), np.asarray(out_j[0]))
    for t, j in zip(out_t[1:], out_j[1:]):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-6, rtol=1e-5)
    if case == "all_tie":
        # ties go to the lowest expert indices, as jax.lax.top_k breaks them
        assert set(np.nonzero(out_t[0].detach().numpy().sum((0, 2)))[0]) == set(range(topk))
    if case in ("padding", "all_tie", "cap"):
        assert not out_t[0][valid == 0].any()


def test_route_over_rows_equals_jax_vmap():
    """Leading dims route independently, as JAX vmaps route over rows, each
    with its own cutoff."""
    rng = np.random.default_rng(5)
    B, T, E, k = 3, 20, 4, 2
    logits = rng.standard_normal((B, T, E)).astype(np.float32)
    valid = (np.arange(T)[None, :] < np.array([20, 13, 5])[:, None]).astype(np.float32)
    C = jmoe.capacity(T, E, k, 0.5)

    def row(lg, vl):
        return jmoe.route(lg, vl, k, C, cap=jmoe.capacity_dyn(vl.sum(), E, k, 0.5))

    out_j = jax.vmap(row)(jnp.asarray(logits), jnp.asarray(valid))
    v_t = torch.from_numpy(valid)
    out_t = tmoe.route(torch.from_numpy(logits), v_t, k, C,
                       cap=tmoe.capacity_dyn(v_t.sum(-1), E, k, 0.5))
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    for t, j in zip(out_t[1:], out_j[1:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the moe connector
# ---------------------------------------------------------------------------

def run_connector(cfg, params, x, lens, rowwise):
    """The connector in both packages on the same parameters and inputs:
    ((y, lengths, aux, grads) of JAX, the same of the port); grads of
    sum(y * w) + lb + z for a fixed random w, by key path."""
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    args_j = (jnp.asarray(x), None if lens is None else jnp.asarray(lens))
    y_j, l_j, a_j = jmoe_apply(p_j, *args_j, model_cfg=cfg, moe_rowwise=rowwise)
    w = np.random.default_rng(1).standard_normal(y_j.shape).astype(np.float32)

    def jloss(p):
        y, _, a = jmoe_apply(p, *args_j, model_cfg=cfg, moe_rowwise=rowwise)
        return jnp.sum(y * w) + a["moe_lb"] + a["moe_z"]

    g_j = jax.grad(jloss)(p_j)
    tc = tcfg.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(
        tcfg.ModelConfig) if f.name in ("connector_type", "moe_experts", "moe_topk",
                                        "moe_capacity_factor", "modality")})
    p_t = from_numpy_tree(params, "cpu")
    leaves = port_paths(p_t)
    for t in leaves.values():
        t.requires_grad_(True)
    y_t, l_t, a_t = moe_apply(p_t, torch.from_numpy(x),
                              None if lens is None else torch.from_numpy(lens),
                              model_cfg=tc, moe_rowwise=rowwise)
    loss = (y_t * torch.from_numpy(w)).sum() + a_t["moe_lb"] + a_t["moe_z"]
    g_t = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return (y_j, l_j, a_j, jax_paths(g_j)), (y_t, l_t, a_t, g_t)


@pytest.mark.parametrize("rowwise", [False, True], ids=["train", "rowwise"])
@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_moe_connector_matches_jax(rowwise, factor):
    """Outputs, lengths, aux losses and every leaf's gradient, with ragged
    lengths, in the training and the row-wise routing, with a generous and
    a squeezing (tokens drop) capacity factor."""
    cfg = moe_cfg(moe_capacity_factor=factor)
    params = perturb(np_tree(jmoe_init(jax.random.key(2), 24, 32, cfg)), 2)
    x = np.random.default_rng(6).standard_normal((3, 14, 24)).astype(np.float32)
    lens = np.array([14, 9, 3], np.int32)
    (y_j, l_j, a_j, g_j), (y_t, l_t, a_t, g_t) = run_connector(cfg, params, x, lens, rowwise)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(a_t[k].item(), float(a_j[k]), **TOL)
    assert set(g_t) == set(g_j)
    for path, g in g_t.items():
        assert rel_dist(g.numpy(), g_j[path]) <= GRAD_TOL, path


def test_moe_single_expert_matches_dense_ffn():
    """E=1, topk=1, generous capacity: every token routes to the only expert
    with gate 1.0, so the MoE blocks are a plain residual FFN; lb is 1.0."""
    cfg = moe_cfg(moe_experts=1, moe_topk=1, moe_capacity_factor=4.0)
    params = perturb(np_tree(jmoe_init(jax.random.key(3), 48, 32, cfg)), 3)
    x = np.random.default_rng(7).standard_normal((2, 10, 48)).astype(np.float32)
    lens = np.array([10, 10], np.int32)
    (y_j, _, a_j, _), (y_t, l_t, a_t, _) = run_connector(cfg, params, x, lens, False)
    p = from_numpy_tree(params, "cpu")
    h = dense(p["inp"], torch.from_numpy(x))
    for blk in p["blocks"]:
        ex = blk["experts"]
        h = h + gelu(layer_norm(blk["ln"], h) @ ex["w1"][0] + ex["b1"][0]) @ ex["w2"][0] \
            + ex["b2"][0]
    np.testing.assert_allclose(y_t.detach().numpy(), h.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    assert l_t.tolist() == [10, 10]
    assert a_t["moe_lb"].item() == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("rowwise", [False, True], ids=["train", "rowwise"])
def test_moe_padding_invariance(rowwise):
    """Padding is masked out of the routing: garbage past ``lengths`` does
    not change the valid rows (slot positions included) or the aux."""
    cfg = tcfg.ModelConfig(connector_type="moe", moe_experts=4, moe_topk=2)
    p = from_numpy_tree(perturb(np_tree(jmoe_init(jax.random.key(0), 24, 32, moe_cfg())), 0),
                        "cpu")
    rng = np.random.default_rng(8)
    x1 = torch.from_numpy(rng.standard_normal((2, 12, 24)).astype(np.float32))
    x2 = x1.clone()
    x2[0, 7:] = torch.from_numpy(100.0 * rng.standard_normal((5, 24)).astype(np.float32))
    lens = torch.tensor([7, 12])
    with torch.no_grad():
        y1, _, a1 = moe_apply(p, x1, lens, model_cfg=cfg, moe_rowwise=rowwise)
        y2, _, a2 = moe_apply(p, x2, lens, model_cfg=cfg, moe_rowwise=rowwise)
    np.testing.assert_allclose(y1[0, :7].numpy(), y2[0, :7].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y1[1].numpy(), y2[1].numpy(), atol=1e-5, rtol=1e-5)
    assert a1["moe_lb"].item() == pytest.approx(a2["moe_lb"].item(), rel=1e-5)


def test_moe_tiny_capacity_still_finite():
    """A pathologically small capacity factor drops tokens to the residual
    path: outputs stay finite, as in JAX."""
    cfg = moe_cfg(moe_capacity_factor=1e-6)
    params = np_tree(jmoe_init(jax.random.key(1), 24, 32, cfg))
    x = np.random.default_rng(9).standard_normal((2, 40, 24)).astype(np.float32)
    (y_j, *_), (y_t, *_) = run_connector(cfg, params, x, None, False)
    assert np.isfinite(y_t.detach().numpy()).all()
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)


def test_moe_connector_is_single_input_and_needs_model_cfg():
    assert not tget("moe").dual
    p = moe_init(torch.Generator().manual_seed(0), 8, 16, tcfg.ModelConfig())
    assert list(p) == ["inp", "blocks"] and len(p["blocks"]) == 2
    assert list(p["blocks"][0]) == ["ln", "router", "experts"]
    with pytest.raises(ValueError, match="model_cfg"):
        moe_apply(p, torch.zeros((1, 3, 8)))


# ---------------------------------------------------------------------------
# the whole model with the moe connector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modality", ["audio", "both"])
def test_moe_forward_grads_and_aux_match_jax(modality):
    """The whole model with the moe connector (modality both: two connectors
    whose aux losses are averaged): the loss with the router losses
    weighted in, moe_lb and moe_z, every trainable leaf's gradient (the
    routers and experts train), and the masks."""
    over = {"model.connector_type": "moe", "model.moe_experts": 4,
            "model.modality": modality}
    jc, tc = configs(**over)
    weights = randomize_lora_b(np_tree(javsr.init_avsr_model(jax.random.key(0), jc.model)),
                               seed=3)
    p_j = jax.tree_util.tree_map(jnp.asarray, weights)
    p_t = from_numpy_tree(weights, "cpu")
    assert port_paths(tavsr.init_avsr_model(tc.model, seed=0, device="cpu")).keys() \
        == port_paths(p_t).keys()
    b = np_batch()
    if modality == "audio":
        b = {k: v for k, v in b.items() if k not in ("frames", "frame_lens")}
    train_j, frozen_j = jstate.partition_trainable(p_j, jc.model)
    (loss_j, m_j), g_j = jax.value_and_grad(
        lambda tp: javsr.forward(jstate.combine_trainable(tp, frozen_j), jc.model,
                                 jbatch(b), use_pallas="never"), has_aux=True)(train_j)
    train_t, _ = tstate.partition_trainable(p_t, tc.model)
    leaves = port_paths(train_t)
    for t in leaves.values():
        t.requires_grad_(True)
    loss_t, m_t = tavsr.forward(p_t, tc.model, tbatch(b), use_kernel="always")
    grads = torch.autograd.grad(loss_t, list(leaves.values()))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-5)
    assert m_t["moe_lb"].item() > 0.0
    g_jp = jax_paths(g_j)
    assert set(leaves) == set(g_jp)
    for path, g in zip(leaves, grads):
        assert rel_dist(g.numpy(), g_jp[path]) <= GRAD_TOL, path
    blk = dict(zip(leaves, grads))
    assert blk[("audio_connector", "blocks", "0", "router", "w")].abs().sum() > 0
    assert blk[("audio_connector", "blocks", "0", "experts", "w1")].abs().sum() > 0
    assert (jax_paths(jstate.trainable_mask(p_j, jc.model))
            == port_paths(tstate.trainable_mask(p_t, tc.model)))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

MOE_CASES = {
    "conn_topk": {"model.connector_type": "moe", "model.moe_experts": 2, "model.moe_topk": 3},
    "conn_topk0": {"model.connector_type": "moe", "model.moe_topk": 0},
    "conn_factor": {"model.connector_type": "moe", "model.moe_capacity_factor": 0.0},
    "llm_topk": {"model.llm.moe_experts": 2, "model.llm.moe_topk": 5},
    "llm_every": {"model.llm.moe_experts": 4, "model.llm.moe_every": 3},
    "llm_every0": {"model.llm.moe_experts": 4, "model.llm.moe_every": 0},
    "llm_pp": {"model.llm.moe_experts": 4, "mesh.pp": 2},
    "ep_dense": {"mesh.ep": 2},
    "ep_conn_indivisible": {"model.connector_type": "moe", "model.moe_experts": 3,
                            "mesh.ep": 2},
    "ep_llm_indivisible": {"model.llm.moe_experts": 3, "mesh.ep": 2},
    "ok_conn": {"model.connector_type": "moe", "model.moe_experts": 4,
                "model.moe_topk": 4},
    "ok_llm": {"model.llm.moe_experts": 4, "model.llm.moe_every": 2},
    "ok_both": {"model.connector_type": "moe", "model.llm.moe_experts": 1,
                "model.llm.moe_topk": 1, "model.moe_capacity_factor": 1e-6},
    "ok_ep_conn": {"model.connector_type": "moe", "model.moe_experts": 4, "mesh.ep": 2},
    "ok_ep_llm": {"model.llm.moe_experts": 4, "mesh.ep": 2},
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_config_validation_matches_jax(case):
    """Each MoE config is accepted by both packages, or refused by both
    with JAX's ValueError and message: mesh.ep with a dense model or with
    experts that do not divide over it, LLM MoE blocks under mesh.pp; a
    mesh.ep that the JAX package accepts loads in the port too."""
    over = {"model.llm.n_layers": 2, **MOE_CASES[case]}
    errs = []
    for mod in (jcfg, tcfg):
        cfg = mod.AVSRConfig(
            model=dataclasses.replace(
                mod.ModelConfig(**{k.split(".")[1]: v for k, v in over.items()
                                   if k.startswith("model.") and k.count(".") == 1}),
                llm=mod.LLMConfig(**{k.split(".")[2]: v for k, v in over.items()
                                     if k.startswith("model.llm.")})),
            mesh=mod.MeshConfig(**{k.split(".")[1]: v for k, v in over.items()
                                   if k.startswith("mesh.")}))
        try:
            cfg.validate()
            errs.append(None)
        except (ValueError, NotImplementedError) as e:
            errs.append((type(e), str(e)))
    if case.startswith("ok") or errs[0] is None:
        assert errs[0] is None, errs[0]
        assert errs[1] is None, errs[1]
    else:
        assert errs[0][0] is ValueError
        assert errs[1] == errs[0]
