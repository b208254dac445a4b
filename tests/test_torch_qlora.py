"""QLoRA training in the port vs the JAX package (f32, CPU): a quantized
base (``model.use_4bit`` / ``use_8bit``) under the train step, the Trainer,
checkpoints and resume, the train CLI's ``--mode`` presets and the decode
CLI reading what it trained.

The widened tiny config of ``test_torch_train.py`` (LLM d_model 128, packed
width 288, dropout off). Weights come from the JAX init (LoRA ``b``
randomised), quantized by the JAX ``quantize_llm`` and carried across by
``convert.from_numpy_tree``; the JAX side runs its dequantize path
(``use_pallas="never"``), the port its kernel path (plain versions on the
CPU; at M > 64 rows ``qdot`` dequantizes there too). Tolerances: loss 1e-5
relative; each trainable leaf's gradient ||g_port - g_jax|| <= 1e-5
||g_jax||; parameters after optimizer updates 1e-5 (atol and rtol);
``QDot``'s dx 1e-5 against ``jax.vjp`` of JAX ``qdot``; the port against
itself (remat, resume) bit for bit; greedy hypotheses exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.cli import common as jcommon
from avsr_tpu.cli import decode as jcli_decode
from avsr_tpu.cli import train as jcli_train
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.models import avsr as javsr
from avsr_tpu.ops import quant as jquant
from avsr_tpu.train import state as jstate
from avsr_tpu.train import step as jstep
from avsr_tpu_torch.cli import common as tcommon
from avsr_tpu_torch.cli import decode as tcli_decode
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.models import avsr as tavsr
from avsr_tpu_torch.ops import quant as tquant
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import CheckpointManager

from test_torch_checkpoint import port_trainer, run_cfgs, trainable_leaves
from test_torch_checkpoint_cli import hyp_lines, overrides
from test_torch_models import np_tree
from test_torch_train import (configs, jax_paths, jbatch, np_batch, port_paths,
                              rel_dist, tbatch, weights)  # noqa: F401

torch.set_num_threads(1)

BITS = {4: "model.use_4bit", 8: "model.use_8bit"}


def quantized(weights, bits):
    """The JAX package's quantized tree of ``weights`` (numpy leaves)."""
    q = dict(weights)
    q["llm"] = np_tree(jquant.quantize_llm(
        jax.tree_util.tree_map(jnp.asarray, weights["llm"]), bits))
    return q


def qconfigs(bits, **extra):
    return configs(**{BITS[bits]: "true", **extra})


def test_quantized_tree_partition_and_cast(weights):
    """The trainable partition of a quantized tree is the connectors and
    LoRA only; cast_frozen leaves integer leaves as they are and rounds the
    frozen scales, as the JAX package does."""
    for bits in BITS:
        jc, tc = qconfigs(bits)
        qw = quantized(weights, bits)
        jm = jax_paths(jstate.trainable_mask(jax.tree_util.tree_map(jnp.asarray, qw),
                                             jc.model))
        tm = port_paths(tstate.trainable_mask(from_numpy_tree(qw, "cpu"), tc.model))
        assert jm == tm
        assert {k[0] for k, m in tm.items() if m} == {"audio_connector",
                                                      "video_connector", "llm"}
        assert all("lora" in k for k, m in tm.items() if m and k[0] == "llm")
        p_j = jstate.cast_frozen(jax.tree_util.tree_map(jnp.asarray, qw), jc.model)
        p_t = tstate.cast_frozen(from_numpy_tree(qw, "cpu"), tc.model)
        dt_j = {k: str(v.dtype) for k, v in jax_paths(p_j).items()}
        dt_t = {k: str(v.dtype).replace("torch.", "") for k, v in port_paths(p_t).items()}
        assert dt_j == dt_t and "int8" in dt_t.values()
        for k, v in port_paths(p_t).items():
            if v.dtype == torch.int8:
                np.testing.assert_array_equal(v.numpy(), qw_leaf(qw, k))


def qw_leaf(tree, path):
    for key in path:
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


@pytest.mark.parametrize("bits", [4, 8])
def test_forward_loss_and_grads_match_jax(weights, bits):
    jc, tc = qconfigs(bits)
    qw = quantized(weights, bits)
    b = np_batch()
    p_j = jax.tree_util.tree_map(jnp.asarray, qw)
    train_j, frozen_j = jstate.partition_trainable(p_j, jc.model)

    def jloss(tp):
        return javsr.forward(jstate.combine_trainable(tp, frozen_j), jc.model,
                             jbatch(b), use_pallas="never")

    (loss_j, _), g_j = jax.value_and_grad(jloss, has_aux=True)(train_j)

    p_t = from_numpy_tree(qw, "cpu")
    leaves = port_paths(tstate.partition_trainable(p_t, tc.model)[0])
    for t in leaves.values():
        t.requires_grad_(True)
    loss_t, _ = tavsr.forward(p_t, tc.model, tbatch(b), use_kernel="always")
    grads = torch.autograd.grad(loss_t, list(leaves.values()))

    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    g_j = jax_paths(g_j)
    assert set(g_j) == set(leaves)
    for path, g in zip(leaves, grads):
        assert float(np.abs(g_j[path]).max()) > 0, path
        assert rel_dist(g.numpy(), g_j[path]) <= 1e-5, path


@pytest.mark.parametrize("bits", [4, 8])
def test_two_train_steps_match_jax(weights, bits):
    jc, tc = qconfigs(bits, **{"training.weight_decay": 0.1})
    qw = quantized(weights, bits)
    state_j, tx = jstate.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, qw), jc, 10)
    step_j = jstep.make_train_step(jc, tx)
    p_t = tstate.cast_frozen(from_numpy_tree(qw, "cpu"), tc.model, torch.float32)
    state_t = tstate.create_train_state(p_t, tc, 10)
    step_t = tstep.make_train_step(tc)
    frozen0 = {k: v.clone() for k, v in port_paths(p_t).items() if not v.requires_grad}
    for i in range(2):
        b = np_batch(10 + i)
        state_j, m_j = step_j(state_j, jstep.microbatch(jbatch(b), 1), jax.random.key(i))
        m_t = step_t(state_t, tstep.microbatch(tbatch(b), 1), i)
        np.testing.assert_allclose(m_t["loss"], float(m_j["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m_t["grad_norm"], float(m_j["grad_norm"]), rtol=1e-5)
    after_j = jax_paths(state_j.params)
    for path, leaf in port_paths(state_t.params).items():
        if path in frozen0:
            assert torch.equal(leaf, frozen0[path]), path
        else:
            np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(after_j[path]),
                                       atol=1e-5, rtol=1e-5, err_msg=str(path))
    assert state_t.optimizer.count == 2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,use_kernel", [(8, "never"), (8, "always"), (100, "always")])
def test_qdot_dx_matches_jax_vjp(bits, m, use_kernel):
    """dx = dy @ dequant(qp)^T whichever way the forward went (the kernel's
    plain version rounds x to bf16 at M <= 64 under "always"), through
    QDot; no gradient for the packed leaves or the scale, and no
    dequantized weight saved for the backward."""
    rng = np.random.default_rng(bits + m)
    K, N = 256, 96
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((2, m // 2, K)).astype(np.float32)
    dy = rng.standard_normal((*x.shape[:-1], N)).astype(np.float32)
    qp_j = jquant.quantize_tensor(jnp.asarray(w), bits)
    _, vjp = jax.vjp(lambda x_: jquant.qdot(x_, qp_j, use_kernel=False), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(dy))

    qp = {k: torch.from_numpy(np.array(v)) for k, v in qp_j.items()}
    qp["scale"].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((t.dtype, tuple(t.shape))) or t, lambda t: t):
        y = tquant.qdot(xt, qp, use_kernel=use_kernel)
    assert type(y.grad_fn).__name__ == "QDotBackward"
    assert all(dt != torch.float32 or s != (K, N) for dt, s in saved), saved
    dx, dscale = torch.autograd.grad(y, [xt, qp["scale"]], torch.from_numpy(dy),
                                     allow_unused=True)
    assert dscale is None
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert tquant.qdot(xt, qp, use_kernel=use_kernel).grad_fn is None


def test_qdot_with_remat_equals_without(weights):
    """Recomputing each block in the backward (with LoRA dropout on) gives
    the gradients of the run without remat, bit for bit, on a quantized
    base; and they differ from the dropout-free ones."""
    _, tc = qconfigs(4, **{"model.lora.dropout": 0.3})
    qw = quantized(weights, 4)
    b = tbatch(np_batch(3))
    out = {}
    for remat, seed in ((False, 7), (True, 7), (False, None)):
        p = from_numpy_tree(qw, "cpu")
        leaves = port_paths(tstate.partition_trainable(p, tc.model)[0])
        for t in leaves.values():
            t.requires_grad_(True)
        loss, _ = tavsr.forward(p, tc.model, b, use_kernel="always", remat=remat,
                                dropout_seed=seed)
        out[(remat, seed)] = (loss.item(), torch.autograd.grad(loss, list(leaves.values())))
    (l0, g0), (l1, g1), (l2, g2) = out.values()
    assert l0 == l1 and l0 != l2
    for a, c in zip(g0, g1):
        torch.testing.assert_close(a, c, atol=0, rtol=0)
    assert any(not torch.allclose(a, c) for a, c in zip(g0, g2))


def test_qlora_resume_equals_uninterrupted(weights, tmp_path):
    """Two steps, stop, resume to three on an int4 base: bit-equal to three
    uninterrupted steps; the checkpoint holds the quantized tree."""
    qw = quantized(weights, 4)
    runs = {}
    for name, steps in (("interrupted", (2, 3)), ("straight", (3,))):
        hist = []
        for max_steps in steps:
            _, tc = run_cfgs(tmp_path / name, **{"training.max_steps": max_steps,
                                                 BITS[4]: "true"})
            tr = port_trainer(tc, qw)
            tr.maybe_resume()
            tr.train()
            hist += tr.history["train"]
        runs[name] = (hist, trainable_leaves(tr.state.params, tc))
    assert runs["interrupted"][0] == runs["straight"][0]
    for k, v in runs["straight"][1].items():
        assert torch.equal(v, runs["interrupted"][1][k]), k
    ck = CheckpointManager(tmp_path / "interrupted" / "ckpt")
    params = torch.load(ck.dir / "3" / "params.pt", weights_only=True)
    q = params["llm"]["layers"][0]["q"]
    assert q["qw4h"].dtype == torch.int8 and "w" not in q and "lora" in q


@pytest.mark.parametrize("mode", ["4bit", "8bit"])
def test_train_cli_mode_then_decode_matches_jax(tmp_path, mode):
    """train --mode -> checkpoint -> decode --checkpoint through each
    package's CLIs from the same quantized initial weights: the same
    hypotheses (the decode CLI restores the quantized tree as it is)."""
    flag = BITS[4 if mode == "4bit" else 8]
    jover = overrides(tmp_path / "jrun", tmp_path / "jdec")
    assert jcli_train.main(["--mode", mode, *jover]) == 0
    assert jcli_decode.main(["--checkpoint", str(tmp_path / "jrun" / "ckpt"),
                             "--split", "train", *jover, f"{flag}=true"]) == 0

    tover = overrides(tmp_path / "trun", tmp_path / "tdec")
    jc = jload_config(None, jover + [f"{flag}=true"])
    tc = tcfg.load_config(None, tover + [f"{flag}=true"])
    init = np_tree(jcommon.init_or_load_params(jc))
    st = tstate.create_train_state(from_numpy_tree(init, "cpu"), tc, 1)
    mngr = CheckpointManager(tmp_path / "trun" / "ckpt", tc)
    mngr.save(st)
    mngr.close()
    assert tcli_train.main(["--device", "cpu", "--mode", mode, *tover]) == 0
    assert tcli_decode.main(["--device", "cpu", *tover, f"{flag}=true", "--checkpoint",
                             str(tmp_path / "trun" / "ckpt"), "--split", "train"]) == 0
    hyps = hyp_lines(tmp_path / "tdec")
    assert len(hyps) == 8 and hyps == hyp_lines(tmp_path / "jdec")
    trained = torch.load(tmp_path / "trun" / "ckpt" / "2" / "params.pt", weights_only=True)
    key = "qw4h" if mode == "4bit" else "qw"
    assert trained["llm"]["layers"][0]["down"][key].dtype == torch.int8


def test_mode_overrides_match_jax_and_explicit_override_wins():
    assert tcommon.MODE_OVERRIDES == jcommon.MODE_OVERRIDES
    for mode, over in tcommon.MODE_OVERRIDES.items():
        assert tcfg.load_config(None, over) is not None, mode
    args = tcommon.base_parser("t", modes=True).parse_args(
        ["--mode", "max", "data.batch_size=4"])
    cfg = tcommon.load_cli_config(args)
    assert cfg.model.use_4bit and cfg.mesh.remat
    assert cfg.training.grad_accum_steps == 8
    assert cfg.data.batch_size == 4           # the explicit override wins
    with pytest.raises(SystemExit):           # the decode CLI has no --mode
        tcommon.base_parser("t").parse_args(["--mode", "4bit"])
