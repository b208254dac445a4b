"""The port's weight-only quantization (ops/quant.py, ops/qmatmul.py, the
fused decode layout and the int8 KV cache) against the JAX package (CPU).

The same numpy inputs from a seed go to both packages. Quantized leaves,
scales, unpacked nibbles, dequantized weights, fused trees and the int8
cache must be exactly equal; the kernels' plain version
``qmatmul_reference`` matches the JAX kernel run in interpret mode within
1e-5 * max|ref| (f32, only the summation order differs), and ``qdot`` on
the CPU (the dequantize path of both packages) within 1e-5 atol/rtol.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core import config as jcfg
from avsr_tpu.models import llama as jllama
from avsr_tpu.ops import quant as jq
from avsr_tpu.ops.qmatmul import qmatmul as jqmatmul
from avsr_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from avsr_tpu_torch.models import llama as tllama
from avsr_tpu_torch.ops import qmatmul as tqm
from avsr_tpu_torch.ops import quant as tq

from test_torch_models import np_tree, randomize_lora_b

torch.set_num_threads(1)


def _t(a):
    return from_numpy_tree(np.asarray(a), "cpu")


def assert_trees_equal(t_tree, j_tree, path="root"):
    """Same structure (dict keys, list lengths), every leaf exactly equal
    in value and of the same integer/float kind."""
    if isinstance(j_tree, dict):
        assert isinstance(t_tree, dict) and set(t_tree) == set(j_tree), \
            (path, sorted(t_tree), sorted(j_tree))
        for k in j_tree:
            assert_trees_equal(t_tree[k], j_tree[k], f"{path}/{k}")
        return
    if isinstance(j_tree, (list, tuple)):
        assert len(t_tree) == len(j_tree), path
        for i, (a, b) in enumerate(zip(t_tree, j_tree)):
            assert_trees_equal(a, b, f"{path}/{i}")
        return
    t = to_numpy_tree(t_tree)
    j = np.asarray(j_tree)
    assert t.shape == j.shape, (path, t.shape, j.shape)
    assert np.issubdtype(t.dtype, np.integer) == np.issubdtype(j.dtype, np.integer), path
    if np.issubdtype(j.dtype, np.integer):
        assert t.dtype == j.dtype, (path, t.dtype, j.dtype)
    np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=path)


# ---------------------------------------------------------------------------
# quantize_tensor, unpacking, dequantize
# ---------------------------------------------------------------------------

def _weights(K, N, seed):
    return np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N", [(2048, 96), (64, 37), (130, 2049)])
def test_quantize_tensor_exact(bits, K, N):
    w = _weights(K, N, seed=K + N + bits)
    assert_trees_equal(tq.quantize_tensor(_t(w), bits), jq.quantize_tensor(jnp.asarray(w), bits))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tensor_rounds_ties_to_even(bits):
    """Columns whose max makes the scale exactly 1: every x.5 is a tie."""
    qmax = 127 if bits == 8 else 7
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5], np.float32)
    w = np.zeros((16, 3), np.float32)
    w[:8, :] = ties[:, None]
    w[8, :] = qmax
    w[9:, 2] = -qmax
    q_t = tq.quantize_tensor(_t(w), bits)
    assert_trees_equal(q_t, jq.quantize_tensor(jnp.asarray(w), bits))
    q = tq.unpacked(q_t)[:8, 0].tolist()
    assert q == [0, 2, 2, 0, -2, -2, 4, -4]


def test_unpack_dequantize_and_legacy_int4_exact():
    rng = np.random.default_rng(3)
    w = _weights(64, 40, seed=4)
    qp_j = jq.quantize_tensor(jnp.asarray(w), 4)
    qp_t = tq.quantize_tensor(_t(w), 4)
    np.testing.assert_array_equal(tq._unpack_int4(qp_t["qw4h"]).numpy(),
                                  np.asarray(jq._unpack_int4(qp_j["qw4h"])))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = to_numpy_tree(tq.dequantize(qp_t, dtype))
        np.testing.assert_array_equal(got, np.asarray(jq.dequantize(qp_j, jdt), np.float32))
    # every byte array is a legacy interleaved packing
    legacy = rng.integers(-128, 128, (32, 40), dtype=np.int8)
    scale = rng.uniform(0.01, 0.1, 40).astype(np.float32)
    np.testing.assert_array_equal(tq._unpack_int4_legacy(_t(legacy)).numpy(),
                                  np.asarray(jq._unpack_int4_legacy(jnp.asarray(legacy))))
    node_j = {"qw4": jnp.asarray(legacy), "scale": jnp.asarray(scale)}
    node_t = {"qw4": _t(legacy), "scale": _t(scale)}
    np.testing.assert_array_equal(tq.dequantize(node_t).numpy(),
                                  np.asarray(jq.dequantize(node_j)))
    tree_j = {"a": [node_j, {"w": jnp.asarray(scale)}], "b": qp_j}
    tree_t = {"a": [node_t, {"w": _t(scale)}], "b": qp_t}
    up_t = tq.upgrade_legacy_int4(tree_t)
    assert_trees_equal(up_t, jq.upgrade_legacy_int4(tree_j))
    # the repacked node dequantizes to the same weight as the legacy one
    np.testing.assert_array_equal(tq.dequantize(up_t["a"][0]).numpy(),
                                  tq.dequantize(node_t).numpy())


def test_is_quantized_and_quant_bytes():
    qp = tq.quantize_tensor(_t(_weights(8, 6, seed=5)), 4)
    assert tq.is_quantized(qp) and tq.is_quantized({"qw4": None})
    assert not tq.is_quantized({"w": qp["scale"]}) and not tq.is_quantized(qp["scale"])
    assert tq.quant_bytes({"l": [qp], "e": torch.zeros(3, dtype=torch.bfloat16)}) \
        == 4 * 6 + 6 * 4 + 3 * 2


# ---------------------------------------------------------------------------
# The kernels' plain version and qdot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,K,N,M", [
    (8, 512, 256, 8), (8, 1024, 384, 3), (4, 512, 256, 8), (4, 2048, 128, 5),
    (4, 2048, 3072, 8), (4, 8192, 2048, 8),      # flagship qkv and down
    (8, 2048, 3072, 8), (8, 8192, 2048, 8)])
def test_qmatmul_reference_matches_jax_interpret(bits, K, N, M):
    rng = np.random.default_rng(K + N + M + bits)
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    ref = np.asarray(jqmatmul(jnp.asarray(x), jq.quantize_tensor(jnp.asarray(w), bits),
                              interpret=True))
    got = tqm.qmatmul_reference(_t(x), tq.quantize_tensor(_t(w), bits))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
    # CPU tensors take the plain version through the wrapper as well
    np.testing.assert_array_equal(
        tqm.qmatmul(_t(x), tq.quantize_tensor(_t(w), bits)).numpy(), got.numpy())


def test_qmatmul_reference_rounds_x_to_bf16_and_checks_k():
    rng = np.random.default_rng(6)
    qp = tq.quantize_tensor(_t(rng.standard_normal((64, 24)).astype(np.float32)), 4)
    x = _t(rng.standard_normal((3, 64)).astype(np.float32))
    np.testing.assert_array_equal(tqm.qmatmul_reference(x, qp).numpy(),
                                  tqm.qmatmul_reference(x.to(torch.bfloat16), qp).numpy())
    out = tqm.qmatmul_reference(x, qp, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tqm.qmatmul_reference(x[:, :62], qp)          # K != 2 x packed rows
    with pytest.raises(ValueError):
        tqm.qmatmul_reference(x, {"qw4": qp["qw4h"], "scale": qp["scale"]})


@pytest.mark.parametrize("kind", ["qw", "qw4h", "qw4"])
@pytest.mark.parametrize("use_kernel", ["auto", "never"])
def test_qdot_cpu_matches_jax(kind, use_kernel):
    """Both packages dequantize on the CPU; f32 logits-style output too."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((48, 20)).astype(np.float32)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    qp_j = jq.quantize_tensor(jnp.asarray(w), 8 if kind == "qw" else 4)
    if kind == "qw4":
        qp_j = {"qw4": jnp.asarray(rng.integers(-128, 128, (24, 20), dtype=np.int8)),
                "scale": qp_j["scale"]}
    qp_t = from_numpy_tree(np_tree(qp_j), "cpu")
    got = tq.qdot(_t(x), qp_t, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(jq.qdot(jnp.asarray(x), qp_j)),
                               atol=1e-5, rtol=1e-5)
    got_f32 = tq.qdot(_t(x).to(torch.bfloat16), qp_t, out_dtype=torch.float32,
                      use_kernel=use_kernel)
    ref = jq.qdot(jnp.asarray(x, jnp.bfloat16), qp_j, out_dtype=jnp.float32)
    assert got_f32.dtype == torch.float32
    np.testing.assert_allclose(got_f32.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m,k,node,use_kernel,cuda,want", [
    (8, 64, "qw", "auto", True, True),
    (8, 64, "qw", "auto", False, False),      # the CPU dequantizes, as JAX's CPU path
    (8, 64, "qw", "always", False, True),     # ... unless asked: the plain version
    (8, 64, "qw", "never", True, False),
    (64, 64, "qw4h", "auto", True, True),
    (65, 64, "qw4h", "auto", True, False),    # M > MAX_SMALL_M
    (8, 63, "qw4h", "always", True, False),   # int4 needs an even K
    (8, 64, "qw4", "always", True, False),    # legacy layout always dequantizes
])
def test_eligible_rule(m, k, node, use_kernel, cuda, want):
    assert tqm.eligible(m, k, {node: None, "scale": None}, use_kernel=use_kernel,
                        cuda=cuda) is want


def test_qdot_dispatch_on_cpu(monkeypatch):
    """"auto" never reaches the plain kernel version on the CPU (it
    dequantizes); "always" takes it for small M only."""
    calls = []
    real = tqm.qmatmul_reference
    monkeypatch.setattr(tqm, "qmatmul_reference",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    rng = np.random.default_rng(8)
    qp = tq.quantize_tensor(_t(rng.standard_normal((32, 16)).astype(np.float32)), 8)
    x = _t(rng.standard_normal((4, 2, 32)).astype(np.float32))
    tq.qdot(x, qp)
    assert calls == []
    y = tq.qdot(x, qp, use_kernel="always")
    assert calls == [(8, 32)] and y.shape == (4, 2, 16)
    tq.qdot(_t(rng.standard_normal((65, 32)).astype(np.float32)), qp, use_kernel="always")
    assert calls == [(8, 32)]
    with pytest.raises(ValueError):
        tq.qdot(x, qp, use_kernel="sometimes")


_PLAN_SHAPES = [(8, 1024, 3072), (8, 1024, 2048), (8, 1024, 16384),
                (8, 4096, 2048), (8, 2048, 129024), (1, 1000, 2050),
                (64, 2048, 2048), (8, 64, 128), (8, 8192, 129024)]


@pytest.mark.parametrize("bits", [8, 4])
def test_splits_fill_the_card(bits):
    """The K split fills one wave of one CTA per SM where the rows allow:
    at most 8 splits in one launch, each with at least one k step per warp
    (int8: 16 weight rows a step, splits on 64-row boundaries; int4: 8
    packed rows), and no split at the lm head's width."""
    plan, kstep, align = ((tqm.int4_plan, tqm.I4_KSTEP, tqm.I4_KSTEP) if bits == 4
                          else (tqm.int8_plan, tqm.I8_KSTEP, tqm.I8_SPLIT_ALIGN))
    for m, rows, n in _PLAN_SHAPES:
        c, per, nt = plan(m, rows, n, sms=132)
        ctas = -(-n // tqm.BLOCK_N) * -(-m // (8 * nt))
        # one wave of one CTA per SM
        assert c * ctas <= 132 or c == 1
        # and no fewer: one more CTA per tile would not fit the wave, or the
        # splits are at their cap, or the CTAs are already short (under two
        # k steps per warp), or the boundaries allow no shorter split
        assert (c + 1) * ctas > 132 or c == tqm.MAX_SPLIT \
            or per < 2 * tqm.WARPS * kstep \
            or -(-(-(-rows // (c + 1))) // align) * align >= per
    # the flagship's projections at M = 8: qkv, o, gateup, down (int4 over
    # K/2 packed rows), and the head
    k_rows = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)]
    div = 2 if bits == 4 else 1
    assert [plan(8, r // div, n, 132)[0] for r, n in k_rows] == [5, 8, 1, 8]
    assert plan(8, 2048 // div, 129024, 132)[0] == 1


@pytest.mark.parametrize("m", [1, 5, 8, 9, 17, 64])
@pytest.mark.parametrize("rows,n", [(1024, 3072), (1024, 2048), (1024, 16384),
                                    (4096, 2048), (500, 2050), (500, 1000),
                                    (1, 128), (12, 16), (20480, 4096)])
def test_int8_plan_is_legal(m, rows, n):
    """Every int8 launch plan covers each of the K = ``rows`` weight rows
    exactly once, each split starting on a 64-column panel of x (whole
    16-row k steps; the last split may end inside one), keeps the splits
    within 8, takes two n8 tiles of x exactly when M > 8, and never splits
    the lm head (129,024 columns fill the card)."""
    c, per, nt = tqm.int8_plan(m, rows, n, sms=132)
    assert 1 <= c <= tqm.MAX_SPLIT
    assert per % tqm.I8_SPLIT_ALIGN == 0 and per % tqm.I8_KSTEP == 0
    starts = [r * per for r in range(c)]
    covered = sum(min(rows, s + per) - s for s in starts)
    assert covered == rows and all(s < rows for s in starts)
    assert nt == (1 if m <= 8 else 2)
    assert tqm.int8_plan(m, rows, 129024, sms=132)[0] == 1


@pytest.mark.parametrize("m", [1, 5, 8, 9, 17, 64])
@pytest.mark.parametrize("rows,n", [(1024, 3072), (1024, 2048), (1024, 16384),
                                    (4096, 2048), (500, 2050), (500, 1000),
                                    (1, 128), (12, 16), (20480, 4096)])
def test_int4_plan_is_legal(m, rows, n):
    """Every int4 launch plan covers each packed row exactly once in whole
    k steps (the last CTA may hold a partial one), keeps the splits within
    8, and takes two n8 tiles of x exactly when M > 8. (A CTA's shared
    memory holds only its warps' sums, 35 or 70 KB whatever the plan.)"""
    c, per, nt = tqm.int4_plan(m, rows, n, sms=132)
    assert 1 <= c <= tqm.MAX_SPLIT
    assert per % tqm.I4_KSTEP == 0
    starts = [r * per for r in range(c)]
    covered = sum(min(rows, s + per) - s for s in starts)
    assert covered == rows and all(s < rows for s in starts)
    assert nt == (1 if m <= 8 else 2)



# ---------------------------------------------------------------------------
# quantize_llm, the fused decode layout, the int8 cache
# ---------------------------------------------------------------------------

def _llm(tie=True, vocab=2100, seed=0):
    cfg = jcfg.LLMConfig(vocab_size=vocab, d_model=32, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_dim=64, max_seq_len=64,
                         tie_embeddings=tie)
    lora = jcfg.LoRAConfig(use_lora=True, r=2, alpha=4,
                           target_modules=("q_proj", "v_proj", "gate_proj", "down_proj"))
    p = jllama.init_llama(jax.random.key(seed), cfg)
    p = jllama.add_lora(jax.random.key(seed + 1), p, cfg, lora)
    return cfg, randomize_lora_b(np_tree(p), seed=seed + 2)


@pytest.mark.parametrize("bits,head_bits,tie", [
    (4, 0, True), (4, 4, True), (4, 8, True), (8, 0, True), (8, 4, True),
    (8, 8, True), (8, 8, False)])
def test_quantize_llm_matches_jax(bits, head_bits, tie):
    _, p = _llm(tie=tie)
    got = tq.quantize_llm(from_numpy_tree(p, "cpu"), bits, lm_head_bits=head_bits)
    ref = jq.quantize_llm(jax.tree_util.tree_map(jnp.asarray, p), bits,
                          lm_head_bits=head_bits)
    assert_trees_equal(got, ref)
    if head_bits:
        key = "qw" if head_bits == 8 else "qw4h"
        assert got["lm_head"][key].shape[1] == 4096          # 2100 padded to 2048s
        assert tq.is_quantized(got["lm_head"])
    layer = got["layers"][0]
    assert tq.is_quantized(layer["down"]) and "lora" in layer["down"]


@pytest.mark.parametrize("bits", [0, 4, 8])
def test_fuse_decode_layout_matches_jax(bits):
    cfg, p = _llm()
    p_j = jax.tree_util.tree_map(jnp.asarray, p)
    p_t = from_numpy_tree(p, "cpu")
    if bits:
        p_j, p_t = jq.quantize_llm(p_j, bits), tq.quantize_llm(p_t, bits)
    fused_t = tllama.fuse_decode_layout(p_t)
    assert_trees_equal(fused_t, jllama.fuse_decode_layout(p_j, cfg))
    layer = fused_t["layers"][1]
    assert set(layer) == {"ln_attn", "qkv", "o", "ln_mlp", "gateup", "down"}
    # LoRA on q and v only: a is [32, 4], b block-structured [4, 32 + 16 + 16]
    assert layer["qkv"]["lora"]["a"].shape == (32, 4)
    assert layer["qkv"]["lora"]["b"].shape == (4, 64)
    assert (layer["qkv"]["lora"]["b"][:2, 32:] == 0).all()
    assert (layer["qkv"]["lora"]["b"][2:, :48] == 0).all()


def test_fused_projections_equal_unfused():
    _, p = _llm()
    p_t = tq.quantize_llm(from_numpy_tree(p, "cpu"), 4)
    fused = tllama.fuse_decode_layout(p_t)
    h = _t(np.random.default_rng(9).standard_normal((2, 1, 32)).astype(np.float32))
    for a, b in zip(tllama._proj_qkv(fused["layers"][0], h, 2.0),
                    tllama._proj_qkv(p_t["layers"][0], h, 2.0)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(tllama._proj_mlp(fused["layers"][0], h, 2.0),
                               tllama._proj_mlp(p_t["layers"][0], h, 2.0),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_cache_matches_jax(dtype):
    """The port's cache is [L,B,Hkv,M,Dh]; JAX's position-minor
    [L,B,Hkv,Dh,M]."""
    rng = np.random.default_rng(10)
    k, v = (rng.standard_normal((2, 3, 2, 20, 8)).astype(np.float32) * s
            for s in (1.0, 3.0))
    k[:, 1] = 0.0                                      # an all-zero row
    jdt = jnp.dtype(dtype)
    kj, vj = (jnp.asarray(np.swapaxes(a, 3, 4), jdt) for a in (k, v))
    cj = jllama.quantize_cache(jllama.KVCache(kj, vj))
    ct = tllama.quantize_cache(tllama.KVCache(
        *(from_numpy_tree(np.swapaxes(np.asarray(a), 3, 4), "cpu") for a in (kj, vj))))
    assert ct.quantized and ct.k.dtype == torch.int8 and ct.k_scale.dtype == torch.bfloat16
    for got, ref in ((ct.k, cj.k), (ct.v, cj.v)):
        np.testing.assert_array_equal(got.numpy(), np.swapaxes(np.asarray(ref), 3, 4))
    for got, ref in ((ct.k_scale, cj.k_scale), (ct.v_scale, cj.v_scale)):
        assert got.shape == (2, 3, 2, 1, 1)
        np.testing.assert_array_equal(to_numpy_tree(got), np.asarray(ref, np.float32))
