"""The port's attention backward vs the JAX package (f32, CPU).

The JAX side is ``jax.vjp`` of ``flash_attention(..., interpret=True)``:
its custom VJP runs the Pallas dQ and dK/dV kernels in interpret mode.
The port's side is its plain backward (``flash_attention_bwd_reference``,
fed with the port's own forward O and lse), the kernels' wrappers called
in turn with the dQ wrapper's delta handed to dK/dV, and the autograd
Function ``FlashAttention`` (the wrappers take the plain versions on CPU
tensors).
Tolerance: 1e-5 atol + 1e-5 rtol on every gradient. dQ is compared on
valid rows only: the JAX dq kernel leaves rows past q_len unconstrained,
the port gives them 0 (asserted). The CUDA kernels are held against the
same plain versions on the card (test_torch_kernels_cuda.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu_torch.ops import attention as tattn

# the JAX package's ops/__init__ re-exports a function named ``attention``
jattn = importlib.import_module("avsr_tpu.ops.attention")

TOL = dict(atol=1e-5, rtol=1e-5)

torch.set_num_threads(1)

# causal, H, Hkv, Tq, Tk, q_lens, kv_lens
CASES = {
    "causal_gqa_untiled_ragged": (True, 4, 2, 100, 100, [100, 61], [100, 61]),
    "cross_gqa_untiled_ragged": (False, 4, 2, 100, 150, [100, 61], [150, 97]),
    "causal_mha_full": (True, 4, 4, 128, 128, [128, 128], [128, 128]),
    "cross_mha_ragged": (False, 2, 2, 128, 128, [128, 77], [128, 101]),
}


def _inputs(case, seed=0, D=64, B=2):
    causal, H, Hkv, Tq, Tk, ql, kl = CASES[case]
    rng = np.random.default_rng(seed)
    arrs = dict(q=rng.standard_normal((B, H, Tq, D)),
                k=rng.standard_normal((B, Hkv, Tk, D)),
                v=rng.standard_normal((B, Hkv, Tk, D)),
                do=rng.standard_normal((B, H, Tq, D)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return causal, arrs, np.array(ql, np.int32), np.array(kl, np.int32)


def _jax_grads(case):
    causal, a, ql, kl = _inputs(case)

    def f(q, k, v):
        return jattn.flash_attention(q, k, v, causal=causal,
                                     q_lens=jnp.asarray(ql),
                                     kv_lens=jnp.asarray(kl), interpret=True,
                                     block_q=64, block_k=64)

    _, vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in "qkv"))
    return [np.asarray(g) for g in vjp(jnp.asarray(a["do"]))]


def _port_grads(case, path):
    causal, a, ql, kl = _inputs(case)
    ql_t, kl_t = torch.from_numpy(ql), torch.from_numpy(kl)
    q, k, v, do = (torch.from_numpy(a[n]) for n in ("q", "k", "v", "do"))
    if path == "reference":
        o, lse = tattn.flash_attention_reference(q, k, v, ql_t, kl_t, causal)
        return tattn.flash_attention_bwd_reference(q, k, v, o, lse, do, ql_t,
                                                   kl_t, causal)
    if path == "wrappers":
        # the kernels' wrappers as FlashAttention calls them: dQ hands its
        # delta to dK/dV (CPU tensors take the plain versions)
        o, lse = tattn.flash_attention(q, k, v, ql_t, kl_t, causal)
        dq, delta = tattn.flash_bwd_dq(q, k, v, o, lse, do, ql_t, kl_t, causal)
        return (dq, *tattn.flash_bwd_dkv(q, k, v, lse, delta, do, ql_t, kl_t,
                                         causal))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.FlashAttention.apply(*leaves, ql_t, kl_t, causal, None).backward(do)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("path", ["reference", "wrappers", "function"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_vjp(case, path):
    jdq, jdk, jdv = _jax_grads(case)
    dq, dk, dv = (g.numpy() for g in _port_grads(case, path))
    _, _, ql, _ = _inputs(case)
    valid = np.arange(dq.shape[2])[None, :] < ql[:, None]         # [B, Tq]
    for b in range(dq.shape[0]):
        np.testing.assert_allclose(dq[b][:, valid[b]], jdq[b][:, valid[b]], **TOL)
        assert np.all(dq[b][:, ~valid[b]] == 0.0)
    np.testing.assert_allclose(dk, jdk, **TOL)
    np.testing.assert_allclose(dv, jdv, **TOL)


@pytest.mark.parametrize("case", ["causal_gqa_untiled_ragged", "cross_mha_ragged"])
def test_function_matches_autograd_through_mha_reference(case):
    """The Function's gradients equal plain autograd through the masked
    softmax attention (Tq == Tk, so both causal alignments agree)."""
    causal, a, ql, kl = _inputs(case, seed=1)
    ql_t, kl_t = torch.from_numpy(ql), torch.from_numpy(kl)
    grads = []
    for fn in (lambda q, k, v: tattn.FlashAttention.apply(q, k, v, ql_t, kl_t,
                                                          causal, None),
               lambda q, k, v: tattn.mha_reference(q, k, v, causal=causal,
                                                   q_lens=ql_t, kv_lens=kl_t)):
        leaves = [torch.from_numpy(a[n]).requires_grad_() for n in "qkv"]
        fn(*leaves).backward(torch.from_numpy(a["do"]))
        grads.append([t.grad for t in leaves])
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, **TOL)


def test_attention_kernel_path_carries_gradients():
    """attention() on the kernel path (T >= 256) differentiates through the
    Function: gradients equal the plain path's, with a non-contiguous dO
    (a transpose-reshape, as in the LLM block)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, h, 256, 64)).astype(np.float32)
               for h in (4, 2, 2))
    w = torch.from_numpy(rng.standard_normal((256, 4 * 64)).astype(np.float32))
    lens = torch.tensor([256, 190])
    grads = []
    for use_kernel in ("always", "never"):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = tattn.attention(*leaves, causal=True, q_lens=lens, kv_lens=lens,
                              use_kernel=use_kernel)
        (out.transpose(1, 2).reshape(2, 256, 256) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, r in zip(*grads):
        assert g is not None and float(g.abs().max()) > 0
        torch.testing.assert_close(g, r, **TOL)


def test_rows_without_keys_get_zero_gradients():
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 2, 64, 64))
                                    .astype(np.float32)) for _ in range(4))
    ql, kl = torch.tensor([64, 64]), torch.tensor([64, 0])
    o, lse = tattn.flash_attention_reference(q, k, v, ql, kl)
    dq, dk, dv = tattn.flash_attention_bwd_reference(q, k, v, o, lse, do, ql, kl)
    for g in (dq, dk, dv):
        assert torch.all(g[1] == 0) and torch.isfinite(g).all()
        assert float(g[0].abs().max()) > 0


def test_cpu_bwd_wrappers_take_plain_versions_and_count_nothing():
    causal, a, ql, kl = _inputs("causal_gqa_untiled_ragged")
    q, k, v, do = (torch.from_numpy(a[n]) for n in ("q", "k", "v", "do"))
    ql, kl = torch.from_numpy(ql), torch.from_numpy(kl)
    o, lse = tattn.flash_attention(q, k, v, ql, kl, causal)
    before = (tattn.launches, tattn.dq_launches, tattn.dkv_launches)
    dq, delta = tattn.flash_bwd_dq(q, k, v, o, lse, do, ql, kl, causal)
    dk, dv = tattn.flash_bwd_dkv(q, k, v, lse, delta, do, ql, kl, causal)
    ref = tattn.flash_attention_bwd_reference(q, k, v, o, lse, do, ql, kl, causal)
    for g, r in zip((dq, dk, dv), ref):
        assert torch.equal(g, r)
    assert (tattn.launches, tattn.dq_launches, tattn.dkv_launches) == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_delta_is_rowsum_of_do_times_o(case):
    """The delta that dQ hands to dK/dV: rowsum(dO * O) in f32 on the rows
    below q_len, exactly 0 past q_len (and on rows without keys)."""
    causal, a, ql, kl = _inputs(case, seed=4)
    q, k, v, do = (torch.from_numpy(a[n]) for n in ("q", "k", "v", "do"))
    ql_t, kl_t = torch.from_numpy(ql), torch.from_numpy(kl)
    o, lse = tattn.flash_attention_reference(q, k, v, ql_t, kl_t, causal)
    _, delta = tattn.flash_bwd_dq_reference(q, k, v, o, lse, do, ql_t, kl_t,
                                            causal)
    assert delta.dtype == torch.float32 and delta.shape == q.shape[:3]
    want = (do.double() * o.double()).sum(dim=-1)
    for b in range(q.shape[0]):
        n = int(ql[b])
        torch.testing.assert_close(delta[b, :, :n].double(), want[b, :, :n],
                                   atol=1e-5, rtol=1e-5)
        assert torch.all(delta[b, :, n:] == 0.0)
    # a batch row without keys has O = 0, so its delta is 0 as well
    kl0 = kl_t.clone()
    kl0[1] = 0
    o0, lse0 = tattn.flash_attention_reference(q, k, v, ql_t, kl0, causal)
    _, delta0 = tattn.flash_bwd_dq_reference(q, k, v, o0, lse0, do, ql_t, kl0,
                                             causal)
    assert torch.all(delta0[1] == 0.0)
