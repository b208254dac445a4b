"""The port's attention at the head widths between and above its compiled
kernels vs the JAX package (f32, CPU).

The port's kernels take every multiple of 64 (``kernel_takes``), JAX's
rule. Through 512 the CUDA sources compile 64, 128, 256 and 512, and the
widths between run the next wider kernel on zero-padded operands; above 512
the panel kernels take the width itself. Here:

  * the JAX ``flash_attention(..., interpret=True)`` forward and its custom
    VJP (the Pallas dQ and dK/dV kernels in interpret mode) against the
    port's ``attention`` on the kernel route (``use_kernel="always"``:
    ``FlashAttention`` with the plain versions on CPU tensors) and on the
    plain route (``use_kernel="never"``: ``mha_reference``), at D = 192,
    320, 384, 448 and 512, and above 512 at 576, 640 (Llama-2-13B's
    connectors) and 1024 (70B's), causal GQA and non-causal MHA, ragged
    lengths;
  * the pad route's arithmetic: the plain versions at the padded width,
    with the true width's scale and the pad columns sliced off, equal the
    plain versions at the true width;
  * the dispatch: the port's predicate is JAX's (``D % 64 == 0``) at every
    width, and every such width takes the kernel route; the forward's
    operand width (bf16: the true width; f32: the compiled one).

Tolerance: 1e-5 atol + 1e-5 rtol on O and every gradient (dQ on valid rows:
the JAX dq kernel leaves rows past q_len unconstrained), the pad route's
included (its products sum over zero columns too: f32 sums in another
order); the pad columns of its outputs are exactly zero.
The CUDA kernels are held against the same plain versions on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py`` phases 26 and 27).
"""

import functools
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
WIDE = (192, 320, 384, 448, 512, 576, 640, 1024)

torch.set_num_threads(1)

# causal, H, Hkv, T, q_lens, kv_lens (T = 256: the dispatch threshold, so
# that the port's "always" takes the kernel route)
CASES = {
    "causal_gqa_ragged": (True, 4, 2, 256, [256, 141], [256, 141]),
    "cross_mha_ragged": (False, 2, 2, 256, [256, 77], [256, 190]),
}


def _inputs(case, D, seed=0, B=2):
    causal, H, Hkv, T, ql, kl = CASES[case]
    rng = np.random.default_rng(seed + D)
    arrs = dict(q=rng.standard_normal((B, H, T, D)), k=rng.standard_normal((B, Hkv, T, D)),
                v=rng.standard_normal((B, Hkv, T, D)), do=rng.standard_normal((B, H, T, D)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return causal, arrs, np.array(ql, np.int32), np.array(kl, np.int32)


@functools.lru_cache(maxsize=2)
def _jax(case, D):
    """O and (dq, dk, dv) of the JAX Pallas kernels in interpret mode (once
    per case and width: both routes of the port compare with them)."""
    causal, a, ql, kl = _inputs(case, D)

    def f(q, k, v):
        return jattn.flash_attention(q, k, v, causal=causal, q_lens=jnp.asarray(ql),
                                     kv_lens=jnp.asarray(kl), interpret=True,
                                     block_q=128, block_k=128)

    o, vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in "qkv"))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(a["do"]))]


def _port(case, D, use_kernel):
    causal, a, ql, kl = _inputs(case, D)
    leaves = [torch.from_numpy(a[n]).requires_grad_() for n in "qkv"]
    o = tattn.attention(*leaves, causal=causal, q_lens=torch.from_numpy(ql),
                        kv_lens=torch.from_numpy(kl), use_kernel=use_kernel)
    o.backward(torch.from_numpy(a["do"]))
    return o.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("use_kernel", ["always", "never"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("D", WIDE)
def test_forward_and_grads_match_jax_kernel(D, case, use_kernel, monkeypatch):
    calls = []
    orig = tattn.FlashAttention.apply
    monkeypatch.setattr(tattn.FlashAttention, "apply",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    o_j, g_j = _jax(case, D)
    o_t, g_t = _port(case, D, use_kernel)
    # the kernel route on "always" (every D here is a kernel width), the
    # plain attention on "never"
    assert len(calls) == (use_kernel == "always")
    _, _, ql, _ = _inputs(case, D)
    valid = np.arange(o_t.shape[2])[None, :] < ql[:, None]          # [B, Tq]
    for b in range(o_t.shape[0]):
        np.testing.assert_allclose(o_t[b][:, valid[b]], o_j[b][:, valid[b]], **TOL)
        np.testing.assert_allclose(g_t[0][b][:, valid[b]], g_j[0][b][:, valid[b]], **TOL)
    assert np.all(o_t[1][:, ~valid[1]] == 0.0) and np.all(g_t[0][1][:, ~valid[1]] == 0.0)
    for got, want in zip(g_t[1:], g_j[1:]):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [192, 320, 384, 448])
def test_pad_route_is_exact(D, causal):
    """What the CUDA wrappers do at a width that is not compiled, in the
    plain versions: zero-pad q, k, v (and O, dO) to ``kernel_width(D)``,
    run at the true width's scale, slice the pad columns off."""
    Dp = tattn.kernel_width(D)
    assert Dp in tattn.COMPILED_HEAD_DIMS and D < Dp
    rng = np.random.default_rng(D)
    q, do = (torch.from_numpy(rng.standard_normal((2, 4, 96, D)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 80, D)).astype(np.float32))
            for _ in range(2))
    ql, kl = (torch.tensor([96, 33]), torch.tensor([80, 33])) if not causal else (None, None)
    if causal:
        k, v = (torch.cat([t, t[:, :, :16]], dim=2) for t in (k, v))   # Tq == Tk
    scale = D ** -0.5
    qp, kp, vp, dop = tattn._pad_heads(Dp, q, k, v, do)
    assert qp.shape[-1] == Dp and torch.equal(qp[..., :D], q) and not qp[..., D:].any()
    o, lse = tattn.flash_attention_reference(q, k, v, ql, kl, causal)
    op, lsep = tattn.flash_attention_reference(qp, kp, vp, ql, kl, causal, scale)
    np.testing.assert_allclose(op[..., :D].numpy(), o.numpy(), **TOL)
    assert not op[..., D:].any()
    np.testing.assert_allclose(lsep.numpy(), lse.numpy(), **TOL)
    grads = tattn.flash_attention_bwd_reference(q, k, v, o, lse, do, ql, kl, causal)
    (op_,) = tattn._pad_heads(Dp, o)
    grads_p = tattn.flash_attention_bwd_reference(qp, kp, vp, op_, lse, dop, ql, kl,
                                                  causal, scale)
    for g, gp in zip(grads, grads_p):
        np.testing.assert_allclose(gp[..., :D].numpy(), g.numpy(), **TOL)
        assert not gp[..., D:].any()


def test_dispatch_predicate_is_jax_rule_up_to_512():
    """For every head width through 512 the port sends to its kernels what
    the JAX package sends to its Pallas kernel (D % 64 == 0, at Tq and Tk
    >= 256 and no kv_valid), each to a compiled width at least as wide."""
    for D in range(1, 513):
        assert tattn.kernel_takes(D) == (D % 64 == 0), D
        if D % 64 == 0:
            assert tattn.kernel_width(D) in tattn.COMPILED_HEAD_DIMS
            assert tattn.kernel_width(D) >= D


def test_dispatch_predicate_is_jax_rule_beyond_512():
    """Above 512 too the port's predicate is JAX's, and the panel kernels
    take each width as it is (no padding)."""
    for D in range(513, 8193):
        assert tattn.kernel_takes(D) == (D % 64 == 0), D
        if D % 64 == 0:
            assert tattn.kernel_width(D) == D


@pytest.mark.parametrize("D", [64, 128, 192, 256, 320, 384, 448, 512, 576, 640, 1024,
                               2048])
def test_dispatch_routes_each_width_as_jax_does(D, monkeypatch):
    """Both packages' ``attention`` with the kernel forced on: JAX's Pallas
    call and the port's ``FlashAttention`` are spied (and return q), so
    only the route is compared: each takes its kernel at every width."""
    j_calls, t_calls = [], []
    monkeypatch.setattr(jattn, "flash_attention", lambda q, *a, **kw: j_calls.append(D) or q)
    monkeypatch.setattr(jattn, "mha_reference", lambda q, *a, **kw: q)
    monkeypatch.setattr(tattn.FlashAttention, "apply", lambda q, *a: t_calls.append(D) or q)
    monkeypatch.setattr(tattn, "mha_reference", lambda q, *a, **kw: q)
    q = np.zeros((1, 1, 256, D), np.float32)
    jattn.attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), use_pallas="always")
    tq = torch.from_numpy(q)
    tattn.attention(tq, tq, tq, use_kernel="always")
    assert j_calls == [D]
    assert t_calls == [D]


@pytest.mark.parametrize("D", range(64, 513, 64))
def test_forward_operand_width(D):
    """The forward wrapper's operand width at every multiple of 64 through
    512: bfloat16 passes the operands at their own width (the kernel's TMA
    tensor maps zero-fill the panels past it and store O at it, so nothing
    is padded or sliced), float32 at the compiled width ``kernel_width(D)``
    (the scalar kernels read by pointer, so the widths between compiled ones
    are zero-padded, as the backward's are)."""
    assert tattn.operand_width(D, torch.bfloat16) == D
    assert tattn.operand_width(D, torch.float32) == tattn.kernel_width(D)
    assert tattn.kernel_width(D) in tattn.COMPILED_HEAD_DIMS


def test_pad_heads_counts_the_tensors_it_pads():
    """``_pad_heads`` counts each tensor it pads (``pad_copies``) and returns
    a tensor that already has the width as it is, uncounted."""
    t = torch.zeros((1, 1, 4, 384))
    before = tattn.pad_copies
    (same,) = tattn._pad_heads(384, t)
    assert same is t and tattn.pad_copies == before
    (padded,) = tattn._pad_heads(512, t)
    assert padded.shape[-1] == 512 and tattn.pad_copies == before + 1
