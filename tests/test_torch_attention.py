"""PyTorch port's attention vs the JAX package (f32, CPU).

Tolerance: 1e-4 atol/rtol on O and lse. The JAX flash kernel runs in Pallas
interpret mode (block 64), its lse read from the kernel's compact layout.
The CUDA kernel itself is checked against its plain version on the card
(test_torch_kernels_cuda.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu_torch.ops import attention as tattn

# the JAX package's ops/__init__ re-exports a function named ``attention``
jattn = importlib.import_module("avsr_tpu.ops.attention")

TOL = dict(atol=1e-4, rtol=1e-4)


def _qkv(seed, B, H, Hkv, Tq, Tk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Tq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("causal,Hkv,ragged", [
    (False, 4, False), (True, 4, False), (False, 2, True), (True, 2, True),
])
def test_mha_reference_matches_jax(causal, Hkv, ragged):
    q, k, v = _qkv(0, 2, 4, Hkv, 24, 24, 16)
    lens = np.array([24, 9], np.int32) if ragged else None
    kw = dict(causal=causal)
    ref = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_lens=None if lens is None else jnp.asarray(lens),
                              kv_lens=None if lens is None else jnp.asarray(lens),
                              **kw)
    tl = None if lens is None else torch.from_numpy(lens)
    out = tattn.mha_reference(*_t(q, k, v), q_lens=tl, kv_lens=tl, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_mha_reference_row_without_keys_is_zero():
    q, k, v = _qkv(1, 2, 2, 2, 8, 8, 16)
    kv_lens = np.array([8, 0], np.int32)
    ref = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_lens=jnp.asarray(kv_lens))
    out = tattn.mha_reference(*_t(q, k, v), kv_lens=torch.from_numpy(kv_lens))
    assert np.all(out[1].numpy() == 0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _jax_flash_o_lse(q, k, v, q_lens, kv_lens, causal, block=64):
    """O from the JAX flash_attention and lse from its _fwd_call, unpacked
    from the compact [B, Hkv, 8*nq, block] layout to [B, H, Tq]."""
    B, H, Tq, D = q.shape
    Hkv = k.shape[1]
    assert Tq % block == 0 and k.shape[2] % block == 0
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ql, kl = jnp.asarray(q_lens), jnp.asarray(kv_lens)
    o = jattn.flash_attention(jq, jk, jv, causal=causal, q_lens=ql, kv_lens=kl,
                              interpret=True, block_q=block, block_k=block)
    lens = jnp.stack([ql, kl], axis=-1)
    _, lse = jattn._fwd_call(jq.reshape(B, Hkv, (H // Hkv) * Tq, D), jk, jv,
                             lens, causal, D ** -0.5, block, block, True, Tq)
    lse = np.asarray(lse)[:, :, ::8, :].reshape(B, H, Tq)
    return np.asarray(o), lse


@pytest.mark.parametrize("causal,H,Hkv,Tk", [
    (False, 4, 4, 192), (True, 4, 4, 128), (True, 4, 2, 128), (False, 4, 2, 128),
])
def test_flash_reference_matches_jax_kernel(causal, H, Hkv, Tk):
    B, Tq, D = 2, 128, 64
    q, k, v = _qkv(2, B, H, Hkv, Tq, Tk, D)
    q_lens = np.array([Tq, 77], np.int32)
    kv_lens = q_lens.copy() if causal else np.array([Tk, 101], np.int32)
    o_j, lse_j = _jax_flash_o_lse(q, k, v, q_lens, kv_lens, causal)
    o_t, lse_t = tattn.flash_attention_reference(
        *_t(q, k, v), torch.from_numpy(q_lens), torch.from_numpy(kv_lens),
        causal)
    valid = np.arange(Tq)[None, :] < q_lens[:, None]           # [B, Tq]
    for b in range(B):
        np.testing.assert_allclose(o_t[b][:, valid[b]].numpy(),
                                   o_j[b][:, valid[b]], **TOL)
        np.testing.assert_allclose(lse_t[b][:, valid[b]].numpy(),
                                   lse_j[b][:, valid[b]], **TOL)
    # rows past q_len: O = 0 and lse = +inf (the port's contract)
    assert np.all(o_t[1][:, ~valid[1]].numpy() == 0.0)
    assert np.all(np.isinf(lse_t[1][:, ~valid[1]].numpy()))
    # and O agrees with the plain attention on every row
    ref = tattn.mha_reference(*_t(q, k, v), causal=causal,
                              q_lens=torch.from_numpy(q_lens),
                              kv_lens=torch.from_numpy(kv_lens))
    np.testing.assert_allclose(o_t.numpy(), ref.numpy(), **TOL)


def test_flash_reference_row_without_keys():
    q, k, v = _qkv(3, 2, 2, 2, 64, 64, 64)
    o, lse = tattn.flash_attention_reference(
        *_t(q, k, v), torch.tensor([64, 64]), torch.tensor([64, 0]))
    assert torch.all(o[1] == 0) and torch.all(torch.isinf(lse[1]))
    assert torch.isfinite(lse[0]).all()


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    q, k, v = _t(*_qkv(4, 2, 4, 2, 256, 256, 64))
    lens = torch.tensor([256, 200])
    before = tattn.launches
    o, lse = tattn.flash_attention(q, k, v, lens, lens, True)
    o_ref, lse_ref = tattn.flash_attention_reference(q, k, v, lens, lens, True)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    out = tattn.attention(q, k, v, causal=True, q_lens=lens, kv_lens=lens,
                          use_kernel="always")
    assert torch.equal(out, o_ref)
    assert tattn.launches == before


def test_dispatch_predicate(monkeypatch):
    """Kernel shapes go to flash_attention, the rest to mha_reference."""
    calls = []
    orig = tattn.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    q, k, v = _t(*_qkv(5, 1, 2, 2, 256, 256, 64))
    q50, k50, v50 = _t(*_qkv(5, 1, 2, 2, 50, 50, 64))
    monkeypatch.setattr(tattn, "flash_attention", spy)
    tattn.attention(q, k, v, use_kernel="always")
    tattn.attention(q50, k50, v50, use_kernel="always")               # T < 256
    tattn.attention(q, k, v, use_kernel="always",
                    kv_valid=torch.ones(1, 256, dtype=torch.bool))
    tattn.attention(q, k, v, use_kernel="auto")                       # CPU
    tattn.attention(q, k, v, use_kernel="never")
    assert calls == [q.shape]


@pytest.mark.parametrize("D", [192, 256])
def test_dispatch_sends_wide_heads_to_mha_reference(monkeypatch, D):
    """Head widths the kernels do not take (192; JAX sends every multiple
    of 64 to its kernel) go to mha_reference by the dispatch rule, even
    under "always". 256, the connectors' head width over the 2048-wide
    LLM, takes the kernel route (its plain version on the CPU) and agrees
    with mha_reference (f32 sums in another order: 1e-5)."""
    calls = []
    orig = tattn.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    q, k, v = _t(*_qkv(6, 1, 2, 1, 256, 256, D))
    lens = torch.tensor([200])
    monkeypatch.setattr(tattn, "flash_attention", spy)
    out = tattn.attention(q, k, v, causal=True, q_lens=lens, kv_lens=lens,
                          use_kernel="always")
    ref = tattn.mha_reference(q, k, v, causal=True, q_lens=lens, kv_lens=lens)
    if D in tattn.KERNEL_HEAD_DIMS:
        assert D == 256 and calls == [q.shape]
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert calls == []
        assert torch.equal(out, ref)
