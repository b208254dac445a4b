"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a host without an NVIDIA GPU. This file
imports no JAX, so on the machine with the card it runs without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: bf16 O atol/rtol 2e-2 (P is rounded to bf16 before PV), f32 O
1e-4, lse 1e-3; backward max|d| <= 2e-2 max|ref| in bf16 (P and dS are
rounded to bf16 before their products) and 1e-4 max|ref| in f32.
"""

import pytest
import torch

from avsr_tpu_torch.ops import attention as A


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _check(q, k, v, q_lens, kv_lens, causal, tol):
    o, lse = A.flash_attention(q, k, v, q_lens, kv_lens, causal)
    o_r, lse_r = A.flash_attention_reference(q, k, v, q_lens, kv_lens, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_r.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_r, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,tol", [(torch.bfloat16, 64, 2e-2),
                                         (torch.bfloat16, 128, 2e-2),
                                         (torch.float32, 64, 1e-4),
                                         (torch.float32, 128, 1e-4)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_matches_plain_version(cuda, dtype, D, tol, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((3, h, 300, D), generator=g, device=cuda, dtype=dtype)
               for h in (8, 2, 2))
    lens = torch.tensor([300, 171, 0], device=cuda)
    _check(q, k, v, lens, lens, causal, tol)


@pytest.mark.cuda
def test_flash_fwd_cross_lengths_and_launch_count(cuda):
    """Tq != Tk non-causal, rows without keys, and one count per launch."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 4, 257, 64), generator=g, device=cuda, dtype=torch.bfloat16)
    k, v = (torch.randn((2, 4, 390, 64), generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    before = A.launches
    _check(q, k, v, torch.tensor([257, 100], device=cuda),
           torch.tensor([390, 0], device=cuda), False, 2e-2)
    assert A.launches == before + 1
    with pytest.raises(ValueError):
        A.flash_attention(q, k, v, causal=True)          # causal needs Tq == Tk
    with pytest.raises(ValueError):
        A.flash_attention(q.transpose(2, 3), k, v)       # not contiguous


def _rel_err(a, ref):
    """max|a - ref| / max|ref| over the whole tensor (f32)."""
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,tol", [(torch.bfloat16, 64, 2e-2),
                                         (torch.bfloat16, 128, 2e-2),
                                         (torch.float32, 64, 1e-4),
                                         (torch.float32, 128, 1e-4)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_matches_plain_version(cuda, dtype, D, tol, causal):
    """dQ and dK/dV kernels against flash_attention_bwd_reference: GQA 8:2,
    a ragged batch with an empty row, a T that does not tile. Tolerance
    per tensor: max|d| <= tol * max|ref|."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn((3, h, 300, D), generator=g, device=cuda,
                               dtype=dtype) for h in (8, 2, 2, 8))
    lens = torch.tensor([300, 171, 0], device=cuda)
    o, lse = A.flash_attention(q, k, v, lens, lens, causal)
    before = (A.dq_launches, A.dkv_launches)
    dq = A.flash_bwd_dq(q, k, v, o, lse, do, lens, lens, causal)
    dk, dv = A.flash_bwd_dkv(q, k, v, o, lse, do, lens, lens, causal)
    assert (A.dq_launches, A.dkv_launches) == (before[0] + 1, before[1] + 1)
    refs = A.flash_attention_bwd_reference(q, k, v, o, lse, do, lens, lens,
                                           causal)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all(), name
        assert _rel_err(got, ref) <= tol, (name, _rel_err(got, ref))
    assert (dq[1, :, 171:] == 0).all() and (dq[2] == 0).all()
    assert (dk[2] == 0).all() and (dv[2] == 0).all()


@pytest.mark.cuda
def test_flash_function_grads_match_autograd(cuda):
    """FlashAttention (kernel forward + backward) against autograd through
    mha_reference, f32, causal GQA with ragged lengths."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, h, 320, 64), generator=g, device=cuda)
               for h in (4, 2, 2))
    lens = torch.tensor([320, 250], device=cuda)
    grad = torch.randn((2, 4, 320, 64), generator=g, device=cuda)
    grads = []
    for fn in (lambda q, k, v: A.FlashAttention.apply(q, k, v, lens, lens, True,
                                                       None),
               lambda q, k, v: A.mha_reference(q, k, v, causal=True,
                                               q_lens=lens, kv_lens=lens)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves).backward(grad)
        grads.append([t.grad for t in leaves])
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        assert _rel_err(a, b) <= 1e-4, (name, _rel_err(a, b))


@pytest.mark.cuda
def test_bare_flash_attention_refuses_gradients(cuda):
    """The forward kernel records no gradient, so it raises rather than
    silently cutting it; attention() takes the differentiable Function."""
    q = torch.randn((1, 2, 256, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        A.flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        A.flash_attention(q, q.detach(), q.detach())
    out = A.attention(q, q.detach(), q.detach(), causal=True)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
