"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a host without an NVIDIA GPU. This file
imports no JAX, so on the machine with the card it runs without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: bf16 O atol/rtol 2e-2 (P is rounded to bf16 before PV), f32 O
1e-4, lse 1e-3.
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
