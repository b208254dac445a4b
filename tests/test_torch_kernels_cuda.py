"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a host without an NVIDIA GPU. This file
imports no JAX, so on the machine with the card it runs without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: bf16 O atol/rtol 2e-2 (P is rounded to bf16 before PV), f32 O
1e-4, lse 1e-3; backward max|d| <= 2e-2 max|ref| in bf16 (P and dS are
rounded to bf16 before their products) and 1e-4 max|ref| in f32, delta
1e-4 (f32 sums in another order); the
weight-only matmuls max|d| <= 1e-4 max|ref| (the kernel and its plain
version differ only in the order of their f32 sums).
"""

import json

import pytest
import torch

from avsr_tpu_torch.ops import attention as A
from avsr_tpu_torch.ops import qmatmul as Q
from avsr_tpu_torch.ops import quant


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
                                         (torch.bfloat16, 256, 2e-2),
                                         (torch.bfloat16, 512, 2e-2),
                                         (torch.float32, 64, 1e-4),
                                         (torch.float32, 128, 1e-4),
                                         (torch.float32, 256, 1e-4),
                                         (torch.float32, 512, 1e-4),
                                         (torch.bfloat16, 640, 2e-2),
                                         (torch.bfloat16, 1024, 2e-2),
                                         (torch.float32, 640, 1e-4),
                                         (torch.float32, 1024, 1e-4)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_matches_plain_version(cuda, dtype, D, tol, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((3, h, 300, D), generator=g, device=cuda, dtype=dtype)
               for h in (8, 2, 2))
    lens = torch.tensor([300, 171, 0], device=cuda)
    _check(q, k, v, lens, lens, causal, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [*range(64, 513, 64), 576, 640, 768, 896, 1024])
def test_attention_launches_the_kernels_at_every_width(cuda, D):
    """attention() on CUDA tensors at head widths the kernels take (those
    between the compiled 64, 128, 256 and 512 on zero-padded operands, and
    the panel kernels above 512): one forward, one dQ and one dK/dV launch
    under grad, and O and the gradients of q, k, v within bf16 rounding of
    mha_reference's (max|d| <= 2e-2 max|ref|)."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v, do = (torch.randn((2, h, 260, D), generator=g, device=cuda,
                               dtype=torch.bfloat16) for h in (4, 2, 2, 4))
    lens = torch.tensor([260, 133], device=cuda)
    outs = []
    for use_kernel in ("auto", "never"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (A.launches, A.dq_launches, A.dkv_launches)
        o = A.attention(*leaves, causal=True, q_lens=lens, kv_lens=lens,
                        use_kernel=use_kernel)
        o.backward(do)
        torch.cuda.synchronize()
        got = (A.launches - before[0], A.dq_launches - before[1],
               A.dkv_launches - before[2])
        assert got == ((1, 1, 1) if use_kernel == "auto" else (0, 0, 0)), got
        outs.append([o.detach(), *(t.grad for t in leaves)])
    for name, a, ref in zip(("o", "dq", "dk", "dv"), *outs):
        assert a.shape == ref.shape and _rel_err(a, ref) <= 2e-2, (name, _rel_err(a, ref))


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


def _check_bwd(q, k, v, do, q_lens, kv_lens, causal, tol):
    """Both backward kernels (dQ handing its delta to dK/dV) against
    flash_attention_bwd_reference and the plain delta; one count per
    launch. Tolerance per tensor: max|d| <= tol * max|ref|."""
    o, lse = A.flash_attention(q, k, v, q_lens, kv_lens, causal)
    before = (A.dq_launches, A.dkv_launches)
    dq, delta = A.flash_bwd_dq(q, k, v, o, lse, do, q_lens, kv_lens, causal)
    dk, dv = A.flash_bwd_dkv(q, k, v, lse, delta, do, q_lens, kv_lens, causal)
    assert (A.dq_launches, A.dkv_launches) == (before[0] + 1, before[1] + 1)
    refs = A.flash_attention_bwd_reference(q, k, v, o, lse, do, q_lens,
                                           kv_lens, causal)
    _, delta_r = A.flash_bwd_dq_reference(q, k, v, o, lse, do, q_lens, kv_lens,
                                          causal)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all(), name
        assert _rel_err(got, ref) <= tol, (name, _rel_err(got, ref))
    # delta: f32 sums of the same products in another order
    torch.testing.assert_close(delta, delta_r, atol=1e-4, rtol=1e-4)
    return dq, dk, dv, delta


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,tol", [(torch.bfloat16, 64, 2e-2),
                                         (torch.bfloat16, 128, 2e-2),
                                         (torch.bfloat16, 256, 2e-2),
                                         (torch.bfloat16, 512, 2e-2),
                                         (torch.float32, 64, 1e-4),
                                         (torch.float32, 128, 1e-4),
                                         (torch.float32, 256, 1e-4),
                                         (torch.float32, 512, 1e-4),
                                         (torch.bfloat16, 640, 2e-2),
                                         (torch.bfloat16, 1024, 2e-2),
                                         (torch.float32, 640, 1e-4),
                                         (torch.float32, 1024, 1e-4)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_matches_plain_version(cuda, dtype, D, tol, causal):
    """dQ and dK/dV kernels against flash_attention_bwd_reference: GQA 8:2,
    a ragged batch with an empty row, a T that does not tile."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn((3, h, 300, D), generator=g, device=cuda,
                               dtype=dtype) for h in (8, 2, 2, 8))
    lens = torch.tensor([300, 171, 0], device=cuda)
    dq, dk, dv, delta = _check_bwd(q, k, v, do, lens, lens, causal, tol)
    assert (dq[1, :, 171:] == 0).all() and (dq[2] == 0).all()
    assert (dk[2] == 0).all() and (dv[2] == 0).all()
    assert (delta[1, :, 171:] == 0).all() and (delta[2] == 0).all()


# the clustered bf16 forward (D > 512): causal GQA over ragged rows, and
# non-causal MHA with Tq != Tk, ragged rows and a row without keys
CLUSTER_CASES = {
    "causal_gqa": (4, 2, 300, 300, True, [300, 217], [300, 217]),
    "cross_mha_empty": (4, 4, 300, 290, False, [300, 131], [290, 0]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
@pytest.mark.parametrize("D", [576, 640, 1024, 2048])
def test_clustered_panel_forward(cuda, D, case):
    """The bf16 forward above 512 runs its ceil(D / 256) column groups as one
    thread-block cluster (3, 3, 4 and 8 CTAs here) that computes S once:
    O within 2e-2 x max|ref| of flash_attention_reference, lse within 1e-3
    (+inf on the same rows), rows past q_len and the row without keys
    zero; a second run gives O and lse bit for bit."""
    H, Hkv, Tq, Tk, causal, ql, kl = CLUSTER_CASES[case]
    assert A.kernel_cluster(D, torch.bfloat16) == -(-D // 256)
    g = torch.Generator(device=cuda).manual_seed(D)
    q = torch.randn((2, H, Tq, D), generator=g, device=cuda, dtype=torch.bfloat16)
    k, v = (torch.randn((2, Hkv, Tk, D), generator=g, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    ql, kl = torch.tensor(ql, device=cuda), torch.tensor(kl, device=cuda)
    o, lse = A.flash_attention(q, k, v, ql, kl, causal)
    o2, lse2 = A.flash_attention(q, k, v, ql, kl, causal)
    o_r, lse_r = A.flash_attention_reference(q, k, v, ql, kl, causal)
    torch.cuda.synchronize()
    assert _rel_err(o, o_r) <= 2e-2, _rel_err(o, o_r)
    torch.testing.assert_close(lse, lse_r, atol=1e-3, rtol=0)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for b in range(2):
        assert (o[b, :, int(ql[b]):] == 0).all()
        if int(kl[b]) == 0:
            assert (o[b] == 0).all() and torch.isinf(lse[b]).all()


@pytest.mark.cuda
def test_widths_past_the_largest_cluster_keep_the_panel_kernel(cuda):
    """The bf16 forward's cluster at every width: ceil(D / 256) CTAs above
    512 up to 8 (the largest portable cluster), none elsewhere or in f32;
    at 2112 (9 column groups) it runs the per-group panel kernel, whose groups
    each compute S: still within 2e-2 x max|ref| of the plain version."""
    for D in range(64, 4097, 64):
        groups = -(-D // 256)
        want = groups if 512 < D and groups <= 8 else 0
        assert A.kernel_cluster(D, torch.bfloat16) == want, D
        assert A.kernel_cluster(D, torch.float32) == 0, D
    D = 2112
    assert A.kernel_cluster(D, torch.bfloat16) == 0
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, h, 260, D), generator=g, device=cuda, dtype=torch.bfloat16)
               for h in (4, 2, 2))
    lens = torch.tensor([260, 133], device=cuda)
    _check(q, k, v, lens, lens, True, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [192, 320, 384, 448])
def test_pad_route_forward_is_the_padded_kernel_bit_for_bit(cuda, D):
    """The bf16 forward at a width between the compiled ones reads its
    operands at their own width (no copy: ``pad_copies`` unchanged) and
    gives O and lse equal bit for bit to the compiled-width kernel run on
    operands zero-padded by hand (with the true width's scale), whose pad
    columns of O are zero."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q = torch.randn((2, 4, 300, D), generator=g, device=cuda, dtype=torch.bfloat16)
    k, v = (torch.randn((2, 2, 300, D), generator=g, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    lens = torch.tensor([300, 171], device=cuda)
    for causal in (True, False):
        before = A.pad_copies
        o, lse = A.flash_attention(q, k, v, lens, lens, causal)
        assert A.pad_copies == before and o.shape == q.shape
        Dp = A.kernel_width(D)
        pad = [torch.nn.functional.pad(t, (0, Dp - D)) for t in (q, k, v)]
        o_p, lse_p = A.flash_attention(*pad, lens, lens, causal, D ** -0.5)
        torch.cuda.synchronize()
        assert torch.equal(o, o_p[..., :D]) and torch.equal(lse, lse_p)
        assert not o_p[..., D:].any()


# name: B, H, Hkv, Tq, Tk, q_lens, kv_lens, causal (the main path's shapes
# at a small batch, and the edges the tiles must handle)
SHAPES = {
    "whisper_500_of_512": (2, 16, 16, 512, 512, [500, 500], [500, 500], False),
    "llm_prefill_533_gqa": (2, 32, 8, 533, 533, [533, 533], [533, 533], True),
    "llm_train_581_of_672": (2, 32, 8, 672, 672, [581, 581], [581, 581], True),
    "kv_len_0_row": (2, 8, 2, 300, 300, [300, 257], [300, 0], False),
    "tk_below_tq": (2, 8, 2, 390, 257, [390, 300], [257, 200], False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_flash_kernels_at_main_path_shapes(cuda, name):
    """bf16 forward, dQ and dK/dV against their plain versions at the main
    path's shapes (small B) and at the edges: a row with queries but no
    keys, Tk < Tq."""
    B, H, Hkv, Tq, Tk, ql, kl, causal = SHAPES[name]
    g = torch.Generator(device=cuda).manual_seed(7)
    q, do = (torch.randn((B, H, Tq, 64), generator=g, device=cuda,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, Hkv, Tk, 64), generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    ql, kl = torch.tensor(ql, device=cuda), torch.tensor(kl, device=cuda)
    _check(q, k, v, ql, kl, causal, 2e-2)
    dq, dk, dv, _ = _check_bwd(q, k, v, do, ql, kl, causal, 2e-2)
    for b in range(B):
        if int(kl[b]) == 0:
            assert (dq[b] == 0).all() and (dk[b] == 0).all() and (dv[b] == 0).all()
        assert (dk[b, :, int(kl[b]):] == 0).all() and (dv[b, :, int(kl[b]):] == 0).all()


@pytest.mark.cuda
def test_flash_kernels_replay_in_a_cuda_graph(cuda):
    """The forward and both backward wrappers captured in one CUDA graph
    and replayed give the eager results bit for bit (the kernels are
    deterministic: one owner per output tile, no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, do = (torch.randn((2, 8, 300, 64), generator=g, device=cuda,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((2, 2, 300, 64), generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    lens = torch.tensor([300, 217], device=cuda, dtype=torch.int32)

    def run():
        o, lse = A.flash_attention(q, k, v, lens, lens, True)
        dq, delta = A.flash_bwd_dq(q, k, v, o, lse, do, lens, lens, True)
        return (o, lse, dq, *A.flash_bwd_dkv(q, k, v, lse, delta, do, lens,
                                             lens, True))

    eager = run()
    again = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                                    # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    for e, a, c in zip(eager, again, captured):
        assert torch.equal(e, a) and torch.equal(e, c)


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


def _qnode(bits, K, N, g, device):
    w = torch.randn((K, N), generator=g, device=device)
    return quant.quantize_tensor(w, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 9, 17, 64])
@pytest.mark.parametrize("K,N", [(2048, 3072), (1000, 2050), (512, 1000), (1000, 2048)])
def test_qmatmul_matches_plain_version(cuda, bits, M, K, N):
    """int8 and int4 against qmatmul_reference: ragged M (9 and 17 take
    more than one n8 tile of x), N not a multiple of the 128-column tile
    (2050 also not of 4 or 16: the byte-load paths), K/2 = 500 not a
    multiple of the int4 kernel's 8-row k step, K = 1000 not a multiple of
    the int8 kernel's 16-row k step (with N = 2048 through its TMA ring),
    bf16 and f32 x, f32 and bf16 output; one count per launch."""
    g = torch.Generator(device=cuda).manual_seed(4)
    qp = _qnode(bits, K, N, g, cuda)
    for x_dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((M, K), generator=g, device=cuda).to(x_dtype)
        before = (Q.int8_launches, Q.int4_launches)
        y = Q.qmatmul(x, qp)
        ref = Q.qmatmul_reference(x, qp)
        torch.cuda.synchronize()
        assert (Q.int8_launches - before[0], Q.int4_launches - before[1]) == \
            ((1, 0) if bits == 8 else (0, 1))
        assert y.dtype == torch.float32 and y.shape == (M, N)
        assert _rel_err(y, ref) <= 1e-4, _rel_err(y, ref)
        yb = Q.qmatmul(x, qp, out_dtype=torch.bfloat16)
        # one rounding of nearly equal f32 sums: at most a bf16 step apart
        torch.testing.assert_close(yb.float(), ref.to(torch.bfloat16).float(),
                                   atol=1e-4 * ref.abs().max().item(), rtol=1e-2)
    with pytest.raises(ValueError):
        Q.qmatmul(torch.zeros((M, K + 2), device=cuda), qp)   # K does not match


# name: K, N of the flagship's decode products at M = 8 (the int8 ones of
# model.use_8bit and the int8 lm head over the 2048-padded vocab)
MAIN_SHAPES = {"qkv": (2048, 3072), "o": (2048, 2048), "gateup": (2048, 16384),
               "down": (8192, 2048), "lm_head": (2048, 129024)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MAIN_SHAPES))
def test_qmatmul_int8_at_main_path_shapes(cuda, name):
    """The int8 kernel at each decode shape of the flagship (M = 8, bf16 x,
    f32 scale and output) against its plain version: max|d| <= 1e-4
    max|ref| (the two differ only in the order of their f32 sums)."""
    K, N = MAIN_SHAPES[name]
    g = torch.Generator(device=cuda).manual_seed(9)
    qp = quant.quantize_tensor(0.02 * torch.randn((K, N), generator=g, device=cuda), 8)
    x = torch.randn((8, K), generator=g, device=cuda, dtype=torch.bfloat16)
    y = Q.qmatmul(x, qp)
    ref = Q.qmatmul_reference(x, qp)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    assert _rel_err(y, ref) <= 1e-4, _rel_err(y, ref)


# the four projections at M = B x W = 40 rows: a beam step of the serving
# preset (8 utterances, 5 beams)
BEAM_SHAPES = {n: MAIN_SHAPES[n] for n in ("qkv", "o", "gateup", "down")}


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", sorted(BEAM_SHAPES))
def test_qmatmul_at_beam_shapes(cuda, bits, name):
    """int8 and int4 at M = 40, the beam step's rows, against the plain
    version: max|d| <= 1e-4 max|ref|."""
    K, N = BEAM_SHAPES[name]
    g = torch.Generator(device=cuda).manual_seed(10)
    qp = quant.quantize_tensor(0.02 * torch.randn((K, N), generator=g, device=cuda), bits)
    x = torch.randn((40, K), generator=g, device=cuda, dtype=torch.bfloat16)
    y = Q.qmatmul(x, qp)
    ref = Q.qmatmul_reference(x, qp)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    assert _rel_err(y, ref) <= 1e-4, _rel_err(y, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 40])
def test_qmatmul_int4_head(cuda, M):
    """The int4 head of a spec_draft_bits=4 self-draft, [2048 x 129024]
    over the 2048-padded vocabulary: against the plain version (max|d| <=
    1e-4 max|ref|), and the same bits on every launch."""
    g = torch.Generator(device=cuda).manual_seed(11)
    qp = quant.quantize_tensor(0.02 * torch.randn((2048, 129024), generator=g, device=cuda), 4)
    x = torch.randn((M, 2048), generator=g, device=cuda, dtype=torch.bfloat16)
    y = Q.qmatmul(x, qp)
    again = Q.qmatmul(x, qp)
    ref = Q.qmatmul_reference(x, qp)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert _rel_err(y, ref) <= 1e-4, _rel_err(y, ref)


@pytest.mark.cuda
def test_split_decode_step_kernel_path_matches_dequantize_path(cuda):
    """``llama_decode_step_split`` in the serving preset's layout (int4
    projections, int8 head, int8 prefix cache) at M = 40 rows: 4 int4
    launches per layer and one int8 head launch, and logits against the
    dequantize path with the serving gates: in f32 mean|d| <= 1e-2 std and
    max|d| no larger than the bf16 step's own distance from f32 (the
    kernels round x to bf16, the dequantize path does not)."""
    from avsr_tpu_torch.convert import cast_tree
    from avsr_tpu_torch.core.config import LLMConfig, LoRAConfig
    from avsr_tpu_torch.models import llama as L

    cfg = LLMConfig(vocab_size=4096, d_model=512, n_layers=2, n_heads=8, n_kv_heads=2,
                    ffn_dim=1024)
    lora = LoRAConfig(r=4, alpha=8)
    g = torch.Generator(device=cuda).manual_seed(12)
    p = L.add_lora(g, L.init_llama(g, cfg), cfg, lora)
    for layer in p["layers"]:
        for node in layer.values():
            if "lora" in node:
                node["lora"]["b"] = 0.05 * torch.randn(node["lora"]["b"].shape,
                                                       generator=g, device=cuda)
    p = L.fuse_decode_layout(quant.quantize_llm(p, 4, lm_head_bits=8))
    B, W, hd = 8, 5, cfg.d_model // cfg.n_heads
    pre = L.quantize_cache(L.KVCache(*(torch.randn((2, B, 2, 256, hd), generator=g,
                                                   device=cuda) for _ in range(2))))
    suf = [torch.randn((2, B * W, 2, 128, hd), generator=g, device=cuda) for _ in range(2)]
    x = torch.randn((B * W, 1, cfg.d_model), generator=g, device=cuda)
    plens = torch.randint(100, 257, (B,), generator=g, device=cuda)

    def step(params, dt, uk):
        return L.llama_decode_step_split(
            params, cfg, x=x.to(dt), prefix_cache=pre,
            suffix_cache=L.KVCache(*(t.to(dt) for t in suf)), prefix_lens=plens, step=3,
            lora=lora, compute_dtype=dt, use_kernel=uk)[0]

    p32, p16 = cast_tree(p, torch.float32), cast_tree(p, torch.bfloat16)
    before = (Q.int8_launches, Q.int4_launches)
    auto = step(p32, torch.float32, "auto")
    assert (Q.int8_launches - before[0], Q.int4_launches - before[1]) == (1, 4 * cfg.n_layers)
    ref = step(p32, torch.float32, "never")
    bf16 = step(p16, torch.bfloat16, "never")
    assert (Q.int8_launches - before[0], Q.int4_launches - before[1]) == (1, 4 * cfg.n_layers)
    torch.cuda.synchronize()
    d = (auto - ref).abs()
    assert auto.shape == (B * W, cfg.vocab_size) and torch.isfinite(auto).all()
    assert d.mean() <= 1e-2 * ref.std(), (d.mean().item(), ref.std().item())
    assert d.max() <= (bf16 - ref).abs().max(), (d.max().item(),
                                                 (bf16 - ref).abs().max().item())


@pytest.mark.cuda
def test_qmatmul_on_two_streams_at_once(cuda):
    """int8 and int4 products with a K split launched on two streams at
    once: each stream has its own tile counters and scratch, so every
    result matches the plain version."""
    g = torch.Generator(device=cuda).manual_seed(10)
    shapes = ((8, 2048, 2048), (4, 2048, 2048), (8, 8192, 2048), (4, 8192, 2048))
    nodes = [_qnode(bits, K, N, g, cuda) for bits, K, N in shapes]
    xs = [torch.randn((8, K), generator=g, device=cuda, dtype=torch.bfloat16)
          for _, K, _ in shapes]
    refs = [Q.qmatmul_reference(x, qp) for x, qp in zip(xs, nodes)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs: list[list[torch.Tensor]] = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(25):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                # each stream runs every product, in another order
                order = range(len(nodes)) if i == 0 else reversed(range(len(nodes)))
                outs[i] += [(j, Q.qmatmul(xs[j], nodes[j])) for j in order]
    torch.cuda.synchronize()
    for per_stream in outs:
        for j, y in per_stream:
            assert _rel_err(y, refs[j]) <= 1e-4, (j, _rel_err(y, refs[j]))


@pytest.mark.cuda
def test_qmatmul_first_split_launch_under_capture_raises(cuda):
    """A stream's first launch with a K split makes its counters, which a
    CUDA-graph capture cannot: it raises and asks for a warm-up."""
    g = torch.Generator(device=cuda).manual_seed(11)
    qp = _qnode(8, 2048, 2048, g, cuda)
    x = torch.randn((8, 2048), generator=g, device=cuda, dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    # PyTorch hands out pooled streams again: forget what this one launched
    Q._workspaces.pop((x.device, side.cuda_stream), None)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="warm-up"):
        with torch.cuda.graph(graph, stream=side):
            Q.qmatmul(x, qp)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 3072), (8, 8192, 2048), (17, 1000, 2050),
                                   (8, 2048, 2048), (8, 2048, 129024)])
def test_qmatmul_is_deterministic(cuda, bits, M, K, N):
    """Two launches on the same inputs, and a replayed CUDA graph of one,
    give the same bits: the K split is added in split order by the tile's
    last CTA, with no float atomics. The capture runs on a stream that has
    launched the kernel before (its counters exist)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    qp = _qnode(bits, K, N, g, cuda)
    x = torch.randn((M, K), generator=g, device=cuda, dtype=torch.bfloat16)
    first = Q.qmatmul(x, qp)
    again = Q.qmatmul(x, qp)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        Q.qmatmul(x, qp)                          # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = Q.qmatmul(x, qp)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, captured)


@pytest.mark.cuda
def test_qdot_auto_never_reaches_the_plain_version_on_cuda(cuda, monkeypatch):
    """Under "auto" a CUDA tensor at decode shapes launches the kernel;
    the plain version is never called, and "never" dequantizes."""
    def refuse(*a, **kw):
        raise AssertionError("qmatmul_reference called for a CUDA tensor")

    monkeypatch.setattr(Q, "qmatmul_reference", refuse)
    g = torch.Generator(device=cuda).manual_seed(5)
    qp = _qnode(4, 256, 384, g, cuda)
    qp["scale"] = qp["scale"].to(torch.bfloat16)       # as cast_frozen leaves it
    x = torch.randn((2, 3, 256), generator=g, device=cuda, dtype=torch.bfloat16)
    before = Q.int4_launches
    y = quant.qdot(x, qp)
    assert Q.int4_launches == before + 1 and y.shape == (2, 3, 384)
    assert y.dtype == torch.bfloat16
    y_never = quant.qdot(x, qp, use_kernel="never")
    assert Q.int4_launches == before + 1
    # the dequantize path rounds every weight (q * scale) to bf16
    assert _rel_err(y, y_never) <= 1e-2, _rel_err(y, y_never)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 64])
def test_qdot_carries_the_gradient_on_the_card(cuda, bits, M):
    """Under grad mode a quantized product at M <= 64 launches the kernel
    through QDot and returns dx = dy @ dequant(qp)^T, the dequantize path's
    dx; the packed leaves get none."""
    g = torch.Generator(device=cuda).manual_seed(M + bits)
    qp = _qnode(bits, 512, 384, g, cuda)
    x = torch.randn((M, 512), generator=g, device=cuda, dtype=torch.bfloat16)
    dy = torch.randn((M, 384), generator=g, device=cuda, dtype=torch.bfloat16)
    grads = []
    for use_kernel in ("auto", "never"):
        before = Q.int8_launches + Q.int4_launches
        xl = x.clone().requires_grad_()
        y = quant.qdot(xl, qp, use_kernel=use_kernel)
        assert type(y.grad_fn).__name__ == "QDotBackward"
        assert Q.int8_launches + Q.int4_launches == before + (use_kernel == "auto")
        y.backward(dy)
        grads.append(xl.grad)
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1])
    assert _rel_err(grads[0], dy.float() @ quant.dequantize(qp, torch.bfloat16).float().t()) <= 1e-2


@pytest.mark.cuda
def test_bare_qmatmul_refuses_gradients(cuda):
    """The qmatmul kernels record no gradient, so the bare wrapper raises on
    an x that requires grad (as the bare flash_attention does); qdot is the
    differentiable path."""
    g = torch.Generator(device=cuda).manual_seed(9)
    qp = _qnode(4, 256, 256, g, cuda)
    x = torch.randn((8, 256), generator=g, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        Q.qmatmul(x, qp)
    with torch.no_grad():
        Q.qmatmul(x, qp)
    quant.qdot(x, qp).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# checkpoints of a train state on the card
# ---------------------------------------------------------------------------

# the widened tiny config of tests/test_torch_train.py, without YAML (the
# card's host has no PyYAML): the LLM's head width 64 and its packed width
# 288 take the flash kernels
TINY_TRAIN = ["data.batch_size=2", "data.max_label_length=24",
              "data.audio_buckets=100,200", "data.video_buckets=4,8",
              "model.modality=both", "model.whisper.d_model=32",
              "model.whisper.n_heads=2", "model.whisper.n_layers=1",
              "model.whisper.max_frames=500", "model.clip.image_size=16",
              "model.clip.patch_size=8", "model.clip.d_model=24",
              "model.clip.n_heads=2", "model.clip.n_layers=1",
              "model.llm.vocab_size=260", "model.llm.d_model=128",
              "model.llm.n_layers=2", "model.llm.n_heads=2",
              "model.llm.n_kv_heads=1", "model.llm.ffn_dim=256",
              "model.llm.max_seq_len=512", "model.lora.r=2", "model.lora.alpha=4",
              "model.lora.dropout=0", "training.warmup_steps=2",
              "training.learning_rate=1e-3", "mesh.remat=false"]


def _train_state(device, extra=()):
    from avsr_tpu_torch.core.config import load_config
    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.train.state import cast_frozen, create_train_state

    cfg = load_config(None, TINY_TRAIN + list(extra))
    p = init_avsr_model(cfg.model, seed=0, device="cpu")
    g = torch.Generator().manual_seed(3)
    for layer in p["llm"]["layers"]:        # LoRA b is zero at init
        for node in layer.values():
            if isinstance(node, dict) and "lora" in node:
                b = node["lora"]["b"]
                node["lora"]["b"] = 0.05 * torch.randn(b.shape, generator=g)
    p = cast_frozen({k: _to(v, device) for k, v in p.items()}, cfg.model)
    return cfg, create_train_state(p, cfg, 10)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _train_batch(device):
    from avsr_tpu_torch.models.avsr import Batch
    from avsr_tpu_torch.train.step import microbatch

    g = torch.Generator().manual_seed(0)
    b = Batch(mel=torch.randn((2, 80, 500), generator=g),
              mel_lens=torch.tensor([500, 380], dtype=torch.int32),
              frames=torch.randn((2, 4, 3, 16, 16), generator=g),
              frame_lens=torch.tensor([4, 3], dtype=torch.int32),
              prompt_tokens=torch.tensor([[256, 72, 105, 33, 9]] * 2, dtype=torch.int32),
              labels=torch.randint(0, 258, (2, 24), generator=g, dtype=torch.int32),
              label_lens=torch.tensor([24, 17], dtype=torch.int32))
    return microbatch(Batch(*[None if x is None else x.to(device) for x in b]), 1)


def _leaves(state):
    from avsr_tpu_torch.train.state import path_leaves
    return path_leaves(state.state_dict())


@pytest.mark.cuda
def test_train_state_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """A train state saved on the card restores into a CPU state bit for
    bit, and a checkpoint of that CPU state restores back onto the card."""
    from avsr_tpu_torch.train.checkpoint import CheckpointManager
    from avsr_tpu_torch.train.step import make_train_step

    cfg, st = _train_state(cuda)
    step = make_train_step(cfg)
    batch = _train_batch(cuda)
    for i in range(3):
        step(st, batch, i)
    m = CheckpointManager(tmp_path / "card")
    m.save(st)
    m.wait()
    _, cpu = _train_state("cpu")
    CheckpointManager(tmp_path / "card").restore(cpu)
    want = _leaves(st)
    for k, v in _leaves(cpu).items():
        if isinstance(v, torch.Tensor):
            assert v.device.type == "cpu" and torch.equal(v, want[k].cpu()), k
        else:
            assert v == want[k], k
    m = CheckpointManager(tmp_path / "cpu")
    m.save(cpu)
    m.wait()
    _, back = _train_state(cuda)
    CheckpointManager(tmp_path / "cpu").restore(back)
    for k, v in _leaves(back).items():
        if isinstance(v, torch.Tensor) and not k.endswith("/step"):
            assert v.is_cuda and torch.equal(v, want[k]), k


@pytest.mark.cuda
def test_resumed_step_equals_uninterrupted_step_on_the_card(cuda, tmp_path):
    """Two steps, a checkpoint, a fresh state restored from it: its third
    step (flash forward, dQ, dK/dV on the card) equals the third step of
    the state that never stopped."""
    from avsr_tpu_torch.train.checkpoint import CheckpointManager
    from avsr_tpu_torch.train.step import make_train_step

    cfg, st = _train_state(cuda)
    step = make_train_step(cfg)
    batch = _train_batch(cuda)
    for i in range(2):
        step(st, batch, i)
    m = CheckpointManager(tmp_path)
    m.save(st)
    m.wait()
    _, resumed = _train_state(cuda)
    m.restore(resumed)
    launches = (A.launches, A.dq_launches, A.dkv_launches)
    m_a, m_b = step(st, batch, 2), step(resumed, batch, 2)
    assert A.dq_launches - launches[1] == A.dkv_launches - launches[2] == 2 * 2
    assert m_a["loss"] == m_b["loss"] and m_a["grad_norm"] == m_b["grad_norm"]
    for k, v in _leaves(resumed).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, _leaves(st)[k]), k


# ---------------------------------------------------------------------------
# mixture of experts on the card
# ---------------------------------------------------------------------------

# both MoE forms on TINY_TRAIN: the moe connector and block 1 of the LLM
MOE = ["model.connector_type=moe", "model.moe_experts=4", "model.llm.moe_experts=4",
       "model.llm.moe_every=2", "model.moe_capacity_factor=0.5",
       "model.llm.moe_capacity_factor=0.5"]


def _moe_layer(device):
    from avsr_tpu_torch.core.config import LLMConfig
    from avsr_tpu_torch.models.llama import init_llama

    cfg = LLMConfig(vocab_size=64, d_model=256, n_layers=1, n_heads=4, n_kv_heads=2,
                    ffn_dim=512, moe_experts=8, moe_topk=2, moe_capacity_factor=0.5)
    layer = init_llama(torch.Generator().manual_seed(0), cfg)["layers"][0]
    return cfg, {k: {n: t.to(device) for n, t in v.items()} for k, v in layer.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["train", "rowwise", "dropless"])
def test_moe_layer_forward_and_backward_match_the_cpu(cuda, mode):
    """The LLM's MoE FFN (f32, TF32 off) on the card against the same call
    on the CPU: the same routing (the dispatch exactly), y and the aux
    losses within 1e-5, and the gradients of x, the router and the experts
    within 1e-5 of max|ref| (f32 sums in another order)."""
    from avsr_tpu_torch.models.llama import _moe_mlp
    from avsr_tpu_torch.ops import moe

    cfg, layer_c = _moe_layer("cpu")
    _, layer_g = _moe_layer(cuda)
    g = torch.Generator().manual_seed(1)
    h = torch.randn((4, 64, 256), generator=g)
    valid = torch.arange(64)[None, :] < torch.tensor([64, 50, 9, 33])[:, None]
    w = torch.randn((4, 64, 256), generator=g)
    kw = dict(valid=valid, rowwise=mode == "rowwise", dropless=mode == "dropless")
    outs = []
    for layer, dev in ((layer_c, "cpu"), (layer_g, cuda)):
        leaves = [layer["router"]["w"], *layer["experts"].values()]
        x = h.to(dev).requires_grad_(True)
        for t in leaves:
            t.requires_grad_(True)
        y, lb, z = _moe_mlp(layer, x, cfg, **{**kw, "valid": valid.to(dev)})
        grads = torch.autograd.grad((y * w.to(dev)).sum() + lb + z, [x, *leaves])
        logits = h.reshape(-1, 256).to(dev) @ layer["router"]["w"].detach()
        disp = moe.route(logits, valid.reshape(-1).to(dev), 2, 64)[0]
        outs.append([t.detach().cpu() for t in (y, lb, z, disp, *grads)])
    (y_c, lb_c, z_c, d_c, *g_c), (y_g, lb_g, z_g, d_g, *g_g) = outs
    assert torch.equal(d_c, d_g)
    torch.testing.assert_close(y_g, y_c, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(torch.stack([lb_g, z_g]), torch.stack([lb_c, z_c]),
                               atol=1e-6, rtol=1e-5)
    for a, ref in zip(g_g, g_c):
        assert _rel_err(a, ref) <= 1e-5


@pytest.mark.cuda
def test_moe_train_step_repeats_bit_for_bit(cuda):
    """A train step with both MoE forms (the connector's experts and routers
    train, the LLM's block 1 is MoE; flash forward, dQ and dK/dV on the
    card), run from two identical states, gives bit-equal states and
    metrics: nothing on the gradient path adds with float atomics."""
    from avsr_tpu_torch.train.step import make_train_step

    cfg, a = _train_state(cuda, MOE)
    _, b = _train_state(cuda, MOE)
    step = make_train_step(cfg)
    batch = _train_batch(cuda)
    launches = A.dq_launches
    for i in range(2):
        m_a, m_b = step(a, batch, i), step(b, batch, i)
        assert m_a == m_b and m_a["moe_lb"] > 0
    assert A.dq_launches - launches == 2 * 2 * 2
    want = _leaves(a)
    for k, v in _leaves(b).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, want[k]), k


# ---------------------------------------------------------------------------
# the serving engine on the card
# ---------------------------------------------------------------------------

PRESET = ["model.use_4bit=true", "decode.lm_head_bits=8", "decode.kv_cache_dtype=int8"]


def _engine_setup(cuda, extra=()):
    import numpy as np

    from avsr_tpu_torch.cli.common import load_decode_params
    from avsr_tpu_torch.core.config import load_config
    from avsr_tpu_torch.data.dataset import Sample
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer

    cfg = load_config(None, TINY_TRAIN + ["runtime.compute_dtype=bfloat16",
                                          "decode.max_new_tokens=12", *extra])
    params = load_decode_params(cfg, None, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    samples = [Sample(f"u{i}", (0.3 * rng.standard_normal(n)).astype(np.float32),
                      rng.integers(0, 256, (4, 16, 16, 3)).astype(np.uint8), "", [1])
               for i, n in enumerate((8000, 16000, 12000, 20000, 6400, 9600))]
    return cfg, params, ByteTokenizer(), samples


@pytest.mark.cuda
def test_preset_engine_chunk_launches_per_step(cuda):
    """The serving preset through the engine (4 slots, ragged budgets):
    every chunk step launches 4 int4 products per layer and the int8 head
    at M = S, and every stage the int8 head at M = W; nothing else
    launches a qmatmul kernel."""
    from avsr_tpu_torch.infer.engine import ServingEngine

    cfg, params, tok, samples = _engine_setup(cuda, PRESET)
    eng = ServingEngine(params, cfg, tok, num_slots=4, k_steps=8)
    eng.warmup(samples[0])
    before = (Q.int8_launches, Q.int4_launches)
    got = eng.transcribe(samples, max_new_per_request=[12, 3, 9, 12, 5, 7])
    torch.cuda.synchronize()
    k = eng.steps_launched
    assert k > 0 and eng.decode_steps_total <= k
    assert (Q.int8_launches - before[0], Q.int4_launches - before[1]) == (
        k + eng.stages_run, 4 * cfg.model.llm.n_layers * k)
    assert [len(g) for g in got] == [12, 3, 9, 12, 5, 7]
    assert eng.cache.k.dtype == torch.int8


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], PRESET], ids=["bf16", "preset"])
def test_engine_first_launches_on_a_scheduler_thread(cuda, extra):
    """An engine built on one thread and warmed up and driven on another
    (as the server's scheduler does, on the default stream) gives the
    tokens of the same engine driven on the building thread."""
    import threading

    from avsr_tpu_torch.infer.engine import ServingEngine

    cfg, params, tok, samples = _engine_setup(cuda, extra)
    budgets = [12, 4, 9, 12, 5, 8]
    out, errors = {}, []

    def serve():
        try:
            eng = out["eng"]
            eng.warmup(samples[0])
            out["tokens"] = eng.transcribe(samples, max_new_per_request=budgets)
        except Exception as e:        # surfaced in the main thread
            errors.append(e)

    out["eng"] = ServingEngine(params, cfg, tok, num_slots=4, k_steps=8)
    th = threading.Thread(target=serve)
    th.start()
    th.join(timeout=600)
    assert not errors, errors
    main = ServingEngine(params, cfg, tok, num_slots=4, k_steps=8)
    main.warmup(samples[0])
    assert out["tokens"] == main.transcribe(samples, max_new_per_request=budgets)


@pytest.mark.cuda
@pytest.mark.parametrize("T,lens", [
    (512, [499] * 8),                               # 10 s: 499 frames
    (512, [499, 311, 260, 499, 17, 400, 256, 1]),
    (1504, [1499] * 8)])                            # 30 s: 1499 frames
@pytest.mark.parametrize("form", ["bf16", "f32", "bwd_bf16"])
def test_flash_fwd_at_the_hubert_shape(cuda, T, lens, form):
    """HuBERT-base's attention: 12 heads of 64, non-causal, the frames of
    10 s or 30 s of audio padded to a multiple of 16 rows, in each form the
    ``hubert_base`` paths launch: the bf16 forward (serving, training), the
    f32 forward (f32 decoding) and the bf16 dQ and dK/dV (training with
    ``unfreeze_layer_norms``)."""
    g = torch.Generator(device=cuda).manual_seed(16)
    dtype = torch.float32 if form == "f32" else torch.bfloat16
    q, k, v, do = (torch.randn((8, 12, T, 64), generator=g, device=cuda, dtype=dtype)
                   for _ in range(4))
    lens = torch.tensor(lens, device=cuda)
    if form == "bwd_bf16":
        dq, dk, dv, _ = _check_bwd(q, k, v, do, lens, lens, False, 2e-2)
        assert bool((dq[0, :, int(lens[0]):] == 0).all())
        return
    _check(q, k, v, lens, lens, False, 1e-4 if form == "f32" else 2e-2)
    o, _ = A.flash_attention(q, k, v, lens, lens, False)
    assert bool((o[0, :, int(lens[0]):] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T,lens", [
    (500, [500] * 8),                               # 10 s: 500 Whisper frames
    (512, [500, 311, 260, 512, 17, 400, 256, 1]),
    (375, [375] * 8)])                              # adaptive at 30 s: 1500 -> 375
@pytest.mark.parametrize("form", ["bf16", "f32", "bwd_bf16", "bwd_f32"])
def test_flash_kernels_at_the_connector_shape(cuda, T, lens, form):
    """The ``attention`` and ``adaptive`` connectors' attention: 8 heads of
    256 over the 2048-wide LLM, non-causal, over the audio features, in
    each form their paths launch: the bf16 and f32 forward (decoding) and
    dQ and dK/dV (training)."""
    g = torch.Generator(device=cuda).manual_seed(17)
    dtype = torch.float32 if form.endswith("f32") else torch.bfloat16
    q, k, v, do = (torch.randn((8, 8, T, 256), generator=g, device=cuda, dtype=dtype)
                   for _ in range(4))
    lens = torch.tensor(lens, device=cuda)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    if form.startswith("bwd"):
        dq, dk, dv, _ = _check_bwd(q, k, v, do, lens, lens, False, tol)
        assert bool((dq[0, :, int(lens[0]):] == 0).all())
        assert bool((dk[0, :, int(lens[0]):] == 0).all())
        return
    _check(q, k, v, lens, lens, False, tol)
    o, _ = A.flash_attention(q, k, v, lens, lens, False)
    assert bool((o[0, :, int(lens[0]):] == 0).all())


@pytest.mark.cuda
def test_attention_at_head_width_256_launches_the_kernels(cuda):
    """``attention()`` at D = 256 with Tq, Tk >= 256 takes the kernels (the
    forward, and dQ with dK/dV under grad), never mha_reference."""
    g = torch.Generator(device=cuda).manual_seed(18)
    q, k, v = (torch.randn((2, 8, 300, 256), generator=g, device=cuda,
                           dtype=torch.bfloat16, requires_grad=True) for _ in range(3))
    lens = torch.tensor([300, 200], device=cuda)
    before = (A.launches, A.dq_launches, A.dkv_launches)
    out = A.attention(q, k, v, q_lens=lens, kv_lens=lens)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (A.launches, A.dq_launches, A.dkv_launches) == tuple(b + 1 for b in before)


@pytest.mark.cuda
def test_safetensors_reader_on_this_host(cuda, tmp_path):
    """The hand-written safetensors reader, on the card's host (which has
    no ``safetensors`` package): a file written by ``chip_smoke.py``'s
    writer reads back bit for bit in every dtype, sharded or not, and
    ``load_pretrained`` upcasts to f32 on the card and fills a tied head."""
    import json

    import chip_smoke
    from avsr_tpu_torch.core import hf_files

    g = torch.Generator(device=cuda).manual_seed(17)
    tensors = {"model.embed_tokens.weight": torch.randn((64, 32), generator=g, device=cuda,
                                                        dtype=torch.bfloat16),
               "a.f32": torch.randn((3, 5, 7), generator=g, device=cuda),
               "b.f16": torch.randn((9,), generator=g, device=cuda, dtype=torch.float16),
               "c.i64": torch.arange(6, device=cuda).reshape(2, 3),
               "d.empty": torch.zeros((0, 4), device=cuda)}
    host = {k: v.cpu() for k, v in tensors.items()}
    chip_smoke.write_safetensors(tmp_path / "model-00001-of-00002.safetensors",
                                 {k: host[k] for k in list(host)[:2]})
    chip_smoke.write_safetensors(tmp_path / "model-00002-of-00002.safetensors",
                                 {k: host[k] for k in list(host)[2:]})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {
        k: f"model-0000{1 if i < 2 else 2}-of-00002.safetensors"
        for i, k in enumerate(host)}}))
    (tmp_path / "config.json").write_text(json.dumps({"tie_word_embeddings": True}))
    got = hf_files.read_weights(tmp_path)
    assert got.keys() == host.keys()
    for k, v in host.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    sd, _ = hf_files.load_pretrained(tmp_path, cuda)
    assert sd["model.embed_tokens.weight"].device.type == cuda.type
    assert sd["model.embed_tokens.weight"].dtype == torch.float32
    assert sd["lm_head.weight"] is sd["model.embed_tokens.weight"]
    assert torch.equal(sd["model.embed_tokens.weight"],
                       tensors["model.embed_tokens.weight"].float())
    assert sd["c.i64"].dtype == torch.int64


@pytest.mark.cuda
def test_profile_train_then_decode_traces_every_launch(cuda, tmp_path):
    """``cli/profile.py`` on the card, the train profile and then the decode
    profile in one process (as ``chip_smoke.py``'s phase 20 runs them): the
    CLI's own check holds (each trace's kernels by name equal the wrappers'
    counters over the traced steps; it raises otherwise), and the flash
    kernels are in both traces."""
    from avsr_tpu_torch.cli import profile

    flag = ["data.audio_buckets=1000,2000,3000", "model.max_seq_len=1536",
            "model.whisper.n_layers=2", "model.clip.n_layers=1", "model.llm.n_layers=2",
            "data.batch_size=2", "decode.max_new_tokens=8"]
    for mode in ("train", "decode"):
        out = tmp_path / mode
        assert profile.main(["--device", "cuda", "--mode", mode, "--steps", "2",
                             "--output_dir", str(out), *flag]) == 0
        report = json.loads((out / "profile_report.json").read_text())
        assert report["kernels_in_trace"]["flash_fwd"] > 0


@pytest.mark.cuda
def test_profile_windows_keep_every_kernel_of_their_steps(cuda, tmp_path):
    """A profiler window on the card loses the kernel records of its first
    launches now and then (the trace check: up to 664 of a decode
    profile's), and a kernel's converted start can precede its launch's;
    the profile CLI opens each window with a guard call and its readers cut
    it by correlation id (``cli/profile.py::trace_steps``,
    ``trace_events``), so in each of 12 windows every launch of the traced
    step (a 0.1 s spin and 4000 small kernels) has its kernel and nothing
    of the guard call is left."""
    from avsr_tpu_torch.cli import profile

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    x = torch.zeros(256, device=cuda)

    def step():
        torch.cuda._sleep(200_000_000)
        for _ in range(4000):
            x.add_(1.0)
        torch.cuda.synchronize(cuda)

    for i in range(12):
        trace = tmp_path / f"trace{i}.json"
        profile.trace_steps(step, 1, acts, trace)
        events = profile.trace_events(trace)
        kernels = {e.get("args", {}).get("correlation") for e in events
                   if e.get("cat") == "kernel"}
        launches = [e.get("args", {}).get("correlation") for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "LaunchKernel" in e["name"]]
        assert len(kernels) == len(launches) == 4001 and set(launches) == kernels, i
        assert not any(e.get("name") == profile.GUARD for e in events)
