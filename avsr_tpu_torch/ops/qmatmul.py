"""Weight-only int8/int4 matmul at decode shapes: the plain PyTorch version
and the wrapper of the Hopper kernels of ``csrc/qmatmul.cu``.

The port of ``avsr_tpu/ops/qmatmul.py`` (the Pallas ``_int8_kernel`` and
``_int4_kernel``). Both compute, for x [M, K] and a quantized node of
``ops/quant.py`` ({"qw": int8[K, N]} or {"qw4h": int8[K/2, N]}, plus
{"scale": [N]}):

    y[M, N] = scale[None, :] * (bf16(x) @ q)

x is rounded to bf16 even when it is f32 (the TPU kernel feeds bf16 to its
matrix unit), every product of a bf16 value and a small integer is exact in
f32, the sum is f32, and the scale is applied once after the K loop. The
kernel writes its result in ``out_dtype`` (f32 by default); that is the f32
result rounded once, as a cast after it would be.

``qmatmul`` takes :func:`qmatmul_reference` for a CPU tensor and launches
the kernel for a CUDA tensor (or raises). ``int8_launches`` and
``int4_launches`` count the launches. ``eligible`` is the dispatch rule of
``ops/quant.py::qdot``.
"""

from __future__ import annotations

import ctypes

import torch

# Decode and beam-search shapes only: the JAX package's threshold (set on a
# TPU, kept until it is measured on the card). Past it the product is
# compute-shaped and the dequantize-then-matmul path is the right one.
MAX_SMALL_M = 64

# Launches of each CUDA kernel (incremented once per launch, nowhere else).
int8_launches = 0
int4_launches = 0

# The kernel's tiling (csrc/qmatmul.cu: BN, MT): a CTA owns 128 output
# columns of 8 rows of x. The K rows are split over CTAs until the grid has
# two CTAs per SM, with at least MIN_SPLIT_ROWS weight rows each, and so
# that a CTA's x columns (f32, 8 rows, both K halves for int4) fit in
# MAX_X_BYTES of shared memory; the partial sums are added in a second,
# deterministic pass.
BLOCK_N = 128
BLOCK_M = 8
MIN_SPLIT_ROWS = 64
MAX_X_BYTES = 96 * 1024


def eligible(m: int, k: int, qp, *, use_kernel: str = "auto",
             cuda: bool = False) -> bool:
    """Whether ``qdot`` takes the kernel (or, on the CPU under "always",
    its plain version) for m rows of x with k columns.

    "never": no. "auto": only for a CUDA tensor. Then the node must use the
    current packing ("qw" or "qw4h"; the legacy "qw4" always dequantizes),
    m <= MAX_SMALL_M, and for int4 k must be even."""
    if use_kernel not in ("auto", "always", "never"):
        raise ValueError(f"use_kernel must be auto|always|never, got {use_kernel!r}")
    if use_kernel == "never" or (use_kernel == "auto" and not cuda):
        return False
    if m > MAX_SMALL_M or "qw4" in qp:
        return False
    if "qw4h" in qp:
        return k % 2 == 0
    return "qw" in qp


def _weight(qp) -> tuple[torch.Tensor, bool]:
    if "qw4h" in qp:
        return qp["qw4h"], True
    if "qw" in qp:
        return qp["qw"], False
    raise ValueError("qmatmul takes a node with 'qw' or 'qw4h' (upgrade "
                     "legacy 'qw4' leaves with upgrade_legacy_int4)")


def _check_k(x: torch.Tensor, w: torch.Tensor, int4: bool) -> None:
    K = x.shape[-1]
    rows = w.shape[0]
    if x.ndim != 2 or (2 * rows if int4 else rows) != K:
        raise ValueError(
            f"qmatmul: x {tuple(x.shape)} does not match the "
            f"{'int4 packed' if int4 else 'int8'} weight {tuple(w.shape)} "
            f"(K must be {'2 x ' if int4 else ''}{rows})")


def qmatmul_reference(x: torch.Tensor, qp,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of the kernels: bf16-rounded x, the integer weight
    in f32, an f32 matmul, then the scale; in ``out_dtype``."""
    from avsr_tpu_torch.ops.quant import unpacked

    w, int4 = _weight(qp)
    _check_k(x, w, int4)
    xb = x.to(torch.bfloat16).float()
    y = torch.matmul(xb, unpacked(qp).float()) * qp["scale"].float()[None, :]
    return y.to(out_dtype)


def splits(m: int, rows: int, n: int, sms: int, bits: int) -> tuple[int, int]:
    """(number of K splits, weight rows per split) of one launch: enough
    CTAs for two per SM where the rows allow it, and no more rows per CTA
    than its staged x allows."""
    ctas = -(-n // BLOCK_N) * -(-m // BLOCK_M)
    cap = MAX_X_BYTES // (BLOCK_M * 4 * (2 if bits == 4 else 1))
    s = max(1, min(-(-2 * sms // ctas), rows // MIN_SPLIT_ROWS), -(-rows // cap))
    per = max(1, -(-rows // s))
    return -(-rows // per), per


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# dtype codes shared with csrc/qmatmul.cu
_KINDS = {torch.bfloat16: 0, torch.float32: 1}


def _kernel_fn(symbol: str):
    """The C entry point ``symbol`` of ``csrc/qmatmul.cu``, built on first
    use: pointers x, w, scale, out, partial; then M, K, N, splits,
    split_rows, the dtype codes of x, scale and out, and the stream."""
    from avsr_tpu_torch.ops import _build

    fn = getattr(_build.load("qmatmul"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def qmatmul(x: torch.Tensor, qp, out_dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """scale * (bf16(x) @ q) -> [M, N] in ``out_dtype``.

    x: [M, K], bfloat16 or float32; ``qp``: {"qw": int8[K, N]} or
    {"qw4h": int8[K/2, N]} with {"scale": [N]} in one of those types; the
    output in one of them too.
    A CPU tensor takes :func:`qmatmul_reference`; a CUDA tensor launches the
    kernel (on the current stream) or raises. Ragged M, N and K are handled
    by the kernel; nothing is padded."""
    if x.device.type == "cpu":
        return qmatmul_reference(x, qp, out_dtype)
    w, int4 = _weight(qp)
    _check_k(x, w, int4)
    scale = qp["scale"]
    dev = x.device
    M, K = x.shape
    rows, N = w.shape
    if w.dtype != torch.int8 or scale.shape != (N,):
        raise ValueError(f"qmatmul: weight must be int8 [rows, N] with a scale "
                         f"of shape [N], got {w.dtype} {tuple(w.shape)} and "
                         f"{tuple(scale.shape)}")
    for name, t in (("x", x), ("scale", scale), ("out_dtype", out_dtype)):
        dt = t if isinstance(t, torch.dtype) else t.dtype
        if dt not in _KINDS:
            raise TypeError(f"qmatmul: {name} must be bfloat16 or float32, "
                            f"got {dt}")
    x = x.contiguous()
    for name, t in (("x", x), ("weight", w), ("scale", scale)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"qmatmul: {name} must be a contiguous tensor on {dev}")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, per = splits(M, rows, N, sms, 4 if int4 else 8)
    partial = (torch.empty((n_split, M, N), dtype=torch.float32, device=dev)
               if n_split > 1 else None)
    symbol = "avsr_qmatmul_int4" if int4 else "avsr_qmatmul_int8"
    with torch.cuda.device(dev):
        err = _kernel_fn(symbol)(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            M, K, N, n_split, per, _KINDS[x.dtype], _KINDS[scale.dtype],
            _KINDS[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    global int8_launches, int4_launches
    if int4:
        int4_launches += 1
    else:
        int8_launches += 1
    return out
