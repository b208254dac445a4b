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

# The int8 kernel's tiling (csrc/qmatmul.cu: BN, MT): a CTA owns 128
# output columns of 8 rows of x. The K rows are split over CTAs until the
# grid has two CTAs per SM, with at least MIN_SPLIT_ROWS weight rows each,
# and so that a CTA's x columns (f32, 8 rows) fit in MAX_X_BYTES of shared
# memory; the partial sums are added in a second, deterministic pass.
BLOCK_N = 128
BLOCK_M = 8
MIN_SPLIT_ROWS = 64
MAX_X_BYTES = 96 * 1024

# The int4 kernel's tiling (csrc/qmatmul.cu: I4_*): a CTA owns 128 output
# columns of 8 or 16 rows of x (one or two n8 mma tiles) over a range of
# packed rows, taken by its 8 warps in k steps of 8 rows; up to MAX_SPLIT
# CTAs of one output tile split the packed rows, and the last of them adds
# their sums, so one launch covers K. One CTA per SM measured faster than
# two at every flagship shape, and 8 splits faster than 16 (PERF.md, PR 5).
I4_BLOCK_N = 128
I4_KSTEP = 8
I4_WARPS = 8
MAX_SPLIT = 8

# The int4 kernel's tile counters, one zeroed int32 buffer per device: a
# launch with a K split counts its CTAs there and leaves every counter 0, so
# launches on one stream (or one at a time) share it.
_counters: dict[torch.device, torch.Tensor] = {}


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


def splits(m: int, rows: int, n: int, sms: int) -> tuple[int, int]:
    """(number of K splits, weight rows per split) of one int8 launch:
    enough CTAs for two per SM where the rows allow it, and no more rows
    per CTA than its staged x allows."""
    ctas = -(-n // BLOCK_N) * -(-m // BLOCK_M)
    cap = MAX_X_BYTES // (BLOCK_M * 4)
    s = max(1, min(-(-2 * sms // ctas), rows // MIN_SPLIT_ROWS), -(-rows // cap))
    per = max(1, -(-rows // s))
    return -(-rows // per), per


def int4_plan(m: int, rows: int, n: int, sms: int) -> tuple[int, int, int]:
    """(K splits, packed rows per CTA, n8 tiles of x per CTA) of one int4
    launch over m rows of x, ``rows`` = K/2 packed rows and n columns: one
    n8 tile up to 8 rows of x, else two; the packed rows split over at most
    MAX_SPLIT CTAs per output tile, as many as one wave of one CTA per SM
    holds, each CTA keeping at least one k step per warp, in whole k
    steps."""
    nt = 1 if m <= 8 else 2
    ctas = -(-n // I4_BLOCK_N) * -(-m // (8 * nt))
    c = max(1, min(MAX_SPLIT, sms // ctas, -(-rows // (I4_WARPS * I4_KSTEP))))
    per = -(-rows // c)
    per = -(-per // I4_KSTEP) * I4_KSTEP
    return -(-rows // per), per, nt


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# dtype codes shared with csrc/qmatmul.cu
_KINDS = {torch.bfloat16: 0, torch.float32: 1}


def _kernel_fn(symbol: str):
    """The C entry point ``symbol`` of ``csrc/qmatmul.cu``, built on first
    use. int8: pointers x, w, scale, out, partial; then M, K, N, splits,
    split_rows, the dtype codes of x, scale and out, and the stream. int4:
    pointers x, w, scale, out, partial, counters; then M, K, N, splits,
    rows per CTA, n8 tiles, the three dtype codes, and the stream."""
    from avsr_tpu_torch.ops import _build

    fn = getattr(_build.load("qmatmul"), symbol)
    if fn.argtypes is None:
        n_ptr, n_int = (6, 9) if symbol == "avsr_qmatmul_int4" else (5, 8)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
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
    kinds = (_KINDS[x.dtype], _KINDS[scale.dtype], _KINDS[out_dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr())
    if int4:
        symbol = "avsr_qmatmul_int4"
        plan = int4_plan(M, rows, N, sms)
        n_split, _, nt = plan
        tiles = -(-N // I4_BLOCK_N) * -(-M // (8 * nt))
        partial = counters = None
        if n_split > 1:
            partial = torch.empty((tiles, n_split, 8 * nt, I4_BLOCK_N),
                                  dtype=torch.float32, device=dev)
            counters = _counters.get(dev)
            if counters is None or counters.numel() < tiles:
                counters = _counters[dev] = torch.zeros(max(tiles, 4096),
                                                        dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = _kernel_fn(symbol)(
                *ptrs, *(t.data_ptr() if t is not None else None for t in (partial, counters)),
                M, K, N, *plan, *kinds, stream)
    else:
        symbol = "avsr_qmatmul_int8"
        n_split, per = splits(M, rows, N, sms)
        partial = (torch.empty((n_split, M, N), dtype=torch.float32, device=dev)
                   if n_split > 1 else None)
        with torch.cuda.device(dev):
            err = _kernel_fn(symbol)(
                *ptrs, partial.data_ptr() if partial is not None else None,
                M, K, N, n_split, per, *kinds, stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    global int8_launches, int4_launches
    if int4:
        int4_launches += 1
    else:
        int8_launches += 1
    return out
