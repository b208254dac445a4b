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
the kernel for a CUDA tensor (or raises), one launch per call whatever the
shape; ``int8_plan`` and ``int4_plan`` split K where the output tiles alone
would leave SMs idle. ``int8_launches`` and ``int4_launches`` count the
launches. ``eligible`` is the dispatch rule of ``ops/quant.py::qdot``.
"""

from __future__ import annotations

import ctypes

import torch

from avsr_tpu_torch.core.logging import trace_range

# Decode and beam-search shapes only: the JAX package's threshold (set on a
# TPU, kept until it is measured on the card). Past it the product is
# compute-shaped and the dequantize-then-matmul path is the right one.
MAX_SMALL_M = 64

# Launches of each CUDA kernel (incremented once per launch, nowhere else).
int8_launches = 0
int4_launches = 0

# The kernels' tiling (csrc/qmatmul.cu: I8_* and I4_*): a unit of work owns
# 128 output columns of 8 or 16 rows of x (one or two n8 mma tiles) over a
# range of weight rows, taken by 8 warps in k steps (int8: 16 rows of the
# weight; int4: 8 packed rows). Where one wave of units leaves SMs idle, up
# to MAX_SPLIT units of one output tile split the rows, and the last of them
# adds their sums, so one launch covers K. One CTA per SM measured faster
# than two at every flagship int4 shape, and 8 splits faster than 16
# (PERF.md, PR 5).
BLOCK_N = 128
WARPS = 8
I8_KSTEP = 16
I4_KSTEP = 8
MAX_SPLIT = 8
# An int8 split starts on a 64-column panel of x, the unit of its TMA box.
I8_SPLIT_ALIGN = 64

# Per (device, stream): the tile counters of a K split (int32, 0 between
# launches: a launch counts its CTAs there and sets them back to 0) and the
# scratch of the splits' sums (f32), which both kernels share. Launches on
# one stream run one after another; a stream of its own per caller lets two
# launch at once. A buffer that had to grow stays referenced in _retired,
# since a captured CUDA graph may still hold its address.
_workspaces: dict[tuple[torch.device, int], tuple[torch.Tensor, torch.Tensor]] = {}
_retired: list[tuple[torch.Tensor, torch.Tensor]] = []
MIN_COUNTERS = 4096
MIN_SCRATCH_FLOATS = 1 << 19     # 2 MB: every flagship decode shape's splits


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


def _split_plan(m: int, rows: int, n: int, sms: int, kstep: int, align: int
                ) -> tuple[int, int, int]:
    """(K splits, rows per split, n8 tiles of x per unit) over m rows of x,
    ``rows`` weight rows in k steps of ``kstep`` and n columns: one n8 tile
    up to 8 rows of x, else two; the rows split over at most MAX_SPLIT units
    per output tile, as many as one wave of one CTA per SM holds, each unit
    keeping at least one k step per warp, in whole multiples of ``align``
    rows."""
    nt = 1 if m <= 8 else 2
    units = -(-n // BLOCK_N) * -(-m // (8 * nt))
    c = max(1, min(MAX_SPLIT, sms // units, -(-rows // (WARPS * kstep))))
    per = -(-rows // c)
    per = -(-per // align) * align
    return -(-rows // per), per, nt


def int8_plan(m: int, rows: int, n: int, sms: int) -> tuple[int, int, int]:
    """(K splits, weight rows per split, n8 tiles) of one int8 launch over
    m rows of x and an int8 weight of ``rows`` = K rows and n columns."""
    return _split_plan(m, rows, n, sms, I8_KSTEP, I8_SPLIT_ALIGN)


def int4_plan(m: int, rows: int, n: int, sms: int) -> tuple[int, int, int]:
    """(K splits, packed rows per CTA, n8 tiles) of one int4 launch over m
    rows of x, ``rows`` = K/2 packed rows and n columns."""
    return _split_plan(m, rows, n, sms, I4_KSTEP, I4_KSTEP)


def _workspace(dev: torch.device, n_counters: int, n_floats: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(counters, scratch) of the current stream of ``dev``, at least
    ``n_counters`` and ``n_floats`` long. They are made (zeroed counters) at
    the stream's first launch with a K split, which must not be under
    CUDA-graph capture."""
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream)
    ws = _workspaces.get(key)
    if ws is not None and ws[0].numel() >= n_counters and ws[1].numel() >= n_floats:
        return ws
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "qmatmul: the first launch with a K split on this stream is under "
            "CUDA-graph capture; launch it once on that stream before capturing "
            "(as a warm-up), so that its counters exist")
    if ws is not None:
        _retired.append(ws)
    ws = _workspaces[key] = (
        torch.zeros(max(n_counters, MIN_COUNTERS, ws[0].numel() if ws else 0),
                    dtype=torch.int32, device=dev),
        torch.empty(max(n_floats, MIN_SCRATCH_FLOATS, ws[1].numel() if ws else 0),
                    dtype=torch.float32, device=dev))
    return ws


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# dtype codes shared with csrc/qmatmul.cu
_KINDS = {torch.bfloat16: 0, torch.float32: 1}


def _kernel_fn(symbol: str):
    """The C entry point ``symbol`` (``avsr_qmatmul_int8`` or
    ``avsr_qmatmul_int4``) of ``csrc/qmatmul.cu``, built on first use:
    pointers x, w, scale, out, scratch, counters; then M, K, N, the plan
    (splits, rows per split, n8 tiles), the dtype codes of x, scale and out,
    and the stream."""
    from avsr_tpu_torch.ops import _build

    fn = getattr(_build.load("qmatmul"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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
    by the kernel; nothing is padded. The kernel records no gradient, so a
    CUDA x that requires grad under grad mode raises: ``ops/quant.py::qdot``
    (``QDot``) is the differentiable path."""
    if x.device.type == "cpu":
        return qmatmul_reference(x, qp, out_dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("qmatmul records no gradient; call ops/quant.py::qdot "
                           "for a differentiable quantized product")
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
    plan = (int4_plan if int4 else int8_plan)(M, rows, N, sms)
    n_split, _, nt = plan
    symbol = "avsr_qmatmul_int4" if int4 else "avsr_qmatmul_int8"
    with torch.cuda.device(dev):
        scratch = counters = None
        if n_split > 1:
            tiles = -(-N // BLOCK_N) * -(-M // (8 * nt))
            counters, scratch = _workspace(dev, tiles, tiles * n_split * 8 * nt * BLOCK_N)
        with trace_range(symbol.removeprefix("avsr_")):
            err = _kernel_fn(symbol)(
                x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
                *(t.data_ptr() if t is not None else None for t in (scratch, counters)),
                M, K, N, *plan, *kinds, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    global int8_launches, int4_launches
    if int4:
        int4_launches += 1
    else:
        int8_launches += 1
    return out
