"""Weight-only int8/int4 quantization, the port of ``avsr_tpu/ops/quant.py``.

A quantized linear is the dict {"qw": int8[in, out], "scale": f32[out]}:
symmetric per-output-channel scales, rounding half to even. int4 packs two
nibbles per byte with the half-split layout, {"qw4h": int8[in/2, out]}:
byte row i holds logical row i in its low nibble and row i + in/2 in its
high nibble, so a quantized tree of either package loads in the other leaf
for leaf. The legacy row-interleaved int4 layout ("qw4") is still read.

``qdot`` computes x @ dequant(q): at decode shapes (M <= 64 rows) on a
CUDA tensor through the Hopper kernels of ``ops/qmatmul.py``, otherwise
by dequantizing the weight and a plain matmul, which is also what the JAX
package does outside its Pallas kernel. Under autograd (QLoRA training) it
goes through :class:`QDot`, which keeps no dequantized weight for the
backward. ``quantize_llm`` rewrites a Llama tree; LoRA adapters stay full
precision on top of the quantized base.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Quantize / dequantize
# ---------------------------------------------------------------------------

def quantize_tensor(w: torch.Tensor, bits: int = 8) -> Params:
    """Symmetric per-output-channel quantization of w [in, out]. The leaves
    are contiguous whatever w's strides (a tied head is quantized from the
    transposed embedding), as the kernels of ``ops/qmatmul.py`` need."""
    w = w.float().contiguous()
    qmax = 127.0 if bits == 8 else 7.0
    scale = (w.abs().amax(dim=0) / qmax).clamp(min=1e-12)      # [out]
    q = torch.clamp(torch.round(w / scale[None, :]), -qmax, qmax).to(torch.int8)
    if bits == 4:
        if q.shape[0] % 2:
            raise ValueError(f"int4 needs even in-dim, got {tuple(q.shape)}")
        return {"qw4h": pack_int4(q), "scale": scale}
    return {"qw": q, "scale": scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8[in, out] values in [-8, 7] -> the half-split packing int8[in/2,
    out]: byte row i holds row i in its low nibble and row i + in/2 in its
    high nibble (int8 arithmetic wraps as the JAX package's does)."""
    half = q.shape[0] // 2
    return (q[:half] & 0x0F) | ((q[half:] & 0x0F) << 4)


def _sign_extend(n: torch.Tensor) -> torch.Tensor:
    return torch.where(n >= 8, n - 16, n)


def _unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8[in/2, out] half-split packed -> int8[in, out], sign-extended:
    low nibbles are logical rows [0, in/2), high nibbles rows [in/2, in)."""
    return torch.cat([_sign_extend(q & 0x0F), _sign_extend((q >> 4) & 0x0F)])


def _unpack_int4_legacy(q: torch.Tensor) -> torch.Tensor:
    """Legacy row-interleaved int4 ("qw4": byte row i holds logical rows 2i
    in its low nibble and 2i + 1 in its high nibble) -> int8[in, out]."""
    lo = _sign_extend(q & 0x0F)
    hi = _sign_extend((q >> 4) & 0x0F)
    return torch.stack([lo, hi], dim=1).reshape(2 * q.shape[0], q.shape[1])


def upgrade_legacy_int4(tree: Any) -> Any:
    """Repack every legacy "qw4" leaf dict as "qw4h" (half-split), which the
    kernel reads; a tree in the current layout comes back unchanged."""
    if isinstance(tree, dict):
        if "qw4" in tree:
            packed = pack_int4(_unpack_int4_legacy(tree["qw4"]))
            rest = {k: upgrade_legacy_int4(v) for k, v in tree.items() if k != "qw4"}
            return {"qw4h": packed, **rest}
        return {k: upgrade_legacy_int4(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [upgrade_legacy_int4(v) for v in tree]
    return tree


def unpacked(qp: Params) -> torch.Tensor:
    """The integer weight [in, out] of a quantized node, int8."""
    if "qw4h" in qp:
        return _unpack_int4(qp["qw4h"])
    if "qw4" in qp:
        return _unpack_int4_legacy(qp["qw4"])
    return qp["qw"]


def dequantize(qp: Params, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q * scale in ``dtype`` (both factors cast to it first, as in JAX)."""
    return unpacked(qp).to(dtype) * qp["scale"].to(dtype)[None, :]


def _weight_key(qp: Params) -> str:
    return next(k for k in ("qw4h", "qw4", "qw") if k in qp)


def _qdot(x: torch.Tensor, qp: Params, dt_out: torch.dtype,
          use_kernel: str) -> torch.Tensor:
    """The dispatch of :func:`qdot`, with no autograd graph of its own."""
    from avsr_tpu_torch.ops import qmatmul as qm

    lead, K = x.shape[:-1], x.shape[-1]
    m = 1
    for s in lead:
        m *= s
    if qm.eligible(m, K, qp, use_kernel=use_kernel, cuda=x.is_cuda):
        y = qm.qmatmul(x.reshape(m, K), qp, out_dtype=dt_out)
        return y.reshape(*lead, y.shape[-1])
    acc = torch.promote_types(x.dtype, dt_out)
    w = dequantize(qp, x.dtype)
    return torch.matmul(x.to(acc), w.to(acc)).to(dt_out)


class QDot(torch.autograd.Function):
    """x @ dequant(qp) with a gradient for x only (the quantized base is
    frozen): the forward is :func:`qdot`'s dispatch (the kernel at M <= 64
    on the card, else dequantize and matmul), and the backward dequantizes
    again, dx = dy @ dequant(qp, x.dtype)^T in the wider of x's dtype and
    the output's, the transpose of the JAX dequantize path. It saves the
    packed leaves, which are resident anyway, and not the dequantized
    weight: autograd through ``dequantize(qp) @`` would keep a copy of
    every base weight in the compute dtype until the backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                key: str, dt_out: torch.dtype, use_kernel: str) -> torch.Tensor:
        ctx.save_for_backward(w, scale)
        ctx.key, ctx.x_dtype, ctx.dt_out = key, x.dtype, dt_out
        return _qdot(x, {key: w, "scale": scale}, dt_out, use_kernel)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        w, scale = ctx.saved_tensors
        acc = torch.promote_types(ctx.x_dtype, ctx.dt_out)
        wq = dequantize({ctx.key: w, "scale": scale}, ctx.x_dtype)
        dx = torch.matmul(dy.to(acc), wq.to(acc).t()).to(ctx.x_dtype)
        return dx, None, None, None, None, None


def qdot(x: torch.Tensor, qp: Params, out_dtype: torch.dtype | None = None,
         use_kernel: str = "auto") -> torch.Tensor:
    """x @ dequant(qp) -> ``out_dtype`` (default x.dtype).

    ``use_kernel``: "auto" takes the kernel for a CUDA tensor at M <= 64
    rows, "always" for any tensor at M <= 64 (on the CPU that is the
    kernel's plain version), "never" always dequantizes; see
    ``qmatmul.eligible``. The kernel accumulates bf16(x) times the integers
    in f32; the dequantized path multiplies in the wider of x's dtype and
    ``out_dtype``. With grad mode on and an x that requires grad it runs
    through :class:`QDot`, which returns a gradient for x and none for the
    quantized leaves."""
    dt_out = out_dtype or x.dtype
    if torch.is_grad_enabled() and x.requires_grad:
        key = _weight_key(qp)
        return QDot.apply(x, qp[key], qp["scale"], key, dt_out, use_kernel)
    return _qdot(x, qp, dt_out, use_kernel)


# ---------------------------------------------------------------------------
# LLM rewrite
# ---------------------------------------------------------------------------

_QUANT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def quantize_llm(llm_params: Params, bits: int = 8,
                 lm_head_bits: int | None = None) -> Params:
    """Quantize every projection of the transformer layers of a Llama tree
    to ``bits`` (0: none). The embedding and the norms stay as they are;
    LoRA adapters are kept beside the quantized base.

    ``lm_head_bits`` also quantizes the hidden -> vocab projection: for a
    tied embedding a quantized copy of embed.T under "lm_head" (the table
    still serves the token gathers), an untied head in place. The vocab is
    padded with zero columns to a multiple of 2048 when it exceeds 2048;
    ``compute_logits`` slices them off."""
    out = dict(llm_params)
    if lm_head_bits:
        head = llm_params.get("lm_head")
        src = head["w"] if isinstance(head, dict) and "w" in head else llm_params["embed"].T
        V = src.shape[1]
        pad = (-V) % 2048 if V > 2048 else 0
        if pad:
            src = torch.nn.functional.pad(src, (0, pad))
        qhead = quantize_tensor(src, lm_head_bits)
        if isinstance(head, dict):
            qhead = {**{k: v for k, v in head.items() if k != "w"}, **qhead}
        out["lm_head"] = qhead
    if not bits:
        return out
    layers = []
    for layer in llm_params["layers"]:
        new_layer = {}
        for name, node in layer.items():
            if name in _QUANT_TARGETS and isinstance(node, dict) and "w" in node:
                qn = quantize_tensor(node["w"], bits)
                if "lora" in node:
                    qn["lora"] = node["lora"]
                new_layer[name] = qn
            else:
                new_layer[name] = node
        layers.append(new_layer)
    out["layers"] = layers
    return out


def is_quantized(node: Any) -> bool:
    return isinstance(node, dict) and ("qw" in node or "qw4h" in node
                                       or "qw4" in node)


def quant_bytes(tree: Any) -> int:
    """Device bytes of every tensor of a (possibly mixed) tree."""
    if isinstance(tree, dict):
        return sum(quant_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(quant_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
