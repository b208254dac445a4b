"""Llama-family causal LM with LoRA and a KV cache, the port of
``avsr_tpu/models/llama.py`` (dense FFN, LoRA adapters, per row too).

GQA attention (n_kv_heads <= n_heads), RoPE (rotate-half, HF convention),
RMSNorm, SiLU-gated MLP, tied embeddings. ``llama_apply`` runs the full
causal sequence (the prefill; its attention is the flash kernel at
T >= 256) and can write the KV cache; ``llama_decode_step`` is the
single-token step, whose attention stays plain PyTorch because the JAX
package leaves it to XLA.

Cache layout: ``[L, B, Hkv, M, Dh]`` (position-major, the natural layout
for torch matmuls; the JAX package's position-minor ``[.., Dh, M]`` was
chosen for TPU lanes). ``llama_decode_step`` writes the new column IN
PLACE into the cache it is given and returns that same cache.

Quantized serving: a projection node may hold an int8/int4 base
(``ops/quant.py``), which ``proj`` multiplies through ``qdot`` (the Hopper
kernels at decode shapes) with LoRA on top in full precision;
``fuse_decode_layout`` fuses q|k|v and gate|up for decode; an int8 cache
(``quantize_cache``) carries per-(layer, row, kv head) scales fixed at the
prefill. ``use_kernel`` ("auto" | "always" | "never") picks the kernels
for attention and for the quantized products alike.

Training: ``proj`` applies LoRA dropout to the adapter branch's input, and
``llama_apply`` can recompute each block in backward (``remat``, the
counterpart of ``jax.checkpoint``) with ``torch.utils.checkpoint``. Dropout
masks are drawn from generators seeded per (call, layer, global row) inside
the block, so the recomputation draws the same masks (``checkpoint``
replays only the default generators' state) and a rank holding some rows
of a batch draws those rows of a single card's masks. Under fsdp each
block gathers its sharded leaves when it runs (``mesh/sharding.py``);
under tp each block, the decode steps and the KV cache run the rank's
heads and slices (Megatron), the embedding looks up its vocab range and
the head gives its vocab columns, gathered; under sp (``mesh.sp``) the
ranks of the group run the blocks on their chunks of the sequence with
ring attention (``llama_apply``'s ``sp``); under pp (``mesh.pp``) each rank
of the group runs its stage's blocks on microbatches handed from stage to
stage (``llama_apply``'s ``pp``, ``ops/pipeline.py``). On a quantized base (QLoRA) the base
product carries the gradient of x through ``qdot``'s autograd Function
(``QDot``) and the integer leaves stay frozen; LoRA trains on top.

Decode variants: ``llama_prefill_continue`` extends a cache by a block of
rows at per-row offsets (the streaming continuation and the speculative
verify pass), and ``llama_decode_step_split`` is beam search's step over a
[B]-row prefix cache shared by all beams and a per-beam suffix cache,
whose new columns ``merge_new_columns`` lands during the next step's beam
gather. Their attention is plain PyTorch, as the decode step's is.

Multi-tenant serving: a LoRA node may hold per-row adapters (``a`` [B,
din, r], ``b`` [B, r, dout], gathered from a bank by ``infer/adapters.py``),
which ``proj`` applies row by row; only the raw layout carries them.

Mixture of experts (``llm.moe_experts`` > 0): every ``moe_every``-th block
swaps its SwiGLU MLP for capacity-routed SwiGLU experts (``router`` and
``experts`` leaves, ``ops/moe.py``). Training routes with the flattened
bounded capacity and returns the router losses (``return_aux``); every
inference prefill routes row by row (``moe_rowwise``) and every token step
(decode, verify, beam) without drops (``dropless``), so a request's tokens
never depend on what shares its batch. The routers and experts stay float
under quantization. Across processes the training routing is the global
batch's (``llama_apply``'s ``moe_group``, ``ops/moe.py::Routing``, under sp
over the ring's chunks too), a ring's prefill routes each row over its
chunks, the experts run Megatron style under tp (gate and up on column
slices of the FFN width, down on row slices, the router replicated), and
under ep each rank runs its E / ep experts on the slots the exchange
brings it.
"""

from __future__ import annotations

import logging
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from avsr_tpu_torch.core.config import LLMConfig, LoRAConfig
from avsr_tpu_torch.core.hf_files import Prefixed
from avsr_tpu_torch.mesh.collectives import (copy_to_tp, gather_from_sp, gather_from_tp,
                                             reduce_from_tp, scatter_to_sp)
from avsr_tpu_torch.mesh.sharding import Shard, gather_tree, tag, tp_group, tp_of
from avsr_tpu_torch.models.layers import Params, normal_init, rms_norm, split_leaf
from avsr_tpu_torch.ops import moe
from avsr_tpu_torch.ops.attention import attention, ring_span
from avsr_tpu_torch.ops.pipeline import pipeline_apply
from avsr_tpu_torch.ops.quant import is_quantized, qdot

# Vocab rows per chunk when bf16 logits are accumulated in f32 (bounds the
# f32 copy of the head that is live at once to ~134 MB at d=2048).
LOGITS_CHUNK = 16384


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., T] -> (cos, sin) each [..., T, head_dim] f32 (the
    half-dim frequencies duplicated, used with rotate_half)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv_t = torch.from_numpy(np.asarray(inv, dtype=np.float32)).to(positions.device)
    ang = positions.float()[..., None] * inv_t
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, T, D]; cos/sin [B, T, D] or [T, D], cast to x.dtype first."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, None].to(x.dtype)
    sin = sin[:, None].to(x.dtype)
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


# ---------------------------------------------------------------------------
# Projections with optional LoRA
# ---------------------------------------------------------------------------

def proj(p: Params, x: torch.Tensor, *, lora_scale: float = 0.0,
         lora_dropout: float = 0.0,
         generator: torch.Generator | list[torch.Generator] | None = None,
         use_kernel: str = "auto", tp=None, row: bool = False,
         seq: tuple[int, int] | None = None) -> torch.Tensor:
    """x @ W (no bias) + lora_scale * (x' @ a) @ b when the node has LoRA,
    in x.dtype. W is a full-precision "w" or a quantized base ("qw"/"qw4h"
    + "scale"), which goes through ``qdot`` with ``use_kernel``. x' is x,
    or with ``generator`` and ``lora_dropout`` > 0 its dropout: each
    element kept with probability 1 - p and scaled by 1 / (1 - p); the
    base product always sees x. ``generator`` is one generator, or one per
    row of x (row i's mask drawn from generator i alone).

    Under tensor parallelism (``tp``, a Megatron block's group) W is this
    rank's column slice, or with ``row`` its row slice and x this rank's
    slice of the input features; the replicated adapter is cut to match
    (column-parallel s·(x' a) b[:, r], row-parallel s·(x'_r a[r, :]) b,
    each factor's gradient summed over the group once), and a row-parallel
    x' takes this rank's columns of the full row's dropout mask, so the
    masks are one card's. A row-parallel result is this rank's partial sum:
    the caller sums it over the group once. ``seq`` (c0, T): x [B, Tl, d]
    holds positions c0 to c0 + Tl of a sequence of T (a rank's chunk under
    sequence parallelism), whose masks are those positions of the whole
    sequence's draws."""
    dt = x.dtype
    if "w" in p:
        y = torch.matmul(x, p["w"].to(dt))
    else:
        y = qdot(x, p, use_kernel=use_kernel)
    if lora_scale and "lora" in p:
        a, b = p["lora"]["a"], p["lora"]["b"]
        if row:
            a, b = split_leaf(a, tp, 0), copy_to_tp(b, tp)
        else:
            # a fused decode layout's b holds its rank's columns already
            a = copy_to_tp(a, tp)
            b = b if tp_of(b) is not None else split_leaf(b, tp, -1)
        a, b = a.to(dt), b.to(dt)
        xl = x
        if generator is not None and lora_dropout > 0.0:
            parts = tp.size if tp is not None and row else 1
            c0, T = seq if seq is not None else (0, x.shape[-2])
            shape = (*x.shape[:-2], T, x.shape[-1] * parts)
            if isinstance(generator, torch.Generator):
                u = torch.rand(shape, generator=generator, device=x.device)
            else:
                u = torch.empty(shape, device=x.device)
                for r, g in zip(u, generator):
                    torch.rand(r.shape, generator=g, out=r)
            if parts > 1:
                u = u.chunk(parts, dim=-1)[tp.rank]
            u = u[..., c0: c0 + x.shape[-2], :]
            keep = u < 1.0 - lora_dropout
            xl = torch.where(keep, x / (1.0 - lora_dropout), 0.0)
        # per-row adapters a [B, din, r], b [B, r, dout] (the serving
        # engine's multi-LoRA bank, infer/adapters.py): each row of x
        # [B, T, din] takes its own update; 2-D adapters broadcast
        y = y + lora_scale * torch.matmul(torch.matmul(xl, a), b)
    return y


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def is_moe_layer(cfg: LLMConfig, i: int) -> bool:
    """Block ``i`` carries a sparse MoE FFN: llm.moe_experts > 0 and the
    block index hits the ``moe_every`` interleave (1 = every block)."""
    return cfg.moe_experts > 0 and (i + 1) % cfg.moe_every == 0


def init_llama(gen: torch.Generator, cfg: LLMConfig,
               dtype: torch.dtype = torch.float32) -> Params:
    """Random init; a MoE block holds ``router`` {w [d, E]} and ``experts``
    {w_gate, w_up [E, d, f], w_down [E, f, d]} in place of gate/up/down
    (the JAX package's keys and order)."""
    d = cfg.d_model
    hd = d // cfg.n_heads
    kvd = cfg.n_kv_heads * hd
    dev = gen.device

    def lin(din: int, dout: int) -> Params:
        return {"w": normal_init(gen, (din, dout), std=0.02, dtype=dtype)}

    def ones() -> Params:
        return {"scale": torch.ones((d,), dtype=dtype, device=dev)}

    layers = []
    for i in range(cfg.n_layers):
        layer = {"ln_attn": ones(),
                 "q": lin(d, d), "k": lin(d, kvd), "v": lin(d, kvd), "o": lin(d, d),
                 "ln_mlp": ones()}
        if is_moe_layer(cfg, i):
            E, f = cfg.moe_experts, cfg.ffn_dim
            layer["router"] = {"w": normal_init(gen, (d, E), std=d ** -0.5, dtype=dtype)}
            layer["experts"] = {
                "w_gate": normal_init(gen, (E, d, f), std=0.02, dtype=dtype),
                "w_up": normal_init(gen, (E, d, f), std=0.02, dtype=dtype),
                "w_down": normal_init(gen, (E, f, d), std=0.02, dtype=dtype)}
        else:
            layer.update(gate=lin(d, cfg.ffn_dim), up=lin(d, cfg.ffn_dim),
                         down=lin(cfg.ffn_dim, d))
        layers.append(layer)
    params: Params = {
        "embed": normal_init(gen, (cfg.vocab_size, d), std=0.02, dtype=dtype),
        "layers": layers,
        "ln_f": ones(),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = lin(d, cfg.vocab_size)
    return params


_LORA_NAMES = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o",
               "gate_proj": "gate", "up_proj": "up", "down_proj": "down"}


def add_lora(gen: torch.Generator, params: Params, cfg: LLMConfig,
             lora: LoRAConfig, dtype: torch.dtype = torch.float32) -> Params:
    """Attach LoRA adapters (a ~ N(0, 1/r) * init_scale, b = 0) to the
    target projections a layer has (a MoE block has no gate/up/down);
    returns a new tree sharing the base weights."""
    del cfg
    targets = [_LORA_NAMES.get(t, t) for t in lora.target_modules]
    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        for t in targets:
            if t not in layer:
                continue
            w = layer[t]["w"]
            a = normal_init(gen, (w.shape[0], lora.r), std=1.0 / lora.r,
                            dtype=dtype) * lora.init_scale
            b = torch.zeros((lora.r, w.shape[1]), dtype=dtype, device=w.device)
            layer[t] = {"w": w, "lora": {"a": a, "b": b}}
        layers.append(layer)
    return {**params, "layers": layers}


def lora_scale(lora: LoRAConfig | None) -> float:
    return lora.alpha / lora.r if lora is not None and lora.use_lora else 0.0


def merge_lora(params: Params, lora: LoRAConfig) -> Params:
    """Fold every adapter into its base weight, w + scale * (a @ b) in w's
    dtype, as the JAX package does for export and for the speculative
    self-draft; returns a new tree whose merged nodes hold only "w"."""
    s = lora_scale(lora)

    def walk(node):
        if isinstance(node, dict):
            if "lora" in node and "w" in node:
                a, b = node["lora"]["a"], node["lora"]["b"]
                node = {"w": node["w"] + s * torch.matmul(a, b).to(node["w"].dtype)}
            return {k: walk(v) if k != "lora" else v for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def _fuse_group(nodes: list[Params]) -> Params | None:
    """Concatenate parallel projections (same input) along the out dim.

    Bases concatenate directly (a float "w", or a quantized "qw"/"qw4h"
    with its per-column "scale"; all are laid out [in, out]). LoRA adapters
    combine as a = [a_1 | a_2 | ...] and a block-structured b that routes
    each adapter's rank rows to its own output columns, so that
    x @ a @ b == concat_i(x @ a_i @ b_i) exactly. None when the nodes mix
    kinds. Nodes that hold a tp rank's column slices fuse those slices,
    each adapter's b cut to the same columns: the rank's q|k|v, not a slice
    of the global concatenation."""
    kinds = {next((k for k in ("w", "qw", "qw4h") if k in n), None) for n in nodes}
    if len(kinds) != 1 or None in kinds:
        return None
    kind = kinds.pop()
    tps = [tp_of(n[kind]) for n in nodes]
    tp = next((s for s in tps if s is not None), None)
    fused: Params = {kind: torch.cat([n[kind] for n in nodes], dim=1)}
    if kind == "w":
        outs = [n["w"].shape[1] for n in nodes]
    else:
        fused["scale"] = torch.cat([n["scale"] for n in nodes])
        outs = [n["scale"].shape[0] for n in nodes]
    loras = [(i, n["lora"]) for i, n in enumerate(nodes) if "lora" in n]
    if loras:
        a = torch.cat([lo["a"] for _, lo in loras], dim=1)
        b = a.new_zeros((a.shape[1], sum(outs)), dtype=loras[0][1]["b"].dtype)
        offs = np.concatenate([[0], np.cumsum(outs)])
        row = 0
        for i, lo in loras:
            r = lo["a"].shape[1]
            bi = lo["b"]
            if tps[i] is not None:
                bi = bi.chunk(tps[i].group.size, dim=-1)[tps[i].group.rank]
            b[row: row + r, offs[i]: offs[i + 1]] = bi
            row += r
        if tp is not None:      # the rank's columns: ``proj`` cuts b no further
            b = tag(b, Shard(1, b.shape[1] * tp.group.size, tp.group, "tp"))
        fused["lora"] = {"a": a, "b": b}
    return fused


def fuse_decode_layout(params: Params) -> Params:
    """The decode layout: q|k|v and gate|up fused per layer, so that a
    decode step makes 4 projection products per layer instead of 7 (one
    kernel launch each when quantized; a MoE block, which has no gate/up,
    makes 2). Exact: the fused product concatenates the outputs. Training
    never sees this layout. Under tp each rank fuses its own slices (see
    :func:`_fuse_group`); o and down, row-parallel, stay as they are."""
    layers = []
    for layer in params["layers"]:
        fl = dict(layer)
        for name, parts in (("qkv", ("q", "k", "v")), ("gateup", ("gate", "up"))):
            if name in fl or not all(p in fl for p in parts):
                continue
            fused = _fuse_group([layer[p] for p in parts])
            if fused is not None:
                fl[name] = fused
                for p in parts:
                    del fl[p]
        layers.append(fl)
    return {**params, "layers": layers}


def _proj_qkv(layer: Params, h: torch.Tensor, ls: float, ldrop: float = 0.0,
              gen: torch.Generator | None = None, use_kernel: str = "auto",
              tp=None, q_width: int | None = None, seq: tuple[int, int] | None = None):
    """(q, k, v) raw projections, fused or per-tensor layout; under tp the
    rank's heads (``q_width`` columns of q); ``seq`` as in :func:`proj`."""
    kw = dict(lora_scale=ls, lora_dropout=ldrop, generator=gen,
              use_kernel=use_kernel, tp=tp, seq=seq)
    if "qkv" in layer:
        y = proj(layer["qkv"], h, **kw)
        d = q_width or h.shape[-1]
        kvd = (y.shape[-1] - d) // 2
        return y[..., :d], y[..., d: d + kvd], y[..., d + kvd:]
    return tuple(proj(layer[n], h, **kw) for n in ("q", "k", "v"))


def _proj_mlp(layer: Params, h: torch.Tensor, ls: float,
              use_kernel: str = "auto", tp=None) -> torch.Tensor:
    """silu(gate) * up, fused or per-tensor layout (under tp, the rank's
    columns of both)."""
    kw = dict(lora_scale=ls, use_kernel=use_kernel, tp=tp)
    if "gateup" in layer:
        y = proj(layer["gateup"], h, **kw)
        f = y.shape[-1] // 2
        gate, up = y[..., :f], y[..., f:]
    else:
        gate = proj(layer["gate"], h, **kw)
        up = proj(layer["up"], h, **kw)
    return F.silu(gate) * up


def _moe_mlp(layer: Params, h: torch.Tensor, cfg: LLMConfig,
             valid: torch.Tensor | None = None, dropless: bool = False,
             rowwise: bool = False, routing: moe.Routing | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sparse SwiGLU MoE FFN over h [B, T, d]: (y, lb loss, z loss).
    ``valid`` [B, T] masks right-padding (None: every token is live).
    Training routes with the flattened bounded capacity (over the ranks of
    ``routing``); every inference prefill passes ``rowwise`` and every
    token step (decode, verify, beam) ``dropless`` (``ops/moe.py::ffn``),
    so that a request's tokens do not depend on what shares its batch.
    ``dropless`` is a topk * N^2 * E dispatch, so not for prefills. Experts
    sliced over tp run Megatron style (the slots copied in, the partial
    outputs all-reduced); experts sliced over ep are this rank's E / ep."""
    cdt = h.dtype
    ex = layer["experts"]
    tp, ep = tp_group(ex), tp_group(ex, "ep")
    wg, wu, wd = (ex[n].to(cdt) for n in ("w_gate", "w_up", "w_down"))

    def experts(xs: torch.Tensor) -> torch.Tensor:               # [E', C', d]
        xs = copy_to_tp(xs, tp)
        y = torch.matmul(F.silu(torch.matmul(xs, wg)) * torch.matmul(xs, wu), wd)
        return reduce_from_tp(y, tp)

    if valid is None:
        valid = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
    return moe.ffn(h, layer["router"]["w"], valid, cfg.moe_topk, cfg.moe_capacity_factor,
                   experts, rowwise=rowwise, dropless=dropless, routing=routing, ep=ep)


def _ffn(layer: Params, x: torch.Tensor, cfg: LLMConfig, ls: float,
         use_kernel: str = "auto", lengths: torch.Tensor | None = None,
         dropless: bool = False, rowwise: bool = False, tp=None,
         routing: moe.Routing | None = None, pos0: int = 0
         ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Post-attention FFN residual: (x + ffn(ln(x)), aux). A dense block
    runs down(silu(gate) * up) and gives aux None (under tp, gate and up
    column-parallel, down row-parallel, one all-reduce); a MoE block (one
    with ``experts``) runs :func:`_moe_mlp` over ``routing``, its valid
    tokens the first ``lengths`` [B] of each row (x holding positions
    ``pos0`` on: a ring's chunk), and gives aux (lb, z)."""
    h = rms_norm(layer["ln_mlp"], x, eps=cfg.rms_eps)
    if "experts" in layer:
        valid = None
        if lengths is not None:
            valid = (torch.arange(pos0, pos0 + x.shape[1], device=x.device)[None, :]
                     < lengths.to(x.device)[:, None])
        y, lb, z = _moe_mlp(layer, h, cfg, valid, dropless=dropless, rowwise=rowwise,
                            routing=routing)
        return x + y, (lb, z)
    h = copy_to_tp(h, tp)
    y = proj(layer["down"], _proj_mlp(layer, h, ls, use_kernel, tp),
             lora_scale=ls, use_kernel=use_kernel, tp=tp, row=True)
    return x + reduce_from_tp(y, tp), None


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Decode cache [L, B, Hkv, M, Dh], updated in place by decode steps.

    Serving mode (decode.kv_cache_dtype="int8", :func:`quantize_cache`):
    k/v are int8 with per-(layer, row, kv head) bf16 scales [L, B, Hkv, 1,
    1], fixed at the prefill (amax / 112 leaves headroom) and reused for
    the decoded rows."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


_KV_QMAX = 112.0   # int8 range with headroom for decoded rows


def quantize_cache(cache: KVCache) -> KVCache:
    """bf16/f32 cache -> int8 + per-(l, b, h) scales (see KVCache): each
    value divided by the f32 scale, rounded half to even, clipped to
    +-127; the scale is stored in bf16."""
    def q(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        s = t.abs().amax(dim=(3, 4), keepdim=True).float() / _KV_QMAX + 1e-8
        q8 = torch.clamp(torch.round(t.float() / s), -127, 127).to(torch.int8)
        return q8, s.to(torch.bfloat16)

    (k8, sk), (v8, sv) = q(cache.k), q(cache.v)
    return KVCache(k8, v8, sk, sv)


def llm_tp(params: Params):
    """The tp group of a Llama tree whose blocks hold Megatron slices, or
    None."""
    layers = params.get("layers") or [None]
    return tp_group(layers[0])


def local_heads(cfg: LLMConfig, tp) -> tuple[int, int]:
    """(q heads, kv heads) of one tp rank (all of them without tp)."""
    n = tp.size if tp is not None else 1
    return cfg.n_heads // n, cfg.n_kv_heads // n


def init_cache(cfg: LLMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda", tp=None) -> KVCache:
    """A zero cache; under tp (the Llama's group, :func:`llm_tp`) it holds
    this rank's kv heads."""
    hd = cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, batch, local_heads(cfg, tp)[1], max_len, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Full sequence (prefill)
# ---------------------------------------------------------------------------

def _row_generators(seed: int, layer: int, rows: range,
                    device: torch.device) -> list[torch.Generator]:
    """The dropout generators of one layer of one call, one per global row
    (the counterpart of ``jax.random.fold_in(dropout_rng, layer)``): a row's
    masks do not depend on the rows beside it, so a rank holding rows
    [a, b) of a batch draws exactly those rows of a single card's masks."""
    gens = []
    for row in rows:
        state = np.random.SeedSequence([seed, layer, row]).generate_state(1, np.uint64)
        gens.append(torch.Generator(device=device).manual_seed(int(state[0])))
    return gens


def _block(layer: Params, x: torch.Tensor, cos, sin, cfg: LLMConfig,
           lengths: torch.Tensor | None, ls: float, use_kernel: str,
           ldrop: float = 0.0, dropout_seed: int | None = None,
           index: int = 0, moe_rowwise: bool = False, row0: int = 0, sp=None,
           seq: tuple[int, int] | None = None, routing: moe.Routing | None = None):
    """One block over [B, T, d]: (x, (k, v), MoE aux or None). Its rows are
    rows ``row0`` on of the global batch (for the dropout masks); under
    sequence parallelism (the sp group ``sp``) x is this rank's chunk, its
    positions ``seq`` = (c0, T) of the sequence, and attention the ring; a sharded
    leaf (fsdp) is gathered here, so that a remat recomputation gathers it
    again rather than keeping it. Under tp (Megatron) the block runs its
    rank's ``n_heads / tp`` q heads and ``n_kv_heads / tp`` kv heads (the
    GQA grouping kept), q, k, v, gate and up column-parallel, o and down
    row-parallel, one all-reduce after the attention and one after the
    MLP; (k, v) are the rank's heads. A MoE FFN routes over ``routing``
    and keeps its ep slices of the experts."""
    B, T, d = x.shape
    hd = d // cfg.n_heads
    layer = gather_tree(layer, keep_tp=True, keep_ep=True)
    tp = tp_group(layer)
    nh, nkv = local_heads(cfg, tp)
    # created inside the block so that a remat recomputation redraws the
    # same masks; drawn in the order q, k, v, o
    gen = (_row_generators(dropout_seed, index, range(row0, row0 + B), x.device)
           if dropout_seed is not None and ldrop > 0.0 else None)
    h = copy_to_tp(rms_norm(layer["ln_attn"], x, eps=cfg.rms_eps), tp)
    q, k, v = _proj_qkv(layer, h, ls, ldrop, gen, use_kernel, tp, nh * hd, seq)
    q = q.reshape(B, T, nh, hd).transpose(1, 2)
    k = k.reshape(B, T, nkv, hd).transpose(1, 2)
    v = v.reshape(B, T, nkv, hd).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attention(q, k, v, causal=True, q_lens=lengths, kv_lens=lengths,
                     use_kernel=use_kernel, sp=sp)
    attn = attn.transpose(1, 2).reshape(B, T, nh * hd)
    x = x + reduce_from_tp(proj(layer["o"], attn, lora_scale=ls, lora_dropout=ldrop,
                                generator=gen, use_kernel=use_kernel, tp=tp, row=True,
                                seq=seq), tp)
    x, aux = _ffn(layer, x, cfg, ls, use_kernel, lengths=lengths, rowwise=moe_rowwise,
                  tp=tp, routing=routing, pos0=seq[0] if seq is not None else 0)
    return x, (k, v), aux


def _block_remat(*args):
    """:func:`_block` under ``checkpoint``: keeps x and the MoE aux (whose
    gradients reach the router through the recomputation)."""
    x, _, aux = _block(*args)
    return x, aux


def llama_apply(params: Params, cfg: LLMConfig, *, inputs_embeds: torch.Tensor,
                lengths: torch.Tensor | None = None,
                lora: LoRAConfig | None = None,
                compute_dtype: torch.dtype = torch.float32,
                use_kernel: str = "auto", remat: bool = False,
                dropout_seed: int | None = None, return_cache: bool = False,
                cache_len: int | None = None, output: str = "logits",
                return_aux: bool = False, moe_rowwise: bool = False,
                dropout_row0: int = 0, sp=None, gather_hidden: bool = True,
                pp=None, global_rows: int | None = None, moe_group=None):
    """Full causal forward over [B, T, d] embeddings -> (logits [B,T,V] or
    final normed hidden [B,T,d] with ``output="hidden"``, cache or None),
    and with ``return_aux`` a third item, {"moe_lb", "moe_z"}: the MoE
    blocks' router losses averaged over those blocks (0 without any).

    ``return_cache`` writes each layer's post-RoPE K/V into a cache of
    ``cache_len`` positions (default T) in ``compute_dtype``. ``remat``
    keeps only each block's input for backward and recomputes the rest
    (while grad mode is on; the aux losses ride through the recompute).
    ``dropout_seed`` turns on LoRA dropout (``lora.dropout``), the
    counterpart of ``dropout_rng``, with masks drawn per row; the rows are
    rows ``dropout_row0`` on of a global batch (a rank's share of it). ``moe_rowwise`` (every inference
    prefill sets it) routes MoE blocks row by row (see :func:`_moe_mlp`);
    training keeps the flattened bounded capacity, over the tokens of every
    rank of ``moe_group`` (a rank's rows of the global batch: the data
    group, or the data and sp groups when the ring engages; its ranks in
    data-major, chunk-minor order), with the global capacity, slots and
    router losses (``ops/moe.py::Routing``).

    ``sp`` (sequence parallelism, the mesh's sp group): where JAX's ring
    engages (``ring_span``: T a multiple of the group's size) each rank runs
    the blocks on its contiguous chunk of the T positions, RoPE at their
    global positions, each LoRA dropout mask those positions of the whole
    sequence's draws, and attention the ring; the cache gets every layer's
    K/V gathered along the sequence, so every rank holds one card's. The
    final hidden states are gathered too, unless ``gather_hidden`` is off
    (with ``output="hidden"``: this rank's chunk of them, as the training
    forward reads them). Elsewhere the stack runs whole on every rank.

    ``pp`` (pipeline parallelism, the mesh's pp group of S stages): without
    a cache, as in JAX, each rank runs the ``n_layers / S`` blocks of its
    stage (remat per block as above) inside ``pipeline_apply``, on up to S
    microbatches of its rows (``global_rows``: the global batch's, for
    JAX's check), and every rank gets the last stage's hidden states. LoRA
    dropout is not threaded across the stages: a pipelined forward runs
    without it and warns once, as JAX does. A forward that writes the cache
    (every prefill) runs the whole stack on every rank."""
    B, T, d = inputs_embeds.shape
    if T > cfg.max_seq_len:
        raise ValueError(
            f"sequence length {T} exceeds llm.max_seq_len={cfg.max_seq_len}")
    if remat and return_cache:
        raise ValueError("remat recomputes the blocks for backward; it "
                         "cannot also return the KV cache")
    span = ring_span(sp, T)
    ring = sp if span else None
    c0, c1 = span or (0, T)
    routing = None
    group = ring if moe_rowwise else (moe_group if moe_group is not None else ring)
    if cfg.moe_experts > 0 and group is not None:
        routing = moe.Routing(group, ring.size if ring is not None else 1)
    x = scatter_to_sp(inputs_embeds.to(compute_dtype), ring, 1)
    cos, sin = rope_cos_sin(torch.arange(c0, c1, device=x.device), d // cfg.n_heads,
                            cfg.rope_theta)
    ls = lora_scale(lora)
    ldrop = lora.dropout if (lora is not None and dropout_seed is not None) else 0.0
    cache = (init_cache(cfg, B, cache_len or T, compute_dtype, x.device,
                        llm_tp(params)) if return_cache else None)
    lb_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_moe = 0
    pipelined = pp is not None and pp.size > 1 and not return_cache
    if pipelined:
        if ldrop > 0.0:
            _warn_pp_dropout()

        def stage_fn(stage: list, xx: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
            for lp in stage:
                args = (lp, xx, cos, sin, cfg, lens, ls, use_kernel)
                if remat and torch.is_grad_enabled():
                    xx, _ = checkpoint(_block_remat, *args, use_reentrant=False)
                else:
                    xx = _block(*args)[0]
            return xx

        lens = (lengths if lengths is not None
                else torch.full((B,), T, dtype=torch.int32, device=x.device))
        x = pipeline_apply(stage_fn, params["layers"], x, lens, group=pp,
                           global_rows=global_rows)
    for i, layer in enumerate([] if pipelined else params["layers"]):
        args = (layer, x, cos, sin, cfg, lengths, ls, use_kernel, ldrop,
                dropout_seed, i, moe_rowwise, dropout_row0, ring,
                (c0, T) if ring is not None else None, routing)
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_block_remat, *args, use_reentrant=False)
        else:
            x, (k, v), aux = _block(*args)
            if cache is not None:
                cache.k[i, :, :, :T] = gather_from_sp(k, ring, 2)
                cache.v[i, :, :, :T] = gather_from_sp(v, ring, 2)
        if aux is not None:
            lb_sum = lb_sum + aux[0]
            z_sum = z_sum + aux[1]
            n_moe += 1
    x = rms_norm(params["ln_f"], x, eps=cfg.rms_eps)
    if gather_hidden or output != "hidden":
        x = gather_from_sp(x, ring, 1)
    out = x if output == "hidden" else compute_logits(params, cfg, x)
    if return_aux:
        n = max(n_moe, 1)
        return out, cache, {"moe_lb": lb_sum / n, "moe_z": z_sum / n}
    return out, cache


_pp_dropout_warned = False


def _warn_pp_dropout() -> None:
    """The JAX package's warning, once: LoRA dropout is not threaded across
    pipeline stages."""
    global _pp_dropout_warned
    if not _pp_dropout_warned:
        _pp_dropout_warned = True
        logging.getLogger("avsr.models.llama").warning(
            "mesh.pp > 1: LoRA dropout is inactive under pipeline "
            "parallelism (rng is not threaded across stages). Set "
            "model.lora.dropout=0 to silence this warning.")


def _head_rows(params: Params, cfg: LLMConfig) -> tuple[torch.Tensor, Any]:
    """(the output projection as [V, d] rows: the tied embedding, or the
    transposed untied head; its tp group, whose ranks hold vocab slices,
    or None)."""
    head = params.get("lm_head")
    src = params["embed"] if cfg.tie_embeddings or head is None else head["w"]
    s = tp_of(src)
    return (src if src is params["embed"] else src.T), (s.group if s else None)


def compute_logits(params: Params, cfg: LLMConfig, x: torch.Tensor,
                   use_kernel: str = "auto") -> torch.Tensor:
    """Final hidden -> f32 vocab logits, f32 accumulation.

    A quantized head (``quantize_llm`` with lm_head_bits) goes through
    ``qdot`` with ``use_kernel`` and loses its vocab padding. Otherwise the
    JAX package multiplies at the wider of the two dtypes with an f32
    result; products of bf16 values are exact in f32, so both cases equal
    ``x.float() @ w.float()``. A non-f32 head is upcast one vocab chunk at
    a time, so no f32 copy of the whole head is ever live.

    Under tp (a head split over the vocabulary) each rank computes its
    vocab columns and the logits are gathered over the group (their
    gradient sliced back), so every rank holds the same full logits and
    takes the same next token; a quantized head's padding is dropped at
    the global end."""
    head = params.get("lm_head")
    if is_quantized(head):
        s = tp_of(head[next(k for k in ("qw", "qw4h", "qw4") if k in head)])
        tp = s.group if s is not None else None
        logits = qdot(copy_to_tp(x, tp), head, out_dtype=torch.float32,
                      use_kernel=use_kernel)
        return gather_from_tp(logits, tp, -1)[..., : cfg.vocab_size]
    w, tp = _head_rows(params, cfg)
    xf = copy_to_tp(x, tp).float()
    if w.dtype == torch.float32:
        return gather_from_tp(torch.matmul(xf, w.T), tp, -1)
    out = torch.empty((*x.shape[:-1], w.shape[0]), dtype=torch.float32,
                      device=x.device)
    for s in range(0, w.shape[0], LOGITS_CHUNK):
        e = min(s + LOGITS_CHUNK, w.shape[0])
        out[..., s:e] = torch.matmul(xf, w[s:e].float().T)
    return gather_from_tp(out, tp, -1)


def embed_tokens(params: Params, tokens: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather the rows first, then cast (the table is cast once at load).
    A vocab-sharded table (tp) looks up the tokens of its rank's range,
    zeros the others and sums over the group: one nonzero per element, so
    the sum is the row itself."""
    table = params["embed"]
    s = tp_of(table)
    if s is None:
        return table[tokens].to(dtype)
    n = table.shape[0]
    local = tokens - s.group.rank * n
    inside = (local >= 0) & (local < n)
    rows = torch.where(inside[..., None], table[local.clamp(0, n - 1)], 0)
    return reduce_from_tp(rows, s.group).to(dtype)


# ---------------------------------------------------------------------------
# Single decode step with KV cache
# ---------------------------------------------------------------------------

def _gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_lens: torch.Tensor,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token GQA attention: q [B,H,1,D] vs cache k/v [B,Hkv,M,D].

    Query heads are grouped over their kv head (no repeat of K/V). Scores
    and outputs accumulate in f32 from exact products of the cache dtype,
    as the JAX einsums with preferred_element_type=f32 do; q is scaled in
    f32 and then cast to the cache dtype, as there. An int8 cache is
    dequantized to bf16 with its scales [B,Hkv,1,1] first, so q is then
    rounded to bf16 even in an f32 step, as in the JAX package."""
    B, H, _, D = q.shape
    Hkv, M = k.shape[1], k.shape[2]
    if k.dtype == torch.int8:
        k = k.to(torch.bfloat16) * k_scale
        v = v.to(torch.bfloat16) * v_scale
    qg = (q.float() * (D ** -0.5)).to(k.dtype).reshape(B, Hkv, H // Hkv, D)
    s = torch.matmul(qg.float(), k.float().transpose(-1, -2))      # [B,Hkv,g,M]
    mask = (torch.arange(M, device=q.device)[None, :] < kv_lens[:, None])
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())             # [B,Hkv,g,D]
    return o.reshape(B, H, 1, D).to(q.dtype)


def llama_decode_step(params: Params, cfg: LLMConfig, *, x: torch.Tensor,
                      cache: KVCache, cur_lens: torch.Tensor,
                      lora: LoRAConfig | None = None,
                      compute_dtype: torch.dtype = torch.float32,
                      use_kernel: str = "auto"
                      ) -> tuple[torch.Tensor, KVCache]:
    """One causal step for x [B, 1, d] at positions ``cur_lens`` [B]:
    writes its K/V into column cur_lens[b] of ``cache`` (in place; an int8
    cache gets them quantized with its prefill scales), attends to
    cache[:cur_len + 1], and returns (logits [B, V] f32, cache).
    ``use_kernel`` goes to the quantized products. Under tp each rank runs
    its heads over its cache (:func:`init_cache`) and every rank gets the
    full logits."""
    B = x.shape[0]
    d = cfg.d_model
    hd = d // cfg.n_heads
    tp = llm_tp(params)
    nh, nkv = local_heads(cfg, tp)
    x = x.to(compute_dtype)
    pos = cur_lens.long()
    cos, sin = rope_cos_sin(pos[:, None], hd, cfg.rope_theta)
    ls = lora_scale(lora)
    b_idx = torch.arange(B, device=x.device)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(layer["ln_attn"], x, eps=cfg.rms_eps)
        q, k, v = _proj_qkv(layer, h, ls, use_kernel=use_kernel, tp=tp, q_width=nh * hd)
        q = apply_rope(q.reshape(B, 1, nh, hd).transpose(1, 2), cos, sin)
        k = apply_rope(k.reshape(B, 1, nkv, hd).transpose(1, 2), cos, sin)
        v = v.reshape(B, 1, nkv, hd).transpose(1, 2)
        k_new, v_new = k[:, :, 0], v[:, :, 0]                      # [B, Hkv, Dh]
        sk = sv = None
        if cache.quantized:
            sk, sv = cache.k_scale[i], cache.v_scale[i]            # [B, Hkv, 1, 1]
            k_new = torch.clamp(torch.round(k_new.float() / sk[..., 0].float()), -127, 127)
            v_new = torch.clamp(torch.round(v_new.float() / sv[..., 0].float()), -127, 127)
        k_i, v_i = cache.k[i], cache.v[i]                          # views
        k_i[b_idx, :, pos] = k_new.to(k_i.dtype)
        v_i[b_idx, :, pos] = v_new.to(v_i.dtype)
        attn = _gqa_decode_attention(q, k_i, v_i, kv_lens=pos + 1,
                                     k_scale=sk, v_scale=sv)
        x = x + reduce_from_tp(proj(layer["o"], attn.transpose(1, 2).reshape(B, 1, nh * hd),
                                    lora_scale=ls, use_kernel=use_kernel, tp=tp, row=True), tp)
        x, _ = _ffn(layer, x, cfg, ls, use_kernel, dropless=True, tp=tp)
    x = rms_norm(params["ln_f"], x, eps=cfg.rms_eps)
    return compute_logits(params, cfg, x, use_kernel)[:, 0], cache


# ---------------------------------------------------------------------------
# Chunked prefill continuation (streaming, the speculative verify pass)
# ---------------------------------------------------------------------------

def _gqa_prefill_attention(q: torch.Tensor, k_all: torch.Tensor,
                           v_all: torch.Tensor, base_lens: torch.Tensor,
                           tail_lens: torch.Tensor) -> torch.Tensor:
    """Tail-block attention against the cache history and causal self: q
    [B,H,T,D] at absolute positions base_lens[b] + t, k/v the cache
    [B,Hkv,M,D] already holding the history (< base) and this tail (base
    .. base + T). Position m is visible to tail row t iff m <= base_lens[b]
    + t and t < tail_lens[b], so stale columns past the tail (an earlier
    chunk's decode writes) are masked out. Rows t >= tail_lens[b] see
    nothing and come out as the mean of V, as in the JAX package; no
    caller reads them."""
    B, H, T, D = q.shape
    Hkv, M = k_all.shape[1], k_all.shape[2]
    qg = (q.float() * (D ** -0.5)).to(k_all.dtype).reshape(B, Hkv, H // Hkv * T, D)
    s = torch.matmul(qg.float(), k_all.float().transpose(-1, -2))
    s = s.reshape(B, Hkv, H // Hkv, T, M)
    t = torch.arange(T, device=q.device)
    lim = base_lens.long()[:, None] + t[None, :]                       # [B, T]
    vis = torch.arange(M, device=q.device)[None, None, :] <= lim[:, :, None]
    vis &= (t[None, :] < tail_lens[:, None])[:, :, None]               # [B, T, M]
    s = torch.where(vis[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1).reshape(B, Hkv, H // Hkv * T, M)
    o = torch.matmul(p.to(v_all.dtype).float(), v_all.float())
    return o.reshape(B, H, T, D).to(q.dtype)


def llama_prefill_continue(params: Params, cfg: LLMConfig, *, x: torch.Tensor,
                           cache: KVCache, base_lens: torch.Tensor,
                           tail_lens: torch.Tensor,
                           lora: LoRAConfig | None = None,
                           compute_dtype: torch.dtype = torch.float32,
                           use_kernel: str = "auto"
                           ) -> tuple[torch.Tensor, KVCache]:
    """Extend a KV cache by a tail block x [B, T, d] (right-padded,
    ``tail_lens`` valid rows) after ``base_lens`` [B] history tokens: each
    layer writes the block's K/V into columns base_lens[b] .. base_lens[b]
    + T of ``cache`` (in place; every one of them must exist) and attends
    to the history and causally to the block. Returns (the normed hidden
    states [B, T, d], cache); one ``llama_apply`` over [history | tail]
    gives the same rows. ``use_kernel`` goes to the quantized products;
    under tp each rank extends its heads' cache."""
    B, T, d = x.shape
    hd = d // cfg.n_heads
    tp = llm_tp(params)
    nh, nkv = local_heads(cfg, tp)
    x = x.to(compute_dtype)
    cols = base_lens.long()[:, None] + torch.arange(T, device=x.device)[None, :]
    cos, sin = rope_cos_sin(cols, hd, cfg.rope_theta)
    ls = lora_scale(lora)
    b_idx = torch.arange(B, device=x.device)[:, None]
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(layer["ln_attn"], x, eps=cfg.rms_eps)
        q, k, v = _proj_qkv(layer, h, ls, use_kernel=use_kernel, tp=tp, q_width=nh * hd)
        q = apply_rope(q.reshape(B, T, nh, hd).transpose(1, 2), cos, sin)
        k = apply_rope(k.reshape(B, T, nkv, hd).transpose(1, 2), cos, sin)
        v = v.reshape(B, T, nkv, hd)
        k_i, v_i = cache.k[i], cache.v[i]                          # views
        k_i[b_idx, :, cols] = k.transpose(1, 2).to(k_i.dtype)     # [B, T, Hkv, Dh]
        v_i[b_idx, :, cols] = v.to(v_i.dtype)
        attn = _gqa_prefill_attention(q, k_i, v_i, base_lens, tail_lens)
        x = x + reduce_from_tp(proj(layer["o"], attn.transpose(1, 2).reshape(B, T, nh * hd),
                                    lora_scale=ls, use_kernel=use_kernel, tp=tp, row=True), tp)
        x, _ = _ffn(layer, x, cfg, ls, use_kernel, lengths=tail_lens, dropless=True,
                    tp=tp)
    return rms_norm(params["ln_f"], x, eps=cfg.rms_eps), cache


# ---------------------------------------------------------------------------
# Beam decode step over a shared-prefix split cache
# ---------------------------------------------------------------------------

def _gqa_split_decode_attention(q: torch.Tensor, k_pre: torch.Tensor,
                                v_pre: torch.Tensor, k_suf: torch.Tensor,
                                v_suf: torch.Tensor, k_self: torch.Tensor,
                                v_self: torch.Tensor, prefix_lens: torch.Tensor,
                                step: int, k_scale: torch.Tensor | None = None,
                                v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Beam decode attention over a split cache: q [B*W,H,1,D]; the prefix
    k/v [B,Hkv,Mp,D], shared by a sample's W beams, so one read of it
    serves them all (an int8 prefix is dequantized to bf16 with its scales
    [B,Hkv,1,1]); the per-beam suffix [B*W,Hkv,Ms,D], whose columns below
    ``step`` are valid; and this step's own k/v [B*W,Hkv,D], not yet in
    the suffix, as a rank-1 term. One softmax over [prefix | suffix |
    self]; scores and outputs accumulate in f32 from exact products of the
    stored dtypes, as the JAX einsums do."""
    BW, H, _, D = q.shape
    B, Hkv, Mp = k_pre.shape[:3]
    W, Ms, g = BW // B, k_suf.shape[2], H // Hkv
    if k_pre.dtype == torch.int8:
        k_pre = k_pre.to(torch.bfloat16) * k_scale
        v_pre = v_pre.to(torch.bfloat16) * v_scale
    qs = (q.float() * (D ** -0.5)).to(k_pre.dtype).reshape(B, W, Hkv, g, D)
    s_pre = torch.einsum("bwhgd,bhmd->bwhgm", qs.float(), k_pre.float())
    q_suf = qs.reshape(BW, Hkv, g, D).to(k_suf.dtype)
    s_suf = torch.matmul(q_suf.float(), k_suf.float().transpose(-1, -2))
    s_suf = s_suf.reshape(B, W, Hkv, g, Ms)
    s_self = torch.einsum("bhgd,bhd->bhg", q_suf.to(k_self.dtype).float(),
                          k_self.float()).reshape(B, W, Hkv, g, 1)
    mask_pre = torch.arange(Mp, device=q.device)[None, :] < prefix_lens[:, None]
    s_pre = torch.where(mask_pre[:, None, None, None, :], s_pre, -1e30)
    s_suf = torch.where(torch.arange(Ms, device=q.device) < step, s_suf, -1e30)
    p = torch.softmax(torch.cat([s_pre, s_suf, s_self], dim=-1), dim=-1)
    p_pre, p_suf, p_self = p[..., :Mp], p[..., Mp:Mp + Ms], p[..., -1:]
    o = torch.einsum("bwhgm,bhmd->bwhgd", p_pre.to(v_pre.dtype).float(), v_pre.float())
    o = o + torch.einsum("bwhgm,bwhmd->bwhgd", p_suf.to(v_suf.dtype).float(),
                         v_suf.reshape(B, W, Hkv, Ms, D).float())
    o = o + p_self.float() * v_self.reshape(B, W, Hkv, 1, D).float()
    return o.reshape(BW, H, 1, D).to(q.dtype)


def llama_decode_step_split(params: Params, cfg: LLMConfig, *, x: torch.Tensor,
                            prefix_cache: KVCache, suffix_cache: KVCache,
                            prefix_lens: torch.Tensor, step: int,
                            lora: LoRAConfig | None = None,
                            compute_dtype: torch.dtype = torch.float32,
                            use_kernel: str = "auto"
                            ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One beam-decode step for x [B*W, 1, d] (W beams per sample, beam-
    major within a sample) at positions prefix_lens[b] + ``step``, against
    the [L, B, ...] prefix cache (read only) and the [L, B*W, ...] suffix
    cache of the tokens generated so far. Writes nothing: returns (logits
    [B*W, V] f32, (k, v) [L, B*W, Hkv, Dh] of this step, in the suffix's
    dtype), which :func:`merge_new_columns` lands at column ``step``
    during the next step's beam gather. Under tp: the rank's heads, full
    logits."""
    BW = x.shape[0]
    B = prefix_cache.k.shape[1]
    W = BW // B
    d = cfg.d_model
    hd = d // cfg.n_heads
    tp = llm_tp(params)
    nh, nkv = local_heads(cfg, tp)
    x = x.to(compute_dtype)
    pos = (prefix_lens.long().repeat_interleave(W) + step)[:, None]    # [B*W, 1]
    cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)
    ls = lora_scale(lora)
    qpre = prefix_cache.quantized
    k_news, v_news = [], []
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(layer["ln_attn"], x, eps=cfg.rms_eps)
        q, k, v = _proj_qkv(layer, h, ls, use_kernel=use_kernel, tp=tp, q_width=nh * hd)
        q = apply_rope(q.reshape(BW, 1, nh, hd).transpose(1, 2), cos, sin)
        k = apply_rope(k.reshape(BW, 1, nkv, hd).transpose(1, 2), cos, sin)
        k_news.append(k[:, :, 0])
        v_news.append(v.reshape(BW, nkv, hd))
        attn = _gqa_split_decode_attention(
            q, prefix_cache.k[i], prefix_cache.v[i], suffix_cache.k[i],
            suffix_cache.v[i], k_news[-1], v_news[-1], prefix_lens, step,
            k_scale=prefix_cache.k_scale[i] if qpre else None,
            v_scale=prefix_cache.v_scale[i] if qpre else None)
        x = x + reduce_from_tp(proj(layer["o"], attn.transpose(1, 2).reshape(BW, 1, nh * hd),
                                    lora_scale=ls, use_kernel=use_kernel, tp=tp, row=True), tp)
        x, _ = _ffn(layer, x, cfg, ls, use_kernel, dropless=True, tp=tp)
    x = rms_norm(params["ln_f"], x, eps=cfg.rms_eps)
    logits = compute_logits(params, cfg, x, use_kernel)[:, 0]
    dt = suffix_cache.k.dtype
    return logits, (torch.stack(k_news).to(dt), torch.stack(v_news).to(dt))


def merge_new_columns(suffix_cache: KVCache, k_new: torch.Tensor,
                      v_new: torch.Tensor, gather: torch.Tensor,
                      col: int) -> KVCache:
    """Reindex the suffix cache by beam (row r takes row gather[r]) and
    land the previous step's K/V [L, B*W, Hkv, Dh] at column ``col`` of the
    same rows; ``col`` < 0 (the first step) lands nothing. Returns a new
    cache: out[l, r, :, m] = new[l, gather[r]] if m == col else
    suffix[l, gather[r], :, m]."""
    k, v = suffix_cache.k[:, gather], suffix_cache.v[:, gather]
    if col >= 0:
        k[:, :, :, col] = k_new[:, gather]
        v[:, :, :, col] = v_new[:, gather]
    return KVCache(k, v)


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------

def convert_hf_llama(state_dict: dict[str, Any], cfg: LLMConfig) -> Params:
    """An HF ``LlamaForCausalLM`` state dict -> the port's tree (keys with
    or without the ``model.`` prefix; weights ``[out, in]`` become
    ``[in, out]``). The head is kept only for an untied config whose state
    dict has ``lm_head.weight``."""
    sd = Prefixed(state_dict, ("model.", ""))
    arr = sd.arr

    def lin(name: str) -> Params:
        return sd.lin(name, bias=False)

    layers = []
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        layers.append({
            "ln_attn": {"scale": arr(pre + "input_layernorm.weight")},
            "q": lin(pre + "self_attn.q_proj"),
            "k": lin(pre + "self_attn.k_proj"),
            "v": lin(pre + "self_attn.v_proj"),
            "o": lin(pre + "self_attn.o_proj"),
            "ln_mlp": {"scale": arr(pre + "post_attention_layernorm.weight")},
            "gate": lin(pre + "mlp.gate_proj"),
            "up": lin(pre + "mlp.up_proj"),
            "down": lin(pre + "mlp.down_proj"),
        })
    params: Params = {
        "embed": arr("embed_tokens.weight"),
        "layers": layers,
        "ln_f": {"scale": arr("norm.weight")},
    }
    if not cfg.tie_embeddings and "lm_head.weight" in state_dict:
        params["lm_head"] = lin("lm_head")
    return params
