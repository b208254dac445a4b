"""Modality connectors, the port of ``avsr_tpu/models/connectors.py``:
project encoder features into the LLM embedding space.

single-input (audio-dim or video-dim -> llm-dim):
  simple     one linear layer, xavier init
  deep       in-proj + residual MLP block + LN, with a linear skip
  conv       two SAME conv1d (kernel 3) + LN + gelu, then out-proj
  attention  in-proj + one pre-LN encoder block (8 heads)
  adaptive   in-proj + sinusoid PE + a stride-4 conv for sequences longer
             than 512 + an MHA mix (8 heads)

dual-input (audio, video -> fused; ``ConnectorDef.dual``):
  cross_modal two layers of bidirectional cross-attention, then video
              aligned to the audio grid and concatenated + projected
  qformer     N learnable queries: self-attention, cross-attention to the
              audio and to the video, MLP; a fixed-length output
  perceiver   M latents cross-attending to the concatenated AV stream,
              each cross step followed by a self-attention block
  adapter     both modalities projected, video aligned to the audio grid
              and added, then bottleneck adapter layers

single-input mixture of experts:
  moe        in-proj + 2 residual MoE-FFN blocks (gelu experts, top-k
             capacity routing shared with the LLM's MoE FFN, ``ops/moe.py``)

The parameter trees are the JAX package's leaf for leaf (conv kernels keep
JAX's [K, C_in, C_out] layout), so ``convert.from_numpy_tree`` carries a
JAX init across. Apply signatures:
  single: apply(params, x, lengths, *, use_kernel) -> (y, lengths)
  dual:   apply(params, audio, video, a_lens, v_lens, *, use_kernel)
          -> (y, lengths)
  moe:    apply(params, x, lengths, *, model_cfg, moe_rowwise)
          -> (y, lengths, {"moe_lb", "moe_z"})
Every apply takes (and all but ``moe`` ignore) ``model_cfg`` and
``moe_rowwise``, which ``models/avsr.py::encode`` passes to each.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from avsr_tpu_torch.core.config import CONNECTOR_TYPES, ModelConfig
from avsr_tpu_torch.models.layers import (
    Params,
    dense,
    dense_init,
    encoder_block_apply,
    encoder_block_init,
    gelu,
    layer_norm,
    mha_apply,
    mha_init,
    norm_init,
    normal_init,
    sinusoid_position_embedding,
)
from avsr_tpu_torch.mesh.sharding import tp_group
from avsr_tpu_torch.ops import moe


class ConnectorDef(NamedTuple):
    init: Callable[..., Params]
    apply: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    dual: bool = False


def _ident_lens(x: torch.Tensor, lengths: torch.Tensor | None) -> torch.Tensor:
    if lengths is not None:
        return lengths
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                      device=x.device)


def upsample_to(x: torch.Tensor, x_lens: torch.Tensor, target_T: int,
                target_lens: torch.Tensor) -> torch.Tensor:
    """Nearest-index resample of [B, T, d] onto the target time grid (the
    video onto the audio's, for ``weighted_sum`` fusion and the
    ``cross_modal`` and ``adapter`` connectors): row t takes row
    clip(int(t * max(x_len, 1) / max(target_len, 1)), 0, T - 1).

    A product with a one-hot [B, target_T, T] matrix: each output row has
    one nonzero term, so the values are the gather's (the JAX
    ``take_along_axis``), and the backward is a matrix product too. A
    gather's backward adds the repeated rows (about 20 per video frame on
    the flagship) with float atomics on the card, in an order that changes
    from run to run, so a resumed run could not repeat an uninterrupted
    one."""
    ratio = (x_lens.clamp(min=1).float() / target_lens.clamp(min=1).float())
    pos = torch.arange(target_T, device=x.device)[None, :] * ratio[:, None]
    idx = pos.to(torch.int64).clamp(0, x.shape[1] - 1)
    onehot = idx[..., None] == torch.arange(x.shape[1], device=x.device)
    return torch.matmul(onehot.to(x.dtype), x)


# ---------------------------------------------------------------------------
# simple, deep, conv
# ---------------------------------------------------------------------------

def simple_init(gen: torch.Generator, d_in: int, d_out: int, cfg: ModelConfig,
                dtype: torch.dtype = torch.float32) -> Params:
    del cfg
    return {"out": dense_init(gen, d_in, d_out, dtype=dtype)}


def simple_apply(p: Params, x: torch.Tensor, lengths=None, **_):
    return dense(p["out"], x), _ident_lens(x, lengths)


def deep_init(gen, d_in, d_out, cfg: ModelConfig, dtype=torch.float32) -> Params:
    hid = d_out * cfg.connector_hidden_mult
    return {
        "inp": dense_init(gen, d_in, hid, dtype=dtype),
        "ln1": norm_init(gen, hid, dtype=dtype),
        "mid": dense_init(gen, hid, hid, dtype=dtype),
        "ln2": norm_init(gen, hid, dtype=dtype),
        "out": dense_init(gen, hid, d_out, dtype=dtype),
        "ln_out": norm_init(gen, d_out, dtype=dtype),
        "res": dense_init(gen, d_in, d_out, bias=False, dtype=dtype),
    }


def deep_apply(p: Params, x: torch.Tensor, lengths=None, **_):
    h = gelu(layer_norm(p["ln1"], dense(p["inp"], x)))
    h = h + gelu(layer_norm(p["ln2"], dense(p["mid"], h)))
    y = layer_norm(p["ln_out"], dense(p["out"], h) + dense(p["res"], x))
    return y, _ident_lens(x, lengths)


def _conv_init(gen, k: int, c_in: int, c_out: int, dtype) -> Params:
    return {"w": normal_init(gen, (k, c_in, c_out), std=(k * c_in) ** -0.5,
                             dtype=dtype),
            "b": torch.zeros((c_out,), dtype=dtype, device=gen.device)}


def conv_init(gen, d_in, d_out, cfg: ModelConfig, dtype=torch.float32) -> Params:
    hid = d_out * cfg.connector_hidden_mult
    return {
        "conv1": _conv_init(gen, 3, d_in, hid, dtype),
        "ln1": norm_init(gen, hid, dtype=dtype),
        "conv2": _conv_init(gen, 3, hid, hid, dtype),
        "ln2": norm_init(gen, hid, dtype=dtype),
        "out": dense_init(gen, hid, d_out, dtype=dtype),
    }


def _conv1d_cl(p: Params, x: torch.Tensor, *, stride: int = 1,
               padding: str = "same") -> torch.Tensor:
    """Channels-last conv1d: x [B, T, C] * w [K, C_in, C_out] (JAX's
    layout, kept at the parameter) + b, in x's dtype."""
    w = p["w"].to(x.dtype).permute(2, 1, 0)                    # [C_out, C_in, K]
    y = F.conv1d(x.transpose(1, 2), w, stride=stride, padding=padding)
    return y.transpose(1, 2) + p["b"].to(x.dtype)


def conv_apply(p: Params, x: torch.Tensor, lengths=None, **_):
    h = gelu(layer_norm(p["ln1"], _conv1d_cl(p["conv1"], x)))
    h = gelu(layer_norm(p["ln2"], _conv1d_cl(p["conv2"], h)))
    return dense(p["out"], h), _ident_lens(x, lengths)


# ---------------------------------------------------------------------------
# attention, adaptive (8 heads: head width 256 over a 2048-wide LLM)
# ---------------------------------------------------------------------------

_CONN_HEADS = 8


def attention_init(gen, d_in, d_out, cfg: ModelConfig, dtype=torch.float32) -> Params:
    return {
        "inp": dense_init(gen, d_in, d_out, dtype=dtype),
        "block": encoder_block_init(gen, d_out, d_out * cfg.connector_hidden_mult,
                                    dtype=dtype),
    }


def attention_apply(p: Params, x: torch.Tensor, lengths=None, *,
                    use_kernel: str = "auto", **_):
    lens = _ident_lens(x, lengths)
    h = dense(p["inp"], x)
    h = encoder_block_apply(p["block"], h, n_heads=_CONN_HEADS, lengths=lens,
                            use_kernel=use_kernel)
    return h, lens


_ADAPTIVE_THRESHOLD = 512
_ADAPTIVE_STRIDE = 4


def adaptive_init(gen, d_in, d_out, cfg: ModelConfig, dtype=torch.float32) -> Params:
    del cfg
    return {
        "inp": dense_init(gen, d_in, d_out, dtype=dtype),
        "pool": _conv_init(gen, _ADAPTIVE_STRIDE, d_out, d_out, dtype),
        "mix": mha_init(gen, d_out, dtype=dtype),
        "ln": norm_init(gen, d_out, dtype=dtype),
    }


def adaptive_apply(p: Params, x: torch.Tensor, lengths=None, *,
                   use_kernel: str = "auto", **_):
    lens = _ident_lens(x, lengths)
    h = dense(p["inp"], x)
    T = h.shape[1]
    h = h + sinusoid_position_embedding(T, h.shape[-1], h.device).to(h.dtype)[None]
    if T > _ADAPTIVE_THRESHOLD:     # a decision on the padded width, as in JAX
        h = _conv1d_cl(p["pool"], h, stride=_ADAPTIVE_STRIDE, padding="valid")
        lens = torch.clamp(torch.div(lens - _ADAPTIVE_STRIDE, _ADAPTIVE_STRIDE,
                                     rounding_mode="floor") + 1, min=1).to(torch.int32)
    h = h + mha_apply(p["mix"], layer_norm(p["ln"], h), n_heads=_CONN_HEADS,
                      lengths=lens, use_kernel=use_kernel)
    return h, lens


# ---------------------------------------------------------------------------
# Dual-input connectors
# ---------------------------------------------------------------------------

_FUSION_LAYERS = 2


def cross_modal_init(gen, d_audio, d_video, d_out, cfg: ModelConfig,
                     dtype=torch.float32) -> Params:
    del cfg
    layers = [{"a2v": mha_init(gen, d_out, dtype=dtype),
               "v2a": mha_init(gen, d_out, dtype=dtype),
               "ln_a": norm_init(gen, d_out, dtype=dtype),
               "ln_v": norm_init(gen, d_out, dtype=dtype)}
              for _ in range(_FUSION_LAYERS)]
    return {
        "proj_a": dense_init(gen, d_audio, d_out, dtype=dtype),
        "proj_v": dense_init(gen, d_video, d_out, dtype=dtype),
        "layers": layers,
        "out": dense_init(gen, 2 * d_out, d_out, dtype=dtype),
    }


def cross_modal_apply(p: Params, audio, video, a_lens=None, v_lens=None, *,
                      use_kernel: str = "auto", **_):
    a_lens = _ident_lens(audio, a_lens)
    v_lens = _ident_lens(video, v_lens)
    a = dense(p["proj_a"], audio)
    v = dense(p["proj_v"], video)
    for lp in p["layers"]:
        a = a + mha_apply(lp["a2v"], layer_norm(lp["ln_a"], a), kv=v,
                          n_heads=_CONN_HEADS, lengths=a_lens,
                          kv_lengths=v_lens, use_kernel=use_kernel)
        v = v + mha_apply(lp["v2a"], layer_norm(lp["ln_v"], v), kv=a,
                          n_heads=_CONN_HEADS, lengths=v_lens,
                          kv_lengths=a_lens, use_kernel=use_kernel)
    fused = torch.cat([a, upsample_to(v, v_lens, a.shape[1], a_lens)], dim=-1)
    return dense(p["out"], fused), a_lens


_QFORMER_LAYERS = 2


def qformer_init(gen, d_audio, d_video, d_out, cfg: ModelConfig,
                 dtype=torch.float32) -> Params:
    hid = d_out * cfg.connector_hidden_mult
    layers = [{"self": mha_init(gen, d_out, dtype=dtype),
               "ln_s": norm_init(gen, d_out, dtype=dtype),
               "xa": mha_init(gen, d_out, dtype=dtype),
               "ln_a": norm_init(gen, d_out, dtype=dtype),
               "xv": mha_init(gen, d_out, dtype=dtype),
               "ln_v": norm_init(gen, d_out, dtype=dtype),
               "fc1": dense_init(gen, d_out, hid, dtype=dtype),
               "fc2": dense_init(gen, hid, d_out, dtype=dtype),
               "ln_m": norm_init(gen, d_out, dtype=dtype)}
              for _ in range(_QFORMER_LAYERS)]
    return {
        "queries": normal_init(gen, (cfg.qformer_queries, d_out), std=0.02, dtype=dtype),
        "proj_a": dense_init(gen, d_audio, d_out, dtype=dtype),
        "proj_v": dense_init(gen, d_video, d_out, dtype=dtype),
        "layers": layers,
        "ln_out": norm_init(gen, d_out, dtype=dtype),
    }


def qformer_apply(p: Params, audio, video, a_lens=None, v_lens=None, *,
                  use_kernel: str = "auto", **_):
    B = audio.shape[0]
    a_lens = _ident_lens(audio, a_lens)
    v_lens = _ident_lens(video, v_lens)
    a = dense(p["proj_a"], audio)
    v = dense(p["proj_v"], video)
    q = p["queries"].to(a.dtype).expand(B, -1, -1)
    for lp in p["layers"]:
        q = q + mha_apply(lp["self"], layer_norm(lp["ln_s"], q),
                          n_heads=_CONN_HEADS, use_kernel=use_kernel)
        q = q + mha_apply(lp["xa"], layer_norm(lp["ln_a"], q), kv=a,
                          n_heads=_CONN_HEADS, kv_lengths=a_lens,
                          use_kernel=use_kernel)
        q = q + mha_apply(lp["xv"], layer_norm(lp["ln_v"], q), kv=v,
                          n_heads=_CONN_HEADS, kv_lengths=v_lens,
                          use_kernel=use_kernel)
        q = q + dense(lp["fc2"], gelu(dense(lp["fc1"], layer_norm(lp["ln_m"], q))))
    q = layer_norm(p["ln_out"], q)
    return q, _ident_lens(q, None)


_PERCEIVER_LAYERS = 2


def perceiver_init(gen, d_audio, d_video, d_out, cfg: ModelConfig,
                   dtype=torch.float32) -> Params:
    layers = [{"cross": mha_init(gen, d_out, dtype=dtype),
               "ln_x": norm_init(gen, d_out, dtype=dtype),
               "self": encoder_block_init(gen, d_out, d_out * cfg.connector_hidden_mult,
                                          dtype=dtype)}
              for _ in range(_PERCEIVER_LAYERS)]
    return {
        "latents": normal_init(gen, (cfg.perceiver_latents, d_out), std=0.02,
                               dtype=dtype),
        "proj_a": dense_init(gen, d_audio, d_out, dtype=dtype),
        "proj_v": dense_init(gen, d_video, d_out, dtype=dtype),
        "layers": layers,
        "ln_out": norm_init(gen, d_out, dtype=dtype),
    }


def perceiver_apply(p: Params, audio, video, a_lens=None, v_lens=None, *,
                    use_kernel: str = "auto", **_):
    B, Ta = audio.shape[:2]
    Tv = video.shape[1]
    a_lens = _ident_lens(audio, a_lens)
    v_lens = _ident_lens(video, v_lens)
    a = dense(p["proj_a"], audio)
    v = dense(p["proj_v"], video)
    stream = torch.cat([a, v], dim=1)                               # [B, Ta+Tv, d]
    # the audio's padding sits mid-stream, so the keys need an explicit mask
    dev = a.device
    valid = torch.cat([
        torch.arange(Ta, device=dev)[None, :] < a_lens.to(dev)[:, None],
        torch.arange(Tv, device=dev)[None, :] < v_lens.to(dev)[:, None]], dim=1)
    lat = p["latents"].to(a.dtype).expand(B, -1, -1)
    for lp in p["layers"]:
        lat = lat + mha_apply(lp["cross"], layer_norm(lp["ln_x"], lat), kv=stream,
                              n_heads=_CONN_HEADS, kv_valid=valid,
                              use_kernel=use_kernel)
        lat = encoder_block_apply(lp["self"], lat, n_heads=_CONN_HEADS,
                                  use_kernel=use_kernel)
    lat = layer_norm(p["ln_out"], lat)
    return lat, _ident_lens(lat, None)


def adapter_init(gen, d_audio, d_video, d_out, cfg: ModelConfig,
                 dtype=torch.float32) -> Params:
    layers = [{"ln": norm_init(gen, d_out, dtype=dtype),
               "down": dense_init(gen, d_out, cfg.adapter_dim, dtype=dtype),
               "up": dense_init(gen, cfg.adapter_dim, d_out, dtype=dtype)}
              for _ in range(max(cfg.num_adapter_layers, 1))]
    return {
        "proj_a": dense_init(gen, d_audio, d_out, dtype=dtype),
        "proj_v": dense_init(gen, d_video, d_out, dtype=dtype),
        "layers": layers,
    }


def adapter_apply(p: Params, audio, video, a_lens=None, v_lens=None, **_):
    a_lens = _ident_lens(audio, a_lens)
    v_lens = _ident_lens(video, v_lens)
    a = dense(p["proj_a"], audio)
    v = dense(p["proj_v"], video)
    h = a + upsample_to(v, v_lens, a.shape[1], a_lens)
    for lp in p["layers"]:
        h = h + dense(lp["up"], gelu(dense(lp["down"], layer_norm(lp["ln"], h))))
    return h, a_lens


# ---------------------------------------------------------------------------
# moe (single-input): a sparse mixture-of-experts projector
# ---------------------------------------------------------------------------

_MOE_LAYERS = 2


def moe_init(gen, d_in, d_out, cfg: ModelConfig, dtype=torch.float32) -> Params:
    E = cfg.moe_experts
    hid = d_out * cfg.connector_hidden_mult
    dev = gen.device
    blocks = [{
        "ln": norm_init(gen, d_out, dtype=dtype),
        "router": {"w": normal_init(gen, (d_out, E), std=d_out ** -0.5, dtype=dtype)},
        "experts": {
            "w1": normal_init(gen, (E, d_out, hid), std=d_out ** -0.5, dtype=dtype),
            "b1": torch.zeros((E, hid), dtype=dtype, device=dev),
            "w2": normal_init(gen, (E, hid, d_out), std=hid ** -0.5, dtype=dtype),
            "b2": torch.zeros((E, d_out), dtype=dtype, device=dev),
        },
    } for _ in range(_MOE_LAYERS)]
    return {"inp": dense_init(gen, d_in, d_out, dtype=dtype), "blocks": blocks}


def _moe_block(blk: Params, x: torch.Tensor, valid: torch.Tensor, topk: int,
               cap_factor: float, rowwise: bool = False,
               routing: moe.Routing | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One MoE-FFN over x [B, T, d] (the block's residual is the caller's):
    (y, lb loss, z loss), the gelu two-matrix experts in x's dtype.
    ``rowwise`` (inference) routes each row within its own capacity slots
    (``ops/moe.py::ffn``), so a request's features are the same in any
    batch: the encode-side half of the engine == generate_tokens
    contract. Training routes over the rows of every rank of ``routing``
    (the data group: every sp, tp and pp rank holds whole rows), and
    experts sliced over ep are this rank's E / ep."""
    cdt = x.dtype
    w1, b1, w2, b2 = (blk["experts"][n].to(cdt) for n in ("w1", "b1", "w2", "b2"))

    def experts(xs: torch.Tensor) -> torch.Tensor:               # [E, C', d]
        h = gelu(torch.matmul(xs, w1) + b1[:, None, :])
        return torch.matmul(h, w2) + b2[:, None, :]

    return moe.ffn(x, blk["router"]["w"], valid, topk, cap_factor, experts, rowwise=rowwise,
                   routing=routing, ep=tp_group(blk["experts"], "ep"))


def moe_apply(p: Params, x: torch.Tensor, lengths=None, *,
              model_cfg: ModelConfig | None = None, moe_rowwise: bool = False,
              moe_routing: moe.Routing | None = None, **_):
    if model_cfg is None:
        raise ValueError("moe connector needs model_cfg threaded into apply")
    lens = _ident_lens(x, lengths)
    h = dense(p["inp"], x)
    valid = (torch.arange(h.shape[1], device=h.device)[None, :]
             < lens.to(h.device)[:, None])
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    z = torch.zeros((), dtype=torch.float32, device=h.device)
    for blk in p["blocks"]:
        y, blb, bz = _moe_block(blk, layer_norm(blk["ln"], h), valid, model_cfg.moe_topk,
                                model_cfg.moe_capacity_factor, rowwise=moe_rowwise,
                                routing=moe_routing)
        h = h + y
        lb = lb + blb
        z = z + bz
    n = float(len(p["blocks"]))
    return h, lens, {"moe_lb": lb / n, "moe_z": z / n}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_CONNECTORS = {
    "simple": ConnectorDef(simple_init, simple_apply),
    "deep": ConnectorDef(deep_init, deep_apply),
    "conv": ConnectorDef(conv_init, conv_apply),
    "attention": ConnectorDef(attention_init, attention_apply),
    "adaptive": ConnectorDef(adaptive_init, adaptive_apply),
    "cross_modal": ConnectorDef(cross_modal_init, cross_modal_apply, dual=True),
    "qformer": ConnectorDef(qformer_init, qformer_apply, dual=True),
    "perceiver": ConnectorDef(perceiver_init, perceiver_apply, dual=True),
    "adapter": ConnectorDef(adapter_init, adapter_apply, dual=True),
    "moe": ConnectorDef(moe_init, moe_apply),
}


def get_connector(name: str) -> ConnectorDef:
    if name in _CONNECTORS:
        return _CONNECTORS[name]
    raise KeyError(f"Unknown connector {name!r}; valid: {sorted(CONNECTOR_TYPES)}")
