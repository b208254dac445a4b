"""AV-HuBERT video encoder, the port of ``avsr_tpu/models/avhubert.py``.

The video branch of AV-HuBERT (Shi et al., "Learning Audio-Visual Speech
Representation by Masked Multimodal Cluster Prediction"):

    lip frames [B, T, 3, S, S] --gray (channel mean)--> [B, 1, T, S, S]
    --Conv3d(5x7x7, stride 1x2x2, pad 2x3x3) + BN + PReLU
      + MaxPool3d(1x3x3, stride 1x2x2, pad 0x1x1; -inf padding)-->
    --per-frame ResNet-18 basic trunk with PReLU (models/resnet.resnet_stages)-->
    [B, T, 512] --LN + linear (or fairseq's fuse head)--> [B, T, d]
    --the shared SSL transformer (models/hubert.ssl_encoder_apply)--> [B, T, d]

``avhubert_layer`` picks the output: 0 the front end, k > 0 the first k
blocks, -1 all of them. The positional conv masks padded frames only when
``frame_lengths`` is given, as in JAX. The blocks' attention goes through
``ops/attention.py::attention``: at 256 frames or more (after the SSL
stack's alignment to 16 rows) that is the flash kernel at head width 64.

The original weights are fairseq ``.pt`` checkpoints:
:func:`load_fairseq_checkpoint` reads one without fairseq (every class its
pickle names that cannot be imported becomes a stub) and
:func:`convert_fairseq_avhubert` maps its video branch and transformer.
"""

from __future__ import annotations

import importlib
import pickle
from typing import Any

import torch
import torch.nn.functional as F

from avsr_tpu_torch.core.config import AVHubertConfig, ResNetConfig
from avsr_tpu_torch.models.hubert import ssl_encoder_apply, ssl_encoder_init, weight_norm
from avsr_tpu_torch.models.layers import Params, dense, dense_init, layer_norm, norm_init
from avsr_tpu_torch.models.resnet import (
    bn_fold,
    bn_init,
    init_resnet_stages,
    prelu,
    resnet_stages,
)


def _trunk_cfg(cfg: AVHubertConfig) -> ResNetConfig:
    """The per-frame trunk's geometry: ResNet-18-shaped basic blocks."""
    return ResNetConfig(embedding_size=cfg.frontend_channels,
                        hidden_sizes=cfg.trunk_widths, depths=cfg.trunk_depths,
                        layer_type="basic", downsample_in_first_stage=False)


def init_avhubert(gen: torch.Generator, cfg: AVHubertConfig,
                  dtype: torch.dtype = torch.float32) -> Params:
    c = cfg.frontend_channels
    params: Params = {
        "stem": {
            "conv": {"w": torch.empty((c, 1, 5, 7, 7), dtype=dtype, device=gen.device)
                     .normal_(0.0, (5 * 7 * 7) ** -0.5, generator=gen)},
            "bn": bn_init(gen, c, dtype),
            "prelu": torch.full((c,), 0.25, dtype=dtype, device=gen.device),
        },
        "trunk": init_resnet_stages(gen, _trunk_cfg(cfg), dtype),
        "proj_ln": norm_init(gen, cfg.trunk_widths[-1], dtype=dtype),
        "proj": dense_init(gen, cfg.trunk_widths[-1], cfg.d_model, dtype=dtype),
    }
    params.update(ssl_encoder_init(
        gen, cfg.d_model, n_layers=cfg.n_layers, ffn_mult=cfg.ffn_mult,
        pos_conv_kernel=cfg.pos_conv_kernel, pos_conv_groups=cfg.pos_conv_groups,
        dtype=dtype))
    return params


def _stem(p: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, 1, T, S, S] -> [B, C, T, S/4, S/4]: conv3d, BN, PReLU, max pool."""
    y = F.conv3d(x, p["conv"]["w"].to(x.dtype), stride=(1, 2, 2), padding=(2, 3, 3))
    y = prelu(p["prelu"], bn_fold(p["bn"], y))
    return F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))   # -inf padding


def _front_end(params: Params, frames: torch.Tensor, cfg: AVHubertConfig,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """frames [B, T, 3, S, S] -> [B, T, d]: stem, trunk, projection."""
    B, T = frames.shape[:2]
    x = frames.to(compute_dtype).mean(dim=2, keepdim=True)   # gray [B, T, 1, S, S]
    x = _stem(params["stem"], x.transpose(1, 2))             # [B, C, T, s, s]
    C, s1, s2 = x.shape[1], x.shape[3], x.shape[4]
    x = x.transpose(1, 2).reshape(B * T, C, s1, s2)
    x = resnet_stages(params["trunk"], x, _trunk_cfg(cfg))
    x = x.mean(dim=(2, 3)).reshape(B, T, -1)                 # [B, T, 512]
    if "fuse_ln" in params:            # a converted fairseq checkpoint
        return _fairseq_fuse_head(params, dense(params["proj"], x))
    return dense(params["proj"], layer_norm(params["proj_ln"], x))


def avhubert_apply(params: Params, frames: torch.Tensor, cfg: AVHubertConfig, *,
                   frame_lengths: torch.Tensor | None = None,
                   compute_dtype: torch.dtype = torch.float32,
                   use_kernel: str = "auto", remat: bool = False, sp=None) -> torch.Tensor:
    """frames [B, T, 3, S, S] -> per-frame features [B, T, d]; under the sp
    group ``sp`` the blocks run on chunks of the frames
    (``hubert.ssl_encoder_apply``)."""
    B, T = frames.shape[:2]
    x = _front_end(params, frames, cfg, compute_dtype)
    if cfg.avhubert_layer == 0:
        return x
    lengths = (frame_lengths.to(device=x.device, dtype=torch.int32)
               if frame_lengths is not None
               else torch.full((B,), T, dtype=torch.int32, device=x.device))
    sub = params
    if cfg.avhubert_layer > 0:         # a 1-based layer tap
        sub = {**params, "blocks": params["blocks"][:cfg.avhubert_layer]}
    return ssl_encoder_apply(
        sub, x, lengths, n_heads=cfg.n_heads, do_stable_layer_norm=cfg.do_stable_layer_norm,
        pos_conv_kernel=cfg.pos_conv_kernel, pos_conv_groups=cfg.pos_conv_groups,
        mask_before_pos_conv=frame_lengths is not None, use_kernel=use_kernel, remat=remat,
        sp=sp)


def _fairseq_fuse_head(params: Params, v: torch.Tensor) -> torch.Tensor:
    """fairseq AVHubertModel's video-only modality fusion.

    At video-only inference AV-HuBERT feeds zero audio features, fuses,
    layer-norms the fused vector and (concat fuse only) projects it with
    ``post_extract_proj``. Add fuse (``fuse_ln`` of width d, no
    ``post_proj``) is a plain LN of the video features. Concat fuse
    layer-norms [audio = 0; video] of width 2d, computed here without the
    zero half:

        mu  = sum(v) / (2d)
        var = (sum((v - mu)^2) + d * mu^2) / (2d)
        y   = LN_a(0) @ Wa + LN_v(v) @ Wv + b     (W = [Wa; Wv] row blocks)
    """
    if "post_proj" not in params:
        return layer_norm(params["fuse_ln"], v)
    d = v.shape[-1]
    g, b = params["fuse_ln"]["scale"].float(), params["fuse_ln"]["b"].float()
    vf = v.float()
    mu = vf.sum(dim=-1, keepdim=True) / (2 * d)
    var = ((vf - mu).square().sum(dim=-1, keepdim=True) + d * mu.square()) / (2 * d)
    inv = torch.rsqrt(var + 1e-5)
    # fairseq concatenates [audio, video]: audio is W's rows [:d]
    ln_v = (vf - mu) * inv * g[d:] + b[d:]
    ln_a = (-mu) * inv * g[:d] + b[:d]
    w = params["post_proj"]["w"].float()                     # [2d, d_out]
    y = ln_a @ w[:d] + ln_v @ w[d:] + params["post_proj"]["b"].float()
    return y.to(v.dtype)


# ---------------------------------------------------------------------------
# Fairseq weight conversion
# ---------------------------------------------------------------------------

class _Stub:
    """Stands in for a class a fairseq pickle names that cannot be imported
    (an OmegaConf config, fairseq's own classes)."""

    def __init__(self, *args, **kwargs) -> None:
        pass

    def __setstate__(self, state) -> None:
        self.__dict__["_state"] = state


class _PermissiveUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        try:
            return getattr(importlib.import_module(module), name)
        except Exception:  # noqa: BLE001 — any class that does not import is stubbed
            return type(f"{module}.{name}", (_Stub,), {})


class _PermissivePickle:
    """The ``pickle_module`` that ``torch.load`` unpickles through."""

    Unpickler = _PermissiveUnpickler
    load = staticmethod(pickle.load)
    loads = staticmethod(pickle.loads)
    dumps = staticmethod(pickle.dumps)
    __name__ = "avsr_tpu_torch_permissive_pickle"


def load_fairseq_checkpoint(path: str) -> dict:
    """A fairseq checkpoint's model state dict, read without fairseq.

    A fairseq ``.pt`` pickles its config (an OmegaConf object) beside the
    tensors; every class it names that does not import here becomes a stub,
    so the tensors load with torch alone. ``weights_only=False`` is passed
    explicitly: the file holds objects besides tensors, and torch's default
    refuses them. Read only checkpoints you trust, as with any pickle."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PermissivePickle)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a fairseq checkpoint (no 'model' state dict)")
    return ckpt


def convert_fairseq_avhubert(state_dict: dict[str, Any], cfg: AVHubertConfig) -> Params:
    """A fairseq ``AVHubertModel`` state dict (the video branch and the
    shared transformer) -> the port's tree, every leaf f32.

    Keys (facebookresearch/av_hubert):
      feature_extractor_video.resnet.frontend3D.{0,1,2}.*   the 3-D stem
      feature_extractor_video.resnet.trunk.layer{1..4}.*    ResNet-18, PReLU
      feature_extractor_video.proj.*                        512 -> d
      layer_norm.*          the post-fuse LN (width 2d concat, d add)
      post_extract_proj.*   2d -> d (concat fuse only)
      encoder.pos_conv.0.*  the weight-normed grouped conv (norm over dims 0, 1)
      encoder.layers.N.*    self_attn.{q,k,v,out}_proj, fc1/fc2, the LNs
      encoder.layer_norm.*  the final (pre-LN) or first (post-LN) LN
    The audio branch and the pretraining heads are not read."""
    def arr(name: str) -> torch.Tensor:
        if name not in state_dict:
            raise KeyError(f"missing fairseq weight {name!r}")
        return state_dict[name].detach().float().clone()

    def lin(name: str) -> Params:
        return {"w": arr(name + ".weight").T.contiguous(), "b": arr(name + ".bias")}

    def ln(name: str) -> Params:
        return {"scale": arr(name + ".weight"), "b": arr(name + ".bias")}

    def bn(name: str) -> Params:
        return {"scale": arr(name + ".weight"), "b": arr(name + ".bias"),
                "mean": arr(name + ".running_mean"), "var": arr(name + ".running_var")}

    res = "feature_extractor_video.resnet."
    trunk = []
    for si, depth in enumerate(cfg.trunk_depths):
        layers = []
        for li in range(depth):
            pre = f"{res}trunk.layer{si + 1}.{li}."
            p: Params = {
                "convs": [{"conv": {"w": arr(pre + "conv1.weight")}, "bn": bn(pre + "bn1")},
                          {"conv": {"w": arr(pre + "conv2.weight")}, "bn": bn(pre + "bn2")}],
                "prelus": [arr(pre + "relu1.weight"), arr(pre + "relu2.weight")],
            }
            if pre + "downsample.0.weight" in state_dict:
                p["shortcut"] = {"conv": {"w": arr(pre + "downsample.0.weight")},
                                 "bn": bn(pre + "downsample.1")}
            layers.append(p)
        trunk.append(layers)

    d = cfg.d_model
    params: Params = {
        "stem": {"conv": {"w": arr(res + "frontend3D.0.weight")},
                 "bn": bn(res + "frontend3D.1"),
                 "prelu": arr(res + "frontend3D.2.weight")},
        "trunk": trunk,
        "proj": lin("feature_extractor_video.proj"),
        "fuse_ln": ln("layer_norm"),
    }
    # the fuse mode from the post-fuse LN's width: 2d concat, d add
    fuse_width = state_dict["layer_norm.weight"].shape[0]
    if fuse_width == 2 * d:
        params["post_proj"] = lin("post_extract_proj")
    elif fuse_width != d:
        raise ValueError(f"layer_norm width {fuse_width} matches neither concat (2d="
                         f"{2 * d}) nor add (d={d}) fuse for d_model={d}")
    params["pos_conv"] = {"w": weight_norm(arr("encoder.pos_conv.0.weight_g"),
                                           arr("encoder.pos_conv.0.weight_v")),
                          "b": arr("encoder.pos_conv.0.bias")}
    params["ln"] = ln("encoder.layer_norm")
    params["blocks"] = [{
        "attn": {"q": lin(f"encoder.layers.{i}.self_attn.q_proj"),
                 "k": lin(f"encoder.layers.{i}.self_attn.k_proj"),
                 "v": lin(f"encoder.layers.{i}.self_attn.v_proj"),
                 "o": lin(f"encoder.layers.{i}.self_attn.out_proj")},
        "ln1": ln(f"encoder.layers.{i}.self_attn_layer_norm"),
        "fc1": lin(f"encoder.layers.{i}.fc1"),
        "fc2": lin(f"encoder.layers.{i}.fc2"),
        "ln2": ln(f"encoder.layers.{i}.final_layer_norm"),
    } for i in range(cfg.n_layers)]
    return params
