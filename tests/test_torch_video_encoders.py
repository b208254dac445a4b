"""The port's ResNet, EfficientNet and AV-HuBERT video encoders, their
image statistics and their converters, against the JAX package (f32, CPU;
JAX at ``jax_default_matmul_precision=highest``, as the suite's conftest
sets it).

The same numpy weights (JAX's init with random BatchNorm statistics,
affines, PReLU slopes and biases, so that no fold is the identity) and the
same numpy frames go to both packages. Tolerances: encoder outputs
``ENC`` (1e-5 absolute plus 1e-4 relative); normalized frames 1e-6
absolute; converted trees leaf for leaf exactly, except the AV-HuBERT
positional conv, which both packages compute as g * v / ||v|| in f32
(rtol 1e-6, atol 1e-7).
"""

import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core import config as jcfg
from avsr_tpu.data import loader as jloader
from avsr_tpu.models import avhubert as javh
from avsr_tpu.models import efficientnet as jeff
from avsr_tpu.models import resnet as jres
from avsr_tpu.ops import image as jimage
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.data import loader as tloader
from avsr_tpu_torch.models import avhubert as tavh
from avsr_tpu_torch.models import efficientnet as teff
from avsr_tpu_torch.models import resnet as tres
from avsr_tpu_torch.ops import image as timage
from avsr_tpu_torch.train.state import path_leaves

from test_torch_models import np_tree, to_port_cfg

torch.set_num_threads(1)

ENC = dict(atol=1e-5, rtol=1e-4)

# JAX's own test geometries (tests/test_models_*.py)
RESNET = {
    "bottleneck": dict(image_size=32, embedding_size=16, hidden_sizes=(32, 64),
                       depths=(1, 2), layer_type="bottleneck"),
    "basic": dict(image_size=32, embedding_size=16, hidden_sizes=(32, 64),
                  depths=(2, 1), layer_type="basic"),
    "basic_downsample_first": dict(image_size=32, embedding_size=16, hidden_sizes=(16, 32),
                                   depths=(2, 1), layer_type="basic",
                                   downsample_in_first_stage=True),
}
_EFF = dict(image_size=32, in_channels=(32, 16), out_channels=(16, 24), kernel_sizes=(3, 5),
            strides=(1, 2), num_block_repeats=(1, 2), expand_ratios=(1, 6))
EFFNET = {
    "tiny": dict(_EFF, hidden_dim=1280),
    "scaled": dict(_EFF, width_coefficient=0.5, depth_coefficient=1.5, hidden_dim=640),
    # block 1 (the stride-2 depthwise) pads symmetrically
    "depthwise_padding": dict(_EFF, hidden_dim=1280, depthwise_padding=(1,)),
}
AVH = dict(image_size=32, frontend_channels=8, trunk_widths=(8, 16), trunk_depths=(1, 1),
           d_model=32, n_heads=2, n_layers=2, ffn_mult=2, pos_conv_kernel=8,
           pos_conv_groups=2)


def jitter_stats(tree, seed: int):
    """Random BatchNorm statistics and affines, PReLU slopes, norm affines
    and biases in a numpy tree, in place (init leaves them 0, 1 or 0.25)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            for k, v in node.items():
                if isinstance(v, np.ndarray) and k != "w":
                    if k == "var":
                        node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                    elif k in ("scale", "prelu"):
                        node[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                    else:                               # mean, b
                        node[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                elif k == "prelus":
                    node[k] = [(0.25 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
                               for a in v]
                else:
                    walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, key)

    walk(tree)
    return tree


def _frames(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, tol=ENC):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(RESNET))
def test_resnet_matches_jax(kind):
    jc, tc = jcfg.ResNetConfig(**RESNET[kind]), tcfg.ResNetConfig(**RESNET[kind])
    p = jitter_stats(np_tree(jres.init_resnet(jax.random.key(0), jc)), 1)
    frames = _frames((2, 3, 3, 32, 32))
    out_j = jres.resnet_apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(frames), jc)
    out_t = tres.resnet_apply(from_numpy_tree(p, "cpu"), torch.from_numpy(frames), tc)
    assert tuple(out_t.shape) == (2, 3, tc.hidden_sizes[-1]) == out_j.shape
    _close(out_t, out_j)
    # one frame [N, 3, S, S] -> [N, d], and remat under grad gives the same
    single = tres.resnet_apply(from_numpy_tree(p, "cpu"), torch.from_numpy(frames[:, 1]), tc)
    _close(single, out_j[:, 1])
    p_t = from_numpy_tree(p, "cpu")
    p_t["stem"]["conv"]["w"].requires_grad_(True)
    remat = tres.resnet_apply(p_t, torch.from_numpy(frames), tc, remat=True)
    torch.testing.assert_close(remat.detach(), out_t, rtol=0, atol=0)


def test_resnet_init_tree_matches_jax():
    for kind in RESNET:
        jc, tc = jcfg.ResNetConfig(**RESNET[kind]), tcfg.ResNetConfig(**RESNET[kind])
        want = path_leaves(from_numpy_tree(np_tree(jres.init_resnet(jax.random.key(0), jc)),
                                           "cpu"))
        got = path_leaves(tres.init_resnet(torch.Generator().manual_seed(0), tc))
        assert got.keys() == want.keys(), kind
        assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
                   for k in want)


@pytest.mark.parametrize("size", [32, 33], ids=["even", "odd"])
@pytest.mark.parametrize("kind", sorted(EFFNET))
def test_efficientnet_matches_jax(kind, size):
    jc, tc = jcfg.EfficientNetConfig(**EFFNET[kind]), tcfg.EfficientNetConfig(**EFFNET[kind])
    assert teff.block_plan(tc) == [tuple(b) for b in jeff.block_plan(jc)]
    p = jitter_stats(np_tree(jeff.init_efficientnet(jax.random.key(1), jc)), 2)
    frames = _frames((2, 2, 3, size, size), seed=size)
    out_j = jeff.efficientnet_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                    jnp.asarray(frames), jc)
    out_t = teff.efficientnet_apply(from_numpy_tree(p, "cpu"), torch.from_numpy(frames), tc)
    assert tuple(out_t.shape) == (2, 2, tc.hidden_dim) == out_j.shape
    _close(out_t, out_j)
    got = path_leaves(teff.init_efficientnet(torch.Generator().manual_seed(0), tc))
    want = path_leaves(from_numpy_tree(p, "cpu"))
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)


def test_efficientnet_b0_plan_and_hidden_dim_check():
    """b0's published block table: 16 blocks, the top at 1280; a top width
    that is not round_filters(1280) is refused."""
    b0 = tcfg.EfficientNetConfig()
    assert len(teff.block_plan(b0)) == 16 == len(jeff.block_plan(jcfg.EfficientNetConfig()))
    assert teff.round_filters(b0, 1280) == 1280
    assert teff.round_filters(tcfg.EfficientNetConfig(width_coefficient=1.1), 1280) == 1408
    bad = tcfg.EfficientNetConfig(**dict(EFFNET["tiny"], hidden_dim=640))
    with pytest.raises(ValueError, match="round_filters"):
        teff.init_efficientnet(torch.Generator(), bad)


def _avh(**kw):
    return jcfg.AVHubertConfig(**AVH, **kw), tcfg.AVHubertConfig(**AVH, **kw)


@pytest.fixture(scope="module")
def avh_params():
    jc, _ = _avh()
    return jitter_stats(np_tree(javh.init_avhubert(jax.random.key(2), jc)), 3)


@pytest.mark.parametrize("stable", [False, True], ids=["post_ln", "stable_ln"])
@pytest.mark.parametrize("tap", [0, 1, -1])
def test_avhubert_matches_jax(avh_params, tap, stable):
    """Taps 0 (the front end), 1 and -1, with ragged ``frame_lengths`` (5
    frames; the positional conv masks the padding) and without."""
    jc, tc = _avh(avhubert_layer=tap, do_stable_layer_norm=stable)
    frames = _frames((2, 5, 3, 32, 32), seed=7)
    lens = np.array([5, 3], np.int32)
    p_j = jax.tree_util.tree_map(jnp.asarray, avh_params)
    p_t = from_numpy_tree(avh_params, "cpu")
    for kw_j, kw_t in (({"frame_lengths": jnp.asarray(lens)},
                        {"frame_lengths": torch.from_numpy(lens)}), ({}, {})):
        out_j = javh.avhubert_apply(p_j, jnp.asarray(frames), jc, use_pallas="never", **kw_j)
        out_t = tavh.avhubert_apply(p_t, torch.from_numpy(frames), tc, **kw_t)
        assert tuple(out_t.shape) == (2, 5, 32) == out_j.shape
        _close(out_t, out_j)


def test_avhubert_time_resolution_and_gray_collapse(avh_params):
    """One feature per frame; RGB collapses to gray by the channel mean, so
    a frame and its gray copy give the same features."""
    _, tc = _avh()
    p_t = from_numpy_tree(avh_params, "cpu")
    frames = torch.from_numpy(_frames((1, 7, 3, 32, 32), seed=8))
    gray = frames.mean(dim=2, keepdim=True).expand(-1, -1, 3, -1, -1)
    out = tavh.avhubert_apply(p_t, frames, tc)
    assert out.shape == (1, 7, 32)
    torch.testing.assert_close(tavh.avhubert_apply(p_t, gray, tc), out, **ENC)


# ---------------------------------------------------------------------------
# AV-HuBERT's fairseq checkpoints
# ---------------------------------------------------------------------------

def _fairseq_oracle(fuse: str, stable: bool):
    """tests/test_avhubert_fairseq.py's torch module graph in fairseq's
    layout, random weights, and its config in both packages."""
    from test_avhubert_fairseq import _AVHubertOracle, _cfg, _randomize

    oracle = _AVHubertOracle(fuse, stable).eval()
    _randomize(oracle)
    jc = _cfg(stable)
    return oracle, jc, to_port_cfg(jc, tcfg.AVHubertConfig)


@pytest.mark.parametrize("fuse,stable", [("concat", False), ("add", True)])
def test_fairseq_conversion_and_fuse_heads_match_jax(fuse, stable):
    """Both fuse heads: the converted trees equal JAX's leaf for leaf, and
    the port's encoder on them equals JAX's and the fairseq-layout oracle."""
    from test_avhubert_fairseq import SIZE, T

    oracle, jc, tc = _fairseq_oracle(fuse, stable)
    sd = {k: v.clone() for k, v in oracle.state_dict().items()}
    p_j = np_tree(javh.convert_fairseq_avhubert(sd, jc))
    p_t = tavh.convert_fairseq_avhubert(sd, tc)
    assert ("post_proj" in p_t) == (fuse == "concat") and "fuse_ln" in p_t
    got, want = path_leaves(p_t), path_leaves(from_numpy_tree(p_j, "cpu"))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        if k == "pos_conv/w":
            torch.testing.assert_close(got[k], w, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(got[k], w), k
    gray = torch.randn(1, 1, T, SIZE, SIZE, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = oracle(gray)
    rgb = gray[:, 0][:, :, None].repeat(1, 1, 3, 1, 1)
    out_t = tavh.avhubert_apply(p_t, rgb, tc)
    out_j = javh.avhubert_apply(jax.tree_util.tree_map(jnp.asarray, p_j),
                                jnp.asarray(rgb.numpy()), jc, use_pallas="never")
    _close(out_t, out_j)
    torch.testing.assert_close(out_t, ref, atol=2e-4, rtol=0)


def test_fairseq_reader_stubs_an_unimportable_config_class(tmp_path):
    """A fairseq ``.pt`` pickles its config object beside the tensors; the
    port's reader loads the tensors without that class, as JAX's does."""
    mod = types.ModuleType("fake_fairseq_cfg_pkg")
    exec("class FakeDictConfig:\n    def __init__(self):\n        self.x = {'y': 1}\n",
         mod.__dict__)
    sys.modules["fake_fairseq_cfg_pkg"] = mod
    try:
        path = tmp_path / "avhubert.pt"
        torch.save({"model": {"w": torch.arange(4.0)}, "cfg": mod.FakeDictConfig(),
                    "task_state": {}}, path)
    finally:
        del sys.modules["fake_fairseq_cfg_pkg"]
    with pytest.raises(Exception):
        torch.load(path, map_location="cpu", weights_only=False)
    sd_t = tavh.load_fairseq_checkpoint(str(path))
    sd_j = javh.load_fairseq_checkpoint(str(path))
    assert list(sd_t) == list(sd_j) == ["w"] and torch.equal(sd_t["w"], sd_j["w"])
    torch.save([torch.zeros(1)], tmp_path / "bare.pt")
    with pytest.raises(ValueError, match="not a fairseq checkpoint"):
        tavh.load_fairseq_checkpoint(str(tmp_path / "bare.pt"))


# ---------------------------------------------------------------------------
# Image statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stats", ["clip", "imagenet", "inception", "avhubert"])
def test_normalize_frames_under_each_statistics_match_jax(stats):
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (2, 3, 8, 8, 3)).astype(np.uint8)
    y, uv = timage.rgb_to_yuv420_np(frames)
    out = timage.normalize_frames(torch.from_numpy(frames), stats=stats)
    assert out.shape == (2, 3, 3, 8, 8)
    _close(out, jimage.normalize_frames(jnp.asarray(frames), stats=stats), dict(atol=1e-6,
                                                                                rtol=0))
    out = timage.normalize_yuv420_frames(torch.from_numpy(y), torch.from_numpy(uv),
                                         stats=stats)
    _close(out, jimage.normalize_yuv420_frames(jnp.asarray(y), jnp.asarray(uv), stats=stats),
           dict(atol=1e-6, rtol=0))
    mean, std = timage.STATS[stats]
    assert np.allclose(mean, jimage._STATS[stats][0]) and np.allclose(std, jimage._STATS[stats][1])


@pytest.mark.parametrize("encoder", ["clip", "resnet", "efficientnet", "avhubert"])
def test_image_stats_for_and_featurize_match_jax(encoder):
    """``image_stats_for`` names JAX's statistics per encoder, and
    ``featurize`` normalizes a batch with them (raw and compact link)."""
    from avsr_tpu_torch.data.dataset import Sample

    jm = jcfg.ModelConfig(video_encoder=encoder)
    tm = tcfg.ModelConfig(video_encoder=encoder)
    stats = tloader.image_stats_for(tm)
    assert stats == jloader.image_stats_for(jm)
    assert tloader.image_stats_for(None) == "clip"
    rng = np.random.default_rng(9)
    samples = [Sample(f"u{i}", None, rng.integers(0, 256, (t, 8, 8, 3)).astype(np.uint8), "",
                      [1, 2]) for i, t in enumerate((3, 2))]
    for compact in (False, True):
        dc = tcfg.DataConfig(video_buckets=(4,), compact_transfer=compact)
        hb = tloader.collate(samples, dc, [256], 0)
        b_t = tloader.featurize(hb, "cpu", torch.float32, tm)
        b_j = jloader.featurize(hb, jnp.float32, image_stats=stats)
        _close(b_t.frames, b_j.frames, dict(atol=1e-6, rtol=0))
        explicit = tloader.featurize(hb, "cpu", torch.float32, None, image_stats=stats)
        assert torch.equal(explicit.frames, b_t.frames)


def test_image_size_and_video_dim_follow_the_encoder():
    for enc in ("clip", "resnet", "efficientnet", "avhubert"):
        for tap in (0, -1):
            kw = dict(video_encoder=enc, avhubert=jcfg.AVHubertConfig(avhubert_layer=tap))
            jm = jcfg.ModelConfig(**kw)
            tm = tcfg.ModelConfig(video_encoder=enc,
                                  avhubert=tcfg.AVHubertConfig(avhubert_layer=tap))
            assert (tm.image_size, tm.video_dim) == (jm.image_size, jm.video_dim)
    assert tcfg.flagship(video_encoder="avhubert").model.image_size == 88
    assert tcfg.flagship(video_encoder="resnet").model.video_dim == 2048
    assert tcfg.flagship(video_encoder="efficientnet").model.video_dim == 1280


def test_config_sections_and_validation_match_jax():
    """Field for field the JAX sections, and JAX's checks with its messages."""
    for name in ("ResNetConfig", "EfficientNetConfig", "AVHubertConfig"):
        j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t), name
    for bad, msg in (("model.video_encoder=vit", "video_encoder must be"),
                     ("model.avhubert.avhubert_layer=13", "avhubert_layer exceeds"),
                     ("model.resnet.layer_type=wide", "resnet.layer_type must be"),
                     ("model.resnet.depths=3,4", "lengths differ")):
        with pytest.raises(ValueError, match=msg) as ej:
            jcfg.load_config(None, [bad])
        with pytest.raises(ValueError, match=msg) as et:
            tcfg.load_config(None, [bad])
        assert str(ej.value) == str(et.value)
    over = ["model.video_encoder=efficientnet", "model.efficientnet.hidden_dim=1408",
            "model.resnet.hidden_sizes=64,128", "model.resnet.depths=1,1"]
    assert tcfg.load_config(None, over).model.efficientnet.hidden_dim == 1408
