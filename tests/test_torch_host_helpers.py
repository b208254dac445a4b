"""The port's host helpers against the JAX package's (CPU): the on-device
frame preprocessing, frame sampling, utterance-id aliases, the loader's
``prefetch`` and ``drop_last`` (exactly the same batches), the media
helpers, and the names the two packages' ``data`` and ``ops`` re-export.

``preprocess_frames`` is held at 1e-5 absolute (f32) to the JAX function
evaluated op by op (``jax.disable_jit``), whose f32 arithmetic it follows
(the resize's weight matrices equal JAX's bit for bit). Under ``jax.jit``
XLA:CPU fuses the sample positions ``(i + 0.5) / scale - 0.5`` into one
fused multiply-add for some shapes and not others, which moves a position
by up to one f32 ulp (~1.5e-5 of a pixel at 300 px) and an output by up to
~6e-5 after the division by the std; the jitted function is held at 2e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avsr_tpu.data as jdata
import avsr_tpu.ops as jops
import avsr_tpu_torch.data as tdata
import avsr_tpu_torch.ops as tops
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.data import media as jmedia
from avsr_tpu.data.dataset import SyntheticAVSRDataset as JDataset
from avsr_tpu.data.loader import DataLoader as JDataLoader
from avsr_tpu.data.manifest import utt_aliases as jutt_aliases
from avsr_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from avsr_tpu.ops.image import preprocess_frames as jpreprocess
from avsr_tpu.ops.image import sample_frame_indices as jsample
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.data import media
from avsr_tpu_torch.data.dataset import SyntheticAVSRDataset
from avsr_tpu_torch.data.loader import DataLoader
from avsr_tpu_torch.data.manifest import utt_aliases
from avsr_tpu_torch.data.tokenizer import ByteTokenizer
from avsr_tpu_torch.data.video_io import load_frames
from avsr_tpu_torch.ops.image import preprocess_frames, sample_frame_indices
from avsr_tpu_torch.train.state import tree_leaves

from test_torch_train import TINY_YAML

torch.set_num_threads(1)

# (lead dims, H, W, S): up- and downscale, H < W and H > W, batched or not
FRAMES = {"up_wide": ((5,), 120, 160, 224), "down_tall": ((4,), 300, 200, 96),
          "batched_wide": ((2, 3), 50, 70, 32), "batched_tall": ((2, 3), 90, 64, 48),
          "square_down": ((3,), 81, 81, 40)}


@pytest.mark.parametrize("stats", ["clip", "imagenet", "inception", "avhubert"])
@pytest.mark.parametrize("case", list(FRAMES))
def test_preprocess_frames_equals_jax(case, stats):
    lead, H, W, S = FRAMES[case]
    frames = np.random.default_rng(len(case)).integers(0, 256, (*lead, H, W, 3),
                                                       dtype=np.uint8)
    with jax.disable_jit():
        want = np.asarray(jpreprocess(jnp.asarray(frames), image_size=S, stats=stats))
    jitted = np.asarray(jpreprocess(jnp.asarray(frames), image_size=S, stats=stats))
    got = preprocess_frames(torch.from_numpy(frames), image_size=S, stats=stats)
    assert got.dtype == torch.float32 and tuple(got.shape) == (*lead, 3, S, S)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), jitted, atol=2e-4, rtol=0)
    bf16 = preprocess_frames(torch.from_numpy(frames), image_size=S, stats=stats,
                             dtype=torch.bfloat16)
    assert torch.equal(bf16, got.to(torch.bfloat16))


@pytest.mark.parametrize("n,target", [(0, 8), (5, 8), (8, 8), (9, 8), (300, 25),
                                      (1000, 97), (26, 25)])
def test_sample_frame_indices_equals_jax(n, target):
    got, want = sample_frame_indices(n, target), jsample(n, target)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("utt", ["a", "a/b/c", "spk1/vid/00042", "/lead", "trail/"])
def test_utt_aliases_equals_jax(utt):
    assert utt_aliases(utt) == jutt_aliases(utt)


@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)])
@pytest.mark.parametrize("drop_last,prefetch", [(False, 1), (True, 4), (True, 1),
                                                (False, 4)])
def test_loader_prefetch_and_drop_last_equal_jax(drop_last, prefetch, shard):
    """7 utterances in batches of 4 (3 at the end): the same batches, ids,
    label and audio lengths and ``__len__`` as the JAX loader, over two
    epochs and a resumed position."""
    over = {"data.synthetic_size": 7, "data.batch_size": 4}
    jc = jload_config(TINY_YAML, over)
    tc = tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in over.items()])
    kw = dict(seed=3, prefetch=prefetch, drop_last=drop_last, data_shard=shard)
    jl = JDataLoader(JDataset(jc.data, JByteTokenizer(), modality="audio", image_size=16),
                     jc.data, JByteTokenizer(), model_cfg=jc.model, **kw)
    tl = DataLoader(SyntheticAVSRDataset(tc.data, ByteTokenizer(), modality="audio",
                                         image_size=16),
                    tc.data, ByteTokenizer(), model_cfg=tc.model, device="cpu", **kw)
    assert len(tl) == len(jl) == (1 if drop_last else 2)

    def walk(loader):
        return [(list(hb.utt_ids), np.asarray(hb.label_lens).tolist(),
                 np.asarray(hb.audio_lens).tolist(), np.asarray(hb.audio).shape)
                for hb, _ in loader]

    for _ in range(2):
        got, want = walk(tl), walk(jl)
        assert got == want and len(got) == len(tl)
        assert len(got[0][0]) == (4 if shard is None else 2)
    for loader in (tl, jl):
        loader.set_position(2, 1)
    assert walk(tl) == walk(jl)
    assert tl.state() == jl.state()


def test_media_helpers_equal_jax(tmp_path):
    """save_results writes JAX's JSON; save_audio JAX's WAV bytes."""
    res = {"wer": 0.1, "utts": 3, "path": tmp_path}
    media.save_results(res, tmp_path / "t" / "results.json")
    jmedia.save_results(res, tmp_path / "j" / "results.json")
    got = (tmp_path / "t" / "results.json").read_text()
    assert got == (tmp_path / "j" / "results.json").read_text()
    assert json.loads(got)["utts"] == 3
    x = np.sin(np.linspace(0, 40, 3200)).astype(np.float32) * 0.5
    media.save_audio(tmp_path / "t.wav", x)
    jmedia.save_audio(tmp_path / "j.wav", x)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_media_save_video_roundtrip(tmp_path, rng):
    pytest.importorskip("cv2")
    frames = rng.integers(0, 256, (5, 32, 32, 3)).astype(np.uint8)
    media.save_video(frames, tmp_path / "v.mp4", fps=25)
    jmedia.save_video(frames, tmp_path / "j.mp4", fps=25)
    back = load_frames(tmp_path / "v.mp4", max_frames=5)
    assert back.shape == (5, 32, 32, 3)
    np.testing.assert_array_equal(back, load_frames(tmp_path / "j.mp4", max_frames=5))


def test_extract_audio_requires_ffmpeg(tmp_path):
    if media.ffmpeg_available():
        pytest.skip("ffmpeg present: the gated error path is not reachable")
    assert not jmedia.ffmpeg_available()
    with pytest.raises(RuntimeError, match="ffmpeg") as got:
        media.extract_audio_from_video(tmp_path / "x.mp4")
    with pytest.raises(RuntimeError) as want:
        jmedia.extract_audio_from_video(tmp_path / "x.mp4")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pkg", ["data", "ops"])
def test_reexported_names_match_jax(pkg):
    """Every name JAX's package re-exports, the port's re-exports, but
    ``ops.attention``: the port keeps it the module (its launch counters),
    whose ``attention`` is the function."""
    jmod, tmod = {"data": (jdata, tdata), "ops": (jops, tops)}[pkg]
    names = {n for n in vars(jmod) if not n.startswith("_")
             and callable(getattr(jmod, n)) and not isinstance(getattr(jmod, n), type(jmod))}
    assert names
    got = {n: getattr(tmod, n, None) for n in names}
    if pkg == "ops":
        import avsr_tpu_torch.ops.attention as tattention
        assert got["attention"] is tattention and hasattr(tattention, "launches")
        got["attention"] = tattention.attention
    assert sorted(n for n, f in got.items() if not callable(f)) == []


def test_small_counterparts_equal_jax():
    """audio_frontend_for and component_bytes give what the JAX package's
    do."""
    from avsr_tpu.cli.analyze_memory import component_bytes as jcomponent_bytes
    from avsr_tpu.data.loader import audio_frontend_for as jfrontend
    from avsr_tpu_torch.cli.analyze_memory import component_bytes, shape_tree
    from avsr_tpu_torch.data.loader import audio_frontend_for

    for enc in ("whisper", "hubert", "wav2vec2"):
        over = {"model.audio_encoder": enc}
        jc = jload_config(TINY_YAML, over)
        tc = tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in over.items()])
        assert audio_frontend_for(tc.model) == jfrontend(jc.model)
    assert audio_frontend_for(None) == jfrontend(None) == "mel"
    tc = tcfg.load_config(TINY_YAML)
    params = shape_tree(tc)
    jparams = {k: {"x": np.zeros(sum(t.numel() for t in tree_leaves(v)))}
               for k, v in params.items()}
    assert component_bytes(params, 2) == jcomponent_bytes(jparams, 2)
