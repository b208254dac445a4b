"""The port's data slice vs the JAX package (CPU): manifests, the HF
tokenizer, the manifest dataset and both retry walks, the threaded loader
over a demo corpus, the compact link format and the frame ops.

Every input is made from a seed with numpy (media) or by the port's
``prepare_data --demo`` (a corpus byte-equal to JAX's, see
``test_torch_prepare_data.py``). Host arrays must be equal exactly (the
same source code, the same native library); featurized f32 tensors within
the port's module tolerance (1e-4), the compact link's featurize within
1e-5, and a frame resize that takes another route than JAX's within one
step of 255.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu import native as jnative
from avsr_tpu.core.config import DataConfig as JDataConfig
from avsr_tpu.core.config import ModelConfig as JModelConfig
from avsr_tpu.data import dataset as jdataset
from avsr_tpu.data import loader as jloader
from avsr_tpu.data import manifest as jmanifest
from avsr_tpu.data import tokenizer as jtokenizer
from avsr_tpu.data.audio_io import write_wav
from avsr_tpu.ops import image as jimage
from avsr_tpu_torch import native as tnative
from avsr_tpu_torch.cli import prepare_data as tprep
from avsr_tpu_torch.core.config import DataConfig as TDataConfig
from avsr_tpu_torch.core.config import ModelConfig as TModelConfig
from avsr_tpu_torch.data import dataset as tdataset
from avsr_tpu_torch.data import loader as tloader
from avsr_tpu_torch.data import manifest as tmanifest
from avsr_tpu_torch.data import tokenizer as ttokenizer
from avsr_tpu_torch.ops import image as timage

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT = "t:"
SPECIALS = ["[UNK]", "<|begin_of_text|>", "<|end_of_text|>", "<|finetune_right_pad_id|>"]


def data_cfgs(**kw):
    base = dict(batch_size=4, max_audio_length=48000, max_video_length=16,
                max_label_length=32, audio_buckets=(100, 200, 300),
                video_buckets=(8, 16, 32, 80), num_workers=1)
    base.update(kw)
    return JDataConfig(**base), TDataConfig(**base)


def write_word_tokenizer(out_dir) -> None:
    """A WordLevel ``tokenizer.json`` over the synthetic corpus' words and
    Llama-3's special tokens (ids < 30)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = sorted(set(tdataset._WORDS))
    vocab = {w: i for i, w in enumerate(SPECIALS + words)}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    out_dir.mkdir(parents=True, exist_ok=True)
    tk.save(str(out_dir / "tokenizer.json"))


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    out = tmp_path_factory.mktemp("demo")
    assert tprep.main(["--demo", "10", "--out", str(out), "--seed", "0",
                       "--splits", "0.8,0.1,0.1"]) == 0
    return out


@pytest.fixture(scope="module")
def libs():
    if not (jnative.available() and tnative.available()):
        pytest.skip("native library unavailable (no g++)")


def host_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def batches_close(bt, bj, tol=TOL):
    for name in ("mel", "mel_lens", "frames", "frame_lens", "prompt_tokens", "labels",
                 "label_lens"):
        t, j = getattr(bt, name), getattr(bj, name)
        assert (t is None) == (j is None), name
        if t is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **tol)


# ---------------------------------------------------------------------------
# manifests and tokenizers
# ---------------------------------------------------------------------------

def test_manifest_roundtrip_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    entries = [tmanifest.ManifestEntry(f"spk{i}/utt{i}", f"v/u{i}.npy", f"a/u{i}.wav",
                                       int(rng.integers(10, 100)),
                                       int(rng.integers(1000, 99999))) for i in range(5)]
    tmanifest.write_manifest(tmp_path / "t.tsv", "/data/root", entries)
    jmanifest.write_manifest(tmp_path / "j.tsv", "/data/root",
                             [jmanifest.ManifestEntry(**dataclasses.asdict(e))
                              for e in entries])
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    # a malformed row is skipped by both readers
    with open(tmp_path / "t.tsv", "a") as fh:
        fh.write("short\trow\n\n")
    root_t, got_t = tmanifest.load_manifest(tmp_path / "t.tsv")
    root_j, got_j = jmanifest.load_manifest(tmp_path / "t.tsv")
    assert str(root_t) == str(root_j) == "/data/root"
    assert got_t == entries
    assert [dataclasses.asdict(e) for e in got_j] == [dataclasses.asdict(e)
                                                      for e in got_t]
    (tmp_path / "x.wrd").write_text(" a b \nc\n")
    assert tmanifest.load_labels(tmp_path / "x.wrd") == jmanifest.load_labels(
        tmp_path / "x.wrd") == ["a b", "c"]


def test_hf_tokenizer_equals_jax(tmp_path):
    write_word_tokenizer(tmp_path)
    t = ttokenizer.load_tokenizer(tmp_path)
    j = jtokenizer.load_tokenizer(tmp_path)
    assert isinstance(t, ttokenizer.HFTokenizer)
    assert (t.bos_id, t.eos_id, t.pad_id, t.vocab_size) == (j.bos_id, j.eos_id,
                                                           j.pad_id, j.vocab_size)
    assert (t.bos_id, t.eos_id, t.pad_id) == (1, 2, 3)
    rng = np.random.default_rng(0)
    for _ in range(5):
        text = " ".join(rng.choice(tdataset._WORDS, int(rng.integers(2, 8))))
        for kw in ({}, {"add_bos": True}, {"add_eos": True}):
            assert t.encode(text, **kw) == j.encode(text, **kw)
        ids = t.encode(text, add_bos=True, add_eos=True) + [t.pad_id]
        assert t.decode(ids) == j.decode(ids) == text
    assert t.encode("Transcribe unknown words") == j.encode("Transcribe unknown words")
    assert isinstance(ttokenizer.load_tokenizer(""), ttokenizer.ByteTokenizer)


# ---------------------------------------------------------------------------
# the manifest dataset
# ---------------------------------------------------------------------------

def datasets(path, split="train", modality="both", defer=False, **kw):
    jc, tc = data_cfgs(path=str(path), **kw)
    tok = jtokenizer.ByteTokenizer()
    return (tdataset.ManifestAVSRDataset(tc, tok, split=split, modality=modality,
                                         image_size=16, defer_audio=defer),
            jdataset.ManifestAVSRDataset(jc, tok, split=split, modality=modality,
                                         image_size=16, defer_audio=defer))


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_manifest_dataset_equals_jax(demo, libs, split):
    """Samples of every split: audio bit-equal, frames equal (the same
    resize route on both sides), tokens equal."""
    ts, js = datasets(demo, split=split)
    assert len(ts) == len(js) > 0
    for i in range(len(ts)):
        a, b = ts[i], js[i]
        assert (a.utt_id, a.text, a.tokens) == (b.utt_id, b.text, b.tokens)
        np.testing.assert_array_equal(a.audio, b.audio)
        np.testing.assert_array_equal(a.frames, b.frames)
        assert a.frames.shape == (min(ts.entries[i].num_frames, 16), 16, 16, 3)
    td, jd = datasets(demo, split=split, defer=True)
    assert td[0].audio is None and td[0].audio_path == jd[0].audio_path
    assert td.defer_audio and tdataset.ManifestAVSRDataset(
        td.cfg, td.tokenizer, split=split).defer_audio


def test_label_truncation_keeps_eos(demo):
    ts, js = datasets(demo, max_label_length=5)
    for i in range(len(ts)):
        assert ts[i].tokens == js[i].tokens
        assert len(ts[i].tokens) <= 5 and ts[i].tokens[-1] == 257


def test_dataset_errors_equal_jax(tmp_path):
    tok = jtokenizer.ByteTokenizer()
    cfgs = data_cfgs(path=str(tmp_path))
    for pkg, cfg in zip((jdataset, tdataset), cfgs):
        with pytest.raises(FileNotFoundError, match="train.tsv not found"):
            pkg.ManifestAVSRDataset(cfg, tok)
    (tmp_path / "data").mkdir()     # found under root/data
    tmanifest.write_manifest(tmp_path / "data" / "train.tsv", tmp_path, [
        tmanifest.ManifestEntry("u", "none", "u.wav", 0, 10)])
    (tmp_path / "data" / "train.wrd").write_text("a\nb\n")
    for pkg, cfg in zip((jdataset, tdataset), cfgs):
        with pytest.raises(ValueError, match="1 manifest rows vs 2 label lines"):
            pkg.ManifestAVSRDataset(cfg, tok)


def _route(monkeypatch, route):
    """Make both packages' resize dispatch take ``route`` where they can:
    cv2 on a host of fewer than 4 cores; torch (the port only) with neither
    cv2 nor the native library."""
    if route == "cv2":
        monkeypatch.setattr(os, "cpu_count", lambda: 2)
    elif route == "torch":
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setattr(tnative, "resize_crop_frames", lambda *a, **k: None)


@pytest.mark.parametrize("route", ["native", "cv2", "torch"])
def test_resize_crop_frames_routes(monkeypatch, libs, route):
    rng = np.random.default_rng(1)
    cases = [rng.integers(0, 256, (3, 37, 53, 3)).astype(np.uint8),
             rng.integers(0, 256, (2, 96, 96, 3)).astype(np.uint8),
             rng.integers(0, 256, (2, 60, 40, 3)).astype(np.uint8)]
    want = [jdataset.resize_crop_frames(f, 32) for f in cases]   # JAX: native
    _route(monkeypatch, route)
    if route == "cv2":
        want = [jdataset.resize_crop_frames(f, 32) for f in cases]
    for f, w in zip(cases, want):
        got = tdataset.resize_crop_frames(f, 32)
        assert got.shape == w.shape and got.dtype == np.uint8
        if route == "torch":
            assert np.abs(got.astype(int) - w.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(got, w)
    same = cases[1][:, :32, :32]
    assert tdataset.resize_crop_frames(same, 32) is same


def test_dataset_retry_walk_equals_jax(tmp_path):
    """A corrupt WAV (decoded in the dataset) and a missing one (deferred)
    both walk forward to the same utterance as JAX's dataset."""
    good = np.sin(np.linspace(0, 50, 16000)).astype(np.float32)
    write_wav(tmp_path / "good.wav", good)
    (tmp_path / "bad.wav").write_bytes(b"not a wav at all")
    entries = [tmanifest.ManifestEntry("bad", "none.npy", "bad.wav", 0, 16000),
               tmanifest.ManifestEntry("missing", "none.npy", "gone.wav", 0, 16000),
               tmanifest.ManifestEntry("good", "none.npy", "good.wav", 0, 16000)]
    tmanifest.write_manifest(tmp_path / "train.tsv", tmp_path, entries)
    (tmp_path / "train.wrd").write_text("bad text\nmissing text\ngood text\n")
    for defer in (False, True):
        ts, js = datasets(tmp_path, modality="audio", defer=defer)
        for i in range(3):
            assert ts[i].utt_id == js[i].utt_id
        assert ts[1].utt_id == "good"
    ts, js = datasets(tmp_path, modality="audio", defer=False)
    np.testing.assert_array_equal(ts[0].audio, js[0].audio)
    assert ts[0].utt_id == "good"
    # video faults walk too: no entry's video exists, so every walk fails
    ts, js = datasets(tmp_path, modality="both")
    for ds in (ts, js):
        with pytest.raises(IOError, match="after 10 retries"):
            ds[0]


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def loaders(ds_t, ds_j, jc, tc, **kw):
    tok = jtokenizer.ByteTokenizer()
    lt = tloader.DataLoader(ds_t, tc, tok, model_cfg=TModelConfig(prompt=PROMPT),
                            device="cpu", **kw)
    lj = jloader.DataLoader(ds_j, jc, tok, model_cfg=JModelConfig(prompt=PROMPT), **kw)
    return lt, lj


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("modality", ["both", "audio"])
def test_loader_over_demo_equals_jax(demo, libs, workers, modality):
    """Two epochs over a make_demo manifest (deferred audio: the native
    batch decode), shuffled: host batches equal, featurized batches close."""
    jc, tc = data_cfgs(path=str(demo), num_workers=workers, batch_size=3)
    tok = jtokenizer.ByteTokenizer()
    ds_t = tdataset.ManifestAVSRDataset(tc, tok, modality=modality, image_size=16)
    ds_j = jdataset.ManifestAVSRDataset(jc, tok, modality=modality, image_size=16)
    assert len(ds_t) == 8 and ds_t.defer_audio and ds_t[0].audio is None
    lt, lj = loaders(ds_t, ds_j, jc, tc, shuffle=True, seed=3)
    assert len(lt) == len(lj) == 3
    for _ in range(2):
        got, want = list(lt), list(lj)
        assert len(got) == len(want) == 3
        for (ht, bt), (hj, bj) in zip(got, want):
            host_equal(ht, hj)
            batches_close(bt, bj)
        # the last batch is wrap-padded: its repeated row weighs nothing
        assert list(got[-1][0].label_lens > 0) == [True, True, False]
    assert (lt._pool is not None) == (workers > 1)
    lt.close()
    assert lt._pool is None
    lj.close()


def test_loader_resume_equals_jax(demo, libs):
    jc, tc = data_cfgs(path=str(demo), batch_size=3)
    ts, js = datasets(demo, modality="audio", batch_size=3)
    lt, lj = loaders(ts, js, jc, tc, shuffle=True)
    assert [h.utt_ids for h, _ in lt] == [h.utt_ids for h, _ in lj]
    lt.set_position(1, 1)
    lj.set_position(1, 1)
    assert [h.utt_ids for h, _ in lt] == [h.utt_ids for h, _ in lj]
    assert lt.state() == lj.state() == {"epoch": 1, "batches": 3}


def test_loader_retry_walk_equals_jax(tmp_path, libs):
    """A WAV that passes the dataset's existence check but fails to decode
    (native and Python) walks forward in the loader, to JAX's utterance."""
    entries, texts = [], []
    for i in range(6):
        name = f"u{i}.wav"
        if i in (1, 3):
            (tmp_path / name).write_bytes(b"RIFFgarbageWAVE")
        else:
            rng = np.random.default_rng(i)
            write_wav(tmp_path / name, (0.3 * rng.standard_normal(3000 + 800 * i)
                                        ).astype(np.float32))
        entries.append(tmanifest.ManifestEntry(f"spk/u{i}", "none.mp4", name, 0, 1))
        texts.append(f"utterance {i}")
    tmanifest.write_manifest(tmp_path / "train.tsv", tmp_path, entries)
    (tmp_path / "train.wrd").write_text("\n".join(texts) + "\n")
    jc, tc = data_cfgs(path=str(tmp_path), batch_size=3)
    ts, js = datasets(tmp_path, modality="audio", defer=True, batch_size=3)
    lt, lj = loaders(ts, js, jc, tc, shuffle=False)
    got, want = list(lt), list(lj)
    for (ht, bt), (hj, bj) in zip(got, want):
        host_equal(ht, hj)
        batches_close(bt, bj)
    assert got[0][0].utt_ids == ["spk/u0", "spk/u2", "spk/u2"]
    assert got[1][0].utt_ids == ["spk/u4", "spk/u4", "spk/u5"]


def test_loader_without_native_equals_jax(demo, monkeypatch):
    """No native library (AVSR_NO_NATIVE): the Python decode and the numpy
    YUV packing give the same batches."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    jc, tc = data_cfgs(path=str(demo), compact_transfer=True)
    ts, js = datasets(demo, modality="both", compact_transfer=True)
    assert not ts.defer_audio and not js.defer_audio
    lt, lj = loaders(ts, js, jc, tc, shuffle=False)
    for (ht, bt), (hj, bj) in zip(lt, lj):
        host_equal(ht, hj)
        batches_close(bt, bj, dict(atol=1e-5, rtol=1e-5))


# ---------------------------------------------------------------------------
# the compact link format
# ---------------------------------------------------------------------------

def synthetic_samples(n=4, S=16):
    jc, _ = data_cfgs()
    ds = jdataset.SyntheticAVSRDataset(jc, jtokenizer.ByteTokenizer(), image_size=S)
    js = [ds[i] for i in range(n)]
    return [tdataset.Sample(s.utt_id, s.audio, s.frames, s.text, s.tokens) for s in js], js


def test_compact_collate_and_featurize_equal_jax():
    ts, js = synthetic_samples()
    tok = jtokenizer.ByteTokenizer()
    prompt = tok.encode(PROMPT, add_bos=True)
    jc, tc = data_cfgs(compact_transfer=True)
    ht = tloader.collate(ts, tc, prompt, tok.pad_id)
    hj = jloader.collate(js, jc, prompt, tok.pad_id)
    host_equal(ht, hj)
    assert ht.audio.dtype == np.int16 and ht.frames is None
    assert ht.frames_y.shape[2:] == (16, 16) and ht.frames_uv.shape[2:] == (8, 8, 2)
    batches_close(tloader.featurize(ht, "cpu"), jloader.featurize(hj),
                  dict(atol=1e-5, rtol=1e-5))


def test_compact_featurize_within_jax_bounds_of_raw():
    """The port's compact batch against its raw one, at the JAX test's
    bounds: mel within 2e-2, white-noise frames' mean |d| under 0.6 (the
    chroma worst case), labels equal; the link carries < 0.55x the bytes."""
    ts, _ = synthetic_samples()
    tok = jtokenizer.ByteTokenizer()
    prompt = tok.encode(PROMPT, add_bos=True)
    _, tc_raw = data_cfgs()
    _, tc_c = data_cfgs(compact_transfer=True)
    h_raw = tloader.collate(ts, tc_raw, prompt, tok.pad_id)
    h_c = tloader.collate(ts, tc_c, prompt, tok.pad_id)
    raw_b = h_raw.audio.nbytes + h_raw.frames.nbytes
    assert h_c.audio.nbytes + h_c.frames_y.nbytes + h_c.frames_uv.nbytes < 0.55 * raw_b
    b_raw, b_c = tloader.featurize(h_raw, "cpu"), tloader.featurize(h_c, "cpu")
    np.testing.assert_allclose(b_c.mel.numpy(), b_raw.mel.numpy(), atol=2e-2)
    assert (b_c.frames - b_raw.frames).abs().mean() < 0.6
    assert torch.equal(b_c.labels, b_raw.labels)
    # PCM16 round trip is exact for what a PCM16 WAV decodes to
    pcm = np.arange(-32768, 32768, 7, dtype=np.int16)
    back = tloader._pcm16_to_f32(torch.from_numpy(pcm)).numpy()
    np.testing.assert_array_equal(
        np.clip(np.rint(back * 32768.0), -32768, 32767).astype(np.int16), pcm)


# ---------------------------------------------------------------------------
# frame ops (tests/test_ops_image.py's bounds)
# ---------------------------------------------------------------------------

def test_rgb_to_yuv420_np_equals_jax():
    frames = np.random.default_rng(2).integers(0, 256, (2, 3, 16, 16, 3)).astype(np.uint8)
    for t, j in zip(timage.rgb_to_yuv420_np(frames), jimage.rgb_to_yuv420_np(frames)):
        np.testing.assert_array_equal(t, j)


def test_yuv420_roundtrip_grayscale_exact():
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (1, 2, 8, 8, 1)).astype(np.uint8)
    frames = np.repeat(gray, 3, axis=-1)
    y, uv = timage.rgb_to_yuv420_np(frames)
    np.testing.assert_array_equal(y, gray[..., 0])
    assert np.abs(uv.astype(int) - 128).max() <= 1
    out = timage.normalize_yuv420_frames(torch.from_numpy(y), torch.from_numpy(uv))
    expect = timage.normalize_frames(torch.from_numpy(frames))
    assert (out - expect).abs().max() < 2.0 / 255.0 / min(timage.CLIP_STD) + 1e-6


def test_yuv420_roundtrip_color_bounded():
    rng = np.random.default_rng(0)
    coarse = rng.integers(0, 256, (2, 3, 4, 4, 3)).astype(np.uint8)
    frames = np.repeat(np.repeat(coarse, 4, axis=2), 4, axis=3)
    y, uv = timage.rgb_to_yuv420_np(frames)
    assert y.shape == (2, 3, 16, 16) and uv.shape == (2, 3, 8, 8, 2)
    out = timage.normalize_yuv420_frames(torch.from_numpy(y), torch.from_numpy(uv))
    expect = timage.normalize_frames(torch.from_numpy(frames))
    assert (out - expect).abs().max() < 4.0 / 255.0 / min(timage.CLIP_STD)


def test_normalize_yuv420_and_frames_equal_jax():
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (2, 3, 16, 16, 3)).astype(np.uint8)
    y, uv = timage.rgb_to_yuv420_np(frames)
    got = timage.normalize_yuv420_frames(torch.from_numpy(y), torch.from_numpy(uv))
    want = jimage.normalize_yuv420_frames(jnp.asarray(y), jnp.asarray(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    got = timage.normalize_frames(torch.from_numpy(frames))
    want = jimage.normalize_frames(jnp.asarray(frames))
    assert got.shape == (2, 3, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert timage.normalize_frames(torch.from_numpy(frames),
                                   dtype=torch.bfloat16).dtype == torch.bfloat16


def test_yuv420_native_matches_numpy(libs):
    frames = np.random.default_rng(0).integers(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    got = tnative.rgb_to_yuv420(frames)
    y_ref, uv_ref = timage.rgb_to_yuv420_np(frames)
    assert np.abs(got[0].astype(int) - y_ref.astype(int)).max() <= 1
    assert np.abs(got[1].astype(int) - uv_ref.astype(int)).max() <= 1
