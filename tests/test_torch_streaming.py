"""The port's streaming transcription (``infer/streaming.py``), the stream
and infer CLIs, and the media readers (``data/audio_io.py``,
``data/video_io.py``) vs the JAX package, the counterparts of
``tests/test_streaming.py`` and ``tests/test_cli_infer.py``.

Both packages' ``StreamingTranscriber`` get the same weights (those of
``tests/test_torch_engine.py``: the JAX init, a 2-layer LLM, an untied
head, LoRA ``b`` randomised; EOS byte 10) and the same chunks, and must
commit the same tokens at every feed, in the exact mode (re-encode,
LocalAgreement-n, rollover at the largest bucket) and the blockwise mode
(blocks frozen into a persistent cache). The CLIs run on a ``.wav``
written by the port's ``write_wav`` and a ``.npy`` of frames, and print
what the transcriber commits for the same media. Tolerance: exact
equality of tokens and of the WAV reader's samples; the resampler to 1e-6;
a PCM16 write and read back within two quantization steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

from avsr_tpu.data import audio_io as jaudio
from avsr_tpu.data import video_io as jvideo
from avsr_tpu.infer.streaming import StreamingTranscriber as JStream
from avsr_tpu_torch.cli import infer as tinfer
from avsr_tpu_torch.cli import stream as tstream
from avsr_tpu_torch.cli.common import load_decode_params
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.data import audio_io as taudio
from avsr_tpu_torch.data import video_io as tvideo
from avsr_tpu_torch.data.dataset import resize_crop_frames
from avsr_tpu_torch.data.loader import collate, featurize
from avsr_tpu_torch.data.dataset import Sample
from avsr_tpu_torch.data.tokenizer import ByteTokenizer
from avsr_tpu_torch.ops.image import sample_frame_indices
from avsr_tpu_torch.infer.generate import generate_tokens
from avsr_tpu_torch.infer.streaming import StreamingTranscriber as TStream

from test_torch_engine import TINY_YAML, Tok, configs, model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def audio_model():
    jc, tc = configs()
    p_j, p_t = model(jc)
    return dict(jc=jc, tc=tc, p_j=p_j, p_t=p_t)


@pytest.fixture(scope="module")
def av_model():
    jc, tc = configs(**{"model.modality": "both"})
    p_j, p_t = model(jc)
    return dict(jc=jc, tc=tc, p_j=p_j, p_t=p_t)


def replace(jc, tc, section: str, **kw):
    return (dataclasses.replace(jc, **{section: dataclasses.replace(getattr(jc, section), **kw)}),
            dataclasses.replace(tc, **{section: dataclasses.replace(getattr(tc, section), **kw)}))


def run_both(m, feeds, *, agree_n, jc=None, tc=None, check=None):
    """Feed the same chunks to both packages' transcribers; every feed and
    the finalize must return the same text and commit the same tokens.
    Returns the port's transcriber."""
    tok = Tok()
    ts = TStream(m["p_t"], tc or m["tc"], tok, agree_n=agree_n)
    js = JStream(m["p_j"], jc or m["jc"], tok, agree_n=agree_n)
    prev = []
    for kw in feeds:
        new = ts.feed(**kw)
        assert new == js.feed(**kw)
        toks = ts.committed_tokens
        assert toks == js.committed_tokens
        assert toks[: len(prev)] == prev                 # never retracted
        assert new == tok.decode(toks[len(prev):])       # exactly the new ids
        if check is not None:
            check(ts, js)
        prev = toks
    tail = ts.finalize()
    assert tail == js.finalize()
    assert ts.committed_tokens == js.committed_tokens
    assert ts.committed_tokens[: len(prev)] == prev
    assert ts.committed_text == tok.decode(ts.committed_tokens)
    return ts


def noise(n, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def test_finalize_matches_offline(audio_model):
    """agree_n above the feed count: nothing commits mid-stream, so
    finalize() equals the one-shot offline decode (and the standalone
    generate_tokens of the whole buffer)."""
    m = audio_model
    audio = noise(12800, 0)
    st = run_both(m, [dict(audio=audio[i * 3200:(i + 1) * 3200]) for i in range(4)],
                  agree_n=10)
    offline = run_both(m, [dict(audio=audio)], agree_n=10)
    assert st.committed_tokens == offline.committed_tokens
    tok, tc = Tok(), m["tc"]
    hb = collate([Sample("x", audio, None, "", [tok.eos_id])], tc.data,
                 tok.encode(tc.model.prompt, add_bos=True), tok.pad_id)
    out = generate_tokens(m["p_t"], tc.model, featurize(hb, "cpu", torch.float32),
                          max_new_tokens=tc.decode.max_new_tokens, eos_id=tok.eos_id)
    ids = out.tokens[0, : int(out.lengths[0])].tolist()
    assert st.committed_tokens == (ids[:-1] if ids[-1] == tok.eos_id else ids)


def test_commits_are_monotonic(audio_model):
    audio = noise(16000, 1)
    st = run_both(audio_model, [dict(audio=audio[i * 3200:(i + 1) * 3200])
                                for i in range(5)], agree_n=2)
    assert len(st.committed_tokens) > 0


def test_window_rollover_keeps_transcribing(audio_model):
    """A stream longer than the largest bucket rolls into new segments:
    earlier commits survive and decoding continues."""
    m = audio_model
    jc, tc = replace(m["jc"], m["tc"], "data", audio_buckets=(20, 40))

    def bounded(ts, js):
        assert ts._audio.shape[0] <= 40 * 160

    audio = noise(32000, 2)
    st = run_both(m, [dict(audio=audio[i * 3200:(i + 1) * 3200]) for i in range(10)],
                  agree_n=1, jc=jc, tc=tc, check=bounded)
    assert len(st.committed_tokens) > 0


def test_oversized_chunk_is_split_not_truncated(audio_model):
    """One chunk larger than the window is split into window-sized pieces
    and fully decoded, as the same media fed piecewise."""
    m = audio_model
    jc, tc = replace(m["jc"], m["tc"], "data", audio_buckets=(20, 40))
    window = 40 * 160
    audio = noise(4 * window, 3)
    st = run_both(m, [dict(audio=audio)], agree_n=1, jc=jc, tc=tc)
    ref = run_both(m, [dict(audio=audio[i * window:(i + 1) * window]) for i in range(4)],
                   agree_n=1, jc=jc, tc=tc)
    assert st.committed_tokens == ref.committed_tokens
    assert len(st.committed_tokens) > 0


def test_blockwise_streaming_commits_and_freezes(audio_model):
    """Blockwise mode: blocks freeze into the persistent cache (the same
    frozen frontier as JAX's at every feed) and the commits are JAX's."""
    m = audio_model
    jc, tc = replace(m["jc"], m["tc"], "decode", stream_block_s=0.2, max_new_tokens=6)

    def frontier(ts, js):
        assert (ts._base_len, ts._frozen_samples) == (js._base_len, js._frozen_samples)

    audio = noise(16000, 4)
    st = run_both(m, [dict(audio=audio[i * 3200:(i + 1) * 3200]) for i in range(5)],
                  agree_n=2, jc=jc, tc=tc, check=frontier)
    assert st._cache is not None and st._frozen_samples >= 3200
    assert st._base_len > len(Tok().encode(tc.model.prompt, add_bos=True))


def test_blockwise_rollover_resets_cache(audio_model):
    m = audio_model
    jc, tc = replace(m["jc"], m["tc"], "data", audio_buckets=(20, 40))
    jc, tc = replace(jc, tc, "decode", stream_block_s=0.1, max_new_tokens=4)

    def bounded(ts, js):
        assert ts._audio.shape[0] <= 40 * 160
        assert ts._frozen_samples <= ts._audio.shape[0]
        assert ts._base_len == js._base_len

    audio = noise(32000, 5)
    st = run_both(m, [dict(audio=audio[i * 3200:(i + 1) * 3200]) for i in range(10)],
                  agree_n=1, jc=jc, tc=tc, check=bounded)
    assert len(st.committed_tokens) > 0


def test_blockwise_streaming_av_modality(av_model):
    """A block spans stream_block_s of BOTH streams (3200 samples and 2
    frames at 10 fps); commits equal JAX's and both modalities freeze."""
    m = av_model
    jc, tc = replace(m["jc"], m["tc"], "decode", stream_block_s=0.2,
                     stream_video_fps=10.0, max_new_tokens=5)
    rng = np.random.default_rng(6)
    audio = noise(12800, 6)
    frames = rng.integers(0, 256, (8, 16, 16, 3)).astype(np.uint8)
    st = run_both(m, [dict(audio=audio[i * 3200:(i + 1) * 3200], frames=frames[2 * i:2 * i + 2])
                      for i in range(4)], agree_n=2, jc=jc, tc=tc)
    assert st._cache is not None
    assert st._frozen_samples >= 3200 and st._frozen_frames >= 2


def test_blockwise_av_gates_on_slower_modality(av_model):
    """Audio fed ahead of video freezes nothing until the video catches
    up (the slower modality gates the frontier)."""
    m = av_model
    jc, tc = replace(m["jc"], m["tc"], "decode", stream_block_s=0.2,
                     stream_video_fps=10.0, max_new_tokens=4)
    frames = np.random.default_rng(7).integers(0, 256, (8, 16, 16, 3)).astype(np.uint8)
    seen = []

    def record(ts, js):
        assert ts._frozen_samples == js._frozen_samples
        seen.append(ts._frozen_samples)

    st = run_both(m, [dict(audio=noise(12800, 7)), dict(frames=frames)], agree_n=2, jc=jc,
                  tc=tc, check=record)
    assert seen[0] == 0 and seen[1] >= 3200 and st._frozen_frames >= 2


def test_audio_io_equals_jax(tmp_path):
    """The copied WAV reader, writer, resampler and header count: the same
    samples as the JAX package's on PCM16 (written by the port), PCM24,
    PCM32, 8-bit, float32, stereo and a 22.05 kHz file."""
    import wave

    rng = np.random.default_rng(8)
    x = (0.5 * np.sin(np.linspace(0, 300, 8000))).astype(np.float32)
    taudio.write_wav(tmp_path / "a.wav", x)
    files = [tmp_path / "a.wav"]
    for name, width, data, ch, sr in (
            ("p24", 3, rng.integers(0, 256, 3 * 2000, dtype=np.uint8).tobytes(), 1, 16000),
            ("p32", 4, rng.integers(-2**31, 2**31 - 1, 1000, dtype=np.int64).astype("<i4")
             .tobytes(), 1, 16000),
            ("p8", 1, rng.integers(0, 256, 900, dtype=np.uint8).tobytes(), 1, 16000),
            ("st", 2, rng.integers(-3000, 3000, 2 * 700).astype("<i2").tobytes(), 2, 22050)):
        with wave.open(str(tmp_path / f"{name}.wav"), "wb") as w:
            w.setnchannels(ch)
            w.setsampwidth(width)
            w.setframerate(sr)
            w.writeframes(data)
        files.append(tmp_path / f"{name}.wav")
    for f in files:
        (a, sa), (b, sb) = taudio.read_wav(f), jaudio.read_wav(f)
        assert sa == sb
        np.testing.assert_array_equal(a, b)
        assert taudio.wav_num_samples(f) == jaudio.wav_num_samples(f)
        np.testing.assert_allclose(taudio.load_audio(f, max_samples=500),
                                   jaudio.load_audio(f, max_samples=500), atol=1e-6)
    np.testing.assert_allclose(taudio.read_wav(files[0])[0], x, atol=2 / 32768)   # PCM16 step
    np.testing.assert_allclose(taudio.resample(x, 22050), jaudio.resample(x, 22050), atol=1e-6)
    with pytest.raises(ValueError, match="RIFF"):
        (tmp_path / "bad.wav").write_bytes(b"nope" * 4)
        taudio.read_wav(tmp_path / "bad.wav")


def test_video_io_equals_jax(tmp_path):
    rng = np.random.default_rng(9)
    arr = rng.integers(0, 256, (11, 20, 24, 3)).astype(np.uint8)
    np.save(tmp_path / "v.npy", arr)
    for T in (4, 11, 16):
        np.testing.assert_array_equal(sample_frame_indices(11, T), jvideo.sample_indices(11, T))
        np.testing.assert_array_equal(tvideo.load_frames(tmp_path / "v.npy", T),
                                      jvideo.load_frames(tmp_path / "v.npy", T))
    np.save(tmp_path / "bad.npy", arr[..., :2])
    with pytest.raises(ValueError, match="expected"):
        tvideo.load_frames(tmp_path / "bad.npy", 4)
    out = resize_crop_frames(arr, 16)
    assert out.shape == (11, 16, 16, 3) and out.dtype == np.uint8
    assert resize_crop_frames(out, 16) is out
    flat = np.full((2, 30, 20, 3), 77, np.uint8)                 # resize keeps constants
    np.testing.assert_array_equal(resize_crop_frames(flat, 16), 77)


def _cli_transcriber(cfg_over, seed=1):
    """The params the CLIs build from --seed, in a transcriber of the port."""
    tc = tcfg.load_config(TINY_YAML, cfg_over)
    params = load_decode_params(tc, None, seed=seed, device="cpu")
    return tc, params


@pytest.mark.parametrize("mode", ["exact", "blockwise"])
def test_cli_stream_audio(tmp_path, capsys, mode):
    """The stream CLI on a WAV written by write_wav prints what the
    transcriber commits for the same chunks, then the transcript."""
    over = ["decode.max_new_tokens=6"] + (["decode.stream_block_s=0.2"]
                                          if mode == "blockwise" else [])
    x = (0.3 * np.sin(np.linspace(0, 500, 16000))).astype(np.float32)
    taudio.write_wav(tmp_path / "u.wav", x)
    rc = tstream.main(["--config", str(TINY_YAML), "--device", "cpu", "--seed", "1",
                       "--audio", str(tmp_path / "u.wav"), "--chunk-s", "0.25", *over])
    assert rc == 0
    out = capsys.readouterr().out
    tc, params = _cli_transcriber(over)
    st = TStream(params, tc, ByteTokenizer())
    audio = taudio.load_audio(tmp_path / "u.wav")
    for i in range(4):
        st.feed(audio=audio[i * 4000:(i + 1) * 4000])
    st.finalize()
    assert out.endswith(st.committed_text + "\n")


def test_cli_stream_av(tmp_path, capsys):
    rng = np.random.default_rng(10)
    taudio.write_wav(tmp_path / "u.wav",
                     (0.2 * np.sin(np.linspace(0, 300, 12000))).astype(np.float32))
    np.save(tmp_path / "u.npy", rng.integers(0, 256, (8, 24, 24, 3)).astype(np.uint8))
    rc = tstream.main(["--config", str(TINY_YAML), "--device", "cpu",
                       "--audio", str(tmp_path / "u.wav"), "--video", str(tmp_path / "u.npy"),
                       "--chunk-s", "0.25", "model.modality=both", "decode.max_new_tokens=4"])
    assert rc == 0
    assert capsys.readouterr().out.endswith("\n")
    with pytest.raises(SystemExit):
        tstream.main(["--config", str(TINY_YAML), "--device", "cpu",
                      "--audio", str(tmp_path / "u.wav"), "model.modality=both"])


@pytest.mark.parametrize("av", [False, True], ids=["audio", "av"])
def test_cli_infer(tmp_path, capsys, av):
    """The infer CLI prints the greedy decode of the file's media, with
    the weights of --seed (frames resized to the model's image size)."""
    rng = np.random.default_rng(11)
    x = (0.3 * np.sin(np.linspace(0, 400, 16000))).astype(np.float32)
    taudio.write_wav(tmp_path / "u.wav", x)
    args = ["--config", str(TINY_YAML), "--device", "cpu", "--seed", "2",
            "--audio", str(tmp_path / "u.wav")]
    over = ["decode.max_new_tokens=6"]
    frames = None
    if av:
        frames = rng.integers(0, 256, (6, 24, 24, 3)).astype(np.uint8)
        np.save(tmp_path / "u.npy", frames)
        args += ["--video", str(tmp_path / "u.npy")]
        over += ["model.modality=both"]
    assert tinfer.main(args + over) == 0
    out = capsys.readouterr().out
    tc, params = _cli_transcriber(over, seed=2)
    tok = ByteTokenizer()
    fr = resize_crop_frames(frames, tc.model.image_size) if av else None
    hb = collate([Sample("x", taudio.load_audio(tmp_path / "u.wav"), fr, "", [tok.eos_id])],
                 tc.data, tok.encode(tc.model.prompt, add_bos=True), tok.pad_id)
    o = generate_tokens(params, tc.model, featurize(hb, "cpu", torch.float32),
                        max_new_tokens=6, eos_id=tok.eos_id)
    assert out == tok.decode(o.tokens[0, : int(o.lengths[0])].tolist()) + "\n"
