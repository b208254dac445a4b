"""The port's ``cli/prepare_data.py`` vs the JAX package's (CPU): the demo
corpus byte for byte, the scan mode's manifests, and a training batch from
a demo corpus through the port's loader."""

import numpy as np
import pytest

from avsr_tpu.cli import prepare_data as jprep
from avsr_tpu.data.audio_io import write_wav
from avsr_tpu_torch.cli import prepare_data as tprep
from avsr_tpu_torch.core.config import DataConfig, ModelConfig
from avsr_tpu_torch.data.dataset import ManifestAVSRDataset
from avsr_tpu_torch.data.loader import DataLoader
from avsr_tpu_torch.data.manifest import load_manifest
from avsr_tpu_torch.data.tokenizer import ByteTokenizer


def tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("n,seed,splits", [(6, 0, "0.9,0.05,0.05"), (10, 3, "0.6,0.2,0.2")])
def test_demo_files_equal_jax(tmp_path, n, seed, splits):
    """--demo writes the same WAVs, .npy frames, transcripts and manifests
    (whose first line is each output's own root)."""
    args = ["--demo", str(n), "--seed", str(seed), "--splits", splits]
    assert tprep.main([*args, "--out", str(tmp_path / "t")]) == 0
    assert jprep.main([*args, "--out", str(tmp_path / "j")]) == 0
    t, j = tree(tmp_path / "t"), tree(tmp_path / "j")
    assert t.keys() == j.keys() and len([k for k in t if k.endswith(".wav")]) == n
    for name in t:
        if name.endswith(".tsv"):
            lt, lj = t[name].decode().splitlines(), j[name].decode().splitlines()
            assert lt[0] == str((tmp_path / "t").absolute())
            assert lt[1:] == lj[1:], name
        else:
            assert t[name] == j[name], name


def make_raw(d, rng):
    """A media directory: WAVs at 16 and 48 kHz, some with .npy video,
    transcripts in sidecar files (one missing) and in a listing."""
    (d / "spk").mkdir(parents=True)
    lines = []
    for i in range(9):
        sr = 48000 if i % 3 == 0 else 16000
        stem = d / "spk" / f"s{i}"
        write_wav(stem.with_suffix(".wav"),
                  (0.3 * rng.standard_normal(int(sr * (0.3 + 0.1 * i)))).astype(np.float32), sr)
        if i % 2 == 0:
            np.save(stem.with_suffix(".npy"),
                    rng.integers(0, 256, (5 + i, 8, 8, 3)).astype(np.uint8))
        if i != 4:
            stem.with_suffix(".txt").write_text(f"hello  world {i}\n")
            lines.append(f"spk/s{i}\tword {i} here")
    (d / "list.txt").write_text("\n".join(lines) + "\n\n")


@pytest.mark.parametrize("transcripts", [False, True])
def test_scan_mode_equals_jax(tmp_path, transcripts):
    raw = tmp_path / "raw"
    make_raw(raw, np.random.default_rng(0))
    args = ["--data_dir", str(raw), "--splits", "0.5,0.25,0.25", "--seed", "2"]
    if transcripts:
        args += ["--transcripts", str(raw / "list.txt")]
    assert tprep.main([*args, "--out", str(tmp_path / "t")]) == 0
    assert jprep.main([*args, "--out", str(tmp_path / "j")]) == 0
    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    root, entries = load_manifest(tmp_path / "t" / "train.tsv")
    assert root == raw.absolute() and len(entries) == 4     # 8 with transcripts
    by_id = {e.utt_id: e for s in ("train", "valid", "test")
             for e in load_manifest(tmp_path / "t" / f"{s}.tsv")[1]}
    assert "spk/s4" not in by_id
    assert by_id["spk/s0"].num_samples == 14400 and by_id["spk/s0"].num_frames == 5
    assert by_id["spk/s1"].video_path == "none" and by_id["spk/s1"].num_frames == 0
    want = "word 0 here" if transcripts else "hello world 0"
    labels = {s: (tmp_path / "t" / f"{s}.wrd").read_text().splitlines()
              for s in ("train", "valid", "test")}
    assert want in sum(labels.values(), [])


def test_prepare_data_errors(tmp_path):
    with pytest.raises(SystemExit):
        tprep.main(["--out", str(tmp_path / "o")])
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no .wav files"):
        tprep.main(["--data_dir", str(tmp_path / "empty"), "--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="3 fractions summing to 1"):
        tprep.main(["--demo", "2", "--out", str(tmp_path / "o"), "--splits", "0.5,0.6"])


def test_demo_to_training_batch(tmp_path):
    assert tprep.main(["--demo", "10", "--out", str(tmp_path), "--splits", "0.6,0.2,0.2",
                       "--seed", "1"]) == 0
    ids = set()
    for split, n in (("train", 6), ("valid", 2), ("test", 2)):
        _, es = load_manifest(tmp_path / f"{split}.tsv")
        assert len(es) == n and all(e.num_samples > 0 and e.num_frames > 0 for e in es)
        assert (tmp_path / f"{split}.wrd").read_text().count("\n") == n
        assert not ids & {e.utt_id for e in es}
        ids |= {e.utt_id for e in es}
    cfg = DataConfig(path=str(tmp_path), batch_size=2, max_audio_length=48000,
                     max_video_length=16, max_label_length=48, audio_buckets=(100, 200, 300),
                     video_buckets=(8, 16))
    tok = ByteTokenizer()
    ds = ManifestAVSRDataset(cfg, tok, modality="both", image_size=32)
    loader = DataLoader(ds, cfg, tok, model_cfg=ModelConfig(prompt="t:"), shuffle=False,
                        device="cpu")
    hb, batch = next(iter(loader))
    loader.close()
    assert hb.audio_lens.min() > 0 and hb.frame_lens.min() > 0
    assert batch.frames.shape == (2, 16, 3, 32, 32)
    assert bool(batch.mel.isfinite().all())
