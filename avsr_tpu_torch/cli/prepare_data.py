"""Dataset preparation: LRS3-style manifests from a media directory, the
port of ``avsr_tpu/cli/prepare_data.py``. Two modes:

  * scan mode — walk ``--data_dir`` for ``*.wav`` (with an optional
    sibling ``<id>.mp4``/``<id>.npy`` video), read transcripts from
    ``--transcripts`` ("<id> <text>" lines) or per-file ``<id>.txt``,
    split train/valid/test deterministically from ``--seed``, and write
    ``{split}.tsv``/``{split}.wrd`` (``data/manifest.py``);
  * ``--demo N`` — synthesize N tone WAVs, random-frame ``.npy`` videos and
    word transcripts on disk (the same files as the JAX package's for the
    same seed), then build manifests from them: a self-contained real-file
    corpus for smoke tests and tutorials.

    python -m avsr_tpu_torch.cli.prepare_data --demo 16 --out data/avsr_demo
    python -m avsr_tpu_torch.cli.prepare_data --data_dir /data/raw --out /data/lrs3
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from avsr_tpu_torch.core.logging import setup_logging
from avsr_tpu_torch.data.audio_io import wav_num_samples, write_wav
from avsr_tpu_torch.data.dataset import _WORDS
from avsr_tpu_torch.data.manifest import ManifestEntry, write_manifest
from avsr_tpu_torch.mesh.multihost import refuse_world

log = logging.getLogger("avsr_tpu_torch.cli.prepare_data")


def video_num_frames(path: Path) -> int:
    if path.suffix == ".npy":
        # mmap reads only the header — no frame data is loaded
        return int(np.load(path, mmap_mode="r").shape[0])
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        return max(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), 0)
    finally:
        cap.release()


def scan_media(data_dir: Path) -> list[tuple[str, Path, Path | None]]:
    """-> [(utt_id, wav, video|None)] sorted by id."""
    items = []
    for wav in sorted(data_dir.rglob("*.wav")):
        utt = str(wav.relative_to(data_dir).with_suffix(""))
        video = None
        for ext in (".mp4", ".avi", ".mov", ".npy"):
            cand = wav.with_suffix(ext)
            if cand.exists():
                video = cand
                break
        items.append((utt, wav, video))
    return items


def load_transcripts(data_dir: Path, transcripts: Path | None,
                     utts: list[str]) -> dict[str, str]:
    out: dict[str, str] = {}
    if transcripts:
        for ln in Path(transcripts).read_text().splitlines():
            ln = ln.strip()
            if not ln:
                continue
            utt, _, text = ln.replace("\t", " ").partition(" ")
            out[utt] = text.strip()
        return out
    for utt in utts:
        txt = data_dir / f"{utt}.txt"
        if txt.exists():
            out[utt] = " ".join(txt.read_text().split())
    return out


def make_demo(out: Path, n: int, seed: int, *,
              secs_range: tuple[float, float] = (0.5, 3.0),
              rates: tuple[int, ...] = (16000,), frame_size: int = 48) -> Path:
    """Write n synthetic utterances as real media files under out/media:
    ``secs_range`` seconds of a tone plus noise as a PCM16 WAV (utterance
    i at ``rates[i % len(rates)]`` Hz), random ``frame_size`` square
    frames at 25 per second as ``.npy``, and 2-7 word transcripts in
    out/transcripts.txt. The defaults write the JAX package's files."""
    media = out / "media"
    media.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        secs = float(rng.uniform(*secs_range))
        sr = rates[i % len(rates)]
        t = np.arange(int(sr * secs), dtype=np.float32) / sr
        f0 = float(rng.uniform(80, 300))
        audio = (0.3 * np.sin(2 * np.pi * f0 * t)
                 + 0.05 * rng.standard_normal(t.shape[0])).astype(np.float32)
        write_wav(media / f"utt{i:04d}.wav", audio, sr)
        frames = rng.integers(0, 256, (int(25 * secs), frame_size, frame_size,
                                       3)).astype(np.uint8)
        np.save(media / f"utt{i:04d}.npy", frames)
        text = " ".join(rng.choice(_WORDS, int(rng.integers(2, 8))))
        lines.append(f"media/utt{i:04d} {text}")
    (out / "transcripts.txt").write_text("\n".join(lines) + "\n")
    log.info("demo dataset: %d utterances under %s", n, media)
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Build LRS3-style manifests (+ optional demo dataset)")
    p.add_argument("--data_dir", default=None, help="media root to scan")
    p.add_argument("--out", required=True, help="output dataset directory")
    p.add_argument("--transcripts", default=None,
                   help='file of "<utt_id> <text>" lines')
    p.add_argument("--splits", default="0.9,0.05,0.05",
                   help="train,valid,test fractions")
    p.add_argument("--demo", type=int, default=0,
                   help="generate N synthetic utterances instead of scanning")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    refuse_world("the prepare_data CLI")
    setup_logging(None)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.demo:
        data_dir = make_demo(out, args.demo, args.seed)
        transcripts = out / "transcripts.txt"
    else:
        if not args.data_dir:
            p.error("--data_dir or --demo is required")
        data_dir = Path(args.data_dir)
        transcripts = Path(args.transcripts) if args.transcripts else None

    items = scan_media(data_dir)
    if not items:
        raise SystemExit(f"no .wav files under {data_dir}")
    texts = load_transcripts(data_dir, transcripts, [u for u, _, _ in items])
    missing = [u for u, _, _ in items if u not in texts]
    if missing:
        log.warning("%d utterances without transcripts — skipped (first: %s)",
                    len(missing), missing[0])
    items = [(u, a, v) for u, a, v in items if u in texts]

    fracs = [float(x) for x in args.splits.split(",")]
    if len(fracs) != 3 or abs(sum(fracs) - 1.0) > 1e-6:
        raise SystemExit(f"--splits must be 3 fractions summing to 1: {fracs}")
    order = np.random.default_rng(args.seed).permutation(len(items))
    n_train = round(len(items) * fracs[0])
    n_val = round(len(items) * fracs[1])
    splits = {"train": order[:n_train],
              "valid": order[n_train:n_train + n_val],
              "test": order[n_train + n_val:]}

    for split, idx in splits.items():
        entries, labels = [], []
        for i in sorted(idx):
            utt, wav, video = items[int(i)]
            entries.append(ManifestEntry(
                utt_id=utt,
                video_path=(str(video.relative_to(data_dir)) if video
                            else "none"),
                audio_path=str(wav.relative_to(data_dir)),
                num_frames=video_num_frames(video) if video else 0,
                num_samples=wav_num_samples(wav)))
            labels.append(texts[utt])
        write_manifest(out / f"{split}.tsv", data_dir.absolute(), entries)
        (out / f"{split}.wrd").write_text(
            "\n".join(labels) + ("\n" if labels else ""))
        log.info("%s: %d utterances", split, len(entries))
    print(f"manifests written to {out} "
          f"({', '.join(f'{s}={len(i)}' for s, i in splits.items())})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
