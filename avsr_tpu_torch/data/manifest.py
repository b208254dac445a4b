"""LRS3-style manifests, a copy of ``avsr_tpu/data/manifest.py``.

Format: a TSV whose first line is the dataset root directory, followed by
rows

    utt_id <TAB> video_rel_path <TAB> audio_rel_path <TAB> n_frames <TAB> n_samples

plus a sibling ``.wrd`` file with one transcript line per utterance.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class ManifestEntry:
    utt_id: str
    video_path: str
    audio_path: str
    num_frames: int
    num_samples: int


def load_manifest(tsv_path: str | Path) -> tuple[Path, list[ManifestEntry]]:
    """-> (root_dir, entries). Malformed rows are skipped, not fatal."""
    tsv_path = Path(tsv_path)
    lines = tsv_path.read_text().splitlines()
    if not lines:
        raise ValueError(f"{tsv_path}: empty manifest")
    root = Path(lines[0].strip())
    entries: list[ManifestEntry] = []
    for ln in lines[1:]:
        ln = ln.strip()
        if not ln:
            continue
        parts = ln.split("\t")
        if len(parts) < 5:
            continue
        entries.append(ManifestEntry(
            utt_id=parts[0],
            video_path=parts[1],
            audio_path=parts[2],
            num_frames=int(float(parts[3])),
            num_samples=int(float(parts[4])),
        ))
    return root, entries


def load_labels(wrd_path: str | Path) -> list[str]:
    return [ln.strip() for ln in Path(wrd_path).read_text().splitlines()]


def utt_aliases(utt_id: str) -> list[str]:
    """The id variants that join references to hypotheses: the full id and
    every path suffix ('a/b/c' -> 'a/b/c', 'b/c', 'c')."""
    parts = utt_id.split("/")
    return ["/".join(parts[i:]) for i in range(len(parts))]


def write_manifest(tsv_path: str | Path, root: str | Path,
                   entries: list[ManifestEntry]) -> None:
    lines = [str(root)]
    for e in entries:
        lines.append(f"{e.utt_id}\t{e.video_path}\t{e.audio_path}\t"
                     f"{e.num_frames}\t{e.num_samples}")
    Path(tsv_path).write_text("\n".join(lines) + "\n")
