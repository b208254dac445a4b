"""Word and character error rate, a copy of ``avsr_tpu/infer/wer.py``.

The standard Levenshtein WER over whitespace words, with per-utterance and
corpus-level aggregation (corpus WER = total edits / total reference words).
"""

from __future__ import annotations

from dataclasses import dataclass


def edit_distance(ref: list[str], hyp: list[str]) -> int:
    """Word-level Levenshtein distance, O(len(ref)*len(hyp))."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ri != hyp[j - 1])
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev = cur
    return prev[m]


def normalize_text(text: str) -> list[str]:
    """Uppercase + whitespace split (LRS3 refs are uppercase; ref decode.py
    compares raw strings — normalization here makes WER casing-robust)."""
    return text.upper().split()


def wer(reference: str, hypothesis: str) -> float:
    ref = normalize_text(reference)
    hyp = normalize_text(hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)


def normalize_chars(text: str) -> list[str]:
    """Character units for CER: the normalized (uppercased, single-spaced)
    string as a char list. THE one definition — cer() and WERAccumulator
    must agree or corpus CER silently desyncs from per-utterance CER."""
    return list(" ".join(normalize_text(text)))


def cer(reference: str, hypothesis: str) -> float:
    """Character error rate: Levenshtein over characters of the normalized
    (uppercased, single-spaced) strings. The finer-grained companion
    metric — standard for AVSR ablations where WER saturates."""
    ref = normalize_chars(reference)
    hyp = normalize_chars(hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)


@dataclass
class WERAccumulator:
    """Corpus-level WER + CER: total edits over total reference units.

    Corpus metrics are deliberately UNCAPPED (total edits / total ref
    units, the standard corpus definition) — unlike per-utterance wer()/
    cer(), which cap an empty-reference mismatch at 1.0. An empty ref
    with a nonempty hyp therefore adds its insertions to the numerator
    and nothing to the denominator here."""

    edits: int = 0
    ref_words: int = 0
    char_edits: int = 0
    ref_chars: int = 0
    utterances: int = 0

    def add(self, reference: str, hypothesis: str) -> float:
        ref = normalize_text(reference)
        hyp = normalize_text(hypothesis)
        e = edit_distance(ref, hyp)
        self.edits += e
        self.ref_words += len(ref)
        rc = normalize_chars(reference)
        hc = normalize_chars(hypothesis)
        self.char_edits += edit_distance(rc, hc)
        self.ref_chars += len(rc)
        self.utterances += 1
        return e / max(len(ref), 1)

    @property
    def wer(self) -> float:
        return self.edits / max(self.ref_words, 1)

    @property
    def cer(self) -> float:
        return self.char_edits / max(self.ref_chars, 1)
