"""Byte-level tokenizer, a copy of ``avsr_tpu/data/tokenizer.py::ByteTokenizer``.

Ids 0..255 are raw UTF-8 bytes; BOS/EOS/PAD follow. No assets, no network.
The HF ``tokenizer.json`` wrapper is still to be ported.
"""

from __future__ import annotations


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255 bytes, then BOS/EOS/PAD."""

    def __init__(self) -> None:
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.vocab_size = 259

    def encode(self, text: str, *, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        data = bytes(int(i) for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")
