"""Tokenizers, a copy of ``avsr_tpu/data/tokenizer.py``.

  * ``ByteTokenizer`` — ids 0..255 are raw UTF-8 bytes; BOS/EOS/PAD follow.
    No assets, no network.
  * ``HFTokenizer`` — a local HF ``tokenizer.json`` through the
    ``tokenizers`` library, imported only when one is built (so the package
    imports on hosts without it).

``load_tokenizer(path)`` picks the byte tokenizer without a path and the
HF one with it, as every CLI of both packages does with
``model.llm_path``. Both expose encode / decode / bos_id / eos_id / pad_id /
vocab_size.
"""

from __future__ import annotations

from pathlib import Path


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


class HFTokenizer:
    """A local HF ``tokenizer.json`` (a file, or a directory holding one);
    no network."""

    def __init__(self, path: str | Path) -> None:
        from tokenizers import Tokenizer

        path = Path(path)
        tok_file = path / "tokenizer.json" if path.is_dir() else path
        self._tok = Tokenizer.from_file(str(tok_file))
        self.vocab_size = self._tok.get_vocab_size()

        def find(cands, default):
            for c in cands:
                i = self._tok.token_to_id(c)
                if i is not None:
                    return i
            return default

        self.bos_id = find(["<s>", "<|begin_of_text|>", "<bos>"], 1)
        self.eos_id = find(["</s>", "<|end_of_text|>", "<eos>"], 2)
        self.pad_id = find(["<pad>", "<|finetune_right_pad_id|>"], self.eos_id)

    def encode(self, text: str, *, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        """The text of ``ids`` with BOS, EOS and PAD dropped."""
        ids = [int(i) for i in ids
               if int(i) not in (self.bos_id, self.eos_id, self.pad_id)]
        return self._tok.decode(ids)


def load_tokenizer(path: str | Path | None = None):
    """The byte tokenizer without a path, the HF tokenizer at ``path``
    otherwise."""
    if not path:
        return ByteTokenizer()
    return HFTokenizer(path)
