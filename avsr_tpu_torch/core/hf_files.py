"""Local Hugging Face checkpoint directories, read without ``transformers``.

The JAX package takes a state dict from
``transformers.<Class>.from_pretrained(path).state_dict()``. The port reads
the directory's files itself, so that conversion runs on a host with
neither ``transformers`` nor ``tokenizers`` nor ``safetensors``:

  * ``config.json`` with ``json``;
  * ``model.safetensors`` with the small reader below (the public layout:
    an 8-byte little-endian header length, a JSON header naming each
    tensor's dtype, shape and ``data_offsets``, then the raw bytes);
  * ``pytorch_model.bin`` with ``torch.load(weights_only=True)``;
  * the sharded form of either, through its ``*.index.json``.

:func:`load_pretrained` then gives what ``from_pretrained(...).state_dict()``
gives where the converters can tell: floating tensors in float32 (its
default dtype; a bf16 file is upcast), and a tied head's
``lm_head.weight`` (a tied Llama file has none). The converters try the
base-model prefixes (``model.``, ``vision_model.``, ``hubert.``,
``resnet.``, ``efficientnet.``) through :class:`Prefixed`, and both names of the weight-normed positional conv
themselves.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Any

import torch

# safetensors dtype names -> torch: the weights' float types, and int64 for
# the position-id buffers some older checkpoints carry
_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64}

_WEIGHT_FILES = ("model.safetensors", "model.safetensors.index.json",
                 "pytorch_model.bin", "pytorch_model.bin.index.json")


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU, in the file's
    dtypes. The tensors share one buffer holding the file's data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: file ends before its data")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which "
                             f"this reader does not know")
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        size = torch.empty((), dtype=dtype).element_size()
        if (end - start) % size or not 0 <= start <= end <= len(data):
            raise ValueError(f"{path}: {name} has data_offsets {start}, {end}")
        t = (torch.frombuffer(data, dtype=dtype, count=(end - start) // size,
                              offset=start) if end > start else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"])
    return out


def _read_file(path: Path) -> dict[str, torch.Tensor]:
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def read_weights(directory: str | Path) -> dict[str, torch.Tensor]:
    """The state dict of an HF directory as its files hold it: one
    ``model.safetensors`` or ``pytorch_model.bin``, or the shards an
    ``*.index.json`` names (safetensors first, as ``from_pretrained``
    prefers them)."""
    d = Path(directory)
    for name in _WEIGHT_FILES:
        path = d / name
        if not path.exists():
            continue
        if not name.endswith(".index.json"):
            return _read_file(path)
        shards = sorted(set(json.loads(path.read_text())["weight_map"].values()))
        out: dict[str, torch.Tensor] = {}
        for shard in shards:
            out.update(_read_file(d / shard))
        return out
    raise FileNotFoundError(f"{d}: no {' / '.join(_WEIGHT_FILES)}")


def load_pretrained(directory: str | Path, device: str | torch.device = "cpu"
                    ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """(state dict on ``device``, config.json) of an HF directory, as the
    JAX package gets them from ``from_pretrained``: floating tensors in
    float32 (cast on ``device``, so a bf16 file crosses the link at half
    the bytes), and a tied model's ``lm_head.weight`` filled from
    ``model.embed_tokens``."""
    config = json.loads((Path(directory) / "config.json").read_text())
    sd = {k: v.to(device).float() if v.is_floating_point() else v.to(device)
          for k, v in read_weights(directory).items()}
    if (config.get("tie_word_embeddings") and "lm_head.weight" not in sd
            and "model.embed_tokens.weight" in sd):
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    return sd, config


class Prefixed:
    """A state dict whose keys may carry a base-model prefix: each name is
    looked up under the first of ``prefixes`` (``""`` for none) that holds
    it. ``arr`` copies one tensor; ``lin`` reads a dense layer, its weight
    ``[out, in]`` transposed to the port's ``[in, out]``; ``ln`` a layer
    norm."""

    def __init__(self, state_dict: dict[str, Any], prefixes: tuple[str, ...]) -> None:
        self.sd, self.prefixes = state_dict, prefixes

    def key(self, name: str) -> str | None:
        for prefix in self.prefixes:
            if prefix + name in self.sd:
                return prefix + name
        return None

    def arr(self, name: str) -> torch.Tensor:
        k = self.key(name)
        if k is None:
            raise KeyError(f"missing weight {name!r}")
        return self.sd[k].detach().clone()

    def lin(self, name: str, bias: bool = True) -> dict[str, torch.Tensor]:
        p = {"w": self.arr(name + ".weight").T.contiguous()}
        if bias:
            p["b"] = self.arr(name + ".bias")
        return p

    def ln(self, name: str) -> dict[str, torch.Tensor]:
        return {"scale": self.arr(name + ".weight"), "b": self.arr(name + ".bias")}
