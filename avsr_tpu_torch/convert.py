"""Parameter trees between the JAX package's layout and torch tensors.

The port keeps the JAX package's parameter trees: nested dicts and lists
with the same key paths, dense kernels ``[d_in, d_out]``, conv kernels
``[C_out, C_in, K]``. So a tree exported from the JAX side (numpy leaves)
loads here leaf for leaf, and the parity tests hand the same weights to
both packages.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def from_numpy_tree(tree: Any, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> Any:
    """Nested dicts/lists of numpy-compatible arrays -> the same tree of
    tensors on ``device``.

    Floating leaves are cast to ``dtype`` here, once, so that no apply
    function has to cast a weight per call (the JAX ``embed_tokens`` casts
    the whole 128256 x 2048 table on every call, which XLA folds away but
    eager PyTorch would copy every token). Integer leaves keep their type.
    bfloat16 arrays (``ml_dtypes``) are accepted."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy_tree(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    if not arr.flags.writeable:   # e.g. a view of a JAX array's buffer
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy_tree(tree: Any) -> Any:
    """The reverse of :func:`from_numpy_tree`: tensors -> numpy on the host.
    bfloat16 leaves come back as float32 (numpy has no bfloat16 of its
    own); every bfloat16 value is exact in float32."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating leaf to ``dtype`` (integer leaves untouched)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def param_count(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_count(v) for v in tree)
    return tree.numel()
