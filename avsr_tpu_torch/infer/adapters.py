"""Multi-tenant LoRA adapters for serving, the port of
``avsr_tpu/infer/adapters.py``.

One resident base model serves K fine-tunes: every request picks its
adapter, and adapters mix freely within a decode batch.

An *adapter* is the LLM params tree filtered down to its ``{"lora": {"a",
"b"}}`` leaves (the nesting kept, list positions held by ``None``); a
*bank* stacks K adapters leaf-wise to ``[K, ...]`` tensors. Per-request
selection is one index per leaf (``select_lora``), and :func:`inject_lora`
grafts the gathered ``[B, din, r]`` / ``[B, r, dout]`` leaves into the base
tree, where ``models/llama.py::proj`` applies them row by row. Each row's
numbers stay independent of the other rows, so the engine's
per-request exactness holds per tenant.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from avsr_tpu_torch.models.layers import Params


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of ``tree`` (and the same positions of
    ``rest``), keeping dicts, lists and ``None`` placeholders."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree: Any) -> list[torch.Tensor]:
    """The tensor leaves of a tree, in walk order."""
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def structure(tree: Any) -> Any:
    """The nesting of a tree with its leaves erased: what two adapters
    must share (``jax.tree.structure``'s role)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return tuple((k, structure(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return ("list", tuple(structure(v) for v in tree))
    return "*"


def extract_lora(llm: Params) -> Params:
    """Filter an LLM params tree down to its LoRA leaves.

    Returns the same dict/list nesting with only ``{"lora": {"a", "b"}}``
    subtrees kept (list positions are preserved with ``None`` placeholders
    so layer indices stay aligned for :func:`inject_lora`). Raises if the
    tree carries no LoRA at all — e.g. a merged decode tree, which cannot
    anchor an adapter bank."""

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "lora" and isinstance(v, dict) and "a" in v:
                    out[k] = {"a": v["a"], "b": v["b"]}
                elif isinstance(v, (dict, list)):
                    sub = walk(v)
                    if sub is not None:
                        out[k] = sub
            return out or None
        if isinstance(node, list):
            subs = [walk(v) for v in node]
            return subs if any(s is not None for s in subs) else None
        return None

    tree = walk(llm)
    if tree is None:
        raise ValueError(
            "params carry no lora leaves (merged or lora-free tree) — "
            "multi-adapter serving needs the unmerged base "
            "(model.lora.use_lora=true, init/convert without merge_lora)")
    return tree


def random_adapter_like(adapter: Params, generator: torch.Generator,
                        std: float = 0.02) -> Params:
    """A random adapter (testing/benchmarks: makes every bank row bite),
    each leaf ``std`` times standard normals drawn from ``generator`` (on
    the leaves' device) in walk order."""
    return tree_map(lambda x: std * torch.randn(x.shape, generator=generator,
                                            device=x.device, dtype=x.dtype),
                adapter)


def stack_lora_bank(adapters: list[Params]) -> Params:
    """K structure-identical adapters -> one bank with ``[K, ...]`` leaves.

    All adapters must share the base model's LoRA geometry (same r — the
    stack itself enforces shape agreement loudly)."""
    if not adapters:
        raise ValueError("adapter bank needs at least one adapter")
    return tree_map(lambda *xs: torch.stack(xs), *adapters)


def bank_size(bank: Params) -> int:
    return int(leaves(bank)[0].shape[0])


def select_lora(bank: Params, ids: torch.Tensor | int) -> Params:
    """Gather per-row adapters: ``[K, ...]`` bank + ``[B]`` ids ->
    ``[B, ...]`` leaves (an int id gives one adapter's own leaves)."""
    return tree_map(lambda x: x[ids], bank)


def inject_lora(llm: Params, sel: Params | None) -> Params:
    """Graft (possibly row-batched) LoRA subtrees onto a base LLM tree.

    ``sel`` mirrors :func:`extract_lora`'s structure; wherever it holds a
    ``lora`` entry the returned tree carries it (replacing any resident
    adapter). Tree surgery only — no copies of base weights."""
    if sel is None:
        return llm

    def walk(p, s):
        if s is None:
            return p
        if isinstance(p, dict):
            out = dict(p)
            for k, sv in s.items():
                out[k] = sv if k == "lora" else walk(p[k], sv)
            return out
        if isinstance(p, list):
            if len(s) != len(p):
                raise ValueError(
                    f"adapter layer count {len(s)} != model's {len(p)} "
                    "(adapter extracted from a different config?)")
            return [walk(pv, sv) for pv, sv in zip(p, s)]
        return p

    return walk(llm, sel)
