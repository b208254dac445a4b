"""Modality connectors, the port of ``avsr_tpu/models/connectors.py``.

Only ``simple`` (one linear layer, xavier init) is ported; it is the
flagship connector. ``get_connector`` keeps the JAX package's lookup by
name and raises for the connector types that are still to be ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from avsr_tpu_torch.core.config import CONNECTOR_TYPES, ModelConfig
from avsr_tpu_torch.models.layers import Params, dense, dense_init


class ConnectorDef(NamedTuple):
    init: Callable[..., Params]
    apply: Callable[..., tuple[torch.Tensor, torch.Tensor]]


def _ident_lens(x: torch.Tensor, lengths: torch.Tensor | None) -> torch.Tensor:
    if lengths is not None:
        return lengths
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                      device=x.device)


def simple_init(gen: torch.Generator, d_in: int, d_out: int, cfg: ModelConfig,
                dtype: torch.dtype = torch.float32) -> Params:
    del cfg
    return {"out": dense_init(gen, d_in, d_out, dtype=dtype)}


def simple_apply(p: Params, x: torch.Tensor, lengths=None, **_):
    return dense(p["out"], x), _ident_lens(x, lengths)


_CONNECTORS = {"simple": ConnectorDef(simple_init, simple_apply)}


def get_connector(name: str) -> ConnectorDef:
    if name in _CONNECTORS:
        return _CONNECTORS[name]
    if name in CONNECTOR_TYPES:
        raise NotImplementedError(
            f"connector {name!r} is not yet ported to avsr_tpu_torch "
            f"(ported: {sorted(_CONNECTORS)})")
    raise KeyError(f"Unknown connector {name!r}; valid: {list(CONNECTOR_TYPES)}")
