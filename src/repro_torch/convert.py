"""Carry the JAX package's parameters and KV caches into the port.

Input is the JAX tree as nested dicts/tuples of numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, params)``).  Two JAX layouts are kept:

* weights stay ``[d_in, d_out]`` and are applied as ``x @ w`` — nothing is
  transposed into ``nn.Linear``'s layout;
* layer parameters stacked ``[n_repeats, ...]`` per pattern position are
  unstacked: layer ``r * len(pattern) + pos`` takes slice ``r`` of
  position ``pos`` (Mamba and MoE leaves too: an expert tensor
  ``[n_repeats, E, d, f]`` becomes ``[E, d, f]``).

Every leaf carries over under its own name, so tied embeddings (no
``lm_head``), LayerNorm's ``b`` and the non-parametric norm's placeholder
``np`` need nothing of their own.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.mamba import MambaState

__all__ = ["params_from_jax", "caches_from_jax"]


def _flatten(tree: Mapping[str, Any], prefix: str, out: dict) -> None:
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            _flatten(value, key + ".", out)
        else:
            out[key] = np.asarray(value)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy cannot take it
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def params_from_jax(params: Mapping[str, Any], cfg, device="cpu") -> dict[str, torch.Tensor]:
    """A state dict for :class:`repro_torch.models.Model` from JAX params."""
    flat: dict[str, np.ndarray] = {}
    _flatten({k: v for k, v in params.items() if k != "layers"}, "", flat)
    n_pos = len(cfg.pattern)
    for pos, stacked in enumerate(params["layers"]):
        per_pos: dict[str, np.ndarray] = {}
        _flatten(stacked, "", per_pos)
        for r in range(cfg.n_repeats):
            layer = r * n_pos + pos
            for key, value in per_pos.items():
                flat[f"layers.{layer}.{key}"] = value[r]
    return {k: _tensor(v, device) for k, v in flat.items()}


def caches_from_jax(caches, cfg, device="cpu") -> list[dict]:
    """Per-layer ``{"kv": KVCache}`` or ``{"ssm": MambaState}`` from the JAX
    caches (a tuple over pattern positions of such dicts stacked over
    repeats)."""
    n_pos = len(cfg.pattern)
    out: list = [None] * cfg.n_layers
    for pos, stacked in enumerate(caches):
        (key, state), = stacked.items()
        kind = KVCache if key == "kv" else MambaState
        leaves = [np.asarray(a) for a in state]
        for r in range(cfg.n_repeats):
            out[r * n_pos + pos] = {key: kind(*(_tensor(a[r], device) for a in leaves))}
    return out
