"""Carry the JAX package's parameters and KV caches into the port.

Input is the JAX tree as nested dicts/tuples of numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, params)``).  Two JAX layouts are kept:

* weights stay ``[d_in, d_out]`` and are applied as ``x @ w`` — nothing is
  transposed into ``nn.Linear``'s layout;
* layer parameters stacked ``[n_repeats, ...]`` per pattern position are
  unstacked: layer ``r * len(pattern) + pos`` takes slice ``r`` of
  position ``pos`` (Mamba, xLSTM and MoE leaves too: an expert tensor
  ``[n_repeats, E, d, f]`` becomes ``[E, d, f]``); the encoder's layers,
  one stack ``[n_enc_layers, ...]``, become ``encoder.layers.<i>``.

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
from repro_torch.models.xlstm import MLstmState, SLstmState

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
    _flatten({k: v for k, v in params.items() if k not in ("layers", "encoder")}, "", flat)
    n_pos = len(cfg.pattern)
    for pos, stacked in enumerate(params["layers"]):
        for r in range(cfg.n_repeats):
            _unstack(stacked, r, f"layers.{r * n_pos + pos}.", flat)
    if "encoder" in params:
        enc = params["encoder"]
        _flatten({"final_norm": enc["final_norm"]}, "encoder.", flat)
        for i in range(cfg.n_enc_layers):
            _unstack(enc["layers"], i, f"encoder.layers.{i}.", flat)
    return {k: _tensor(v, device) for k, v in flat.items()}


def _unstack(stacked: Mapping[str, Any], index: int, prefix: str, out: dict) -> None:
    """Slice ``index`` of every leaf of a stacked layer tree, under ``prefix``."""
    per_layer: dict[str, np.ndarray] = {}
    _flatten(stacked, "", per_layer)
    for key, value in per_layer.items():
        out[prefix + key] = value[index]


_STATES = {"kv": KVCache, "cross_kv": KVCache, "ssm": MambaState}


def _state_kind(key: str, n_leaves: int):
    if key == "xl":  # MLstmState (c, n, m) or SLstmState (c, n, m, h)
        return MLstmState if n_leaves == len(MLstmState._fields) else SLstmState
    return _STATES[key]


def caches_from_jax(caches, cfg, device="cpu") -> list[dict]:
    """Per-layer cache dicts (``"kv"``, ``"ssm"`` or ``"xl"``, and
    ``"cross_kv"`` beside ``"kv"`` in an encoder-decoder) from the JAX
    caches (a tuple over pattern positions of such dicts stacked over
    repeats)."""
    n_pos = len(cfg.pattern)
    out: list = [None] * cfg.n_layers
    for pos, stacked in enumerate(caches):
        for r in range(cfg.n_repeats):
            out[r * n_pos + pos] = {
                key: _state_kind(key, len(state))(*(_tensor(np.asarray(a)[r], device)
                                                     for a in state))
                for key, state in stacked.items()}
    return out
