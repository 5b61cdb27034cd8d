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

The other way, :func:`jax_layout` lays the port's parameter names out as
the JAX tree (layers stacked per pattern position again), which
:func:`jax_leaves` flattens in JAX's leaf order (dict keys sorted) and
:func:`jax_treedef` prints as ``str`` of JAX's treedef does: the optimizer
and the checkpoint walk parameters in that order, and
:func:`params_to_jax` gives the JAX package a model's parameters.
"""
from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.mamba import MambaState
from repro_torch.models.xlstm import MLstmState, SLstmState

__all__ = ["params_from_jax", "caches_from_jax", "jax_layout", "jax_leaves", "jax_treedef",
           "params_to_jax"]


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


def jax_layout(names: Iterable[str], cfg) -> dict:
    """The JAX parameter tree over the port's parameter names (in layer
    order, as ``named_parameters`` gives them): each leaf a name, or for a
    leaf stacked over layers (``layers``: one dict per pattern position;
    ``encoder.layers``) the list of its layers' names, repeat by repeat."""
    tree: dict = {}
    n_pos = len(cfg.pattern)
    layers: list = [{} for _ in range(n_pos)]
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            _insert(layers[int(parts[1]) % n_pos], parts[2:], name, stacked=True)
        elif parts[:2] == ["encoder", "layers"]:
            enc_layers = tree.setdefault("encoder", {}).setdefault("layers", {})
            _insert(enc_layers, parts[3:], name, stacked=True)
        else:
            _insert(tree, parts, name, stacked=False)
    tree["layers"] = tuple(layers)
    return tree


def _insert(tree: dict, path: list, name: str, stacked: bool) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    if stacked:
        tree.setdefault(path[-1], []).append(name)
    else:
        tree[path[-1]] = name


def jax_leaves(tree) -> list:
    """The leaves of a :func:`jax_layout` tree in JAX's flattening order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in jax_leaves(tree[key])]
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in jax_leaves(sub)]
    return [tree]


def _render(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_render(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_render(t) for t in tree) + ("," if len(tree) == 1 else "") + ")"
    return "*"


def jax_treedef(tree, namedtuple: str = "") -> str:
    """``str`` of the JAX treedef of a :func:`jax_layout` tree; with
    ``namedtuple`` (e.g. ``"OptState"``), of that NamedTuple of two such
    trees and a scalar leaf (the optimizer state's m, v and step)."""
    body = _render(tree)
    if namedtuple:
        body = f"CustomNode(namedtuple[{namedtuple}], [{body}, {body}, *])"
    return f"PyTreeDef({body})"


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:  # numpy has the dtype only once ml_dtypes is imported
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def params_to_jax(model) -> dict:
    """The JAX package's parameter tree (nested dicts and tuples of numpy
    arrays, layers stacked per pattern position) of a port ``Model``: the
    inverse of :func:`params_from_jax`.  bf16 leaves need numpy's bfloat16
    dtype, which importing ``ml_dtypes`` (the JAX package does) registers."""
    params = dict(model.named_parameters())

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(build(t) for t in tree)
        if isinstance(tree, list):
            return np.stack([_numpy(params[n]) for n in tree])
        return _numpy(params[tree])

    return build(jax_layout(params, model.cfg))
