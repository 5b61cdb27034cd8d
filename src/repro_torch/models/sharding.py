"""Sharding rules: parameters, caches and batches -> partition specs.

Counterpart of ``repro.models.sharding``, rule for rule.  A spec is a tuple
with one entry per tensor dim: a mesh-axis name, a tuple of them (the
batch over ``("pod", "data")``) or None (the ``PartitionSpec``
counterpart); ``to_shardings`` turns specs into DTensor placements.

Scheme (MaxText-style logical rules, as the JAX package's):
  * tensor-parallel dims (heads, d_ff, vocab, experts, d_inner) -> "model"
  * the other matmul dim -> "data" (FSDP / weight-gathered serving)
  * batch -> ("pod", "data") multi-pod, ("data",) single-pod
  * decode KV-cache sequence dim -> "model" (context parallelism)
  * any dim not divisible by its mesh axis size falls back to replication

The rules read the JAX parameter tree's paths.  The port's parameters are
per layer, so :func:`param_specs` lays them out as the JAX tree
(``convert.jax_layout``: one leaf per pattern position stacked over
repeats), takes each stacked leaf's spec with its leading repeats dim, and
gives each layer's tensor that spec without the leading None.  A mesh is
a ``DeviceMesh`` or a mapping of axis name to size: the rules read only
the sizes.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np

from repro_torch.convert import jax_layout

__all__ = ["param_specs", "input_specs_train", "cache_specs", "batch_spec",
           "to_shardings", "axis_sizes"]


# leaf-name -> (logical axes per dim), applied to the trailing dims
# (a leading stacked "repeats"/"layers" dim is auto-detected and unsharded).
_RULES: dict[str, tuple[Optional[str], ...]] = {
    # embeddings / head: [vocab, d_model]
    "embed/w": ("model", "data"),
    "lm_head/w": ("model", "data"),
    # attention
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "q_norm": (None,),
    "k_norm": (None,),
    # mlp
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    # moe (leading expert dim)
    "ffn/w_gate": ("expert", "data", "model"),
    "ffn/w_up": ("expert", "data", "model"),
    "ffn/w_down": ("expert", "model", "data"),
    "router": ("data", None),
    # mamba
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "dt_bias": ("model",),
    "a_log": ("model", None),
    "d_skip": ("model",),
    # xlstm
    "up_proj": ("data", "model"),
    "down_proj": ("model", "data"),
    "w_gates": (None, "model"),
    "r_gates": (None, "model"),
    "b_gates": ("model",),
    "w_if": (None, None),
    "b_if": (None,),
    "out_norm": (None,),
}

_LOGICAL_TO_MESH = {"model": "model", "expert": "model", "data": "data"}

Spec = tuple
MeshLike = Union[Mapping[str, int], Any]


def axis_sizes(mesh: MeshLike) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _spec_for(path: str, shape: tuple[int, ...], sizes: Mapping[str, int]) -> Spec:
    """Pick the most specific rule whose arity matches the leaf.

    Params under a stacked "layers/" tree carry exactly one leading repeats
    dim; the rule must cover the remaining dims exactly — this is what keeps
    the expert rules (3 trailing dims) from grabbing non-MoE stacked
    [repeats, d, f] weights."""
    ndim = len(shape)
    lead = 1 if ("layers/" in path) else 0
    candidates = [
        _RULES[name]
        for name in sorted(_RULES, key=len, reverse=True)
        if path.endswith(name)
    ]
    tail = path.split("/")[-1]
    if tail in _RULES and _RULES[tail] not in candidates:
        candidates.append(_RULES[tail])
    rule = next((r for r in candidates if len(r) == ndim - lead), None)
    if rule is None:
        # fall back to any rule that fits with non-negative lead
        rule = next((r for r in candidates if len(r) <= ndim), None)
        if rule is None:
            return ()  # replicate (norms, scalars)
        lead = ndim - len(rule)
    axes: list[Optional[str]] = [None] * lead
    used: set[str] = set()
    for dim_size, logical in zip(shape[lead:], rule):
        mesh_axis = _LOGICAL_TO_MESH.get(logical) if logical else None
        if (
            mesh_axis is not None
            and mesh_axis in sizes
            and mesh_axis not in used
            and dim_size % sizes[mesh_axis] == 0
        ):
            axes.append(mesh_axis)
            used.add(mesh_axis)
        else:
            axes.append(None)
    return tuple(axes)


def _stacked(tree, path: str, shapes: Mapping[str, tuple], out: dict) -> None:
    """(path, stacked shape, names) of every leaf of a ``jax_layout`` tree."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _stacked(sub, f"{path}{key}/", shapes, out)
    elif isinstance(tree, tuple):
        for i, sub in enumerate(tree):
            _stacked(sub, f"{path}{i}/", shapes, out)
    elif isinstance(tree, list):  # one name per layer, stacked
        out[path[:-1]] = ((len(tree), *shapes[tree[0]]), tree)
    else:
        out[path[:-1]] = (tuple(shapes[tree]), [tree])


def param_specs(model, mesh: MeshLike) -> dict[str, Spec]:
    """Parameter name -> spec, for every parameter of a port ``Model``.

    Each stacked JAX leaf's spec; a layer's tensor takes it without the
    leading repeats dim."""
    sizes = axis_sizes(mesh)
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    leaves: dict = {}
    _stacked(jax_layout(shapes, model.cfg), "", shapes, leaves)
    specs = {}
    for path, (shape, names) in leaves.items():
        spec = _spec_for(path, shape, sizes) if shape else ()
        if len(names) > 1 or "layers/" in path:
            spec = spec[1:]
        for name in names:
            specs[name] = spec
    return specs


def batch_spec(mesh: MeshLike) -> tuple:
    """Mesh axes used for the batch dim."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _entry(axes: tuple):
    """One dim's entry for ``axes``: a lone axis by its name, as
    ``PartitionSpec`` normalises it."""
    return axes[0] if len(axes) == 1 else axes


def batch_axes(mesh: MeshLike, batch: int):
    """The batch dim's entry: the data axes where they divide ``batch``,
    else "data" alone where it does, else None (replicated)."""
    sizes = axis_sizes(mesh)
    bs = batch_spec(sizes)
    dp = int(np.prod([sizes[a] for a in bs]))
    if batch % dp == 0:
        return _entry(bs)
    return "data" if batch % sizes["data"] == 0 else None


def input_specs_train(mesh: MeshLike) -> Spec:
    """tokens/labels [B, S]."""
    return (_entry(batch_spec(mesh)), None)


def cache_specs(caches: list, cfg, mesh: MeshLike, batch: int) -> list:
    """Decode caches: batch -> data axes; KV sequence dim -> model axis.

    Per layer, the cache's structure (dicts of NamedTuples) with a spec per
    tensor, from JAX's rule over the stacked leaf [repeats, B, ...] (the
    layer's tensor takes it without the leading None)."""
    sizes = axis_sizes(mesh)
    b_ax = batch_axes(sizes, batch)
    n_pos = len(cfg.pattern)

    def leaf_spec(path: str, shape: tuple) -> Spec:
        shape = (cfg.n_repeats, *shape)
        axes: list[Any] = [None] * len(shape)
        if len(shape) >= 2:
            axes[1] = b_ax  # [repeats, B, ...]
        if "kv/" in path or path.endswith("/k") or path.endswith("/v"):
            # [repeats, B, S, kvH, hd]: context-parallel sequence dim
            if len(shape) == 5 and shape[2] % sizes["model"] == 0:
                axes[2] = "model"
        elif len(shape) >= 3:
            # recurrent states: shard the widest trailing dim over model
            widths = list(shape[2:])
            j = 2 + int(np.argmax(widths))
            if shape[j] % sizes["model"] == 0 and shape[j] >= sizes["model"]:
                axes[j] = "model"
        return tuple(axes[1:])

    return [
        {key: type(state)(*(leaf_spec(f"{i % n_pos}/{key}/.{field}", tuple(t.shape))
                            for field, t in zip(state._fields, state)))
         for key, state in cache.items()}
        for i, cache in enumerate(caches)
    ]


def to_shardings(specs: Any, mesh) -> Any:
    """Each spec of a (nested dict, list or NamedTuple) tree as DTensor
    placements over ``mesh``: per mesh dim, ``Shard(i)`` where tensor dim
    i is sharded over it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names

    def placements(spec: Spec) -> tuple:
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    out[names.index(axis)] = Shard(dim)
        return tuple(out)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if hasattr(tree, "_fields"):  # a NamedTuple of subtrees; a spec is a plain tuple
            return type(tree)(*(walk(v) for v in tree))
        return placements(tree)

    return walk(specs)
