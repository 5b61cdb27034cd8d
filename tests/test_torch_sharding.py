"""The port's sharding rules and step inputs (repro_torch.models.sharding,
repro_torch.launch.steps.input_specs) against the JAX package's, at full
width, on the CPU.

JAX's rules run on ``jax.eval_shape`` trees against an ``AbstractMesh``
(no devices); the port's on a full-width ``Model`` on the meta device
against the mesh's axis sizes.  Every spec must be equal, leaf by leaf: a
stacked JAX leaf's spec without its leading repeats dim for each of the
port's per-layer tensors.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import get_config as jax_get_config
from repro.configs import shape_config as jax_shape_config
from repro.launch.steps import input_specs as jax_input_specs
from repro.models import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.models import Model as JModel
from repro.models.sharding import _path_str
from repro.models.sharding import cache_specs as jax_cache_specs
from repro.models.sharding import param_specs as jax_param_specs
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, shape_config
from repro_torch.convert import jax_layout
from repro_torch.launch.steps import input_specs
from repro_torch.models import Model
from repro_torch.models.sharding import (batch_spec, cache_specs, input_specs_train,
                                         param_specs)
from test_torch_launch import clean_process_state  # noqa: F401  (autouse fixture)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SUPPORTED = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES if shape_config(a, s) is not None]


def _abstract(mesh_name):
    return AbstractMesh(*MESHES[mesh_name])


def _sizes(mesh_name):
    shape, names = MESHES[mesh_name]
    return dict(zip(names, shape))


def _spec(p) -> tuple:
    return tuple(p)


def _is_spec(x):
    return isinstance(x, PartitionSpec)


def _layout_paths(tree, path=""):
    """JAX path -> the port's names at that leaf of a ``jax_layout`` tree."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _layout_paths(sub, f"{path}{key}/")
    elif isinstance(tree, tuple):
        for i, sub in enumerate(tree):
            yield from _layout_paths(sub, f"{path}{i}/")
    else:
        yield path[:-1], tree if isinstance(tree, list) else [tree]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax_at_full_width(arch, mesh_name):
    jm = JModel(jax_get_config(arch))
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
    want = {_path_str(p): _spec(s) for p, s in jax.tree_util.tree_flatten_with_path(
        jax_param_specs(shapes, _abstract(mesh_name)), is_leaf=_is_spec)[0]}
    model = Model(get_config(arch), device="meta")
    got = param_specs(model, _sizes(mesh_name))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(got) == sorted(names)
    paths = dict(_layout_paths(jax_layout(names, model.cfg)))
    assert sorted(paths) == sorted(want)
    for path, spec in want.items():
        for name in paths[path]:
            expect = spec[1:] if "layers/" in path else spec
            assert got[name] == expect, (path, name, got[name], spec)
    assert any("data" in s or "model" in s for s in got.values())


def _cache_leaves(cfg, caches):
    """The port's per-layer cache tensors (or specs) by (position, key, field)."""
    n_pos = len(cfg.pattern)
    out = {}
    for i, cache in enumerate(caches):
        for key, state in cache.items():
            for field, leaf in zip(state._fields, state):
                out.setdefault((i % n_pos, key, field), []).append(leaf)
    return out


def _jax_cache_leaves(tree, leaves_are=None):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaves_are)[0]:
        pos, key, field = _path_str(path).split("/")
        out[(int(pos), key, field.lstrip("."))] = leaf
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax_at_full_width(arch, mesh_name):
    for name in ("prefill_32k", "decode_32k", "long_500k"):
        jcfg, cfg = jax_shape_config(arch, name), shape_config(arch, name)
        if cfg is None:
            continue
        shape = INPUT_SHAPES[name]
        b, length = shape.global_batch, shape.seq_len + cfg.n_patches
        jm = JModel(jcfg)
        jcaches = jax.eval_shape(lambda: jm.init_caches(b, length))
        want = _jax_cache_leaves(jax_cache_specs(jcaches, _abstract(mesh_name), b), _is_spec)
        caches = Model(cfg, device="meta").init_caches(b, length)
        got = _cache_leaves(cfg, cache_specs(caches, cfg, _sizes(mesh_name), b))
        assert sorted(got) == sorted(want)
        for key, spec in want.items():
            assert all(s == _spec(spec)[1:] for s in got[key]), (name, key, got[key], spec)


def test_batch_and_train_specs():
    assert batch_spec(_sizes("16x16")) == ("data",)
    assert batch_spec(_sizes("2x16x16")) == ("pod", "data")
    assert input_specs_train(_sizes("2x16x16")) == (("pod", "data"), None)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch,shape_name", SUPPORTED)
def test_input_specs_match_jax(arch, shape_name):
    jcfg, cfg = jax_shape_config(arch, shape_name), shape_config(arch, shape_name)
    want = jax_input_specs(jcfg, JAX_INPUT_SHAPES[shape_name], JModel(jcfg))
    got = input_specs(cfg, INPUT_SHAPES[shape_name], Model(cfg, device="meta"))
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "caches":
            jleaves = _jax_cache_leaves(want[key])
            leaves = _cache_leaves(cfg, got[key])
            assert sorted(leaves) == sorted(jleaves)
            for k, jl in jleaves.items():
                assert len(leaves[k]) == cfg.n_repeats
                for t in leaves[k]:
                    assert t.device.type == "meta"
                    assert (cfg.n_repeats, *t.shape) == tuple(jl.shape), (k, t.shape, jl.shape)
                    assert _dtype_name(t.dtype) == str(jl.dtype), (k, t.dtype, jl.dtype)
            continue
        t = got[key]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[key].shape), key
        assert _dtype_name(t.dtype) == str(want[key].dtype), key


def test_unsharded_dims_fall_back_to_replication():
    """A dim that its mesh axis does not divide is replicated (the rules'
    last clause), as JAX's: whisper-base's 51,865-token vocabulary."""
    model = Model(get_config("whisper-base"), device="meta")
    specs = param_specs(model, _sizes("16x16"))
    assert model.cfg.vocab % 16 != 0
    assert specs["embed.w"] == (None, "data")
    assert np.prod(model.embed["w"].shape) > 0 and torch.device("meta") == model.device
