"""The port's launch layer (repro_torch.launch: mesh, steps, dryrun) on the
CPU.

* Meshes: each creates the default process group on entry and destroys it
  on exit; nesting raises.  Every test of this file, and of
  test_torch_sharding.py and test_torch_roofline.py, starts and ends with
  no default group, the CPU as the default device and no dispatch or
  function mode active (the files share their worker with other files).
* Dry run: every arch's smoke config at the JAX launch tests' shapes
  (64 x 4) on both production meshes: a full record, with the counted
  FLOPs within [0.5, 30] x MODEL_FLOPS (tests/test_launch.py's bounds);
  whisper-base x long_500k skipped; full-width qwen3-0.6b x decode_32k,
  whose argument bytes are the shards JAX's specs imply.
* Bundles on ``make_host_mesh("cpu")``: prefill, decode and train steps
  against the JAX model's ``prefill``, ``decode_step`` and ``loss`` +
  ``adamw_update`` on the same converted weights, to the tolerances of
  tests/test_torch_model.py and tests/test_torch_train.py.
* ``chip_smoke.phase_launch`` at a smoke config on the CPU: its checks and
  launch accounting hold.
"""
from __future__ import annotations

import importlib.util
import math
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import Model as JModel
from repro.models.sharding import cache_specs as jax_cache_specs
from repro.models.sharding import param_specs as jax_param_specs
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_update as jadamw_update
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import caches_from_jax, params_from_jax, params_to_jax
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import build_bundle
from repro_torch.models import InputShape
from repro_torch.roofline import model_flops

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_model.py
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4  # tests/test_torch_train.py
ADAMW_TOL = dict(rtol=1e-6, atol=1e-7)  # float32, tests/test_torch_train.py
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "kind", "status", "trace_s", "count_method",
               "flops_total", "bytes_accessed", "collective_method", "collective_bytes",
               "collective_breakdown", "memory", "param_count", "active_param_count",
               "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes"}


@pytest.fixture(autouse=True)
def clean_process_state():
    """No default process group, the CPU as default device and no dispatch
    or function mode, before and after the test."""
    def check(when):
        assert not dist.is_initialized(), f"a default process group exists {when} the test"
        assert torch.get_default_device() == torch.device("cpu"), when
        assert torch._C._len_torch_dispatch_stack() == 0, f"a dispatch mode is on {when}"
        assert torch._C._len_torch_function_stack() == 0, f"a function mode is on {when}"

    check("before")
    yield
    check("after")


def small_shape(kind):
    """tests/test_launch.py's shapes."""
    return {
        "train": InputShape("t", 64, 4, "train"),
        "prefill": InputShape("p", 64, 4, "prefill"),
        "decode": InputShape("d", 64, 4, "decode"),
    }[kind]


# ----------------------------------------------------------------- meshes


@pytest.mark.parametrize("multi_pod,shape,world", [(False, (16, 16), 256),
                                                   (True, (2, 16, 16), 512)])
def test_production_mesh_lives_inside_its_context(multi_pod, shape, world):
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        assert dist.is_initialized() and dist.get_world_size() == world
        assert tuple(mesh.mesh.shape) == shape
        assert mesh.mesh_dim_names[-2:] == ("data", "model")
    assert not dist.is_initialized()


def test_host_mesh_on_the_cpu():
    with make_host_mesh("cpu") as mesh:
        assert dist.get_world_size() == 1
        assert tuple(mesh.mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    assert not dist.is_initialized()


def test_meshes_do_not_nest():
    with make_production_mesh():
        with pytest.raises(RuntimeError, match="process group exists"):
            with make_host_mesh("cpu"):
                pass
        with pytest.raises(RuntimeError, match="process group exists"):
            with make_production_mesh(multi_pod=True):
                pass
        assert dist.get_world_size() == 256
    assert not dist.is_initialized()


def test_importing_the_dry_run_sets_nothing():
    assert "512" not in os.environ.get("XLA_FLAGS", "")
    assert not dist.is_initialized()
    assert dryrun.RESULTS_DIR.parts[-2:] == ("results", "dryrun_torch")


# ----------------------------------------------------------------- dry run


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dry_run_of_each_smoke_config_on_both_meshes(arch):
    cfg = get_smoke_config(arch)
    for kind in ("train", "prefill", "decode"):
        shape, counted = small_shape(kind), None
        for multi_pod in (False, True):
            with make_production_mesh(multi_pod=multi_pod) as mesh:
                rec, counted = dryrun.dry_run(cfg, shape, mesh, arch=arch, shape_name=shape.name,
                                              mesh_name=dryrun._mesh_name(multi_pod),
                                              counted=counted)
            assert set(rec) == RECORD_KEYS and set(rec["memory"]) == MEMORY_KEYS
            assert rec["status"] == "ok" and rec["chips"] == (512 if multi_pod else 256)
            assert rec["collective_method"] == "placement rule"
            mf = model_flops(cfg, shape)
            assert 0.5 * mf < rec["flops_total"] * rec["chips"] < 30 * mf, (kind, rec, mf)
            assert rec["bytes_accessed"] > 0 and rec["memory"]["argument_bytes"] > 0
            mem = rec["memory"]
            assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                         + mem["temp_bytes"] - mem["alias_bytes"])
            assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
            if kind == "train":
                assert set(rec["collective_breakdown"]) >= {"all-gather", "reduce-scatter"}


def test_dry_run_skips_whisper_at_long_500k():
    rec = dryrun.run_one("whisper-base", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and rec["mesh"] == "16x16"
    assert not dist.is_initialized()


def _shard_bytes(tree, specs, sizes):
    """Bytes per device of a JAX (shape) tree under its PartitionSpec tree."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves, strict=True):
        split = math.prod(sizes[a] for e in spec if e is not None
                          for a in (e if isinstance(e, tuple) else (e,)))
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // split
    return total


def test_full_width_decode_record_argument_bytes_are_jaxs_shards():
    rec = dryrun.run_one("qwen3-0.6b", "decode_32k", verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 256
    sizes = {"data": 16, "model": 16}
    mesh = AbstractMesh((16, 16), ("data", "model"))
    jm = JModel(jax_get_config("qwen3-0.6b"))
    b, s = 128, 32768
    params = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
    caches = jax.eval_shape(lambda: jm.init_caches(b, s))
    want = (_shard_bytes(params, jax_param_specs(params, mesh), sizes)
            + _shard_bytes(caches, jax_cache_specs(caches, mesh, b), sizes)
            + b * 4 // 16 + b * 4 // 16)  # token [B, 1] and cache_len [B], int32 over "data"
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["alias_bytes"] == _shard_bytes(caches, jax_cache_specs(caches, mesh, b),
                                                        sizes)


# ----------------------------------------------------------------- bundles


def _loaded_bundle(arch, shape, mesh):
    jm = JModel(jax_smoke_config(arch))
    params = jm.init_params(jax.random.PRNGKey(0))
    bundle = build_bundle(get_smoke_config(arch), shape, mesh, device="cpu")
    bundle.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), bundle.cfg))
    return jm, params, bundle


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-v0.1-52b"])
def test_serving_bundles_on_the_host_mesh_match_jax(arch):
    b, s = 2, 16
    toks = np.random.default_rng(1).integers(0, 256, (b, s)).astype(np.int32)
    with make_host_mesh("cpu") as mesh:
        jm, params, pre = _loaded_bundle(arch, InputShape("p", s, b, "prefill"), mesh)
        assert pre.kind == "prefill" and pre.donate_argnums == (2,)
        pre.args[1].copy_(torch.as_tensor(toks))
        logits, caches = pre.step_fn(*pre.args)
        prefill = jax.jit(jm.prefill)
        jl, jc, _ = prefill(params, jnp.asarray(toks), jm.init_caches(b, s))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        for got, want in zip(caches, caches_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                                                     pre.cfg)):
            for key in want:
                for g, w in zip(got[key], want[key]):
                    np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)

        # decode: one token against the caches the JAX prefill filled
        dec = build_bundle(pre.cfg, InputShape("d", s, b, "decode"), mesh, device="cpu")
        dec.model.load_state_dict(pre.model.state_dict())
        _, token, dcaches, cache_len = dec.args
        _, jc2, _ = prefill(params, jnp.asarray(toks[:, :-1]), jm.init_caches(b, s))
        for mine, filled in zip(dcaches, caches_from_jax(
                jax.tree_util.tree_map(np.asarray, jc2), pre.cfg)):
            for key in mine:
                for m, f in zip(mine[key], filled[key]):
                    m.copy_(f)
        token.copy_(torch.as_tensor(toks[:, -1:]))
        cache_len.fill_(s - 1)
        logits, _ = dec.step_fn(*dec.args)
        jl, _ = jax.jit(jm.decode_step)(params, jnp.asarray(toks[:, -1:]), jc2,
                                        jnp.full((b,), s - 1, jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        assert dec.donate_argnums == (2,) and len(dec.in_shardings) == 4
    assert not dist.is_initialized()


def _grads_model(model):
    """A stand-in for ``model`` whose parameters are its gradients."""
    return types.SimpleNamespace(cfg=model.cfg, named_parameters=lambda: [
        (n, torch.zeros_like(p) if p.grad is None else p.grad)
        for n, p in model.named_parameters()])


@pytest.mark.parametrize("arch", ["qwen3-0.6b"])
def test_train_bundle_on_the_host_mesh_matches_jax(arch):
    """Loss and gradients as ``jax.value_and_grad(Model.loss)``, and the
    update as JAX's ``adamw_update`` applied to the same gradients."""
    b, s = 2, 16
    rng = np.random.default_rng(2)
    tokens, labels = (rng.integers(0, 256, (b, s)).astype(np.int32) for _ in range(2))
    with make_host_mesh("cpu") as mesh:
        jm, params, bundle = _loaded_bundle(arch, InputShape("t", s, b, "train"), mesh)
        assert bundle.kind == "train" and bundle.donate_argnums == (0, 1)
        bundle.args[2].copy_(torch.as_tensor(tokens))
        bundle.args[3].copy_(torch.as_tensor(labels))
        out_params, opt_state, loss, metrics = bundle.step_fn(*bundle.args)
    assert out_params is bundle.args[0]
    want_loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tokens), jnp.asarray(labels))))(params)
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    model = bundle.model
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), model.cfg)
    for name, g in dict(_grads_model(model).named_parameters()).items():
        err = (g - want[name]).abs().max().item()
        assert err <= GRAD_TOL * want[name].abs().max().item(), (name, err)
    grads = jax.tree_util.tree_map(jnp.asarray, params_to_jax(_grads_model(model)))
    new, jopt, jmetrics = jax.jit(jadamw_update, static_argnums=0)(
        JAdamWConfig(), params, grads, jinit_opt_state(params))
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=1e-5)
    assert int(opt_state.step) == int(jopt.step) == 1
    for name, p in params_from_jax(jax.tree_util.tree_map(np.asarray, new), model.cfg).items():
        torch.testing.assert_close(dict(model.named_parameters())[name].detach(), p,
                                   **ADAMW_TOL)


# ------------------------------------------------------- chip_smoke's phase


def test_chip_smoke_launch_phase_on_the_cpu(monkeypatch):
    """``phase_launch`` at qwen3-0.6b's smoke config on the CPU, its kernel
    counters fed by the wrappers' calls (the CPU runs the plain versions):
    the bundles' logits bit-equal to the model's, the launches the
    script's accounting, the train losses finite with no kernel call."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, value in (("BATCH", 2), ("PROMPT", 16), ("MAX_CONTEXT", 32),
                        ("LAUNCH_TRAIN_STEPS", 2)):
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "LAUNCH", {"train": 32, "prefill": 16, "decode": 32})
    counters = {n: types.SimpleNamespace(launches=0)
                for n in ("persistent_matmul", "flash_attention", "selective_scan")}

    def zeroed():
        for c in counters.values():
            c.launches = 0
        return counters

    def counting(name, fn):
        def call(*args, **kw):
            counters[name].launches += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(smoke, "zeroed_counters", zeroed)
    monkeypatch.setattr(ops, "pinned_matmul", counting("persistent_matmul", ops.pinned_matmul))
    monkeypatch.setattr(ops, "mha_flash", counting("flash_attention", ops.mha_flash))
    monkeypatch.setattr(smoke, "eager_ms", lambda fn, iters=20: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "_events_ms", lambda run, count: (run(), 1.0)[1])
    out = smoke.phase_launch("cpu", cfg=get_smoke_config("qwen3-0.6b"), device="cpu")
    assert set(out) == {"train", "prefill", "decode", "seconds"}
    assert out["prefill"]["launches"]["flash_attention"] == 2
    assert out["decode"]["launches"]["persistent_matmul"] == 14
    assert len(out["train"]["losses"]) == 2
    assert all(out[k]["bound_ms"] > 0 for k in ("train", "prefill", "decode"))
