"""The port's torch analysis engine against the port's NumPy engine, the
scalar search and the reference's JAX engine.

``grid_search_frontier(..., backend="torch:cpu")`` runs the torch engine's
lockstep fixed point on the CPU (``"torch"`` runs it on the card).  Each
oracle is held on its own: the NumPy engine to 1e-9 with identical
decisions and candidates tried, the scalar ``grid_search_dfs`` without
preemption only (batched equals scalar is red on the reference under
preemption), and the reference's ``_JaxEngine`` in a subprocess, since
selecting it flips the process-global ``jax_enable_x64``.  Task sets come
from each package's copy of the Table-1 generator on the same seeds, and
are checked to be the same sets.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import GeneratorConfig, available_backends, generate_taskset
from repro_torch.core import backend as backend_module
from repro_torch.core import rta_batch
from repro_torch.core.federated import grid_search_dfs
from repro_torch.core.rta_batch import _HpGroup, _NumpyEngine, _TorchEngine, grid_search_frontier
from repro_torch.core.workload import ViewTables, cpu_view

_TOL = 1e-9
REPO = Path(__file__).resolve().parents[1]


def _taskset(seed: int, util: float, n: int, m: int = 3):
    rng = np.random.default_rng(seed)
    return generate_taskset(rng, util, GeneratorConfig(n_tasks=n, n_subtasks=m,
                                                       variability=0.2))


def _assert_same(a, b, ctx, same_tried: bool = True):
    assert a.schedulable == b.schedulable, ctx
    assert a.alloc == b.alloc, ctx
    if same_tried:
        assert a.candidates_tried == b.candidates_tried, ctx
    if a.schedulable:
        for x, y in zip(a.analysis.responses, b.analysis.responses):
            assert abs(x - y) <= _TOL, (ctx, x, y)


@pytest.fixture
def torch_cpu():
    """A fresh torch engine on the CPU in the engine table."""
    engine = _TorchEngine("cpu")
    old = rta_batch._ENGINES.get("torch:cpu")
    rta_batch._ENGINES["torch:cpu"] = engine
    yield engine
    if old is None:
        rta_batch._ENGINES.pop("torch:cpu", None)
    else:
        rta_batch._ENGINES["torch:cpu"] = old


CASES = [  # (seed, util, n tasks, gn_total, tightened, preemption)
    (0, 0.6, 3, 6, True, None),
    (1, 0.8, 3, 8, False, None),
    (2, 1.0, 4, 8, True, None),
    (3, 1.2, 4, 12, True, None),
    (4, 0.7, 3, 8, True, "priority"),
    (5, 1.0, 3, 10, False, "priority"),
]


@pytest.mark.parametrize("case", CASES, ids=[f"s{c[0]}" for c in CASES])
def test_torch_engine_matches_the_numpy_engine(case, torch_cpu):
    seed, util, n, gn, tightened, preemption = case
    ts = _taskset(seed, util, n)
    kw = dict(tightened=tightened, preemption=preemption)
    a = grid_search_frontier(ts, gn, backend="numpy", **kw)
    b = grid_search_frontier(ts, gn, backend="torch:cpu", **kw)
    _assert_same(a, b, case)
    assert torch_cpu.fixed_points["device"] > 0


@pytest.mark.parametrize("case", [c for c in CASES if c[5] is None],
                         ids=[f"s{c[0]}" for c in CASES if c[5] is None])
def test_torch_engine_matches_the_scalar_search(case, torch_cpu):
    """Without preemption, against ``grid_search_dfs``: the same verdict,
    allocation and R̂ (the two searches count candidates differently)."""
    seed, util, n, gn, tightened, _ = case
    ts = _taskset(seed, util, n)
    d = grid_search_dfs(ts, gn, tightened=tightened)
    f = grid_search_frontier(ts, gn, tightened=tightened, backend="torch:cpu")
    _assert_same(d, f, case, same_tried=False)


@pytest.mark.parametrize("util", [0.5, 0.9])
def test_torch_engine_matches_the_scalar_search_warm_started(util, torch_cpu):
    ts = _taskset(7, util, 3)
    d = grid_search_dfs(ts, 9, tightened=True)
    hint = d.alloc if d.schedulable else (2, 2, 2)
    _assert_same(grid_search_dfs(ts, 9, tightened=True, hint=hint),
                 grid_search_frontier(ts, 9, tightened=True, hint=hint,
                                      backend="torch:cpu"), util, same_tried=False)


JAX_SETS = [(seed, util, 3, 6) for seed in range(3) for util in (0.6, 1.0)]

_JAX_CODE = """
import json, sys
import numpy as np
from repro.core import GeneratorConfig, generate_taskset, set_backend
from repro.core.rta_batch import grid_search_frontier

set_backend("jax")
out = []
for seed, util, n, gn in json.loads(sys.argv[1]):
    ts = generate_taskset(np.random.default_rng(seed), util,
                          GeneratorConfig(n_tasks=n, n_subtasks=3, variability=0.2))
    f = grid_search_frontier(ts, gn, tightened=True, backend="jax")
    out.append({"taskset": repr(ts), "schedulable": f.schedulable,
                "alloc": f.alloc, "tried": f.candidates_tried,
                "responses": list(f.analysis.responses) if f.schedulable else None})
print(json.dumps(out))
"""


def test_torch_engine_matches_the_reference_jax_engine(torch_cpu):
    """The reference's ``_JaxEngine`` on the same task sets, in a
    subprocess, as ``tests/test_rta_batch.py`` runs it."""
    pytest.importorskip("jax")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_CODE, json.dumps(JAX_SETS)], env=env,
                          capture_output=True, text=True, timeout=560)
    assert proc.returncode == 0, proc.stderr
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    for (seed, util, n, gn), r in zip(JAX_SETS, ref, strict=True):
        ts = _taskset(seed, util, n)
        assert repr(ts) == r["taskset"], (seed, util)
        f = grid_search_frontier(ts, gn, tightened=True, backend="torch:cpu")
        assert (f.schedulable, f.candidates_tried) == (r["schedulable"], r["tried"]), (seed, util)
        assert f.alloc == (tuple(r["alloc"]) if r["alloc"] is not None else None)
        if f.schedulable:
            assert np.max(np.abs(np.array(f.analysis.responses) - r["responses"])) <= _TOL
    assert torch_cpu.fixed_points["device"] > 0


# ---- fallbacks, eviction, counts and the device ------------------------------


def _group(task, gns, n_rows, seed=0):
    """One higher-priority position: ``task``'s CPU view at each GN, and a
    GN per candidate row drawn from ``gns``."""
    rng = np.random.default_rng(seed)
    return _HpGroup({g: ViewTables(cpu_view(task, 2 * g)) for g in gns},
                    np.asarray(rng.choice(gns, n_rows), dtype=np.int64))


def test_fallbacks_are_the_numpy_engines_and_are_counted():
    ts = _taskset(11, 0.8, 3)
    eng, ref = _TorchEngine("cpu"), _NumpyEngine()
    limit = ts[2].deadline
    base = np.tile(np.asarray(ts[2].cpu_hi, dtype=np.float64), (5, 1))
    horizon = 2 * limit
    # no interference groups: the NumPy engine, every entry counted there
    out = eng.fixed_point_batch(base, limit, [[]], 0.0, horizon)
    assert np.array_equal(out, ref.fixed_point_batch(base, limit, [[]], 0.0, horizon))
    assert eng.fixed_points == {"device": 0, "numpy": base.size}
    # an empty batch
    empty = np.zeros((0, base.shape[1]))
    parts = [[_group(ts[0], (1, 2, 3), 0)]]
    assert eng.fixed_point_batch(empty, limit, parts, 0.0, horizon).shape == empty.shape
    assert eng.fixed_points["device"] == 0
    # a view whose arrays do not cover the limit: the horizon asked for is
    # below it, and the NumPy engine answers past the arrays
    short = [[_group(ts[0], (1, 2), 5), _group(ts[1], (2,), 5, seed=1)]]
    far = 50.0 * limit
    got = eng.fixed_point_batch(base, far, short, 0.0, 0.0)
    assert np.array_equal(got, ref.fixed_point_batch(base, far, short, 0.0, 0.0))
    assert eng.fixed_points["device"] == 0 and eng.fixed_points["numpy"] == 2 * base.size
    # covered: the device runs it, and agrees
    parts = [[_group(ts[0], (1, 2, 3), 5), _group(ts[1], (2, 4), 5, seed=1)]]
    got = eng.fixed_point_batch(base, limit, parts, 0.5, horizon)
    want = ref.fixed_point_batch(base, limit, parts, 0.5, horizon)
    assert np.allclose(got, want, rtol=0, atol=_TOL) and np.array_equal(np.isinf(got),
                                                                        np.isinf(want))
    assert eng.fixed_points["device"] == base.size


def test_rows_path_is_the_numpy_engines():
    eng = _TorchEngine("cpu")
    assert eng.rows_stack([]) is None
    base, limit, const = np.array([1.0, 2.0]), np.array([10.0, 10.0]), np.zeros(2)
    got = eng.fixed_point_rows(base, limit, const, np.zeros((2, 0), np.int64), None, None)
    assert np.array_equal(got, _NumpyEngine().fixed_point_rows(
        base, limit, const, np.zeros((2, 0), np.int64), None, None))
    assert eng.fixed_points == {"device": 0, "numpy": 2}


def test_registry_evicts_before_a_call_and_results_hold(torch_cpu):
    """With a registry bound of 8 views, a call whose new views would pass
    it clears the registry first (a call's own views are never split), any
    other call keeps it, and nothing changes in the result."""
    torch_cpu._REGISTRY_LIMIT = 8
    trims, trim = [], torch_cpu._trim_registry

    def spy(incoming):
        before = len(torch_cpu._views)
        trim(incoming)
        trims.append((before, incoming, len(torch_cpu._views)))

    torch_cpu._trim_registry = spy
    ts = _taskset(2, 1.0, 4)
    a = grid_search_frontier(ts, 8, tightened=True, backend="numpy")
    b = grid_search_frontier(ts, 8, tightened=True, backend="torch:cpu")
    _assert_same(a, b, "evicting")
    for before, incoming, after in trims:
        assert after == (0 if before + incoming > 8 else before)
    assert any(after == 0 < before for before, _, after in trims)


def test_the_host_check_interval_changes_nothing(torch_cpu):
    ts = _taskset(3, 1.2, 4)
    a = grid_search_frontier(ts, 12, tightened=True, backend="torch:cpu")
    torch_cpu._CHECK_EVERY = 1
    torch_cpu._stack = None
    b = grid_search_frontier(ts, 12, tightened=True, backend="torch:cpu")
    _assert_same(a, b, "check every 1")


def test_torch_on_the_card_is_explicit(monkeypatch):
    """``"torch"`` runs on cuda, and raises without a CUDA device; the CPU
    is named (``"torch:cpu"``), never fallen back to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend_module, "_backend", None)
    monkeypatch.delitem(rta_batch._ENGINES, "torch", raising=False)
    assert available_backends() == ("numpy", "torch:cpu")
    with pytest.raises(RuntimeError):
        backend_module.set_backend("torch")
    with pytest.raises(RuntimeError):
        _TorchEngine("cuda")
    with pytest.raises(RuntimeError):
        grid_search_frontier(_taskset(0, 0.6, 3), 6, backend="torch")
    with pytest.raises(ValueError):
        backend_module.set_backend("jax")
    assert backend_module.set_backend("torch:cpu") == "torch:cpu"
    assert backend_module.get_backend() == "torch:cpu"
    assert isinstance(rta_batch._engine(), _TorchEngine)
    assert rta_batch._engine().device == torch.device("cpu")
    monkeypatch.setenv("REPRO_RTA_BACKEND", "torch")
    monkeypatch.setattr(backend_module, "_backend", None)
    with pytest.raises(RuntimeError):
        backend_module.get_backend()
