"""The port's copies of ``core/baselines.py``, ``sched/fleet.py`` and
``sched/daemon.py`` against the reference's, on the same inputs.

The baselines' analyses on task sets of each package's generator (the
same seeds give the same sets, checked), ``BrokerTree`` decisions on
seeded fleets built as ``tests/test_scale.py`` builds them, and
``SchedulerDaemon.handle`` replies in process for submit, status and
cancel as ``tests/test_recovery.py`` drives them.  The copies' syntax trees
are held to the originals in ``tests/test_torch_admission_copies.py``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

import repro.core as ref_core
import repro.sched as ref_sched
import repro_torch.core as port_core
import repro_torch.sched as port_sched
from repro.sched.daemon import SchedulerDaemon as RefDaemon
from repro.sched.journal import task_to_dict as ref_task_to_dict
from repro_torch.sched.daemon import SchedulerDaemon as PortDaemon
from repro_torch.sched.journal import task_to_dict as port_task_to_dict

PACKAGES = {"reference": (ref_core, ref_sched), "port": (port_core, port_sched)}


def _taskset(core, seed: int, util: float, n: int = 4, m: int = 3):
    rng = np.random.default_rng(seed)
    return core.generate_taskset(rng, util, core.GeneratorConfig(n_tasks=n, n_subtasks=m))


def _analysis(res) -> tuple:
    return tuple((t.name, t.response, t.schedulable) for t in res.tasks)


@pytest.mark.parametrize("analyze", ["analyze_stgm", "analyze_self_suspension"])
@pytest.mark.parametrize("seed", range(4))
def test_baselines_agree(analyze, seed):
    """Each baseline on the same task set and allocations gives the same
    per-task R̂ and verdicts in both packages."""
    sets = {k: _taskset(core, seed, 0.4 + 0.3 * seed) for k, (core, _) in PACKAGES.items()}
    assert repr(sets["reference"]) == repr(sets["port"])
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        alloc = [int(g) for g in rng.integers(1, 6, len(sets["port"]))]
        out = {k: _analysis(getattr(core, analyze)(sets[k], alloc))
               for k, (core, _) in PACKAGES.items()}
        assert out["port"] == out["reference"], (analyze, seed, alloc)


GN = 8


def _pool(core, seed: int, n: int = 8, util: float = 0.5):
    out = []
    for i in range(n):
        t = _taskset(core, seed * 100 + i, util, n=1)[0]
        out.append(dataclasses.replace(t, name=f"pool{i}"))
    return out


def _fleet_decisions(core, sched, seed: int) -> list:
    """Seeded arrivals and departures on a BrokerTree, as test_scale's
    ``_random_fleet`` draws them: each decision, where it landed, and the
    certified bounds after it."""
    rng = np.random.default_rng(seed)
    tree = sched.BrokerTree.build(12, GN, hosts_per_shard=4, fanout=2, transition="instant",
                                  migrate_on_departure=False)
    pool = _pool(core, seed)
    out, names = [], []
    for i in range(int(rng.integers(8, 4 * 12))):
        if names and rng.random() < 0.2:
            name = names.pop(int(rng.integers(len(names))))
            out.append(("release", name, tree.release(name)))
            continue
        t = dataclasses.replace(pool[int(rng.integers(len(pool)))], name=f"f{seed}t{i}")
        dec = tree.admit(t)
        where = None
        if dec.admitted:
            names.append(t.name)
            leaf, host = tree.locate(t.name)
            where = (next(j for j, x in enumerate(tree.leaves()) if x is leaf), host)
        out.append(("admit", t.name, dec.admitted, where, tree.bound(t.name)
                    if dec.admitted else None, dec.reason))
    out.append(("state", tree.residents, tree.capacity_in_use, tree.free_capacity,
                sorted(tree.allocation.items()), sorted(tree.bounds().items())))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_broker_tree_decides_alike(seed):
    out = {k: _fleet_decisions(core, sched, seed) for k, (core, sched) in PACKAGES.items()}
    assert out["port"] == out["reference"]
    assert any(d[0] == "admit" and d[2] for d in out["port"])
    assert seed == 1 or any(d[0] == "admit" and not d[2] for d in out["port"])


def _specs(core, to_dict, n: int, util: float = 0.06):
    return [to_dict(dataclasses.replace(_taskset(core, i, util, n=1)[0], name=f"d{i}"))
            for i in range(n)]


def _replies(daemon_cls, core, to_dict, path) -> list:
    d = daemon_cls(str(path / "j.sqlite"), str(path / "s.sock"), gn_total=10)
    out = []
    try:
        for spec in _specs(core, to_dict, 8, util=0.5):
            out.append(d.handle({"cmd": "submit", "task": spec}))
        out.append(d.handle({"cmd": "status"}))
        out.append(d.handle({"cmd": "cancel", "name": "d1"}))
        out.append(d.handle({"cmd": "cancel", "name": "nope"}))
        out.append(d.handle({"cmd": "status"}))
        out.append(d.handle({"cmd": "wat"}))
    finally:
        d.journal.close()
    return out


def _without_timings(reply):
    """A reply with its wall-clock fields dropped."""
    if isinstance(reply, dict):
        return {k: _without_timings(v) for k, v in reply.items()
                if not (k.endswith("_s") or k.endswith("_ms") or k in ("uptime", "pid"))}
    if isinstance(reply, list):
        return [_without_timings(v) for v in reply]
    return reply


def test_daemon_replies_alike(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = _replies(RefDaemon, ref_core, ref_task_to_dict, tmp_path / "ref")
    port = _replies(PortDaemon, port_core, port_task_to_dict, tmp_path / "port")
    assert _without_timings(port) == _without_timings(ref)
    submitted, status = port[:8], port[8]
    assert all(r["ok"] for r in submitted)
    assert {r["admitted"] for r in submitted} == {True, False}
    assert "d1" in status["resident"] and port[9]["released"] and not port[10]["released"]
    assert all(math.isfinite(b) for b in status["bounds"].values())
