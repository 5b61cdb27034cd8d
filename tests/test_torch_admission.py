"""The port's admission path against the reference's, and its wiring into
the serving engine.

Decisions: on task sets from ``repro.core.generator``, the port's
``AdmissionController`` and the reference's make the same sequence of
decisions (admitted, allocation, certified bounds, reason), compared
exactly: the code is the same.  Wiring: a registered engine runs every
pinned matmul on the GN SMs it holds, disjoint from the other services'
of its front door, and on the card registers a task measured there.  The
fit: GR̂(m) bounds every measured device-busy step t(m).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.generator import GeneratorConfig, generate_taskset
from repro.runtime import AdmissionController as RefAdmission

import repro_torch.core as port_core
from repro_torch.configs import get_smoke_config
from repro_torch.core import backend as port_backend
from repro_torch.core.rta_batch import _engine as port_engine
from repro_torch.kernels import ops
from repro_torch.runtime import AdmissionController as PortAdmission
from repro_torch.runtime import ServingTaskSpec, serving_task_to_rt
from repro_torch.runtime.task_spec import (DecodeCalibration, StepFit, fit_step,
                                           job_response_ms, measured_task_to_rt)
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving.engine import calibration_sms

GN_TOTAL = 8


def _tasks(seed: int, util: float) -> list:
    """Two generated task sets of the reference, names made unique."""
    rng = np.random.default_rng(seed)
    cfg = GeneratorConfig(n_tasks=3, n_subtasks=3)
    out = []
    for s in range(2):
        ts = generate_taskset(rng, util, cfg)
        out += [dataclasses.replace(t, name=f"set{s}-{t.name}") for t in ts]
    return out


def _port_task(task):
    """The same task built from the port's classes."""
    gpu = tuple(port_core.GpuSegment(**dataclasses.asdict(g)) for g in task.gpu)
    fields = {f.name: getattr(task, f.name) for f in dataclasses.fields(task)}
    return port_core.RTTask(**{**fields, "gpu": gpu})


def _decision(dec) -> tuple:
    res = None if dec.result is None else dataclasses.astuple(dec.result)
    return dec.admitted, dec.alloc, dec.reason, dec.host, res


def _run(controller_cls, tasks, **kw) -> list:
    """Admit the first four, remove the first admitted and one rejected
    name, then admit the rest; the log of every decision and state."""
    ac = controller_cls(gn_total=GN_TOTAL, **kw)
    log = []
    for t in tasks[:4]:
        log.append(("admit", t.name, _decision(ac.admit(t))))
    admitted = [name for _, name, d in log if d[0]]
    for name in admitted[:1] + ["never-admitted"]:
        log.append(("remove", name, ac.remove(name)))
    for t in tasks[4:]:
        log.append(("admit", t.name, _decision(ac.admit(t))))
    log.append(("state", dict(ac.allocation), [t.name for t in ac.tasks],
                ac.current_alloc_list()))
    return log


def _admissions(log) -> list:
    return [entry[2] for entry in log if entry[0] == "admit"]


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("preemption", ["none", "priority"])
@pytest.mark.parametrize("tightened", [True, False])
def test_admission_decisions_match_reference(tightened, preemption, hosts):
    kw = dict(tightened=tightened, preemption=preemption, hosts=hosts)
    for seed, util in ((0, 0.6), (1, 1.2)):
        tasks = _tasks(seed, util)
        want = _run(RefAdmission, tasks, **kw)
        got = _run(PortAdmission, [_port_task(t) for t in tasks], **kw)
        assert got == want
        assert any(d[0] for d in _admissions(want))


def test_admission_covers_rejections():
    """The generated sets reach both outcomes, so the parity above is held
    on rejections (and their reasons) too."""
    outcomes = {d[0] for seed, util in ((0, 0.6), (1, 1.2))
                for d in _admissions(_run(RefAdmission, _tasks(seed, util)))}
    assert outcomes == {True, False}


def test_backend_names_numpy_only(monkeypatch):
    assert port_backend.available_backends() == ("numpy",)
    with pytest.raises(ValueError):
        port_backend.set_backend("jax")
    with pytest.raises(ValueError):
        port_engine("jax")
    assert port_backend.set_backend("numpy") == "numpy"
    assert port_core.get_backend() == "numpy"
    monkeypatch.setattr(port_backend, "_backend", None)
    monkeypatch.setenv("REPRO_RTA_BACKEND", "jax")
    with pytest.raises(ValueError):
        port_backend.get_backend()


def test_durable_checkpoint_round_trip(tmp_path):
    """A journaled front door checkpoints, and a controller recovered from
    that journal holds the same residents and allocation."""
    from repro_torch.sched.journal import Journal
    from repro_torch.sched.recovery import recover_controller

    path = tmp_path / "admission.sqlite"
    ac = PortAdmission(gn_total=GN_TOTAL, durable=str(path))
    decisions = [ac.admit(_port_task(t)).admitted for t in _tasks(0, 0.6)[:3]]
    assert any(decisions)
    seq = ac.checkpoint()
    assert seq >= 1
    alloc = dict(ac.allocation)
    ac.journal.close()
    ctl, report = recover_controller(Journal(str(path)))
    assert dict(ctl.allocation) == alloc
    with pytest.raises(RuntimeError):
        PortAdmission(gn_total=GN_TOTAL).checkpoint()


# ---------------------------------------------------------------- the wiring


class _Spy:
    """Records the (n_bands, first_sm) of every ops.pinned_matmul call."""

    def __init__(self, monkeypatch):
        self.ranges = []
        real = ops.pinned_matmul

        def spy(x, w, *, n_bands=None, first_sm=0):
            self.ranges.append((n_bands, first_sm))
            return real(x, w, n_bands=n_bands, first_sm=first_sm)

        monkeypatch.setattr(ops, "pinned_matmul", spy)


def _small_engine():
    cfg = get_smoke_config("qwen3-0.6b")
    return ServingEngine(cfg, ServeConfig(max_context=32, batch=2), seed=0, device="cpu")


def _spec(name="chat"):
    return ServingTaskSpec(name=name, arch_id="qwen3-0.6b", period_ms=200.0,
                           deadline_ms=150.0, batch=2, seq_len=8, new_tokens=2,
                           roofline_step_s=0.004, dominant="memory_s")


def _prompts(eng, seed):
    return np.random.default_rng(seed).integers(0, eng.cfg.vocab, (2, 8)).astype(np.int32)


def test_registered_engine_runs_every_matmul_on_its_gn(monkeypatch):
    eng = _small_engine()
    dec = eng.rt_register(PortAdmission(gn_total=GN_TOTAL), _spec())
    assert dec.admitted
    gn = dec.alloc["chat"]
    assert eng.sm_range == (gn, 0) and 1 <= gn <= GN_TOTAL
    spy = _Spy(monkeypatch)
    eng.generate(_prompts(eng, 0), max_new_tokens=2)
    assert spy.ranges and set(spy.ranges) == {(gn, 0)}
    assert ops.sm_range() == (None, 0)  # the scope ends with generate


def test_unregistered_engine_runs_matmuls_on_all_sms(monkeypatch):
    eng = _small_engine()
    assert eng.rt_register(PortAdmission(gn_total=GN_TOTAL), _spec()).admitted
    assert eng.rt_deregister()
    assert eng.sm_range is None and eng.rt_task is None
    spy = _Spy(monkeypatch)
    eng.generate(_prompts(eng, 1), max_new_tokens=2)
    assert spy.ranges and set(spy.ranges) == {(None, 0)}


def test_engines_of_one_front_door_hold_disjoint_sms(monkeypatch):
    """Two engines admitted by one controller run their matmuls on disjoint
    SM ranges inside the card; when the first departs, the second's range
    moves to the freed SMs at its next job."""
    ac = PortAdmission(gn_total=GN_TOTAL)
    a, b = _small_engine(), _small_engine()
    assert a.rt_register(ac, _spec("a")).admitted and b.rt_register(ac, _spec("b")).admitted
    (gn_a, first_a), (gn_b, first_b) = a.sm_range, b.sm_range
    assert (gn_a, gn_b) == (ac.allocation["a"], ac.allocation["b"])
    assert first_a + gn_a <= first_b and first_b + gn_b <= GN_TOTAL
    for eng, held in ((a, (gn_a, first_a)), (b, (gn_b, first_b))):
        spy = _Spy(monkeypatch)
        eng.generate(_prompts(eng, 2), max_new_tokens=1)
        assert set(spy.ranges) == {held}
    assert a.rt_deregister()
    assert b.sm_range == (ac.allocation["b"], 0)
    spy = _Spy(monkeypatch)
    b.generate(_prompts(b, 3), max_new_tokens=1)
    assert set(spy.ranges) == {(ac.allocation["b"], 0)}


def test_overlapping_allocations_are_refused_at_the_next_job():
    """Under priority preemption holdings may overlap; a range past the
    card's SMs is refused, not run on SMs another service holds."""
    ac = PortAdmission(gn_total=GN_TOTAL, preemption="priority")
    engines = {}
    for name in ("s0", "s1", "s2"):
        engines[name] = _small_engine()
        spec = dataclasses.replace(_spec(name), roofline_step_s=0.02)
        assert engines[name].rt_register(ac, spec).admitted
    assert sum(ac.allocation.values()) > GN_TOTAL
    first, refused = 0, 0
    for name, gn in ac.allocation.items():
        if first + gn > GN_TOTAL:
            with pytest.raises(RuntimeError, match="disjoint"):
                engines[name].generate(_prompts(engines[name], 4), max_new_tokens=1)
            refused += 1
        else:
            assert engines[name].sm_range == (gn, first)
        first += gn
    assert refused


def test_multi_host_front_door_is_refused():
    with pytest.raises(ValueError):
        _small_engine().rt_register(PortAdmission(gn_total=GN_TOTAL, hosts=2), _spec())


def test_cpu_registration_uses_the_reference_task():
    eng = _small_engine()
    assert eng.rt_register(PortAdmission(gn_total=GN_TOTAL), _spec()).admitted
    assert eng.rt_task == serving_task_to_rt(_spec()) and eng.rt_calibration is None


def _curve(m: int) -> float:
    return 400.0 / m + 6.0


# whole-job walls: a 50 ms prefill, 2 decode steps of about 20 ms
JOBS_MS = tuple(90.0 - (7 * i) % 5 for i in range(16))


def _measured(sms) -> dict:
    return {m: {"prefill_ms": [50.0, 49.0, 48.0], "device_ms": [_curve(m), 0.99 * _curve(m)],
                "job_ms": []} for m in sms}


def test_card_registration_measures_the_granted_gn(monkeypatch):
    """The card's chain on synthetic measurements: the task comes from the
    calibration, and the engine measures each granted GN that is not a
    measured count, refits and asks again, until the GN it holds is one.
    The admitted task's GR̂(GN) then bounds the step measured at GN."""
    gn_total = 132
    eng = _small_engine()
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    asked = []

    def measure(prompts, sms):
        asked.append(tuple(sms))
        assert prompts.shape == (2, 8)
        return _measured(sms)

    monkeypatch.setattr(eng, "measure_decode", measure)
    spec = dataclasses.replace(_spec(), deadline_ms=1e9, period_ms=2e9)
    cal = DecodeCalibration(2, 8, 2, _measured(calibration_sms(gn_total)), JOBS_MS)
    eng.rt_calibration = cal
    deadline = job_response_ms(cal.task(spec), gn_total // 3)
    spec = dataclasses.replace(spec, deadline_ms=deadline, period_ms=2 * deadline)
    ac = PortAdmission(gn_total=gn_total)
    dec = eng.rt_register(ac, spec)
    assert dec.admitted
    gn = dec.alloc[spec.name]
    assert gn in cal.measured and eng.rt_calibration is cal
    assert all(len(a) == 1 and a[0] not in calibration_sms(gn_total) for a in asked)
    assert eng.rt_task == cal.task(spec) == ac.dynamic.task(spec.name)
    assert cal.gr_hi(spec, gn) >= max(cal.measured[gn]["device_ms"])
    assert eng.rt_task.gpu[0].response_bounds(2 * gn)[1] == cal.gr_hi(spec, gn)


def test_held_out_prediction_is_the_fit_without_that_count():
    spec = _spec()
    cal = DecodeCalibration(2, 8, 2, _measured((16, 33, 44, 66, 132)), JOBS_MS)
    without = DecodeCalibration(2, 8, 2, _measured((16, 33, 66, 132)), JOBS_MS)
    assert cal.fit(without=44) == without.fit()
    assert cal.gr_hi(spec, 44, held_out=True) == without.gr_hi(spec, 44)
    assert cal.gr_hi(spec, 44) >= _curve(44)


def test_job_response_shrinks_with_sms():
    spec = dataclasses.replace(_spec(), deadline_ms=1e9, period_ms=2e9)
    task = DecodeCalibration(2, 8, 2, _measured((16, 66, 132)), JOBS_MS).task(spec)
    r = [job_response_ms(task, m) for m in (8, 33, 132)]
    assert all(np.isfinite(r)) and r[0] > r[1] > r[2] > 0


def test_sm_scope_nests_and_restores():
    assert ops.sm_range() == (None, 0)
    with ops.on_sms(5, 3):
        assert ops.sm_range() == (5, 3)
        with ops.on_sms(None):
            assert ops.sm_range() == (None, 0)
        assert ops.sm_range() == (5, 3)
    assert ops.sm_range() == (None, 0)


# ------------------------------------------------------------------- the fit


@pytest.mark.parametrize("seed", range(6))
def test_fit_bounds_every_measured_point(seed):
    """On synthetic t(m) = A/m + L with noise (and non-monotone points),
    the envelope and Lemma 5.1's GR̂ at every measured m are >= t(m)."""
    rng = np.random.default_rng(seed)
    sms = sorted(set(int(m) for m in rng.integers(1, 133, 5)) | {132})
    a, l = rng.uniform(0, 500), rng.uniform(0.1, 12)
    t = [a / m + l + rng.normal(0, 0.05 * l) for m in sms]
    fit = fit_step(sms, t)
    assert fit.a_ms >= 0 and fit.l_ms >= 0
    spec = _spec()
    task = measured_task_to_rt(spec, fit, host_step_ms=30.0, prefill_ms=40.0)
    seg = task.gpu[0]
    assert seg.work_hi == pytest.approx(2 * fit.a_ms + fit.l_ms)
    assert seg.overhead_hi == fit.l_ms
    for m, tm in zip(sms, t):
        assert fit.a_ms / m + fit.l_ms >= tm - 1e-9
        assert seg.response_bounds(2 * m)[1] >= tm - 1e-9


def test_fit_recovers_an_exact_curve():
    sms = [8, 33, 66, 132]
    fit = fit_step(sms, [400 / m + 7 for m in sms])
    assert fit.a_ms == pytest.approx(400) and fit.l_ms == pytest.approx(7)


def test_fit_of_a_flat_or_rising_curve_has_no_slope():
    fit = fit_step([16, 66, 132], [9.0, 9.5, 10.0])
    assert fit.a_ms == 0.0 and fit.l_ms == pytest.approx(10.0)


def test_fit_needs_three_sm_counts():
    with pytest.raises(ValueError):
        fit_step([66, 132], [3.0, 2.0])
    with pytest.raises(ValueError):
        fit_step([66, 66, 132], [3.0, 3.1, 2.0])


def test_measured_task_keeps_the_host_in_cpu_segments():
    """The memory copies and the segment count are serving_task_to_rt's;
    the first CPU segment adds the prefill's wall, each decode token's the
    host's step; the GPU segment is the fit's, at the kernel type's alpha."""
    spec = _spec()
    fit = StepFit(sms=(8, 66, 132), device_ms=(60.0, 10.0, 7.0), a_ms=400.0, l_ms=6.0)
    base = serving_task_to_rt(spec)
    task = measured_task_to_rt(spec, fit, host_step_ms=25.0, prefill_ms=40.0)
    assert task.cpu_hi[0] == base.cpu_hi[0] + 40.0
    assert task.cpu_hi[1:] == tuple(c + 25.0 for c in base.cpu_hi[1:])
    assert task.mem_hi == base.mem_hi and task.n_gpu == base.n_gpu
    assert task.deadline == spec.deadline_ms and task.period == spec.period_ms
    seg = task.gpu[0]
    assert (seg.work_hi, seg.overhead_hi, seg.alpha) == (806.0, 6.0, base.gpu[0].alpha)
    assert seg.work_lo == pytest.approx(806.0 * (1 - spec.variability))
    assert all(c_lo <= c_hi for c_lo, c_hi in zip(task.cpu_lo, task.cpu_hi))


def test_measuring_the_step_needs_the_card():
    eng = _small_engine()
    prompts = np.zeros((2, 8), np.int32)
    with pytest.raises(RuntimeError):
        eng.measure_decode(prompts, sms=(1, 2, 8))


def test_measured_task_admits_on_the_port_controller():
    spec = ServingTaskSpec(name="chat", arch_id="qwen3-0.6b", period_ms=4000.0,
                           deadline_ms=2000.0, batch=4, seq_len=256, new_tokens=16,
                           dominant="memory_s", vocab=151936)
    fit = StepFit(sms=(16, 66, 132), device_ms=(21.0, 12.5, 10.5), a_ms=175.0, l_ms=9.0)
    dec = PortAdmission(gn_total=132).admit(measured_task_to_rt(spec, fit, host_step_ms=45.0,
                                                                    prefill_ms=40.0))
    assert dec.admitted and 1 <= dec.alloc["chat"] <= 132
