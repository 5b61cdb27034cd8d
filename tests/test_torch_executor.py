"""The port's wall-clock executor, the measured job's task and the glue
that hands an executor run to ``BoundMonitor``.

Executor: twins of ``tests/test_runtime.py``'s executor tests against the
port's copy.  Task: the measured task's first CPU segment carries the
largest prefill wall and its CPU segments together the pWCET of the
whole calibration jobs, so the job's R̂ covers one prefill and then
``new_tokens`` decode steps.  Service: ``ServingEngine.rt_service`` on a
CPU engine runs whole ``generate`` jobs under the executor, and
``executor_events`` gives the monitor each job's R in ms beside the
controller's certified R̂.  No test draws a seed at run time.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.obs import BoundMonitor
from repro_torch.runtime import (AdmissionController, Service, ServingTaskSpec,
                                 WallClockExecutor, serving_task_to_rt)
from repro_torch.runtime.task_spec import (PWCET_BLOCK, PWCET_EXCEEDANCE, DecodeCalibration,
                                           job_response_ms, measured_task_to_rt, pwcet_ms)
from repro_torch.sched import DynamicController, EventTrace
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving import engine as serving_engine
from repro_torch.serving.engine import executor_events


def _spin(cost_s):
    def job():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < cost_s:
            pass
    return job


# ------------------------------------------------------------ executor twins


def test_executor_runs_services_by_deadline_priority():
    calls = {"a": 0, "b": 0}

    def mk(name, cost_s):
        spin = _spin(cost_s)

        def job():
            calls[name] += 1
            spin()
        return job

    svcs = [
        Service("a", period_s=0.02, deadline_s=0.02, run_job=mk("a", 0.001)),
        Service("b", period_s=0.05, deadline_s=0.05, run_job=mk("b", 0.002)),
    ]
    stats = WallClockExecutor(svcs).run(duration_s=0.3)
    assert stats["a"]["completed"] > stats["b"]["completed"] > 0
    assert stats["a"]["worst_response_ms"] > 0
    assert calls == {"a": stats["a"]["completed"], "b": stats["b"]["completed"]}


def test_executor_mid_run_join_then_leave_completes_inflight_jobs():
    trace = EventTrace(us_per_unit=1e6)
    base = Service("base", period_s=0.02, deadline_s=0.02, run_job=_spin(0.001))
    joiner = Service("joiner", period_s=0.04, deadline_s=0.08, run_job=_spin(0.03))
    ex = WallClockExecutor([base], trace=trace)
    stats = ex.run(duration_s=0.3, events=[
        (0.05, lambda e: e.add_service(joiner)),
        (0.12, lambda e: e.remove_service("joiner")),
    ])
    assert stats["joiner"]["released"] >= 1
    assert stats["joiner"]["completed"] >= 1
    ev = trace.events
    admits = [e for e in ev if e.kind == "admit" and e.task == "joiner"]
    reclaims = [e for e in ev if e.kind == "reclaim" and e.task == "joiner"]
    assert len(admits) == 1 and len(reclaims) == 1
    starts = [e for e in ev if e.kind == "start" and e.task == "joiner"]
    completes = [e for e in ev if e.kind == "complete" and e.task == "joiner"]
    assert len(starts) == len(completes) == stats["joiner"]["completed"]
    reclaim_t = reclaims[0].t
    assert all(s.t <= reclaim_t for s in starts)
    assert max(c.t for c in completes) <= reclaim_t + 1e-9
    assert stats["base"]["completed"] > stats["joiner"]["completed"]


def _rt_spec(name):
    return ServingTaskSpec(name=name, arch_id="qwen3-0.6b", period_ms=50.0,
                           deadline_ms=40.0, batch=2, seq_len=64, new_tokens=2,
                           roofline_step_s=0.002, collective_s=2e-4, dominant="compute_s")


def test_rt_register_mid_run_releases_only_at_job_boundary():
    eng = ServingEngine(get_smoke_config("qwen3-0.6b"), ServeConfig(max_context=64, batch=2),
                        device="cpu")
    c = DynamicController(gn_total=8, transition="boundary")
    assert c.admit(serving_task_to_rt(_rt_spec("resident")), t=0.0).admitted
    dec = eng.rt_register(c, _rt_spec("svc"), t=1.0)
    assert dec.admitted and eng.rt_registered
    used = c.capacity_in_use
    assert eng.rt_deregister(t=2.0)
    assert not eng.rt_registered
    assert c.is_departing("svc")
    assert c.capacity_in_use == used
    assert "svc" in c.allocation
    assert c.job_boundary("svc", t=3.0) == "reclaimed"
    assert "svc" not in c.allocation
    assert c.capacity_in_use < used
    assert "resident" in c.allocation


# ---------------------------------------------------- the measured job's task


def _spec(deadline_ms=1e9, period_ms=2e9):
    return ServingTaskSpec(name="chat", arch_id="qwen3-0.6b", period_ms=period_ms,
                           deadline_ms=deadline_ms, batch=4, seq_len=256, new_tokens=16,
                           dominant="memory_s", vocab=151936)


# whole-job walls of the first calibration: 16 jobs, two blocks' maxima 812.5 and 790
JOBS_MS = (700.0, 812.5, 640.0, 655.0, 690.0, 701.0, 688.0, 720.0,
           790.0, 700.0, 640.0, 660.0, 670.0, 680.0, 650.0, 710.0)


def _calibration(prefill_at_gn=None) -> DecodeCalibration:
    """Synthetic measurements in the shape ``measure_decode`` returns."""
    measured = {m: {"prefill_ms": [30.0 + 100.0 / m, 31.0 + 100.0 / m, 29.5 + 100.0 / m],
                    "device_ms": [80.0 / m + 10.0, 79.0 / m + 10.0], "job_ms": []}
                for m in (16, 33, 66, 99, 132)}
    if prefill_at_gn is not None:
        measured[7] = {"prefill_ms": [prefill_at_gn], "device_ms": [80.0 / 7 + 10.0],
                       "job_ms": []}
    return DecodeCalibration(4, 256, 16, measured, JOBS_MS)


def test_measured_task_bounds_the_prefill():
    spec = _spec()
    cal = _calibration()
    largest = 31.0 + 100.0 / 16
    assert cal.prefill_ms() == largest
    task = cal.task(spec)
    assert len(task.gpu) == spec.new_tokens and len(task.cpu_hi) == spec.new_tokens + 1
    assert task.cpu_hi[0] >= largest
    without = measured_task_to_rt(spec, cal.fit(), cal.host_step_ms(), prefill_ms=0.0)
    assert task.cpu_hi[0] == without.cpu_hi[0] + largest
    assert task.cpu_hi[1:] == without.cpu_hi[1:] and task.gpu == without.gpu
    for gn in (4, 16, 44, 132):
        assert job_response_ms(task, gn) >= job_response_ms(without, gn) + largest - 1e-9


def test_measured_task_holds_the_pwcet_of_the_calibration_jobs():
    """The CPU segments together carry the pWCET of the whole calibration
    jobs' walls: the first the largest prefill wall, each decode token's an
    even share of the rest.  The GPU segments are the fit's alone, so the
    job's R̂ exceeds that wall by at least the GPU's part."""
    spec = _spec()
    cal = _calibration()
    base = serving_task_to_rt(spec)
    task = cal.task(spec)
    bound = pwcet_ms(JOBS_MS)
    assert cal.job_bound_ms() == bound > max(JOBS_MS)
    assert cal.host_step_ms() == pytest.approx((bound - cal.prefill_ms()) / spec.new_tokens)
    assert task.cpu_hi[1:] == tuple(c + cal.host_step_ms() for c in base.cpu_hi[1:])
    assert task.cpu_hi[0] == base.cpu_hi[0] + cal.prefill_ms()
    assert sum(task.cpu_hi) == pytest.approx(sum(base.cpu_hi) + bound)
    assert task == measured_task_to_rt(spec, cal.fit(), cal.host_step_ms(), cal.prefill_ms())
    for gn in (16, 44, 132):
        gpu = spec.new_tokens * task.gpu[0].response_bounds(2 * gn)[1]
        assert job_response_ms(task, gn) >= bound + gpu - 1e-9


def test_pwcet_is_the_gumbel_fit_of_block_maxima():
    """Two blocks with maxima 812.5 and 790: the method of moments gives
    beta = sd * sqrt(6) / pi and mu = mean - gamma * beta, read where a
    block's maximum exceeds with 1 - (1 - 1e-3)^8."""
    assert (PWCET_BLOCK, PWCET_EXCEEDANCE) == (8, 1e-3)
    maxima = np.array([812.5, 790.0])
    beta = np.std(maxima, ddof=1) * np.sqrt(6) / np.pi
    mu = maxima.mean() - np.euler_gamma * beta
    p_block = 1 - (1 - 1e-3) ** 8
    assert pwcet_ms(JOBS_MS) == pytest.approx(mu - beta * np.log(-np.log(1 - p_block)))
    assert pwcet_ms(JOBS_MS) > max(JOBS_MS)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pwcet_recovers_a_gumbel_quantile(seed):
    """On 800 walls drawn (fixed seeds) from a Gumbel law, the pWCET lies
    within 5% of the law's own quantile at 1e-3, or of the largest wall
    where that is larger."""
    mu, beta = 800.0, 60.0
    walls = np.random.default_rng(seed).gumbel(mu, beta, 800)
    exact = mu - beta * np.log(-np.log(1 - 1e-3))
    assert pwcet_ms(walls) == pytest.approx(max(exact, walls.max()), rel=0.05)


def test_pwcet_never_below_the_largest_wall_and_needs_two_blocks():
    assert pwcet_ms([500.0] * 16) == 500.0
    # 16 blocks, one outlier: the fit reads below that outlier, which stands
    assert pwcet_ms([500.0] * 127 + [900.0]) == 900.0
    with pytest.raises(ValueError):
        pwcet_ms([500.0] * (2 * PWCET_BLOCK - 1))


def test_measured_prefill_covers_a_gn_measured_later():
    """A granted GN below the calibration's counts is measured before the
    task stands; its slower prefill then sets the first CPU segment, and
    the decode segments shrink so the CPU segments still hold the largest
    calibration job: a refit does not move the host's part of R̂."""
    before = _calibration().task(_spec())
    cal = _calibration(prefill_at_gn=80.0)
    assert cal.prefill_ms() == 80.0
    task = cal.task(_spec())
    assert task.cpu_hi[0] == serving_task_to_rt(_spec()).cpu_hi[0] + 80.0
    assert sum(task.cpu_hi) == pytest.approx(sum(before.cpu_hi))


def test_measured_task_is_of_the_calibrated_job_shape():
    """The host share is a share of jobs of one shape: another prompt
    shape or job length is refused, and the engine calibrates again."""
    cal = _calibration()
    for other in (dict(new_tokens=8), dict(seq_len=128), dict(batch=2)):
        with pytest.raises(ValueError):
            cal.task(dataclasses.replace(_spec(), **other))


def test_calibration_times_whole_jobs_on_each_count(monkeypatch):
    """``calibrate`` asks ``measure_decode`` for CALIBRATION_JOBS whole jobs
    of the spec's length at each SM count, and the calibration keeps all
    of them; a job timed on m SMs runs what ``generate`` runs, with its
    pinned matmuls on SMs 0..m-1."""
    eng = ServingEngine(get_smoke_config("qwen3-0.6b"), ServeConfig(max_context=32, batch=2),
                        device="cpu")
    spec = dataclasses.replace(_rt_spec("chat"), seq_len=8)
    asked = []

    def measure(prompts, sms, new_tokens=0, jobs=0):
        asked.append((prompts.shape, tuple(sms), new_tokens, jobs))
        return {m: {"prefill_ms": [40.0], "device_ms": [80.0 / m + 10.0],
                    "job_ms": [float(100 * m + j) for j in range(jobs)]} for m in sms}

    monkeypatch.setattr(eng, "measure_decode", measure)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _: type("P", (), {"multi_processor_count": 132}))
    cal = eng.calibrate(spec)
    sms = serving_engine.calibration_sms(132)
    assert asked == [((spec.batch, 8), sms, spec.new_tokens, serving_engine.CALIBRATION_JOBS)]
    assert cal.shape == (spec.batch, 8, spec.new_tokens) and eng.rt_calibration is cal
    assert len(cal.job_ms) == len(sms) * serving_engine.CALIBRATION_JOBS
    assert max(cal.job_ms) == 100.0 * 132 + serving_engine.CALIBRATION_JOBS - 1

    ranges = []
    real = ops.pinned_matmul

    def spy(x, w, *, n_bands=None, first_sm=0):
        ranges.append((n_bands, first_sm))
        return real(x, w, n_bands=n_bands, first_sm=first_sm)

    monkeypatch.setattr(ops, "pinned_matmul", spy)
    prompts = np.zeros((2, 8), np.int32)
    timed, _ = eng._generate(prompts, 2, None, (5, 0))
    assert ranges and set(ranges) == {(5, 0)}
    ranges.clear()
    served, _ = eng.generate(prompts, 2)
    assert set(ranges) == {(None, 0)} and np.array_equal(timed, served)


def test_cpu_task_is_still_the_reference_estimate():
    eng = ServingEngine(get_smoke_config("qwen3-0.6b"), ServeConfig(max_context=32, batch=2),
                        device="cpu")
    spec = dataclasses.replace(_rt_spec("chat"), seq_len=8, period_ms=200.0, deadline_ms=150.0)
    assert eng.rt_register(AdmissionController(gn_total=8), spec).admitted
    assert eng.rt_task == serving_task_to_rt(spec)


# ------------------------------------------- the service under the executor


def _service_engine():
    cfg = get_smoke_config("qwen3-0.6b")
    eng = ServingEngine(cfg, ServeConfig(max_context=32, batch=2), seed=0, device="cpu")
    spec = ServingTaskSpec(name="chat", arch_id="qwen3-0.6b", period_ms=400.0,
                           deadline_ms=400.0, batch=2, seq_len=8, new_tokens=2,
                           roofline_step_s=0.004, dominant="memory_s")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    return eng, spec, prompts


def test_rt_service_runs_generate_jobs_and_feeds_the_monitor():
    eng, spec, prompts = _service_engine()
    ac = AdmissionController(gn_total=8)
    assert eng.rt_register(ac, spec).admitted
    jobs = []
    generate = eng.generate

    def counted(*args, **kw):
        jobs.append((args, kw, eng.sm_range))
        return generate(*args, **kw)

    eng.generate = counted
    svc = eng.rt_service(spec, prompts)
    assert (svc.name, svc.period_s, svc.deadline_s) == ("chat", 0.4, 0.4)
    trace = EventTrace(us_per_unit=1e6)
    stats = WallClockExecutor([svc], trace=trace).run(duration_s=0.6)["chat"]
    assert stats["completed"] == stats["released"] >= 1 and len(jobs) == stats["completed"]
    for (p, new_tokens, _), _, held in jobs:
        assert p is prompts and new_tokens == spec.new_tokens
        assert held == (ac.allocation["chat"], 0)

    r_hat, gn = eng.rt_bound
    assert r_hat == ac.dynamic.bounds()["chat"] and gn == ac.allocation["chat"]
    monitor = BoundMonitor().feed(executor_events(trace, {"chat": eng.rt_bound}))
    health = monitor.tasks["chat"]
    assert health.bound == r_hat and health.alloc == gn
    assert health.jobs == stats["completed"]
    assert health.worst_response == stats["worst_response_ms"]
    responses = [dict(e.meta)["response_s"] * 1e3 for e in trace.events if e.kind == "complete"]
    assert health.last_response == responses[-1]
    assert health.min_headroom == min(1.0 - r / r_hat for r in responses)
    assert monitor.alert_counts().get("deadline_miss", 0) == stats["missed"]


def test_executor_events_give_ms_and_the_bound():
    trace = EventTrace(us_per_unit=1e6)
    trace.record(0.0, "release", "svc")
    trace.record(0.5, "complete", "svc", response_s=0.5)
    trace.record(1.5, "complete", "svc", response_s=1.25)
    trace.record(1.5, "miss", "svc", overshoot_s=0.25)
    monitor = BoundMonitor().feed(executor_events(trace, {"svc": (1000.0, 12)}))
    st = monitor.tasks["svc"]
    assert (st.bound, st.alloc, st.jobs, st.worst_response) == (1000.0, 12, 2, 1250.0)
    assert st.min_headroom == pytest.approx(-0.25)
    kinds = monitor.alert_counts()
    assert kinds["bound_violation"] == 1 and kinds["deadline_miss"] == 1
    miss = next(a for a in monitor.alerts if a.kind == "deadline_miss")
    assert miss.value == 250.0


def test_rt_service_needs_the_admitted_spec_and_its_shape():
    eng, spec, prompts = _service_engine()
    with pytest.raises(ValueError):
        eng.rt_service(spec, prompts)
    assert eng.rt_bound is None
    assert eng.rt_register(AdmissionController(gn_total=8), spec).admitted
    with pytest.raises(ValueError):
        eng.rt_service(dataclasses.replace(spec, name="other"), prompts)
    with pytest.raises(ValueError):
        eng.rt_service(spec, prompts[:, :4])


def test_trace_pool_hands_out_disjoint_views():
    from repro_torch.kernels.persistent_matmul import TracePool

    pool = TracePool(10, "cpu")
    sm_a, hits_a = pool.take(4)
    sm_b, hits_b = pool.take(6)
    assert pool.used == 10 and sm_a.numel() == 4 and hits_b.numel() == 6
    assert bool((sm_b == -1).all()) and bool((hits_a == 0).all())
    hits_a += 1
    assert int(pool.tile_hits[:4].sum()) == 4 and int(pool.tile_hits[4:].sum()) == 0
    with pytest.raises(RuntimeError):
        pool.take(1)
