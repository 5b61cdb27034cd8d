"""A calibration job's wall split on the job path, each part bounded by
the segment that carries it, and the measured interleave ratio in the
measured task.

Split: a job's prefill span, its decode steps' spans and its rest add up
to its wall.  Bounds: t(m) takes a job's decode-step span where it exceeds
every profiled step, CPU segment 0 a job's prefill span, the host bound
the rests; so the job's R̂ covers every calibration wall, also when half of
a count's jobs run slower on the device.  α: a measured α below 1 is
refused, and the measured α replaces the paper table's in GR̂.  The
held-out script's counts of rests and steps.  Synthetic inputs from numpy
seeds; one test times a smoke model's job on the CPU.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import INTERLEAVE_RATIO_MAX
from repro_torch.kernels import interleave_probe
from repro_torch.runtime import ServingTaskSpec, serving_task_to_rt
from repro_torch.runtime.task_spec import (DecodeCalibration, StepFit, job_response_ms,
                                           kernel_type, measured_task_to_rt, pwcet_ms)
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving import engine as serving_engine

REPO = Path(__file__).resolve().parents[1]
COUNTS = (16, 33, 66, 99, 132)


def _spec(**kw):
    base = dict(name="chat", arch_id="qwen3-0.6b", period_ms=2e9, deadline_ms=1e9, batch=4,
                seq_len=256, new_tokens=16, dominant="memory_s", vocab=151936)
    return ServingTaskSpec(**{**base, **kw})


def _split_row(m: int, rng, slow_share: float = 0.0, slow: float = 1.08, jobs: int = 40) -> dict:
    """One count's measurements as ``measure_decode`` gives them: profiled
    busy steps at the fast level; each job's prefill and 16 step spans
    (the jobs of ``slow_share`` at ``slow`` times the fast level), a
    Gumbel rest, and the wall their sum."""
    prefill, step = 12.0 + 200.0 / m, 10.0 + 70.0 / m
    row = {"prefill_ms": [prefill + 0.3, prefill + 0.1, prefill + 0.2],
           "device_ms": [step, step + 0.02, step + 0.05],
           "prefill_span_ms": [], "step_span_ms": [], "rest_ms": [], "job_ms": []}
    for j in range(jobs):
        level = slow if j < slow_share * jobs else 1.0
        steps = list(level * (step + rng.uniform(0.0, 0.05, 16)))
        pre = level * (prefill + rng.uniform(0.0, 0.1))
        rest = 1.0 + rng.gumbel(0.0, 0.2)
        row["prefill_span_ms"].append(pre)
        row["step_span_ms"].append(steps)
        row["rest_ms"].append(rest)
        row["job_ms"].append(pre + sum(steps) + rest)
    return row


def _split_calibration(seed: int = 0, slow_share: float = 0.0, alpha=None) -> DecodeCalibration:
    rng = np.random.default_rng(seed)
    return DecodeCalibration(4, 256, 16, {m: _split_row(m, rng, slow_share) for m in COUNTS},
                             alpha)


# ---------------------------------------------------------------- the split


def test_rest_and_spans_add_up_to_the_wall():
    """A job timed as the calibration times it (here on the CPU, the spans
    by perf_counter): its prefill span, decode-step spans and rest add up
    to its wall, each span lies inside the wall and the rest is what is
    left, at least 0."""
    eng = ServingEngine(get_smoke_config("qwen3-0.6b"), ServeConfig(max_context=32, batch=2),
                        device="cpu")
    prompts = np.random.default_rng(0).integers(0, eng.cfg.vocab, (2, 8)).astype(np.int32)
    for held in ((None, 0), (3, 1)):
        job = eng.timed_job(prompts, 3, held)
        assert len(job["step_span_ms"]) == 3 and job["prefill_span_ms"] > 0
        assert all(t > 0 for t in job["step_span_ms"])
        parts = job["prefill_span_ms"] + sum(job["step_span_ms"]) + job["rest_ms"]
        assert parts == pytest.approx(job["wall_ms"], rel=1e-12, abs=1e-9)
        assert 0 <= job["rest_ms"] < job["wall_ms"]


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_jobs_split_into_spans_and_rests(seed):
    """On rows shaped as ``measure_decode`` gives them, the host's part of
    each job is its rest, and the spans plus the rest give back the wall."""
    cal = _split_calibration(seed)
    for m, row in cal.measured.items():
        assert cal.host_parts_ms(m) == pytest.approx(np.array(row["rest_ms"]), abs=1e-12)
        for wall, pre, steps, rest in zip(row["job_ms"], row["prefill_span_ms"],
                                          row["step_span_ms"], row["rest_ms"]):
            assert pre + sum(steps) + rest == pytest.approx(wall, abs=1e-9)
    assert cal.host_pwcets_ms() == pytest.approx(
        {m: pwcet_ms(row["rest_ms"]) for m, row in cal.measured.items()})


def test_measure_decode_keeps_each_jobs_split(monkeypatch):
    """``measure_decode`` keeps, per count, each timed job's wall and its
    three parts in the order timed (stubs stand in for the card)."""
    eng = ServingEngine(get_smoke_config("qwen3-0.6b"), ServeConfig(max_context=32, batch=2),
                        device="cpu")
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(eng, "capture", lambda *a: 0.0)
    monkeypatch.setattr(eng, "steps", lambda s, held, **kw: ServingEngine.steps(
        eng, s, held, eager=True))
    monkeypatch.setattr(serving_engine, "profiled_ms", lambda fn: (fn(), 1.5, 7))
    jobs = iter(range(100))

    def timed(prompts, new_tokens, held):
        i = next(jobs)
        return {"wall_ms": 10.0 + i, "prefill_span_ms": 2.0, "step_span_ms": [3.0] * new_tokens,
                "rest_ms": 10.0 + i - 2.0 - 3.0 * new_tokens}

    monkeypatch.setattr(eng, "timed_job", timed)
    prompts = np.zeros((2, 8), np.int32)
    out = eng.measure_decode(prompts, (4, 8), new_tokens=2, jobs=3)
    assert out[8]["job_ms"] == [13.0, 14.0, 15.0]
    assert out[8]["step_span_ms"] == [[3.0, 3.0]] * 3 and out[8]["prefill_span_ms"] == [2.0] * 3
    assert out[8]["rest_ms"] == [5.0, 6.0, 7.0]
    assert out[4]["device_ms"] == [1.5] * serving_engine.CALIBRATION_STEPS


# ------------------------------------------------------------------ the bounds


def test_t_m_takes_a_job_step_span_over_every_profiled_step():
    cal = _split_calibration(2)
    row = cal.measured[33]
    assert cal.step_ms(33) == max(max(row["device_ms"]),
                                  max(t for job in row["step_span_ms"] for t in job))
    row["step_span_ms"][7][3] = max(row["device_ms"]) + 5.0
    assert cal.step_ms(33) == max(row["device_ms"]) + 5.0
    assert cal.fit().device_ms[cal.fit().sms.index(33)] == cal.step_ms(33)
    row["device_ms"].append(100.0)   # a profiled step above every span
    assert cal.step_ms(33) == 100.0
    # a count measured without whole jobs (a granted GN) keeps its profiled steps
    cal.measured[48] = {"prefill_ms": [20.0], "device_ms": [12.0, 12.5], "job_ms": []}
    assert cal.step_ms(48) == 12.5


def test_prefill_ms_covers_a_job_prefill_span():
    cal = _split_calibration(3)
    walls = max(max(row["prefill_ms"]) for row in cal.measured.values())
    spans = max(max(row["prefill_span_ms"]) for row in cal.measured.values())
    assert cal.prefill_ms() == max(walls, spans)
    cal.measured[66]["prefill_span_ms"][12] = walls + 4.0
    assert cal.prefill_ms() == walls + 4.0
    assert cal.task(_spec()).cpu_hi[0] == serving_task_to_rt(_spec()).cpu_hi[0] + walls + 4.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_r_hat_covers_every_wall_when_half_the_jobs_run_slower_on_the_device(seed):
    """Half of every count's jobs run 8% slower on the device than the
    profiled steps: t(m) takes their steps, so the job's R̂ on each count
    still covers every calibration wall there.  The host bound stays the
    rests' pWCET, below the earlier rule's, which counted the slow level's
    device time as host time."""
    spec = _spec()
    cal = _split_calibration(seed, slow_share=0.5)
    for m, row in cal.measured.items():
        assert cal.step_ms(m) >= 1.08 * min(row["device_ms"]) > max(row["device_ms"])
    task = cal.task(spec)
    for m, row in cal.measured.items():
        assert job_response_ms(task, m) >= max(row["job_ms"])
    assert cal.host_bound_ms() < cal.earlier_host_bound_ms()
    assert cal.host_bound_ms() == max(pwcet_ms(row["rest_ms"]) for row in cal.measured.values())


def test_rows_without_spans_keep_the_earlier_rule():
    """A row whose jobs carry no split (a calibration timed without spans)
    gives the wall less the device's earlier lower bound as the host part."""
    cal = _split_calibration(4)
    for key in ("prefill_span_ms", "step_span_ms", "rest_ms"):
        del cal.measured[99][key]
    assert cal.host_parts_ms(99) == pytest.approx(cal.earlier_host_parts_ms(99))
    lower = min(cal.measured[99]["prefill_ms"]) + 16 * min(cal.measured[99]["device_ms"])
    assert cal.earlier_host_parts_ms(99) == pytest.approx(
        np.array(cal.measured[99]["job_ms"]) - lower)
    assert cal.step_ms(99) == max(cal.measured[99]["device_ms"])


# -------------------------------------------------------------------------- α


def test_a_measured_alpha_below_one_is_refused():
    spec = _spec()
    fit = StepFit(sms=(16, 66, 132), device_ms=(21.0, 12.5, 10.5), a_ms=175.0, l_ms=9.0)
    for alpha in (0.999, 0.5, float("nan")):
        with pytest.raises(ValueError, match="interleave ratio"):
            measured_task_to_rt(spec, fit, 1.0, 30.0, alpha=alpha)
        with pytest.raises(ValueError, match="interleave ratio"):
            _split_calibration(0, alpha=alpha).task(spec)
    assert measured_task_to_rt(spec, fit, 1.0, 30.0, alpha=1.0).gpu[0].alpha == 1.0


@pytest.mark.parametrize("alpha", [1.0, 1.612, 1.95])
def test_the_measured_alpha_sets_gr_hat(alpha):
    """The task takes the measured α of its kernel type in place of the
    table's, and Lemma 5.1's GR̂ on 2m virtual SMs is Aα/m + L(α−1)/2m + L,
    at least the fit's envelope A/m + L."""
    spec = _spec()
    cal = _split_calibration(5, alpha=alpha)
    table = dataclasses.replace(cal, alpha=None)
    assert kernel_type(spec) == "memory"
    assert table.task(spec).gpu[0].alpha == INTERLEAVE_RATIO_MAX["memory"]
    task, fit = cal.task(spec), cal.fit()
    assert all(seg.alpha == alpha for seg in task.gpu)
    assert task.cpu_hi == table.task(spec).cpu_hi
    for m in (16, 45, 132):
        gr = task.gpu[0].response_bounds(2 * m)[1]
        a, l = fit.a_ms, fit.l_ms
        assert gr == pytest.approx(a * alpha / m + l * (alpha - 1) / (2 * m) + l)
        assert gr >= a / m + l - 1e-9
    r_hat, r_hat_table = job_response_ms(task, 45), job_response_ms(table.task(spec), 45)
    assert r_hat < r_hat_table if alpha < INTERLEAVE_RATIO_MAX["memory"] else r_hat > r_hat_table


def test_calibrate_takes_the_largest_alpha_measured_on_the_card(monkeypatch):
    """On the card ``calibrate`` measures the step's kernel type's α on
    each calibrated count and keeps the largest; on the CPU none."""
    eng = ServingEngine(get_smoke_config("qwen3-0.6b"), ServeConfig(max_context=32, batch=2),
                        device="cpu")
    spec = _spec(batch=2, seq_len=8, new_tokens=2)

    def measure(prompts, sms, new_tokens=0, jobs=0):
        return {m: {"prefill_ms": [40.0], "device_ms": [80.0 / m + 10.0],
                    "job_ms": [100.0 + j for j in range(jobs)]} for m in sms}

    asked = []

    def alpha(kind, m):
        asked.append((kind, m))
        return {"alpha": 1.0 + m / 1000}

    monkeypatch.setattr(eng, "measure_decode", measure)
    monkeypatch.setattr(interleave_probe, "measure_alpha", alpha)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _: type("P", (), {"multi_processor_count": 132}))
    assert eng.calibrate(spec).alpha is None and not asked
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    cal = eng.calibrate(spec)
    sms = serving_engine.calibration_sms(132)
    assert asked == [("memory", m) for m in sms] and cal.alpha == pytest.approx(1.132)


def test_the_probes_run_on_the_card_only():
    with pytest.raises(ValueError, match="kernel type"):
        interleave_probe.probe("vector", 16, 1, device="cpu")
    with pytest.raises(ValueError, match="card only"):
        interleave_probe.probe("memory", 16, 2, device="cpu")


# ---------------------------------------------------- the held-out script


def _holdout():
    spec = importlib.util.spec_from_file_location("pwcet_holdout",
                                                  REPO / "scripts" / "pwcet_holdout.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_holdout_counts_rests_and_steps():
    h = _holdout()
    rests = [1.0 + 0.01 * (i % 9) for i in range(97)] + [3.2, 1.0, 3.1]
    got = h.summarize_rests(rests, 3.0, 1e-3)
    assert got["over_host_bound"] == [97, 99] and got["host_ms"] == rests
    assert got["max_host_over_bound"] == pytest.approx(3.2 / 3.0)
    assert got["p_at_least_as_many_over_host_bound"] == pytest.approx(
        1 - 0.999 ** 100 - 100 * 1e-3 * 0.999 ** 99)
    steps = [[11.0] * 16 for _ in range(4)]
    steps[2][5] = 12.6
    got = h.summarize_steps(steps, 12.5)
    assert got["over_gr_hi"] == [2] and got["max_step_over_gr_hi"] == pytest.approx(12.6 / 12.5)
