"""Batched serving engine: prefill + decode loop with KV-cache management
and samplers, usable standalone or under an RT admission controller.

Counterpart of ``repro.serving.engine``.  Steps are timed with CUDA events
on the card and with ``perf_counter`` on the CPU.  On the card an engine
asks for admission with a task measured there (:meth:`ServingEngine.
rt_register`), and once admitted runs its prefill and decode matmuls on the
GN SMs it holds (``ops.on_sms``).  :meth:`ServingEngine.rt_service` is the
admitted service as ``WallClockExecutor`` runs it, and
:func:`executor_events` hands that run to ``BoundMonitor``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import ops
from repro_torch.models import Model, ModelConfig
from repro_torch.runtime.admission import AdmissionDecision
from repro_torch.runtime.executor import Service
from repro_torch.runtime.task_spec import DecodeCalibration, serving_task_to_rt
from repro_torch.sched import TraceEvent

__all__ = ["ServeConfig", "ServingEngine", "calibration_sms", "device_busy_ms",
           "executor_events", "profiled_ms", "sample_greedy", "sample_topk"]

CALIBRATION_STEPS = 6   # decode steps profiled at each SM count
CALIBRATION_PREFILLS = 3  # prefills timed at each SM count, after one untimed
CALIBRATION_JOBS = 16   # whole jobs timed at each SM count of the first calibration
READMITS = 10           # admissions tried until the granted GN is a measured count


def calibration_sms(n_sms: int) -> tuple[int, ...]:
    """The SM counts the decode step is first measured on: eighths of the
    card to all of it."""
    return tuple(sorted({n_sms // 8, n_sms // 4, n_sms // 2, 3 * n_sms // 4, n_sms}))


def sample_greedy(generator: Optional[torch.Generator], logits: torch.Tensor):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_topk(generator: Optional[torch.Generator], logits: torch.Tensor,
                k: int = 40, temperature: float = 0.8):
    """Sample among the k largest logits at ``temperature``; logits [..., V]."""
    v, idx = torch.topk(logits.float(), k, dim=-1)
    probs = torch.softmax(v / temperature, dim=-1)
    flat = probs.reshape(-1, k)
    choice = torch.multinomial(flat, 1, generator=generator).reshape(*v.shape[:-1], 1)
    return torch.gather(idx, -1, choice)[..., 0].to(torch.int32)


@dataclasses.dataclass
class ServeConfig:
    max_context: int = 512
    batch: int = 4
    sampler: str = "greedy"  # greedy | topk


class _StepTimer:
    """Seconds of device work between start() and stop(): CUDA events on
    the card (read after the caller's last synchronise), perf_counter on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._spans = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._spans.append([ev, None])
        else:
            self._spans.append([time.perf_counter(), None])

    def stop(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._spans[-1][1] = ev
        else:
            self._spans[-1][1] = time.perf_counter()

    def seconds(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in self._spans]
        return [b - a for a, b in self._spans]


class ServingEngine:
    """One model, fixed batch slots, continuous decode.

    ``params`` is a state dict (e.g. from :func:`repro_torch.convert.params_from_jax`);
    without it the weights are random from ``seed``.  Optionally registers
    with an online scheduler: ``rt_register`` asks a controller (anything
    with ``admit``; clocked controllers also have ``job_boundary``) to
    admit this engine's periodic decode service as an RTGPU task, and
    ``rt_deregister`` departs.  While admitted, ``sm_range`` is the
    (GN, first SM) the service holds now, and ``generate`` runs every
    pinned matmul there; otherwise it is None (all SMs).
    """

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, params=None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.serve = serve
        self._rt = None            # (controller, service name, task) when admitted
        self.rt_calibration: Optional[DecodeCalibration] = None
        self.model = Model(cfg, device=device)
        if params is None:
            self.model.init_params(seed)
        else:
            self.model.load_state_dict(params)
        self.device = self.model.device
        self._sample = sample_greedy if serve.sampler == "greedy" else sample_topk

    # ---- online-scheduler registration --------------------------------------

    def rt_register(self, controller, spec, t: float = 0.0):
        """Admit this engine's periodic decode service on ``controller``
        under ``spec.name``; returns the last decision.

        On the card the task is measured (:meth:`calibrate`, once per
        prompt shape), and after each admission the granted GN is measured
        too: while GN is not one of the measured counts, the service
        departs, the task is refitted with GN's points and asks again.  So
        the certified GR̂(GN) bounds the device-busy step measured on GN
        SMs.  On the CPU, which has no SMs to measure, the task is
        ``serving_task_to_rt(spec)``.

        One card is one host: a multi-host front door is refused, since
        its allocation does not say which services share this card."""
        if getattr(controller, "hosts", 1) != 1:
            raise ValueError("register with the front door of this card's host alone")
        if self.device.type != "cuda":
            return self._admit(controller, spec.name, serving_task_to_rt(spec), t)
        cal = self.rt_calibration
        if cal is None or cal.shape != (spec.batch, spec.seq_len, spec.new_tokens):
            cal = self.calibrate(spec)
        for _ in range(READMITS):
            dec = self._admit(controller, spec.name, cal.task(spec), t)
            if not dec.admitted or dec.alloc[spec.name] in cal.measured:
                return dec
            gn = dec.alloc[spec.name]
            self.rt_deregister(t)
            cal.measured.update(self.measure_decode(_prompts(spec, self.cfg.vocab), (gn,)))
        return AdmissionDecision(False, None, reason=f"the granted GN was not a measured SM "
                                 f"count after {READMITS} admissions")

    def _admit(self, controller, name: str, task, t: float):
        if hasattr(controller, "job_boundary"):   # online ctl/broker: clocked
            dec = controller.admit(task, t=t)
        else:                                     # static wrapper front door
            dec = controller.admit(task)
        if dec.admitted:
            self._rt = (controller, name, task)
        return dec

    def calibrate(self, spec) -> DecodeCalibration:
        """Measure ``spec``'s job (random prompt tokens from a fixed seed,
        ``spec.new_tokens`` decode steps) on the card at the
        :func:`calibration_sms` of its SM count, ``CALIBRATION_JOBS`` whole
        jobs at each; kept as ``rt_calibration``, which :meth:`rt_register`
        reuses."""
        sms = calibration_sms(torch.cuda.get_device_properties(
            self.device).multi_processor_count)
        meas = self.measure_decode(_prompts(spec, self.cfg.vocab), sms, spec.new_tokens,
                                   CALIBRATION_JOBS)
        jobs = tuple(w for m in sms for w in meas[m]["job_ms"])
        self.rt_calibration = DecodeCalibration(spec.batch, spec.seq_len, spec.new_tokens,
                                                meas, jobs)
        return self.rt_calibration

    def rt_deregister(self, t: float = 0.0) -> bool:
        """Depart from the scheduler (job-boundary reclamation)."""
        if self._rt is None:
            return False
        controller, name, _ = self._rt
        self._rt = None
        if hasattr(controller, "release"):
            return controller.release(name, t=t)
        return controller.remove(name)

    @property
    def rt_registered(self) -> bool:
        return self._rt is not None

    @property
    def rt_task(self):
        """The task admitted for this service (None when not admitted)."""
        return None if self._rt is None else self._rt[2]

    @property
    def rt_bound(self) -> Optional[tuple[float, int]]:
        """(certified R̂ in ms, GN) of the admitted service now, from its
        controller (behind the static ``AdmissionController``, from the
        online controller it wraps); None when not admitted."""
        if self._rt is None:
            return None
        controller, name, _ = self._rt
        return (getattr(controller, "dynamic", controller).bound(name),
                controller.allocation[name])

    def rt_service(self, spec, prompts: np.ndarray,
                   generator: Optional[torch.Generator] = None) -> Service:
        """The admitted service as ``WallClockExecutor`` runs it: released
        every ``spec.period_ms`` with deadline ``spec.deadline_ms``, each job
        one ``generate(prompts, spec.new_tokens)`` of the spec's shape,
        which reads :attr:`sm_range` as it starts."""
        if self._rt is None or self._rt[1] != spec.name:
            raise ValueError(f"{spec.name}: not admitted on this engine")
        if prompts.shape != (spec.batch, spec.seq_len):
            raise ValueError(f"prompts {prompts.shape} are not the spec's "
                             f"{(spec.batch, spec.seq_len)}")

        def run_job():
            self.generate(prompts, spec.new_tokens, generator)

        return Service(spec.name, period_s=spec.period_ms / 1e3,
                       deadline_s=spec.deadline_ms / 1e3, run_job=run_job)

    @property
    def sm_range(self) -> Optional[tuple[int, int]]:
        """(GN, first SM) the service holds now; None when not admitted.

        The services of one front door hold consecutive, disjoint ranges
        of the card, in the order of the controller's allocation table.
        ``generate`` reads it once, at the start of each job, so a later
        admission's re-balance takes effect at this service's next job."""
        if self._rt is None:
            return None
        controller, name, _ = self._rt
        alloc = controller.allocation
        first = 0
        for other, gn in alloc.items():
            if other == name:
                break
            first += gn
        if first + alloc[name] > controller.gn_total:
            raise RuntimeError(f"{name}: SMs {first}..{first + alloc[name] - 1} past the "
                               f"{controller.gn_total} of the card: only federated "
                               f"(disjoint) allocations map onto the card's SMs")
        return alloc[name], first

    def generate(
        self,
        prompts: np.ndarray,           # [B, S] int32
        max_new_tokens: int = 16,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[np.ndarray, dict]:
        return self._generate(prompts, max_new_tokens, generator, self.sm_range or (None, 0))

    @torch.inference_mode()
    def _generate(self, prompts, max_new_tokens, generator, held) -> tuple[np.ndarray, dict]:
        """One job, its pinned matmuls on ``held`` = (n_bands, first SM)."""
        b, s = prompts.shape
        if b != self.serve.batch:
            raise ValueError(f"batch {b} != ServeConfig.batch {self.serve.batch}")
        if s + max_new_tokens > self.serve.max_context:
            raise ValueError("prompt + new tokens exceed max_context")
        model = self.model
        caches = model.init_caches(b, self.serve.max_context)
        tokens = torch.as_tensor(prompts, dtype=torch.int32, device=self.device)

        out = np.zeros((b, max_new_tokens), np.int32)
        prefill_t, decode_t = _StepTimer(self.device), _StepTimer(self.device)
        with ops.on_sms(*held):
            prefill_t.start()
            logits, caches = model.prefill(tokens, caches)
            prefill_t.stop()

            cache_len = torch.full((b,), s, dtype=torch.int32, device=self.device)
            tok = self._sample(generator, logits[:, -1, :])[:, None]
            for i in range(max_new_tokens):
                out[:, i] = tok[:, 0].cpu().numpy()
                decode_t.start()
                logits, caches = model.decode_step(tok, caches, cache_len)
                decode_t.stop()
                cache_len = cache_len + 1
                tok = self._sample(generator, logits[:, -1, :])[:, None]
        decode_s = decode_t.seconds()
        stats = {
            "prefill_s": prefill_t.seconds()[0],
            "decode_s_per_tok": float(np.mean(decode_s)) if decode_s else 0.0,
            "tokens": b * max_new_tokens,
        }
        return out, stats

    @torch.inference_mode()
    def measure_decode(self, prompts: np.ndarray, sms, new_tokens: int = 0,
                       jobs: int = 0) -> dict:
        """Each prefill's wall, each decode step's device-busy time and
        each whole job's wall, in ms, with the pinned matmuls on m SMs, for
        each m in ``sms``: ``{m: {"prefill_ms": [...], "device_ms": [...],
        "job_ms": [...]}}``.  On the card only.

        After one untimed prefill of ``prompts``, ``CALIBRATION_PREFILLS``
        are timed on the host clock with a synchronise on both sides, each
        with the caches' allocation, as a job starts.  After the last,
        ``CALIBRATION_STEPS`` decode steps each run in a profiler window of
        its own (:func:`profiled_ms`).  Then ``jobs`` whole jobs of
        ``new_tokens`` decode steps, each what :meth:`generate` runs, are
        timed on the host clock with a synchronise on both sides: the
        host's issue plus the device's tail, sampling included."""
        if self.device.type != "cuda":
            raise RuntimeError("measuring the decode step needs the card")

        b, s = prompts.shape
        steps = CALIBRATION_STEPS
        if s + steps + 1 > self.serve.max_context:
            raise ValueError("prompt + measured steps exceed max_context")
        model = self.model
        tokens = torch.as_tensor(prompts, dtype=torch.int32, device=self.device)
        out = {}
        for m in sms:
            with ops.on_sms(m):
                prefill_ms = []
                for i in range(CALIBRATION_PREFILLS + 1):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    caches = model.init_caches(b, self.serve.max_context)
                    logits, caches = model.prefill(tokens, caches)
                    torch.cuda.synchronize()
                    if i:
                        prefill_ms.append((time.perf_counter() - t0) * 1e3)
                tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                cache_len = torch.full((b,), s, dtype=torch.int32, device=self.device)
                model.decode_step(tok, caches, cache_len)  # warm
                busy = []
                for _ in range(steps):
                    cache_len = cache_len + 1
                    busy.append(profiled_ms(model.decode_step, tok, caches, cache_len)[1])
            if not all(busy):
                raise RuntimeError(f"the profiler saw no device time on {m} SMs")
            job_ms = []
            for _ in range(jobs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                self._generate(prompts, new_tokens, None, (m, 0))
                torch.cuda.synchronize()
                job_ms.append((time.perf_counter() - t0) * 1e3)
            out[m] = {"prefill_ms": prefill_ms, "device_ms": busy, "job_ms": job_ms}
        return out


def executor_events(trace, admitted: dict[str, tuple[float, int]]) -> list[TraceEvent]:
    """A ``WallClockExecutor`` trace in ``BoundMonitor``'s terms: an
    ``admit`` per service of ``admitted`` (name -> (certified R̂ ms, GN),
    e.g. :attr:`ServingEngine.rt_bound`), then each job's ``complete`` with
    its ``response`` in ms and each ``miss`` with its ``overshoot`` in ms.
    The executor records seconds and no bound, which the monitor cannot
    read as they are."""
    out = [TraceEvent(0.0, "admit", name, (("bound", r_hat), ("gn", gn)))
           for name, (r_hat, gn) in admitted.items()]
    in_ms = {"complete": ("response", "response_s"), "miss": ("overshoot", "overshoot_s")}
    for ev in trace.events:
        if ev.kind in in_ms:
            key, seconds = in_ms[ev.kind]
            out.append(TraceEvent(ev.t, ev.kind, ev.task,
                                  ((key, dict(ev.meta)[seconds] * 1e3),)))
    return out


def _prompts(spec, vocab: int) -> np.ndarray:
    """Calibration prompts of ``spec``'s shape: random tokens, fixed seed."""
    rng = np.random.default_rng(0)
    return rng.integers(0, vocab, (spec.batch, spec.seq_len)).astype(np.int32)


def profiled_ms(fn, *args):
    """``fn(*args)`` in a ``torch.profiler`` window of its own, with a
    synchronise on both sides (so the window holds its kernels and no
    others): its result and its device-busy ms."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    return out, device_busy_ms(prof)


def device_busy_ms(prof) -> float:
    """Kernel time summed over a ``torch.profiler`` window, in ms."""
    total_us = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            total_us += us if us is not None else getattr(e, "self_cuda_time_total", 0.0)
    return total_us / 1e3
