"""Batched serving engine: prefill + decode loop with KV-cache management
and samplers, usable standalone or under an RT admission controller.

Counterpart of ``repro.serving.engine``.  The caches and the step's
inputs and outputs are static: allocated once per engine (its batch and
``max_context``) and written in place.  Each job resets them, then runs a
prefill step and a decode step per token; the sampled tokens collect in a
device buffer, copied to the host once a job.  On the card each step is a
CUDA graph replay (:class:`~repro_torch.serving.graphs.StepGraph`, as the
JAX engine ``jax.jit``s its steps), captured per prompt length and per
(n_bands, first SM) of the pinned matmuls, which the capture bakes into
the kernels' arguments, and never inside a served job (see
:class:`ServingEngine`); on the CPU the same step functions run eagerly
on the same buffers.  Steps are timed with CUDA events on the card and
with ``perf_counter`` on the CPU.  On the card an engine asks for
admission with a task measured there (:meth:`ServingEngine.rt_register`),
and once admitted runs its prefill and decode matmuls on the GN SMs it
holds (``ops.on_sms``).  :meth:`ServingEngine.rt_service` is the admitted
service as ``WallClockExecutor`` runs it, and :func:`executor_events`
hands that run to ``BoundMonitor``.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import interleave_probe, ops
from repro_torch.models import Model, ModelConfig
from repro_torch.runtime.admission import AdmissionDecision
from repro_torch.runtime.executor import Service
from repro_torch.runtime.task_spec import DecodeCalibration, kernel_type, serving_task_to_rt
from repro_torch.sched import TraceEvent

from .graphs import StepGraph

__all__ = ["ServeConfig", "ServingEngine", "Steps", "calibration_sms", "device_activities",
           "device_busy_ms", "executor_events", "profiled_ms", "sample_greedy", "sample_topk"]

CALIBRATION_STEPS = 6   # decode steps profiled at each SM count
CALIBRATION_PREFILLS = 3  # prefills timed at each SM count, after one untimed
CALIBRATION_JOBS = 40   # whole jobs timed at each SM count of the first calibration
READMITS = 10           # admissions tried until the granted GN is a measured count

# the engines registered now, each to be told when its controller's
# allocation changes (another engine registers or departs there)
_REGISTERED: "weakref.WeakSet[ServingEngine]" = weakref.WeakSet()


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
    sampler: str = "greedy"  # greedy | topk (top-k on the CPU only)


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


class _Static:
    """One engine's device state between steps: the caches, each row's
    ``cache_len``, the prompt of each length, the last sampled token, the
    decode step's index and the tokens it has emitted.  Plain tensors, not
    inference tensors, so they can be written outside inference mode."""

    @torch.inference_mode(False)
    def __init__(self, model: Model, batch: int, max_context: int):
        dev = model.device
        self.caches = model.init_caches(batch, max_context)
        self.cache_len = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.out = torch.zeros((batch, max_context), dtype=torch.int32, device=dev)
        self.prompts: dict[int, torch.Tensor] = {}

    @torch.inference_mode(False)
    def prompt(self, seq_len: int) -> torch.Tensor:
        if seq_len not in self.prompts:
            self.prompts[seq_len] = torch.zeros((self.tok.shape[0], seq_len),
                                                dtype=torch.int32, device=self.tok.device)
        return self.prompts[seq_len]


class Steps:
    """A job's two steps at one prompt length, on one (n_bands, first SM):
    ``prefill()`` and ``decode()``, CUDA graph replays (``graphs``, a
    (prefill, decode) pair of :class:`StepGraph`) or eager calls."""

    def __init__(self, prefill: Callable[[], None], decode: Callable[[], None],
                 graphs: Optional[tuple[StepGraph, StepGraph]] = None):
        self.graphs = graphs
        self.prefill = prefill if graphs is None else graphs[0].replay
        self.decode = decode if graphs is None else graphs[1].replay


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

    On the card the steps are graphs captured off the job path: an
    unregistered engine's first job of a prompt length captures them, as
    ``jax.jit`` compiles at its first call; a registered service's are
    captured when it is admitted and again, at the job boundary where the
    change is made, whenever another engine's registration or departure
    on its controller moves its SMs (:meth:`rt_regraph`), and the graphs
    of SMs it no longer holds are dropped.  A served job never captures:
    on SMs without graphs it raises.
    """

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, params=None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.serve = serve
        self._rt = None            # (controller, service name, task) when admitted
        self._rt_seq_len = 0       # the admitted spec's prompt length
        self.rt_calibration: Optional[DecodeCalibration] = None
        self.model = Model(cfg, device=device)
        if params is None:
            self.model.init_params(seed)
        else:
            self.model.load_state_dict(params)
        self.device = self.model.device
        self._sample = sample_greedy if serve.sampler == "greedy" else sample_topk
        self._static: Optional[_Static] = None
        self._graphs: dict[tuple, tuple[StepGraph, StepGraph]] = {}
        self._pool = None

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

        Once admitted, the service's steps are captured on the SMs it is
        granted, and every engine registered on ``controller`` captures
        anew where the admission moved its SMs (:meth:`rt_regraph`).

        One card is one host: a multi-host front door is refused, since
        its allocation does not say which services share this card."""
        if getattr(controller, "hosts", 1) != 1:
            raise ValueError("register with the front door of this card's host alone")
        if self.device.type != "cuda":
            dec = self._admit(controller, spec, serving_task_to_rt(spec), t)
        else:
            dec = self._admit_measured(controller, spec, t)
        _regraph_all(controller)
        return dec

    def _admit_measured(self, controller, spec, t: float):
        cal = self.rt_calibration
        if cal is None or cal.shape != (spec.batch, spec.seq_len, spec.new_tokens):
            cal = self.calibrate(spec)
        for _ in range(READMITS):
            dec = self._admit(controller, spec, cal.task(spec), t)
            if not dec.admitted or dec.alloc[spec.name] in cal.measured:
                return dec
            gn = dec.alloc[spec.name]
            self._depart(t)
            cal.measured.update(self.measure_decode(_prompts(spec, self.cfg.vocab), (gn,)))
        return AdmissionDecision(False, None, reason=f"the granted GN was not a measured SM "
                                 f"count after {READMITS} admissions")

    def _admit(self, controller, spec, task, t: float):
        if hasattr(controller, "job_boundary"):   # online ctl/broker: clocked
            dec = controller.admit(task, t=t)
        else:                                     # static wrapper front door
            dec = controller.admit(task)
        if dec.admitted:
            self._rt = (controller, spec.name, task)
            self._rt_seq_len = spec.seq_len
            _REGISTERED.add(self)
        return dec

    def calibrate(self, spec) -> DecodeCalibration:
        """Measure ``spec``'s job (random prompt tokens from a fixed seed,
        ``spec.new_tokens`` decode steps) on the card at the
        :func:`calibration_sms` of its SM count, ``CALIBRATION_JOBS`` whole
        jobs at each, and the interleave ratio α of the step's kernel type
        on each of those counts (Fig. 6's probe,
        ``kernels.interleave_probe``; the largest is kept); kept as
        ``rt_calibration``, which :meth:`rt_register` reuses."""
        sms = calibration_sms(torch.cuda.get_device_properties(
            self.device).multi_processor_count)
        meas = self.measure_decode(_prompts(spec, self.cfg.vocab), sms, spec.new_tokens,
                                   CALIBRATION_JOBS)
        alpha = None
        if self.device.type == "cuda":
            ktype = kernel_type(spec)
            alpha = max(interleave_probe.measure_alpha(ktype, m)["alpha"] for m in sms)
        self.rt_calibration = DecodeCalibration(spec.batch, spec.seq_len, spec.new_tokens, meas,
                                                alpha)
        return self.rt_calibration

    def rt_deregister(self, t: float = 0.0) -> bool:
        """Depart from the scheduler (job-boundary reclamation); the graphs
        of the SMs it held are dropped, and every engine still registered
        on the controller captures anew where its SMs moved."""
        if self._rt is None:
            return False
        controller = self._rt[0]
        left = self._depart(t)
        self.rt_regraph()
        _regraph_all(controller)
        return left

    def _depart(self, t: float) -> bool:
        controller, name, _ = self._rt
        self._rt = None
        _REGISTERED.discard(self)
        if hasattr(controller, "release"):
            return controller.release(name, t=t)
        return controller.remove(name)

    def rt_regraph(self) -> float:
        """Hold graphs for the SMs the service holds now and drop the rest:
        admitted, the steps of its spec's prompt length on :attr:`sm_range`
        (captured if they are not yet); not admitted, those on all SMs.
        Called by every registration and departure on the controller, at
        the job boundary where it is made; call it after changing the
        controller's allocation by other means.  The seconds it took."""
        if not self.graphs:
            return 0.0
        held = self.sm_range or (None, 0)
        self._drop_graphs([k for k in self._graphs if k[1] != held])
        if self._rt is None:
            return 0.0
        return self.capture(self._rt_seq_len, held)

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
        which reads :attr:`sm_range` as it starts and replays the graphs
        captured there at admission or at the last change of its SMs."""
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
        admission's re-balance takes effect at this service's next job, on
        the graphs that admission captured (:meth:`rt_regraph`)."""
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
        """One job on the SMs the service holds (all, when not admitted).
        Not admitted, its first job of a prompt length captures the steps;
        admitted, a job runs the graphs captured at admission or raises."""
        return self._generate(prompts, max_new_tokens, generator, self.sm_range or (None, 0),
                              lazy=self._rt is None)

    # ---- the steps ----------------------------------------------------------

    @property
    def graphs(self) -> bool:
        """Whether the steps are CUDA graph replays: on the card."""
        return self.device.type == "cuda"

    def _state(self) -> _Static:
        if self._static is None:
            self._static = _Static(self.model, self.serve.batch, self.serve.max_context)
        return self._static

    def _prefill_step(self, seq_len: int, generator) -> None:
        """Reset the job's state, fill the caches from the prompt and
        sample the first token."""
        st, model = self._static, self.model
        model.reset_caches(st.caches, st.cache_len)
        logits, _ = model.prefill(st.prompts[seq_len], st.caches)
        st.cache_len.add_(seq_len)
        st.step.zero_()
        st.tok.copy_(self._sample(generator, logits[:, -1, :])[:, None])

    def _decode_step(self, generator) -> None:
        """Emit the last token, run it through the model (writing its K/V
        at ``cache_len``) and sample the next."""
        st = self._static
        st.out.index_copy_(1, st.step, st.tok)
        logits, _ = self.model.decode_step(st.tok, st.caches, st.cache_len)
        st.cache_len.add_(1)
        st.step.add_(1)
        st.tok.copy_(self._sample(generator, logits[:, -1, :])[:, None])

    def steps(self, seq_len: int, held: tuple[Optional[int], int] = (None, 0),
              generator: Optional[torch.Generator] = None, eager: bool = False) -> Steps:
        """The prefill and decode steps of [batch, seq_len] prompts with the
        pinned matmuls on ``held`` = (n_bands, first SM): on the card the
        replays of the graphs :meth:`capture` made (none made: it raises),
        on the CPU (or ``eager``, the card's reference) eager calls."""
        self._state().prompt(seq_len)

        def prefill():
            with torch.inference_mode(), ops.on_sms(*held):
                self._prefill_step(seq_len, generator)

        def decode():
            with torch.inference_mode(), ops.on_sms(*held):
                self._decode_step(generator)

        if eager or not self.graphs:
            return Steps(prefill, decode)
        if (seq_len, held) not in self._graphs:
            raise RuntimeError(f"no graphs of {seq_len}-token prompts on SMs {held}: a job never "
                               f"captures; capture them first (capture, rt_regraph)")
        return Steps(prefill, decode, self._graphs[seq_len, held])

    def capture(self, seq_len: int, held: tuple[Optional[int], int] = (None, 0)) -> float:
        """Capture the steps of ``seq_len`` prompts on ``held`` if they are
        not captured yet; the seconds it took (0 if they were).  Top-k
        sampling is refused: a graph's draws are not checked on the card."""
        t0 = time.perf_counter()
        if self.graphs and (seq_len, held) not in self._graphs:
            if self.serve.sampler != "greedy":
                raise ValueError(f"{self.serve.sampler} sampling inside a CUDA graph is not "
                                 f"checked on the card: serve greedy there")
            eager = self.steps(seq_len, held, eager=True)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._graphs[seq_len, held] = (StepGraph(eager.prefill, self._pool),
                                           StepGraph(eager.decode, self._pool))
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    def release_graphs(self) -> None:
        """Drop every captured step and their memory pool."""
        self._drop_graphs(list(self._graphs))

    def _drop_graphs(self, keys) -> None:
        for key in keys:
            del self._graphs[key]
        if not self._graphs:
            # a pool whose graphs are all gone takes no further capture
            self._pool = None

    @torch.inference_mode()
    def _generate(self, prompts, max_new_tokens, generator, held, lazy: bool = False,
                  eager: bool = False, spans: Optional[dict] = None) -> tuple[np.ndarray, dict]:
        """One job, its pinned matmuls on ``held`` = (n_bands, first SM);
        ``lazy`` captures its steps first where they are not, ``eager``
        issues them op by op (the card's reference for the graphs).  A
        ``spans`` dict given receives the prefill's span (``prefill_s``)
        and each decode step's (``decode_s``), in seconds."""
        b, s = prompts.shape
        if b != self.serve.batch:
            raise ValueError(f"batch {b} != ServeConfig.batch {self.serve.batch}")
        if s + max_new_tokens > self.serve.max_context:
            raise ValueError("prompt + new tokens exceed max_context")
        if lazy and not eager:
            self.capture(s, held)
        steps = self.steps(s, held, generator, eager)
        st = self._static
        st.prompts[s].copy_(torch.as_tensor(prompts, dtype=torch.int32))
        prefill_t, decode_t = _StepTimer(self.device), _StepTimer(self.device)
        prefill_t.start()
        steps.prefill()
        prefill_t.stop()
        for _ in range(max_new_tokens):
            decode_t.start()
            steps.decode()
            decode_t.stop()
        out = st.out[:, :max_new_tokens].to("cpu", copy=True).numpy()
        decode_s = decode_t.seconds()
        stats = {
            "prefill_s": prefill_t.seconds()[0],
            "decode_s_per_tok": float(np.mean(decode_s)) if decode_s else 0.0,
            "tokens": b * max_new_tokens,
        }
        if spans is not None:
            spans.update(prefill_s=stats["prefill_s"], decode_s=decode_s)
        return out, stats

    def timed_job(self, prompts: np.ndarray, new_tokens: int,
                  held: tuple[Optional[int], int] = (None, 0)) -> dict:
        """One job (:meth:`_generate` on ``held``) timed on the host clock,
        with a synchronise on both sides on the card, and its wall split in
        ms: ``prefill_span_ms`` and ``step_span_ms`` (one per decode step)
        are the steps' own spans (CUDA events around each replay on the
        card, ``perf_counter`` on the CPU), and ``rest_ms`` is the wall less
        those spans: every gap between two steps' events, the prompt's copy
        to the card, the host's part of sampling and the tokens' copy back.
        The three parts add up to the wall exactly: no millisecond is
        counted twice and none is left out."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        spans: dict = {}
        sync()
        t0 = time.perf_counter()
        self._generate(prompts, new_tokens, None, held, spans=spans)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prefill_ms = spans["prefill_s"] * 1e3
        steps_ms = [t * 1e3 for t in spans["decode_s"]]
        return {"wall_ms": wall_ms, "prefill_span_ms": prefill_ms, "step_span_ms": steps_ms,
                "rest_ms": wall_ms - prefill_ms - sum(steps_ms)}

    @torch.inference_mode()
    def measure_decode(self, prompts: np.ndarray, sms, new_tokens: int = 0,
                       jobs: int = 0) -> dict:
        """Each prefill's wall, each profiled decode step's device-busy time
        and each whole job's wall and its split, in ms, with the pinned
        matmuls on m SMs, for each m in ``sms``: ``{m: {"capture_s": s,
        "prefill_ms": [...], "device_ms": [...], "device_activities": [...],
        "job_ms": [...], "prefill_span_ms": [...], "step_span_ms": [[...],
        ...], "rest_ms": [...]}}`` (``device_activities``: what the profiler
        recorded of each step; the last three, one entry per job: its
        prefill's device span, its decode steps' and the rest of its wall,
        which add up to the wall exactly, :meth:`timed_job`).  On the card
        only.

        Each m's steps are captured just before its measurements
        (``capture_s``, 0 where they were), so each measurement is of what
        :meth:`generate` runs, and m's jobs start, as a served job does
        after admission's capture, in the state a capture leaves.  A job's
        steps run at one of two levels about 8% apart whatever precedes
        them: at the slow one the card idles between the replayed graphs'
        kernels, which run no slower (``scripts/host_regimes.py``).  The
        spans carry whichever level the jobs met into t(m), the rest into
        the host's part.
        After one untimed prefill of ``prompts``, ``CALIBRATION_PREFILLS``
        are timed on the host clock with a synchronise on both sides, each
        with the prompt's copy to the card, as a job starts.  After the
        last, ``CALIBRATION_STEPS`` decode steps each run in a profiler
        window of its own (:func:`profiled_ms`), after an unprofiled one.
        Then ``jobs`` whole jobs of ``new_tokens`` decode steps, each what
        :meth:`generate` runs, are timed by :meth:`timed_job`, with no
        profiler on the job path."""
        if self.device.type != "cuda":
            raise RuntimeError("measuring the decode step needs the card")

        b, s = prompts.shape
        if s + CALIBRATION_STEPS + 1 > self.serve.max_context:
            raise ValueError("prompt + measured steps exceed max_context")
        host = torch.as_tensor(prompts, dtype=torch.int32)
        out = {}
        for m in sms:
            capture_s = self.capture(s, (m, 0))
            steps, prompt = self.steps(s, (m, 0)), self._static.prompts[s]
            prefill_ms = []
            for i in range(CALIBRATION_PREFILLS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prompt.copy_(host)
                steps.prefill()
                torch.cuda.synchronize()
                if i:
                    prefill_ms.append((time.perf_counter() - t0) * 1e3)
            steps.decode()
            profiles = [profiled_ms(steps.decode)[1:] for _ in range(CALIBRATION_STEPS)]
            busy = [ms for ms, _ in profiles]
            if not all(busy):
                raise RuntimeError(f"the profiler saw no device time on {m} SMs")
            timed = [self.timed_job(prompts, new_tokens, (m, 0)) for _ in range(jobs)]
            out[m] = {"capture_s": capture_s, "prefill_ms": prefill_ms, "device_ms": busy,
                      "device_activities": [n for _, n in profiles],
                      "job_ms": [j["wall_ms"] for j in timed],
                      **{key: [j[key] for j in timed]
                         for key in ("prefill_span_ms", "step_span_ms", "rest_ms")}}
        return out


def _regraph_all(controller) -> None:
    """Every engine registered on ``controller`` holds the graphs of the SMs
    it holds now."""
    for engine in list(_REGISTERED):
        if engine._rt is not None and engine._rt[0] is controller:
            engine.rt_regraph()


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
    others): its result, its device-busy ms and the device activities the
    profiler recorded (a window that lost some undercounts the time)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    return out, device_busy_ms(prof), device_activities(prof)


def _device_rows(prof):
    return [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]


def device_busy_ms(prof) -> float:
    """Kernel time summed over a ``torch.profiler`` window, in ms."""
    total_us = 0.0
    for e in _device_rows(prof):
        us = getattr(e, "self_device_time_total", None)
        total_us += us if us is not None else getattr(e, "self_cuda_time_total", 0.0)
    return total_us / 1e3


def device_activities(prof) -> int:
    """Device activities (kernels, copies, sets) a ``torch.profiler``
    window recorded."""
    return sum(e.count for e in _device_rows(prof))
