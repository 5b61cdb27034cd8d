"""Discrete-event executor for RT CPU–bus–accelerator task sets.

This is the container-side stand-in for the paper's real-GPU experiment
(Figs. 12–13): it *executes* task sets under the RTGPU runtime rules —

  * CPU: preemptive fixed-priority (one core),
  * bus: non-preemptive fixed-priority (one PCIe-like channel),
  * accelerator: federated — every task owns 2·GN_i dedicated virtual SMs
    (chip-slice interleave lanes), so GPU segments start immediately after
    their copy-in completes (no contention by construction),

with per-job segment durations sampled from [lo, hi] (worst-case model:
lo == hi).  Observed response times validate the analysis bounds:
tests assert  observed R ≤ analytic R̂  for admitted sets.

Both entry points are thin policies over the one shared
:class:`repro_torch.runtime.engine.DiscreteEventEngine` (the arbitration loop
lives there, exactly once):

  * :func:`simulate` — :class:`_FixedTaskSetPolicy`: a frozen task set
    over a horizon, priority = taskset order (the seed behavior);
  * :func:`simulate_churn` — :class:`_ChurnPolicy`: dynamic membership —
    an admit/release event trace is fed through a
    :class:`repro_torch.sched.DynamicController`, slices are reclaimed only at
    job boundaries (mode-change protocol), and every completed job is
    checked against the analytic bound certified by the admission epoch it
    was released in;
  * :func:`simulate_fleet` — :class:`_FleetChurnPolicy`: multi-host churn —
    arrivals are routed by a :class:`repro_torch.sched.CapacityBroker` across N
    hosts (one CPU + bus + slice-pool resource lane each, lockstepped in
    one engine), departures trigger imbalance migrations executed through
    the mode-change protocol, and the same observed-R ≤ certified-R̂ check
    runs per job on whichever host it executed; an optional ``elastic``
    schedule grows (``add_host``) and shrinks (drain-then-retire) the
    fleet mid-run.

All record into an optional :class:`repro_torch.sched.EventTrace` (releases,
CPU preemptions, completions, deadline misses — host-tagged in the fleet
case); the golden corpus under ``tests/golden/`` pins their observable
behavior event by event.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import ChurnEvent, RTTask, SegmentKind, TaskSet
from repro_torch.sched import CapacityBroker, DynamicController, EventTrace

from .engine import DiscreteEventEngine, EngineJob, SchedulingPolicy

__all__ = [
    "SimResult",
    "simulate",
    "ChurnSimResult",
    "simulate_churn",
    "FleetSimResult",
    "simulate_fleet",
]

_EPS = 1e-9


@dataclasses.dataclass
class SimResult:
    responses: list[list[float]]          # per task, per completed job
    misses: list[int]                     # per task deadline misses
    jobs: list[int]                       # per task completed jobs

    @property
    def any_miss(self) -> bool:
        return any(m > 0 for m in self.misses)

    def max_response(self, i: int) -> float:
        return max(self.responses[i]) if self.responses[i] else 0.0


def _sample_durations(
    task: RTTask, alloc_vsm: int, rng, worst_case: bool = False
) -> list[float]:
    """One duration per chain segment, honoring [lo, hi] bounds and
    Lemma 5.1 for accelerator segments.  ``worst_case`` pins every segment
    to its upper bound (the Fig. 12 WCET execution model)."""
    out = []
    for kind, idx in task.chain():
        if kind is SegmentKind.CPU:
            lo, hi = task.cpu_lo[idx], task.cpu_hi[idx]
        elif kind is SegmentKind.MEM:
            lo, hi = task.mem_lo[idx], task.mem_hi[idx]
        else:
            lo, hi = task.gpu[idx].response_bounds(alloc_vsm)
        if worst_case or hi <= lo:
            out.append(hi)
        else:
            out.append(float(rng.uniform(lo, hi)))
    return out


class _FixedTaskSetPolicy(SchedulingPolicy):
    """Frozen membership: every task is resident for the whole run.

    Priority = taskset order (0 highest).  Sporadic releases: period T_i
    plus optional random inter-arrival slack (sporadic ≥ T).

    Incremental seam: membership is static (one shared group, priority =
    index order), so the only indexed structure is a release heap —
    entries are ``(release_time, task_index)``, lazily invalidated by
    comparing against ``self.releases`` (the single source of truth)."""

    incremental = True

    def __init__(
        self,
        taskset: TaskSet,
        alloc: list[int],
        rng: np.random.Generator,
        release_jitter: bool,
        worst_case: bool,
        preemption: str = "none",
        gpu_ctx_overhead: float = 0.0,
    ):
        self.taskset = taskset
        self.alloc = alloc
        self.rng = rng
        self.release_jitter = release_jitter
        self.worst_case = worst_case
        self._gpu_arbitration = (preemption, gpu_ctx_overhead)
        self.chains = [t.chain() for t in taskset]
        self.names = [t.name or f"task{i}" for i, t in enumerate(taskset)]
        self.releases = [
            float(rng.uniform(0, t.period)) if release_jitter else 0.0
            for t in taskset
        ]
        n = len(taskset)
        self.responses: list[list[float]] = [[] for _ in range(n)]
        self.misses = [0] * n
        self.completed = [0] * n

    def bind(self, engine: DiscreteEventEngine) -> None:
        super().bind(engine)
        engine.jobs = {i: None for i in range(len(self.taskset))}
        self._release_heap = [
            (self.releases[i], i) for i in range(len(self.taskset))
        ]
        heapq.heapify(self._release_heap)

    def _release_one(self, i: int) -> None:
        t = self.taskset[i]
        self.engine.start_job(i, EngineJob(
            release=self.releases[i],
            deadline_abs=self.releases[i] + t.deadline,
            chain=self.chains[i],
            durations=_sample_durations(
                t, 2 * self.alloc[i], self.rng, self.worst_case
            ),
        ))

    def release_jobs(self, now: float) -> None:
        eng = self.engine
        for i in range(len(self.taskset)):
            if eng.jobs[i] is None and self.releases[i] <= now + _EPS:
                self._release_one(i)

    def release_jobs_fast(self, now: float) -> None:
        # pop every due entry, drop the stale ones (an entry is live iff
        # it matches self.releases and the task is idle), then release in
        # index order — the same order the scan-based path produces, so
        # the RNG draw sequence is identical
        eng = self.engine
        heap = self._release_heap
        due = []
        while heap and heap[0][0] <= now + _EPS:
            t, i = heapq.heappop(heap)
            if self.releases[i] == t and eng.jobs[i] is None:
                due.append(i)
        due.sort()
        for i in due:
            self._release_one(i)

    def arbitration_order(self) -> list:
        return list(range(len(self.taskset)))

    def resource_groups(self) -> list:
        return [None]

    def sort_group(self, group, keys: list) -> list:
        keys.sort()
        return keys

    def next_external_time(self, now: float) -> float:
        return min(
            (self.releases[i] for i in range(len(self.taskset))
             if self.engine.jobs[i] is None),
            default=math.inf,
        )

    def next_external_time_fast(self, now: float) -> float:
        heap = self._release_heap
        while heap:
            t, i = heap[0]
            if self.releases[i] == t and self.engine.jobs[i] is None:
                return t
            heapq.heappop(heap)
        return math.inf

    def on_job_complete(self, key, job, now, response) -> None:
        eng = self.engine
        task = self.taskset[key]
        self.responses[key].append(response)
        self.completed[key] += 1
        eng.record("complete", key, response=response)
        if response > task.deadline + 1e-6:
            self.misses[key] += 1
            eng.record("miss", key, overshoot=response - task.deadline)
        # next sporadic release
        gap = (
            float(self.rng.uniform(0, 0.2 * task.period))
            if self.release_jitter else 0.0
        )
        self.releases[key] = max(job.release + task.period + gap, now)
        eng.jobs[key] = None
        heapq.heappush(self._release_heap, (self.releases[key], key))

    def display_name(self, key) -> str:
        return self.names[key]

    def gpu_arbitration(self) -> tuple[str, float]:
        return self._gpu_arbitration


def simulate(
    taskset: TaskSet,
    alloc: list[int],
    horizon: float,
    seed: int = 0,
    release_jitter: bool = True,
    worst_case: bool = False,
    trace: Optional[EventTrace] = None,
    preemption: str = "none",
    gpu_ctx_overhead: float = 0.0,
    engine_variant: Optional[str] = None,
) -> SimResult:
    """Run the RT executor for ``horizon`` time units.

    ``preemption`` selects the accelerator arbitration: ``"none"`` (the
    federated default — dedicated lanes, byte-identical to the seed
    behavior) or ``"priority"`` (preemptive priority-driven GPU context,
    ``gpu_ctx_overhead`` charged per preemption).

    ``engine_variant`` pins the event-loop implementation (``"indexed"``
    / ``"reference"``); ``None`` defers to ``REPRO_ENGINE`` (default
    indexed).  Both produce byte-identical traces."""
    policy = _FixedTaskSetPolicy(
        taskset, alloc, np.random.default_rng(seed), release_jitter,
        worst_case, preemption=preemption,
        gpu_ctx_overhead=gpu_ctx_overhead,
    )
    DiscreteEventEngine(policy, trace=trace,
                        variant=engine_variant).run(horizon)
    return SimResult(
        responses=policy.responses,
        misses=policy.misses,
        jobs=policy.completed,
    )


# ---- dynamic-membership executor (online scheduler validation) --------------


@dataclasses.dataclass
class ChurnSimResult:
    """Per-service outcome of a churn-trace run.

    ``responses[name][k]`` and ``bounds[name][k]`` pair each completed
    job's observed response with the analytic R̂ certified by the admission
    epoch the job was released in — the validation invariant is
    ``observed ≤ bound`` for every job, in every epoch, across the trace."""

    responses: dict[str, list[float]]
    bounds: dict[str, list[float]]
    misses: dict[str, int]
    jobs: dict[str, int]
    admitted: list[str]
    rejected: list[str]

    @property
    def any_miss(self) -> bool:
        return any(m > 0 for m in self.misses.values())

    def bound_violations(self, eps: float = 1e-6) -> list[str]:
        out = []
        for name, rs in self.responses.items():
            for r, b in zip(rs, self.bounds[name]):
                if r > b + eps:
                    out.append(f"{name}: observed {r:.3f} > bound {b:.3f}")
        return out

    @property
    def total_jobs(self) -> int:
        return sum(self.jobs.values())


class _ChurnPolicy(SchedulingPolicy):
    """Dynamic membership under the online controller.

    Every ``admit`` event goes through the controller's transitional
    analysis; rejected services never run.  A ``release`` event marks the
    service departing — its job in flight finishes and only then does
    :meth:`DynamicController.job_boundary` reclaim the slices (the
    mode-change protocol).  Each job samples durations with the task
    parameters and slice count *committed at its release*, and is checked
    against the analytic bound of that epoch.

    Incremental seam: one shared group; the priority order is the
    controller's deadline-sorted :meth:`~DynamicController.order`, so a
    capacity listener on the controller invalidates the engine's cached
    sort on every committed mutation (admit, reclaim, boundary commit,
    rate change).  Pending releases live in a lazily-invalidated heap of
    ``(time, membership_seq, name)`` — the membership sequence number
    reproduces the ``engine.jobs`` dict-insertion order the scan-based
    path releases same-time jobs in."""

    horizon_slack = _EPS
    incremental = True

    def __init__(
        self,
        events: Sequence[ChurnEvent],
        controller: DynamicController,
        rng: np.random.Generator,
        release_jitter: bool,
        worst_case: bool,
    ):
        self.controller = controller
        self.rng = rng
        self.release_jitter = release_jitter
        self.worst_case = worst_case
        self.pending = sorted(events, key=lambda e: (e.time, e.name))
        self.ev_idx = 0
        self.next_release: dict[str, float] = {}
        self._release_heap: list = []
        self._mseq: dict[str, int] = {}
        self._seq = 0
        self.responses: dict[str, list[float]] = {}
        self.bounds: dict[str, list[float]] = {}
        self.misses: dict[str, int] = {}
        self.jobs_done: dict[str, int] = {}
        self.admitted: list[str] = []
        self.rejected: list[str] = []

    def bind(self, engine: DiscreteEventEngine) -> None:
        super().bind(engine)
        # every committed controller mutation (admit, reclaim, boundary
        # commit, update_rate) can reshuffle the deadline-sorted priority
        # order — including out-of-band rate changes fired from trace
        # subscribers (BoundMonitor re-admission callbacks)
        self.controller.add_capacity_listener(self._on_capacity_change)

    def _on_capacity_change(self) -> None:
        self.order_changed(None)

    def gpu_arbitration(self) -> tuple[str, float]:
        # the runtime must execute the arbitration the controller certified
        pm = self.controller.preemption
        return (pm.mode, pm.ctx)

    def _finish_boundary(self, name: str, now: float) -> None:
        """Job boundary for ``name``: reclaim if departing, else commit
        staged mode changes; drop reclaimed services from membership."""
        if self.controller.job_boundary(name, t=now) == "reclaimed":
            self.engine.jobs.pop(name, None)
            self.next_release.pop(name, None)
            self._mseq.pop(name, None)
            self.membership_changed(name, added=False)

    def begin_step(self, now: float) -> None:
        eng = self.engine
        ctl = self.controller
        while (
            self.ev_idx < len(self.pending)
            and self.pending[self.ev_idx].time <= now + _EPS
        ):
            ev = self.pending[self.ev_idx]
            self.ev_idx += 1
            if ev.kind == "admit":
                dec = ctl.admit(ev.task, t=now)
                if dec.admitted:
                    self.admitted.append(ev.name)
                    eng.jobs[ev.name] = None
                    self.next_release[ev.name] = now
                    self._mseq[ev.name] = self._seq
                    self._seq += 1
                    self.membership_changed(ev.name, added=True)
                    heapq.heappush(
                        self._release_heap,
                        (now, self._mseq[ev.name], ev.name),
                    )
                    # setdefault: a re-admission of a departed name must
                    # extend its history, not erase the first residency
                    self.responses.setdefault(ev.name, [])
                    self.bounds.setdefault(ev.name, [])
                    self.misses.setdefault(ev.name, 0)
                    self.jobs_done.setdefault(ev.name, 0)
                    # a job spanning the reconfiguration sees the arrival's
                    # interference: lift its bound to the new epoch's R̂
                    # (certified over the transitional set, so valid for
                    # jobs of either epoch)
                    for name, job in eng.jobs.items():
                        if job is not None:
                            job.bound = max(job.bound, ctl.bound(name))
                else:
                    self.rejected.append(ev.name)
            elif ev.kind == "release":
                if ctl.release(ev.name, t=now) and eng.jobs.get(ev.name) is None:
                    self._finish_boundary(ev.name, now)  # idle: reclaim now
            else:
                raise ValueError(f"unknown churn event kind {ev.kind!r}")

    def _release_one(self, name: str) -> None:
        ctl = self.controller
        task = ctl.task(name)
        self.engine.start_job(name, EngineJob(
            release=self.next_release[name],
            deadline_abs=self.next_release[name] + task.deadline,
            chain=task.chain(),
            durations=_sample_durations(
                task, 2 * ctl.allocation[name], self.rng,
                self.worst_case,
            ),
            bound=ctl.bound(name),
        ))

    def release_jobs(self, now: float) -> None:
        eng = self.engine
        ctl = self.controller
        for name in list(eng.jobs):
            if (
                eng.jobs[name] is None
                and not ctl.is_departing(name)
                and self.next_release[name] <= now + _EPS
            ):
                self._release_one(name)

    def _heap_entry_live(self, t: float, name: str) -> bool:
        # an entry is live iff it matches the current schedule and the
        # member is idle and not departing — anything else is a leftover
        # from a superseded push (re-admission, completed release) and is
        # dropped; a dropped entry can never become live again (departure
        # is final for a name's residency, re-admission re-pushes)
        return (
            self.next_release.get(name) == t
            and self.engine.jobs.get(name, False) is None
            and not self.controller.is_departing(name)
        )

    def release_jobs_fast(self, now: float) -> None:
        heap = self._release_heap
        due = []
        while heap and heap[0][0] <= now + _EPS:
            t, s, name = heapq.heappop(heap)
            if self._heap_entry_live(t, name):
                due.append((s, name))
        # membership-sequence order == jobs dict-insertion order == the
        # order the scan-based path releases (and draws RNG for)
        # same-time jobs
        due.sort()
        for _, name in due:
            self._release_one(name)

    def arbitration_order(self) -> list:
        prio = {n: i for i, n in enumerate(self.controller.order())}
        return sorted(self.engine.jobs, key=lambda n: prio.get(n, len(prio)))

    def resource_groups(self) -> list:
        return [None]

    def sort_group(self, group, keys: list) -> list:
        prio = {n: i for i, n in enumerate(self.controller.order())}
        keys.sort(key=lambda n: prio.get(n, len(prio)))
        return keys

    def next_external_time(self, now: float) -> float:
        t = math.inf
        for name, job in self.engine.jobs.items():
            if job is None and not self.controller.is_departing(name):
                t = min(t, self.next_release[name])
        if self.ev_idx < len(self.pending):
            t = min(t, self.pending[self.ev_idx].time)
        return t

    def next_external_time_fast(self, now: float) -> float:
        t = math.inf
        heap = self._release_heap
        while heap:
            tt, s, name = heap[0]
            if self._heap_entry_live(tt, name):
                t = tt
                break
            heapq.heappop(heap)
        if self.ev_idx < len(self.pending):
            t = min(t, self.pending[self.ev_idx].time)
        return t

    def on_job_complete(self, key, job, now, response) -> None:
        eng = self.engine
        self.responses[key].append(response)
        self.bounds[key].append(job.bound)
        self.jobs_done[key] += 1
        deadline = job.deadline_abs - job.release
        eng.record("complete", key, response=response, bound=job.bound)
        if response > deadline + 1e-6:
            self.misses[key] += 1
            eng.record("miss", key, overshoot=response - deadline)
        eng.jobs[key] = None
        self._finish_boundary(key, now)    # reclaim / commit staged changes
        if key in eng.jobs:                # still resident: next sporadic gap
            task = self.controller.task(key)
            gap = (
                float(self.rng.uniform(0, 0.2 * task.period))
                if self.release_jitter else 0.0
            )
            self.next_release[key] = max(job.release + task.period + gap, now)
            heapq.heappush(self._release_heap,
                           (self.next_release[key], self._mseq[key], key))


def simulate_churn(
    events: Sequence[ChurnEvent],
    gn_total: int,
    horizon: float,
    seed: int = 0,
    release_jitter: bool = True,
    worst_case: bool = False,
    tightened: bool = True,
    allow_realloc: bool = True,
    controller: Optional[DynamicController] = None,
    trace: Optional[EventTrace] = None,
    preemption: str = "none",
    gpu_ctx_overhead: float = 0.0,
    monitor=None,
    engine_variant: Optional[str] = None,
) -> ChurnSimResult:
    """Execute an admit/release churn trace under the online scheduler.

    ``preemption``/``gpu_ctx_overhead`` select the GPU arbitration model
    for the default controller; the engine always executes whatever
    arbitration the (possibly caller-provided) controller certified.

    ``monitor`` (a :class:`repro_torch.obs.BoundMonitor`) is attached to the
    run's event trace — an internal one is created when ``trace`` is not
    given — and observes every scheduler/engine event live, tracking
    observed R against certified R̂ per task.  Attaching never alters the
    trace or the simulation."""
    if monitor is not None:
        if trace is None:
            trace = EventTrace()
        monitor.attach(trace)
    if controller is None:
        controller = DynamicController(
            gn_total,
            tightened=tightened,
            transition="boundary",
            allow_realloc=allow_realloc,
            trace=trace,
            preemption=preemption,
            gpu_ctx_overhead=gpu_ctx_overhead,
        )
    if controller.transition != "boundary":
        # an instant controller reclaims mid-job, leaving the engine's
        # membership pointing at entries the controller no longer knows
        raise ValueError(
            "simulate_churn requires a boundary-transition controller "
            f"(got transition={controller.transition!r})"
        )
    policy = _ChurnPolicy(
        events, controller, np.random.default_rng(seed), release_jitter,
        worst_case,
    )
    DiscreteEventEngine(policy, trace=trace,
                        variant=engine_variant).run(horizon)
    return ChurnSimResult(
        responses=policy.responses,
        bounds=policy.bounds,
        misses=policy.misses,
        jobs=policy.jobs_done,
        admitted=policy.admitted,
        rejected=policy.rejected,
    )


# ---- multi-host executor (federated broker validation) -----------------------


@dataclasses.dataclass
class FleetSimResult(ChurnSimResult):
    """Per-service outcome of a multi-host churn run.

    Extends :class:`ChurnSimResult` with fleet observables: the host each
    service was placed on at admission, and every completed
    departure-imbalance migration (``{"name", "src", "dst", "t"}``).  The
    validation invariant is unchanged — ``observed ≤ bound`` for every
    job, on whichever host it ran — plus: a migrating task's jobs must
    never miss while its residency spans two hosts."""

    placements: dict[str, int]
    migrations: list[dict]
    n_hosts: int
    # elastic fleet events applied during the run, in order:
    # {"kind": "add"|"retire", "host": h, "t": t, "ok": bool}
    fleet_events: list[dict] = dataclasses.field(default_factory=list)


class _FleetChurnPolicy(SchedulingPolicy):
    """Broker-routed dynamic membership across N host resource lanes.

    Member keys are ``(host, name)``; :meth:`resource_group` maps each to
    its host lane, so every host arbitrates its own CPU and copy bus while
    the single lockstep event loop keeps global time (and therefore
    broker-admission / migration causality) exact.  Jobs sample durations
    with the slice count committed *on the host they run on*; a migration
    moves the member key — and its sporadic release schedule — from the
    source lane to the target lane at the source job boundary.

    Incremental seam: one group per host; a capacity listener on every
    host controller (including elastically joined ones) invalidates that
    host's cached priority sort on any committed mutation, so migrations
    and rate changes dirty exactly the lanes they touch.  Pending
    releases live in one fleet-wide lazily-invalidated heap of
    ``(time, membership_seq, (host, name))``."""

    horizon_slack = _EPS
    incremental = True

    def __init__(
        self,
        events: Sequence[ChurnEvent],
        broker: CapacityBroker,
        rng: np.random.Generator,
        release_jitter: bool,
        worst_case: bool,
        elastic: Sequence[tuple] = (),
    ):
        self.broker = broker
        self.rng = rng
        self.release_jitter = release_jitter
        self.worst_case = worst_case
        self.pending = sorted(events, key=lambda e: (e.time, e.name))
        self.ev_idx = 0
        # elastic fleet schedule: (t, "add", gn_total[, speed]) grows the
        # fleet, (t, "retire", host) drains-then-retires; merged with the
        # churn stream in global time order (fleet ops first on ties)
        self.fleet_pending = sorted(elastic, key=lambda e: e[0])
        self.fl_idx = 0
        self.fleet_log: list[dict] = []
        self.next_release: dict[tuple, float] = {}
        self._release_heap: list = []
        self._mseq: dict[tuple, int] = {}
        self._seq = 0
        self.responses: dict[str, list[float]] = {}
        self.bounds: dict[str, list[float]] = {}
        self.misses: dict[str, int] = {}
        self.jobs_done: dict[str, int] = {}
        self.admitted: list[str] = []
        self.rejected: list[str] = []
        self.placements: dict[str, int] = {}

    # ---- engine hooks -------------------------------------------------------

    def bind(self, engine: DiscreteEventEngine) -> None:
        super().bind(engine)
        for h in range(len(self.broker.hosts)):
            self._listen_host(h)

    def _listen_host(self, h: int) -> None:
        # any committed mutation on host h (admit, reclaim, boundary
        # commit, rate change — including migration legs) can reshuffle
        # that lane's deadline-sorted priority order
        self.broker.hosts[h].add_capacity_listener(
            lambda h=h: self.order_changed(h)
        )

    def resource_group(self, key):
        return key[0]

    def resource_groups(self) -> list:
        return list(range(len(self.broker.hosts)))

    def sort_group(self, h, keys: list) -> list:
        prio = {n: i for i, n in enumerate(self.broker.hosts[h].order())}
        keys.sort(key=lambda k: prio.get(k[1], len(prio)))
        return keys

    def _track_member(self, key: tuple) -> None:
        self._mseq[key] = self._seq
        self._seq += 1
        self.membership_changed(key, added=True)

    def _untrack_member(self, key: tuple) -> None:
        self._mseq.pop(key, None)
        self.membership_changed(key, added=False)

    def display_name(self, key) -> str:
        return key[1]

    def event_meta(self, key) -> dict:
        return {"host": key[0]}

    def gpu_arbitration(self) -> tuple[str, float]:
        # simulate_fleet validates that every host certifies one model
        pm = self.broker.hosts[0].preemption
        return (pm.mode, pm.ctx)

    # ---- bookkeeping --------------------------------------------------------

    def _lift_bounds(self, hosts=None) -> None:
        """Raise in-flight jobs' bounds to their host's current R̂.

        An admission or an in-migration changes a host's interference; the
        new epoch's bound is certified over the transitional set, so it
        covers jobs of either epoch — lifting keeps the per-job validation
        sound for jobs spanning the reconfiguration.

        ``hosts`` narrows the lift to lanes whose certification actually
        changed: admission is per-host transactional (the losing hosts'
        state is untouched), so the admit path passes the one winning
        host and the lift stays O(that host's residents) — without it,
        filling a fleet to N residents costs O(N²) lifts.  ``None``
        (reclaims, retires) lifts fleet-wide, since drain migrations can
        cascade across lanes.  Either way ``max`` makes unaffected lanes
        a no-op, so the narrowed lift is byte-identical."""
        jobs = self.engine.jobs
        if hosts is None:
            for (h, name), job in jobs.items():
                if job is not None:
                    job.bound = max(job.bound,
                                    self.broker.hosts[h].bound(name))
            return
        for h in hosts:
            for name, b in self.broker.hosts[h].bounds().items():
                job = jobs.get((h, name))
                if job is not None and b > job.bound:
                    job.bound = b

    def _boundary(self, name: str, now: float) -> str:
        """Job boundary on ``name``'s active host: reclaim a departer,
        complete a migration (moving the member to its target lane), or
        commit staged changes."""
        h = self.broker.active_host(name)
        if h is None:
            return "none"
        key = (h, name)
        res = self.broker.job_boundary(name, t=now)
        if res == "reclaimed":
            self.engine.jobs.pop(key, None)
            self.next_release.pop(key, None)
            self._untrack_member(key)
            # the departure may have started migrations; an idle source
            # is at its boundary NOW (mirrors the idle-departer reclaim)
            self._drain_idle_migrations(now)
            self._lift_bounds()
        elif res == "migrated":
            nr = self.next_release.pop(key, now)
            self.engine.jobs.pop(key, None)
            self._untrack_member(key)
            dst = self.broker.active_host(name)
            self.engine.jobs[(dst, name)] = None
            self.next_release[(dst, name)] = max(nr, now)
            self._track_member((dst, name))
            heapq.heappush(
                self._release_heap,
                (self.next_release[(dst, name)],
                 self._mseq[(dst, name)], (dst, name)),
            )
        return res

    def _drain_idle_migrations(self, now: float) -> None:
        progress = True
        while progress:
            progress = False
            for name, mig in list(self.broker.migrating.items()):
                key = (mig.src, name)
                if key in self.engine.jobs and self.engine.jobs[key] is None:
                    self._boundary(name, now)
                    progress = True

    def begin_step(self, now: float) -> None:
        # merge the churn and elastic streams in global time order so a
        # retire at t precedes (and its drain migrations can absorb) an
        # arrival at t' > t even when the engine wakes once for both
        while True:
            ct = (
                self.pending[self.ev_idx].time
                if self.ev_idx < len(self.pending) else math.inf
            )
            ft = (
                self.fleet_pending[self.fl_idx][0]
                if self.fl_idx < len(self.fleet_pending) else math.inf
            )
            if min(ct, ft) > now + _EPS:
                break
            if ft <= ct:
                fe = self.fleet_pending[self.fl_idx]
                self.fl_idx += 1
                self._apply_fleet_event(fe, now)
            else:
                ev = self.pending[self.ev_idx]
                self.ev_idx += 1
                self._apply_churn_event(ev, now)

    def _apply_fleet_event(self, fe: tuple, now: float) -> None:
        kind = fe[1]
        if kind == "add":
            speed = float(fe[3]) if len(fe) > 3 else 1.0
            h = self.broker.add_host(
                gn_total=int(fe[2]), speed=speed, t=now
            )
            self._listen_host(h)
            # a new resource group: the engine's group index must grow
            self.order_changed()
            self.fleet_log.append(
                {"kind": "add", "host": h, "t": now, "ok": True}
            )
        elif kind == "retire":
            h = int(fe[2])
            ok = self.broker.retire_host(h, t=now)
            self.fleet_log.append(
                {"kind": "retire", "host": h, "t": now, "ok": ok}
            )
            if ok:
                # drain migrations off idle members complete at their
                # (immediate) job boundary; busy members at their next
                self._drain_idle_migrations(now)
                self._lift_bounds()
        else:
            raise ValueError(f"unknown fleet event kind {kind!r}")

    def _apply_churn_event(self, ev: ChurnEvent, now: float) -> None:
        eng = self.engine
        if ev.kind == "admit":
            dec = self.broker.admit(ev.task, t=now)
            if dec.admitted:
                h = dec.host
                self.admitted.append(ev.name)
                self.placements[ev.name] = h
                eng.jobs[(h, ev.name)] = None
                self.next_release[(h, ev.name)] = now
                self._track_member((h, ev.name))
                heapq.heappush(
                    self._release_heap,
                    (now, self._mseq[(h, ev.name)], (h, ev.name)),
                )
                # setdefault: a re-admission of a departed name must
                # extend its history, not erase the first residency
                self.responses.setdefault(ev.name, [])
                self.bounds.setdefault(ev.name, [])
                self.misses.setdefault(ev.name, 0)
                self.jobs_done.setdefault(ev.name, 0)
                self._lift_bounds(hosts=(h,))
            else:
                self.rejected.append(ev.name)
        elif ev.kind == "release":
            h = self.broker.active_host(ev.name)
            if self.broker.release(ev.name, t=now):
                if eng.jobs.get((h, ev.name)) is None:
                    self._boundary(ev.name, now)   # idle: reclaim now
                self._drain_idle_migrations(now)
                self._lift_bounds()
        else:
            raise ValueError(f"unknown churn event kind {ev.kind!r}")

    def _release_one(self, key: tuple) -> None:
        h, name = key
        ctl = self.broker.hosts[h]
        task = ctl.task(name)
        self.engine.start_job(key, EngineJob(
            release=self.next_release[key],
            deadline_abs=self.next_release[key] + task.deadline,
            chain=task.chain(),
            durations=_sample_durations(
                task, 2 * ctl.allocation[name], self.rng,
                self.worst_case,
            ),
            bound=ctl.bound(name),
        ))

    def release_jobs(self, now: float) -> None:
        eng = self.engine
        for key in list(eng.jobs):
            h, name = key
            ctl = self.broker.hosts[h]
            if (
                eng.jobs[key] is None
                and not ctl.is_departing(name)
                and self.next_release.get(key, math.inf) <= now + _EPS
            ):
                self._release_one(key)

    def _heap_entry_live(self, t: float, key: tuple) -> bool:
        # mirror of the scan-based release/next-external predicate; stale
        # entries (superseded by a migration, a departure, or a completed
        # release) are dropped — a migration or re-admission pushes a
        # fresh entry under the new key, so nothing is lost
        h, name = key
        return (
            self.next_release.get(key) == t
            and self.engine.jobs.get(key, False) is None
            and not self.broker.hosts[h].is_departing(name)
        )

    def release_jobs_fast(self, now: float) -> None:
        heap = self._release_heap
        due = []
        while heap and heap[0][0] <= now + _EPS:
            t, s, key = heapq.heappop(heap)
            if self._heap_entry_live(t, key):
                due.append((s, key))
        # membership-sequence order == jobs dict-insertion order == the
        # scan-based release (and RNG draw) order for same-time jobs
        due.sort()
        for _, key in due:
            self._release_one(key)

    def arbitration_order(self) -> list:
        out = []
        for h, ctl in enumerate(self.broker.hosts):
            prio = {n: i for i, n in enumerate(ctl.order())}
            members = [k for k in self.engine.jobs if k[0] == h]
            members.sort(key=lambda k: prio.get(k[1], len(prio)))
            out.extend(members)
        return out

    def next_external_time(self, now: float) -> float:
        t = math.inf
        for key, job in self.engine.jobs.items():
            h, name = key
            if job is None and not self.broker.hosts[h].is_departing(name):
                t = min(t, self.next_release.get(key, math.inf))
        if self.ev_idx < len(self.pending):
            t = min(t, self.pending[self.ev_idx].time)
        if self.fl_idx < len(self.fleet_pending):
            t = min(t, self.fleet_pending[self.fl_idx][0])
        return t

    def next_external_time_fast(self, now: float) -> float:
        t = math.inf
        heap = self._release_heap
        while heap:
            tt, s, key = heap[0]
            if self._heap_entry_live(tt, key):
                t = tt
                break
            heapq.heappop(heap)
        if self.ev_idx < len(self.pending):
            t = min(t, self.pending[self.ev_idx].time)
        if self.fl_idx < len(self.fleet_pending):
            t = min(t, self.fleet_pending[self.fl_idx][0])
        return t

    def on_job_complete(self, key, job, now, response) -> None:
        eng = self.engine
        h, name = key
        self.responses[name].append(response)
        self.bounds[name].append(job.bound)
        self.jobs_done[name] += 1
        deadline = job.deadline_abs - job.release
        eng.record("complete", key, response=response, bound=job.bound)
        if response > deadline + 1e-6:
            self.misses[name] += 1
            eng.record("miss", key, overshoot=response - deadline)
        eng.jobs[key] = None
        self._boundary(name, now)   # reclaim / migrate / commit staged
        h2 = self.broker.active_host(name)
        if h2 is not None and (h2, name) in eng.jobs:
            # still a fleet member (possibly on a new host): next sporadic
            # release, with the post-boundary committed parameters
            task = self.broker.hosts[h2].task(name)
            gap = (
                float(self.rng.uniform(0, 0.2 * task.period))
                if self.release_jitter else 0.0
            )
            self.next_release[(h2, name)] = max(
                job.release + task.period + gap, now
            )
            heapq.heappush(
                self._release_heap,
                (self.next_release[(h2, name)],
                 self._mseq[(h2, name)], (h2, name)),
            )


def simulate_fleet(
    events: Sequence[ChurnEvent],
    n_hosts: int,
    gn_per_host: int,
    horizon: float,
    seed: int = 0,
    release_jitter: bool = True,
    worst_case: bool = False,
    tightened: bool = True,
    placement: str = "least_loaded",
    imbalance_threshold: float = 0.25,
    max_migrations_per_event: int = 1,
    engine: str = "batch",
    broker: Optional[CapacityBroker] = None,
    trace: Optional[EventTrace] = None,
    preemption: str = "none",
    gpu_ctx_overhead: float = 0.0,
    host_speeds: Optional[Sequence[float]] = None,
    monitor=None,
    elastic: Sequence[tuple] = (),
    engine_variant: Optional[str] = None,
) -> FleetSimResult:
    """Execute a churn trace across ``n_hosts`` broker-routed hosts.

    ``monitor`` behaves as in :func:`simulate_churn`: attached to the
    run's event trace (created internally when ``trace`` is not given)
    to track observed R vs certified R̂ without touching the trace.

    ``elastic`` is an optional fleet schedule merged with the churn
    stream in global time order: ``(t, "add", gn_total[, speed])`` joins
    a host mid-run (mirroring host 0's configuration);
    ``(t, "retire", h)`` drains host ``h`` through certified migrations
    and retires it once empty.  A retire that cannot place every
    resident elsewhere is refused and logged
    (``result.fleet_events[..]["ok"] is False``) — the fleet keeps
    running on the undrained host."""
    if monitor is not None:
        if trace is None:
            trace = EventTrace()
        monitor.attach(trace)
    if broker is None:
        broker = CapacityBroker.build(
            n_hosts, gn_per_host,
            trace=trace,
            transition="boundary",
            engine=engine,
            tightened=tightened,
            placement=placement,
            imbalance_threshold=imbalance_threshold,
            max_migrations_per_event=max_migrations_per_event,
            preemption=preemption,
            gpu_ctx_overhead=gpu_ctx_overhead,
            host_speeds=host_speeds,
        )
    for h, ctl in enumerate(broker.hosts):
        if ctl.transition != "boundary":
            # an instant controller reclaims mid-job, leaving the engine's
            # membership pointing at entries the controller no longer knows
            raise ValueError(
                "simulate_fleet requires boundary-transition hosts "
                f"(host {h} has transition={ctl.transition!r})"
            )
        if ctl.preemption != broker.hosts[0].preemption:
            # one engine-wide arbitration model: mixed fleets would need
            # per-lane arbitration configs the lockstep loop doesn't carry
            raise ValueError(
                "simulate_fleet requires one GPU arbitration model across "
                f"hosts (host {h} has {ctl.preemption}, host 0 has "
                f"{broker.hosts[0].preemption})"
            )
    policy = _FleetChurnPolicy(
        events, broker, np.random.default_rng(seed), release_jitter,
        worst_case, elastic=elastic,
    )
    DiscreteEventEngine(policy, trace=trace,
                        variant=engine_variant).run(horizon)
    return FleetSimResult(
        responses=policy.responses,
        bounds=policy.bounds,
        misses=policy.misses,
        jobs=policy.jobs_done,
        admitted=policy.admitted,
        rejected=policy.rejected,
        placements=policy.placements,
        migrations=[
            {"name": m.name, "src": m.src, "dst": m.dst, "t": m.started}
            for m in broker.migration_log
        ],
        n_hosts=len(broker.hosts),
        fleet_events=policy.fleet_log,
    )
