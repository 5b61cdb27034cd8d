"""Unified discrete-event engine for RT CPU–bus–accelerator execution.

One event loop implements the RTGPU runtime rules shared by every
simulator variant:

  * CPU: preemptive fixed-priority (one core) — the highest-priority
    member with a ready CPU segment owns the core each step;
  * bus: non-preemptive fixed-priority (one PCIe-like channel) — the
    holder keeps the bus until its copy completes, then the
    highest-priority waiter takes over;
  * accelerator: pluggable arbitration
    (:meth:`SchedulingPolicy.gpu_arbitration`) — ``"none"`` is the
    federated default (every member owns dedicated virtual SMs, so GPU
    segments always run: no contention by construction); ``"priority"``
    is one *preemptive priority-driven* GPU execution context per
    resource group (GCAPS-style): only the highest-priority ready kernel
    runs, a preempted kernel is charged the configurable context-switch
    overhead when evicted, and ``preempt``/``resume`` trace events mark
    every hand-off;

plus segment-completion bookkeeping (advance the chain, release the bus
after a copy, detect job completion) and :class:`~repro_torch.sched.EventTrace`
emission for ``release`` and ``preempt`` events.

Everything *workload-specific* — who the members are, their priority
order, when jobs are released, what happens when one completes — lives in
a :class:`SchedulingPolicy`.  ``repro_torch.runtime.simulator`` provides the
shipped policies: a fixed task set (:func:`~repro_torch.runtime.simulate`),
dynamic membership under the online controller
(:func:`~repro_torch.runtime.simulate_churn`), and broker-routed multi-host
churn (:func:`~repro_torch.runtime.simulate_fleet`).  New variants (preemptive
GPU slices, urgency-aware launching) add a policy, not a third copy of
the arbitration loop.

**Resource lanes (multi-host).**  Each member belongs to a *resource
group* (:meth:`SchedulingPolicy.resource_group`; default: one shared
group) owning its own CPU core and copy bus.  A fleet runs one lane group
per host inside one lockstep event loop — equivalent to one engine per
host with perfectly synchronized clocks, which keeps cross-host causality
(broker admissions, migrations at job boundaries) trivially correct: the
single loop processes every event in global time order.  Single-group
policies are byte-identical to the pre-federation engine.

**Two loop variants, one contract.**  The engine ships a *reference*
loop (scan-everything: rebuild the arbitration order, re-arbitrate every
group, and take the min over every running job, each step) and an
*indexed* loop that does the same arbitration only for *dirty* groups —
groups where something actually changed since the last step (a release,
a segment transition, a completion, a membership or priority-order
change).  Clean groups keep their cached CPU/bus/GPU owners, and the
time advance reads a per-group minimum-remaining value that is
decremented by the same ``dt`` as its members (float subtraction of the
identical value preserves the argmin exactly), so the indexed loop is
**byte-identical** to the reference loop — every trace event, timestamp
and RNG draw — while a step costs O(dirty groups + running jobs) instead
of O(members · log).  Selection: the ``variant`` constructor argument,
else the ``REPRO_ENGINE`` env var (``indexed`` — the default — or
``reference``); policies that do not opt in (``incremental = False``,
the default for custom policies) always run the reference loop.  The
golden corpus under ``tests/golden/`` and
``tests/test_engine_indexed.py`` pin the equivalence.

Determinism contract: the engine iterates members only in the policy's
arbitration order (and groups in their order of first appearance there)
and never touches an unordered set, so a run is a pure function of
(policy state, RNG seed).  Incremental policies additionally promise a
*group-major* arbitration order: members of one resource group are
contiguous and groups appear in :meth:`SchedulingPolicy.resource_groups`
order — which every shipped policy already satisfied.
"""
from __future__ import annotations

import abc
import dataclasses
import math
import os
from typing import Hashable, Optional

from repro_torch.core import SegmentKind
from repro_torch.obs import metrics
from repro_torch.sched import EventTrace

__all__ = ["EngineJob", "SchedulingPolicy", "DiscreteEventEngine"]

_EPS = 1e-9

#: sentinel for :meth:`SchedulingPolicy.order_changed` — "every group"
#: (``None`` is a real group key: the default single shared lane)
_ALL_GROUPS = object()


@dataclasses.dataclass
class EngineJob:
    """One job in flight: a segment chain with per-segment durations.

    ``key`` — the policy's member handle (task index, service name, …) —
    is filled in by :meth:`DiscreteEventEngine.start_job`; ``bound``
    carries the analytic R̂ certified for this job where the policy
    tracks one (``inf`` means untracked)."""

    release: float
    deadline_abs: float
    chain: list                    # [(SegmentKind, index-within-kind), ...]
    durations: list                # one duration per chain segment
    seg_idx: int = 0
    remaining: float = 0.0         # remaining time of the current segment
    bound: float = math.inf
    key: Hashable = None


class SchedulingPolicy(abc.ABC):
    """Membership / priority / lifecycle hooks driving the engine.

    The engine owns the member → in-flight-job map (``engine.jobs``; a
    ``None`` value means the member is idle) and calls the hooks in loop
    order: ``begin_step`` → ``release_jobs`` → ``arbitration_order`` →
    (advance time) → ``on_job_complete`` per finished job.

    **Incremental seam.**  A policy that sets ``incremental = True`` opts
    into the indexed loop and promises to (a) call
    :meth:`membership_changed` on every ``engine.jobs`` key
    insertion/removal, (b) call :meth:`order_changed` whenever member
    priorities may have changed, and (c) keep its
    :meth:`arbitration_order` group-major (members of one resource group
    contiguous, groups in :meth:`resource_groups` order).  The optional
    fast hooks (:meth:`release_jobs_fast`, :meth:`next_external_time_fast`,
    :meth:`sort_group`) default to the scan-everything implementations, so
    opting in is behavior-preserving even before a policy indexes its own
    release schedule."""

    engine: "DiscreteEventEngine"

    #: loop-guard slack: the engine runs while ``now < horizon - slack``
    horizon_slack: float = 0.0

    #: opt-in to the indexed loop (see class docstring).  Custom policies
    #: keep the default and always get the reference loop.
    incremental: bool = False

    def bind(self, engine: "DiscreteEventEngine") -> None:
        """Called once by the engine constructor; seed initial membership
        (``engine.jobs`` keys) here."""
        self.engine = engine

    def begin_step(self, now: float) -> None:
        """External world first: membership changes (admissions,
        departures) due at ``now``.  Default: nothing."""

    @abc.abstractmethod
    def release_jobs(self, now: float) -> None:
        """Create jobs whose release time has arrived, via
        :meth:`DiscreteEventEngine.start_job`."""

    @abc.abstractmethod
    def arbitration_order(self) -> list:
        """Member keys from highest to lowest fixed priority.  The engine
        resolves CPU/bus contention — and processes simultaneous
        completions — in exactly this order."""

    @abc.abstractmethod
    def next_external_time(self, now: float) -> float:
        """Absolute time of the next policy-side event (pending release,
        churn event, …); ``inf`` when none is scheduled."""

    @abc.abstractmethod
    def on_job_complete(self, key, job: EngineJob, now: float,
                        response: float) -> None:
        """Job bookkeeping: record the response, trace ``complete`` /
        ``miss``, schedule the next release, run boundary protocols.  Must
        clear ``engine.jobs[key]`` (or remove the member)."""

    def display_name(self, key) -> str:
        """Task name used in trace events for ``key``."""
        return str(key)

    def resource_group(self, key) -> Hashable:
        """CPU/bus lane ``key`` contends in (e.g. the host index).  Members
        of different groups never contend; the default puts every member
        on one shared CPU and bus (the single-host engine)."""
        return None

    def event_meta(self, key) -> dict:
        """Extra meta stamped onto every trace event the engine records
        for ``key`` (e.g. ``{"host": h}`` for host-tagged fleet traces).
        Default: none."""
        return {}

    def gpu_arbitration(self) -> tuple[str, float]:
        """GPU arbitration model as ``(mode, ctx_overhead)``.

        ``("none", 0.0)`` — dedicated federated slices: every member's GPU
        segment always runs (the seed behavior, byte-identical).
        ``("priority", ctx)`` — one preemptive priority-driven GPU
        execution context per resource group: the highest-priority member
        with a ready kernel owns the GPU; on eviction the preempted job is
        charged ``ctx`` (state save/restore) and traced ``preempt``, and
        traced ``resume`` when it re-acquires the GPU.  Read once per
        :meth:`DiscreteEventEngine.run`."""
        return ("none", 0.0)

    # ---- incremental seam (used only by the indexed loop) --------------------

    def resource_groups(self) -> Optional[list]:
        """Every resource group, in arbitration-appearance order (may
        include currently-empty groups — they cost nothing).  ``None``
        (the default) derives the list from :meth:`arbitration_order`
        at index-rebuild time."""
        return None

    def sort_group(self, group, keys: list) -> Optional[list]:
        """Priority-sort ``keys`` (one group's members, in membership
        insertion order) highest priority first; in-place is fine.  Must
        match :meth:`arbitration_order` restricted to ``group``.  ``None``
        (the default) falls back to positions from the full
        :meth:`arbitration_order`."""
        return None

    def release_jobs_fast(self, now: float) -> None:
        """Indexed-loop release hook; override with an event-indexed
        implementation (e.g. a release heap).  Default: the scan-based
        :meth:`release_jobs`."""
        self.release_jobs(now)

    def next_external_time_fast(self, now: float) -> float:
        """Indexed-loop pending-event probe; override with an indexed
        implementation.  Default: the scan-based
        :meth:`next_external_time`."""
        return self.next_external_time(now)

    def membership_changed(self, key, added: bool) -> None:
        """Notify the engine that ``key`` entered (``added=True``) or left
        ``engine.jobs``.  Incremental policies must call this at every
        membership mutation (admit, reclaim, both sides of a migration);
        it is a no-op under the reference loop."""
        eng = getattr(self, "engine", None)
        if eng is not None:
            eng.membership_changed(key, added)

    def order_changed(self, group=_ALL_GROUPS) -> None:
        """Notify the engine that member priorities may have changed — in
        ``group``, or everywhere when called without arguments (also the
        signal for "the group set itself changed", e.g. an elastic host
        join).  No-op under the reference loop."""
        eng = getattr(self, "engine", None)
        if eng is not None:
            eng.order_changed(group)


class DiscreteEventEngine:
    """The shared event loop.  Construct with a policy, call :meth:`run`.

    State exposed to policies: ``jobs`` (member → job-or-None), ``now``,
    and ``record`` for trace emission in the engine's clock.  ``steps``
    counts event steps executed (both loop variants), cheap enough to
    maintain unconditionally — benchmarks use it as the events/sec
    numerator.

    ``variant`` selects the loop: ``"indexed"`` / ``"reference"``; when
    ``None`` the ``REPRO_ENGINE`` env var decides (default
    ``"indexed"``).  Policies with ``incremental = False`` always run the
    reference loop regardless."""

    #: consecutive zero-width steps tolerated before the livelock guard
    #: trips (a legitimate burst of same-timestamp events is far below
    #: this; a policy whose next_external_time never advances is not)
    max_same_time_steps: int = 10_000

    def __init__(
        self,
        policy: SchedulingPolicy,
        trace: Optional[EventTrace] = None,
        variant: Optional[str] = None,
    ):
        self.policy = policy
        self.trace = trace
        self.variant = variant
        self.jobs: dict[Hashable, Optional[EngineJob]] = {}
        self.now = 0.0
        self.steps = 0
        # per resource group: non-preemptive bus holder / last core owner
        self.bus_owner: dict[Hashable, Hashable] = {}
        self._last_cpu_owner: dict[Hashable, Hashable] = {}
        # priority-preemptive GPU lanes only: per-group kernel owner and
        # the members whose in-flight kernel is currently evicted
        self.gpu_owner: dict[Hashable, Hashable] = {}
        self._gpu_preempted: set = set()
        # ---- indexed-loop state (inert under the reference loop) ----
        self._index_active = False
        self._full_stale = True
        self._groups: list = []                 # groups, appearance order
        self._gpos: dict = {}                   # group -> appearance index
        self._members_raw: dict = {}            # group -> keys, insertion order
        self._members: dict = {}                # group -> keys, priority order
        self._seg: dict = {}                    # key -> current SegmentKind|None
        self._cpu_owner: dict = {}              # group -> CPU owner (this step)
        self._gpu_list: dict = {}               # group -> running GPU members
        self._min_rem: dict = {}                # group -> min running remaining
        self._stale: set = set()                # groups needing a re-sort
        self._dirty: set = set()                # groups needing re-arbitration
        self._running: list = []                # flat running list, ref order
        policy.bind(self)

    def record(self, kind: str, key, **meta) -> None:
        if self.trace is not None:
            self.trace.record(self.now, kind, self.policy.display_name(key),
                              **{**self.policy.event_meta(key), **meta})

    def seg_kind(self, key) -> Optional[SegmentKind]:
        """Current segment kind of ``key``'s job (None when idle/absent)."""
        job = self.jobs.get(key)
        if job is None:
            return None
        return job.chain[job.seg_idx][0]

    def start_job(self, key, job: EngineJob) -> None:
        """Install a newly released job and trace its release."""
        job.key = key
        job.remaining = job.durations[0]
        self.jobs[key] = job
        self._gpu_preempted.discard(key)
        if self._index_active and not self._full_stale:
            self._seg[key] = job.chain[0][0]
            g = self.policy.resource_group(key)
            if g in self._gpos:
                self._dirty.add(g)
            else:
                self._full_stale = True
        self.record("release", key, deadline=job.deadline_abs)

    # ---- index maintenance (indexed loop) ------------------------------------

    def membership_changed(self, key, added: bool) -> None:
        """``key`` entered/left ``jobs`` (see the policy seam)."""
        if not self._index_active or self._full_stale:
            return
        g = self.policy.resource_group(key)
        if g not in self._gpos:
            self._full_stale = True
            return
        if added:
            self._members_raw[g].append(key)
            self._seg.setdefault(key, None)
        else:
            try:
                self._members_raw[g].remove(key)
            except ValueError:
                pass
            self._seg.pop(key, None)
        self._stale.add(g)
        self._dirty.add(g)

    def order_changed(self, group=_ALL_GROUPS) -> None:
        """Member priorities changed in ``group`` (default: everywhere)."""
        if not self._index_active or self._full_stale:
            return
        if group is _ALL_GROUPS or group not in self._gpos:
            self._full_stale = True
        else:
            self._stale.add(group)
            self._dirty.add(group)

    def _rebuild_index(self) -> None:
        policy = self.policy
        groups = policy.resource_groups()
        if groups is None:
            groups, seen = [], set()
            for k in policy.arbitration_order():
                g = policy.resource_group(k)
                if g not in seen:
                    seen.add(g)
                    groups.append(g)
        else:
            groups = list(groups)
        gpos = {g: i for i, g in enumerate(groups)}
        raw: dict = {g: [] for g in groups}
        seg: dict = {}
        for k, job in self.jobs.items():
            g = policy.resource_group(k)
            if g not in gpos:
                raise RuntimeError(
                    f"member {k!r} is in group {g!r}, missing from "
                    f"resource_groups() of {type(policy).__name__}"
                )
            raw[g].append(k)
            seg[k] = None if job is None else job.chain[job.seg_idx][0]
        self._groups = groups
        self._gpos = gpos
        self._members_raw = raw
        self._members = {}
        self._seg = seg
        self._cpu_owner = {}
        self._gpu_list = {}
        self._min_rem = {}
        self._stale = set(groups)
        self._dirty = set(groups)
        self._full_stale = False

    def _resort_stale(self) -> None:
        policy = self.policy
        pos = None
        for g in self._stale:
            if g not in self._gpos:
                continue
            keys = list(self._members_raw[g])
            out = policy.sort_group(g, keys)
            if out is None:
                if pos is None:
                    pos = {k: i
                           for i, k in enumerate(policy.arbitration_order())}
                keys.sort(key=pos.__getitem__)
                out = keys
            self._members[g] = out
        self._stale.clear()

    # ---- per-group arbitration (indexed loop; mirrors the reference loop) ----

    def _arbitrate_cpu_bus(self, g, obs: bool) -> None:
        policy = self.policy
        seg = self._seg
        members = self._members[g]
        cpu_owner = None
        for k in members:
            if seg.get(k) is SegmentKind.CPU:
                cpu_owner = k
                break
        last = self._last_cpu_owner.get(g)
        if (
            (self.trace is not None or obs)
            and last is not None
            and cpu_owner != last
            and seg.get(last) is SegmentKind.CPU
            and self.jobs[last].remaining > _EPS
        ):
            metrics.inc("engine_cpu_preemptions_total")
            self.record(
                "preempt", last,
                by=policy.display_name(cpu_owner)
                if cpu_owner is not None else "",
            )
        self._last_cpu_owner[g] = cpu_owner
        self._cpu_owner[g] = cpu_owner

        owner = self.bus_owner.get(g)
        if owner is not None and seg.get(owner) is not SegmentKind.MEM:
            owner = None
        if owner is None:
            for k in members:
                if seg.get(k) is SegmentKind.MEM:
                    owner = k
                    break
        self.bus_owner[g] = owner

    def _arbitrate_gpu(self, g, gpu_ctx: float) -> None:
        policy = self.policy
        seg = self._seg
        owner = None
        for k in self._members[g]:
            if seg.get(k) is SegmentKind.GPU:
                owner = k
                break
        last = self.gpu_owner.get(g)
        if (
            last is not None
            and owner != last
            and seg.get(last) is SegmentKind.GPU
            and self.jobs[last].remaining > _EPS
        ):
            # evicted mid-kernel: the victim is charged the context
            # switch (state save/restore) and serves it when it
            # re-acquires the GPU
            self.jobs[last].remaining += gpu_ctx
            self._gpu_preempted.add(last)
            metrics.inc("engine_gpu_preemptions_total")
            metrics.inc("engine_gpu_ctx_charged_total", amount=gpu_ctx)
            self.record(
                "preempt", last, resource="gpu",
                by=policy.display_name(owner)
                if owner is not None else "",
            )
        if owner is not None and owner in self._gpu_preempted:
            self._gpu_preempted.discard(owner)
            self.record("resume", owner, resource="gpu")
        self.gpu_owner[g] = owner
        self._gpu_list[g] = [owner] if owner is not None else []

    def _rebuild_running(self) -> None:
        # reference order: CPU owners (groups in appearance order), bus
        # holders, then the GPU lanes — completion processing depends on
        # it.  Only *active* groups (a ``_min_rem`` entry ⟺ at least one
        # running member) can contribute, so an idle fleet lane costs
        # nothing here — step cost is O(active), not O(groups)
        running = []
        act = sorted(self._min_rem, key=self._gpos.__getitem__)
        cpu = self._cpu_owner
        bus = self.bus_owner
        gpu = self._gpu_list
        for g in act:
            k = cpu.get(g)
            if k is not None:
                running.append(k)
        for g in act:
            k = bus.get(g)
            if k is not None:
                running.append(k)
        for g in act:
            running.extend(gpu.get(g, ()))
        self._running = running

    def _livelock(self, stall: int, running: list) -> RuntimeError:
        names = [self.policy.display_name(k) for k in running[:12]]
        if len(running) > 12:
            names.append(f"... +{len(running) - 12} more")
        return RuntimeError(
            f"engine livelock: {stall} consecutive zero-width steps at "
            f"t={self.now!r} under {type(self.policy).__name__} "
            f"(running: {names}); next_external_time is not advancing"
        )

    # ---- the loops -----------------------------------------------------------

    def run(self, horizon: float) -> None:
        variant = (
            self.variant
            if self.variant is not None
            else os.environ.get("REPRO_ENGINE", "indexed")
        )
        if variant not in ("indexed", "reference"):
            raise ValueError(
                f"unknown engine variant {variant!r} "
                "(expected 'indexed' or 'reference')"
            )
        if variant == "indexed" and self.policy.incremental:
            self._run_indexed(horizon)
        else:
            self._run_reference(horizon)

    def _run_reference(self, horizon: float) -> None:
        """The scan-everything oracle loop (the original engine)."""
        policy = self.policy
        gpu_mode, gpu_ctx = policy.gpu_arbitration()
        if gpu_mode not in ("none", "priority"):
            raise ValueError(f"unknown GPU arbitration mode {gpu_mode!r}")
        # observability is read once per run (like the arbitration model):
        # when off, the loop pays nothing beyond this flag
        obs = metrics.enabled()
        stall = 0
        while self.now < horizon - policy.horizon_slack:
            # 1. external events, then releases due now
            policy.begin_step(self.now)
            policy.release_jobs(self.now)

            # 2. arbitration under the policy's fixed-priority order, one
            # CPU core + one bus per resource group (groups in order of
            # first appearance — deterministic).  Segment kinds are probed
            # once per member per step (kinds), not once per owner scan.
            order = policy.arbitration_order()
            groups: list = []
            members: dict = {}
            kinds: dict = {}
            for k in order:
                g = policy.resource_group(k)
                if g not in members:
                    members[g] = []
                    groups.append(g)
                members[g].append(k)
                kinds[k] = self.seg_kind(k)

            cpu_owners: dict = {}
            for g in groups:
                cpu_owner = next(
                    (k for k in members[g]
                     if kinds.get(k) is SegmentKind.CPU),
                    None,
                )
                last = self._last_cpu_owner.get(g)
                if (
                    (self.trace is not None or obs)
                    and last is not None
                    and cpu_owner != last
                    and kinds.get(last) is SegmentKind.CPU
                    and self.jobs[last].remaining > _EPS
                ):
                    metrics.inc("engine_cpu_preemptions_total")
                    self.record(
                        "preempt", last,
                        by=policy.display_name(cpu_owner)
                        if cpu_owner is not None else "",
                    )
                self._last_cpu_owner[g] = cpu_owner
                cpu_owners[g] = cpu_owner

                owner = self.bus_owner.get(g)
                if (
                    owner is not None
                    and kinds.get(owner) is not SegmentKind.MEM
                ):
                    owner = None
                if owner is None:
                    owner = next(
                        (k for k in members[g]
                         if kinds.get(k) is SegmentKind.MEM),
                        None,
                    )
                self.bus_owner[g] = owner

            # running: CPU owners, bus holders (groups in appearance
            # order), then the accelerator under the policy's arbitration
            # model — kept in arbitration order for deterministic
            # completion processing
            running = []
            for g in groups:
                if cpu_owners[g] is not None:
                    running.append(cpu_owners[g])
            for g in groups:
                if self.bus_owner[g] is not None:
                    running.append(self.bus_owner[g])
            if gpu_mode == "none":
                # federated dedicated lanes: every GPU segment runs
                for k in order:
                    if kinds.get(k) is SegmentKind.GPU:
                        running.append(k)
            else:
                # one preemptive priority-driven GPU context per group
                for g in groups:
                    owner = next(
                        (k for k in members[g]
                         if kinds.get(k) is SegmentKind.GPU),
                        None,
                    )
                    last = self.gpu_owner.get(g)
                    if (
                        last is not None
                        and owner != last
                        and kinds.get(last) is SegmentKind.GPU
                        and self.jobs[last].remaining > _EPS
                    ):
                        # evicted mid-kernel: the victim is charged the
                        # context switch (state save/restore) and serves
                        # it when it re-acquires the GPU
                        self.jobs[last].remaining += gpu_ctx
                        self._gpu_preempted.add(last)
                        metrics.inc("engine_gpu_preemptions_total")
                        metrics.inc("engine_gpu_ctx_charged_total",
                                    amount=gpu_ctx)
                        self.record(
                            "preempt", last, resource="gpu",
                            by=policy.display_name(owner)
                            if owner is not None else "",
                        )
                    if owner is not None and owner in self._gpu_preempted:
                        self._gpu_preempted.discard(owner)
                        self.record("resume", owner, resource="gpu")
                    self.gpu_owner[g] = owner
                    if owner is not None:
                        running.append(owner)

            # 3. next event: earliest completion or policy-side event
            dt = math.inf
            for k in running:
                dt = min(dt, self.jobs[k].remaining)
            dt = min(dt, policy.next_external_time(self.now) - self.now)
            if not math.isfinite(dt):
                break
            dt = max(dt, 0.0)
            step_end = min(self.now + dt, horizon)
            dt = step_end - self.now

            self.steps += 1
            if obs:
                metrics.inc("engine_steps_total")
                metrics.observe("engine_step_width", dt,
                                buckets=metrics.DEFAULT_STEP_WIDTH_BUCKETS)

            for k in running:
                self.jobs[k].remaining -= dt
            advanced = step_end > self.now
            self.now = step_end
            if advanced:
                stall = 0
            else:
                stall += 1
                if stall >= self.max_same_time_steps:
                    raise self._livelock(stall, running)

            # 4. completions, in arbitration order
            for k in running:
                job = self.jobs.get(k)
                if job is None or job.remaining > _EPS:
                    continue
                g = policy.resource_group(k)
                if (
                    job.chain[job.seg_idx][0] is SegmentKind.MEM
                    and self.bus_owner.get(g) == k
                ):
                    self.bus_owner[g] = None
                if (
                    job.chain[job.seg_idx][0] is SegmentKind.GPU
                    and self.gpu_owner.get(g) == k
                ):
                    # release the GPU context with the kernel: a stale
                    # owner would read a successor job's fresh kernel as
                    # an in-flight one and bill it a phantom preemption
                    self.gpu_owner[g] = None
                job.seg_idx += 1
                if job.seg_idx < len(job.chain):
                    job.remaining = job.durations[job.seg_idx]
                    continue
                if obs:
                    response = self.now - job.release
                    metrics.inc("engine_jobs_completed_total")
                    metrics.observe(
                        "engine_response", response,
                        buckets=metrics.DEFAULT_RESPONSE_BUCKETS,
                        task=policy.display_name(k),
                    )
                    if self.now > job.deadline_abs + _EPS:
                        metrics.inc("engine_deadline_misses_total")
                policy.on_job_complete(k, job, self.now,
                                       self.now - job.release)

    def _run_indexed(self, horizon: float) -> None:
        """The event-indexed loop: byte-identical to the reference loop,
        re-arbitrating only dirty groups (see the module docstring)."""
        policy = self.policy
        gpu_mode, gpu_ctx = policy.gpu_arbitration()
        if gpu_mode not in ("none", "priority"):
            raise ValueError(f"unknown GPU arbitration mode {gpu_mode!r}")
        obs = metrics.enabled()
        jobs = self.jobs
        self._index_active = True
        self._full_stale = True
        stall = 0
        while self.now < horizon - policy.horizon_slack:
            # 1. external events, then releases due now (policy hooks may
            # mark groups dirty/stale via membership_changed/order_changed
            # and start_job)
            policy.begin_step(self.now)
            policy.release_jobs_fast(self.now)

            # 2. re-arbitrate only what changed.  Event order matches the
            # reference loop: CPU preempts for all (dirty) groups in
            # appearance order, then the GPU hand-offs.  Clean groups
            # cannot emit events or change owners — recomputing them is
            # provably a no-op, so they are skipped wholesale.
            if self._full_stale:
                self._rebuild_index()
            if self._stale:
                self._resort_stale()
            if self._dirty:
                dirty = sorted(self._dirty, key=self._gpos.__getitem__)
                self._dirty.clear()
                for g in dirty:
                    self._arbitrate_cpu_bus(g, obs)
                if gpu_mode == "none":
                    seg = self._seg
                    for g in dirty:
                        self._gpu_list[g] = [
                            k for k in self._members[g]
                            if seg.get(k) is SegmentKind.GPU
                        ]
                else:
                    for g in dirty:
                        self._arbitrate_gpu(g, gpu_ctx)
                for g in dirty:
                    # per-group min remaining over the group's running
                    # members; decremented in lockstep with them below, so
                    # it stays *exactly* the float min until the group is
                    # next dirtied.  A group with no running member holds
                    # NO entry (min = +inf) — ``_min_rem`` doubles as the
                    # active-group set, keeping the per-step min/decrement
                    # loops O(active), not O(groups)
                    rem = math.inf
                    k = self._cpu_owner.get(g)
                    if k is not None:
                        rem = jobs[k].remaining
                    k = self.bus_owner.get(g)
                    if k is not None and jobs[k].remaining < rem:
                        rem = jobs[k].remaining
                    for k in self._gpu_list.get(g, ()):
                        if jobs[k].remaining < rem:
                            rem = jobs[k].remaining
                    if rem == math.inf:
                        self._min_rem.pop(g, None)
                    else:
                        self._min_rem[g] = rem
                self._rebuild_running()

            # 3. next event: earliest completion (min over per-group
            # mins — the same float value as the reference min over all
            # running jobs) or policy-side event
            dt = math.inf
            min_rem = self._min_rem
            for v in min_rem.values():
                if v < dt:
                    dt = v
            dt = min(dt, policy.next_external_time_fast(self.now) - self.now)
            if not math.isfinite(dt):
                break
            dt = max(dt, 0.0)
            step_end = min(self.now + dt, horizon)
            dt = step_end - self.now

            self.steps += 1
            if obs:
                metrics.inc("engine_steps_total")
                metrics.observe("engine_step_width", dt,
                                buckets=metrics.DEFAULT_STEP_WIDTH_BUCKETS)

            running = self._running
            for k in running:
                jobs[k].remaining -= dt
            if dt:
                for g in min_rem:
                    min_rem[g] -= dt
            advanced = step_end > self.now
            self.now = step_end
            if advanced:
                stall = 0
            else:
                stall += 1
                if stall >= self.max_same_time_steps:
                    raise self._livelock(stall, running)

            # 4. completions, in arbitration order (the flat running list
            # preserves it); every touched group is re-arbitrated next step
            for k in running:
                job = jobs.get(k)
                if job is None or job.remaining > _EPS:
                    continue
                g = policy.resource_group(k)
                kind = job.chain[job.seg_idx][0]
                if kind is SegmentKind.MEM and self.bus_owner.get(g) == k:
                    self.bus_owner[g] = None
                if kind is SegmentKind.GPU and self.gpu_owner.get(g) == k:
                    # release the GPU context with the kernel (see the
                    # reference loop)
                    self.gpu_owner[g] = None
                self._dirty.add(g)
                job.seg_idx += 1
                if job.seg_idx < len(job.chain):
                    job.remaining = job.durations[job.seg_idx]
                    self._seg[k] = job.chain[job.seg_idx][0]
                    continue
                self._seg[k] = None
                if obs:
                    response = self.now - job.release
                    metrics.inc("engine_jobs_completed_total")
                    metrics.observe(
                        "engine_response", response,
                        buckets=metrics.DEFAULT_RESPONSE_BUCKETS,
                        task=policy.display_name(k),
                    )
                    if self.now > job.deadline_abs + _EPS:
                        metrics.inc("engine_deadline_misses_total")
                policy.on_job_complete(k, job, self.now,
                                       self.now - job.release)
