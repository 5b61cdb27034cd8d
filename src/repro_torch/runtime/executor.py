"""Best-effort wall-clock executor: admitted model services running REAL
jitted decode steps under fixed-priority dispatch (single-host demo of the
runtime; the hard-RT guarantees live in the simulator + analysis, since a
shared CPU host has no federated isolation).

Supports *live churn*: services can join and leave mid-run — either
programmatically (:meth:`WallClockExecutor.add_service` /
:meth:`remove_service`) or via a timed event script passed to
:meth:`run`.  Removal honors the job-boundary rule: a service leaves only
after its current job returns (jobs are never killed mid-flight).  All
scheduling activity can be recorded into a :class:`repro_torch.sched.EventTrace`
(clock in seconds → ``us_per_unit=1e6``) for Chrome-trace export.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.sched import EventTrace

__all__ = ["Service", "WallClockExecutor"]


@dataclasses.dataclass
class Service:
    name: str
    period_s: float
    deadline_s: float
    run_job: Callable[[], None]   # executes one request end-to-end

    # stats
    released: int = 0
    completed: int = 0
    missed: int = 0
    worst_response_s: float = 0.0


class WallClockExecutor:
    """Release jobs periodically; always run the earliest-deadline-class
    ready job (deadline-monotonic: dispatch keys directly on ``deadline_s``,
    which stays correct when services join or leave mid-run)."""

    def __init__(
        self,
        services: list[Service],
        trace: Optional[EventTrace] = None,
    ):
        self.services = sorted(services, key=lambda s: s.deadline_s)
        self.trace = trace
        self._now = 0.0
        self._next_release: dict[str, float] = {}

    def _record(self, kind: str, task: str, **meta) -> None:
        if self.trace is not None:
            self.trace.record(self._now, kind, task, **meta)

    # ---- live churn ---------------------------------------------------------

    def add_service(self, svc: Service) -> None:
        """Join a service mid-run: first release at the current instant."""
        if any(s.name == svc.name for s in self.services):
            raise ValueError(f"service {svc.name!r} already running")
        self.services.append(svc)
        self._next_release[svc.name] = self._now
        self._record("admit", svc.name, period_s=svc.period_s,
                     deadline_s=svc.deadline_s)

    def remove_service(self, name: str) -> bool:
        """Leave at the job boundary: pending ready jobs are dropped, a job
        already running returns normally (the run loop never kills one)."""
        before = len(self.services)
        self.services = [s for s in self.services if s.name != name]
        if len(self.services) == before:
            return False
        self._next_release.pop(name, None)
        self._record("reclaim", name)
        return True

    # ---- main loop ----------------------------------------------------------

    def run(
        self,
        duration_s: float,
        events: Optional[Sequence[tuple[float, Callable]]] = None,
        poll_s: float = 0.001,
    ) -> dict:
        """Run for ``duration_s``.  ``events`` is an optional churn script:
        ``(t, fn)`` pairs, each ``fn(executor)`` called once the wall clock
        passes ``t`` (e.g. ``lambda ex: ex.add_service(svc)``)."""
        t0 = time.perf_counter()
        script = sorted(events, key=lambda e: e[0]) if events else []
        script_idx = 0
        self._next_release = {s.name: 0.0 for s in self.services}
        # deadline-monotonic dispatch keyed by the deadline itself (stable
        # across mid-run add/remove; priority indices would go stale inside
        # already-pushed heap entries when the membership changes)
        ready: list[tuple[float, float, int, Service]] = []  # (deadline, release, seq, svc)
        seq = 0
        # every Service object that ever ran, in join order; a re-added name
        # aggregates with its earlier residency in the returned stats
        stats_seen: list[Service] = list(self.services)

        while True:
            now = time.perf_counter() - t0
            self._now = now
            if now >= duration_s:
                break
            while script_idx < len(script) and now >= script[script_idx][0]:
                script[script_idx][1](self)
                for s in self.services:
                    # identity, not ==: a re-added Service may compare equal
                    # to a retired one with zeroed stats
                    if not any(x is s for x in stats_seen):
                        stats_seen.append(s)
                script_idx += 1
            # identity, not name: a stale heap entry from a removed service
            # must not run again if a new service re-uses the name
            alive = {id(s) for s in self.services}
            for s in self.services:
                if now >= self._next_release[s.name]:
                    heapq.heappush(
                        ready, (s.deadline_s, self._next_release[s.name], seq, s)
                    )
                    seq += 1
                    s.released += 1
                    self._record("release", s.name)
                    self._next_release[s.name] += s.period_s
            # drop ready jobs of departed services (job-boundary removal)
            while ready and id(ready[0][3]) not in alive:
                heapq.heappop(ready)
            if not ready:
                time.sleep(min(poll_s, duration_s - now))
                continue
            _, release, _, svc = heapq.heappop(ready)
            if id(svc) not in alive:
                continue
            self._record("start", svc.name)
            svc.run_job()
            self._now = time.perf_counter() - t0
            resp = self._now - release
            svc.completed += 1
            svc.worst_response_s = max(svc.worst_response_s, resp)
            self._record("complete", svc.name, response_s=resp)
            if resp > svc.deadline_s:
                svc.missed += 1
                self._record("miss", svc.name,
                             overshoot_s=resp - svc.deadline_s)

        out: dict = {}
        for s in stats_seen:
            agg = out.setdefault(s.name, {
                "released": 0, "completed": 0, "missed": 0,
                "worst_response_ms": 0.0,
            })
            agg["released"] += s.released
            agg["completed"] += s.completed
            agg["missed"] += s.missed
            agg["worst_response_ms"] = max(
                agg["worst_response_ms"], s.worst_response_s * 1e3
            )
        return out
