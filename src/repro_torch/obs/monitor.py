"""Certified-bound runtime monitor: observed R versus certified R̂.

The analysis certifies a response bound R̂ per admitted task; the runtime
then *observes* actual responses.  :class:`BoundMonitor` closes the loop
the ROADMAP's measured-timing-calibration item asks for: it consumes
scheduler events (live, via :meth:`attach` on an
``repro_torch.sched.EventTrace``, or offline via :meth:`feed` over a recorded
trace), maintains per-task headroom gauges and an EWMA drift score, and
emits structured :class:`Alert`\\ s:

  ``bound_violation``   a completed job's observed response exceeded its
                        certified bound (must never fire on a sound run —
                        the no-false-alarms property in
                        ``tests/test_obs.py``)
  ``deadline_miss``     the runtime recorded a miss event
  ``slack_erosion``     the EWMA of observed/certified ratio crept above
                        ``1 - erosion_threshold``: the task still meets
                        its bound but its slack is drying up — the signal
                        for certified re-admission *before* anything is
                        violated

Alerts flow through the ``on_alert`` callback seam;
:func:`make_readmit_callback` wires that seam to a controller's (or
broker's) certified ``update_rate`` path, so an eroding task is re-rated
through the normal transitional-envelope certification — rejection
leaves the system untouched, exactly like any other mode change.

The monitor is deliberately dependency-free: events are duck-typed
(``.t``/``.kind``/``.task``/``.meta``), so it works on live traces,
golden-corpus JSON, and anything else shaped like a
:class:`~repro_torch.sched.trace.TraceEvent`.  Attaching a monitor never
mutates the trace — byte-identity of golden traces with a monitor
attached is asserted in ``tests/test_obs.py``.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Iterable, Optional

from . import metrics

__all__ = ["Alert", "TaskHealth", "BoundMonitor", "make_readmit_callback"]

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Alert:
    """One structured monitor alert."""

    t: float                 # producer-clock timestamp of the trigger event
    task: str
    kind: str                # "bound_violation" | "deadline_miss" | "slack_erosion"
    value: float             # the observed quantity (response, drift, ...)
    limit: float             # the threshold it crossed
    detail: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TaskHealth:
    """Mutable per-task monitor state (one per task name ever admitted)."""

    bound: float = math.inf          # latest certified R̂
    alloc: Optional[int] = None      # latest committed GN (when traced)
    jobs: int = 0
    misses: int = 0
    violations: int = 0
    last_response: float = 0.0
    worst_response: float = 0.0
    headroom: float = 1.0            # 1 - observed/R̂ of the latest job
    min_headroom: float = 1.0
    drift: float = 0.0               # EWMA of observed/R̂
    gpu_preemptions: int = 0
    cpu_preemptions: int = 0
    resident: bool = True
    _eroding: bool = False           # alert latch: one alert per episode

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("_eroding")
        return d


def _meta(ev) -> dict:
    m = getattr(ev, "meta", ())
    return m if isinstance(m, dict) else dict(m)


class BoundMonitor:
    """Per-task observed-R vs certified-R̂ tracking over scheduler events.

    ``ewma_alpha`` weights the newest job's observed/certified ratio in
    the drift score; ``erosion_threshold`` is the minimum acceptable
    EWMA headroom (``slack_erosion`` fires when drift exceeds
    ``1 - erosion_threshold``, latched once per erosion episode);
    ``on_alert`` is called with each :class:`Alert` as it is raised.

    When the metrics registry is enabled the monitor also exports
    ``monitor_headroom{task=}`` / ``monitor_drift{task=}`` gauges and a
    ``monitor_alerts_total{kind=}`` counter; when handed a
    ``counter_trace`` (an :class:`~repro_torch.sched.EventTrace` with spans
    enabled) it emits per-task Chrome counter rows, so Perfetto shows
    headroom shrinking alongside the job timeline.
    """

    def __init__(
        self,
        ewma_alpha: float = 0.25,
        erosion_threshold: float = 0.1,
        eps: float = _EPS,
        on_alert: Optional[Callable[[Alert], object]] = None,
        counter_trace=None,
    ):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if not 0.0 <= erosion_threshold < 1.0:
            raise ValueError("erosion_threshold must be in [0, 1)")
        self.ewma_alpha = ewma_alpha
        self.erosion_threshold = erosion_threshold
        self.eps = eps
        self.on_alert = on_alert
        self.counter_trace = counter_trace
        self.tasks: dict[str, TaskHealth] = {}
        self.alerts: list[Alert] = []
        self.admits = 0
        self.rejects = 0
        self.migrations = 0
        self.updates = 0

    # ---- event consumption --------------------------------------------------

    def attach(self, trace) -> "BoundMonitor":
        """Subscribe to a live :class:`~repro_torch.sched.EventTrace`: every
        subsequently recorded event is observed (the trace itself is not
        modified in any way)."""
        trace.attach(self.observe_event)
        return self

    def feed(self, events: Iterable) -> "BoundMonitor":
        """Offline ingestion of recorded events (an ``EventTrace``, its
        ``.events`` list, or any iterable of event-shaped objects)."""
        for ev in getattr(events, "events", events):
            self.observe_event(ev)
        return self

    def _state(self, task: str) -> TaskHealth:
        st = self.tasks.get(task)
        if st is None:
            st = self.tasks[task] = TaskHealth()
        return st

    def _raise_alert(self, alert: Alert) -> None:
        self.alerts.append(alert)
        metrics.inc("monitor_alerts_total", kind=alert.kind)
        if self.on_alert is not None:
            # a raising alert handler must not abort the run it observes:
            # the alert itself is already recorded above, so log, count,
            # and keep going
            try:
                self.on_alert(alert)
            except Exception:
                metrics.inc("monitor_callback_errors_total")
                logging.getLogger(__name__).exception(
                    "on_alert callback raised for %s alert on task %r",
                    alert.kind, alert.task,
                )

    def observe_event(self, ev) -> None:
        kind = ev.kind
        if kind == "admit":
            meta = _meta(ev)
            st = self._state(ev.task)
            st.resident = True
            b = meta.get("bound")
            if b is not None:
                st.bound = float(b)
            if meta.get("gn") is not None:
                st.alloc = int(meta["gn"])
            self.admits += 1
            self._export_gauges(ev.task, st)
        elif kind == "complete":
            self._on_complete(ev)
        elif kind == "miss":
            st = self._state(ev.task)
            st.misses += 1
            self._raise_alert(Alert(
                t=ev.t, task=ev.task, kind="deadline_miss",
                value=_meta(ev).get("overshoot", 0.0), limit=0.0,
                detail="runtime recorded a deadline miss",
            ))
        elif kind == "preempt":
            st = self._state(ev.task)
            if _meta(ev).get("resource") == "gpu":
                st.gpu_preemptions += 1
            else:
                st.cpu_preemptions += 1
        elif kind == "update":
            meta = _meta(ev)
            st = self._state(ev.task)
            b = meta.get("bound")
            if b is not None:
                st.bound = float(b)
            self.updates += 1
        elif kind == "migrate":
            meta = _meta(ev)
            st = self._state(ev.task)
            b = meta.get("bound")
            if b is not None:
                st.bound = float(b)
            self.migrations += 1
        elif kind == "reject":
            self.rejects += 1
        elif kind in ("reclaim", "depart"):
            st = self.tasks.get(ev.task)
            if st is not None and kind == "reclaim":
                st.resident = False

    def _on_complete(self, ev) -> None:
        meta = _meta(ev)
        st = self._state(ev.task)
        response = float(meta.get("response", 0.0))
        # job-level bound first (churn sims stamp the epoch-lifted bound on
        # each completion); the task-level certified bound as fallback
        bound = meta.get("bound")
        bound = float(bound) if bound is not None else st.bound
        if math.isfinite(bound):
            st.bound = bound
        st.jobs += 1
        st.last_response = response
        st.worst_response = max(st.worst_response, response)
        if math.isfinite(bound) and bound > 0.0:
            ratio = response / bound
            st.headroom = 1.0 - ratio
            st.min_headroom = min(st.min_headroom, st.headroom)
            st.drift = (self.ewma_alpha * ratio
                        + (1.0 - self.ewma_alpha) * st.drift)
            if response > bound + self.eps:
                st.violations += 1
                self._raise_alert(Alert(
                    t=ev.t, task=ev.task, kind="bound_violation",
                    value=response, limit=bound,
                    detail=f"observed R {response:.6g} > certified "
                           f"R̂ {bound:.6g}",
                ))
            erosion_limit = 1.0 - self.erosion_threshold
            if st.drift > erosion_limit:
                if not st._eroding:
                    st._eroding = True
                    self._raise_alert(Alert(
                        t=ev.t, task=ev.task, kind="slack_erosion",
                        value=st.drift, limit=erosion_limit,
                        detail=f"EWMA observed/certified "
                               f"{st.drift:.3f} > {erosion_limit:.3f}",
                    ))
            else:
                st._eroding = False
        self._export_gauges(ev.task, st, t=ev.t)

    def _export_gauges(self, task: str, st: TaskHealth, t=None) -> None:
        metrics.set_gauge("monitor_headroom", st.headroom, task=task)
        metrics.set_gauge("monitor_drift", st.drift, task=task)
        if self.counter_trace is not None and t is not None:
            self.counter_trace.counter(
                t, f"headroom/{task}", headroom=round(st.headroom, 6)
            )

    # ---- read side ----------------------------------------------------------

    def headroom(self, task: str) -> float:
        st = self.tasks.get(task)
        return st.headroom if st is not None else 1.0

    def drift(self, task: str) -> float:
        st = self.tasks.get(task)
        return st.drift if st is not None else 0.0

    def gauges(self) -> dict[str, dict]:
        """Per-task gauge snapshot (sorted; one entry per task ever
        admitted — the ≥1-gauge-per-resident-task contract)."""
        return {name: {
            "headroom": self.tasks[name].headroom,
            "min_headroom": self.tasks[name].min_headroom,
            "drift": self.tasks[name].drift,
            "bound": self.tasks[name].bound,
        } for name in sorted(self.tasks)}

    def alert_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for a in self.alerts:
            out[a.kind] = out.get(a.kind, 0) + 1
        return out

    def summary(self) -> dict:
        """End-of-run rollup: per-task health rows plus fleet totals."""
        per_task = {name: self.tasks[name].as_dict()
                    for name in sorted(self.tasks)}
        jobs = sum(st.jobs for st in self.tasks.values())
        misses = sum(st.misses for st in self.tasks.values())
        return {
            "tasks": per_task,
            "totals": {
                "tasks": len(self.tasks),
                "jobs": jobs,
                "misses": misses,
                "miss_rate": (misses / jobs) if jobs else 0.0,
                "violations": sum(
                    st.violations for st in self.tasks.values()
                ),
                "gpu_preemptions": sum(
                    st.gpu_preemptions for st in self.tasks.values()
                ),
                "cpu_preemptions": sum(
                    st.cpu_preemptions for st in self.tasks.values()
                ),
                "admits": self.admits,
                "rejects": self.rejects,
                "updates": self.updates,
                "migrations": self.migrations,
            },
            "alerts": [a.as_dict() for a in self.alerts],
        }


def make_readmit_callback(
    controller,
    stretch: float = 1.25,
    kinds: tuple = ("slack_erosion",),
) -> Callable[[Alert], object]:
    """Wire the alert seam to certified re-admission.

    Returns an ``on_alert`` callable that, for alerts of the given
    ``kinds``, asks ``controller`` (a
    :class:`~repro_torch.sched.DynamicController` or
    :class:`~repro_torch.sched.CapacityBroker`) to re-rate the task to
    ``stretch ×`` its current period/deadline through the normal
    certified ``update_rate`` path — the transitional envelope is
    re-analyzed, and a rejection leaves the task (and the rest of the
    system) untouched.  The decision is returned to the caller for
    bookkeeping."""
    if stretch <= 1.0:
        raise ValueError("stretch must be > 1 (a re-rate must shed load)")

    def on_alert(alert: Alert):
        if alert.kind not in kinds:
            return None
        task = controller.task(alert.task)
        if task is None:
            return None
        return controller.update_rate(
            alert.task,
            period=task.period * stretch,
            deadline=task.deadline * stretch,
            t=alert.t,
        )

    return on_alert
