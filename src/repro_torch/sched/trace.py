"""Event-trace telemetry for the online scheduler.

Every layer of the runtime — the :class:`DynamicController`, the
discrete-event simulator and the wall-clock executor — can record into one
:class:`EventTrace`.  Events carry a scheduler-domain kind:

  lifecycle   admit, reject, depart, reclaim, update, realloc
  per job     release, start, preempt, resume, complete, miss

The trace exports to the Chrome trace-event JSON format (load in
``chrome://tracing`` or Perfetto): one timeline row (``tid``) per task,
``B``/``E`` duration slices spanning release→completion of each job, and
instant events for everything else.  Deadline misses become flow-less
instant events with the overshoot attached, so a miss is one click away
from the preemptions that caused it.

**Multi-host traces.**  An event whose meta carries ``host=<int>`` is
attributed to that host: the Chrome export derives ``pid`` from it
(``host + 1``) with one ``process_name`` lane group per host, so a fleet
trace renders host-by-host.  :meth:`EventTrace.for_host` returns a scoped
recorder that injects the ``host`` key into every event — per-host
controllers in a :class:`~repro_torch.sched.CapacityBroker` each record through
one.  Traces with no ``host`` meta (the single-host default) export
byte-identically to the pre-federation format (``pid`` 1, one process
row).

Besides the (lossy, render-oriented) Chrome export, traces round-trip
losslessly through a native JSON form: ``to_json``/``from_json`` (objects)
and ``save``/``load`` (files) preserve every event verbatim, which is what
the golden-trace regression corpus under ``tests/golden/`` is built on.
``EventTrace.diff`` locates the first divergent event between two traces —
the regression harness and the CI job report that instead of a bare
assert.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from typing import Iterable, Optional

from repro_torch.obs import metrics

__all__ = ["TraceEvent", "EventTrace", "HostTrace", "KINDS", "SPAN_NAMES"]

#: kinds that open/close a job duration slice in the Chrome export
_JOB_BEGIN = "release"
_JOB_END = "complete"

#: every kind the runtime layers emit (documented contract, not enforced);
#: "migrate" is the broker's departure-imbalance move instant; "span" and
#: "ctr" are the opt-in control-plane rows (analysis-stage durations and
#: gauge samples — see :meth:`EventTrace.span` / :meth:`EventTrace.counter`)
KINDS = (
    "admit", "reject", "depart", "reclaim", "update", "realloc", "migrate",
    "release", "start", "preempt", "resume", "complete", "miss",
    "span", "ctr",
)

#: control-plane span names the analysis layers emit when spans are on
SPAN_NAMES = ("certify", "pinned_sweep", "grid_search", "placement",
              "migrate")


def _jsonify(value):
    """Normalize a meta value into JSON-native shape (tuples → lists,
    recursively) so the JSON round-trip is lossless by construction."""
    if isinstance(value, (tuple, list)):
        return [_jsonify(v) for v in value]
    if isinstance(value, dict):
        return {k: _jsonify(v) for k, v in value.items()}
    return value


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    t: float              # timestamp in the producer's clock unit
    kind: str
    task: str
    meta: tuple = ()      # sorted (key, value) pairs, JSON-native values

    def as_dict(self) -> dict:
        return {"t": self.t, "kind": self.kind, "task": self.task,
                "meta": dict(self.meta)}


class EventTrace:
    """Append-only scheduler event log with Chrome-trace export.

    ``us_per_unit`` converts the producer's clock to microseconds (the
    Chrome trace unit): the simulator runs in model milliseconds
    (``us_per_unit=1000``), the wall-clock executor in seconds
    (``us_per_unit=1e6``).
    """

    def __init__(self, us_per_unit: float = 1000.0, label: str = "rtgpu",
                 spans: bool = False):
        self.us_per_unit = us_per_unit
        self.label = label
        #: opt-in control-plane rows: when False (the default) the
        #: :meth:`span`/:meth:`counter` recorders are no-ops, so traces —
        #: and the golden corpus built on them — are byte-identical to the
        #: pre-observability format
        self.spans = spans
        self.events: list[TraceEvent] = []
        self._subscribers: tuple = ()

    def record(self, t: float, kind: str, task: str, **meta) -> TraceEvent:
        ev = TraceEvent(
            t=float(t), kind=kind, task=task,
            meta=tuple(sorted((k, _jsonify(v)) for k, v in meta.items())),
        )
        self.events.append(ev)
        for cb in self._subscribers:
            # subscribers observe the stream; one raising must neither
            # abort the producer (the simulation / controller mid-commit)
            # nor starve the subscribers after it — log, count, continue
            try:
                cb(ev)
            except Exception:
                metrics.inc("monitor_callback_errors_total")
                logging.getLogger(__name__).exception(
                    "trace subscriber raised on %s event for task %r",
                    ev.kind, ev.task,
                )
        return ev

    def attach(self, callback) -> "EventTrace":
        """Subscribe ``callback(event)`` to every subsequently recorded
        event.  Subscribers observe the stream; they cannot alter it —
        the recorded trace (and its byte-exact dump) is unaffected.  This
        is the seam a live :class:`~repro_torch.obs.BoundMonitor` hangs off."""
        self._subscribers = self._subscribers + (callback,)
        return self

    def span(self, t: float, name: str, dur_ms: float, **meta) -> Optional[TraceEvent]:
        """Record a control-plane span: an analysis-domain stage (one of
        :data:`SPAN_NAMES`, or any other label) that took ``dur_ms`` of
        *wall-clock* time, anchored at model-time ``t``.  No-op unless
        the trace was built with ``spans=True``."""
        if not self.spans:
            return None
        return self.record(t, "span", name, dur_ms=round(float(dur_ms), 6),
                           **meta)

    def counter(self, t: float, name: str, **values) -> Optional[TraceEvent]:
        """Record a Chrome counter sample (``ph: "C"``): named series
        values at model-time ``t`` (e.g. per-task headroom gauges).
        No-op unless the trace was built with ``spans=True``."""
        if not self.spans:
            return None
        return self.record(t, "ctr", name, **values)

    def for_host(self, host: int) -> "HostTrace":
        """Scoped recorder appending to THIS trace with ``host=<host>``
        injected into every event's meta (one Chrome lane group per host)."""
        return HostTrace(self, host)

    def __len__(self) -> int:
        return len(self.events)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for ev in self.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    def by_task(self, task: str) -> list[TraceEvent]:
        return [ev for ev in self.events if ev.task == task]

    def misses(self) -> list[TraceEvent]:
        return [ev for ev in self.events if ev.kind == "miss"]

    def diff(
        self, other: "EventTrace | Iterable[TraceEvent]"
    ) -> Optional[tuple[int, Optional[TraceEvent], Optional[TraceEvent]]]:
        """First divergence against ``other``: ``(index, ours, theirs)``.

        A missing event on either side shows up as ``None``; identical
        traces return ``None``.  Compares the full event tuple (t, kind,
        task, meta) — the equality the golden-trace harness enforces."""
        theirs = other.events if isinstance(other, EventTrace) else list(other)
        for i in range(max(len(self.events), len(theirs))):
            a = self.events[i] if i < len(self.events) else None
            b = theirs[i] if i < len(theirs) else None
            if a != b:
                return i, a, b
        return None

    # ---- lossless JSON round-trip ------------------------------------------

    def to_json(self) -> dict:
        """Native JSON object preserving every event verbatim (unlike the
        render-oriented :meth:`to_chrome`)."""
        return {
            "format": 1,
            "label": self.label,
            "us_per_unit": self.us_per_unit,
            "events": [ev.as_dict() for ev in self.events],
        }

    @classmethod
    def from_json(cls, doc: dict) -> "EventTrace":
        fmt = doc.get("format", 1)
        if fmt != 1:
            raise ValueError(f"unsupported EventTrace format {fmt!r}")
        trace = cls(
            us_per_unit=float(doc.get("us_per_unit", 1000.0)),
            label=str(doc.get("label", "rtgpu")),
        )
        for ev in doc.get("events", ()):
            trace.events.append(TraceEvent(
                t=float(ev["t"]),
                kind=str(ev["kind"]),
                task=str(ev["task"]),
                meta=tuple(sorted(ev.get("meta", {}).items())),
            ))
        return trace

    def dumps(self) -> str:
        """Canonical JSON text: sorted keys, no whitespace — byte-stable
        under ``dumps → loads/from_json → dumps`` (golden-file contract)."""
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def loads(cls, text: str) -> "EventTrace":
        return cls.from_json(json.loads(text))

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            fh.write(self.dumps())
        return path

    @classmethod
    def load(cls, path: str) -> "EventTrace":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    # ---- Chrome trace-event export -----------------------------------------

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (``traceEvents`` array form).

        Job slices pair ``release → complete`` for producers where releases
        strictly alternate with completions (the simulators: at most one
        job in flight per task).  When the trace contains ``start`` events
        (the wall-clock executor, which can queue several released jobs
        behind one running job), slices pair ``start → complete`` instead
        and releases render as instants — B/E events are stack-paired per
        timeline row in Chrome, so the opener must alternate with the
        closer."""
        begin_kind = (
            "start"
            if any(ev.kind == "start" for ev in self.events)
            else _JOB_BEGIN
        )
        rows: list[dict] = []
        tids: dict[tuple[int, str], int] = {}
        next_tid: dict[int, int] = {}

        def pid_of(meta: dict) -> int:
            # host h renders as process h+1; un-tagged events stay on pid 1
            # (the pre-federation layout, byte-identical for such traces)
            return int(meta.get("host", 0)) + 1

        def tid(pid: int, task: str) -> int:
            key = (pid, task)
            if key not in tids:
                next_tid[pid] = next_tid.get(pid, 0) + 1
                tids[key] = next_tid[pid]
                rows.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tids[key], "args": {"name": task},
                })
            return tids[key]

        hosts = sorted({
            int(dict(ev.meta)["host"]) for ev in self.events
            if "host" in dict(ev.meta)
        })
        if hosts:
            for h in hosts:
                rows.append({"name": "process_name", "ph": "M", "pid": h + 1,
                             "args": {"name": f"{self.label}/host{h}"}})
        else:
            rows.append({"name": "process_name", "ph": "M", "pid": 1,
                         "args": {"name": self.label}})
        for ev in self.events:
            ts = ev.t * self.us_per_unit
            meta = dict(ev.meta)
            pid = pid_of(meta)
            if ev.kind == "span":
                # control-plane stage: a complete ("X") slice on a dedicated
                # per-host row, anchored at model-time t with its wall-clock
                # dur_ms rendered as the slice width — Perfetto then shows
                # analysis cost stacked against the data-plane timeline
                rows.append({
                    "pid": pid, "tid": tid(pid, "control-plane"), "ts": ts,
                    "cat": "control", "name": ev.task, "ph": "X",
                    "dur": meta.get("dur_ms", 0.0) * 1e3, "args": meta,
                })
                continue
            if ev.kind == "ctr":
                rows.append({
                    "pid": pid, "tid": 0, "ts": ts, "cat": "control",
                    "name": ev.task, "ph": "C",
                    "args": {k: v for k, v in meta.items() if k != "host"},
                })
                continue
            base = {"pid": pid, "tid": tid(pid, ev.task), "ts": ts,
                    "cat": "sched", "args": meta}
            if ev.kind == begin_kind:
                rows.append({**base, "name": f"{ev.task} job", "ph": "B"})
            elif ev.kind == _JOB_END:
                rows.append({**base, "name": f"{ev.task} job", "ph": "E"})
            else:
                rows.append({**base, "name": ev.kind, "ph": "i", "s": "t"})
        return {"traceEvents": rows, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh, indent=None, separators=(",", ":"))
        return path


class HostTrace:
    """Host-scoped view of an :class:`EventTrace` (see
    :meth:`EventTrace.for_host`).

    Duck-types the recording surface the producers use (``record``), so a
    per-host :class:`~repro_torch.sched.DynamicController` can be handed one in
    place of the shared trace; every event lands in the parent trace with
    ``host`` stamped into its meta.  An explicit ``host=`` keyword from
    the producer wins (the broker records cross-host events like
    ``migrate`` that way)."""

    def __init__(self, parent: EventTrace, host: int):
        self.parent = parent
        self.host = int(host)

    def record(self, t: float, kind: str, task: str, **meta) -> TraceEvent:
        meta.setdefault("host", self.host)
        return self.parent.record(t, kind, task, **meta)

    @property
    def spans(self) -> bool:
        return self.parent.spans

    def span(self, t: float, name: str, dur_ms: float, **meta):
        meta.setdefault("host", self.host)
        return self.parent.span(t, name, dur_ms, **meta)

    def counter(self, t: float, name: str, **values):
        values.setdefault("host", self.host)
        return self.parent.counter(t, name, **values)

    def attach(self, callback) -> "HostTrace":
        self.parent.attach(callback)
        return self

    @property
    def events(self) -> list[TraceEvent]:
        return self.parent.events
