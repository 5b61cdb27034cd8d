"""``python -m repro_torch.obs.report`` — trace + metrics post-mortem report.

Ingests a scheduler trace in native JSON form — either a bare
``EventTrace.to_json()`` object or a golden-corpus document (the recorder
output with the trace under ``"trace"``) — runs it through a
:class:`~repro_torch.obs.BoundMonitor`, and prints:

  * the per-task observed-R vs certified-R̂ table (jobs, misses, worst
    response, bound, headroom, EWMA drift, GPU/CPU preemption counts);
  * the miss budget and fleet rollup (admits / rejects / updates /
    migrations / alerts);
  * a control-plane span summary (count + total/mean wall-clock per
    stage) when the trace carries ``span`` events;
  * the metrics snapshot (``--metrics snap.json``) when given one.

Examples::

    PYTHONPATH=src python -m repro_torch.obs.report tests/golden/preemptive_churn.json
    PYTHONPATH=src python -m repro_torch.obs.report --replay fleet_churn
    PYTHONPATH=src python -m repro_torch.obs.report trace.json --metrics snap.json --json

``--replay NAME`` re-records the named golden scenario in-process with
metrics enabled (the stored file is not touched) and reports on the fresh
trace + registry — the observability CI job drives exactly this path.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Optional, Sequence

from . import metrics
from .monitor import BoundMonitor

__all__ = ["build_report", "format_report", "main"]


def _fmt(v: float, width: int = 9) -> str:
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return "-".rjust(width)
    return f"{v:.3f}".rjust(width)


def load_trace_doc(doc: dict):
    """Accept a golden-corpus document or a bare native-trace object."""
    from repro_torch.sched import EventTrace

    if "trace" in doc and isinstance(doc["trace"], dict):
        return EventTrace.from_json(doc["trace"]), doc
    if "events" in doc:
        return EventTrace.from_json(doc), None
    raise ValueError(
        "unrecognized input: expected a golden document (with a 'trace' "
        "object) or an EventTrace native-JSON object (with 'events')"
    )


def build_report(trace, golden_doc: Optional[dict] = None,
                 snapshot: Optional[dict] = None) -> dict:
    """Structured report: monitor summary + span rollup (+ context)."""
    mon = BoundMonitor().feed(trace)
    spans: dict[str, dict] = {}
    for ev in trace.events:
        if ev.kind != "span":
            continue
        meta = dict(ev.meta)
        agg = spans.setdefault(ev.task, {"count": 0, "total_ms": 0.0})
        agg["count"] += 1
        agg["total_ms"] += float(meta.get("dur_ms", 0.0))
    for agg in spans.values():
        agg["mean_ms"] = agg["total_ms"] / agg["count"]
    report = {
        "label": trace.label,
        "events": len(trace.events),
        "monitor": mon.summary(),
        "spans": {k: spans[k] for k in sorted(spans)},
    }
    if golden_doc is not None:
        report["scenario"] = golden_doc.get("scenario")
        report["kind"] = golden_doc.get("kind")
    if snapshot is not None:
        report["metrics"] = snapshot
    return report


def format_report(report: dict) -> str:
    out: list[str] = []
    head = f"trace {report['label']!r}: {report['events']} events"
    if report.get("scenario"):
        head += f" (golden scenario {report['scenario']!r}," \
                f" kind {report['kind']})"
    out.append(head)
    mon = report["monitor"]
    tasks = mon["tasks"]
    out.append("")
    out.append(f"{'task':12s} {'jobs':>5s} {'miss':>5s} {'worst R':>9s} "
               f"{'R^':>9s} {'headroom':>9s} {'drift':>9s} "
               f"{'gpu-pre':>8s} {'cpu-pre':>8s}")
    for name in sorted(tasks):
        st = tasks[name]
        out.append(
            f"{name:12s} {st['jobs']:5d} {st['misses']:5d} "
            f"{_fmt(st['worst_response'])} {_fmt(st['bound'])} "
            f"{_fmt(st['headroom'])} {_fmt(st['drift'])} "
            f"{st['gpu_preemptions']:8d} {st['cpu_preemptions']:8d}"
        )
    tot = mon["totals"]
    out.append("")
    out.append(
        f"totals: {tot['tasks']} tasks, {tot['jobs']} jobs, "
        f"{tot['misses']} misses (rate {tot['miss_rate']:.4f}), "
        f"{tot['violations']} bound violations"
    )
    out.append(
        f"        {tot['admits']} admits, {tot['rejects']} rejects, "
        f"{tot['updates']} updates, {tot['migrations']} migrations; "
        f"{tot['gpu_preemptions']} GPU / {tot['cpu_preemptions']} CPU "
        f"preemptions"
    )
    alerts = mon["alerts"]
    if alerts:
        out.append(f"alerts ({len(alerts)}):")
        for a in alerts:
            out.append(
                f"  t={a['t']:<10.3f} {a['kind']:15s} {a['task']:12s} "
                f"value={a['value']:.4f} limit={a['limit']:.4f}"
            )
    else:
        out.append("alerts: none")
    spans = report.get("spans") or {}
    if spans:
        out.append("")
        out.append("control-plane spans (wall-clock):")
        out.append(f"  {'stage':14s} {'count':>6s} {'total ms':>10s} "
                   f"{'mean ms':>9s}")
        for name, agg in spans.items():
            out.append(
                f"  {name:14s} {agg['count']:6d} {agg['total_ms']:10.3f} "
                f"{agg['mean_ms']:9.3f}"
            )
    snap = report.get("metrics")
    if snap:
        out.append("")
        out.append(f"metrics snapshot: {len(snap)} families")
        for fam in sorted(snap):
            series = snap[fam].get("series", {})
            if snap[fam].get("kind") == "histogram":
                n = sum(s.get("count", 0) for s in series.values())
                out.append(f"  {fam:32s} histogram  n={n}")
            else:
                total = sum(s for s in series.values()
                            if isinstance(s, (int, float)))
                out.append(f"  {fam:32s} {snap[fam]['kind']:9s} "
                           f"sum={total:g}")
    return "\n".join(out)


def _replay(name: str):
    """Re-record a golden scenario in-process with metrics enabled."""
    from repro_torch.core import golden_scenario
    from repro_torch.runtime.record_golden import record_scenario

    metrics.enable(fresh=True)
    doc = record_scenario(golden_scenario(name))
    snapshot = metrics.registry().snapshot()
    metrics.disable()
    return doc, snapshot


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="Per-task R vs R^ report from a native-JSON trace.",
    )
    ap.add_argument("trace", nargs="?", default=None,
                    help="native trace JSON or golden-corpus document")
    ap.add_argument("--replay", metavar="NAME", default=None,
                    help="re-record the named golden scenario with metrics "
                         "enabled and report on the result")
    ap.add_argument("--metrics", metavar="PATH", default=None,
                    help="metrics snapshot JSON to fold into the report")
    ap.add_argument("--json", action="store_true",
                    help="emit the structured report as JSON")
    args = ap.parse_args(argv)

    if (args.trace is None) == (args.replay is None):
        ap.error("exactly one of a trace path or --replay NAME is required")

    snapshot = None
    if args.metrics:
        with open(args.metrics) as fh:
            snapshot = json.load(fh)

    if args.replay:
        doc, replay_snap = _replay(args.replay)
        if snapshot is None:
            snapshot = replay_snap
        from repro_torch.sched import EventTrace

        trace, golden_doc = EventTrace.from_json(doc["trace"]), doc
    else:
        with open(args.trace) as fh:
            doc = json.load(fh)
        trace, golden_doc = load_trace_doc(doc)

    report = build_report(trace, golden_doc, snapshot)
    if args.json:
        json.dump(report, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        print(format_report(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
