"""Golden-trace corpus recorder: ``python -m repro_torch.runtime.record_golden``.

Runs every :data:`repro_torch.core.GOLDEN_SCENARIOS` preset through the
discrete-event simulator and serializes the complete observable outcome —
RNG seed and scenario parameters, allocation, per-job responses/misses,
and the full :class:`~repro_torch.sched.EventTrace` — to one JSON file per
scenario under ``tests/golden/``.

``tests/test_golden_traces.py`` replays each file and asserts event-by-
event equality, so the corpus pins the scheduler's observable behavior:
any change to arbitration, RNG call order, or trace emission fails CI with
the first divergent event.  Regenerating the corpus is therefore a
*deliberate* act — run this CLI and review the diff:

    PYTHONPATH=src python -m repro_torch.runtime.record_golden            # all
    PYTHONPATH=src python -m repro_torch.runtime.record_golden --only steady
    PYTHONPATH=src python -m repro_torch.runtime.record_golden --check    # no write
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

from repro_torch.core import GOLDEN_SCENARIOS, ScenarioPreset
from repro_torch.sched import EventTrace

from .simulator import simulate, simulate_churn, simulate_fleet

__all__ = ["GOLDEN_FORMAT", "preset_params", "record_scenario", "dump_doc",
           "main"]

#: bump when the golden-file schema changes (forces a deliberate re-record)
GOLDEN_FORMAT = 1

DEFAULT_OUT = os.path.join("tests", "golden")


def preset_params(preset: ScenarioPreset) -> dict:
    """JSON-normalized preset parameters (tuples become lists), stored in
    each golden file so the replay harness can detect preset drift.

    Only behavior-bearing fields: ``name``/``kind`` are stored separately,
    ``description`` is cosmetic (rewording it must not invalidate a
    recorded golden file), and fields the preset's kind never reads
    (``churn``/``churn_horizon`` for static scenarios, the task-set knobs
    for churn/fleet ones, the fleet knobs for single-host kinds) are
    dropped so unrelated default changes don't spuriously demand
    re-recording."""
    params = dataclasses.asdict(preset)
    fleet_fields = ("n_hosts", "placement", "imbalance_threshold")
    if preset.kind == "static":
        irrelevant = ("churn", "churn_horizon") + fleet_fields
    elif preset.kind == "churn":
        irrelevant = ("total_util", "config") + fleet_fields
    else:                                  # fleet
        irrelevant = ("total_util", "config")
    for field in ("name", "kind", "description") + irrelevant:
        params.pop(field, None)
    if preset.preemption == "none":
        # the inert default: dedicated-slice presets recorded before the
        # arbitration seam existed stay valid without re-recording (the
        # ctx overhead is read only under "priority")
        params.pop("preemption", None)
        params.pop("gpu_ctx_overhead", None)
    return json.loads(json.dumps(params))


def record_scenario(preset: ScenarioPreset) -> dict:
    """One corpus entry: run the preset and capture every observable."""
    trace = EventTrace(label=f"golden:{preset.name}")
    doc: dict = {
        "format": GOLDEN_FORMAT,
        "scenario": preset.name,
        "kind": preset.kind,
        "description": preset.description,
        "params": preset_params(preset),
    }
    if preset.kind == "static":
        ts, alloc = preset.build_static()
        res = simulate(
            ts, alloc, preset.horizon, seed=preset.seed,
            release_jitter=preset.release_jitter,
            worst_case=preset.worst_case, trace=trace,
            preemption=preset.preemption,
            gpu_ctx_overhead=preset.gpu_ctx_overhead,
        )
        doc["alloc"] = alloc
        doc["result"] = {
            "responses": res.responses,
            "misses": res.misses,
            "jobs": res.jobs,
        }
    elif preset.kind == "churn":
        events = preset.build_churn()
        res = simulate_churn(
            events, preset.gn_total, preset.horizon, seed=preset.seed,
            release_jitter=preset.release_jitter,
            worst_case=preset.worst_case, trace=trace,
            preemption=preset.preemption,
            gpu_ctx_overhead=preset.gpu_ctx_overhead,
        )
        doc["result"] = {
            "responses": res.responses,
            "bounds": res.bounds,
            "misses": res.misses,
            "jobs": res.jobs,
            "admitted": res.admitted,
            "rejected": res.rejected,
        }
    else:                                  # fleet
        events = preset.build_churn()
        res = simulate_fleet(
            events, preset.n_hosts, preset.gn_total, preset.horizon,
            seed=preset.seed, release_jitter=preset.release_jitter,
            worst_case=preset.worst_case, placement=preset.placement,
            imbalance_threshold=preset.imbalance_threshold, trace=trace,
            preemption=preset.preemption,
            gpu_ctx_overhead=preset.gpu_ctx_overhead,
        )
        doc["result"] = {
            "responses": res.responses,
            "bounds": res.bounds,
            "misses": res.misses,
            "jobs": res.jobs,
            "admitted": res.admitted,
            "rejected": res.rejected,
            "placements": res.placements,
            "migrations": res.migrations,
            "n_hosts": res.n_hosts,
        }
    doc["trace"] = trace.to_json()
    return doc


def dump_doc(doc: dict) -> str:
    """Canonical golden-file text: sorted keys, one-space indent — stable
    bytes for identical runs, reviewable line diffs for intentional ones."""
    return json.dumps(doc, sort_keys=True, indent=1, separators=(",", ": "))


def _summarize(doc: dict) -> str:
    result = doc["result"]
    if doc["kind"] == "static":
        jobs = sum(result["jobs"])
        misses = sum(result["misses"])
    else:
        jobs = sum(result["jobs"].values())
        misses = sum(result["misses"].values())
    return (f"{doc['scenario']:20s} {doc['kind']:6s} "
            f"events={len(doc['trace']['events']):5d} jobs={jobs:4d} "
            f"misses={misses}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.runtime.record_golden",
        description="(Re)generate the golden-trace regression corpus.",
    )
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"output directory (default: {DEFAULT_OUT})")
    ap.add_argument("--only", action="append", default=None, metavar="NAME",
                    help="record only the named scenario (repeatable)")
    ap.add_argument("--check", action="store_true",
                    help="re-run scenarios and diff against existing files "
                         "instead of writing (exit 1 on divergence)")
    args = ap.parse_args(argv)

    presets = GOLDEN_SCENARIOS
    if args.only:
        unknown = set(args.only) - {p.name for p in presets}
        if unknown:
            ap.error(f"unknown scenario(s): {sorted(unknown)}")
        presets = tuple(p for p in presets if p.name in set(args.only))

    os.makedirs(args.out, exist_ok=True)
    divergent = []
    for preset in presets:
        doc = record_scenario(preset)
        path = os.path.join(args.out, f"{preset.name}.json")
        text = dump_doc(doc)
        if args.check:
            try:
                with open(path) as fh:
                    stored = fh.read()
            except FileNotFoundError:
                stored = None
            status = "ok" if stored == text + "\n" else "DIVERGED"
            if status != "ok":
                divergent.append(preset.name)
            print(f"{_summarize(doc)}  [{status}]")
        else:
            with open(path, "w") as fh:
                fh.write(text + "\n")
            print(f"{_summarize(doc)}  -> {path}")
    if args.check and divergent:
        print(f"divergent scenarios: {divergent}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
