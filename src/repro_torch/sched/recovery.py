"""Crash recovery: rebuild and re-certify the control plane from a journal.

The counterpart of :mod:`repro_torch.sched.journal`.  A journal prefix on disk
describes the last durable control-plane state; this module turns it back
into live objects in three stages:

**1. Replay** (:func:`replay`).  Starting from the latest compaction
snapshot (if any), every journal record is folded back into per-host
ledger state — entries in their original insertion order (the
deadline-monotonic stable-sort tiebreak, so recovered priority orders
match pre-crash ones), the certified R̂ bounds exactly as journaled, and
the controller epoch — plus the broker's fleet bookkeeping (active hosts,
in-flight migrations).  Single-host operations are atomic (one record
each), so replay of any prefix lands on a state the pre-crash controller
actually held.  The broker's two-phase migration is the one multi-record
transaction; a crash inside it leaves a *dangling intent*, resolved
deterministically to a deadline-safe side per the protocol contract:

  * intent only (target host never admitted) → **roll back** — nothing
    happened, the intent is dropped;
  * target admitted (its ``admit`` record is durable) → **roll forward** —
    the source release the broker would have issued is applied
    (release-at-boundary on a boundary-mode source, immediate reclaim on
    an instant one) and the migration is registered in flight (or
    completed, when the source already reclaimed).

  Both sides are safe: rolled back, the target holds nothing and the
  source keeps its certified residency; rolled forward, the task is
  certified on BOTH hosts until the source job boundary, exactly like a
  live migration.

**2. Re-certification** (:func:`recover`).  The replayed resident set of
every host is pushed back through the :class:`CertificationEngine` the
journal's ``meta`` configuration describes (``partial=True``: every task
gets a bound, ``inf`` marks failures).  Each task is classified:

  ``exact``         recomputed R̂ == journaled R̂ bit-for-bit (the normal
                    case — JSON floats round-trip exactly);
  ``conservative``  recomputed < journaled: the journaled bound was
                    certified against a superset context (residents have
                    since reclaimed, staged changes committed) and is
                    still a sound upper bound — the journaled value is
                    kept so recovered state stays bit-identical to the
                    pre-crash controller;
  quarantined       recomputed > journaled, or infinite: the journaled
                    guarantee is unsound (tampered journal, config drift,
                    analysis bug).  The task is REMOVED from the
                    recovered resident set and a structured
                    :class:`RecoveryAlert` is raised — the deadline-safe
                    side is to not re-admit what cannot be re-certified.

**3. Reconstruction** (:func:`recover_controller` /
:func:`recover_broker`).  Fresh :class:`DynamicController` /
:class:`CapacityBroker` objects are built from the journaled ``meta``
configuration (``ensure_meta`` re-verifies it), the recovered state is
installed via their ``restore()`` hooks, and the journal stays attached —
the recovered control plane keeps journaling where the crashed one
stopped.

:func:`serialize_state` produces the snapshot document
:meth:`Journal.checkpoint` stores (and the daemon's graceful-shutdown
checkpoint): replay consumes it transparently, so a compacted journal
recovers exactly like an uncompacted one.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Union

from repro_torch.core import AnalysisTables
from repro_torch.obs import metrics

from .capacity import Entry
from .certify import make_certifier
from .controller import DynamicController
from .federation import CapacityBroker, Migration
from .journal import (
    FORMAT,
    Journal,
    entry_from_dict,
    entry_to_dict,
    task_from_dict,
)

__all__ = [
    "HostState",
    "LedgerState",
    "RecoveryAlert",
    "RecoveryReport",
    "replay",
    "recover",
    "recover_controller",
    "recover_broker",
    "serialize_state",
]

#: recovery wall-clock spans ~1ms (empty journal) to seconds (large pools)
_RECOVERY_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)


@dataclasses.dataclass
class HostState:
    """One host's replayed ledger: entries (insertion order preserved),
    journaled certified bounds, controller epoch."""

    entries: dict[str, Entry] = dataclasses.field(default_factory=dict)
    bounds: dict[str, float] = dataclasses.field(default_factory=dict)
    epoch: int = 0


@dataclasses.dataclass
class LedgerState:
    """The full replayed control-plane state (before re-certification)."""

    hosts: dict[int, HostState]
    active: dict[str, int]                 # broker: name -> active host
    migrations: dict[str, Migration]       # broker: in-flight moves
    replayed: int                          # records folded in
    from_snapshot: bool                    # started from a checkpoint
    rolled_forward: list[str]              # dangling migrations completed
    rolled_back: list[str]                 # dangling intents dropped
    #: elastic-fleet history, journal order: {"phase": "add", "host",
    #: "gn_total", "speed"} joins and {"phase": "retire", "host"}
    #: tombstones — recover_broker re-applies them to rebuild fleet shape
    fleet_ops: list[dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class RecoveryAlert:
    """Structured alert: a journaled guarantee failed re-certification."""

    kind: str                              # "recertification_mismatch"
    host: int
    task: str
    journaled: float                       # R̂ the journal promised
    recomputed: float                      # R̂ the analysis produces now
    action: str = "quarantined"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RecoveryReport:
    """Outcome of :func:`recover`: the (possibly quarantine-pruned) state,
    the per-task re-certification classification, and any alerts."""

    state: LedgerState
    recert: dict[int, dict[str, str]]      # host -> task -> classification
    alerts: list[RecoveryAlert]
    recovery_ms: float = 0.0

    @property
    def quarantined(self) -> list[tuple[int, str]]:
        return [(a.host, a.task) for a in self.alerts]


# ---- replay ------------------------------------------------------------------

def _decode_snapshot(state: dict) -> tuple[dict, dict, dict, list]:
    if state.get("format") != FORMAT:
        raise ValueError(
            f"snapshot format {state.get('format')!r} != {FORMAT}"
        )
    hosts = {
        int(h): HostState(
            entries={e["task"]["name"]: entry_from_dict(e)
                     for e in doc["entries"]},
            bounds={k: float(v) for k, v in doc["bounds"].items()},
            epoch=int(doc["epoch"]),
        )
        for h, doc in state["hosts"].items()
    }
    active = {n: int(h) for n, h in state.get("active", {}).items()}
    migrations = {
        n: Migration(**m) for n, m in state.get("migrations", {}).items()
    }
    fleet_ops = [dict(op) for op in state.get("fleet_ops", [])]
    return hosts, active, migrations, fleet_ops


def replay(journal: Journal, up_to: Optional[int] = None) -> LedgerState:
    """Fold the journal (snapshot + record suffix) back into ledger state.

    ``up_to`` truncates the record suffix — the crash model: everything
    after record ``up_to`` was lost.  Deterministic and side-effect free
    (the journal is only read), so replaying twice is idempotent by
    construction — the property ``tests/test_recovery.py`` asserts."""
    meta = journal.meta()

    def transition_of(h: int) -> str:
        cfg = meta.get(f"host{h}")
        return cfg["transition"] if cfg else "boundary"

    hosts: dict[int, HostState] = {}
    active: dict[str, int] = {}
    migrations: dict[str, Migration] = {}
    fleet_ops: list[dict] = []
    from_snapshot = False
    snap = journal.snapshot()
    if snap is not None:
        seq0, state = snap
        if up_to is not None and up_to < seq0:
            raise ValueError(
                f"cannot replay up_to={up_to}: records <= {seq0} were "
                f"compacted into the snapshot"
            )
        hosts, active, migrations, fleet_ops = _decode_snapshot(state)
        from_snapshot = True

    def host_state(h: int) -> HostState:
        st = hosts.get(h)
        if st is None:
            st = hosts[h] = HostState()
        return st

    # pending two-phase migration intents (the only multi-record txn)
    intents: dict[str, dict] = {}
    records = journal.records(up_to=up_to)
    for rec in records:
        h = rec.host if rec.host is not None else 0
        name = rec.task
        p = rec.payload
        if rec.op == "admit":
            st = host_state(h)
            # the payload's allocation map is the post-op resident state
            # (a realloc admit re-sizes residents too)
            for n, g in p["alloc"].items():
                e = st.entries[n]
                e.alloc = int(g)
                if p.get("path") == "realloc":
                    e.staged_alloc = None
            st.entries[name] = Entry(task=task_from_dict(p["spec"]),
                                     alloc=int(p["gn"]))
            st.bounds = {k: float(v) for k, v in p["bounds"].items()}
            st.epoch = int(p["epoch"])
            it = intents.get(name)
            if it is not None and it["dst"] == h:
                # the target side of an in-flight migration: the task's
                # jobs still run on the source, so `active` is untouched
                it["dst_admitted"] = True
            else:
                active[name] = h
        elif rec.op == "release":
            st = host_state(h)
            st.entries.pop(name, None)
            st.bounds.pop(name, None)
            st.epoch = int(p["epoch"])
            it = intents.get(name)
            if it is not None and it["src"] == h:
                it["src_released"] = True
            elif active.get(name) == h:
                del active[name]
        elif rec.op == "depart":
            st = host_state(h)
            e = st.entries.get(name)
            if e is not None:
                e.departing = True
            it = intents.get(name)
            if it is not None and it["src"] == h:
                it["src_released"] = True
        elif rec.op == "boundary":
            st = host_state(h)
            if p["result"] == "reclaimed":
                st.entries.pop(name, None)
                st.bounds.pop(name, None)
                st.epoch = int(p["epoch"])
                mig = migrations.pop(name, None)
                if active.get(name) == h:
                    if mig is not None:
                        active[name] = mig.dst   # the move completed
                    else:
                        del active[name]         # a true fleet departure
            else:  # committed
                e = st.entries.get(name)
                if e is not None:
                    e.commit()
        elif rec.op == "update":
            st = host_state(h)
            e = st.entries[name]
            new_task = dataclasses.replace(
                e.target_task, period=p["period"], deadline=p["deadline"]
            )
            if p["staged"]:
                e.staged_task = new_task
            else:
                e.task = new_task
                e.staged_task = None
            st.bounds = {k: float(v) for k, v in p["bounds"].items()}
            st.epoch = int(p["epoch"])
        elif rec.op == "migrate":
            if rec.phase == "intent":
                intents[name] = {
                    "src": int(p["src"]), "dst": int(p["dst"]), "t": rec.t,
                    "dst_admitted": False, "src_released": False,
                }
            elif rec.phase == "abort":
                intents.pop(name, None)
                migrations.pop(name, None)
            else:  # commit
                intents.pop(name, None)
                if p.get("completed"):
                    # instant-transition source: reclaimed at once
                    active[name] = int(p["dst"])
                else:
                    migrations[name] = Migration(
                        name=name, src=int(p["src"]), dst=int(p["dst"]),
                        started=rec.t,
                    )
        elif rec.op == "host":
            # elastic fleet shape: atomic single-record ops (a drain's
            # individual moves are ordinary migrate transactions; the
            # retire record lands only once the host is empty)
            if rec.phase == "add":
                fleet_ops.append({
                    "phase": "add", "host": h,
                    "gn_total": int(p["gn_total"]),
                    "speed": float(p["speed"]),
                })
                host_state(h)   # the joined host exists from here on
            elif rec.phase == "retire":
                fleet_ops.append({"phase": "retire", "host": h})
            else:
                raise ValueError(
                    f"unknown host phase {rec.phase!r} (seq {rec.seq})"
                )
        else:
            raise ValueError(f"unknown journal op {rec.op!r} (seq {rec.seq})")

    # Dangling intents: the crash landed inside the two-phase migration.
    # Forward iff the target's admit record committed, back otherwise.
    rolled_forward: list[str] = []
    rolled_back: list[str] = []
    for name in sorted(intents):
        it = intents[name]
        if not it["dst_admitted"]:
            rolled_back.append(name)
            metrics.inc("recovery_migrations_resolved_total", action="back")
            continue
        src = it["src"]
        st = host_state(src)
        e = st.entries.get(name)
        if e is not None and not it["src_released"]:
            # apply the source release the broker never got to issue
            if transition_of(src) == "instant":
                st.entries.pop(name, None)
                st.bounds.pop(name, None)
                st.epoch += 1
            else:
                e.departing = True
        if name in st.entries:
            migrations[name] = Migration(name=name, src=src, dst=it["dst"],
                                         started=it["t"])
        else:
            active[name] = it["dst"]
        rolled_forward.append(name)
        metrics.inc("recovery_migrations_resolved_total", action="forward")

    metrics.inc("recovery_replayed_records_total", amount=float(len(records)))
    return LedgerState(
        hosts=hosts, active=active, migrations=migrations,
        replayed=len(records), from_snapshot=from_snapshot,
        rolled_forward=rolled_forward, rolled_back=rolled_back,
        fleet_ops=fleet_ops,
    )


# ---- re-certification --------------------------------------------------------

def recover(
    journal: Journal,
    up_to: Optional[int] = None,
    recertify: bool = True,
) -> RecoveryReport:
    """Replay the journal and re-certify every host's resident set.

    The journaled bounds are kept verbatim on the recovered state (they
    are what the pre-crash controller held, bit for bit); the fresh
    analysis polices their *soundness*.  A resident whose recomputed R̂
    exceeds its journaled one (or is infinite) is quarantined: removed
    from the recovered set, reported as a :class:`RecoveryAlert`."""
    t0 = time.perf_counter()
    state = replay(journal, up_to=up_to)
    meta = journal.meta()
    recert: dict[int, dict[str, str]] = {}
    alerts: list[RecoveryAlert] = []
    if recertify:
        for h in sorted(state.hosts):
            st = state.hosts[h]
            cfg = meta.get(f"host{h}")
            if cfg is None or not st.entries:
                continue
            certifier = make_certifier(
                "batch",
                tightened=cfg["tightened"],
                preemption=cfg["preemption"],
                gpu_ctx=cfg["gpu_ctx_overhead"],
            )
            # a copy of every entry: certification must not perturb the
            # recovered ledger (entries are mutable dataclasses)
            entries = [e.copy() for e in st.entries.values()]
            fresh, _, _ = certifier.certify(
                entries, AnalysisTables(), {}, partial=True
            )
            per: dict[str, str] = {}
            for name in list(st.entries):
                jr = st.bounds.get(name, math.inf)
                rc = (fresh or {}).get(name, math.inf)
                if rc == jr:
                    per[name] = "exact"
                elif rc < jr and math.isfinite(jr):
                    per[name] = "conservative"
                else:
                    per[name] = "quarantined"
                    alerts.append(RecoveryAlert(
                        "recertification_mismatch", h, name,
                        journaled=jr, recomputed=rc,
                    ))
                    st.entries.pop(name)
                    st.bounds.pop(name, None)
                    state.active.pop(name, None)
                    state.migrations.pop(name, None)
                    metrics.inc("recovery_quarantined_total")
            recert[h] = per
    ms = (time.perf_counter() - t0) * 1e3
    metrics.observe("recovery_ms", ms, buckets=_RECOVERY_BUCKETS_MS)
    return RecoveryReport(state=state, recert=recert, alerts=alerts,
                          recovery_ms=ms)


# ---- reconstruction ----------------------------------------------------------

def recover_controller(
    journal: Journal,
    trace=None,
    engine: str = "batch",
    allow_realloc: bool = True,
    max_candidates: int = 2000,
    recertify: bool = True,
) -> tuple[DynamicController, RecoveryReport]:
    """Rebuild a live single-host controller from its journal.

    Semantic configuration (pool size, transition protocol, arbitration
    model) comes from the journal's ``meta`` scope; ``engine`` /
    ``allow_realloc`` / ``max_candidates`` are performance knobs the meta
    deliberately excludes (they never change what a bound means) and may
    be chosen fresh.  The journal stays attached: the recovered
    controller journals its next decision at the next sequence number."""
    cfg = journal.meta().get("host0")
    if cfg is None:
        raise ValueError(
            f"journal {journal.path!r} has no host0 configuration to "
            f"recover from"
        )
    report = recover(journal, recertify=recertify)
    ctl = DynamicController(
        cfg["gn_total"],
        tightened=cfg["tightened"],
        transition=cfg["transition"],
        allow_realloc=allow_realloc,
        max_candidates=max_candidates,
        trace=trace,
        engine=engine,
        preemption=cfg["preemption"],
        gpu_ctx_overhead=cfg["gpu_ctx_overhead"],
        journal=journal,
    )
    st = report.state.hosts.get(0)
    if st is not None and st.entries:
        ctl.restore(st.entries.values(), st.bounds, st.epoch)
    return ctl, report


def recover_broker(
    journal: Journal,
    trace=None,
    engine: str = "batch",
    placement=None,
    allow_realloc: bool = True,
    max_candidates: int = 2000,
    recertify: bool = True,
) -> tuple[CapacityBroker, RecoveryReport]:
    """Rebuild a live fleet broker (hosts + bookkeeping) from its journal.

    A journal written under a *callable* placement policy records
    ``"custom"``; recovery then needs the callable re-supplied via
    ``placement=``."""
    meta = journal.meta()
    bcfg = meta.get("broker")
    if bcfg is None:
        raise ValueError(
            f"journal {journal.path!r} has no broker configuration; use "
            f"recover_controller() for single-host journals"
        )
    hcfg = meta.get("host0")
    pl = bcfg["placement"]
    if pl == "custom":
        if placement is None:
            raise ValueError(
                "journal was written under a custom placement policy; "
                "re-supply it via placement="
            )
        pl = placement
    report = recover(journal, recertify=recertify)
    broker = CapacityBroker.build(
        bcfg["n_hosts"],
        hcfg["gn_total"],
        trace=trace,
        transition=hcfg["transition"],
        engine=engine,
        tightened=hcfg["tightened"],
        allow_realloc=allow_realloc,
        max_candidates=max_candidates,
        preemption=hcfg["preemption"],
        gpu_ctx_overhead=hcfg["gpu_ctx_overhead"],
        journal=journal,
        placement=pl,
        migrate_on_departure=bcfg["migrate_on_departure"],
        imbalance_threshold=bcfg["imbalance_threshold"],
        max_migrations_per_event=bcfg["max_migrations_per_event"],
        realloc_hosts=bcfg["realloc_hosts"],
        host_speeds=bcfg["host_speeds"],
    )
    # elastic history first: hosts joined after construction must exist
    # before their ledgers are restored (ids are sequential by protocol)
    for op in report.state.fleet_ops:
        if op["phase"] != "add":
            continue
        if op["host"] != broker.n_hosts:
            raise ValueError(
                f"journaled host add out of order: host {op['host']} "
                f"joined a {broker.n_hosts}-host fleet"
            )
        broker.add_host(gn_total=op["gn_total"], speed=op["speed"],
                        _record=False)
    for h, st in sorted(report.state.hosts.items()):
        # restore even entry-less hosts: their epoch counter must survive
        broker.hosts[h].restore(st.entries.values(), st.bounds, st.epoch)
    broker.restore(
        report.state.active, report.state.migrations,
        retired=[op["host"] for op in report.state.fleet_ops
                 if op["phase"] == "retire"],
    )
    return broker, report


# ---- checkpoint serialization ------------------------------------------------

def _host_doc(ctl: DynamicController) -> dict:
    return {
        "entries": [entry_to_dict(e) for e in ctl.pool.entries()],
        "bounds": ctl.bounds(),
        "epoch": ctl.epoch,
    }


def serialize_state(
    obj: Union[DynamicController, CapacityBroker],
) -> dict:
    """The snapshot document :meth:`Journal.checkpoint` stores — the full
    recoverable state of a controller or broker, JSON-native (floats
    round-trip bit-exactly)."""
    if isinstance(obj, CapacityBroker):
        # fleet shape beyond the construction-time n_hosts (journal meta)
        # plus retired tombstones, re-applied by recover_broker in order
        fleet_ops = [
            {"phase": "add", "host": h, "gn_total": obj.hosts[h].gn_total,
             "speed": obj.speeds[h]}
            for h in range(obj._n_hosts0, len(obj.hosts))
        ] + [{"phase": "retire", "host": h} for h in sorted(obj.retired)]
        doc = {
            "format": FORMAT,
            "hosts": {str(h): _host_doc(ctl)
                      for h, ctl in enumerate(obj.hosts)},
            "active": {n: h for n, h in sorted(obj._active.items())},
            "migrations": {n: dataclasses.asdict(m)
                           for n, m in sorted(obj.migrating.items())},
        }
        if fleet_ops:
            # only elastic fleets grow the snapshot schema — static-fleet
            # snapshots stay byte-identical to the previous format
            doc["fleet_ops"] = fleet_ops
        return doc
    return {
        "format": FORMAT,
        "hosts": {"0": _host_doc(obj)},
        "active": {},
        "migrations": {},
    }
