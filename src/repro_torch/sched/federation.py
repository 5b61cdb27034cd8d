"""Multi-host federated admission: a capacity broker over per-host
controllers.

The paper's federated scheduling (Sec. 6) partitions ONE accelerator's
virtual SMs among tasks; :class:`~repro_torch.sched.DynamicController` does that
online for a single host.  A serving fleet has N hosts, each with its own
slice pool, CPU, and copy bus — so federation composes per host:
:class:`CapacityBroker` routes every global operation (admit / release /
rate change / job boundary) to per-host controllers, adding exactly three
fleet-level concerns:

**Placement.**  An arrival is offered to hosts in a pluggable order —
``"first_fit"`` (host index order), ``"best_fit"`` (tightest feasible
pool first, classic bin-packing), ``"least_loaded"`` (most free slices
first, the load-balancing default), or any callable
``(broker, task) -> host-index order``.  Each host runs its normal
transitional-envelope admission; the first host that certifies the task
wins.  A host's rejection is not the fleet's: the broker falls through to
the next host in the order, so fleet admission only fails once *every*
host has rejected.  Admission is two-pass — the cheap pinned sweep across
all hosts first, the expensive re-allocation search only afterwards and
only on the ``realloc_hosts`` most-promising hosts — so fleet-scale admit
latency stays in the batched-certification regime
(``benchmarks/federation_acceptance.py`` asserts it beats the single-host
cold scalar path).

**Departure-imbalance migration.**  When a departure reclaims capacity
and leaves the fleet imbalanced (max load fraction − min load fraction >
``imbalance_threshold``), the broker moves a task from the most- to the
least-loaded host.  The move is certified end to end before anything
changes, and executes entirely inside the mode-change protocol:

  1. the task is **admitted on the target host** through the normal
     transitional-envelope certification (if no allocation certifies, the
     migration simply doesn't happen);
  2. only then is it **released on the source host** — release-at-boundary:
     its slices (and its transitional-analysis membership) stay on the
     source until its in-flight job completes;
  3. at that source job boundary the broker flips the task's *active*
     host to the target (``job_boundary`` returns ``"migrated"``), and the
     runtime releases all subsequent jobs there.

  Between (2) and (3) the task is certified resident on BOTH hosts, so
  whichever side a job runs on, its deadline is covered — no deadline can
  be missed mid-migration (the hypothesis property in
  ``tests/test_properties.py`` validates this over whole churn traces).

**Fleet bookkeeping.**  Task names are fleet-unique; the broker tracks
each task's *active* host (where its jobs run) and any in-flight
migration.  ``repro_torch.runtime.simulate_fleet`` drives one broker under the
multi-host discrete-event simulator; ``benchmarks/federation_acceptance.py``
tracks admit latency versus host count.

**Vectorized placement.**  The built-in policies are scored in one
batched NumPy sweep over per-host free-slice / speed arrays the broker
maintains *incrementally* (capacity-change listeners on every host
controller fire on admit / reclaim / boundary commit — never a
recomputation over residents), decision-identical to the scalar
``PLACEMENT_POLICIES`` reference functions, which remain the oracle the
equivalence tests (``tests/test_scale.py``) compare against.  Callable
and custom registered policies keep the scalar path.

**Elastic fleets.**  :meth:`CapacityBroker.add_host` joins a host at
runtime (journaled, immediately placeable); :meth:`CapacityBroker.retire_host`
is certified migrate-then-retire — every resident is admitted on a new
host through the normal two-phase migration protocol (target certified
*before* source release, journaled intent/commit/abort) before the host
leaves, so scale-in can never drop a deadline.  Host indices are stable
tombstones: a retired host stays in ``hosts`` (excluded from placement,
migration targets, and capacity totals) so journal host ids, active-host
bookkeeping, and simulator lanes never re-index.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.core import RTTask, TaskSet
from repro_torch.obs import metrics

from .controller import DynamicController, SchedDecision
from .trace import EventTrace

__all__ = ["BrokerDecision", "CapacityBroker", "Migration",
           "PLACEMENT_POLICIES", "register_placement"]


@dataclasses.dataclass(frozen=True)
class BrokerDecision:
    """Outcome of one fleet-level admission."""

    admitted: bool
    host: Optional[int]                    # admitting host index
    decision: Optional[SchedDecision]      # that host's decision (or last)
    tried_hosts: tuple[int, ...]           # hosts offered, in order
    reason: str = ""

    @property
    def bounds(self) -> Optional[dict[str, float]]:
        return self.decision.bounds if self.decision else None


@dataclasses.dataclass(frozen=True)
class Migration:
    """One broker-driven move of ``name`` from host ``src`` to ``dst``.

    ``started`` is the initiation time (target admitted, source released);
    the move completes at the source job boundary."""

    name: str
    src: int
    dst: int
    started: float


def _first_fit(broker: "CapacityBroker", task: RTTask) -> list[int]:
    return list(range(len(broker.hosts)))


def _best_fit(broker: "CapacityBroker", task: RTTask) -> list[int]:
    # tightest pool first: minimize leftover free capacity (ties → index)
    return sorted(range(len(broker.hosts)),
                  key=lambda h: (broker.hosts[h].free_capacity, h))


def _least_loaded(broker: "CapacityBroker", task: RTTask) -> list[int]:
    # most free slices first: spread load (ties → index)
    return sorted(range(len(broker.hosts)),
                  key=lambda h: (-broker.hosts[h].free_capacity, h))


def _weighted(broker: "CapacityBroker", task: RTTask) -> list[int]:
    # heterogeneous fleets: most *effective* free capacity first — free
    # slices weighted by the host's speed class (ties → index), so a fast
    # half-empty host beats a slow emptier one
    return sorted(
        range(len(broker.hosts)),
        key=lambda h: (-broker.hosts[h].free_capacity * broker.speeds[h], h),
    )


PLACEMENT_POLICIES: dict[str, Callable] = {
    "first_fit": _first_fit,
    "best_fit": _best_fit,
    "least_loaded": _least_loaded,
    "weighted": _weighted,
}

#: snapshot of the shipped policy names — register_placement() protects
#: these without a hand-maintained duplicate list
_BUILTIN_PLACEMENTS = frozenset(PLACEMENT_POLICIES)


def register_placement(name: str, fn: Callable) -> None:
    """Register a named placement policy ``(broker, task) -> host order``.

    Registered names become valid ``placement=`` arguments everywhere a
    built-in name is (brokers, ``simulate_fleet``, scenario presets).
    Re-registering a built-in name is rejected; re-registering a custom
    name replaces it."""
    if not callable(fn):
        raise TypeError(f"placement policy {name!r} must be callable")
    if name in _BUILTIN_PLACEMENTS:
        raise ValueError(f"cannot override built-in placement {name!r}")
    PLACEMENT_POLICIES[name] = fn


class CapacityBroker:
    """Global admission + migration over per-host ``DynamicController``\\ s.

    The broker mirrors the controller surface the runtime layers consume
    (``admit`` / ``release`` / ``update_rate`` / ``job_boundary`` /
    ``bound`` / ``task`` / ``is_departing``), so
    :class:`repro_torch.runtime.AdmissionController` and
    :class:`repro_torch.serving.ServingEngine` accept a broker wherever they
    accepted a single controller.
    """

    def __init__(
        self,
        hosts: Sequence[DynamicController],
        placement: Union[str, Callable] = "least_loaded",
        migrate_on_departure: bool = True,
        imbalance_threshold: float = 0.25,
        max_migrations_per_event: int = 1,
        realloc_hosts: int = 1,
        trace: Optional[EventTrace] = None,
        host_speeds: Optional[Sequence[float]] = None,
        journal=None,
    ):
        if not hosts:
            raise ValueError("broker needs at least one host")
        if not callable(placement) and placement not in PLACEMENT_POLICIES:
            raise ValueError(
                f"unknown placement policy {placement!r} "
                f"(known: {sorted(PLACEMENT_POLICIES)})"
            )
        self.hosts: tuple[DynamicController, ...] = tuple(hosts)
        # fleet size at construction: the journal meta pins THIS number —
        # hosts joined later are replayed from their op="host" records
        self._n_hosts0 = len(self.hosts)
        # heterogeneous fleets: relative speed class per host (1.0 =
        # reference).  Effective capacity is gn_total * speed — the
        # "weighted" placement and the departure-imbalance heuristic
        # normalize by it, so identical-speed fleets behave exactly as
        # before.
        if host_speeds is None:
            self.speeds: tuple[float, ...] = (1.0,) * len(self.hosts)
        else:
            if len(host_speeds) != len(self.hosts):
                raise ValueError(
                    f"host_speeds has {len(host_speeds)} entries for "
                    f"{len(self.hosts)} hosts"
                )
            if any(s <= 0.0 for s in host_speeds):
                raise ValueError("host speeds must be positive")
            self.speeds = tuple(float(s) for s in host_speeds)
        self.placement = placement
        self.migrate_on_departure = migrate_on_departure
        self.imbalance_threshold = imbalance_threshold
        self.max_migrations_per_event = max_migrations_per_event
        # second-pass budget: how many hosts may run the expensive full
        # re-allocation search after every pinned placement failed
        self.realloc_hosts = realloc_hosts
        self.trace = trace
        # Write-ahead journal (repro_torch.sched.journal.Journal).  The broker
        # journals only its two-phase migration protocol (intent / commit /
        # abort); per-host admits, releases and boundaries are journaled by
        # the host controllers through their host-scoped views — recovery
        # re-derives active hosts and in-flight moves from that total order.
        self.journal = journal
        if journal is not None:
            journal.ensure_meta("broker", self.journal_config())
        self._active: dict[str, int] = {}          # name -> active host
        self._migrations: dict[str, Migration] = {}  # in-flight moves
        self.migration_log: list[Migration] = []     # completed moves
        # Elastic-fleet tombstones: indices are stable for the life of the
        # broker (journal host ids, simulator lanes, _active values), so a
        # host never leaves `hosts` — it drains, then moves to _retired.
        self._draining: set[int] = set()
        self._retired: set[int] = set()
        # Incrementally-maintained per-host arrays for vectorized placement
        # scoring: one capacity-change listener per host keeps _free exact
        # under ANY mutation path (broker ops or direct controller calls).
        self._free = np.array([c.free_capacity for c in self.hosts],
                              dtype=np.int64)
        self._gn = np.array([c.gn_total for c in self.hosts], dtype=np.int64)
        self._speed_arr = np.array(self.speeds, dtype=np.float64)
        self._preemptive_any = any(c.preemption.enabled for c in self.hosts)
        for h, ctl in enumerate(self.hosts):
            ctl.add_capacity_listener(self._refresher(h))
        # recent fleet-admit timestamps for the admissions/sec gauge
        # (obs-gated: never populated while metrics are disabled)
        self._admit_times: collections.deque = collections.deque(maxlen=64)

    def _refresher(self, h: int) -> Callable[[], None]:
        def refresh() -> None:
            self._free[h] = self.hosts[h].free_capacity
        return refresh

    @classmethod
    def build(
        cls,
        n_hosts: int,
        gn_per_host: int,
        *,
        trace: Optional[EventTrace] = None,
        transition: str = "boundary",
        engine: str = "batch",
        tightened: bool = True,
        allow_realloc: bool = True,
        max_candidates: int = 2000,
        preemption: str = "none",
        gpu_ctx_overhead: float = 0.0,
        journal=None,
        **broker_kw,
    ) -> "CapacityBroker":
        """Fleet of ``n_hosts`` identical hosts; controller events are
        recorded host-tagged into ``trace`` (one Chrome lane group per
        host).  ``preemption``/``gpu_ctx_overhead`` select each host's GPU
        arbitration model (every host runs the same one); per-host
        ``host_speeds`` pass through to the broker.  A ``journal`` is
        shared: each host writes through its host-scoped view and the
        broker journals the migration protocol."""
        hosts = [
            DynamicController(
                gn_per_host,
                tightened=tightened,
                transition=transition,
                allow_realloc=allow_realloc,
                max_candidates=max_candidates,
                trace=trace.for_host(h) if trace is not None else None,
                engine=engine,
                preemption=preemption,
                gpu_ctx_overhead=gpu_ctx_overhead,
                journal=journal.for_host(h) if journal is not None else None,
            )
            for h in range(n_hosts)
        ]
        return cls(hosts, trace=trace, journal=journal, **broker_kw)

    # ---- durability ---------------------------------------------------------

    def journal_config(self) -> dict:
        """Broker-level semantic configuration for the journal ``meta``
        table (the per-host configs live under their own scopes).  A
        callable placement journals as ``"custom"`` — recovery then needs
        the callable re-supplied.  ``n_hosts`` is the fleet size at broker
        construction: hosts joined later via :meth:`add_host` are part of
        the journaled *history* (op="host" records), not the config."""
        return {
            "n_hosts": self._n_hosts0,
            "placement": (self.placement if isinstance(self.placement, str)
                          else "custom"),
            "migrate_on_departure": self.migrate_on_departure,
            "imbalance_threshold": self.imbalance_threshold,
            "max_migrations_per_event": self.max_migrations_per_event,
            "realloc_hosts": self.realloc_hosts,
            "host_speeds": list(self.speeds),
        }

    def restore(self, active: dict, migrations: dict,
                retired: Sequence[int] = ()) -> None:
        """Install recovered fleet bookkeeping (active hosts, in-flight
        migrations, retired tombstones); the per-host ledgers are restored
        on the host controllers by :mod:`repro_torch.sched.recovery`."""
        if self._active or self._migrations:
            raise RuntimeError("restore() requires a fresh broker")
        self._active = {n: int(h) for n, h in active.items()}
        self._migrations = {
            n: m if isinstance(m, Migration) else Migration(**m)
            for n, m in migrations.items()
        }
        self._retired.update(int(h) for h in retired)

    # ---- fleet introspection ------------------------------------------------

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    @property
    def draining(self) -> frozenset[int]:
        """Hosts mid scale-in: residents moving out, no new placements."""
        return frozenset(self._draining)

    @property
    def retired(self) -> frozenset[int]:
        """Fully drained tombstones (index kept, capacity withdrawn)."""
        return frozenset(self._retired)

    @property
    def active_host_indices(self) -> list[int]:
        """Hosts eligible for placement, in index order."""
        inactive = self._draining | self._retired
        return [h for h in range(len(self.hosts)) if h not in inactive]

    @property
    def allocation(self) -> dict[str, int]:
        """Committed GN per task, fleet-wide (names are fleet-unique)."""
        out: dict[str, int] = {}
        for ctl in self.hosts:
            out.update(ctl.allocation)
        return out

    @property
    def capacity_in_use(self) -> int:
        return int((self._gn - self._free).sum())

    @property
    def free_capacity(self) -> int:
        """Placeable free slices: draining and retired hosts take no
        arrivals, so their free slices are not fleet capacity."""
        inactive = self._draining | self._retired
        if not inactive:
            return int(self._free.sum())
        mask = np.ones(len(self.hosts), dtype=bool)
        mask[list(inactive)] = False
        return int(self._free[mask].sum())

    @property
    def max_arrival_capacity(self) -> int:
        """Largest GN an arrival's allocation could range over on any
        single placeable host — the capacity digest
        :class:`~repro_torch.sched.fleet.BrokerTree` prunes shard descents
        with.  Free slices under federated dedication; the whole pool
        under preemptive arbitration (time-shared slices are not bounded
        by residents' holdings)."""
        arr = self._gn if self._preemptive_any else self._free
        inactive = self._draining | self._retired
        if inactive:
            mask = np.ones(len(self.hosts), dtype=bool)
            mask[list(inactive)] = False
            arr = arr[mask]
        return int(arr.max()) if arr.size else 0

    @property
    def migrating(self) -> dict[str, Migration]:
        return dict(self._migrations)

    def load(self, h: int) -> float:
        """Envelope load fraction of host ``h``, normalized by *effective*
        capacity (``gn_total × speed``): the same slice holdings press a
        fast host less.  Identical to the raw fraction when all speeds are
        1.0 (the homogeneous default)."""
        ctl = self.hosts[h]
        return ctl.capacity_in_use / (ctl.gn_total * self.speeds[h])

    def active_host(self, name: str) -> Optional[int]:
        """Host whose slices ``name``'s jobs currently run on."""
        return self._active.get(name)

    def host_of(self, name: str) -> Optional[int]:
        return self._active.get(name)

    def bounds(self) -> dict[str, float]:
        """Certified R̂ per task on its *active* host."""
        return {
            name: self.hosts[h].bound(name)
            for name, h in self._active.items()
        }

    def bound(self, name: str) -> float:
        h = self._active.get(name)
        return self.hosts[h].bound(name) if h is not None else math.inf

    def task(self, name: str) -> Optional[RTTask]:
        h = self._active.get(name)
        return self.hosts[h].task(name) if h is not None else None

    def is_departing(self, name: str) -> bool:
        """True when ``name`` is departing the *fleet* (a migration's
        source-side departure is not a fleet departure)."""
        h = self._active.get(name)
        if h is None:
            return False
        return self.hosts[h].is_departing(name) and name not in self._migrations

    def current_taskset(self) -> Optional[TaskSet]:
        tasks = [t for ctl in self.hosts
                 for t in (ctl.current_taskset() or ())]
        if not tasks:
            return None
        return TaskSet.deadline_monotonic(tasks)

    # ---- operations ---------------------------------------------------------

    #: built-in policies with a vectorized scoring path; the scalar
    #: ``PLACEMENT_POLICIES`` functions stay the reference oracle
    #: (decision identity asserted in ``tests/test_scale.py``)
    _VECTOR_POLICIES = frozenset(
        ("first_fit", "best_fit", "least_loaded", "weighted"))

    def _vector_order(self, policy: str) -> list[int]:
        """One batched sweep over the incrementally-maintained per-host
        arrays.  ``np.argsort(kind="stable")`` breaks score ties by host
        index — exactly the ``(key, h)`` tiebreak of the scalar policies —
        and the scores are the same IEEE float ops elementwise, so the
        resulting order is bit-identical to the scalar reference."""
        free = self._free
        if policy == "first_fit":
            idx = np.arange(len(self.hosts))
        elif policy == "best_fit":
            idx = np.argsort(free, kind="stable")
        elif policy == "least_loaded":
            idx = np.argsort(-free, kind="stable")
        else:   # weighted
            idx = np.argsort(-(free * self._speed_arr), kind="stable")
        inactive = self._draining | self._retired
        if inactive:
            mask = np.ones(len(self.hosts), dtype=bool)
            mask[list(inactive)] = False
            idx = idx[mask[idx]]
        return idx.tolist()

    def _placement_order(self, task: Optional[RTTask]) -> list[int]:
        if not callable(self.placement) \
                and self.placement in self._VECTOR_POLICIES:
            order = self._vector_order(self.placement)
        else:
            fn = self.placement if callable(self.placement) \
                else PLACEMENT_POLICIES[self.placement]
            order = [int(h) for h in fn(self, task)]
            inactive = self._draining | self._retired
            if inactive:
                order = [h for h in order if h not in inactive]
        metrics.observe("placement_hosts_scanned", len(order),
                        buckets=metrics.DEFAULT_RESPONSE_BUCKETS)
        return order

    def admit(
        self,
        task: RTTask,
        t: float = 0.0,
        allow_realloc: Optional[bool] = None,
        pinned: bool = True,
    ) -> BrokerDecision:
        """Offer ``task`` to hosts in placement order; first certifying
        host wins.  Rejected by all → the fleet rejects, every host's
        state untouched (per-host transactionality).

        Admission is **two-pass**: the first pass runs only each host's
        cheap pinned sweep (``allow_realloc=False``) in placement order;
        only if every host pinned-rejects does the second pass run the
        expensive full re-allocation search, bounded to the
        ``realloc_hosts`` most-promising hosts (most free capacity — for
        identical hosts, if re-balancing cannot fit the task there it
        cannot fit anywhere).  This keeps the common fleet admission at
        O(hosts × pinned) instead of O(hosts × grid search).

        As on the host controller, the keywords narrow the passes per
        call (defaults are byte-identical to the historical behavior):
        ``allow_realloc=False`` runs only the pinned sweep,
        ``pinned=False`` only the re-allocation pass.
        :class:`~repro_torch.sched.fleet.BrokerTree` uses them to preserve
        two-pass admission at every level of the shard hierarchy."""
        name = task.name
        if name and name in self._active:
            return BrokerDecision(
                False, None, None, (),
                reason=f"name {name!r} already resident in the fleet",
            )
        spans = self.trace is not None and getattr(self.trace, "spans", False)
        t0 = time.perf_counter() if spans else 0.0
        with metrics.timed("fleet_placement_ms"):
            order = self._placement_order(task)
        if spans:
            self.trace.span(
                t, "placement", (time.perf_counter() - t0) * 1e3,
                target=name, policy=(self.placement if
                                     isinstance(self.placement, str)
                                     else "custom"),
            )
        tried: list[int] = []
        last: Optional[SchedDecision] = None
        if pinned:
            for h in order:
                dec = self.hosts[h].admit(task, t=t, allow_realloc=False)
                tried.append(h)
                last = dec
                if dec.admitted:
                    self._active[name] = h
                    self._count_admit(True, tried)
                    return BrokerDecision(True, h, dec, tuple(tried))
        if allow_realloc is not False:
            realloc_order = [
                h for h in sorted(
                    order, key=lambda h: (-self.hosts[h].free_capacity, h)
                )
                if self.hosts[h].transition == "instant"
                and self.hosts[h].allow_realloc
            ][: self.realloc_hosts]
            for h in realloc_order:
                # pass 1's pinned rejection was transactional, so repeating
                # the sweep would fail identically: go straight to the
                # re-balance
                dec = self.hosts[h].admit(task, t=t, pinned=False)
                last = dec
                if dec.admitted:
                    self._active[name] = h
                    self._count_admit(True, tried)
                    return BrokerDecision(True, h, dec, tuple(tried))
        reason = (
            f"rejected by all {len(tried)} hosts"
            + (f" (last: {last.reason})" if last is not None else "")
        )
        self._count_admit(False, tried)
        return BrokerDecision(False, None, last, tuple(tried), reason=reason)

    def _count_admit(self, admitted: bool, tried: list) -> None:
        metrics.inc("fleet_admit_total",
                    result="admitted" if admitted else "rejected")
        metrics.observe("fleet_hosts_tried", len(tried),
                        buckets=metrics.DEFAULT_RESPONSE_BUCKETS)
        if metrics.enabled():
            metrics.set_gauge("fleet_residents", len(self._active))
            if admitted:
                now = time.perf_counter()
                self._admit_times.append(now)
                span = now - self._admit_times[0]
                if len(self._admit_times) >= 2 and span > 0:
                    metrics.set_gauge(
                        "fleet_admissions_per_sec",
                        (len(self._admit_times) - 1) / span,
                    )

    def release(self, name: str, t: float = 0.0) -> bool:
        """Depart ``name`` from the fleet (release-at-boundary on its
        active host).  A task mid-migration departs from both sides: the
        idle copy parked on the target is reclaimed immediately, the
        active source copy at its job boundary."""
        h = self._active.get(name)
        if h is None:
            return False
        mig = self._migrations.get(name)
        if mig is not None:
            if self.journal is not None:
                # abort the in-flight move BEFORE any side is touched: a
                # crash inside this fan-out must not be resolved as a
                # still-running migration
                self.journal.append("migrate", name, t=t, phase="abort",
                                    src=mig.src, dst=mig.dst,
                                    reason="released mid-migration")
            del self._migrations[name]
            dst = self.hosts[mig.dst]
            dst.release(name, t=t)
            dst.job_boundary(name, t=t)   # no jobs ever ran there: boundary now
            # the source side is ALREADY departing (release-at-boundary was
            # issued when the migration started), so with the migration
            # record gone its boundary now reclaims as a fleet departure
            self.hosts[h].release(name, t=t)
            return True
        ok = self.hosts[h].release(name, t=t)
        if ok and name not in self.hosts[h].pool:
            # instant-transition host: reclaimed at once — the departure
            # imbalance (if any) exists now
            del self._active[name]
            if metrics.enabled():
                metrics.set_gauge("fleet_residents", len(self._active))
            self._maybe_finalize_retire(h, t)
            if self.migrate_on_departure:
                self._rebalance(t)
        return ok

    def update_rate(
        self, name: str, period: float, deadline: float, t: float = 0.0
    ) -> SchedDecision:
        h = self._active.get(name)
        if h is None:
            return SchedDecision(False, None, None,
                                 reason=f"no resident task {name!r}")
        mig = self._migrations.get(name)
        if mig is not None:
            # mid-migration: the source copy is departing (it finishes at
            # most one more job at the old, still-certified rate), so the
            # rate change lands on the migration target — the task's home
            # for every job after the source boundary
            return self.hosts[mig.dst].update_rate(name, period, deadline,
                                                   t=t)
        return self.hosts[h].update_rate(name, period, deadline, t=t)

    def job_boundary(self, name: str, t: float = 0.0) -> str:
        """Runtime hook: ``name`` completed a job on its active host.

        Beyond the per-host outcomes (``"committed"`` / ``"none"``), the
        broker distinguishes ``"migrated"`` (the source side of an
        in-flight migration reclaimed: the task's active host flipped to
        the target) from ``"reclaimed"`` (a true fleet departure, which
        may trigger departure-imbalance migrations)."""
        h = self._active.get(name)
        if h is None:
            return "none"
        res = self.hosts[h].job_boundary(name, t=t)
        if res != "reclaimed":
            return res
        mig = self._migrations.pop(name, None)
        if mig is not None:
            self._active[name] = mig.dst
            self.migration_log.append(mig)
            self._maybe_finalize_retire(h, t)
            return "migrated"
        del self._active[name]
        if metrics.enabled():
            metrics.set_gauge("fleet_residents", len(self._active))
        self._maybe_finalize_retire(h, t)
        if self.migrate_on_departure:
            self._rebalance(t)
        return "reclaimed"

    # ---- departure-imbalance migration --------------------------------------

    def rebalance(self, t: float = 0.0) -> int:
        """Run the departure-imbalance migration pass now; returns the
        number of migrations started.  ``release``/``job_boundary`` call
        this automatically when ``migrate_on_departure`` — the public
        entry point exists for callers that own the trigger themselves
        (the scheduler daemon, and the crash-matrix tests that need
        migrations as standalone journal transactions)."""
        started = 0
        for _ in range(self.max_migrations_per_event):
            if not self._start_one_migration(t):
                break
            started += 1
        return started

    def _rebalance(self, t: float) -> None:
        self.rebalance(t)

    def _migration_candidates(self, src: int) -> list:
        """Movable entries on ``src``: not departing, not mid-transition,
        not already migrating — smallest slice holdings first (cheapest to
        re-place; ties broken by name for determinism)."""
        return sorted(
            (e for n, e in self.hosts[src].pool.items()
             if not e.departing and not e.in_transition
             and n not in self._migrations),
            key=lambda e: (e.gn_hi, e.task.name),
        )

    def _loads(self) -> np.ndarray:
        """Per-host envelope load fractions in one vectorized read —
        elementwise the same IEEE ops as :meth:`load`, so argmax/argmin
        picks (first max / first min) match the scalar loop exactly."""
        return (self._gn - self._free) / (self._gn * self._speed_arr)

    def _begin_migration(self, e, src: int, dst: int, t: float) -> bool:
        """Certified two-phase move of entry ``e`` from ``src`` to ``dst``.

        The target host admits through normal transitional-envelope
        certification BEFORE the source releases; with a journal attached
        the move is the durable intent/commit/abort transaction.  Returns
        False (state untouched beyond the journaled abort) when the
        target rejects."""
        name = e.task.name
        src_ctl, dst_ctl = self.hosts[src], self.hosts[dst]
        spans = (self.trace is not None
                 and getattr(self.trace, "spans", False))
        t0 = time.perf_counter() if spans else 0.0
        if self.journal is not None:
            # two-phase: the intent is durable before the target host
            # certifies.  Recovery resolves a crash inside the window
            # deterministically — forward iff the target's admit
            # record committed, back otherwise.
            self.journal.append("migrate", name, t=t, phase="intent",
                                src=src, dst=dst)
        dec = dst_ctl.admit(e.task, t=t)   # envelope-certified, or skip
        if spans:
            self.trace.span(
                t, "migrate", (time.perf_counter() - t0) * 1e3,
                target=name, src=src, dst=dst, hit=dec.admitted,
            )
        if not dec.admitted:
            if self.journal is not None:
                self.journal.append("migrate", name, t=t, phase="abort",
                                    src=src, dst=dst,
                                    reason="target rejected")
            return False
        src_ctl.release(name, t=t)         # release-at-boundary
        if self.journal is not None:
            self.journal.append("migrate", name, t=t, phase="commit",
                                src=src, dst=dst,
                                completed=name not in src_ctl.pool)
        metrics.inc("fleet_migrations_total")
        mig = Migration(name=name, src=src, dst=dst, started=t)
        if self.trace is not None:
            extra = {}
            if metrics.enabled() and dec.bounds:
                # obs-gated: certified R̂ on the target, so the report
                # CLI tracks bounds across moves from the trace alone
                extra = {"bound": round(dec.bounds.get(name,
                                                       math.inf), 6)}
            self.trace.record(t, "migrate", name, src=src, dst=dst,
                              gn=dec.alloc[name] if dec.alloc else None,
                              host=src, **extra)
        if name not in src_ctl.pool:
            # instant-transition source: reclaimed at once — the
            # migration completes immediately
            self._active[name] = dst
            self.migration_log.append(mig)
        else:
            self._migrations[name] = mig
        return True

    def _start_one_migration(self, t: float) -> bool:
        n = len(self.hosts)
        if n < 2:
            return False
        loads = self._loads()
        # a draining/retired host must not receive migrations; masking the
        # argmin (rather than filtering) keeps indices stable
        inactive = self._draining | self._retired
        dst_loads = loads
        if inactive:
            if n - len(inactive) < 1:
                return False
            dst_loads = loads.copy()
            dst_loads[list(inactive)] = np.inf
        src = int(np.argmax(loads))
        dst = int(np.argmin(dst_loads))
        if src == dst or loads[src] - loads[dst] <= self.imbalance_threshold:
            return False
        src_ctl, dst_ctl = self.hosts[src], self.hosts[dst]
        for e in self._migration_candidates(src):
            # a move that would just flip the imbalance is no move at all
            # (gains/costs in effective-capacity units, like load())
            gain = e.gn_hi / (src_ctl.gn_total * self.speeds[src])
            cost = e.gn_hi / (dst_ctl.gn_total * self.speeds[dst])
            if loads[src] - gain < loads[dst] + cost \
                    - self.imbalance_threshold:
                continue
            if self._begin_migration(e, src, dst, t):
                return True
        return False

    # ---- elastic fleets ------------------------------------------------------

    def add_host(
        self,
        controller: Optional[DynamicController] = None,
        *,
        gn_total: Optional[int] = None,
        speed: float = 1.0,
        t: float = 0.0,
        _record: bool = True,
    ) -> int:
        """Join a host to the fleet at runtime; returns its (stable) index.

        Without an explicit ``controller`` the new host mirrors host 0's
        semantic configuration (transition mode, engine, preemption model,
        realloc policy) at ``gn_total`` slices (default: same as host 0),
        wired into the broker's trace and journal exactly as
        :meth:`build` would have.  The host starts empty and is
        immediately eligible for placement and as a migration target —
        the discrete-event simulator picks up its resource lanes on the
        next step.  With a journal attached the join is recorded
        (op="host", phase="add") so recovery rebuilds the grown fleet."""
        if float(speed) <= 0.0:
            raise ValueError("host speeds must be positive")
        h = len(self.hosts)
        if controller is None:
            ref = self.hosts[0]
            controller = DynamicController(
                int(gn_total) if gn_total is not None else ref.gn_total,
                tightened=ref.tightened,
                transition=ref.transition,
                allow_realloc=ref.allow_realloc,
                max_candidates=ref.max_candidates,
                trace=(self.trace.for_host(h)
                       if self.trace is not None else None),
                engine=ref.engine,
                preemption=ref.preemption,
                gpu_ctx_overhead=ref.preemption.ctx,
                journal=(self.journal.for_host(h)
                         if self.journal is not None else None),
            )
        elif gn_total is not None:
            raise ValueError("pass gn_total or a controller, not both")
        self.hosts = self.hosts + (controller,)
        self.speeds = self.speeds + (float(speed),)
        self._free = np.append(self._free, controller.free_capacity)
        self._gn = np.append(self._gn, controller.gn_total)
        self._speed_arr = np.append(self._speed_arr, float(speed))
        self._preemptive_any |= controller.preemption.enabled
        controller.add_capacity_listener(self._refresher(h))
        if self.journal is not None and _record:
            self.journal.append("host", "", t=t, phase="add", host=h,
                                gn_total=controller.gn_total,
                                speed=float(speed))
        if self.trace is not None:
            self.trace.record(t, "host_add", f"host{h}", host=h,
                              gn=controller.gn_total)
        metrics.inc("fleet_hosts_added_total")
        return h

    def retire_host(self, h: int, t: float = 0.0) -> bool:
        """Scale-in: certified migrate-then-retire of host ``h``.

        Every movable resident is re-placed through the normal two-phase
        migration (:meth:`_begin_migration`: target certified before
        source release, journaled when a journal is attached), so no
        resident ever drops a deadline during scale-in.  Returns True
        when the drain is fully underway — the host is excluded from
        placement at once and retires (op="host", phase="retire"
        journaled) as soon as its last boundary reclaims; instant-
        transition hosts retire before this call returns.

        Returns False, leaving the host active, when the drain cannot
        complete: some resident found no certifying target, a resident is
        mid rate-change (its envelope cannot be re-certified elsewhere),
        a migration into ``h`` is in flight, or ``h`` is the last active
        host.  Moves already started stand — each was individually
        certified, so they are safe load-shedding either way."""
        if not 0 <= h < len(self.hosts):
            raise IndexError(f"no host {h}")
        if h in self._retired or h in self._draining:
            return False
        if len(self.active_host_indices) < 2:
            return False   # never drain the last active host
        if any(m.dst == h for m in self._migrations.values()):
            # an in-flight move is parking its target copy on h; retiring
            # under it would orphan that copy — retry after its boundary
            return False
        ctl = self.hosts[h]
        # exclusion first: placement orders computed below must not pick h
        self._draining.add(h)
        moved_all = True
        for e in list(self._migration_candidates(h)):
            placed = False
            for dst in self._placement_order(e.task):
                if self._begin_migration(e, h, dst, t):
                    placed = True
                    break
            if not placed:
                moved_all = False
                break
        # stagers mid rate-change are not migration candidates: their
        # transitional envelope spans two parameter sets and cannot be
        # re-admitted elsewhere — the drain must wait for their boundary
        if any(e.in_transition and not e.departing
               for e in ctl.pool.entries()):
            moved_all = False
        if not moved_all:
            self._draining.discard(h)
            return False
        if self.trace is not None:
            self.trace.record(t, "host_drain", f"host{h}", host=h,
                              residents=len(ctl.pool))
        self._maybe_finalize_retire(h, t)
        return True

    def _maybe_finalize_retire(self, h: int, t: float) -> None:
        """Complete a drain once the host's ledger is empty: the tombstone
        moves from draining to retired (durably, when journaled)."""
        if h not in self._draining or len(self.hosts[h].pool):
            return
        self._draining.discard(h)
        self._retired.add(h)
        if self.journal is not None:
            self.journal.append("host", "", t=t, phase="retire", host=h)
        if self.trace is not None:
            self.trace.record(t, "host_retire", f"host{h}", host=h)
        metrics.inc("fleet_hosts_retired_total")
