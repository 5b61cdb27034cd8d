"""Transactional slice-capacity ledger (the bottom layer of the stack).

One accelerator owns ``gn_total`` physical SM slices.  :class:`SlicePool`
is the *ledger* of who holds how many: each resident task is one
:class:`Entry` carrying its committed allocation plus any staged
mode-change state (a staged task re-rate, or — reserved for staged
boundary-mode re-allocation — a staged slice count).  The pool knows
nothing about schedulability: certifying that a ledger state meets every
deadline is :mod:`repro_torch.sched.certify`'s job, and sequencing *when* staged
state commits (the job-boundary protocol) is the controller's.

**Fork-and-adopt transactionality.**  Every mutating decision runs against
``pool.fork()`` — an independent copy of every entry — and only a
*successful* decision ``adopt()``\\ s the fork back.  A rejected operation
therefore leaves the ledger byte-identical (asserted via
:meth:`fingerprint` in ``tests/test_sched.py``).  Entry insertion order is
preserved across fork/adopt, which keeps deadline-monotonic priority
sorting (a stable sort over ``entries()``) deterministic.

**Envelope capacity.**  Until a transition commits, an entry holds
``max(committed, staged)`` slices (``gn_hi``) — the mode-change protocol's
safety invariant: capacity is never handed out while any job that was
certified against it may still be in flight.

**Incremental accounting.**  ``capacity_in_use`` is maintained as a
running counter updated by every mutation (reserve / reclaim /
set_alloc / commit), not recomputed from the entries — placement scoring
across a large fleet reads per-host free capacity on every arrival, so
an O(residents) sum here puts an O(total residents) term on the fleet
admit path.  Anything that changes an entry's ``gn_hi`` must therefore
go through the pool API (:meth:`SlicePool.set_alloc` /
:meth:`SlicePool.commit`) rather than mutating the entry in place.
``REPRO_DEBUG=1`` cross-checks the counter against the recomputed sum on
every read.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

from repro_torch.core import RTTask

__all__ = ["Entry", "SlicePool"]

#: opt-in invariant checking (read once at import): the incremental
#: capacity counter is asserted against the from-scratch sum on every read
_DEBUG = os.environ.get("REPRO_DEBUG", "") == "1"


@dataclasses.dataclass
class Entry:
    """One resident task: committed state plus staged mode-change state.

    ``staged_task`` is set by rate changes in boundary mode.
    ``staged_alloc`` is reserved for staged boundary-mode re-allocation
    (ROADMAP); nothing populates it yet, so ``gn_lo == gn_hi`` today."""

    task: RTTask                        # committed parameters (jobs in flight)
    alloc: int                          # committed GN (slices physically held)
    staged_task: Optional[RTTask] = None
    staged_alloc: Optional[int] = None
    departing: bool = False

    @property
    def target_task(self) -> RTTask:
        return self.staged_task if self.staged_task is not None else self.task

    @property
    def target_alloc(self) -> int:
        return self.staged_alloc if self.staged_alloc is not None else self.alloc

    @property
    def trans_task(self) -> RTTask:
        """Envelope task for transitional analysis: min(T), min(D).

        Sound for any mix of old- and new-parameter jobs: min T upper-bounds
        the task's interference on others, min D lower-bounds the deadline
        its own response is checked against.  (min D ≤ min T always holds
        when both configurations are individually constrained-deadline.)
        """
        if self.staged_task is None:
            return self.task
        return dataclasses.replace(
            self.task,
            period=min(self.task.period, self.staged_task.period),
            deadline=min(self.task.deadline, self.staged_task.deadline),
        )

    @property
    def gn_lo(self) -> int:
        return min(self.alloc, self.target_alloc)

    @property
    def gn_hi(self) -> int:
        return max(self.alloc, self.target_alloc)

    @property
    def in_transition(self) -> bool:
        return self.staged_task is not None or self.staged_alloc is not None

    def copy(self) -> "Entry":
        return dataclasses.replace(self)

    def commit(self) -> None:
        """Job-boundary commit: staged parameters become the committed ones."""
        self.task = self.target_task
        self.alloc = self.target_alloc
        self.staged_task = None
        self.staged_alloc = None


class SlicePool:
    """The ledger: name → :class:`Entry` over ``gn_total`` slices."""

    def __init__(self, gn_total: int):
        self.gn_total = gn_total
        self._entries: dict[str, Entry] = {}
        # running envelope-capacity counter (sum of gn_hi over entries);
        # every mutation keeps it in step so reads are O(1)
        self._in_use = 0

    # ---- views --------------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def get(self, name: str) -> Optional[Entry]:
        return self._entries.get(name)

    def entries(self) -> list[Entry]:
        """Entries in insertion order (the stable-sort tiebreak order)."""
        return list(self._entries.values())

    def items(self):
        return self._entries.items()

    @property
    def allocation(self) -> dict[str, int]:
        """Committed GN per resident task (slices physically held now)."""
        return {n: e.alloc for n, e in self._entries.items()}

    @property
    def target_allocation(self) -> dict[str, int]:
        """GN per task once every staged change commits."""
        return {n: e.target_alloc for n, e in self._entries.items()}

    @property
    def capacity_in_use(self) -> int:
        """Envelope capacity: committed and staged slices both count until
        the transition commits (the protocol's safety invariant).  O(1):
        a running counter, cross-checked under ``REPRO_DEBUG=1``."""
        if _DEBUG:
            recomputed = sum(e.gn_hi for e in self._entries.values())
            assert self._in_use == recomputed, (
                f"slice ledger counter desync: cached {self._in_use} != "
                f"recomputed {recomputed} (an entry's gn_hi was mutated "
                f"without going through the pool API)"
            )
        return self._in_use

    @property
    def free_capacity(self) -> int:
        return self.gn_total - self.capacity_in_use

    def fingerprint(self) -> tuple:
        """Hashable snapshot of the full ledger state."""
        return tuple(sorted(
            (n, e.alloc, e.target_alloc, e.departing, e.task, e.target_task)
            for n, e in self._entries.items()
        ))

    # ---- transactions -------------------------------------------------------

    def fork(self) -> "SlicePool":
        """Independent copy of every entry; mutate freely, then
        :meth:`adopt` on success or drop on rejection."""
        child = SlicePool(self.gn_total)
        child._entries = {n: e.copy() for n, e in self._entries.items()}
        child._in_use = self._in_use
        return child

    def adopt(self, other: "SlicePool") -> None:
        self._entries = other._entries
        self._in_use = other._in_use

    # ---- mutations ----------------------------------------------------------

    def reserve(self, entry: Entry) -> None:
        """Add a new resident (the admit commit step)."""
        name = entry.task.name
        if name in self._entries:
            raise ValueError(f"name {name!r} already resident")
        self._entries[name] = entry
        self._in_use += entry.gn_hi

    def reclaim(self, name: str) -> Entry:
        """Remove a resident, returning its slices to the pool."""
        e = self._entries.pop(name)
        self._in_use -= e.gn_hi
        return e

    def set_alloc(self, name: str, alloc: int) -> None:
        """Re-size ``name``'s committed allocation (instant-mode
        re-balancing), clearing any staged allocation.  The pool-API twin
        of assigning ``entry.alloc`` directly — required so the running
        capacity counter tracks the envelope change."""
        e = self._entries[name]
        self._in_use -= e.gn_hi
        e.alloc = int(alloc)
        e.staged_alloc = None
        self._in_use += e.gn_hi

    def commit(self, name: str) -> Entry:
        """Job-boundary commit of ``name``'s staged state (the pool-API
        twin of :meth:`Entry.commit`): staged parameters become committed
        and any envelope surplus returns to the pool."""
        e = self._entries[name]
        self._in_use -= e.gn_hi
        e.commit()
        self._in_use += e.gn_hi
        return e

    def mark_departing(self, name: str) -> bool:
        """Flag ``name`` as departing (slices stay held until reclaim)."""
        e = self._entries.get(name)
        if e is None or e.departing:
            return False
        e.departing = True
        return True
