"""Write-ahead journal: durable admission state for the control plane.

The controller/broker layers are transactional *in memory* — a rejected
operation leaves the ledger byte-identical — but a process restart used to
forget the entire resident set, and with it every certified guarantee.
:class:`Journal` makes the control plane crash-recoverable: every
state-changing transaction (admit / release / depart / boundary / update /
migrate) is recorded *durably, before the in-memory commit*, so after any
crash the journal prefix on disk describes a state the live controller
either reached or was one certified decision away from reaching.
:mod:`repro_torch.sched.recovery` replays that prefix back into a
:class:`~repro_torch.sched.capacity.SlicePool` and re-certifies it.

**Record model.**  One sqlite row per record, in a single ``journal``
table with a monotonic ``seq`` (``AUTOINCREMENT``: sequence numbers never
repeat, even across compactions).  Each record carries the model-time
``t``, an optional ``host`` (per-host controller records in a federated
journal; broker-level records leave it NULL), the operation ``op``, a
two-phase ``phase`` and a canonical-JSON ``payload``:

  ===========  ======================  ====================================
  op           phases                  written by
  ===========  ======================  ====================================
  admit        commit                  controller, before the pool adopts
                                       the certified arrival (payload:
                                       task spec, GN, post-op allocation
                                       map, certified R̂ bounds, epoch)
  release      commit                  instant-mode release (reclaim now)
  depart       commit                  boundary-mode release (slices held
                                       until the job boundary)
  boundary     commit                  job_boundary with an effect
                                       (``result``: reclaimed | committed)
  update       commit                  certified rate change (new T/D,
                                       staged flag, post-op bounds, epoch)
  migrate      intent, commit, abort   broker two-phase migration: intent
                                       *before* the target-host admit,
                                       commit after the source release,
                                       abort on target rejection or
                                       mid-migration fleet departure
  ===========  ======================  ====================================

Single-host operations are atomic (one record); the broker migration is
the two-phase one, and its crash window is resolved deterministically by
recovery (see :mod:`repro_torch.sched.recovery`).

**Durability.**  The connection runs ``journal_mode=WAL`` with
``synchronous=FULL``: every ``append`` is one fsync'd sqlite transaction,
atomic under power loss.  The fsync cost per record is exported as the
``journal_fsync_seconds`` histogram;
``benchmarks/recovery_acceptance.py`` gates the end-to-end journaled
admission overhead at < 2x the in-memory mean.

**Compaction.**  :meth:`checkpoint` writes a full state snapshot (the
shape :func:`repro_torch.sched.recovery.serialize_state` produces) and deletes
every journal record it covers, so the log stays bounded under churn:
recovery loads the snapshot and replays only the suffix.  Controller
configuration lives in a separate ``meta`` table that compaction never
touches.
"""
from __future__ import annotations

import dataclasses
import json
import sqlite3
import time
from typing import Optional

from repro_torch.core import GpuSegment, RTTask
from repro_torch.obs import metrics

from .capacity import Entry

__all__ = [
    "Journal",
    "HostJournal",
    "Record",
    "task_to_dict",
    "task_from_dict",
    "entry_to_dict",
    "entry_from_dict",
]

#: bump when the record/payload layout changes incompatibly
FORMAT = 1

#: journal fsync latencies span ~10us (tmpfs) to ~100ms (busy disks)
_FSYNC_BUCKETS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS journal (
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    t REAL NOT NULL,
    host INTEGER,
    op TEXT NOT NULL,
    phase TEXT NOT NULL,
    task TEXT NOT NULL,
    payload TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS meta (
    scope TEXT PRIMARY KEY,
    config TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS snapshot (
    id INTEGER PRIMARY KEY CHECK (id = 1),
    seq INTEGER NOT NULL,
    state TEXT NOT NULL
);
"""


# ---- task / entry serialization ---------------------------------------------
#
# JSON floats round-trip bit-exactly (repr is the shortest exact form), so
# a replayed task — and the certified R-hat recomputed from it — is
# bit-identical to the admitted one.  tests/test_recovery.py asserts this
# across whole crash matrices.

def task_to_dict(task: RTTask) -> dict:
    return {
        "name": task.name,
        "cpu_lo": list(task.cpu_lo),
        "cpu_hi": list(task.cpu_hi),
        "mem_lo": list(task.mem_lo),
        "mem_hi": list(task.mem_hi),
        "gpu": [
            [g.work_lo, g.work_hi, g.overhead_hi, g.alpha] for g in task.gpu
        ],
        "deadline": task.deadline,
        "period": task.period,
        "copies": task.copies,
    }


def task_from_dict(doc: dict) -> RTTask:
    return RTTask(
        cpu_lo=tuple(doc["cpu_lo"]),
        cpu_hi=tuple(doc["cpu_hi"]),
        mem_lo=tuple(doc["mem_lo"]),
        mem_hi=tuple(doc["mem_hi"]),
        gpu=tuple(GpuSegment(*g) for g in doc["gpu"]),
        deadline=doc["deadline"],
        period=doc["period"],
        copies=doc["copies"],
        name=doc["name"],
    )


def entry_to_dict(entry: Entry) -> dict:
    doc = {
        "task": task_to_dict(entry.task),
        "alloc": entry.alloc,
        "departing": entry.departing,
    }
    if entry.staged_task is not None:
        doc["staged_task"] = task_to_dict(entry.staged_task)
    if entry.staged_alloc is not None:
        doc["staged_alloc"] = entry.staged_alloc
    return doc


def entry_from_dict(doc: dict) -> Entry:
    return Entry(
        task=task_from_dict(doc["task"]),
        alloc=int(doc["alloc"]),
        staged_task=(task_from_dict(doc["staged_task"])
                     if "staged_task" in doc else None),
        staged_alloc=doc.get("staged_alloc"),
        departing=bool(doc.get("departing", False)),
    )


def _canonical(doc: dict) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass(frozen=True)
class Record:
    """One journal record, payload decoded."""

    seq: int
    t: float
    host: Optional[int]
    op: str
    phase: str
    task: str
    payload: dict

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Journal:
    """Sqlite write-ahead journal (see module docstring).

    ``path`` may be ``":memory:"`` for tests; durability then obviously
    only spans the :class:`Journal` object's lifetime.  ``synchronous``
    is ``"full"`` (fsync per record, the crash-safe default) or
    ``"normal"`` (WAL-safe against process crashes, not power loss).
    """

    def __init__(self, path: str, synchronous: str = "full"):
        if synchronous not in ("full", "normal"):
            raise ValueError(f"unknown synchronous mode {synchronous!r}")
        self.path = str(path)
        self.host: Optional[int] = None    # scope marker (HostJournal sets it)
        self._conn = sqlite3.connect(self.path)
        self._conn.isolation_level = None  # autocommit: one txn per append
        if self.path != ":memory:":
            self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(f"PRAGMA synchronous={synchronous.upper()}")
        self._conn.executescript(_SCHEMA)

    # ---- write side ---------------------------------------------------------

    def append(
        self,
        op: str,
        task: str = "",
        t: float = 0.0,
        phase: str = "commit",
        host: Optional[int] = None,
        **payload,
    ) -> int:
        """Durably record one transaction; returns its sequence number.

        The row is committed (and fsync'd, under ``synchronous="full"``)
        before this returns — the write-ahead contract callers rely on:
        journal first, mutate memory second."""
        t0 = time.perf_counter()
        cur = self._conn.execute(
            "INSERT INTO journal (t, host, op, phase, task, payload) "
            "VALUES (?, ?, ?, ?, ?, ?)",
            (float(t), host, op, phase, task, _canonical(payload)),
        )
        metrics.observe("journal_fsync_seconds",
                        time.perf_counter() - t0, buckets=_FSYNC_BUCKETS)
        metrics.inc("journal_records_total", op=op)
        return int(cur.lastrowid)

    def ensure_meta(self, scope: str, config: dict) -> None:
        """Record ``scope``'s configuration once; a re-open verifies it.

        The semantic configuration (pool size, transition protocol,
        arbitration model) determines what the journaled bounds *mean*,
        so attaching a differently-configured controller to an existing
        journal is an error, not a silent reinterpretation."""
        row = self._conn.execute(
            "SELECT config FROM meta WHERE scope = ?", (scope,)
        ).fetchone()
        text = _canonical(config)
        if row is None:
            self._conn.execute(
                "INSERT INTO meta (scope, config) VALUES (?, ?)",
                (scope, text),
            )
        elif row[0] != text:
            raise ValueError(
                f"journal {self.path!r} scope {scope!r} was written by a "
                f"differently-configured controller: journaled "
                f"{row[0]}, attaching {text}"
            )

    # ---- read side ----------------------------------------------------------

    @property
    def last_seq(self) -> int:
        """Highest sequence number ever issued (survives compaction)."""
        row = self._conn.execute(
            "SELECT seq FROM sqlite_sequence WHERE name = 'journal'"
        ).fetchone()
        return int(row[0]) if row is not None else 0

    def records(self, up_to: Optional[int] = None) -> list[Record]:
        """All live records in sequence order; ``up_to`` truncates the
        suffix — the deterministic crash model the recovery matrix uses
        (crash = everything after record ``up_to`` was lost)."""
        q = "SELECT seq, t, host, op, phase, task, payload FROM journal"
        args: tuple = ()
        if up_to is not None:
            q += " WHERE seq <= ?"
            args = (int(up_to),)
        q += " ORDER BY seq"
        return [
            Record(seq=r[0], t=r[1], host=r[2], op=r[3], phase=r[4],
                   task=r[5], payload=json.loads(r[6]))
            for r in self._conn.execute(q, args)
        ]

    def meta(self) -> dict[str, dict]:
        """Scope → configuration, as recorded by :meth:`ensure_meta`."""
        return {
            scope: json.loads(cfg)
            for scope, cfg in self._conn.execute(
                "SELECT scope, config FROM meta ORDER BY scope"
            )
        }

    def snapshot(self) -> Optional[tuple[int, dict]]:
        """The latest checkpoint as ``(covered_seq, state)``, or None."""
        row = self._conn.execute(
            "SELECT seq, state FROM snapshot WHERE id = 1"
        ).fetchone()
        return (int(row[0]), json.loads(row[1])) if row is not None else None

    # ---- compaction ---------------------------------------------------------

    def checkpoint(self, state: dict, vacuum: bool = False) -> int:
        """Snapshot + truncate: durably store ``state`` as covering every
        record written so far, then delete those records.  Returns the
        covered sequence number.  The snapshot write and the truncation
        are one atomic transaction — a crash between them cannot leave a
        journal that forgets both."""
        seq = self.last_seq
        with metrics.timed("journal_checkpoint_ms"):
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                self._conn.execute(
                    "INSERT OR REPLACE INTO snapshot (id, seq, state) "
                    "VALUES (1, ?, ?)",
                    (seq, _canonical(state)),
                )
                self._conn.execute(
                    "DELETE FROM journal WHERE seq <= ?", (seq,)
                )
                self._conn.execute("COMMIT")
            except BaseException:
                self._conn.execute("ROLLBACK")
                raise
            if self.path != ":memory:":
                self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            if vacuum:
                self._conn.execute("VACUUM")
        metrics.inc("journal_checkpoints_total")
        return seq

    # ---- scoping / lifecycle ------------------------------------------------

    def for_host(self, host: int) -> "HostJournal":
        """Host-scoped view: every append is stamped ``host=<host>`` (the
        federation analogue of :meth:`repro_torch.sched.EventTrace.for_host`)."""
        return HostJournal(self, host)

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class HostJournal:
    """Host-scoped view of a :class:`Journal` (see :meth:`Journal.for_host`).

    Duck-types the writer surface the controller uses (``append`` /
    ``ensure_meta``), stamping ``host`` into every record so a federated
    journal interleaves per-host and broker-level records in one total
    order."""

    def __init__(self, parent: Journal, host: int):
        self.parent = parent
        self.host = int(host)

    @property
    def path(self) -> str:
        return self.parent.path

    def append(self, op, task="", t=0.0, phase="commit", host=None,
               **payload) -> int:
        return self.parent.append(op, task, t=t, phase=phase,
                                  host=self.host if host is None else host,
                                  **payload)

    def ensure_meta(self, scope: str, config: dict) -> None:
        self.parent.ensure_meta(scope, config)
