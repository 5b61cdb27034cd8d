"""Online scheduling subsystem: the port's copies of ``repro.sched``.

capacity.py     Entry + SlicePool — the transactional slice-capacity ledger
certify.py      CertificationEngine — scalar / batched / preemptive
                RTGPU certification of transitional ledger states
controller.py   DynamicController — the job-boundary mode-change protocol
federation.py   CapacityBroker — multi-host federated admission
fleet.py        BrokerTree — hierarchical broker sharding
trace.py        EventTrace — scheduler event telemetry (Chrome trace JSON)
journal.py      Journal — sqlite write-ahead journal
recovery.py     crash recovery — replay the journal, re-certify, rebuild
daemon.py       SchedulerDaemon — unix-socket service over a journaled
                controller (python -m repro_torch.sched.daemon)

Each is the reference module with ``repro.`` read as ``repro_torch.``.
"""
from .capacity import Entry, SlicePool
from .certify import (
    BatchCertifier,
    CertificationEngine,
    PreemptiveCertifier,
    ScalarCertifier,
    make_certifier,
    transitional_vectors,
)
from .certify import MemoOverlay
from .controller import DynamicController, SchedDecision
from .federation import (
    BrokerDecision,
    CapacityBroker,
    Migration,
    register_placement,
)
from .fleet import BrokerTree
from .journal import HostJournal, Journal
from .recovery import (
    RecoveryAlert,
    RecoveryReport,
    recover,
    recover_broker,
    recover_controller,
    replay,
    serialize_state,
)
from .trace import KINDS, SPAN_NAMES, EventTrace, HostTrace, TraceEvent

__all__ = [
    "Entry",
    "SlicePool",
    "CertificationEngine",
    "ScalarCertifier",
    "BatchCertifier",
    "PreemptiveCertifier",
    "MemoOverlay",
    "make_certifier",
    "transitional_vectors",
    "DynamicController",
    "SchedDecision",
    "BrokerTree",
    "CapacityBroker",
    "BrokerDecision",
    "Migration",
    "register_placement",
    "Journal",
    "HostJournal",
    "RecoveryAlert",
    "RecoveryReport",
    "replay",
    "recover",
    "recover_controller",
    "recover_broker",
    "serialize_state",
    "EventTrace",
    "HostTrace",
    "TraceEvent",
    "KINDS",
    "SPAN_NAMES",
]
