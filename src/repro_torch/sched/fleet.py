"""Hierarchical broker sharding: brokers-of-brokers for fleet scale.

:class:`~repro_torch.sched.federation.CapacityBroker` already composes one
level of hierarchy — a broker over per-host controllers.  At 10⁴–10⁶
resident services a single flat broker still pays O(hosts) per admission
(placement scoring plus, on full rejection, a pinned offer to every
host).  :class:`BrokerTree` recurses the same composition: a node over
child *shards* (flat brokers, or nested trees), so one admission
descends ``O(log_fanout(hosts) + hosts_per_shard)`` of the fleet instead
of all of it.

**Capacity digests.**  Each shard maintains an aggregate digest the
parent reads in O(1): ``max_arrival_capacity`` — the largest GN an
arrival could range over on any single placeable host below (free slices
under federated dedication, the whole pool under preemptive
arbitration).  Admission first derives the arrival's minimum feasible GN
(``g_min``: the smallest g whose 2g-slice minimum span meets the
deadline — the same Lemma-5.3 feasibility screen the host controller
runs) and descends only shards whose digest can plausibly fit it.
Pruned shards are never offered the task at all, which is what makes
fleet admission O(affected neighborhood): the certify-memo makes the
*host-level* cost independent of resident count, and the digest makes
the *fleet-level* cost independent of shard count.

**Two-pass admission at every level.**  Mirroring the flat broker, pass
one offers the arrival to plausible shards in most-free-first digest
order with ``allow_realloc=False`` — each shard runs only its cheap
pinned sweeps.  Only if every plausible shard pinned-rejects does pass
two descend the ``realloc_children`` most-free shards with
``pinned=False`` — the shard then runs only its expensive re-allocation
pass (its own pinned sweep already failed transactionally in pass one).

**Scope.**  The tree mirrors the controller surface the runtime layers
consume (admit / release / update_rate / job_boundary / bound / task /
is_departing), keyed by fleet-unique task names routed to the owning
shard.  Departure-imbalance migration stays *within* each leaf broker —
cross-shard migration is a recorded follow-on (ROADMAP).  The
discrete-event fleet simulator drives flat brokers; trees are the
admission-path scale layer (``benchmarks/scale_acceptance.py``).
"""
from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence, Union

from repro_torch.core import RTTask
from repro_torch.obs import metrics

from .controller import SchedDecision
from .federation import BrokerDecision, CapacityBroker

__all__ = ["BrokerTree"]

_EPS = 1e-9


class BrokerTree:
    """A broker over child shards (flat brokers or nested trees)."""

    def __init__(
        self,
        children: Sequence[Union[CapacityBroker, "BrokerTree"]],
        realloc_children: int = 1,
    ):
        if not children:
            raise ValueError("broker tree needs at least one child")
        self.children: tuple = tuple(children)
        # second-pass budget, mirroring CapacityBroker.realloc_hosts: how
        # many most-free shards may run their re-allocation pass after
        # every plausible shard pinned-rejected
        self.realloc_children = realloc_children
        self._active: dict[str, int] = {}       # name -> child index

    @classmethod
    def build(
        cls,
        n_hosts: int,
        gn_per_host: int,
        *,
        hosts_per_shard: int = 32,
        fanout: int = 32,
        realloc_children: int = 1,
        **broker_kw,
    ) -> "BrokerTree":
        """Fleet of ``n_hosts`` identical hosts sharded into leaf brokers
        of ``hosts_per_shard``, grouped ``fanout``-wide into nested trees
        until one root remains.  ``broker_kw`` passes through to
        :meth:`CapacityBroker.build` for every leaf (placement policy,
        transition mode, engine, preemption, ...)."""
        if n_hosts < 1:
            raise ValueError("need at least one host")
        leaves: list = []
        h = 0
        while h < n_hosts:
            take = min(hosts_per_shard, n_hosts - h)
            leaves.append(CapacityBroker.build(take, gn_per_host,
                                               **broker_kw))
            h += take
        nodes: list = leaves
        while len(nodes) > fanout:
            nodes = [
                cls(nodes[i:i + fanout], realloc_children=realloc_children)
                for i in range(0, len(nodes), fanout)
            ]
        return cls(nodes, realloc_children=realloc_children)

    # ---- digests ------------------------------------------------------------

    @property
    def n_hosts(self) -> int:
        return sum(c.n_hosts for c in self.children)

    @property
    def free_capacity(self) -> int:
        return sum(c.free_capacity for c in self.children)

    @property
    def capacity_in_use(self) -> int:
        return sum(c.capacity_in_use for c in self.children)

    @property
    def max_arrival_capacity(self) -> int:
        """The shard digest, aggregated: the parent's pruning reads one
        number per child, not the hosts below it."""
        return max(c.max_arrival_capacity for c in self.children)

    @property
    def residents(self) -> int:
        return len(self._active)

    def leaves(self) -> Iterator[CapacityBroker]:
        """Every flat leaf broker, left to right."""
        for c in self.children:
            if isinstance(c, BrokerTree):
                yield from c.leaves()
            else:
                yield c

    def locate(self, name: str) -> Optional[tuple[CapacityBroker, int]]:
        """(leaf broker, host index within it) owning ``name``."""
        i = self._active.get(name)
        if i is None:
            return None
        child = self.children[i]
        if isinstance(child, BrokerTree):
            return child.locate(name)
        h = child.active_host(name)
        return (child, h) if h is not None else None

    # ---- controller surface -------------------------------------------------

    def _g_min(self, task: RTTask, cap: int) -> Optional[int]:
        # Lemma-5.3 feasibility screen: smallest g whose best-case span at
        # 2g virtual SMs meets the deadline (same rule as the controller)
        for g in range(1, cap + 1):
            if task.min_span(2 * g) <= task.deadline + _EPS:
                return g
        return None

    def admit(
        self,
        task: RTTask,
        t: float = 0.0,
        allow_realloc: Optional[bool] = None,
        pinned: bool = True,
    ) -> BrokerDecision:
        """Offer ``task`` to plausible shards in digest order; the first
        shard that certifies it wins.  See the module docstring for the
        pruning rule and the two-pass structure."""
        name = task.name
        if name and name in self._active:
            return BrokerDecision(
                False, None, None, (),
                reason=f"name {name!r} already resident in the fleet",
            )
        g_min = self._g_min(task, self.max_arrival_capacity)
        if g_min is None:
            return BrokerDecision(
                False, None, None, (),
                reason="no feasible GN within any shard's capacity digest",
            )
        digests = [
            (i, c.free_capacity, c.max_arrival_capacity)
            for i, c in enumerate(self.children)
        ]
        last: Optional[SchedDecision] = None
        tried: tuple = ()
        if pinned:
            # plausible shards, most placeable free capacity first
            order = sorted(
                (i for i, _, cap in digests if cap >= g_min),
                key=lambda i: (-digests[i][1], i),
            )
            for i in order:
                metrics.inc("broker_shard_descents_total", phase="pinned")
                dec = self.children[i].admit(task, t=t, allow_realloc=False)
                if dec.admitted:
                    self._active[name] = i
                    return dec
                last, tried = dec.decision, dec.tried_hosts
        if allow_realloc is not False:
            realloc_order = sorted(
                (i for i, _, _ in digests), key=lambda i: (-digests[i][1], i)
            )[: self.realloc_children]
            for i in realloc_order:
                metrics.inc("broker_shard_descents_total", phase="realloc")
                dec = self.children[i].admit(task, t=t, pinned=False)
                if dec.admitted:
                    self._active[name] = i
                    return dec
                last = dec.decision
        return BrokerDecision(
            False, None, last, tried,
            reason="rejected by every plausible shard",
        )

    def release(self, name: str, t: float = 0.0) -> bool:
        i = self._active.get(name)
        if i is None:
            return False
        ok = self.children[i].release(name, t=t)
        if ok and self.children[i].task(name) is None:
            # instant-transition shard: reclaimed at once
            del self._active[name]
        return ok

    def update_rate(
        self, name: str, period: float, deadline: float, t: float = 0.0
    ) -> SchedDecision:
        i = self._active.get(name)
        if i is None:
            return SchedDecision(False, None, None,
                                 reason=f"no resident task {name!r}")
        return self.children[i].update_rate(name, period, deadline, t=t)

    def job_boundary(self, name: str, t: float = 0.0) -> str:
        i = self._active.get(name)
        if i is None:
            return "none"
        res = self.children[i].job_boundary(name, t=t)
        if res == "reclaimed":
            del self._active[name]
        return res

    def bound(self, name: str) -> float:
        i = self._active.get(name)
        return self.children[i].bound(name) if i is not None else math.inf

    def bounds(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for c in self.children:
            out.update(c.bounds())
        return out

    def task(self, name: str) -> Optional[RTTask]:
        i = self._active.get(name)
        return self.children[i].task(name) if i is not None else None

    def is_departing(self, name: str) -> bool:
        i = self._active.get(name)
        return self.children[i].is_departing(name) if i is not None else False

    def active_child(self, name: str) -> Optional[int]:
        return self._active.get(name)

    @property
    def allocation(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for c in self.children:
            out.update(c.allocation)
        return out
