"""Long-lived scheduler daemon: the durable control plane as a service.

``python -m repro_torch.sched.daemon serve`` runs a journaled
:class:`~repro_torch.sched.DynamicController` (or, with ``--hosts N > 1``, a
:class:`~repro_torch.sched.CapacityBroker`) behind a unix-socket request
protocol.  On startup the daemon *recovers*: if the journal already holds
a configuration, the resident set is rebuilt and re-certified through
:mod:`repro_torch.sched.recovery` — a ``kill -9`` between requests loses
nothing, because every admission decision was journaled before it was
applied.  On graceful shutdown (SIGTERM / SIGINT / ``stop``) the daemon
checkpoints: the full state is snapshotted into the journal and the log
truncated, so restart cost stays bounded under churn (the same compaction
also runs automatically every ``--compact-every`` mutating operations).

**Protocol.**  One JSON document per connection, newline-terminated; the
response is one JSON document.  Commands:

  ``submit``   ``{"cmd": "submit", "task": {<task spec>}}`` — admit a
               task (spec format: :func:`repro_torch.sched.journal.task_to_dict`)
  ``status``   resident allocation, certified bounds, epoch, journal
               position, and the startup recovery report
  ``cancel``   ``{"cmd": "cancel", "name": "..."}`` — release a task
  ``update``   ``{"cmd": "update", "name": ..., "period": ..,
               "deadline": ..}`` — certified rate change
  ``drain``    release every resident, checkpoint, and refuse further
               submits (graceful wind-down)
  ``ping``     liveness probe
  ``stop``     checkpoint and exit the serve loop

The CLI mirrors the protocol: ``submit`` / ``status`` / ``cancel`` /
``drain`` / ``ping`` / ``stop`` subcommands are thin clients over
:func:`request` (which tests use directly).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import signal
import socket
import sys
from typing import Optional, Union

from repro_torch.obs import metrics

from .controller import DynamicController
from .federation import CapacityBroker
from .journal import Journal, task_from_dict
from .recovery import (
    RecoveryReport,
    recover_broker,
    recover_controller,
    serialize_state,
)

__all__ = ["SchedulerDaemon", "request", "main"]


class SchedulerDaemon:
    """The service loop: a journaled control plane plus its socket front.

    Construction recovers-or-creates: a journal that already carries a
    ``meta`` configuration wins over the constructor arguments (they
    merely describe the *fresh* case), so restarting a daemon on an
    existing journal always resumes the journaled system."""

    def __init__(
        self,
        journal_path: str,
        socket_path: str,
        gn_total: int = 16,
        hosts: int = 1,
        transition: str = "instant",
        engine: str = "batch",
        tightened: bool = True,
        preemption: str = "none",
        gpu_ctx_overhead: float = 0.0,
        placement: str = "least_loaded",
        compact_every: int = 256,
    ):
        self.socket_path = str(socket_path)
        self.journal = Journal(str(journal_path))
        self.compact_every = int(compact_every)
        self._ops_since_compact = 0
        self._draining = False
        self._stop = False
        self.report: Optional[RecoveryReport] = None
        meta = self.journal.meta()
        self.front: Union[DynamicController, CapacityBroker]
        if "broker" in meta:
            self.front, self.report = recover_broker(self.journal,
                                                     engine=engine)
        elif meta:
            self.front, self.report = recover_controller(self.journal,
                                                         engine=engine)
        elif hosts > 1:
            self.front = CapacityBroker.build(
                hosts, gn_total, transition=transition, engine=engine,
                tightened=tightened, preemption=preemption,
                gpu_ctx_overhead=gpu_ctx_overhead, placement=placement,
                journal=self.journal,
            )
        else:
            self.front = DynamicController(
                gn_total, tightened=tightened, transition=transition,
                engine=engine, preemption=preemption,
                gpu_ctx_overhead=gpu_ctx_overhead, journal=self.journal,
            )

    # ---- state ---------------------------------------------------------------

    @property
    def recovered(self) -> bool:
        return self.report is not None

    def checkpoint(self) -> int:
        """Snapshot + truncate the journal (see ``Journal.checkpoint``)."""
        self._ops_since_compact = 0
        return self.journal.checkpoint(serialize_state(self.front))

    def _after_mutation(self) -> None:
        self._ops_since_compact += 1
        if self.compact_every > 0 \
                and self._ops_since_compact >= self.compact_every:
            self.checkpoint()

    def status(self) -> dict:
        front = self.front
        bounds = front.bounds()
        doc = {
            "ok": True,
            "resident": dict(sorted(front.allocation.items())),
            "bounds": {n: bounds[n] for n in sorted(bounds)},
            "free_capacity": front.free_capacity,
            "journal_seq": self.journal.last_seq,
            "draining": self._draining,
            "recovered": self.recovered,
        }
        if isinstance(front, CapacityBroker):
            doc["hosts"] = front.n_hosts
            doc["active"] = {n: h for n, h in sorted(front._active.items())}
            doc["migrating"] = sorted(front.migrating)
            doc["epochs"] = [ctl.epoch for ctl in front.hosts]
        else:
            doc["epoch"] = front.epoch
        if self.report is not None:
            doc["recovery"] = {
                "replayed_records": self.report.state.replayed,
                "from_snapshot": self.report.state.from_snapshot,
                "rolled_forward": self.report.state.rolled_forward,
                "rolled_back": self.report.state.rolled_back,
                "quarantined": [list(q) for q in self.report.quarantined],
                "recovery_ms": self.report.recovery_ms,
            }
        return doc

    # ---- request handling ----------------------------------------------------

    def handle(self, doc: dict) -> dict:
        try:
            return self._handle(doc)
        except Exception as exc:  # protocol errors must not kill the loop
            metrics.inc("daemon_request_errors_total")
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}

    def _handle(self, doc: dict) -> dict:
        cmd = doc.get("cmd")
        metrics.inc("daemon_requests_total", cmd=str(cmd))
        if cmd == "ping":
            return {"ok": True, "pid": os.getpid()}
        if cmd == "status":
            return self.status()
        if cmd == "submit":
            if self._draining:
                return {"ok": True, "admitted": False,
                        "reason": "daemon is draining"}
            task = task_from_dict(doc["task"])
            dec = self.front.admit(task, t=float(doc.get("t", 0.0)))
            if dec.admitted:
                self._after_mutation()
            out = {
                "ok": True,
                "admitted": dec.admitted,
                "reason": getattr(dec, "reason", ""),
            }
            if dec.admitted:
                out["alloc"] = dict(sorted(self.front.allocation.items()))
                out["bound"] = (dec.bounds or {}).get(task.name, math.inf)
            if isinstance(self.front, CapacityBroker):
                out["host"] = getattr(dec, "host", None)
            return out
        if cmd == "cancel":
            ok = self.front.release(doc["name"], t=float(doc.get("t", 0.0)))
            if ok:
                self._after_mutation()
            return {"ok": True, "released": bool(ok)}
        if cmd == "update":
            dec = self.front.update_rate(
                doc["name"], float(doc["period"]), float(doc["deadline"]),
                t=float(doc.get("t", 0.0)),
            )
            if dec.admitted:
                self._after_mutation()
            return {"ok": True, "admitted": dec.admitted,
                    "reason": dec.reason}
        if cmd == "drain":
            self._draining = True
            released = []
            for name in sorted(self.front.allocation):
                if self.front.release(name):
                    released.append(name)
            seq = self.checkpoint()
            return {"ok": True, "released": released, "checkpoint_seq": seq}
        if cmd == "stop":
            self._stop = True
            seq = self.checkpoint()
            return {"ok": True, "checkpoint_seq": seq}
        return {"ok": False, "error": f"unknown command {cmd!r}"}

    # ---- serve loop ----------------------------------------------------------

    def serve(self) -> None:
        """Accept-and-respond until ``stop`` / SIGTERM / SIGINT; graceful
        exits checkpoint, a ``kill -9`` is what recovery is for."""
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.socket_path)
        srv.listen(8)
        srv.settimeout(0.25)   # so signal flags are polled

        def _graceful(signum, frame):
            self._stop = True

        old = {s: signal.signal(s, _graceful)
               for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            while not self._stop:
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                with conn:
                    conn.settimeout(5.0)
                    data = b""
                    while b"\n" not in data:
                        chunk = conn.recv(65536)
                        if not chunk:
                            break
                        data += chunk
                    if not data.strip():
                        continue
                    try:
                        doc = json.loads(data.decode())
                    except ValueError as exc:
                        resp = {"ok": False, "error": f"bad request: {exc}"}
                    else:
                        resp = self.handle(doc)
                    conn.sendall((json.dumps(resp) + "\n").encode())
        finally:
            for s, h in old.items():
                signal.signal(s, h)
            srv.close()
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)
            # graceful exit: compact so the next start replays a snapshot
            self.checkpoint()
            self.journal.close()


# ---- client ------------------------------------------------------------------

def request(socket_path: str, doc: dict, timeout: float = 10.0) -> dict:
    """One protocol round trip (the client the CLI and tests share)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(str(socket_path))
        s.sendall((json.dumps(doc) + "\n").encode())
        data = b""
        while b"\n" not in data:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    if not data.strip():
        raise ConnectionError(f"empty response from {socket_path}")
    return json.loads(data.decode())


# ---- CLI ---------------------------------------------------------------------

def _load_spec(args: argparse.Namespace) -> dict:
    if args.file == "-":
        return json.load(sys.stdin)
    with open(args.file) as f:
        return json.load(f)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sched.daemon",
        description="Durable scheduler daemon over a write-ahead journal.",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    sv = sub.add_parser("serve", help="run the service loop")
    sv.add_argument("--journal", required=True, help="journal sqlite path")
    sv.add_argument("--socket", required=True, help="unix socket path")
    sv.add_argument("--gn-total", type=int, default=16)
    sv.add_argument("--hosts", type=int, default=1)
    sv.add_argument("--transition", default="instant",
                    choices=["instant", "boundary"])
    sv.add_argument("--engine", default="batch")
    sv.add_argument("--preemption", default="none",
                    choices=["none", "priority"])
    sv.add_argument("--gpu-ctx-overhead", type=float, default=0.0)
    sv.add_argument("--placement", default="least_loaded")
    sv.add_argument("--compact-every", type=int, default=256,
                    help="checkpoint the journal every N mutations "
                         "(0 disables)")

    for name, hlp in (("status", "resident set + recovery report"),
                      ("ping", "liveness probe"),
                      ("drain", "release everything and wind down"),
                      ("stop", "checkpoint and exit the daemon")):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("--socket", required=True)

    sm = sub.add_parser("submit", help="admit a task from a JSON spec")
    sm.add_argument("--socket", required=True)
    sm.add_argument("--file", required=True,
                    help="task spec JSON path ('-' for stdin)")

    cn = sub.add_parser("cancel", help="release a task")
    cn.add_argument("--socket", required=True)
    cn.add_argument("name")

    args = ap.parse_args(argv)
    if args.command == "serve":
        SchedulerDaemon(
            args.journal, args.socket,
            gn_total=args.gn_total, hosts=args.hosts,
            transition=args.transition, engine=args.engine,
            preemption=args.preemption,
            gpu_ctx_overhead=args.gpu_ctx_overhead,
            placement=args.placement, compact_every=args.compact_every,
        ).serve()
        return 0
    if args.command == "submit":
        resp = request(args.socket, {"cmd": "submit",
                                     "task": _load_spec(args)})
    elif args.command == "cancel":
        resp = request(args.socket, {"cmd": "cancel", "name": args.name})
    else:
        resp = request(args.socket, {"cmd": args.command})
    json.dump(resp, sys.stdout, indent=1, sort_keys=True)
    sys.stdout.write("\n")
    if not resp.get("ok", False):
        return 1
    if args.command == "submit" and not resp.get("admitted", False):
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
