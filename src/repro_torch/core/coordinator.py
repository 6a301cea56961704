"""The replicated coordinator (paper Fig. 1, §3).

In the paper the coordinator is a 960-line replicated object hosted by the
Replicant state-machine service, which uses Paxos to sequence function calls
into the object.  We reproduce that structure: a tiny deterministic state
machine (`CoordinatorState`) replicated across N replicas by a sequencer that
assigns a total order to commands (the Paxos stand-in), with quorum reads and
replica crash/recovery.

The coordinator is the rendezvous point: it maintains the list of storage
servers, their liveness, and a monotonically increasing *configuration epoch*
that clients use to refresh their hash ring when membership changes.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .errors import NoQuorum


@dataclass
class ServerInfo:
    server_id: int
    address: str
    status: str = "online"      # online | failed


class CoordinatorState:
    """Deterministic replicated object.  Commands are (name, args) tuples;
    applying the same log to any replica yields the same state."""

    def __init__(self):
        self.epoch = 0
        self.servers: Dict[int, ServerInfo] = {}

    # Every mutation bumps the epoch so clients can cheaply detect staleness.
    def apply(self, command: str, args: tuple) -> Any:
        fn = getattr(self, f"_cmd_{command}")
        return fn(*args)

    def _cmd_register_server(self, server_id: int, address: str):
        self.servers[server_id] = ServerInfo(server_id, address)
        self.epoch += 1
        return self.epoch

    def _cmd_fail_server(self, server_id: int):
        info = self.servers.get(server_id)
        if info is not None and info.status != "failed":
            info.status = "failed"
            self.epoch += 1
        return self.epoch

    def _cmd_recover_server(self, server_id: int):
        info = self.servers.get(server_id)
        if info is not None and info.status != "online":
            info.status = "online"
            self.epoch += 1
        return self.epoch

    def _cmd_deregister_server(self, server_id: int):
        if self.servers.pop(server_id, None) is not None:
            self.epoch += 1
        return self.epoch

    def config(self) -> dict:
        return {
            "epoch": self.epoch,
            "online": sorted(s.server_id for s in self.servers.values()
                             if s.status == "online"),
            "failed": sorted(s.server_id for s in self.servers.values()
                             if s.status == "failed"),
        }


class _Replica:
    def __init__(self, rid: int):
        self.rid = rid
        self.state = CoordinatorState()
        self.applied_upto = 0           # log index
        self.alive = True


class ReplicatedCoordinator:
    """N-replica coordinator with a total-order command log.

    The sequencer (``_log`` + lock) plays the role of Paxos: every command
    gets a slot, replicas apply slots in order.  Commands succeed only while
    a majority of replicas is alive; reads are served by any replica that is
    caught up to the latest slot (linearizable in this in-process setting).
    """

    def __init__(self, n_replicas: int = 3):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self._replicas = [_Replica(i) for i in range(n_replicas)]
        self._log: List[Tuple[str, tuple]] = []
        self._lock = threading.RLock()

    # -- replication machinery ----------------------------------------------
    def _quorum(self) -> int:
        return len(self._replicas) // 2 + 1

    def _alive(self) -> List[_Replica]:
        return [r for r in self._replicas if r.alive]

    def _submit(self, command: str, args: tuple) -> Any:
        with self._lock:
            alive = self._alive()
            if len(alive) < self._quorum():
                raise NoQuorum(
                    f"{len(alive)}/{len(self._replicas)} replicas alive, "
                    f"need {self._quorum()}")
            self._log.append((command, args))
            slot = len(self._log)
            result = None
            for rep in alive:
                result = self._catch_up(rep, slot)
            return result

    def _catch_up(self, rep: _Replica, upto: int) -> Any:
        result = None
        while rep.applied_upto < upto:
            cmd, args = self._log[rep.applied_upto]
            result = rep.state.apply(cmd, args)
            rep.applied_upto += 1
        return result

    # -- coordinator API -----------------------------------------------------
    def register_server(self, server_id: int, address: str) -> int:
        return self._submit("register_server", (server_id, address))

    def fail_server(self, server_id: int) -> int:
        return self._submit("fail_server", (server_id,))

    def recover_server(self, server_id: int) -> int:
        return self._submit("recover_server", (server_id,))

    def deregister_server(self, server_id: int) -> int:
        return self._submit("deregister_server", (server_id,))

    def config(self) -> dict:
        """Quorum read: served by any caught-up live replica."""
        with self._lock:
            alive = self._alive()
            if len(alive) < self._quorum():
                raise NoQuorum("cannot serve linearizable read")
            rep = alive[0]
            self._catch_up(rep, len(self._log))
            return rep.state.config()

    # -- failure injection ----------------------------------------------------
    def crash_replica(self, rid: int) -> None:
        self._replicas[rid].alive = False

    def recover_replica(self, rid: int) -> None:
        with self._lock:
            rep = self._replicas[rid]
            rep.alive = True
            # State transfer: replay the log from the last applied slot.
            self._catch_up(rep, len(self._log))

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)
