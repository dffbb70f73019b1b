"""Heartbeat-based failure detection (the Kubernetes liveness analogue).

A copy of ``repro/runtime/failure.py`` (numpy and the standard library only).


Pure logic (injectable clock) so it is unit-testable and reusable by both
the emulator and a real multi-host launcher: workers report heartbeats;
``sweep()`` returns newly-suspected dead workers after ``timeout_s``;
flapping nodes are quarantined after ``max_restarts``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class WorkerState:
    last_seen: float
    alive: bool = True
    restarts: int = 0


class HeartbeatMonitor:
    def __init__(self, workers, timeout_s: float = 10.0,
                 max_restarts: int = 3, clock=time.monotonic):
        self.clock = clock
        self.timeout_s = timeout_s
        self.max_restarts = max_restarts
        now = clock()
        self.workers = {w: WorkerState(last_seen=now) for w in workers}
        self.quarantined: set = set()

    def beat(self, worker) -> None:
        st = self.workers[worker]
        st.last_seen = self.clock()
        if not st.alive:                 # came back
            st.alive = True
            st.restarts += 1
            if st.restarts > self.max_restarts:
                self.quarantined.add(worker)

    def sweep(self):
        """Returns workers newly declared dead on this sweep."""
        now = self.clock()
        newly_dead = []
        for w, st in self.workers.items():
            if st.alive and now - st.last_seen > self.timeout_s:
                st.alive = False
                newly_dead.append(w)
        return newly_dead

    def healthy(self):
        return [w for w, st in self.workers.items()
                if st.alive and w not in self.quarantined]
