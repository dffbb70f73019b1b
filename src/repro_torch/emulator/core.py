"""Minimal discrete-event simulator (heapq event loop)."""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable


@dataclass(order=True)
class Event:
    time: float
    seq: int
    fn: Callable = field(compare=False)


class Simulator:
    def __init__(self) -> None:
        self.now = 0.0
        self._q: list[Event] = []
        self._counter = itertools.count()
        self.log: list[tuple[float, str]] = []

    def at(self, time: float, fn: Callable) -> None:
        heapq.heappush(self._q, Event(max(time, self.now),
                                      next(self._counter), fn))

    def after(self, delay: float, fn: Callable) -> None:
        self.at(self.now + delay, fn)

    def note(self, msg: str) -> None:
        self.log.append((self.now, msg))

    def run(self, until: float) -> None:
        while self._q and self._q[0].time <= until:
            ev = heapq.heappop(self._q)
            self.now = ev.time
            ev.fn()
        self.now = max(self.now, until)
