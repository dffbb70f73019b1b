"""Per-stage serving telemetry: ring-buffer streams + EWMA cluster state.

A copy of ``repro/serve/telemetry.py`` (numpy only; the same estimates
bit for bit).

Two pieces close the elastic-serving control loop
(telemetry -> ``repro_torch.core.replan`` -> live migration):

* :class:`TelemetryStream` — fixed-capacity ring buffers of per-stage
  decode latency, boundary-transfer (bytes, seconds) and scheduler queue
  depth, emitted by ``PipelineServeEngine`` / ``SlotScheduler``.  The
  clock is **injected** (default ``time.perf_counter``, passed as a
  reference and only ever called through ``self._clock``): pinned token
  paths never read the wall clock themselves, which is what makes
  telemetry-triggered migration reproducible under a fake clock in tests
  and fixture cells.

* :class:`ClusterState` — an EWMA, outlier-clipped estimate of the
  cluster's bandwidth / compute-scale, updated from telemetry samples
  (``fold``) or direct observations.  ``as_cluster()`` materializes a
  ``ClusterGraph`` for ``incremental_replan``.

Samples are plain floats on the host; recording never touches device
values beyond what the engine already synchronized, so enabling telemetry
cannot change a token stream (the serving token-identity contract).
"""

from __future__ import annotations

import time

import numpy as np


class Ring:
    """Fixed-capacity float ring buffer (O(1) append, no realloc)."""

    def __init__(self, capacity: int):
        self._buf = np.zeros(int(capacity))
        self._n = 0                      # total appends ever

    def append(self, x: float) -> None:
        self._buf[self._n % self._buf.size] = x
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self._buf.size)

    @property
    def total(self) -> int:
        return self._n

    def values(self) -> np.ndarray:
        """Retained samples, oldest first."""
        n = len(self)
        if self._n <= self._buf.size:
            return self._buf[:n].copy()
        cut = self._n % self._buf.size
        return np.concatenate([self._buf[cut:], self._buf[:cut]])

    def mean(self) -> float:
        return float(self.values().mean()) if len(self) else float("nan")


class TelemetryStream:
    """Ring-buffered per-stage serving telemetry with an injected clock.

    decode_s[k]   : per-stage decode-step latency samples (seconds)
    transfer_s[k] : stage k -> k+1 boundary transfer seconds
    transfer_b[k] : matching payload bytes (same sample index)
    queue_depth   : scheduler active-slot count per decode step

    Transfer samples are additionally kept in a pending list consumed by
    ``ClusterState.fold`` (each sample folds into exactly one EWMA
    update); the rings are the rolling diagnostic view.
    """

    def __init__(self, n_stages: int, capacity: int = 256,
                 clock=time.perf_counter):
        self.n_stages = int(n_stages)
        self._clock = clock
        self.decode_s = [Ring(capacity) for _ in range(n_stages)]
        self.transfer_s = [Ring(capacity) for _ in range(n_stages)]
        self.transfer_b = [Ring(capacity) for _ in range(n_stages)]
        self.queue_depth = Ring(capacity)
        self._pending: list[tuple[int, float, float]] = []
        self.dropped = 0                 # out-of-range samples discarded

    def now(self) -> float:
        return self._clock()

    def record_decode(self, stage: int, seconds: float) -> None:
        self.decode_s[stage].append(seconds)

    def record_transfer(self, stage: int, nbytes: float,
                        seconds: float) -> None:
        """One boundary handoff leaving ``stage`` (k -> k+1).

        A stage index outside ``[0, n_stages)`` (a recorder racing a plan
        change) is dropped and counted in ``dropped`` rather than
        corrupting the rings or raising on the serving hot path."""
        if not 0 <= stage < self.n_stages:
            self.dropped += 1
            return
        self.transfer_s[stage].append(seconds)
        self.transfer_b[stage].append(nbytes)
        self._pending.append((stage, float(nbytes), float(seconds)))

    def record_queue_depth(self, depth: int) -> None:
        self.queue_depth.append(float(depth))

    def drain_transfers(self) -> list[tuple[int, float, float]]:
        """Transfer samples since the last drain: [(stage, bytes, s)]."""
        out, self._pending = self._pending, []
        return out

    def snapshot(self) -> dict:
        """Telemetry schema (see ROADMAP "Telemetry & replan contract")."""
        return {
            "n_stages": self.n_stages,
            "decode_s": [r.values().tolist() for r in self.decode_s],
            "transfer_s": [r.values().tolist() for r in self.transfer_s],
            "transfer_bytes": [r.values().tolist() for r in self.transfer_b],
            "queue_depth": self.queue_depth.values().tolist(),
            "samples_total": int(sum(r.total for r in self.decode_s)),
        }


class ClusterState:
    """EWMA, outlier-clipped bandwidth / compute-scale estimate.

    Seeded from a ``ClusterGraph``; each observation moves the estimate by
    ``alpha`` toward the sample, after clipping the sample into
    ``[est / clip, est * clip]`` so a single pathological measurement (GC
    pause, cold cache) cannot capsize the estimate.  Symmetric links: one
    observation updates both directions.
    """

    def __init__(self, cluster, *, alpha: float = 0.3, clip: float = 4.0,
                 suspect_penalty: float = 0.25):
        self.base = cluster
        self.alpha = float(alpha)
        self.clip = float(clip)
        self.suspect_penalty = float(suspect_penalty)
        self.bw = cluster.bw.astype(np.float64).copy()
        self.compute_scale = np.asarray(cluster.compute_scale,
                                        np.float64).copy()
        self.suspected: set[int] = set()  # nodes under heartbeat suspicion
        self.dropped = 0                 # out-of-range samples discarded

    def _ewma(self, est: float, sample: float) -> float:
        if est > 0.0:
            sample = min(max(sample, est / self.clip), est * self.clip)
        return (1.0 - self.alpha) * est + self.alpha * sample

    def observe_bandwidth(self, a: int, b: int, nbytes: float,
                          seconds: float) -> None:
        if seconds <= 0.0 or nbytes <= 0.0:
            return
        self.bw[a, b] = self.bw[b, a] = self._ewma(float(self.bw[a, b]),
                                                   nbytes / seconds)

    def observe_compute(self, node: int, seconds: float,
                        nominal_s: float) -> None:
        """``nominal_s``: expected seconds at compute_scale 1.0."""
        if seconds <= 0.0 or nominal_s <= 0.0:
            return
        self.compute_scale[node] = self._ewma(
            float(self.compute_scale[node]), nominal_s / seconds)

    def fold(self, telemetry: TelemetryStream, node_of_stage,
             dispatcher_node: int = 0) -> int:
        """Fold pending transfer samples into link estimates.

        ``node_of_stage[k]`` hosts stage k; a transfer leaving stage k
        lands on stage k+1's node (the pipeline hop the sample measured).
        A sample whose stage index falls outside the current mapping (a
        recording that outlived a plan change) is dropped and counted in
        ``dropped`` instead of raising.  Returns the number of samples
        drained."""
        samples = telemetry.drain_transfers()
        n = len(node_of_stage)
        for stage, nbytes, seconds in samples:
            if stage < -1 or stage >= n:
                self.dropped += 1
                continue
            if stage + 1 >= n:
                continue               # last stage: no downstream hop
            src = (dispatcher_node if stage < 0 else node_of_stage[stage])
            self.observe_bandwidth(src, node_of_stage[stage + 1], nbytes,
                                   seconds)
        return len(samples)

    def fold_health(self, report: dict, node_of_stage) -> int:
        """Fold a heartbeat detector snapshot (stage -> ``"up"`` /
        ``"suspected"`` / ``"dead"``, see ``HeartbeatMonitor.report``)
        into the estimate: a SUSPECTED stage's node joins ``suspected``
        and its links are penalized at ``as_cluster()`` time, so the
        replanner steers work away from a possibly-stalled node without
        destroying the EWMA estimate (suspicion is reversible — the next
        healthy report clears it).  DEAD stages are *not* penalized here:
        confirmation engages the restore path, which re-places the stage
        outright.  Returns the number of suspected nodes."""
        for k in sorted(report):
            node = node_of_stage[k]
            if report[k] == "suspected":
                self.suspected.add(node)
            else:
                self.suspected.discard(node)
        return len(self.suspected)

    def as_cluster(self):
        """Materialize the current estimate as a ``ClusterGraph``; links
        of heartbeat-suspected nodes are multiplicatively penalized
        (non-destructively — the EWMA estimate itself is untouched)."""
        from repro_torch.core.cluster import ClusterGraph
        bw = self.bw.copy()
        for node in sorted(self.suspected):
            bw[node, :] *= self.suspect_penalty
            bw[:, node] *= self.suspect_penalty
        return ClusterGraph(bw=bw, pos=self.base.pos,
                            labels=self.base.labels,
                            compute_scale=self.compute_scale.copy())
