"""Fleet-scale emulator fast path: vectorized event engine.

Two fast engines behind one entry point, :func:`simulate`:

* **calendar** — the fault-free steady-state path.  With unbounded stage
  queues and one-batch-at-a-time links, the reference event loop reduces to
  a pair of Lindley recurrences per stage::

      depart[i]  = fl(max(arrive[i],  depart[i-1])  + compute_s)   # compute
      deliver[i] = fl(max(depart[i],  deliver[i-1]) + transfer_s)  # link

  :func:`lindley_scan` evaluates that recurrence with the *exact* IEEE-754
  operation sequence the reference executes, but vectorized: saturated runs
  are replayed with ``np.add.accumulate`` (a sequential fl-add in C), idle
  runs with one vector add, with doubling block detection of regime
  switches and a scalar fallback when the two regimes thrash.

* **events** — :class:`FlatEventEngine`, used when node/link faults or
  straggler migration are active.  The same discrete-event semantics as the
  reference ``PipelineEmulator``, but as a flat heap of tuples dispatched
  by opcode: no per-event closure/dict allocation, state in flat lists.
  Every handler mirrors its reference counterpart statement for statement,
  including the order events are scheduled in, so heap tie-breaking (the
  global sequence counter) is identical and the two loops are
  step-for-step equivalent.

Both paths are **metrics-identical** to the reference engine — the same
floats, not approximately equal ones.  The contract is pinned by
``tests/data/emulator_equivalence.json`` over the scenario grid in
``repro_torch.emulator.equivalence`` and property-tested in
the port's ``tests/test_torch_emulator.py``, which also holds both
engines to the reference's on the same inputs.  LOCKSTEP OBLIGATION: any
semantic change to ``pipeline.PipelineEmulator`` must land here in the
same change (and vice versa); the fixture is the reference's and is never
re-pinned by the port.
"""

from __future__ import annotations

import itertools
from collections import deque
from heapq import heappop, heappush

import numpy as np

from repro_torch.core.cluster import ClusterGraph
from .faults import (EffectLedger, FaultInjector, LinkDegrade, LinkFault,
                     NodeFault, NodeSlowdown, WireLoss, _WireRec, link_key)
from .pipeline import EmulatorConfig, PipelineEmulator, summarize

__all__ = ["lindley_scan", "poisson_arrivals", "simulate", "FlatEventEngine"]


# ---------------------------------------------------------------------------
# exact vectorized Lindley recurrence
# ---------------------------------------------------------------------------

def lindley_scan(a: np.ndarray, c: float) -> np.ndarray:
    """``d[i] = fl(max(a[i], d[i-1]) + c)`` with ``d[-1] = -inf``.

    Bit-identical to the sequential scalar evaluation (``np.add.accumulate``
    performs the same left-to-right fl-adds; ``max`` selects, never
    rounds), but vectorized over maximal single-regime blocks:

    * saturated (``a[i] <= d[i-1]``): repeated fl-addition of ``c``,
      replayed by ``add.accumulate`` seeded with the running value;
    * idle/reset (``a[i] > d[i-1]``): ``d[i] = a[i] + c``, one vector add.

    Blocks are grown by doubling; if the regimes alternate so often that
    block detection stops paying (> n/16 switches), the remainder runs as a
    plain scalar loop — still allocation-free per element.
    """
    n = a.size
    d = np.empty(n)
    i = 0
    prev = -np.inf
    nswitch = 0
    while i < n:
        if nswitch * 16 > n and n - i > 64:    # regime thrash: finish scalar
            out = []
            ap = out.append
            p = prev
            for x in a[i:].tolist():
                if x < p:
                    x = p
                p = x + c
                ap(p)
            d[i:] = out
            return d
        if a[i] < prev:                        # saturated block
            chunk = 64
            while True:
                hi = min(n, i + chunk)
                t = np.add.accumulate(
                    np.concatenate(([prev], np.full(hi - i, c))))
                bad = a[i:hi] > t[:-1]         # arrival overtakes the server
                j = int(np.argmax(bad)) if bad.any() else -1
                if j >= 0:
                    d[i:i + j] = t[1:j + 1]
                    if j > 0:
                        prev = t[j]
                    i += j
                    nswitch += 1
                    break
                d[i:hi] = t[1:]
                prev = t[-1]
                i = hi
                if i >= n:
                    break
                chunk *= 2
        else:                                  # idle/reset block
            chunk = 64
            while True:
                hi = min(n, i + chunk)
                r = a[i:hi] + c
                bad = a[i + 1:hi] < r[:hi - i - 1]   # server overtakes arrivals
                j = int(np.argmax(bad)) if bad.any() else -1
                if j >= 0:
                    d[i:i + j + 1] = r[:j + 1]
                    prev = r[j]
                    i += j + 1
                    nswitch += 1
                    break
                d[i:hi] = r
                prev = r[-1]
                i = hi
                if i >= n or a[i] < prev:      # end, or regime flips at edge
                    nswitch += 1
                    break
                chunk *= 2
    return d


def poisson_arrivals(n_batches: int, arrival_rate_hz: float | None,
                     rng: np.random.Generator) -> np.ndarray:
    """The reference engine's arrival stream, batched: ``t=0`` for all
    batches without a rate, else the same Poisson process
    (``t += rng.exponential(1/rate)`` per batch — one draw *per submitted
    batch*, accumulated with sequential fl-adds, which is exactly what the
    size-``n`` draw + ``add.accumulate`` reproduce)."""
    if n_batches == 0:
        return np.zeros(0)
    if not arrival_rate_hz:
        return np.zeros(n_batches)
    draws = rng.exponential(1.0 / arrival_rate_hz, size=n_batches)
    return np.add.accumulate(np.concatenate(([0.0], draws[:-1])))


# ---------------------------------------------------------------------------
# calendar path (fault-free)
# ---------------------------------------------------------------------------

def _stage_constants(cluster, nodes, boundary_bytes, compute_flops, cfg):
    """Per-stage (compute_s, transfer_s) with the reference's float ops."""
    comp = []
    for k in range(len(boundary_bytes) + 1):
        if k == 0:
            comp.append(0.0)
        else:
            comp.append(compute_flops[k - 1] / cfg.node_flops
                        / cluster.compute_scale[nodes[k]])
    send = []
    for k in range(len(boundary_bytes)):
        bw = cluster.bw[nodes[k], nodes[k + 1]]
        send.append(boundary_bytes[k] / bw if bw > 0 else np.inf)
    return comp, send


def _calendar_run(arrivals, comp, send, duration_s):
    """Advance the whole batch trace stage by stage (two scans per stage)."""
    a = arrivals
    d = a
    for k in range(len(comp)):
        d = lindley_scan(a, comp[k])
        if k < len(send):
            a = lindley_scan(d, send[k])
    keep = d <= duration_s
    return d[keep], (d - arrivals)[keep]


# ---------------------------------------------------------------------------
# flat event engine (faults / straggler migration)
# ---------------------------------------------------------------------------

# opcodes (heap tuples: (time, seq, OP, *args); seq is globally unique so
# payloads are never compared — which also makes replica *records* safe to
# carry in event tuples)
_ARRIVE, _DONE, _RETRY, _DELIVER = 0, 1, 2, 3
_KILL, _REVIVE, _RESCHED, _DROP, _RESTORE, _SWEEP = 4, 5, 6, 7, 8, 9
_DEGRADE, _UNDEGRADE, _SLOW, _UNSLOW = 10, 11, 12, 13
_WIRELOSS, _UNWIRELOSS = 14, 15


class _Rep:
    """Flat mirror of the reference engine's ``_Replica`` pod record (no
    per-event allocation: all records are created at init / reschedule
    keeps them)."""

    __slots__ = ("node", "comp_s", "busy", "sending", "tok", "inbox",
                 "outbox", "unacked", "svc", "inflight")

    def __init__(self, node, comp_s):
        self.node = node
        self.comp_s = comp_s
        self.busy = False
        self.sending = False
        self.tok = 0
        self.inbox = deque()
        self.outbox = deque()
        self.unacked = None
        self.svc = []
        self.inflight = 0


class FlatEventEngine:
    """Reference-identical event loop without per-event closures.

    Mirrors ``PipelineEmulator`` handler for handler (see the lockstep
    obligation in the module docstring).  The cluster's bandwidth matrix is
    copied, so link faults never mutate the caller's cluster."""

    def __init__(self, cluster: ClusterGraph, nodes, boundary_bytes,
                 compute_flops, cfg: EmulatorConfig | None = None,
                 replicas=None):
        self.cfg = cfg or EmulatorConfig()
        self.cluster = cluster
        self.n_parts = len(boundary_bytes)
        self.nodes = list(nodes)
        self.flops = [0.0] + list(compute_flops)
        self.out_bytes = list(boundary_bytes) + [0.0]
        self.replicas = ([list(r) for r in replicas] if replicas
                         else [[] for _ in range(self.n_parts)])

    def run(self, arrivals: np.ndarray, duration_s: float,
            faults=()) -> dict:
        cfg = self.cfg
        cluster = self.cluster
        # fresh copies per run: a link fault still down (or a node slowdown
        # still active) at end-of-run must not leak into the next run (or
        # into the caller's cluster)
        scale = cluster.compute_scale.copy()
        bwmat = cluster.bw.copy()
        links = EffectLedger()
        slows = EffectLedger()
        wire: dict = {}            # link_key -> active _WireRec
        n_stages = self.n_parts + 1
        last = n_stages - 1
        n_batches = arrivals.size
        node_flops = cfg.node_flops
        retry_s = cfg.retry_s
        resched_delay = cfg.detection_s + cfg.reschedule_s

        flops = self.flops
        out_bytes = self.out_bytes
        reps: list[list[_Rep]] = []
        for k in range(n_stages):
            cs = (0.0 if flops[k] == 0.0
                  else flops[k] / node_flops / scale[self.nodes[k]])
            rl = [_Rep(self.nodes[k], cs)]
            if k > 0:
                for rn in self.replicas[k - 1]:
                    rl.append(_Rep(rn, 0.0 if flops[k] == 0.0
                                   else flops[k] / node_flops / scale[rn]))
            reps.append(rl)
        rep_nodes = {r.node for rl in reps for r in rl}
        down: set[int] = set()
        spares = [n for n in range(cluster.n) if n not in rep_nodes]
        epoch = [0] * cluster.n
        completed_t: list[float] = []
        completed_e: list[float] = []
        log: list[tuple[float, str]] = []

        q: list[tuple] = []
        cnt = itertools.count().__next__
        now = 0.0

        # -- handler helpers (defined once; no per-event allocation) --------
        def pick(k):
            # join-shortest-queue over up replicas, first minimum in slot
            # order (mirrors the reference's _pick_replica)
            rl = reps[k]
            cand = [r for r in rl if r.node not in down] or rl
            best = cand[0]
            bd = len(best.inbox) + (1 if best.busy else 0) + best.inflight
            for r in cand[1:]:
                d = len(r.inbox) + (1 if r.busy else 0) + r.inflight
                if d < bd:
                    best, bd = r, d
            return best

        def enqueue(k, bid):
            r = pick(k)
            r.inbox.append(bid)
            try_start(k, r)

        def try_start(k, rep):
            if rep.busy or not rep.inbox or rep.node in down:
                return
            rep.busy = True
            rep.tok += 1
            nd = rep.node
            heappush(q, (now + rep.comp_s, cnt(), _DONE, k, rep,
                         rep.inbox.popleft(), now, nd, epoch[nd], rep.tok))

        def attempt(k, rep, bid):
            if rep not in reps[k]:
                # sender slot dissolved while a retry was pending: its
                # unacked batch was already re-routed at kill time
                return
            rep2 = pick(k + 1)                 # route at send time (JSQ)
            src, dst = rep.node, rep2.node
            bwv = 0.0 if (src in down or dst in down) else bwmat[src, dst]
            if bwv <= 0:
                heappush(q, (now + retry_s, cnt(), _RETRY, k, rep, bid))
                return
            wrec = wire.get(link_key(src, dst))
            if wrec is not None and wrec.lost():
                # frame lost on the unreliable wire: it still occupied the
                # link for the transfer duration, then the sender's
                # reconnect loop retransmits (the ack never arrived)
                log.append((now, f"wire ({src},{dst}) frame LOST — "
                                 "retransmit"))
                # parenthesized like the reference's after(dur + retry_s):
                # fl(now + fl(dur + retry_s)), not fl(fl(now + dur) + retry_s)
                heappush(q, (now + (out_bytes[k] / bwv + retry_s), cnt(),
                             _RETRY, k, rep, bid))
                return
            rep2.inflight += 1
            heappush(q, (now + out_bytes[k] / bwv, cnt(), _DELIVER, k, rep,
                         rep2, bid, src, dst, epoch[src], epoch[dst]))

        def pump(k, rep):
            if rep.sending or not rep.outbox:
                return
            rep.sending = True
            rep.unacked = rep.outbox.popleft()
            attempt(k, rep, rep.unacked)

        def set_scale(nd, eff):
            # mirrors FaultInjector._set_scale: in-flight computes keep the
            # service time they were scheduled with; later starts pay the
            # new rate (the _DONE events already in the heap are unchanged)
            scale[nd] = eff
            for k in range(n_stages):
                for r in reps[k]:
                    if r.node == nd:
                        r.comp_s = (0.0 if flops[k] == 0.0
                                    else flops[k] / node_flops / scale[nd])

        def release(nd):
            if (nd not in down and nd not in spares
                    and all(r.node != nd for rl in reps for r in rl)):
                spares.append(nd)

        def do_reschedule(k, rep, straggler):
            if not straggler and rep.node not in down:
                log.append((now, f"stage {k}: node {rep.node} recovered "
                                 f"before reschedule; pod kept in place"))
                try_start(k, rep)
                return
            if not spares:
                log.append((now,
                            f"stage {k}: NO SPARE NODE — pipeline stalled"))
                return
            best, best_score = None, -np.inf   # max() keeps the first maximum
            for s in spares:
                sc = 0.0
                if k > 0:
                    sc += bwmat[reps[k - 1][0].node, s]
                if k < last:
                    sc += bwmat[s, reps[k + 1][0].node]
                if sc > best_score:
                    best, best_score = s, sc
            spares.remove(best)
            old = rep.node
            rep.node = best
            rep.comp_s = (0.0 if flops[k] == 0.0
                          else flops[k] / node_flops / scale[best])
            rep.svc.clear()
            rep.busy = False
            log.append((now, f"stage {k}: pod rescheduled {old} -> {best}"))
            release(old)
            try_start(k, rep)

        # -- initial schedule: faults, straggler arm, arrivals (the order
        #    the reference sees: injector first, then run()) ----------------
        for fi, f in enumerate(faults):
            if isinstance(f, NodeFault):
                heappush(q, (max(f.time_s, 0.0), cnt(), _KILL, f.node))
                if f.recover_after_s is not None:
                    heappush(q, (max(f.time_s + f.recover_after_s, 0.0),
                                 cnt(), _REVIVE, f.node))
            elif isinstance(f, LinkFault):
                heappush(q, (max(f.time_s, 0.0), cnt(), _DROP, fi))
            elif isinstance(f, LinkDegrade):
                heappush(q, (max(f.time_s, 0.0), cnt(), _DEGRADE, fi))
            elif isinstance(f, NodeSlowdown):
                heappush(q, (max(f.time_s, 0.0), cnt(), _SLOW, fi))
            elif isinstance(f, WireLoss):
                heappush(q, (max(f.time_s, 0.0), cnt(), _WIRELOSS, fi))
            else:
                raise TypeError(f)
        if cfg.enable_straggler_migration:
            heappush(q, (cfg.straggler_check_s, cnt(), _SWEEP))
        for bid in range(n_batches):
            heappush(q, (max(arrivals[bid], 0.0), cnt(), _ARRIVE, bid))

        # -- dispatch --------------------------------------------------------
        while q and q[0][0] <= duration_s:
            ev = heappop(q)
            now = ev[0]
            op = ev[2]
            if op == _DONE:
                k, rep, bid, t0c, nd, ep, tok = ev[3:10]
                current = tok == rep.tok
                if current:
                    rep.busy = False
                if epoch[nd] != ep:            # host died mid-compute
                    if rep in reps[k]:
                        rep.inbox.appendleft(bid)
                        if current:
                            try_start(k, rep)
                    else:
                        # slot dissolved: warm survivors absorb the batch
                        enqueue(k, bid)
                    continue
                if current and k > 0:
                    rep.svc.append(now - t0c)
                if k == last:
                    completed_t.append(now)
                    completed_e.append(now - arrivals[bid])
                else:                          # _send
                    rep.outbox.append(bid)
                    pump(k, rep)
                if current:
                    try_start(k, rep)
            elif op == _DELIVER:
                k, rep, rep2, bid, src, dst, es, ed = ev[3:11]
                rep2.inflight -= 1
                if rep not in reps[k]:
                    continue                   # sender slot dissolved
                if (epoch[src] != es or epoch[dst] != ed
                        or rep.node != src or rep2 not in reps[k + 1]
                        or rep2.node != dst):
                    heappush(q, (now + retry_s, cnt(), _RETRY, k, rep, bid))
                    continue
                rep.unacked = None
                rep.sending = False
                rep2.inbox.append(bid)         # _enqueue + ack
                try_start(k + 1, rep2)
                pump(k, rep)
            elif op == _ARRIVE:
                enqueue(0, ev[3])
            elif op == _RETRY:
                attempt(ev[3], ev[4], ev[5])
            elif op == _KILL:
                nd = ev[3]
                down.add(nd)
                epoch[nd] += 1
                if nd in spares:
                    spares.remove(nd)
                log.append((now, f"node {nd} FAILED"))
                for k in range(n_stages):
                    for rep in [r for r in reps[k] if r.node == nd]:
                        survivors = [r for r in reps[k] if r is not rep
                                     and r.node not in down]
                        if survivors:
                            # warm-spare failover: dissolve the slot, hand
                            # its queued work to the survivors, no restore
                            reps[k].remove(rep)
                            log.append((
                                now, f"stage {k}: replica on node {nd} LOST "
                                f"({len(survivors)} survivor(s), "
                                f"no restore)"))
                            moved = ([rep.unacked]
                                     if rep.unacked is not None else [])
                            moved += list(rep.outbox) + list(rep.inbox)
                            for bid in moved:
                                enqueue(k, bid)
                        else:
                            heappush(q, (now + resched_delay, cnt(),
                                         _RESCHED, k, rep))
            elif op == _REVIVE:
                nd = ev[3]
                down.discard(nd)
                log.append((now, f"node {nd} recovered"))
                hosted = [(k, r) for k in range(n_stages)
                          for r in reps[k] if r.node == nd]
                if hosted:
                    for k, r in hosted:
                        try_start(k, r)
                else:
                    release(nd)
            elif op == _RESCHED:
                do_reschedule(ev[3], ev[4], False)
            elif op == _DROP:
                fi = ev[3]
                f = faults[fi]
                eff = links.push(link_key(f.a, f.b),
                                 float(bwmat[f.a, f.b]), fi, 0.0)
                bwmat[f.a, f.b] = bwmat[f.b, f.a] = eff
                log.append((now, f"link ({f.a},{f.b}) DOWN"))
                heappush(q, (now + f.duration_s, cnt(), _RESTORE, fi))
            elif op == _RESTORE:
                f = faults[ev[3]]
                eff = links.pop(link_key(f.a, f.b), ev[3])
                bwmat[f.a, f.b] = bwmat[f.b, f.a] = eff
                log.append((now, f"link ({f.a},{f.b}) restored"))
            elif op == _DEGRADE:
                fi = ev[3]
                f = faults[fi]
                eff = links.push(link_key(f.a, f.b),
                                 float(bwmat[f.a, f.b]), fi, f.factor)
                bwmat[f.a, f.b] = bwmat[f.b, f.a] = eff
                log.append((now, f"link ({f.a},{f.b}) degraded "
                                 f"x{f.factor:g}"))
                if f.duration_s is not None:
                    heappush(q, (now + f.duration_s, cnt(), _UNDEGRADE, fi))
            elif op == _UNDEGRADE:
                f = faults[ev[3]]
                eff = links.pop(link_key(f.a, f.b), ev[3])
                bwmat[f.a, f.b] = bwmat[f.b, f.a] = eff
                log.append((now, f"link ({f.a},{f.b}) drift cleared"))
            elif op == _SLOW:
                fi = ev[3]
                f = faults[fi]
                set_scale(f.node, slows.push(f.node, float(scale[f.node]),
                                             fi, f.factor))
                log.append((now, f"node {f.node} slowdown x{f.factor:g}"))
                if f.duration_s is not None:
                    heappush(q, (now + f.duration_s, cnt(), _UNSLOW, fi))
            elif op == _UNSLOW:
                f = faults[ev[3]]
                set_scale(f.node, slows.pop(f.node, ev[3]))
                log.append((now, f"node {f.node} slowdown cleared"))
            elif op == _WIRELOSS:
                fi = ev[3]
                f = faults[fi]
                wire[link_key(f.a, f.b)] = _WireRec(f)
                log.append((now, f"wire ({f.a},{f.b}) loss "
                                 f"x{f.loss_rate:g} ON"))
                if f.duration_s is not None:
                    heappush(q, (now + f.duration_s, cnt(), _UNWIRELOSS, fi))
            elif op == _UNWIRELOSS:
                f = faults[ev[3]]
                wire.pop(link_key(f.a, f.b), None)
                log.append((now, f"wire ({f.a},{f.b}) loss cleared"))
            elif op == _SWEEP:
                pods = [(k, r) for k in range(1, n_stages) for r in reps[k]]
                vals = [np.mean(r.svc[-5:]) for _, r in pods if r.svc]
                med = np.median(vals) if vals else None
                if med:
                    for k, r in pods:
                        if (r.svc and spares
                                and np.mean(r.svc[-5:])
                                > cfg.straggler_factor * med):
                            log.append((now, f"stage {k}: straggler on node "
                                             f"{r.node}, migrating"))
                            do_reschedule(k, r, True)
                if len(completed_t) < n_batches:
                    heappush(q, (now + cfg.straggler_check_s, cnt(), _SWEEP))

        return summarize(np.array(completed_t), np.array(completed_e), log)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def simulate(cluster: ClusterGraph, nodes, boundary_bytes, compute_flops,
             cfg: EmulatorConfig | None = None, *,
             n_batches: int, duration_s: float,
             arrival_rate_hz: float | None = None,
             faults=(), rng: np.random.Generator | int = 0,
             engine: str = "auto", replicas=None) -> dict:
    """Emulate one plan; metrics-identical to ``PipelineEmulator``.

    ``faults`` is a declarative list of :class:`NodeFault` /
    :class:`LinkFault` / :class:`LinkDegrade` / :class:`NodeSlowdown` /
    :class:`WireLoss`
    (the reference wires the same list through ``FaultInjector`` *before*
    ``run`` — event ordering replicates that).  ``replicas`` lists warm
    replica node ids per partition (JSQ-routed pods; see the replication
    contract in ROADMAP.md).  Engines:

    * ``"auto"`` — calendar when fault-free (no faults, no straggler
      migration, every pipeline link up) *and* single-copy, else events
      (a replicated stage's parallel service has no Lindley form);
    * ``"calendar"`` / ``"events"`` — force a fast path;
    * ``"reference"`` — the closure-based reference loop (on a
      bandwidth-copied cluster, so callers never see fault mutations).
    """
    cfg = cfg or EmulatorConfig()
    replicated = any(replicas) if replicas else False
    if engine == "reference":
        # bw AND compute_scale are copied: link faults and node slowdowns
        # mutate them, and the caller's cluster must never see that
        ref_cluster = ClusterGraph(bw=cluster.bw.copy(), pos=cluster.pos,
                                   labels=cluster.labels,
                                   compute_scale=cluster.compute_scale.copy())
        emu = PipelineEmulator(ref_cluster, nodes, boundary_bytes,
                               compute_flops, cfg, rng, replicas=replicas)
        if faults:
            FaultInjector(emu).schedule(faults)
        return emu.run(n_batches, duration_s, arrival_rate_hz)

    gen = np.random.default_rng(rng) if isinstance(rng, int) else rng
    arrivals = poisson_arrivals(n_batches, arrival_rate_hz, gen)
    comp, send = _stage_constants(cluster, nodes, boundary_bytes,
                                  compute_flops, cfg)
    if engine == "auto":
        fault_free = (not faults and not cfg.enable_straggler_migration
                      and not replicated
                      and all(np.isfinite(s) for s in send))
        engine = "calendar" if fault_free else "events"
    if engine == "calendar":
        if faults or cfg.enable_straggler_migration or replicated:
            raise ValueError("calendar engine is fault-free, "
                             "single-copy only")
        times, e2e = _calendar_run(arrivals, comp, send, duration_s)
        return summarize(times, e2e, [])
    if engine == "events":
        return FlatEventEngine(cluster, nodes, boundary_bytes, compute_flops,
                               cfg, replicas=replicas
                               ).run(arrivals, duration_s, faults)
    raise ValueError(f"unknown engine {engine!r}")
