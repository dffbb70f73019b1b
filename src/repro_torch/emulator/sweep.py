"""Monte-Carlo plan evaluation: (plan x fault-seed x arrival-rate) sweeps.

Evaluates many emulator cells on the fast engines
(``repro_torch.emulator.engine``): fault-free cells run on the vectorized
calendar engine, faulted cells on the flat event engine.  Cross-cell
structure is exploited where it exists — deterministic cells (no arrival
rate, no fault model) are identical across seeds, so they are simulated
once per (plan, rate) and replicated — and within each cell the calendar
engine is itself vectorized over the whole batch trace.

The per-cell metrics are exactly what ``PipelineEmulator`` would have
produced (the emulator equivalence contract), so a sweep is a drop-in
replacement for looping the reference engine — at fleet scale (hundreds of
nodes, 10k+ batch traces, dozens of seeds) where the reference cannot
finish inside a benchmark budget (see BENCH_emulator.json).
"""

from __future__ import annotations

import numpy as np

from .engine import _calendar_run, _stage_constants, simulate
from .faults import effective_cluster
from .pipeline import EmulatorConfig, plan_replicas, plan_stage_args


def evaluate_cells(cluster, nodes, boundary_bytes, compute_flops, *,
                   cfg: EmulatorConfig | None = None,
                   seeds=(0,), arrival_rates=(None,),
                   n_batches: int = 1000, duration_s: float = 1e9,
                   fault_model=None, engine: str = "auto",
                   replicas=None) -> list[dict]:
    """One plan, a grid of (seed x arrival-rate) cells.

    ``seeds`` drive both the Poisson arrival stream (bare seed) and the
    fault schedule (``fault_model.draw(seed, nodes)``, an independent
    stream).  ``replicas`` (per-stage warm replica node lists) is passed
    through to the engine; replicated cells always run on the flat event
    engine (the calendar engine is single-copy only).  Returns one dict
    per cell, in (rate-major, seed-minor) order.
    """
    cfg = cfg or EmulatorConfig()
    cells = []
    det_cache: dict = {}
    for rate in arrival_rates:
        for seed in seeds:
            faults = fault_model.draw(seed, nodes) if fault_model else ()
            deterministic = not faults and not rate
            if deterministic and rate in det_cache:
                m = det_cache[rate]
            else:
                m = simulate(cluster, nodes, boundary_bytes, compute_flops,
                             cfg, n_batches=n_batches, duration_s=duration_s,
                             arrival_rate_hz=rate, faults=faults,
                             rng=int(seed), engine=engine,
                             replicas=replicas)
                if deterministic:
                    det_cache[rate] = m
            cells.append({
                "seed": int(seed),
                "arrival_rate_hz": rate,
                "n_faults": len(faults),
                "completed": m["completed"],
                "throughput_hz": m["throughput_hz"],
                "mean_e2e_s": m["mean_e2e_s"],
                "p95_e2e_s": m["p95_e2e_s"],
                "n_events": len(m["events"]),
            })
    return cells


def aggregate(cells: list[dict], n_batches: int) -> dict:
    """Fleet-level summary of a cell grid (one plan)."""
    if not cells:
        return {"n_cells": 0, "completion_rate": 0.0,
                "throughput_hz_median": 0.0, "mean_e2e_s": float("inf"),
                "p95_e2e_s_worst": float("inf")}
    completed = np.array([c["completed"] for c in cells], dtype=np.float64)
    thr = np.array([c["throughput_hz"] for c in cells], dtype=np.float64)
    mean_e2e = np.array([c["mean_e2e_s"] for c in cells], dtype=np.float64)
    p95 = np.array([c["p95_e2e_s"] for c in cells], dtype=np.float64)
    return {
        "n_cells": len(cells),
        "completion_rate": float(completed.mean() / max(n_batches, 1)),
        "throughput_hz_median": float(np.median(thr)),
        "mean_e2e_s": float(mean_e2e.mean()),
        "p95_e2e_s_worst": float(p95.max()),
    }


def sweep_plan(plan, cluster, *, replication_factors=None, **kw
               ) -> list[dict]:
    """``evaluate_cells`` for a StageExecutionPlan (or SeiferPlan); the
    plan's own warm-replica assignment is passed through.

    ``replication_factors`` (an iterable of ints) additionally grids over
    replication: for each factor R the plan is re-replicated with
    ``repro_torch.core.placement.replicate_bottlenecks(max_replicas=R)`` —
    spending unused spares on copies of the costliest stages, R = 1
    meaning the unreplicated plan — and every cell gains a
    ``replication_factor`` key, concatenated in factor-major order."""
    if replication_factors is None:
        nodes, boundary, flops = plan_stage_args(plan)
        return evaluate_cells(cluster, nodes, boundary, flops,
                              replicas=plan_replicas(plan), **kw)
    from repro_torch.core.placement import replicate_bottlenecks
    if hasattr(plan, "placement"):                       # SeiferPlan
        plan = plan.execution_plan(cluster)
    cells = []
    for r in replication_factors:
        var = (plan if r <= 1
               else replicate_bottlenecks(plan, cluster, max_replicas=r))
        nodes, boundary, flops = plan_stage_args(var)
        for c in evaluate_cells(cluster, nodes, boundary, flops,
                                replicas=plan_replicas(var), **kw):
            c["replication_factor"] = int(r)
            cells.append(c)
    return cells


def _tail(e2e: list[float], submitted: int) -> dict:
    arr = np.array(e2e, dtype=np.float64)
    if arr.size == 0:
        return {"completed": 0, "submitted": submitted,
                "mean_e2e_s": float("inf"), "p50_e2e_s": float("inf"),
                "p95_e2e_s": float("inf"), "p99_e2e_s": float("inf")}
    return {"completed": int(arr.size), "submitted": submitted,
            "mean_e2e_s": float(arr.mean()),
            "p50_e2e_s": float(np.percentile(arr, 50)),
            "p95_e2e_s": float(np.percentile(arr, 95)),
            "p99_e2e_s": float(np.percentile(arr, 99))}


def compare_replan(plan, cluster, *, drift, period_s: float,
                   horizon_s: float, arrival_rate_hz: float,
                   seeds=(0,), cfg: EmulatorConfig | None = None,
                   max_moves: int = 2, min_gain_s: float = 0.0) -> dict:
    """Static plan vs replan-every-``period_s`` on a drifting cluster.

    Quasi-static windowed emulation: the horizon is cut into
    ``horizon_s / period_s`` windows; within each window the cluster is
    frozen at its drifted state (``faults.effective_cluster`` — the
    perfect-telemetry oracle) and the window's Poisson arrivals are run
    through the vectorized calendar engine.  The *static* variant keeps
    the seed plan's placement for every window; the *replan* variant
    calls ``repro_torch.core.replan.incremental_replan`` (diff bounded to
    ``max_moves`` stage moves) at each window boundary against the same
    oracle state, emulating telemetry-driven replanning with one-period
    staleness at most.  Per-window tails are pooled over all seeds and
    windows; batches that never finish under a dead link are counted in
    ``submitted`` but excluded from the latency pool.

    ``plan`` must be a StageExecutionPlan (or SeiferPlan, converted) with
    ``spare_nodes`` — with an empty spare pool the replan variant
    degenerates to static.
    """
    from repro_torch.core.replan import incremental_replan
    cfg = cfg or EmulatorConfig()
    if hasattr(plan, "placement"):                       # SeiferPlan
        plan = plan.execution_plan()
    static_args = plan_stage_args(plan)
    n_windows = int(np.ceil(horizon_s / period_s))

    def window_e2e(eff, args, arrivals) -> np.ndarray:
        nodes, boundary, flops = args
        comp, send = _stage_constants(eff, nodes, boundary, flops, cfg)
        _, e2e = _calendar_run(arrivals, comp, send, np.inf)
        return e2e[np.isfinite(e2e)]

    static_lat: list[float] = []
    replan_lat: list[float] = []
    static_sub = replan_sub = 0
    total_moves = 0
    replan_windows = 0
    for seed in seeds:
        schedule = drift.draw(seed, static_args[0])
        rng = np.random.default_rng(int(seed))
        # one Poisson stream for the whole horizon, split at window edges
        t, arrivals = 0.0, []
        while t < horizon_s:
            arrivals.append(t)
            t += rng.exponential(1.0 / arrival_rate_hz)
        arrivals = np.array(arrivals)
        current = plan
        for w in range(n_windows):
            t0 = w * period_s
            eff = effective_cluster(cluster, schedule, t0)
            sel = (arrivals >= t0) & (arrivals < t0 + period_s)
            local = arrivals[sel] - t0
            res = incremental_replan(current, eff, max_moves=max_moves,
                                     min_gain_s=min_gain_s,
                                     node_flops=cfg.node_flops)
            current = res.plan
            total_moves += len(res.moves)
            replan_windows += bool(res.moves)
            if local.size == 0:
                continue
            static_sub += int(local.size)
            replan_sub += int(local.size)
            static_lat.extend(window_e2e(eff, static_args, local))
            replan_lat.extend(window_e2e(eff, plan_stage_args(current),
                                         local))
    out = {"period_s": period_s, "horizon_s": horizon_s,
           "arrival_rate_hz": arrival_rate_hz, "n_seeds": len(seeds),
           "static": _tail(static_lat, static_sub),
           "replan": _tail(replan_lat, replan_sub)}
    out["replan"]["moves"] = total_moves
    out["replan"]["replanned_windows"] = replan_windows
    return out
