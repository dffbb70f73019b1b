"""Color-coding k-path (Alon, Yuster & Zwick 1995) — paper Algorithm 2's core.

Finds a simple path visiting exactly ``k`` vertices in an undirected graph,
optionally with fixed endpoints and a restricted set of usable vertices.

Implementation notes (beyond-paper engineering, documented in DESIGN.md §8):
  * trials are batched and vectorized with numpy: dp[S] is a (T, n) boolean
    array ("some colorful path with color-set S ends at v in trial t");
    transitions are batched boolean matmuls, so a batch of 64 trials costs
    2^k * k matmuls of (T, n) x (n, n).  The float32 staging buffers for the
    matmuls are preallocated once per call and reused across subsets/batches.
  * adaptive early exit: feasible instances almost always succeed in the
    first batch on the dense graphs the paper targets (complete WiFi
    clusters, TPU cliques); infeasible instances pay the full trial budget,
    so callers binary-searching a threshold see conservative 'False's with
    probability <= exp(-trials/e^k).  Callers that can *prove* infeasibility
    (union-find bounds, see placement.py) skip the DP entirely via
    :func:`replay_infeasible`, which burns the exact same rng draws so the
    shared stream — and therefore every downstream plan — stays bit-identical.
  * k > KMAX_EXACT falls back to a greedy maximin insertion + 2-opt repair
    heuristic (the paper caps k <= 4 and never needs this; our 405B pipeline
    placements can need k ~ 14).  With ``weights`` given, each extension
    takes the maximin-bandwidth admissible edge and dead ends are repaired
    by maximin insertion / suffix reversal.
"""

from __future__ import annotations

import math

import numpy as np

KMAX_COLOR = 12          # color-coding DP beyond this is not worth 2^k cost
_DEF_BATCH = 64
_GREEDY_RESTARTS = 32


def _trial_budget(k: int) -> int:
    # e^k trials give ~63% success for a single existing path; 3e^k => ~95%.
    return max(1, min(int(math.ceil(3 * math.e ** min(k, 9))), 25000))


def find_k_path(adj: np.ndarray, k: int, start: int | None = None,
                end: int | None = None, avail: np.ndarray | None = None,
                rng: np.random.Generator | int = 0,
                max_trials: int | None = None,
                weights: np.ndarray | None = None) -> list[int] | None:
    """Return a list of ``k`` distinct vertices forming a path, or None.

    adj    -- (n, n) boolean adjacency (symmetric, no self loops required)
    start  -- required first vertex (or None = free)
    end    -- required last vertex (or None = free)
    avail  -- boolean mask of vertices allowed on the path (must include
              start/end if given); default all.
    weights-- optional (n, n) edge weights steering the k > KMAX_COLOR greedy
              fallback toward maximin-bandwidth paths (ignored by the exact
              color-coding DP, whose answer is weight-independent).
    """
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    n = adj.shape[0]
    avail = np.ones(n, dtype=bool) if avail is None else avail.astype(bool).copy()
    if start is not None:
        avail[start] = True
    if end is not None:
        avail[end] = True
    if int(avail.sum()) < k:
        return None

    # ---- trivial sizes ----------------------------------------------------
    if k <= 0:
        return []
    if k == 1:
        if start is not None and end is not None and start != end:
            return None
        v = start if start is not None else (end if end is not None else
                                             int(np.flatnonzero(avail)[0]))
        return [v]
    if k == 2:
        return _two_path(adj, start, end, avail)

    if k > KMAX_COLOR:
        return _greedy_maximin_path(adj, k, start, end, avail, rng, weights)

    # ---- color-coding DP ----------------------------------------------------
    budget = max_trials if max_trials is not None else _trial_budget(k)
    batch = min(_DEF_BATCH, budget)
    adj_b = (adj & avail[None, :] & avail[:, None]).astype(np.float32)
    ws = _Workspace(batch, n)
    done = 0
    while done < budget:
        t = min(batch, budget - done)
        path = _color_trial_batch(adj, adj_b, k, start, end, avail, rng, t,
                                  ws, chunk_first=done == 0)
        done += t
        if path is not None:
            return path
    return None


def replay_infeasible(adj_n: int, k: int, start: int | None,
                      end: int | None, avail: np.ndarray | None,
                      rng: np.random.Generator,
                      max_trials: int | None = None) -> None:
    """Consume exactly the rng draws a *failing* :func:`find_k_path` call
    would have made, without doing any of its work.

    Callers who have proved no k-path exists (e.g. placement.py's union-find
    feasibility curve) use this instead of the full search.  The planner's
    equivalence contract (ROADMAP) requires plans to be bit-identical to the
    unpruned code path, and successive searches share one rng stream — so a
    skipped search must still advance the stream by the same amount.  Keep
    this in lockstep with find_k_path / _greedy_maximin_path /
    _color_trial_batch whenever their rng usage changes
    (tests/test_threshold_search.py cross-checks).
    """
    n = adj_n
    avail = np.ones(n, dtype=bool) if avail is None else avail.astype(bool).copy()
    if start is not None:
        avail[start] = True
    if end is not None:
        avail[end] = True
    if int(avail.sum()) < k:
        return                          # find_k_path bails before any draw
    if k <= 2:
        return                          # trivial sizes never touch the rng
    if k > KMAX_COLOR:
        nodes = np.flatnonzero(avail)
        for _ in range(_GREEDY_RESTARTS):   # every restart of a failed greedy
            rng.permutation(nodes)          # draws exactly one permutation
        return
    budget = max_trials if max_trials is not None else _trial_budget(k)
    batch = min(_DEF_BATCH, budget)
    done = 0
    while done < budget:                    # one colors draw per batch
        t = min(batch, budget - done)
        done += t
        rng.integers(0, k, size=(t, n))


def _two_path(adj, start, end, avail):
    n = adj.shape[0]
    ok = adj & avail[None, :] & avail[:, None]
    if start is not None and end is not None:
        return [start, end] if ok[start, end] else None
    if start is not None:
        js = np.flatnonzero(ok[start])
        return [start, int(js[0])] if len(js) else None
    if end is not None:
        js = np.flatnonzero(ok[:, end])
        return [int(js[0]), end] if len(js) else None
    idx = np.argwhere(np.triu(ok, 1))
    return [int(idx[0][0]), int(idx[0][1])] if len(idx) else None


class _Workspace:
    """Reusable staging buffers for the batched DP transitions."""

    def __init__(self, batch: int, n: int) -> None:
        self.cur_f = np.empty((batch, n), dtype=np.float32)
        self.reach_f = np.empty((batch, n), dtype=np.float32)
        self.nxt = np.empty((batch, n), dtype=bool)


_SUBSET_ORDER: dict[int, list[int]] = {}


def _subset_order(k: int) -> list[int]:
    order = _SUBSET_ORDER.get(k)
    if order is None:
        full = (1 << k) - 1
        order = _SUBSET_ORDER[k] = sorted(range(1, full + 1),
                                          key=lambda s: s.bit_count())
    return order


_EVAL_CHUNK = 8         # leading sub-chunk evaluated before the batch rest


def _color_trial_batch(adj, adj_f32, k, start, end, avail, rng, t,
                       ws: _Workspace | None = None, chunk_first=False):
    """One batch of ``t`` random colorings; returns a path or None.

    The colorings are drawn in a single rng call (the stream is part of the
    planner's equivalence contract), but with ``chunk_first`` the DP is
    evaluated lazily: trials are independent and the hit selection is
    earliest-trial-first, so running the DP on a small leading chunk first
    returns the identical path while a feasible dense instance — the common
    case, which succeeds within the first few trials of the first batch —
    pays ~1/8th of the matmuls.  Only the probe's first batch is chunked:
    later batches belong to hard/infeasible instances where the extra
    subset-loop pass would be pure overhead.
    """
    n = adj.shape[0]
    colors = rng.integers(0, k, size=(t, n))
    if start is not None:
        # WLOG recolor the fixed start to color 0 (keeps uniformity of the rest)
        colors[:, start] = 0
    bounds = [0, _EVAL_CHUNK, t] if chunk_first and t > _EVAL_CHUNK else [0, t]
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        path = _color_dp(adj, adj_f32, k, start, end, avail,
                         colors[c0:c1], ws)
        if path is not None:
            return path
    return None


def _color_dp(adj, adj_f32, k, start, end, avail, colors,
              ws: _Workspace | None = None):
    """The color-coding DP over one block of colorings."""
    t, n = colors.shape
    cmask = np.stack([(colors == c) & avail[None, :] for c in range(k)])  # (k,t,n)

    full = (1 << k) - 1
    # dense table: dp[S] all-False == the old list's None (never reached)
    dp = np.zeros((1 << k, t, n), dtype=bool)
    if start is not None:
        dp[1 << 0, :, start] = True
    else:
        for c in range(k):
            dp[1 << c] = cmask[c]

    ws = ws or _Workspace(t, n)
    cur_f, reach_f, nxt = ws.cur_f[:t], ws.reach_f[:t], ws.nxt[:t]
    for S in _subset_order(k):
        if S == full:
            continue
        cur = dp[S]
        if not cur.any():
            continue
        np.copyto(cur_f, cur)                                    # bool -> f32
        np.matmul(cur_f, adj_f32, out=reach_f)
        reach = reach_f > 0                                      # (t, n)
        for c in range(k):
            if S >> c & 1:
                continue
            np.logical_and(reach, cmask[c], out=nxt)
            dp[S | (1 << c)] |= nxt

    final = dp[full]
    if end is not None:
        hits = np.flatnonzero(final[:, end])
        if not len(hits):
            return None
        trial = int(hits[0]); last = end
    else:
        ts, vs = np.nonzero(final)
        if not len(ts):
            return None
        trial = int(ts[0]); last = int(vs[0])
    return _reconstruct(adj, dp, colors[trial], k, trial, last, avail)


def _reconstruct(adj, dp, colors, k, trial, last, avail):
    """Walk the DP table backwards to emit the actual vertex sequence."""
    path = [last]
    S = (1 << k) - 1
    cur = last
    for _ in range(k - 1):
        S2 = S & ~(1 << int(colors[cur]))
        prev_tab = dp[S2]
        cand = np.flatnonzero(prev_tab[trial] & adj[:, cur] & avail)
        # cand can contain the current vertex only if colors differ; colorful
        # paths guarantee distinctness, pick any witness.
        cur = int(cand[0])
        path.append(cur)
        S = S2
    path.reverse()
    return path


# ---------------------------------------------------------------------------
# Long-path fallback (k > KMAX_COLOR): greedy maximin insertion + 2-opt repair.
# ---------------------------------------------------------------------------

def _greedy_maximin_path(adj, k, start, end, avail, rng,
                         weights: np.ndarray | None = None,
                         restarts: int = _GREEDY_RESTARTS) -> list[int] | None:
    """Greedy maximin path: extend along the highest-weight admissible edge;
    on a dead end, repair by maximin *insertion* of an unused vertex between
    adjacent path vertices; if the required ``end`` is unreachable from the
    tail, repair with a 2-opt suffix reversal that maximizes the weaker of
    the two rewired edges.  Without ``weights`` all edges tie and the
    extension degenerates to first-admissible (the pre-maximin behavior).

    rng contract: exactly one ``rng.permutation`` per restart, nothing else —
    :func:`replay_infeasible` depends on it.
    """
    w = weights if weights is not None else adj.astype(np.float64)
    nodes = np.flatnonzero(avail)
    for attempt in range(restarts):
        order = list(rng.permutation(nodes))
        if start is None and end is not None and order[-1] == end:
            # the free head seed comes from order.pop(); it must not be the
            # pinned tail or `end` would appear twice (rotate, no rng drawn)
            order.insert(0, order.pop())
        path = [start] if start is not None else [int(order.pop())]
        if start is not None and start in order:
            order.remove(start)
        if end is not None and end in order:
            order.remove(end)
        target = k - (1 if end is not None else 0)
        ok = True
        while len(path) < target:
            tail = path[-1]
            nxts = [v for v in order if adj[tail, v]]
            if nxts:
                # maximin step: the extension edge is the path's new weakest
                # link candidate, so grab the strongest one (ties keep the
                # permutation's first, matching the unweighted behavior)
                v = int(max(nxts, key=lambda u: w[tail, u]))
                path.append(v)
                order.remove(v)
                continue
            # dead end: 2-opt style repair — splice an unused vertex into the
            # edge where it keeps the path's min weight highest
            best = None
            for v in order:
                for idx in range(len(path) - 1):
                    if adj[path[idx], v] and adj[v, path[idx + 1]]:
                        score = min(w[path[idx], v], w[v, path[idx + 1]])
                        if best is None or score > best[0]:
                            best = (score, v, idx)
            if best is None:
                ok = False
                break
            _, v, idx = best
            path.insert(idx + 1, v)
            order.remove(v)
        if not ok:
            continue
        if end is not None:
            if adj[path[-1], end]:
                path.append(end)
            else:
                # 2-opt repair: reverse a suffix so the tail reaches ``end``;
                # needs adj[path[i], path[-1]] (new internal edge) and
                # adj[path[i+1], end] (new tail edge)
                best = None
                tail = path[-1]
                for idx in range(len(path) - 2, -1, -1):
                    if adj[path[idx], tail] and adj[path[idx + 1], end]:
                        score = min(w[path[idx], tail], w[path[idx + 1], end])
                        if best is None or score > best[0]:
                            best = (score, idx)
                if best is None:
                    continue
                idx = best[1]
                path[idx + 1:] = path[:idx:-1]   # reverse the suffix
                path.append(end)
        if len(path) == k:
            return path
    return None
