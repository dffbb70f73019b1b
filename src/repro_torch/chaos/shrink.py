"""Minimal-repro reduction of a failing chaos schedule.

Classic delta debugging (Zeller's ddmin) over the case's schedule atoms:
each injected wire fault, each emulator fault, and the stage kill are
independently removable, and the reducer searches for a subset that still
violates an invariant.  Replays are deterministic (every atom is a pure
value and the harness reuses one seeded engine), so the reduction is
reproducible from ``(seed, cid)`` alone.
"""

from __future__ import annotations

from .campaign import ChaosCase, atoms_of, reduced


def ddmin(items: list, fails) -> list:
    """Smallest subset of ``items`` (under chunk removal) for which
    ``fails`` still returns True.  ``fails(items)`` must hold on entry;
    the empty subset is probed too, so a failure independent of the
    schedule reduces all the way to ``[]``."""
    if not fails(items):
        raise ValueError("ddmin needs a failing input to shrink")
    if fails([]):
        return []
    n = 2
    while len(items) >= 2:
        chunk = max(1, (len(items) + n - 1) // n)
        for i in range(0, len(items), chunk):
            trial = items[:i] + items[i + chunk:]
            if trial and fails(trial):
                items, n = trial, max(n - 1, 2)
                break
        else:
            if n >= len(items):
                break
            n = min(n * 2, len(items))
    return items


def shrink_case(case: ChaosCase, case_fails) -> ChaosCase:
    """Reduce a failing case to a minimal failing schedule.

    ``case_fails(case) -> bool`` replays a candidate; the returned case
    keeps only the schedule atoms without which the failure disappears.
    """
    atoms = ddmin(atoms_of(case), lambda a: case_fails(reduced(case, a)))
    return reduced(case, atoms)
