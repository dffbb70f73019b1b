"""Bounded retry with exponential backoff for fault-path side effects.

A copy of ``repro/serve/retry.py`` (the same policies, delays, jitter
streams and attempt histories).

Checkpoint reads and spare acquisition during stage replacement are I/O
against shared infrastructure (the NFS-analogue checkpoint store, the
cluster's spare pool) and can fail transiently; a single-shot attempt
turns a blip into a dead pipeline.  :func:`retry_call` bounds the retries
and the total backoff, and on exhaustion raises :class:`RetryExhausted`
carrying the full attempt history — the caller converts that into its own
typed error (``RestoreExhausted`` in ``repro_torch.serve.pipeline``) so
operators see *every* underlying failure, not just the last one.

``sleep`` is injectable so tests (and deterministic replays) never block.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """attempts total tries; delay before retry i is
    ``min(base_delay_s * backoff**i, max_delay_s)``, optionally shrunk by
    deterministic seeded jitter.

    ``jitter`` in [0, 1] decorrelates concurrent retry loops (many
    retransmits / restores backing off in lockstep re-collide on every
    attempt): retry i sleeps ``delay * (1 - jitter * u)`` with ``u``
    drawn from a per-call-site stream seeded by ``(jitter_seed, what)``
    — deterministic across runs, decorrelated across call sites.
    ``jitter=0`` (the default) is bit-identical to the unjittered
    schedule: ``delay_s(i, None)`` never multiplies.

    Fields are validated at construction: a policy with 0 attempts never
    calls its target, a backoff < 1 shrinks delays instead of backing
    off, negative delays are nonsense, and jitter outside [0, 1] would
    lengthen or negate delays — all silent misconfigurations on the
    fault path, where they would only surface mid-outage."""
    attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    backoff: float = 2.0
    jitter: float = 0.0
    jitter_seed: int = 0

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(
                f"RetryPolicy.attempts must be >= 1 (a policy that never "
                f"tries cannot succeed), got {self.attempts}")
        if self.base_delay_s < 0.0 or self.max_delay_s < 0.0:
            raise ValueError(
                f"RetryPolicy delays must be non-negative, got "
                f"base_delay_s={self.base_delay_s}, "
                f"max_delay_s={self.max_delay_s}")
        if self.backoff < 1.0:
            raise ValueError(
                f"RetryPolicy.backoff must be >= 1.0 (delays must not "
                f"shrink between attempts), got {self.backoff}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(
                f"RetryPolicy.jitter must be in [0, 1] (a fraction of the "
                f"delay to shave off), got {self.jitter}")

    def delay_s(self, attempt: int, u: float | None = None) -> float:
        d = min(self.base_delay_s * self.backoff ** attempt,
                self.max_delay_s)
        if self.jitter > 0.0 and u is not None:
            d *= 1.0 - self.jitter * u
        return d

    def jitter_stream(self, salt: str):
        """Deterministic uniform[0,1) stream for one retry loop, seeded by
        ``(jitter_seed, salt)``; ``None``s when the policy is unjittered
        so the jitter=0 path stays bit-identical."""
        if self.jitter == 0.0:
            while True:
                yield None
        rng = random.Random(f"{self.jitter_seed}:{salt}")
        while True:
            yield rng.random()


@dataclass(frozen=True)
class Attempt:
    """One failed try: the error it died with and the backoff that
    followed it (0.0 after the final try)."""
    index: int
    error: str
    delay_s: float


class RetryExhausted(RuntimeError):
    """Every attempt failed; ``attempts`` is the full failure history."""

    def __init__(self, what: str, attempts):
        self.what = what
        self.attempts = tuple(attempts)
        last = self.attempts[-1].error if self.attempts else "?"
        super().__init__(
            f"{what}: {len(self.attempts)} attempt(s) failed; last: {last}")


def retry_call(fn, *, what: str, policy: RetryPolicy | None = None,
               retry_on=(Exception,), sleep=time.sleep):
    """Call ``fn()`` under ``policy``; return its value on first success.

    Exceptions not in ``retry_on`` propagate immediately (they are bugs,
    not blips).  On exhaustion raises :class:`RetryExhausted` with the
    per-attempt history chained to the final underlying error."""
    policy = policy or RetryPolicy()
    history: list[Attempt] = []
    err: BaseException | None = None
    us = policy.jitter_stream(what)      # per-call-site decorrelation
    for i in range(policy.attempts):
        try:
            return fn()
        except retry_on as e:                    # noqa: PERF203
            err = e
            last = i + 1 >= policy.attempts
            d = 0.0 if last else policy.delay_s(i, next(us))
            history.append(Attempt(i, f"{type(e).__name__}: {e}", d))
            if not last:
                sleep(d)
    raise RetryExhausted(what, history) from err
