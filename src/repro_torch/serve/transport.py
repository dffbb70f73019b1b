"""Fault-tolerant boundary transport + heartbeat failure detection.

The port of ``repro/serve/transport.py``.  The typed faults, their parser
and seeded generator (the same numpy stream, so the same schedules), the
heartbeat monitor, the errors, ``HopStats`` and ``FakeWireClock`` are
copies; :class:`BoundaryTransport` is ported: a payload is a tensor (the
raw wire's boundary activation) or a tuple of tensors (the int8 wire's
``(q, scale)``), and a frame holds each leaf's own bytes on the host.

The stage-boundary handoffs of the pipeline are in-process tensor passes
— implicitly lossless, in-order, exactly-once.  Edge deployments ship
those activations over a real (lossy) wire, so this module makes the
wire a first-class fault surface:

:class:`BoundaryTransport` frames every boundary payload (per-hop
**sequence number** + chained **CRC32** over the host bytes) and delivers
it through an ack/retransmit loop under the engine's
:class:`~repro_torch.serve.retry.RetryPolicy`: a frame that is dropped,
arrives corrupt (CRC mismatch -> NAK), or is overtaken by its own
retransmission is simply sent again, and the receiver deduplicates by
sequence number so delivery is **idempotent** — every frame is delivered
exactly once, in order, no matter how the wire misbehaves.  Delivered
payloads are rebuilt from the *received* host bytes (a device -> host ->
device round trip), so a transport bug would genuinely corrupt downstream
tokens.  The frame's bytes are the tensor's own: bf16 travels as its
16-bit patterns, so the CRC32 of a payload equals the reference's for
the same values.

Wire faults are **typed and injectable** (:class:`Drop`,
:class:`CorruptPayload`, :class:`Duplicate`, :class:`Reorder`,
:class:`Stall`), each targeting one ``(hop, xfer)`` — the ``xfer``-th
frame ever sent on that hop — so a whole schedule is deterministic and
replayable; :func:`seeded_wire_faults` draws one from a seed.  ``Reorder``
is modeled as the in-process analogue of packet reordering: the original
frame is delayed past the sender's timeout, the retransmission overtakes
it, and the stale copy arrives *after* the newer frame and must be
discarded by dedup.

:class:`HeartbeatMonitor` is the serving-side failure detector.  Stages
beat on every completed compute; silence is graded — ``SUSPECTED`` after
``suspect_after_s`` (a stalled wire looks exactly like this: keep
serving, feed telemetry, let the transport retransmit) and ``DEAD`` only
after ``dead_after_s`` (engage the checkpoint-restore / replica paths).

Clock and sleep are injectable everywhere (``FakeWireClock`` for tests),
so the pinned paths never read the wall clock.
"""

from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .retry import RetryExhausted, RetryPolicy, retry_call

# decorrelates the wire-fault draw stream from every other seeded stream
_WIRE_STREAM = 0xB0B1E

UP = "up"
SUSPECTED = "suspected"
DEAD = "dead"


# ---------------------------------------------------------------------------
# typed wire faults
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Drop:
    """Frame ``xfer`` on ``hop`` is lost in flight: no delivery, no ack;
    the sender times out and retransmits."""
    hop: int
    xfer: int


@dataclass(frozen=True)
class CorruptPayload:
    """Frame ``xfer`` on ``hop`` arrives with bit ``bit`` (mod payload
    size) flipped; the receiver's CRC rejects it (NAK) and the sender
    retransmits the pristine frame."""
    hop: int
    xfer: int
    bit: int = 0


@dataclass(frozen=True)
class Duplicate:
    """Frame ``xfer`` on ``hop`` arrives twice; the second copy must be
    discarded by sequence-number dedup (idempotent delivery)."""
    hop: int
    xfer: int


@dataclass(frozen=True)
class Reorder:
    """Frame ``xfer`` on ``hop`` is delayed past the retransmit timeout:
    its retransmission overtakes it, and the stale original arrives after
    the newer frame and is dropped by dedup."""
    hop: int
    xfer: int


@dataclass(frozen=True)
class Stall:
    """The wire carrying frame ``xfer`` on ``hop`` stalls for
    ``stall_s`` before delivering — long enough to trip the heartbeat
    monitor into ``SUSPECTED`` (but never a restore: the frame arrives
    and the stage beats again)."""
    hop: int
    xfer: int
    stall_s: float = 3.0


_FAULT_KINDS = {"drop": Drop, "corrupt": CorruptPayload, "dup": Duplicate,
                "reorder": Reorder, "stall": Stall}


def parse_wire_faults(specs) -> list:
    """JSON-friendly fault specs -> typed faults.  Each spec is
    ``[kind, hop, xfer]`` plus the kind's extra field (``corrupt``: bit,
    ``stall``: stall_s) — the encoding the serve-equivalence fixture
    cells use."""
    out = []
    for spec in specs:
        kind, hop, xfer = spec[0], int(spec[1]), int(spec[2])
        cls = _FAULT_KINDS[kind]
        if kind == "corrupt":
            out.append(cls(hop, xfer, int(spec[3]) if len(spec) > 3 else 0))
        elif kind == "stall":
            out.append(cls(hop, xfer,
                           float(spec[3]) if len(spec) > 3 else 3.0))
        else:
            out.append(cls(hop, xfer))
    return out


def seeded_wire_faults(seed: int, n_hops: int, n_xfers: int,
                       rate: float = 0.1, *, stall_s: float = 3.0) -> list:
    """Draw a deterministic wire-fault schedule: each (hop, xfer) suffers
    a fault with probability ``rate``, kind uniform over the five types.
    The chaos campaign's schedule generator."""
    rng = np.random.default_rng([int(seed), _WIRE_STREAM])
    kinds = ("drop", "corrupt", "dup", "reorder", "stall")
    out = []
    for hop in range(n_hops):
        for xfer in range(n_xfers):
            if rng.random() >= rate:
                continue
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "corrupt":
                out.append(CorruptPayload(hop, xfer, int(rng.integers(64))))
            elif kind == "stall":
                out.append(Stall(hop, xfer, stall_s))
            else:
                out.append(_FAULT_KINDS[kind](hop, xfer))
    return out


# ---------------------------------------------------------------------------
# heartbeat failure detection
# ---------------------------------------------------------------------------

class HeartbeatMonitor:
    """Grades per-stage silence: ``UP`` -> ``SUSPECTED`` (after
    ``suspect_after_s`` without a beat — a stalled wire; keep serving)
    -> ``DEAD`` (after ``dead_after_s`` — engage restore).  Stages beat
    on every completed compute; clock/sleep are injected so detection is
    deterministic under test."""

    def __init__(self, n_stages: int, *, suspect_after_s: float = 2.0,
                 dead_after_s: float = 8.0, poll_s: float = 0.5,
                 clock=time.perf_counter, sleep=time.sleep):
        if not 0.0 < suspect_after_s <= dead_after_s:
            raise ValueError(
                f"HeartbeatMonitor needs 0 < suspect_after_s <= "
                f"dead_after_s (suspicion must precede confirmation), got "
                f"suspect_after_s={suspect_after_s}, "
                f"dead_after_s={dead_after_s}")
        if poll_s <= 0.0:
            raise ValueError(f"HeartbeatMonitor.poll_s must be > 0, "
                             f"got {poll_s}")
        self.n_stages = int(n_stages)
        self.suspect_after_s = float(suspect_after_s)
        self.dead_after_s = float(dead_after_s)
        self.poll_s = float(poll_s)
        self._clock = clock
        self._sleep = sleep
        t = clock()
        self._last = [t] * self.n_stages

    def now(self) -> float:
        return self._clock()

    def wait(self) -> None:
        """Block one detection poll interval (injected sleep)."""
        self._sleep(self.poll_s)

    def beat(self, stage: int) -> None:
        self._last[stage] = self._clock()

    def last_beat(self, stage: int) -> float:
        return self._last[stage]

    def silence_s(self, stage: int) -> float:
        return self._clock() - self._last[stage]

    def state(self, stage: int) -> str:
        s = self.silence_s(stage)
        if s >= self.dead_after_s:
            return DEAD
        if s >= self.suspect_after_s:
            return SUSPECTED
        return UP

    def report(self) -> dict[int, str]:
        """Stage -> health, the snapshot ``ClusterState.fold_health``
        consumes (detector suspicion feeds the replan estimate)."""
        return {k: self.state(k) for k in range(self.n_stages)}


# ---------------------------------------------------------------------------
# framed channel
# ---------------------------------------------------------------------------

class FrameLost(RuntimeError):
    """One transmission attempt failed (dropped / NAK'd / overtaken);
    retryable under the transport's RetryPolicy."""


class WireExhausted(RuntimeError):
    """Every retransmission of one frame failed; ``attempts`` carries the
    per-attempt history (the wire-level RestoreExhausted analogue)."""

    def __init__(self, msg: str, attempts=()):
        super().__init__(msg)
        self.attempts = tuple(attempts)


@dataclass
class HopStats:
    """Per-hop delivery accounting; ``delivered == sent`` at rest is the
    exactly-once invariant the chaos campaign asserts."""
    sent: int = 0
    delivered: int = 0
    retransmits: int = 0
    dropped: int = 0
    corrupt_rejected: int = 0
    dup_dropped: int = 0
    stale_dropped: int = 0
    stalls: int = 0
    suspected: int = 0
    bytes: int = 0


@dataclass
class _Frame:
    seq: int
    crc: int
    leaves: list = field(default_factory=list)   # host np arrays


def _crc_leaves(leaves) -> int:
    """CRC32 chained over the leaves' bytes in order, each read in place."""
    crc = 0
    for a in leaves:
        crc = zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8),
                         crc)
    return crc & 0xFFFFFFFF


def _host_leaf(t: torch.Tensor) -> np.ndarray:
    """A host copy of the tensor's own bytes: contiguous, and bf16 (which
    numpy lacks) as its 16-bit patterns."""
    t = t.detach()
    if not t.is_contiguous():
        t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


def _device_leaf(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A received host leaf as a tensor of ``dtype`` on ``device``."""
    t = torch.from_numpy(a).to(device)
    return t.view(dtype) if t.dtype != dtype else t


class BoundaryTransport:
    """Framed, ack'd, deduplicating channel for the pipeline's
    ``n_hops = n_stages - 1`` stage boundaries.

    ``send(hop, payload)`` pushes one payload — a tensor, or a tuple of
    tensors such as the int8 wire's ``(q, scale)`` — through the hop's
    wire and returns it *as received* (rebuilt from the delivered host
    bytes).  Injected ``faults`` fire by (hop, xfer);
    ``policy`` bounds retransmissions; ``monitor`` (optional) is polled
    after stalls/losses so wire trouble surfaces as *suspicion*, never a
    restore.  Clock/sleep are injected; the default policy keeps the
    fault-free path effectively instantaneous."""

    def __init__(self, n_hops: int, *, faults=(), policy=None,
                 monitor: HeartbeatMonitor | None = None,
                 clock=time.perf_counter, sleep=time.sleep):
        if n_hops < 0:
            raise ValueError(f"n_hops must be >= 0, got {n_hops}")
        self.n_hops = int(n_hops)
        self.policy = policy or RetryPolicy(attempts=5, base_delay_s=0.05)
        self.monitor = monitor
        self._clock = clock
        self._sleep = sleep
        self._tx = [0] * self.n_hops          # next seq to send, per hop
        self._rx = [0] * self.n_hops          # next seq expected, per hop
        self._delayed: dict[int, list] = {}   # hop -> reordered stale frames
        self.stats = [HopStats() for _ in range(self.n_hops)]
        self.events: list[tuple[float, str]] = []
        self._faults: dict[tuple[int, int], deque] = {}
        for f in faults:
            if not 0 <= f.hop < self.n_hops:
                raise ValueError(f"wire fault {f} targets hop {f.hop}; "
                                 f"transport has {self.n_hops} hop(s)")
            self._faults.setdefault((f.hop, f.xfer), deque()).append(f)

    # -- framing ------------------------------------------------------------

    def _note(self, msg: str) -> None:
        self.events.append((self._clock(), msg))

    @staticmethod
    def _to_frame(seq: int, payload) -> tuple[_Frame, object]:
        """The frame of ``payload`` (its leaves in the reference's order,
        q before scale) and the layout to rebuild it from: whether it was
        a tuple, and each leaf's dtype."""
        is_tuple = isinstance(payload, tuple)
        leaves = list(payload) if is_tuple else [payload]
        host = [_host_leaf(t) for t in leaves]
        layout = (is_tuple, [t.dtype for t in leaves], leaves[0].device)
        return _Frame(seq, _crc_leaves(host), host), layout

    @staticmethod
    def _corrupted(frame: _Frame, bit: int) -> _Frame:
        """A copy of ``frame`` with one payload bit flipped (the CRC is
        carried unchanged, so the receiver must reject it)."""
        leaves = [a.copy() for a in frame.leaves]
        sizes = [a.nbytes for a in leaves]
        total_bits = 8 * sum(sizes)
        bit %= max(total_bits, 1)
        byte, shift = divmod(bit, 8)
        for i, nb in enumerate(sizes):
            if byte < nb:
                raw = bytearray(leaves[i].tobytes())
                raw[byte] ^= 1 << shift
                leaves[i] = np.frombuffer(
                    bytes(raw), dtype=leaves[i].dtype
                ).reshape(leaves[i].shape)
                break
            byte -= nb
        return _Frame(frame.seq, frame.crc, leaves)

    def _receive(self, hop: int, frame: _Frame):
        """Receiver side: CRC check then in-order dedup.  Returns the
        delivered host leaves, or None for a NAK (corrupt) / discarded
        duplicate or stale copy."""
        st = self.stats[hop]
        if _crc_leaves(frame.leaves) != frame.crc:
            st.corrupt_rejected += 1
            self._note(f"hop {hop}: frame {frame.seq} CRC mismatch — NAK")
            return None
        if frame.seq != self._rx[hop]:
            # retransmission of an already-delivered frame (duplicate) or
            # a reordered stale copy: idempotent delivery discards it
            st.dup_dropped += 1
            return None
        self._rx[hop] += 1
        st.delivered += 1
        return frame.leaves

    def _suspect_check(self, hop: int) -> None:
        """After wire trouble, poll the downstream stage's health: a
        stalled wire surfaces as SUSPECTED — telemetry-visible, never a
        restore (the transport keeps retransmitting)."""
        mon = self.monitor
        if mon is None:
            return
        stage = hop + 1
        if mon.state(stage) != UP:
            self.stats[hop].suspected += 1
            self._note(f"hop {hop}: stage {stage} SUSPECTED "
                       f"(silent {mon.silence_s(stage):.3g}s) — "
                       "retransmitting, no restore")

    # -- the wire -----------------------------------------------------------

    def send(self, hop: int, payload, *, device=None):
        """Deliver one boundary payload over ``hop`` exactly once, in
        order, under the fault schedule; returns the payload rebuilt from
        the received bytes — placed on ``device`` when given (the
        receiving stage's device), else on the payload's own device."""
        frame, layout = self._to_frame(self._tx[hop], payload)
        self._tx[hop] += 1
        st = self.stats[hop]
        st.sent += 1
        st.bytes += sum(a.nbytes for a in frame.leaves)
        pending = self._faults.get((hop, frame.seq))
        state = {"attempt": 0, "leaves": None}

        def attempt():
            if state["attempt"]:
                st.retransmits += 1
            state["attempt"] += 1
            fault = pending.popleft() if pending else None
            if isinstance(fault, Drop):
                st.dropped += 1
                self._note(f"hop {hop}: frame {frame.seq} DROPPED in "
                           "flight — retransmit")
                self._suspect_check(hop)
                raise FrameLost(f"hop {hop}: frame {frame.seq} dropped")
            if isinstance(fault, Reorder):
                # delayed past the timeout: the retransmission will
                # overtake it; the stale copy arrives later (flushed on
                # the next successful delivery) and is deduped
                self._delayed.setdefault(hop, []).append(frame)
                self._note(f"hop {hop}: frame {frame.seq} delayed "
                           "(reordered) — retransmit overtakes it")
                self._suspect_check(hop)
                raise FrameLost(f"hop {hop}: frame {frame.seq} reordered")
            if isinstance(fault, CorruptPayload):
                got = self._receive(hop, self._corrupted(frame, fault.bit))
                if got is not None:       # CRC failed to catch the flip
                    raise AssertionError(
                        f"hop {hop}: corrupt frame {frame.seq} passed CRC")
                self._suspect_check(hop)
                raise FrameLost(f"hop {hop}: frame {frame.seq} corrupt "
                                "(NAK)")
            if isinstance(fault, Stall):
                st.stalls += 1
                self._note(f"hop {hop}: wire STALLED {fault.stall_s:g}s on "
                           f"frame {frame.seq}")
                self._sleep(fault.stall_s)
                self._suspect_check(hop)
            got = self._receive(hop, frame)
            if got is None:
                raise FrameLost(f"hop {hop}: frame {frame.seq} discarded "
                                "by receiver")
            if isinstance(fault, Duplicate):
                dup = self._receive(hop, frame)
                if dup is not None:
                    raise AssertionError(
                        f"hop {hop}: duplicate frame {frame.seq} was "
                        "delivered twice")
            state["leaves"] = got
            return got

        try:
            leaves = retry_call(
                attempt, what=f"wire hop {hop} frame {frame.seq}",
                policy=self.policy, retry_on=(FrameLost,),
                sleep=self._sleep)
        except RetryExhausted as e:
            raise WireExhausted(str(e), e.attempts) from e
        # late (reordered) copies of older frames arrive now, after the
        # newer frame: dedup must discard every one of them
        for stale in self._delayed.pop(hop, ()):
            if self._receive(hop, stale) is not None:
                raise AssertionError(
                    f"hop {hop}: stale reordered frame {stale.seq} was "
                    "delivered after its retransmission")
            self.stats[hop].dup_dropped -= 1
            self.stats[hop].stale_dropped += 1
        is_tuple, dtypes, src = layout
        out = [_device_leaf(a, dt, src if device is None else device)
               for a, dt in zip(leaves, dtypes)]
        return tuple(out) if is_tuple else out[0]

    # -- accounting ---------------------------------------------------------

    def exactly_once(self) -> bool:
        """True iff every hop delivered exactly what was sent — no lost
        and no double-delivered frame (the chaos invariant)."""
        return all(s.delivered == s.sent and s.delivered == self._rx[i]
                   for i, s in enumerate(self.stats))

    def total(self, field_name: str) -> int:
        return sum(getattr(s, field_name) for s in self.stats)


class FakeWireClock:
    """Deterministic time source for transport/monitor tests and the
    ``-wire`` cells: ``now()`` reads, ``sleep`` advances."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    now = __call__

    def sleep(self, s: float) -> None:
        self.t += float(s)
