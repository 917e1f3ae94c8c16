"""Deterministic fault injection + recovery primitives for the IO stack.

The container has no failing SSDs or flapping NICs, so faults are
*injected* the same way timing is: a seeded ``ChaosSchedule`` decides,
deterministically, whether a given service attempt on a given stream
(storage shard for ``AsyncIOEngine``, peer for ``RemoteIOEngine``) fails
transiently, runs slow, sticks past its deadline, or tears mid-write.
``SSDModel``/``NetworkModel`` carry the schedule and the engines consult
it through ``fault()`` on every service attempt, so a chaos run is
reproducible bit-for-bit: faults perturb only *virtual time* and retry
accounting — a retried read returns exactly the bytes the fault-free run
would have returned.

Error taxonomy (what lands on a CQE / ticket):

  * ``TransientIOError``  — retryable: media/link glitch; the engine
    retries with exponential backoff + deterministic jitter, priced in
    virtual seconds.
  * ``IOTimeout``         — a service attempt exceeded the per-stream
    virtual deadline (latency spike / stuck shard); retryable, and on
    the remote path the retry is a HEDGE rerouted to owner storage.
  * ``FatalIOError``      — not retryable: the fault schedule marked the
    op fatal, or a stuck stream has no deadline configured (the real
    system would hang; we raise instead).
  * ``RetriesExhausted``  — transient faults outlasted the retry budget;
    escalated to fatal so callers see a clear error, never a hang.
  * ``SimulatedCrash``    — a torn write: a prefix of the batch landed
    and the "machine" died.  Recovery is the flush journal's job
    (``writeback.FlushJournal``), not the engine's.

Decisions are keyed on ``(stream, kind, seq, attempt)`` where ``seq`` is
a per-stream service-attempt counter the engine advances under its
per-stream lock — per-stream FIFO service makes the key deterministic,
and retrying advances ``seq`` so a stuck *window* naturally passes.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field


class IOFault(IOError):
    """Base of the injected-fault taxonomy."""


class TransientIOError(IOFault):
    """Retryable fault: retry with backoff reproduces the read."""


class IOTimeout(TransientIOError):
    """Service attempt exceeded the per-stream virtual deadline."""


class FatalIOError(IOFault):
    """Unrecoverable fault: surfaces on the ticket, never retried."""


class RetriesExhausted(FatalIOError):
    """Transient faults outlasted the bounded retry budget."""


class SimulatedCrash(FatalIOError):
    """Torn write: a prefix of the batch landed, then the machine died."""


_M = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: avalanche a 64-bit value."""
    x &= _M
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M
    return x ^ (x >> 31)


def _unit(*parts: int) -> float:
    """Deterministic hash of integer parts -> float in [0, 1)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = _mix64(h ^ (int(p) & _M))
    return h / 2.0 ** 64


@dataclass(frozen=True)
class FaultDecision:
    """What the schedule injects into ONE service attempt."""
    error: str | None = None            # None | "transient" | "fatal"
    stuck: bool = False                 # attempt exceeds any deadline
    slow: float = 1.0                   # latency-spike multiplier
    torn: bool = False                  # write lands a prefix, then crash


class ChaosSchedule:
    """Seeded, schedule-driven fault injection consulted by the engines.

    * ``read_error_rate``/``write_error_rate`` — per service-attempt
      probability of a transient error, hashed from
      ``(seed, stream, kind, seq, attempt)`` so runs reproduce exactly
      and a retry (``attempt+1``) re-rolls.
    * ``stuck`` — windows ``(stream, lo, hi)``: service attempts
      ``lo <= seq < hi`` on that stream never complete before the
      deadline (stuck shard / frozen peer).
    * ``slow`` — windows ``(stream, lo, hi, factor)``: attempts in the
      window take ``factor``x their modeled virtual time (latency
      spike; trips the deadline only if the inflated time exceeds it).
    * ``fatal_at`` — ``(stream, seq)`` pairs: that attempt raises a
      ``FatalIOError`` (unrecoverable media error).
    * ``torn_at`` — ``(stream, seq)`` pairs: a WRITE attempt lands only
      a prefix of its rows and raises ``SimulatedCrash``.

    Streams are storage shards for ``AsyncIOEngine``, peers for
    ``RemoteIOEngine``; the legacy/sync whole-batch paths consult the
    schedule as stream 0.
    """

    def __init__(self, seed: int = 0, read_error_rate: float = 0.0,
                 write_error_rate: float = 0.0,
                 stuck: tuple = (), slow: tuple = (),
                 fatal_at: tuple = (), torn_at: tuple = ()):
        self.seed = int(seed)
        self.read_error_rate = float(read_error_rate)
        self.write_error_rate = float(write_error_rate)
        self.stuck = tuple((int(s), int(lo), int(hi))
                           for s, lo, hi in stuck)
        self.slow = tuple((int(s), int(lo), int(hi), float(f))
                          for s, lo, hi, f in slow)
        self.fatal_at = frozenset((int(s), int(q)) for s, q in fatal_at)
        self.torn_at = frozenset((int(s), int(q)) for s, q in torn_at)

    def decide(self, stream: int, kind: str, seq: int,
               attempt: int) -> FaultDecision | None:
        """Fault (if any) for one service attempt; None = clean.  Pure:
        same key -> same decision, regardless of thread interleaving."""
        if (stream, seq) in self.fatal_at:
            return FaultDecision(error="fatal")
        if kind == "w" and (stream, seq) in self.torn_at:
            return FaultDecision(torn=True)
        stuck = any(s == stream and lo <= seq < hi
                    for s, lo, hi in self.stuck)
        slowf = 1.0
        for s, lo, hi, f in self.slow:
            if s == stream and lo <= seq < hi:
                slowf *= f
        rate = (self.read_error_rate if kind == "r"
                else self.write_error_rate)
        err = None
        if rate > 0.0 and _unit(self.seed, stream, ord(kind[0]), seq,
                                attempt) < rate:
            err = "transient"
        if err is None and not stuck and slowf == 1.0:
            return None
        return FaultDecision(error=err, stuck=stuck, slow=slowf)

    def __repr__(self):
        return (f"ChaosSchedule(seed={self.seed}, "
                f"read_error_rate={self.read_error_rate}, "
                f"write_error_rate={self.write_error_rate}, "
                f"stuck={self.stuck}, slow={self.slow}, "
                f"fatal_at={sorted(self.fatal_at)}, "
                f"torn_at={sorted(self.torn_at)})")

    @classmethod
    def from_env(cls, var: str = "HELIOS_CHAOS") -> "ChaosSchedule | None":
        """Schedule from a ``k=v,k=v`` env string (scalar knobs only:
        ``seed``, ``read_error_rate``, ``write_error_rate``) — how the CI
        chaos leg runs the whole e2e suite under injected faults without
        touching any test.  Returns None when unset/empty/``off``."""
        raw = os.environ.get(var, "").strip()
        if not raw or raw.lower() in ("0", "off", "none"):
            return None
        kw: dict = {}
        for part in raw.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k == "seed":
                kw[k] = int(v)
            elif k in ("read_error_rate", "write_error_rate"):
                kw[k] = float(v)
            else:
                raise ValueError(f"{var}: unknown knob {k!r} "
                                 "(env supports seed/read_error_rate/"
                                 "write_error_rate)")
        return cls(**kw)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry knobs, priced in VIRTUAL seconds.

    ``deadline_s`` is the per-stream service deadline: an attempt whose
    modeled time exceeds it is abandoned at the deadline and retried
    (or hedged).  None disables deadlines — transient errors still
    retry, but a stuck stream then raises ``FatalIOError`` instead of
    hanging forever.
    """
    max_retries: int = 4
    backoff_base_s: float = 1e-3
    backoff_cap_s: float = 50e-3
    deadline_s: float | None = None

    def backoff(self, stream: int, seq: int, attempt: int,
                jitter_seed: int = 0) -> float:
        """Exponential backoff with deterministic jitter in [0.5x, 1.5x)."""
        j = 0.5 + _unit(jitter_seed, stream, ord("b"), seq, attempt)
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** attempt) * j)


DEFAULT_RETRY = RetryPolicy()


@dataclass
class RecoveryCounters:
    """What one recovered service op cost beyond its clean execution."""
    retries: int = 0                    # failed attempts retried
    timeouts: int = 0                   # of which: deadline-abandoned
    transient: int = 0                  # of which: transient errors
    backoff_s: float = 0.0              # virtual backoff charged
    hedged: bool = False                # final attempt took the hedge route
    extra_virt_s: float = field(default=0.0)  # total failed-attempt virt


def serve_with_recovery(fault_fn, policy: RetryPolicy, stream: int,
                        kind: str, next_seq, time_fn, io_fn,
                        hedge: bool = False, jitter_seed: int = 0):
    """Run one service op under the fault schedule with bounded retries.

    ``time_fn(attempt, hedged)`` models the attempt's virtual seconds
    (the hedged flag reroutes remote attempts to owner storage after a
    timeout); ``io_fn(decision)`` performs the actual data movement and
    runs ONCE, on the successful attempt — retried reads therefore
    return bit-identical bytes.  Failed attempts charge their virtual
    time (full deadline for timeouts) plus backoff.  Returns
    ``(payload, virtual_s, RecoveryCounters)``; raises the fatal
    taxonomy on unrecoverable faults.
    """
    rec = RecoveryCounters()
    attempt = 0
    hedged = False

    def fatal(cls, msg):
        # fatal raises carry the counters accumulated so far, so the
        # engine books the retries a doomed op burned before escalating
        exc = cls(msg)
        exc.recovery = rec
        return exc

    while True:
        seq = next_seq()
        fd = fault_fn(stream, kind, seq, attempt) if fault_fn else None
        if fd is not None and fd.error == "fatal":
            raise fatal(FatalIOError,
                        f"injected fatal {kind!r} fault on stream "
                        f"{stream} (seq {seq})")
        base = time_fn(attempt, hedged)
        if fd is not None and fd.slow != 1.0:
            base *= fd.slow
        # a hedged attempt reads the owner's storage directly — a stuck
        # PEER no longer sits on the path, so its window doesn't apply
        stuck = fd is not None and fd.stuck and not (hedge and hedged)
        dl = policy.deadline_s
        if stuck and dl is None:
            raise fatal(FatalIOError,
                        f"stream {stream} stuck with no deadline "
                        f"configured (seq {seq}): would hang; set "
                        "RetryPolicy.deadline_s to bound service attempts")
        if stuck or (dl is not None and base > dl):
            rec.timeouts += 1
            rec.retries += 1
            back = policy.backoff(stream, seq, attempt, jitter_seed)
            rec.backoff_s += back
            rec.extra_virt_s += dl + back
            hedged = hedge
            attempt += 1
            if attempt > policy.max_retries:
                raise fatal(RetriesExhausted,
                            f"stream {stream} {kind!r}: {rec.timeouts} "
                            f"timeouts/{rec.transient} errors in "
                            f"{attempt} attempts (deadline {dl}s, "
                            f"max_retries {policy.max_retries})")
            continue
        if fd is not None and fd.error == "transient":
            rec.transient += 1
            rec.retries += 1
            back = policy.backoff(stream, seq, attempt, jitter_seed)
            rec.backoff_s += back
            rec.extra_virt_s += base + back
            attempt += 1
            if attempt > policy.max_retries:
                raise fatal(RetriesExhausted,
                            f"stream {stream} {kind!r}: {rec.transient} "
                            f"transient errors in {attempt} attempts "
                            f"(max_retries {policy.max_retries})")
            continue
        payload = io_fn(fd)
        if fd is not None and fd.torn and kind == "w":
            raise fatal(SimulatedCrash,
                        f"torn write on stream {stream} (seq {seq}): a "
                        "prefix of the batch landed before the crash")
        rec.hedged = hedged
        return payload, base + rec.extra_virt_s, rec
