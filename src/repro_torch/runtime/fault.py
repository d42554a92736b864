"""Fault tolerance: failure injection, interrupted counts, stragglers.

Port of ``src/repro/runtime/fault.py``:

  * ``FailureInjector`` — a deterministic chaos monkey. ``TCServer`` checks
    it with the request id before every dispatch attempt (a transient fault
    that the bounded retry recovers, or a hard one that exhausts it); the
    resumable sharded count checks it with the step index before every
    step's launches.
  * ``CountInterrupted`` — what a resumable sharded count raises when a
    step fails: the committed total and per-shard cursors a resume needs.
  * ``StragglerMonitor`` — EWMA step-time outlier detection; a flagged
    straggler commits and interrupts the count for a remesh, like a failure.
"""
from __future__ import annotations

import dataclasses
import time

__all__ = [
    "SimulatedFailure",
    "CountInterrupted",
    "FailureInjector",
    "StragglerMonitor",
]


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / examples)."""


class CountInterrupted(RuntimeError):
    """A sharded count died mid-flight — with everything needed to resume.

    Raised by the resumable execute driver (``distributed.tc
    ._StripeScheduleDriver.count_plan_resumable``) instead of a bare
    exception: the count's
    reduction is a commutative integer monoid over disjoint pair stripes, so
    the *committed* prefix is exact and only the pairs past the committed
    cursor need re-execution — on the same mesh or (via
    ``distributed.resilient``) a shrunk one.

    Attributes:
        failed_step:     psum step index the failure surfaced at.
        committed_step:  last step whose total + cursor were committed.
        committed_total: exact partial count through ``committed_step``
                         (includes any ``base_total`` carried into the run).
        shard_cursors:   per-shard consumed-pair offsets at the committed
                         step (``StripeSchedule.cursor_after``), or ``None``
                         when the interrupted path tracked no schedule.
        reason:          ``"failure"`` (exception at dispatch/readback) or
                         ``"straggler"`` (StragglerMonitor flag).
        attempt:         the resilient driver's attempt number (0 = first).
    """

    def __init__(
        self,
        message: str,
        *,
        failed_step: int,
        committed_step: int = 0,
        committed_total: int = 0,
        shard_cursors: tuple[int, ...] | None = None,
        reason: str = "failure",
        attempt: int = 0,
    ):
        super().__init__(message)
        self.failed_step = int(failed_step)
        self.committed_step = int(committed_step)
        self.committed_total = int(committed_total)
        self.shard_cursors = (
            tuple(int(c) for c in shard_cursors)
            if shard_cursors is not None
            else None
        )
        self.reason = reason
        self.attempt = int(attempt)

    @property
    def steps_replayed(self) -> int:
        """Steps past the committed cursor a resume re-executes (<= the
        driver's ``checkpoint_every``)."""
        return max(self.failed_step - self.committed_step, 0)


@dataclasses.dataclass
class FailureInjector:
    """Raise SimulatedFailure at configured steps (each at most ``repeats``
    times, default once — the classic transient fault).

    ``fail_at_steps`` arms specific step indices; ``fail_every`` arms every
    positive multiple of a period on top. ``repeats > 1`` makes an armed
    step keep firing on re-checks — how a *hard* failure that survives
    bounded retries is modeled (the serving layer re-checks the same request
    id per attempt).
    """

    fail_at_steps: tuple[int, ...] = ()
    fail_every: int = 0
    repeats: int = 1

    def __post_init__(self):
        self._fired: dict[int, int] = {}

    @property
    def failures(self) -> int:
        """Total injected failures so far."""
        return sum(self._fired.values())

    def check(self, step: int):
        armed = step in self.fail_at_steps or (
            self.fail_every > 0 and step > 0 and step % self.fail_every == 0
        )
        if armed and self._fired.get(step, 0) < self.repeats:
            self._fired[step] = self._fired.get(step, 0) + 1
            raise SimulatedFailure(f"injected failure at step {step}")


class StragglerMonitor:
    """EWMA step-time outlier detection.

    flag() returns True when the last step exceeded ``threshold`` x the EWMA
    for ``patience`` consecutive steps — the signature of a persistent
    straggler rather than a transient (GC pause, incast).
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0, patience: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ewma: float | None = None
        self._strikes = 0
        self.history: list[float] = []
        self._t0: float | None = None

    def reset(self):
        """Forget history — e.g. after an elastic remesh, whose new gang has
        a different per-step baseline that must not inherit stale strikes."""
        self.ewma = None
        self._strikes = 0
        self.history = []
        self._t0 = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self) -> bool:
        assert self._t0 is not None, "start_step() not called"
        dt = time.perf_counter() - self._t0
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        """Record a step time; returns True if a straggler is flagged."""
        self.history.append(dt)
        if self.ewma is None:
            self.ewma = dt
            return False
        flagged = dt > self.threshold * self.ewma
        self._strikes = self._strikes + 1 if flagged else 0
        # Slow steps polute the EWMA less (winsorised update).
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * min(
            dt, self.threshold * self.ewma
        )
        return self._strikes >= self.patience
