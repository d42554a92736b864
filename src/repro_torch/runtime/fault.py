"""Failure injection: a deterministic chaos monkey for tests and the server.

Port of ``src/repro/runtime/fault.py`` (``SimulatedFailure``,
``FailureInjector``). ``TCServer`` checks the injector with the request id
before every dispatch attempt, so a test can fail one request once (a
transient fault that the bounded retry recovers) or keep failing it (a hard
fault that exhausts the retries) while every other count stays exact.
"""
from __future__ import annotations

import dataclasses

__all__ = ["SimulatedFailure", "FailureInjector"]


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / examples)."""


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
