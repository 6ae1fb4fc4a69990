"""Fault-tolerance orchestration: periodic + preemption checkpointing,
crash-consistent resume, and failure-injection hooks for tests — the
port's copy of ``repro/runtime/ft.py`` over its jax-free
``train.checkpoint``.

Two consumers share the preemption machinery here:

  * the training loop (FaultTolerantLoop + train.checkpoint): save every
    N steps, SIGTERM/SIGINT => final checkpoint before exit, resume()
    restores the latest checkpoint and the step counter;
  * the graph engine (core.engine + core.checkpoint): a PreemptionGuard
    turns SIGTERM into a flag the engine polls at the BSP barrier — the
    preempted rank writes a superstep checkpoint and raises Preempted,
    exiting cleanly so cluster supervision can resume the run
    (DESIGN.md §12).

Both are context managers that ALWAYS restore the prior signal handlers
on exit, even when the body raises — a leaked handler would redirect a
later test's (or job's) SIGTERM into a stale object.
"""
from __future__ import annotations

import signal
from typing import Callable, Optional

from repro_torch.train.checkpoint import CheckpointManager


class Preempted(RuntimeError):
    """Raised by a preemptible engine after it saved its state in response
    to SIGTERM/SIGINT; ``superstep`` is the boundary the checkpoint
    resumes at."""

    def __init__(self, superstep: int):
        super().__init__(f"preempted: state saved at superstep boundary "
                         f"{superstep}; rerun with resume to continue")
        self.superstep = superstep


class PreemptionGuard:
    """Context manager that latches SIGTERM/SIGINT into ``triggered``.

    Handlers install on ``__enter__`` (or in ``install()``) and the prior
    handlers are restored on ``__exit__`` no matter how the body ends.
    In non-main threads, where ``signal.signal`` is illegal, the guard
    degrades to an inert flag (``triggered`` stays False) — thread-rank
    test clusters run unguarded, real spawned ranks are main-thread."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self.triggered = False
        self._prev: dict = {}

    def _on_signal(self, signum, frame):
        self.triggered = True

    def install(self) -> "PreemptionGuard":
        """Install the latching handlers (idempotent)."""
        for sig in self.signals:
            if sig in self._prev:
                continue
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:      # non-main thread
                pass
        return self

    def restore(self) -> None:
        """Restore every handler this guard replaced (idempotent)."""
        for sig, h in list(self._prev.items()):
            signal.signal(sig, h)
            del self._prev[sig]

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.restore()
        return False


class FaultTolerantLoop:
    """Periodic + preemption checkpointing for the training loop.

    Use as a context manager so the SIGTERM/SIGINT handlers it installs
    are restored even when the training body raises::

        with FaultTolerantLoop(mgr, save_every=100) as ft:
            step, state = ft.resume_or_init(init_fn)
            ...

    (Bare construction still installs handlers immediately for
    backward compatibility; call ``restore_handlers()`` yourself then.)
    """

    def __init__(self, ckpt: CheckpointManager, save_every: int = 100,
                 on_preempt_save: bool = True,
                 export: Optional[Callable] = None):
        self.ckpt = ckpt
        self.save_every = save_every
        # state -> the tree a save writes, called only when one is due
        # (the train CLI's model_zoo.export_state)
        self.export = export
        self._guard = PreemptionGuard()
        if on_preempt_save:
            self._guard.install()

    @property
    def preempted(self) -> bool:
        """True once SIGTERM/SIGINT arrived (checkpoint at the next
        ``maybe_save`` and stop)."""
        return self._guard.triggered

    def __enter__(self) -> "FaultTolerantLoop":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.restore_handlers()
        return False

    # ------------------------------------------------------------------
    def resume_or_init(self, init_fn: Callable, device=None):
        """(step, state): restore the latest checkpoint (numpy leaves, or
        tensors on ``device``) or build fresh."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            step, state = self.ckpt.restore(latest, device=device)
            return step, state
        return 0, init_fn()

    def maybe_save(self, step: int, state, force: bool = False) -> bool:
        """Save when due (every ``save_every``), forced, or preempted."""
        if force or self.preempted or (self.save_every and
                                       step % self.save_every == 0 and step > 0):
            self.ckpt.save(step, state if self.export is None
                           else self.export(state))
            return True
        return False

    def should_stop(self) -> bool:
        """True when the loop should checkpoint-and-exit (preemption)."""
        return self.preempted

    def restore_handlers(self):
        """Put back the signal handlers this loop replaced (idempotent;
        the context-manager exit calls this for you)."""
        self._guard.restore()


class FailureInjector:
    """Deterministic failure injection for resilience tests: raises
    SimulatedFailure at the given steps.  (The graph engine's richer
    point-fault layer lives in runtime.faults.)"""

    def __init__(self, fail_at_steps: set[int]):
        self.fail_at = set(fail_at_steps)
        self.failures = 0

    def check(self, step: int):
        """Raise SimulatedFailure if ``step`` is an armed failure point."""
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures += 1
            raise SimulatedFailure(f"injected failure at step {step}")


class SimulatedFailure(RuntimeError):
    """The injected-failure marker raised by FailureInjector."""
