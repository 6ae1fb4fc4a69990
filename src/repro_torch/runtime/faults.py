"""Deterministic fault injection for resilience tests (DESIGN.md §12).

The port's copy of ``repro/runtime/faults.py`` (stdlib only).  Spec ids
and once-marker file names are the reference's, so a marker directory
written by either package is honoured by the other.

Crash-consistent checkpointing is untestable without a way to crash on
purpose, at a *named* point, repeatably.  This module provides that:

  * a :class:`FaultSpec` names a point — ``site`` (e.g. ``"superstep"``,
    ``"barrier"``, ``"ckpt.pre_rename"``, ``"transport.send"``,
    ``"http_response"`` — the HTTP frontend's response path, where
    ``kind=delay`` simulates a slow reply and ``kind=drop`` a reply lost
    on the wire), an optional superstep/sequence number, an optional
    rank — plus what to do there (``kind``);
  * a :class:`FaultPlan` is a picklable bundle of specs that rides
    through ``EngineConfig``/``ClusterConfig`` into multiprocessing
    ``spawn`` children, so one plan arms every rank of a cluster;
  * a :class:`FaultInjector` is the per-process arm of a plan: hot paths
    call ``check(site, step)`` (no-op unless a spec matches), file
    writers call ``write(...)`` (torn-write aware), transports call
    ``drop(...)``.

Fault kinds:

  ``raise``      raise :class:`InjectedFault` (catchable, in-process tests)
  ``kill``       ``os._exit(137)`` — hard death, skips ``finally``/atexit
                 (simulates a crashed process, not a clean shutdown)
  ``sigkill``    deliver a real ``SIGKILL`` to this process
  ``preempt``    deliver ``SIGTERM`` to this process (spot reclaim drill;
                 the engine's preemption guard turns it into a
                 save-and-exit, see runtime.ft)
  ``delay``      sleep ``delay_seconds`` (straggler/timeout drills)
  ``torn_write`` only via ``write()``: persist the first ``keep_bytes``
                 bytes of the payload, then die per ``then``
  ``drop_frame`` only via ``drop()``: swallow one transport frame
  ``drop``       alias of ``drop_frame`` for non-frame sites (e.g. an
                 HTTP response at ``site=http_response``)

Determinism across restarts: a spec with ``once=True`` (the default)
fires exactly once per *plan*, not per process.  When the plan carries a
``marker_dir`` (any directory that survives the crash — the checkpoint
dir in practice), firing is recorded as a marker file claimed with
``O_CREAT|O_EXCL`` *before* the fault acts, so a respawned rank does not
re-fire the same fault; without a marker_dir the once-set is in-memory
(fine for single-process tests).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional


class InjectedFault(RuntimeError):
    """The catchable crash raised by ``kind="raise"`` (and torn writes
    with ``then="raise"``) — distinguishable from real failures."""


KINDS = ("raise", "kill", "sigkill", "preempt", "delay", "torn_write",
         "drop_frame", "drop")

#: the kinds :meth:`FaultInjector.drop` responds to ("drop" is the
#: spelling for non-frame sites like http_response; same semantics)
DROP_KINDS = ("drop_frame", "drop")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One named fault point (see module docstring for the kinds).

    ``superstep=-1`` matches any step, ``rank=-1`` any rank.  ``site``
    is compared exactly against the caller-supplied site string."""

    site: str
    superstep: int = -1
    rank: int = -1
    kind: str = "raise"
    delay_seconds: float = 0.05       # kind="delay"
    keep_bytes: int = 0               # kind="torn_write": surviving prefix
    then: str = "raise"               # torn_write follow-up: raise | kill
    once: bool = True

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")

    def spec_id(self) -> str:
        """Stable identifier used for the once-marker file name."""
        site = self.site.replace(".", "-").replace(os.sep, "-")
        return f"{site}_{self.superstep}_{self.rank}_{self.kind}"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A picklable bundle of fault specs + the directory where once-markers
    persist across process restarts (``None`` = in-memory markers)."""

    specs: tuple = ()
    marker_dir: Optional[str] = None

    def injector(self, rank: Optional[int] = None) -> "FaultInjector":
        """Arm this plan in the current process as ``rank`` (None = the
        classic single-process engine, which matches any rank spec)."""
        return FaultInjector(self, rank=rank)


def parse_spec(text: str) -> FaultSpec:
    """Parse one CLI ``--inject`` value, e.g.
    ``"rank=1,superstep=2,site=superstep,kind=sigkill"``.

    Keys: site (required), superstep, rank, kind, delay_seconds,
    keep_bytes, then, once."""
    kw: dict = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad --inject fragment {part!r} "
                             "(expected key=value)")
        k, v = part.split("=", 1)
        k = k.strip()
        v = v.strip()
        if k in ("superstep", "rank", "keep_bytes"):
            kw[k] = int(v)
        elif k == "delay_seconds":
            kw[k] = float(v)
        elif k == "once":
            kw[k] = v.lower() in ("1", "true", "yes")
        elif k in ("site", "kind", "then"):
            kw[k] = v
        else:
            raise ValueError(f"unknown --inject key {k!r}")
    if "site" not in kw:
        raise ValueError(f"--inject spec {text!r} needs site=...")
    return FaultSpec(**kw)


def parse_plan(texts, marker_dir: Optional[str] = None) -> Optional[FaultPlan]:
    """Build a FaultPlan from repeated CLI ``--inject`` values (None when
    no spec was given, so callers can pass it straight to configs)."""
    if not texts:
        return None
    return FaultPlan(specs=tuple(parse_spec(t) for t in texts),
                     marker_dir=marker_dir)


class FaultInjector:
    """Per-process arm of a :class:`FaultPlan` (see module docstring).

    Thread-compatible: matching mutates only the once-claim state, which
    is an O_EXCL marker file (cross-process) or an in-memory set guarded
    by the GIL — good enough for the engine's single compute thread."""

    def __init__(self, plan: FaultPlan, rank: Optional[int] = None):
        self.plan = plan
        self.rank = rank
        self.fired: list[str] = []      # spec_ids this injector acted on
        self._mem_claims: set[str] = set()

    # -- hot-path hooks ------------------------------------------------------
    def check(self, site: str, step: int = -1) -> None:
        """Fire any matching non-I/O fault at this point (no-op otherwise).
        ``torn_write``/``drop_frame`` specs never match here — they fire
        through :meth:`write` / :meth:`drop`."""
        spec = self._match(site, step,
                           exclude=("torn_write",) + DROP_KINDS)
        if spec is not None:
            self._act(spec)

    def write(self, path: str, data: bytes, site: str, step: int = -1) -> None:
        """Write ``data`` to ``path`` — unless a ``torn_write`` spec matches
        this point, in which case only ``keep_bytes`` of the payload reach
        the file (flushed + fsynced, so the torn prefix is really on disk)
        before the fault acts per ``spec.then``."""
        spec = self._match(site, step, only=("torn_write",))
        with open(path, "wb") as f:
            if spec is None:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
                return
            f.write(data[: max(spec.keep_bytes, 0)])
            f.flush()
            os.fsync(f.fileno())
        if spec.then == "kill":
            os._exit(137)
        raise InjectedFault(
            f"torn write at {site} (step {step}): kept "
            f"{max(spec.keep_bytes, 0)}/{len(data)} bytes of {path}")

    def drop(self, site: str, step: int = -1) -> bool:
        """True if a ``drop_frame``/``drop`` spec matches this point —
        the caller must then swallow the frame (or response) instead of
        sending it."""
        return self._match(site, step, only=DROP_KINDS) is not None

    # -- matching ------------------------------------------------------------
    def _match(self, site: str, step: int,
               exclude: tuple = (), only: Optional[tuple] = None
               ) -> Optional[FaultSpec]:
        for spec in self.plan.specs:
            if spec.site != site:
                continue
            if only is not None and spec.kind not in only:
                continue
            if spec.kind in exclude:
                continue
            if spec.superstep >= 0 and step >= 0 and spec.superstep != step:
                continue
            if (spec.rank >= 0 and self.rank is not None
                    and spec.rank != self.rank):
                continue
            if not self._claim(spec):
                continue
            self.fired.append(spec.spec_id())
            return spec
        return None

    def _claim(self, spec: FaultSpec) -> bool:
        """Claim the right to fire ``spec`` (False if a once-spec already
        fired — here, in a previous process, or on a peer sharing the
        marker_dir for a rank=-1 spec).  Claimed BEFORE acting so hard
        kills can't re-fire after a supervised restart."""
        if not spec.once:
            return True
        sid = spec.spec_id()
        if self.plan.marker_dir is not None:
            os.makedirs(self.plan.marker_dir, exist_ok=True)
            path = os.path.join(self.plan.marker_dir, sid + ".fired")
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return False
            os.close(fd)
            return True
        if sid in self._mem_claims:
            return False
        self._mem_claims.add(sid)
        return True

    # -- actions -------------------------------------------------------------
    def _act(self, spec: FaultSpec) -> None:
        if spec.kind == "raise":
            raise InjectedFault(
                f"injected fault at {spec.site} "
                f"(superstep {spec.superstep}, rank {spec.rank})")
        if spec.kind == "kill":
            os._exit(137)
        if spec.kind == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60)     # pragma: no cover - death is asynchronous
        if spec.kind == "preempt":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if spec.kind == "delay":
            time.sleep(spec.delay_seconds)
            return
        raise AssertionError(f"unhandled kind {spec.kind}")  # pragma: no cover
