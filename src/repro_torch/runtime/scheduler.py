"""Tile scheduler: work stealing + straggler mitigation for the GAB engine.

The paper assigns tile i to server ``i mod N`` statically (its stage-2).
At 1000+ nodes two failure modes appear: (a) skewed tiles make some
servers finish late, (b) slow/flaky nodes straggle an entire BSP
superstep.  This module adds, beyond the paper:

  * WorkStealingScheduler — per-server deques; an idle server steals the
    largest pending tile from the most-loaded peer (locality-aware: the
    victim's cache keeps the tile, the thief reads from the shared store).
  * speculative re-execution — tiles still pending after
    ``straggler_factor x`` the median tile time are duplicated onto idle
    servers; BSP tile idempotence (disjoint dst ranges, pure gather/apply)
    makes duplicate completion safe: first writer wins, results identical.
  * rebalance_assignment — the *cluster-runtime* variant (DESIGN.md §11):
    between BSP supersteps, every server process runs this same pure
    function on the same replicated inputs (per-server measured compute
    seconds, shipped in the exchange frame headers) and deterministically
    moves tiles off stragglers, so all servers agree on the next
    superstep's ownership with no coordinator.

Scheduling is host-side (like the paper's MPE main loop); the engine uses
it to order cache fetches + device dispatches.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class TileTask:
    tile_id: int
    est_cost: float            # edges (proxy for runtime)
    started_at: dict = dataclasses.field(default_factory=dict)  # server -> t
    done: bool = False
    result: object = None
    completed_by: Optional[int] = None


class WorkStealingScheduler:
    def __init__(self, assignment: list[list[int]], edges_per_tile,
                 straggler_factor: float = 3.0,
                 enable_speculation: bool = True):
        self.n_servers = len(assignment)
        self.tasks = {}
        self.queues: list[deque] = []
        for s, tids in enumerate(assignment):
            q = deque()
            for t in tids:
                task = TileTask(t, float(edges_per_tile[t]))
                self.tasks[t] = task
                q.append(t)
            self.queues.append(q)
        self.straggler_factor = straggler_factor
        self.enable_speculation = enable_speculation
        self.steals = 0
        self.speculative = 0
        self.durations: list[float] = []

    # -- acquisition ----------------------------------------------------
    def next_tile(self, server: int, now: Optional[float] = None) -> Optional[int]:
        """Next tile for `server`: own queue, else steal, else speculate."""
        now = time.perf_counter() if now is None else now
        q = self.queues[server]
        while q:
            t = q.popleft()
            if not self.tasks[t].done:
                self.tasks[t].started_at[server] = now
                return t
        # steal from the most-loaded peer (largest pending work)
        victim = max(range(self.n_servers),
                     key=lambda s: sum(self.tasks[t].est_cost
                                       for t in self.queues[s]
                                       if not self.tasks[t].done))
        vq = self.queues[victim]
        while vq:
            t = vq.pop()           # steal from the tail (victim works the head)
            if not self.tasks[t].done:
                self.steals += 1
                self.tasks[t].started_at[server] = now
                return t
        if self.enable_speculation:
            t = self._speculative_candidate(server, now)
            if t is not None:
                self.speculative += 1
                self.tasks[t].started_at[server] = now
                return t
        return None

    def _speculative_candidate(self, server: int, now: float) -> Optional[int]:
        if not self.durations:
            return None
        median = float(np.median(self.durations))
        worst, worst_t = None, None
        # lint: allow(GH205): tasks built in ascending tile-id order on every rank
        for t, task in self.tasks.items():
            if task.done or not task.started_at or server in task.started_at:
                continue
            age = now - min(task.started_at.values())
            if age > self.straggler_factor * median and \
                    (worst is None or age > worst):
                worst, worst_t = age, t
        return worst_t

    # -- completion -----------------------------------------------------
    def complete(self, server: int, tile_id: int, result=None,
                 now: Optional[float] = None) -> bool:
        """First completion wins (idempotent tiles).  Returns True if this
        call was the winning one."""
        now = time.perf_counter() if now is None else now
        task = self.tasks[tile_id]
        if task.done:
            return False
        task.done = True
        task.result = result
        task.completed_by = server
        if server in task.started_at:
            self.durations.append(now - task.started_at[server])
        return True

    def all_done(self) -> bool:
        return all(t.done for t in self.tasks.values())

    def pending(self) -> list[int]:
        # lint: allow(GH205): tasks built in ascending tile-id order on every rank
        return [t for t, task in self.tasks.items() if not task.done]

    def stats(self) -> dict:
        return dict(steals=self.steals, speculative=self.speculative,
                    tiles=len(self.tasks))


def rebalance_assignment(
    assignment: list[list[int]],
    edges_per_tile,
    server_seconds: list[float],
    straggler_factor: float = 1.5,
    max_move_fraction: float = 0.5,
) -> Optional[tuple[list[list[int]], int]]:
    """Cross-server tile stealing at BSP-superstep granularity.

    A server whose measured compute time exceeded ``straggler_factor`` x
    the median is a straggler; its tiles are moved — largest pending cost
    first, matching :class:`WorkStealingScheduler`'s steal order — onto
    the servers with the lowest *projected* next-superstep time, until the
    straggler's projection drops under the threshold or
    ``max_move_fraction`` of its tiles have moved.  Projections use each
    server's measured per-edge rate (seconds / currently assigned edges),
    so a server that is slow because its *hardware* is slow keeps
    shedding work rather than reabsorbing it.

    Pure and deterministic: every cluster server calls this with identical
    replicated inputs and derives the identical new assignment (ties break
    toward lower server rank).  Tile movement never changes results —
    tiles own disjoint dst rows and gather/apply is pure.

    Returns (new assignment, tiles moved), or None when no server
    straggled (callers keep the old assignment and skip the churn).
    """
    n = len(assignment)
    if n < 2:
        return None
    secs = np.asarray(server_seconds, dtype=np.float64)
    med = float(np.median(secs))
    if med <= 0.0:
        return None
    threshold = straggler_factor * med
    stragglers = [s for s in range(n) if secs[s] > threshold]
    if not stragglers:
        return None
    new = [list(a) for a in assignment]
    edges = np.asarray(edges_per_tile, dtype=np.float64)
    load = np.array([sum(edges[t] for t in ts) for ts in new])
    # measured per-edge seconds; a server with no tiles inherits the
    # cluster-best rate (it is free capacity, not infinitely fast)
    rate = np.where(load > 0, secs / np.maximum(load, 1.0), np.inf)
    rate = np.where(np.isfinite(rate), rate, rate[np.isfinite(rate)].min())
    moved = 0
    for s in sorted(stragglers):
        budget = max(1, int(len(new[s]) * max_move_fraction))
        moved_s = 0
        order = sorted(new[s], key=lambda t: (-edges[t], t))
        for t in order:
            if load[s] * rate[s] <= threshold or moved_s >= budget:
                break
            proj = load * rate
            proj[s] = np.inf   # never "move" a tile onto the straggler
            d = int(np.argmin(proj))   # argmin ties break to lower rank
            if (load[d] + edges[t]) * rate[d] >= load[s] * rate[s]:
                break          # the move would just create a new straggler
            new[s].remove(t)
            new[d].append(t)
            load[s] -= edges[t]
            load[d] += edges[t]
            moved += 1
            moved_s += 1
    if moved == 0:
        return None
    return new, moved


def simulate_superstep(scheduler: WorkStealingScheduler,
                       server_speed: np.ndarray,
                       tile_cost_fn: Callable[[int], float]) -> dict:
    """Event-driven simulation of one BSP superstep under heterogeneous
    server speeds (used by tests + the straggler benchmark): returns
    makespan + per-server busy time.

    First completion of a duplicated tile wins; a preempted duplicate's
    server simply becomes idle at the winner's completion time (modeling
    the BSP barrier discard)."""
    import heapq

    n = scheduler.n_servers
    busy = np.zeros(n)
    idle: set[int] = set()
    events: list = []          # (end_time, server, tile)
    makespan = 0.0

    def try_dispatch(s: int, now: float) -> bool:
        tile = scheduler.next_tile(s, now=now)
        if tile is None:
            idle.add(s)
            return False
        dt = tile_cost_fn(tile) / server_speed[s]
        busy[s] += dt
        heapq.heappush(events, (now + dt, s, tile))
        idle.discard(s)
        return True

    for s in range(n):
        try_dispatch(s, 0.0)

    def earliest_speculation() -> Optional[float]:
        if not (scheduler.enable_speculation and scheduler.durations and idle):
            return None
        median = float(np.median(scheduler.durations))
        cands = [min(task.started_at.values())
                 + scheduler.straggler_factor * median
                 # lint: allow(GH205): folded with min() below — order-insensitive
                 for task in scheduler.tasks.values()
                 if not task.done and task.started_at
                 and not idle.issubset(set(task.started_at))]
        return min(cands) if cands else None

    while events:
        # idle servers may become speculation-eligible before the next event
        t_spec = earliest_speculation()
        if t_spec is not None and t_spec < events[0][0]:
            for i in sorted(idle):
                try_dispatch(i, t_spec + 1e-9)
        now, s, tile = heapq.heappop(events)
        won = scheduler.complete(s, tile, now=now)
        if won:
            makespan = max(makespan, now)
        try_dispatch(s, now)
        # completion events update median durations; idle servers re-check
        # for newly eligible speculative work
        for i in sorted(idle):
            try_dispatch(i, now)
        if not events and not scheduler.all_done():
            # all runnable work is in flight on slow servers and no event is
            # pending for the idle ones; advance to the earliest time at
            # which speculation becomes eligible
            if scheduler.enable_speculation and scheduler.durations and idle:
                median = float(np.median(scheduler.durations))
                t_next = min(
                    (min(task.started_at.values())
                     + scheduler.straggler_factor * median)
                    for task in scheduler.tasks.values() if not task.done)
                for i in sorted(idle):
                    try_dispatch(i, t_next + 1e-9)
            if not events:
                break
    return dict(makespan=float(makespan), busy=busy.tolist(),
                **scheduler.stats())
