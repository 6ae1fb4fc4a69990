"""The port's tile scheduler (``runtime/scheduler.py``) on the CPU.

The cases of tests/test_runtime.py and the determinism case of
tests/test_lint_regressions.py, run on the port's copy, plus a check that
the port and the JAX package simulate the same superstep: equal makespan,
busy times, steals, speculative copies and winner of every tile.
"""
import numpy as np
import pytest

from repro_torch.core.partition import assign_tiles
from repro_torch.runtime.scheduler import (WorkStealingScheduler,
                                           simulate_superstep)


def _sched(n_tiles=32, n_servers=4, seed=0, **kw):
    rng = np.random.default_rng(seed)
    edges = rng.pareto(1.3, n_tiles) * 1000 + 100
    return (WorkStealingScheduler(assign_tiles(n_tiles, n_servers), edges,
                                  **kw), edges)


def test_all_tiles_complete_exactly_once():
    sched, edges = _sched()
    simulate_superstep(sched, np.ones(4), lambda t: edges[t])
    assert sched.all_done()
    assert all(t.completed_by is not None for t in sched.tasks.values())


def test_work_stealing_beats_static_with_skew():
    """One slow server: stealing shortens the makespan against static
    round-robin ownership."""
    speeds = np.array([1.0, 1.0, 1.0, 0.25])
    edges = np.random.default_rng(1).uniform(100, 1000, 64)
    sched = WorkStealingScheduler(assign_tiles(64, 4), edges,
                                  enable_speculation=False)
    dynamic = simulate_superstep(sched, speeds, lambda t: edges[t])
    assign = assign_tiles(64, 4)
    static_makespan = max(
        sum(edges[t] for t in assign[s]) / speeds[s] for s in range(4))
    assert dynamic["makespan"] < static_makespan * 0.75
    assert dynamic["steals"] > 0


def test_speculation_rescues_giant_tile_on_slow_server():
    """A dominating tile that starts at once on a slow server: only a
    speculative copy on a fast server bounds the makespan."""
    edges = np.array([100.0] * 16)
    edges[3] = 10_000.0
    speeds = np.array([1.0, 1.0, 1.0, 0.1])
    sched = WorkStealingScheduler(assign_tiles(16, 4), edges,
                                  enable_speculation=True,
                                  straggler_factor=2.0)
    dyn = simulate_superstep(sched, speeds, lambda t: edges[t])
    nospec = WorkStealingScheduler(assign_tiles(16, 4), edges,
                                   enable_speculation=False)
    base = simulate_superstep(nospec, speeds, lambda t: edges[t])
    assert base["makespan"] >= 10_000 / 0.1 * 0.99
    assert dyn["makespan"] < base["makespan"] * 0.25
    assert dyn["speculative"] >= 1


def test_speculative_execution_completes():
    sched, edges = _sched(16, 4, enable_speculation=True)
    simulate_superstep(sched, np.array([1, 1, 1, 0.05]), lambda t: edges[t])
    assert sched.all_done()


def test_completion_idempotent():
    sched, _ = _sched(4, 2)
    t = sched.next_tile(0)
    assert sched.complete(0, t) is True
    assert sched.complete(1, t) is False


def test_superstep_dispatch_is_run_deterministic():
    def run_once():
        sched, edges = _sched(48, 4, seed=3)
        stats = simulate_superstep(sched, np.array([1.0, 0.7, 1.3, 0.2]),
                                   lambda t: edges[t])
        winners = tuple(sched.tasks[t].completed_by
                        for t in sorted(sched.tasks))
        return stats["makespan"], tuple(stats["busy"]), winners

    assert run_once() == run_once()


@pytest.mark.parametrize("n_tiles,speeds,spec", [
    (32, (1.0, 1.0, 1.0, 1.0), True),
    (64, (1.0, 1.0, 1.0, 0.25), False),
    (48, (1.0, 0.7, 1.3, 0.2), True),
    (16, (1.0, 1.0, 1.0, 0.05), True),
    (24, (0.5, 2.0), True),
])
def test_simulation_equals_the_reference(n_tiles, speeds, spec):
    from repro.core.partition import assign_tiles as j_assign_tiles
    from repro.runtime import scheduler as jsched

    n = len(speeds)
    edges = np.random.default_rng(n_tiles).pareto(1.3, n_tiles) * 1000 + 100
    speeds = np.asarray(speeds)

    def simulate(pkg_sched, assign):
        sched = pkg_sched.WorkStealingScheduler(
            assign(n_tiles, n), edges, enable_speculation=spec,
            straggler_factor=2.0)
        stats = pkg_sched.simulate_superstep(sched, speeds,
                                             lambda t: edges[t])
        winners = [sched.tasks[t].completed_by for t in sorted(sched.tasks)]
        return (stats["makespan"], list(stats["busy"]), stats["steals"],
                stats["speculative"], winners)

    import repro_torch.runtime.scheduler as tsched
    assert simulate(tsched, assign_tiles) == simulate(jsched, j_assign_tiles)
