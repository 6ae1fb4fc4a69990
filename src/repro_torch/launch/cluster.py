"""Cluster launcher of the port — so far only ``parse_admit_plan``, which
the in-process driver (``launch/graph.py``) uses for ``--admit``.  The
multi-process runtime is ROADMAP.md queue A.9."""
from __future__ import annotations

from typing import Optional


def parse_admit_plan(specs) -> Optional[tuple]:
    """``--admit`` specs -> ``EngineConfig.admit_plan``: each
    ``"SS:seed1,seed2"`` entry schedules those query seeds for admission
    at the end of superstep SS (batched apps only)."""
    if not specs:
        return None
    plan = []
    for spec in specs:
        try:
            ss, seeds = spec.split(":", 1)
            plan.append((int(ss), tuple(int(s)
                                        for s in seeds.split(","))))
        except ValueError:
            raise SystemExit(f"--admit {spec!r}: expected 'SS:seed,seed'")
    return tuple(sorted(plan))
