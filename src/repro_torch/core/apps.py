"""Vertex-centric applications implemented with GAB (paper Algorithms 6/7).

PageRank and SSSP follow the paper's pseudo-code exactly; WCC, BFS and
in-degree-count are standard extras exercising min/sum monoids.  The
hooks mirror ``repro/core/apps.py`` term for term, so each float
operation is the reference's.

Batched (multi-query) programs: PersonalizedPageRank, MultiSourceBFS and
LandmarkDistances evaluate Q program instances in one edge pass; vertex
state is ``[V, Q]`` and per-column convergence lets the engine retire
finished queries early.  Their hooks receive ``[E, Q]`` / ``[R, Q]``
tensors and broadcast the shared 1-D aux and edge terms explicitly, so
each column's float operations are those of a Q = 1 run of the same
program — a batched column equals its solo run bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from repro_torch.core.gab import VertexProgram
from repro_torch.kernels.gab_fused import FusedSpec


class _BatchedQueries:
    """Mixin giving batched programs a uniform query interface.

    ``query_field`` names the dataclass field holding the per-query seed
    tuple (``seeds``/``sources``/``landmarks``); ``queries`` reads it and
    ``with_queries`` rebuilds the program for a different batch (column
    math is independent of which other queries share the batch)."""

    query_field: ClassVar[str] = "seeds"

    @property
    def queries(self) -> tuple[int, ...]:
        """The per-query seed vertices, one query column per entry."""
        return tuple(getattr(self, self.query_field))

    @property
    def num_queries(self) -> int:
        """Q = number of seed vertices (one query column per seed)."""
        return len(self.queries)

    def with_queries(self, queries):
        """A copy of this program evaluating exactly ``queries`` columns."""
        return dataclasses.replace(self, **{self.query_field: tuple(queries)})


@dataclasses.dataclass(eq=False)
class PageRank(VertexProgram):
    """Paper Algorithm 6 — unnormalized damped PageRank.

    gather: sum of src.value / src.out_degree over in-edges
    apply : 0.15 + 0.85 * accum
    """

    damping: float = 0.85
    combine: str = "sum"
    src_aux: tuple[str, ...] = ("inv_out_degree",)
    dst_aux: tuple[str, ...] = ()
    update_tol: float = 1e-9

    def init(self, num_vertices, out_degree, in_degree, **kw):
        """Initial state: value [V] = 1.0 (float32) + inv_out_degree [V] src aux."""
        inv = np.zeros(num_vertices, dtype=np.float32)
        nz = out_degree > 0
        inv[nz] = 1.0 / out_degree[nz]
        return {
            "value": np.full(num_vertices, 1.0, dtype=np.float32),
            "inv_out_degree": inv,
        }

    def gather(self, src_value, edge_val, aux):
        """Per-edge message [E]: src rank · (1/out-degree · edge_val) —
        the fused kernel's association (its scale stream is a = inv · ev),
        which keeps the two paths equal on weighted edges (padding inert:
        edge_val == 0)."""
        return src_value * (aux["inv_out_degree"] * edge_val)

    def apply(self, old_value, accum, aux):
        """Damped update over [R] rows: (1 - d) + d * accum."""
        return (1.0 - self.damping) + self.damping * accum

    def fused_spec(self):
        """Fused form: contrib = src · (inv_out_degree · edge_val), damped
        affine apply."""
        return FusedSpec(combine="sum", scale_aux="inv_out_degree",
                         apply="affine", alpha=1.0 - self.damping,
                         beta=self.damping, update_tol=self.update_tol)


@dataclasses.dataclass(eq=False)
class SSSP(VertexProgram):
    """Paper Algorithm 7 — single-source shortest paths (min-plus)."""

    source: int = 0
    combine: str = "min"
    src_aux: tuple[str, ...] = ()
    dst_aux: tuple[str, ...] = ()

    def init(self, num_vertices, out_degree, in_degree, **kw):
        """Initial state: value [V] = +inf except 0.0 at ``source`` (float32)."""
        v = np.full(num_vertices, np.inf, dtype=np.float32)
        v[self.source] = 0.0
        return {"value": v}

    def gather(self, src_value, edge_val, aux):
        """Min-plus message [E]: src distance + edge weight (inf stays inert)."""
        return src_value + edge_val

    def apply(self, old_value, accum, aux):
        """Relaxation over [R] rows: min(old distance, best incoming)."""
        return torch.minimum(old_value, accum)

    def fused_spec(self):
        """Fused form: contrib = src + edge_val, min-relax apply."""
        return FusedSpec(combine="min", add_edge=True, apply="min")


@dataclasses.dataclass(eq=False)
class WCC(VertexProgram):
    """Weakly-connected components by min-label propagation.  Run on a
    symmetrized edge set for true WCC semantics."""

    combine: str = "min"

    def init(self, num_vertices, out_degree, in_degree, **kw):
        """Initial state: value [V] = own vertex id as float32 label."""
        return {"value": np.arange(num_vertices, dtype=np.float32)}

    def gather(self, src_value, edge_val, aux):
        """Label message [E]: forward the src label unchanged."""
        return src_value

    def apply(self, old_value, accum, aux):
        """Label update over [R] rows: min(old label, smallest incoming)."""
        return torch.minimum(old_value, accum)

    def fused_spec(self):
        """Fused form: contrib = src (label forward), min-merge apply."""
        return FusedSpec(combine="min", apply="min")


@dataclasses.dataclass(eq=False)
class BFS(VertexProgram):
    """Level-synchronous BFS (hop counts) from ``source``."""

    source: int = 0
    combine: str = "min"

    def init(self, num_vertices, out_degree, in_degree, **kw):
        """Initial state: value [V] = +inf hops except 0.0 at ``source``."""
        v = np.full(num_vertices, np.inf, dtype=np.float32)
        v[self.source] = 0.0
        return {"value": v}

    def gather(self, src_value, edge_val, aux):
        """Hop message [E]: src hop count + 1."""
        return src_value + 1.0

    def apply(self, old_value, accum, aux):
        """Hop update over [R] rows: min(old, best incoming)."""
        return torch.minimum(old_value, accum)

    def fused_spec(self):
        """Fused form: contrib = src + 1, min-relax apply."""
        return FusedSpec(combine="min", add_const=1.0, apply="min")


@dataclasses.dataclass(eq=False)
class InDegree(VertexProgram):
    """Sanity app: value converges to in-degree after one superstep.  It
    has no fused form, so the ``"fused"`` path runs the segment kernel."""

    combine: str = "sum"

    def init(self, num_vertices, out_degree, in_degree, **kw):
        """Initial state: value [V] = 0.0 counts."""
        return {"value": np.zeros(num_vertices, dtype=np.float32)}

    def gather(self, src_value, edge_val, aux):
        """Count message [E]: 1.0 per real edge, 0.0 for padding."""
        return edge_val * 0.0 + torch.where(edge_val > 0, 1.0, 0.0)

    def apply(self, old_value, accum, aux):
        """Replace with the summed count over [R] rows."""
        return accum


# ---------------------------------------------------------------------------
# Batched multi-query programs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class PersonalizedPageRank(_BatchedQueries, VertexProgram):
    """Q-seed personalized PageRank: column q solves
    ``pr = (1-d) * e_{seed_q} + d * P^T pr`` — teleport mass concentrated
    on that query's seed vertex instead of spread uniformly."""

    seeds: tuple[int, ...] = (0,)
    damping: float = 0.85
    combine: str = "sum"
    src_aux: tuple[str, ...] = ("inv_out_degree",)
    dst_aux: tuple[str, ...] = ("seed_mass",)
    update_tol: float = 1e-9

    def init(self, num_vertices, out_degree, in_degree, **kw):
        """Initial state: value [V, Q] = seed one-hot mass; inv_out_degree [V]
        (shared) + seed_mass [V, Q] (per-query teleport vector)."""
        q = len(self.seeds)
        inv = np.zeros(num_vertices, dtype=np.float32)
        nz = out_degree > 0
        inv[nz] = 1.0 / out_degree[nz]
        seed_mass = np.zeros((num_vertices, q), dtype=np.float32)
        seed_mass[np.asarray(self.seeds, dtype=np.int64), np.arange(q)] = 1.0
        return {
            "value": seed_mass.copy(),   # start with all mass on the seed
            "inv_out_degree": inv,       # [V]: shared across queries
            "seed_mass": seed_mass,      # [V, Q]: per-query teleport vector
        }

    def gather(self, src_value, edge_val, aux):
        """Per-edge message [E, Q]: src mass scaled by the shared 1/out-degree
        factor broadcast over the query axis."""
        return src_value * (aux["inv_out_degree"] * edge_val)[:, None]

    def apply(self, old_value, accum, aux):
        """Damped update over [R, Q]: (1 - d) * seed_mass + d * accum."""
        return (1.0 - self.damping) * aux["seed_mass"] + self.damping * accum

    def fused_spec(self):
        """Fused form: contrib = src · (inv_out_degree · edge_val) per
        column, affine apply against the per-query seed_mass base."""
        return FusedSpec(combine="sum", scale_aux="inv_out_degree",
                         apply="affine", alpha=1.0 - self.damping,
                         beta=self.damping, base_aux="seed_mass",
                         update_tol=self.update_tol)


@dataclasses.dataclass(eq=False)
class MultiSourceBFS(_BatchedQueries, VertexProgram):
    """Level-synchronous BFS from Q sources at once (hop counts per column)."""

    sources: tuple[int, ...] = (0,)
    combine: str = "min"
    query_field: ClassVar[str] = "sources"

    def init(self, num_vertices, out_degree, in_degree, **kw):
        """Initial state: value [V, Q] = +inf hops except 0.0 at each source."""
        q = len(self.sources)
        v = np.full((num_vertices, q), np.inf, dtype=np.float32)
        v[np.asarray(self.sources, dtype=np.int64), np.arange(q)] = 0.0
        return {"value": v}

    def gather(self, src_value, edge_val, aux):
        """Hop message [E, Q]: src hop count + 1, per column."""
        return src_value + 1.0

    def apply(self, old_value, accum, aux):
        """Hop update over [R, Q]: min(old, best incoming) per column."""
        return torch.minimum(old_value, accum)

    def fused_spec(self):
        """Fused form: contrib = src + 1 per column, min-relax apply."""
        return FusedSpec(combine="min", add_const=1.0, apply="min")


@dataclasses.dataclass(eq=False)
class LandmarkDistances(_BatchedQueries, VertexProgram):
    """Weighted shortest-path distances from Q landmark vertices (min-plus)
    — the batched form of SSSP, e.g. for landmark-based distance oracles."""

    landmarks: tuple[int, ...] = (0,)
    combine: str = "min"
    query_field: ClassVar[str] = "landmarks"

    def init(self, num_vertices, out_degree, in_degree, **kw):
        """Initial state: value [V, Q] = +inf except 0.0 at each landmark."""
        q = len(self.landmarks)
        v = np.full((num_vertices, q), np.inf, dtype=np.float32)
        v[np.asarray(self.landmarks, dtype=np.int64), np.arange(q)] = 0.0
        return {"value": v}

    def gather(self, src_value, edge_val, aux):
        """Min-plus message [E, Q]: src distance + edge weight per column."""
        return src_value + edge_val[:, None]

    def apply(self, old_value, accum, aux):
        """Relaxation over [R, Q]: min(old, best incoming) per column."""
        return torch.minimum(old_value, accum)

    def fused_spec(self):
        """Fused form: contrib = src + edge_val per column, min-relax."""
        return FusedSpec(combine="min", add_edge=True, apply="min")


APPS = {
    "pagerank": PageRank,
    "sssp": SSSP,
    "wcc": WCC,
    "bfs": BFS,
    "indegree": InDegree,
    "ppr": PersonalizedPageRank,
    "msbfs": MultiSourceBFS,
    "landmarks": LandmarkDistances,
}
