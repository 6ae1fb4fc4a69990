"""Vertex-centric applications implemented with GAB (paper Algorithms 6/7).

PageRank and SSSP follow the paper's pseudo-code exactly; WCC, BFS and
in-degree-count are standard extras exercising min/sum monoids.  The
hooks mirror ``repro/core/apps.py`` term for term, so each float
operation is the reference's.  The batched ``[V, Q]`` programs
(PersonalizedPageRank, MultiSourceBFS, LandmarkDistances) are ROADMAP.md
queue A.5.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gab import VertexProgram
from repro_torch.kernels.gab_fused import FusedSpec


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


APPS = {
    "pagerank": PageRank,
    "sssp": SSSP,
    "wcc": WCC,
    "bfs": BFS,
    "indegree": InDegree,
}

#: the reference's batched [V, Q] programs, not in this port yet
BATCHED_APPS = ("ppr", "msbfs", "landmarks")
