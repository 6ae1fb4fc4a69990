"""Two-stage graph partitioning (paper §III-A/B).

Stage 1 ("SPE"): split the input graph's edges into P tiles, 1-D by target
vertex, each holding ~S = |E|/P edges, target ranges contiguous.  The
splitter array is derived from the in-degree array exactly as the paper's
Algorithm 4: walk vertices in id order, open a new tile whenever the current
tile exceeds S edges.

Stage 2 ("MPE"): assign tile i to server ``i mod N`` (round-robin), and
within a server spread tiles over T workers.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PartitionPlan:
    """Output of stage 1: target-vertex splitter + static shape capacities."""

    num_vertices: int
    num_edges: int
    splitter: np.ndarray     # int64[P + 1]; tile t covers [splitter[t], splitter[t+1])
    edges_per_tile: np.ndarray  # int64[P]
    edge_cap: int            # padded edge capacity shared by all tiles
    row_cap: int             # padded row capacity shared by all tiles

    @property
    def num_tiles(self) -> int:
        """P = number of tiles (len(splitter) - 1)."""
        return len(self.splitter) - 1

    def tile_range(self, t: int) -> tuple[int, int]:
        """[row_start, row_end) target-vertex range of tile ``t``."""
        return int(self.splitter[t]), int(self.splitter[t + 1])

    def tile_of_vertex(self, v: int) -> int:
        """Owning tile of target vertex ``v`` (binary search on the splitter)."""
        return int(np.searchsorted(self.splitter, v, side="right") - 1)

    def to_dict(self) -> dict:
        """JSON-serializable form (stored in the tile store's meta.json)."""
        return dict(
            num_vertices=self.num_vertices,
            num_edges=self.num_edges,
            splitter=self.splitter.tolist(),
            edges_per_tile=self.edges_per_tile.tolist(),
            edge_cap=self.edge_cap,
            row_cap=self.row_cap,
        )

    @staticmethod
    def from_dict(d: dict) -> "PartitionPlan":
        """Inverse of ``to_dict``."""
        return PartitionPlan(
            num_vertices=d["num_vertices"],
            num_edges=d["num_edges"],
            splitter=np.asarray(d["splitter"], dtype=np.int64),
            edges_per_tile=np.asarray(d["edges_per_tile"], dtype=np.int64),
            edge_cap=d["edge_cap"],
            row_cap=d["row_cap"],
        )


def _round_up(x: int, mult: int) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


def make_splitter(in_degree: np.ndarray, tile_size: int) -> np.ndarray:
    """Paper Algorithm 4 lines 3-8: accumulate in-degrees in vertex-id order,
    cut a new tile once the running sum exceeds S.  Vectorized.

    Returns splitter int64[P+1] with splitter[0] == 0, splitter[-1] == |V|.
    """
    n = int(in_degree.shape[0])
    if n == 0:
        return np.array([0, 0], dtype=np.int64)
    csum = np.cumsum(in_degree.astype(np.int64))
    total = int(csum[-1])
    cuts = [0]
    # A tile closes at the first vertex where its running edge count > S.
    # Equivalent vectorized form: repeatedly searchsorted on the cumsum.
    base = 0
    pos = 0
    while pos < n:
        target = base + tile_size
        nxt = int(np.searchsorted(csum, target, side="left")) + 1
        nxt = min(max(nxt, pos + 1), n)
        cuts.append(nxt)
        base = int(csum[nxt - 1])
        pos = nxt
    assert base == total
    return np.asarray(cuts, dtype=np.int64)


def plan_partition(
    in_degree: np.ndarray,
    tile_size: int,
    pad_edges_to: int = 128,
    pad_rows_to: int = 128,
) -> PartitionPlan:
    """Stage 1: derive the tile splitter and shared static capacities
    from in_degree ``[V]``."""
    splitter = make_splitter(in_degree, tile_size)
    csum = np.concatenate([[0], np.cumsum(in_degree.astype(np.int64))])
    edges_per_tile = csum[splitter[1:]] - csum[splitter[:-1]]
    rows_per_tile = np.diff(splitter)
    edge_cap = _round_up(int(edges_per_tile.max(initial=1)), pad_edges_to)
    row_cap = _round_up(int(rows_per_tile.max(initial=1)), pad_rows_to)
    return PartitionPlan(
        num_vertices=int(in_degree.shape[0]),
        num_edges=int(edges_per_tile.sum()),
        splitter=splitter,
        edges_per_tile=np.asarray(edges_per_tile, dtype=np.int64),
        edge_cap=edge_cap,
        row_cap=row_cap,
    )


@dataclasses.dataclass
class IntervalPlan:
    """Source-interval plan for out-of-core vertex state (DESIGN.md §10).

    V is split into K contiguous intervals whose boundaries are *aligned to
    tile row ranges* (every interval boundary is a tile splitter entry), so
    each tile's target rows fall inside exactly one interval and a tile's
    dst-side state is a single block.  The src side of a tile may touch any
    subset of intervals — that subset is its *source-interval footprint*
    (recorded in ``TileMeta.src_intervals`` / computed lazily by the
    engine)."""

    splitter: np.ndarray        # int64[K + 1]; interval k = [splitter[k], splitter[k+1])
    tile_to_interval: np.ndarray  # int64[P]; owning interval of each tile's rows

    @property
    def num_intervals(self) -> int:
        """K = number of source intervals."""
        return len(self.splitter) - 1

    def interval_range(self, k: int) -> tuple[int, int]:
        """[lo, hi) vertex range of interval ``k``."""
        return int(self.splitter[k]), int(self.splitter[k + 1])

    def interval_of(self, vertex_ids) -> np.ndarray:
        """Owning interval id ``[U]`` per vertex id ``[U]`` (vectorized)."""
        return np.searchsorted(self.splitter, vertex_ids, side="right") - 1

    def to_dict(self) -> dict:
        """JSON-serializable form (stored in the tile store's meta.json)."""
        return dict(
            splitter=self.splitter.tolist(),
            tile_to_interval=self.tile_to_interval.tolist(),
        )

    @staticmethod
    def from_dict(d: dict) -> "IntervalPlan":
        """Inverse of ``to_dict``."""
        return IntervalPlan(
            splitter=np.asarray(d["splitter"], dtype=np.int64),
            tile_to_interval=np.asarray(d["tile_to_interval"], dtype=np.int64),
        )


def plan_intervals(tile_splitter: np.ndarray, num_intervals: int) -> IntervalPlan:
    """Group consecutive tiles into ``num_intervals`` vertex intervals of
    roughly |V|/K vertices each, given tile_splitter ``[P+1]``.  Boundaries
    are chosen *from the tile
    splitter*, so intervals always align to tile row ranges; K is clamped to
    the tile count when there are fewer tiles than requested intervals."""
    tile_splitter = np.asarray(tile_splitter, dtype=np.int64)
    nv = int(tile_splitter[-1])
    num_tiles = len(tile_splitter) - 1
    k = max(1, min(int(num_intervals), num_tiles))
    target = nv / k
    cuts = [0]
    for t in range(1, num_tiles):
        b = int(tile_splitter[t])
        if b >= len(cuts) * target and len(cuts) < k:
            cuts.append(b)
    cuts.append(nv)
    splitter = np.asarray(cuts, dtype=np.int64)
    t2i = np.searchsorted(splitter, tile_splitter[:-1], side="right") - 1
    return IntervalPlan(splitter=splitter,
                        tile_to_interval=t2i.astype(np.int64))


def assign_tiles(num_tiles: int, num_servers: int) -> list[list[int]]:
    """Stage 2 (paper §III-C-1): tile i -> server ``i mod N``."""
    out: list[list[int]] = [[] for _ in range(num_servers)]
    for t in range(num_tiles):
        out[t % num_servers].append(t)
    return out


def assign_tiles_balanced(
    edges_per_tile: np.ndarray, num_servers: int
) -> list[list[int]]:
    """Beyond-paper variant: greedy longest-processing-time assignment over
    edges_per_tile ``[P]``, which
    balances *edges* (not tile counts) per server.  Used by the scheduler when
    tiles have uneven real edge counts (last tile is usually short)."""
    order = np.argsort(-edges_per_tile)
    loads = np.zeros(num_servers, dtype=np.int64)
    out: list[list[int]] = [[] for _ in range(num_servers)]
    for t in order:
        s = int(np.argmin(loads))
        out[s].append(int(t))
        loads[s] += int(edges_per_tile[t])
    for lst in out:
        lst.sort()
    return out


def server_vertex_ranges(
    splitter: np.ndarray, assignment: list[list[int]]
) -> list[list[tuple[int, int]]]:
    """Per-server owned dst-vertex ranges from splitter ``[P+1]``, merged
    where contiguous.

    Server s owns the union of its tiles' row ranges — the vertices whose
    new values that server (and only that server) produces each superstep.
    The cluster runtime (DESIGN.md §11) reports these so an operator can
    see how stage-2 ownership maps onto the vertex space; tile stealing
    moves entries between servers but never overlaps them."""
    out: list[list[tuple[int, int]]] = []
    for tids in assignment:
        ranges = sorted((int(splitter[t]), int(splitter[t + 1]))
                        for t in tids)
        merged: list[tuple[int, int]] = []
        for lo, hi in ranges:
            if merged and merged[-1][1] == lo:
                merged[-1] = (merged[-1][0], hi)
            else:
                merged.append((lo, hi))
        out.append(merged)
    return out


def balance_stats(edges_per_tile: np.ndarray, assignment: list[list[int]]) -> dict:
    """Edge/tile balance metrics over edges_per_tile ``[P]`` (paper Fig. 5
    reproduces these per tile)."""
    per_server = np.array(
        [sum(int(edges_per_tile[t]) for t in ts) for ts in assignment], dtype=np.int64
    )
    return dict(
        per_server_edges=per_server.tolist(),
        max_over_mean=float(per_server.max() / max(per_server.mean(), 1e-9)),
        cv=float(per_server.std() / max(per_server.mean(), 1e-9)),
    )
