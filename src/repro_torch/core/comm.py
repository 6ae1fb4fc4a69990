"""Hybrid communication (paper §III-D-3) — the host half.

Dense mode ships a |V| value array (+ update bitvector); sparse mode ships
(index, value) pairs for updated vertices only.  The paper switches to
sparse when the updated ratio drops below a threshold (0.4), and compresses
payloads (snappy by default).

This is the host accounting the out-of-core engine uses to measure real
payload bytes per superstep, including real compression of the actual
buffers (paper Fig. 9), plus the session admission records.  It is numpy
throughout and matches ``repro/core/comm.py`` byte for byte.  The device
collectives (``hybrid_broadcast`` and friends) are ROADMAP.md queue A.8,
the 2-D ``[V, Q]`` payloads queue A.5, the per-interval payloads A.6.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch import compat
from repro_torch.graphio import formats

DENSITY_THRESHOLD = 0.4  # paper's sparsity switch point

# compressor name -> formats.MODE_CODECS mode (paper default: snappy; we use
# the zstd ladder, transparently zlib when zstandard is absent — compat.py)
COMPRESSORS = {"none": 1, "zstd-1": 2, "zstd-3": 3, "zstd-9": 4}


def resolve_compressor(name: str) -> tuple[int, str]:
    """Validate a compressor name and return (mode, actual codec label) —
    the label reflects what will really run, e.g. ``zlib-1`` when
    repro.compat has fallen back from zstd to stdlib zlib."""
    mode = COMPRESSORS.get(name)
    if mode is None:
        raise ValueError(
            f"unknown compressor {name!r}; valid: {', '.join(sorted(COMPRESSORS))}")
    if mode == 1:
        return mode, "none"
    _, level = formats.MODE_CODECS[mode]
    return mode, f"{'zstd' if compat.HAVE_ZSTD else 'zlib'}-{level}"


# ---------------------------------------------------------------------------
# Host-side accounting (out-of-core engine / benchmarks)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BroadcastRecord:
    """Measured size of one server's per-superstep broadcast payload
    (bytes pre/post compression + the mode the planner chose)."""
    mode: str                 # "dense" | "sparse" | "mixed" (2-D payloads)
    raw_bytes: int            # pre-compression payload
    wire_bytes: int           # post-compression payload
    density: float
    compressor: str
    # multi-query payloads: per-query-column mode choices ("dense"/"sparse"),
    # None for classic 1-D payloads
    query_modes: Optional[tuple] = None
    # interval-sharded payloads (DESIGN.md §10): number of dirty intervals
    # shipped; None for classic whole-V payloads
    intervals: Optional[int] = None


def dense_payload(values: np.ndarray, updated: np.ndarray) -> bytes:
    """Dense wire payload: ``ceil(V/8)``-byte update bitvector followed by
    the full ``[V]`` value array (raw little-endian bytes).  Inverse:
    :func:`decode_dense_payload`."""
    bitvec = np.packbits(updated.astype(np.uint8))
    return bitvec.tobytes() + values.tobytes()


def sparse_payload(values: np.ndarray, updated: np.ndarray) -> bytes:
    """Sparse wire payload: ``[U]`` uint32 updated vertex ids followed by
    their ``[U]`` values (raw bytes).  Inverse:
    :func:`decode_sparse_payload`."""
    idx = np.nonzero(updated)[0].astype(np.uint32)
    return idx.tobytes() + values[idx].tobytes()


def decode_dense_payload(buf: bytes, nv: int,
                         dtype) -> tuple[np.ndarray, np.ndarray]:
    """Invert :func:`dense_payload`: returns (updated vertex ids ``[U]``,
    their values ``[U]``) — value bytes round-trip exactly (no float
    re-encoding), which is what keeps cluster results bit-identical."""
    dtype = np.dtype(dtype)
    nb = (nv + 7) // 8
    bits = np.unpackbits(np.frombuffer(buf, np.uint8, count=nb))[:nv]
    vals = np.frombuffer(buf, dtype, count=nv, offset=nb)
    idx = np.nonzero(bits)[0].astype(np.int64)
    return idx, vals[idx].copy()


def decode_sparse_payload(buf: bytes, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Invert :func:`sparse_payload`: returns (updated vertex ids ``[U]``,
    values ``[U]``).  The entry count is derived from the byte length
    (each entry is 4 index bytes + one value)."""
    dtype = np.dtype(dtype)
    per = 4 + dtype.itemsize
    count = len(buf) // per
    idx = np.frombuffer(buf, np.uint32, count=count).astype(np.int64)
    vals = np.frombuffer(buf, dtype, count=count, offset=4 * count)
    return idx, vals.copy()


def plan_broadcast(
    values: np.ndarray,
    updated: np.ndarray,
    threshold: float = DENSITY_THRESHOLD,
    compressor: str = "zstd-1",       # paper default: snappy
    mode: str = "hybrid",             # "dense" | "sparse" | "hybrid"
) -> BroadcastRecord:
    """Measure one server's broadcast payload over values ``[V]`` and the
    updated mask ``[V]`` (the 2-D ``[V, Q]`` payloads are ROADMAP.md queue
    A.5)."""
    if values.ndim != 1:
        raise NotImplementedError(
            "[V, Q] broadcast payloads are ROADMAP.md queue A.5")
    comp_mode, codec = resolve_compressor(compressor)
    density = float(updated.mean()) if updated.size else 0.0
    use_dense = mode == "dense" or (mode == "hybrid" and density >= threshold)
    payload = (dense_payload(values, updated) if use_dense
               else sparse_payload(values, updated))
    raw = len(payload)
    wire = len(formats.compress_blob(payload, comp_mode))
    return BroadcastRecord(
        mode="dense" if use_dense else "sparse", raw_bytes=raw,
        wire_bytes=wire, density=density, compressor=codec,
    )


def wire_bytes_estimate(num_vertices: int, density: float, itemsize: int = 4,
                        threshold: float = DENSITY_THRESHOLD,
                        index_bytes: int = 4) -> int:
    """Analytic per-server payload size (paper Fig. 9 model).

    ``index_bytes`` is the per-update index overhead on the sparse path:
    4 for classic 1-D payloads (uint32 vertex), 8 for multi-query 2-D
    payloads (uint32 vertex + uint32 query pair) — callers estimating a
    flattened [V, Q] payload pass ``num_vertices=V*Q, index_bytes=8``."""
    if density >= threshold:
        # bitvector is np.packbits output: ceil(V / 8) bytes
        return (num_vertices + 7) // 8 + num_vertices * itemsize
    u = int(density * num_vertices)
    return u * (index_bytes + itemsize)


# ---------------------------------------------------------------------------
# Session admission records (DESIGN.md §13)
# ---------------------------------------------------------------------------

def pack_admissions(admit=(), drain=(), pending: int = 0):
    """Pack a barrier's admission control record, or ``None`` when empty.

    ``admit`` is a sequence of ``(global qid, seed vertex)`` pairs for the
    query columns every rank must splice at this barrier; ``drain`` the
    global qids to force-retire; ``pending`` the number of queries still
    queued behind the slot limit (peers use it to keep the superstep loop
    alive while rank 0 has admissible backlog).  The record is JSON-safe —
    it rides in the transport frame header (``encode_frame(control=...)``)
    so all ranks see it at the same barrier as the update set."""
    admit = [[int(g), int(s)] for g, s in admit]
    drain = [int(g) for g in drain]
    if not admit and not drain and not pending:
        return None
    return {"admit": admit, "drain": drain, "pending": int(pending)}


def unpack_admissions(control) -> tuple[list, list, int]:
    """Invert :func:`pack_admissions`; ``None`` means an empty record."""
    if not control:
        return [], [], 0
    return (
        [(int(g), int(s)) for g, s in control.get("admit", [])],
        [int(g) for g in control.get("drain", [])],
        int(control.get("pending", 0)),
    )
