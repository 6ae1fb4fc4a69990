"""Hybrid communication (paper §III-D-3) — the host half.

Dense mode ships a |V| value array (+ update bitvector); sparse mode ships
(index, value) pairs for updated vertices only.  The paper switches to
sparse when the updated ratio drops below a threshold (0.4), and compresses
payloads (snappy by default).

This is the host accounting the out-of-core engine uses to measure real
payload bytes per superstep, including real compression of the actual
buffers (paper Fig. 9) — inline, or on a small executor that overlaps
compression with the next server's compute (pipelined engine) — plus the
session admission records.  It is numpy throughout and matches
``repro/core/comm.py`` byte for byte, for ``[V]`` and multi-query
``[V, Q]`` payloads alike, and for the out-of-core engine's
per-dirty-interval payloads.  The device collectives
(``hybrid_broadcast`` and friends) are ROADMAP.md queue A.8.
"""
from __future__ import annotations

import atexit
import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor
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


def multi_query_payload(
    values: np.ndarray,          # [V, Q]
    updated: np.ndarray,         # [V, Q] bool
    threshold: float = DENSITY_THRESHOLD,
    mode: str = "hybrid",
) -> tuple[bytes, tuple]:
    """2-D broadcast payload over values ``[V, Q]`` and the bool updated
    mask ``[V, Q]``: density is measured *per query column*.  Dense columns
    ship a ceil(V/8) bitvector + the full column; sparse columns pool their
    updates into one packed section of (vertex: uint32, query: uint32)
    pairs followed by the values.  Returns (payload bytes, per-column mode
    tuple)."""
    nv, nq = values.shape
    parts: list[bytes] = []
    modes: list[str] = []
    sp_pairs: list[np.ndarray] = []
    sp_vals: list[np.ndarray] = []
    for q in range(nq):
        col_upd = updated[:, q]
        density_q = float(col_upd.mean()) if nv else 0.0
        use_dense = mode == "dense" or (mode == "hybrid"
                                        and density_q >= threshold)
        if use_dense:
            parts.append(dense_payload(values[:, q], col_upd))
            modes.append("dense")
        else:
            idx = np.nonzero(col_upd)[0].astype(np.uint32)
            sp_pairs.append(np.stack(
                [idx, np.full(idx.shape, q, dtype=np.uint32)], axis=1))
            sp_vals.append(values[idx, q])
            modes.append("sparse")
    if sp_pairs:
        pairs = np.concatenate(sp_pairs, axis=0)
        vals = np.concatenate(sp_vals, axis=0)
        parts.append(pairs.tobytes() + vals.tobytes())
    return b"".join(parts), tuple(modes)


def decode_multi_query_payload(
    buf: bytes, nv: int, qmodes: tuple, dtype,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Invert :func:`multi_query_payload` given the per-column mode tuple.

    Returns (updated vertex ids ``[U]``, values ``[U, Q]``, per-query
    updated mask ``[U, Q]``) — the sparse-update triple the engine's
    barrier applies.  Cells where the mask is False hold zeros; the engine
    only applies masked cells, so this is lossless."""
    dtype = np.dtype(dtype)
    nq = len(qmodes)
    off = 0
    cell_v: list[np.ndarray] = []
    cell_q: list[np.ndarray] = []
    cell_val: list[np.ndarray] = []
    for q, m in enumerate(qmodes):
        if m != "dense":
            continue
        nb = (nv + 7) // 8
        col_idx, col_vals = decode_dense_payload(
            buf[off: off + nb + nv * dtype.itemsize], nv, dtype)
        off += nb + nv * dtype.itemsize
        cell_v.append(col_idx)
        cell_q.append(np.full(col_idx.shape, q, dtype=np.int64))
        cell_val.append(col_vals)
    if any(m == "sparse" for m in qmodes):
        rest = buf[off:]
        per = 8 + dtype.itemsize
        count = len(rest) // per
        pairs = np.frombuffer(rest, np.uint32, count=2 * count).reshape(-1, 2)
        vals = np.frombuffer(rest, dtype, count=count, offset=8 * count)
        cell_v.append(pairs[:, 0].astype(np.int64))
        cell_q.append(pairs[:, 1].astype(np.int64))
        cell_val.append(vals.copy())
    if not cell_v:
        return (np.zeros(0, np.int64), np.zeros((0, nq), dtype),
                np.zeros((0, nq), dtype=bool))
    v = np.concatenate(cell_v)
    qcol = np.concatenate(cell_q)
    cval = np.concatenate(cell_val)
    idx, inv = np.unique(v, return_inverse=True)
    vals_out = np.zeros((len(idx), nq), dtype)
    mask_out = np.zeros((len(idx), nq), dtype=bool)
    vals_out[inv, qcol] = cval
    mask_out[inv, qcol] = True
    return idx, vals_out, mask_out


def plan_broadcast(
    values: np.ndarray,
    updated: np.ndarray,
    threshold: float = DENSITY_THRESHOLD,
    compressor: str = "zstd-1",       # paper default: snappy
    mode: str = "hybrid",             # "dense" | "sparse" | "hybrid"
) -> BroadcastRecord:
    """Measure one server's broadcast payload.  ``values``/``updated`` are
    ``[V]`` (classic) or ``[V, Q]`` (multi-query; per-column mode choice,
    see :func:`multi_query_payload`)."""
    comp_mode, codec = resolve_compressor(compressor)
    density = float(updated.mean()) if updated.size else 0.0
    if values.ndim == 2:
        payload, qmodes = multi_query_payload(values, updated, threshold,
                                              mode)
        uniq = set(qmodes)
        rec_mode = "sparse" if not qmodes else (
            qmodes[0] if len(uniq) == 1 else "mixed")
    else:
        use_dense = mode == "dense" or (mode == "hybrid"
                                        and density >= threshold)
        payload = (dense_payload(values, updated) if use_dense
                   else sparse_payload(values, updated))
        rec_mode, qmodes = ("dense" if use_dense else "sparse"), None
    raw = len(payload)
    wire = len(formats.compress_blob(payload, comp_mode))
    return BroadcastRecord(
        mode=rec_mode, raw_bytes=raw, wire_bytes=wire, density=density,
        compressor=codec, query_modes=qmodes,
    )


# 8-byte header per dirty-interval section: (interval id: u32, count: u32).
INTERVAL_HEADER_BYTES = 8


def plan_broadcast_intervals(
    idx: np.ndarray,              # [U] updated global vertex ids
    vals: np.ndarray,             # [U] or [U, Q] updated values
    mask: Optional[np.ndarray],   # [U, Q] per-query updated mask, or None
    splitter: np.ndarray,         # int64[K + 1] interval boundaries
    threshold: float = DENSITY_THRESHOLD,
    compressor: str = "zstd-1",
    mode: str = "hybrid",
) -> BroadcastRecord:
    """Measure one server's broadcast sharded per *dirty interval*
    (DESIGN.md §10) instead of one whole-V payload.  Shapes: idx ``[U]``
    global vertex ids, vals ``[U(, Q)]``, mask ``[U, Q]`` or None,
    splitter ``[K+1]`` interval boundaries.

    Each interval that received updates ships its own section — an 8-byte
    (interval id, count) header plus a :func:`plan_broadcast` payload built
    over that interval's local vertex range — so receivers holding their
    vertex state out of core apply updates block by block and clean
    intervals cost zero bytes.  Density on the sparse/dense switch is
    *local* to the interval, which is strictly better than the global
    switch when updates cluster (a dense-in-one-interval frontier no
    longer drags the whole |V| array onto the wire)."""
    _, codec = resolve_compressor(compressor)
    splitter = np.asarray(splitter, dtype=np.int64)
    nv = int(splitter[-1])
    qa = vals.shape[1] if vals.ndim == 2 else None
    cells = nv * (qa or 1)
    if len(idx) == 0:
        return BroadcastRecord(mode="interval", raw_bytes=0, wire_bytes=0,
                               density=0.0, compressor=codec, intervals=0)
    ivs = np.searchsorted(splitter, idx, side="right") - 1
    raw = wire = 0
    count = 0
    updated_cells = 0
    for iv in np.unique(ivs):
        lo, hi = int(splitter[iv]), int(splitter[iv + 1])
        sel = ivs == iv
        local = idx[sel] - lo
        n = hi - lo
        if qa is not None:
            dense = np.zeros((n, qa), dtype=vals.dtype)
            upd = np.zeros((n, qa), dtype=bool)
            dense[local] = vals[sel]
            upd[local] = mask[sel]
        else:
            dense = np.zeros(n, dtype=vals.dtype)
            upd = np.zeros(n, dtype=bool)
            dense[local] = vals[sel]
            upd[local] = True
        rec = plan_broadcast(dense, upd, threshold=threshold,
                             compressor=compressor, mode=mode)
        raw += rec.raw_bytes + INTERVAL_HEADER_BYTES
        wire += rec.wire_bytes + INTERVAL_HEADER_BYTES
        count += 1
        updated_cells += int(upd.sum())
    return BroadcastRecord(
        mode="interval", raw_bytes=raw, wire_bytes=wire,
        density=updated_cells / max(cells, 1), compressor=codec,
        intervals=count,
    )


def plan_broadcast_intervals_async(*args, **kw) -> "Future[BroadcastRecord]":
    """Submit :func:`plan_broadcast_intervals` onto the comm executor."""
    return _comm_pool().submit(plan_broadcast_intervals, *args, **kw)


# Payload compression is CPU-bound byte work with no dependence on the next
# server's gather/apply, so the pipelined engine ships it to a small executor
# and collects the BroadcastRecords at the superstep barrier.  Two workers:
# one per in-flight payload is plenty, and zlib/zstd release the GIL.  The
# executor starts at first use, never at import.
_COMM_POOL: Optional[ThreadPoolExecutor] = None
_COMM_POOL_LOCK = threading.Lock()


def _comm_pool() -> ThreadPoolExecutor:
    # Double-checked locking: concurrent first callers share ONE executor,
    # shut down at interpreter exit instead of leaking its worker threads.
    global _COMM_POOL
    pool = _COMM_POOL
    if pool is None:
        with _COMM_POOL_LOCK:
            if _COMM_POOL is None:
                _COMM_POOL = ThreadPoolExecutor(
                    max_workers=2, thread_name_prefix="graphh-comm")
                atexit.register(_shutdown_comm_pool)
            pool = _COMM_POOL
    return pool


def _shutdown_comm_pool() -> None:
    global _COMM_POOL
    with _COMM_POOL_LOCK:
        pool, _COMM_POOL = _COMM_POOL, None
    if pool is not None:
        pool.shutdown(wait=False)


def plan_broadcast_async(
    values: np.ndarray,
    updated: np.ndarray,
    threshold: float = DENSITY_THRESHOLD,
    compressor: str = "zstd-1",
    mode: str = "hybrid",
) -> "Future[BroadcastRecord]":
    """Submit :func:`plan_broadcast` onto the comm executor over values
    ``[V(, Q)]`` and the updated mask ``[V(, Q)]``.  The caller owns
    ``values``/``updated`` after submission — pass freshly built arrays."""
    return _comm_pool().submit(plan_broadcast, values, updated,
                               threshold=threshold, compressor=compressor,
                               mode=mode)


def sparse_capacity(num_vertices: int, threshold: float = DENSITY_THRESHOLD,
                    align: int = 128) -> int:
    """Static capacity for the sparse branch: density < threshold by
    construction, so ceil(threshold * V) entries always suffice (rounded
    up to ``align``, at most V)."""
    k = int(np.ceil(num_vertices * threshold))
    return min(num_vertices, ((k + align - 1) // align) * align)


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
