"""Streaming synthetic graph generators.

R-MAT reproduces the power-law degree skew of the paper's web graphs
(Twitter-2010 / UK-2007 / ...), uniform graphs match the random-graph
assumption behind the paper's Eq. 4/5 memory model.  Generators yield
chunks so the SPE preprocessing path stays out-of-core end to end.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

EdgeChunk = tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


def uniform_edges(
    num_vertices: int,
    num_edges: int,
    seed: int = 0,
    weighted: bool = False,
    chunk: int = 1 << 20,
) -> Iterator[EdgeChunk]:
    """Uniform random directed edges in chunks of ``chunk`` (matches the
    random-graph assumption behind the paper's Eq. 4/5 memory model)."""
    rng = np.random.default_rng(seed)
    left = num_edges
    while left > 0:
        n = min(chunk, left)
        src = rng.integers(0, num_vertices, n, dtype=np.int64)
        dst = rng.integers(0, num_vertices, n, dtype=np.int64)
        val = rng.uniform(0.1, 10.0, n).astype(np.float32) if weighted else None
        yield src, dst, val
        left -= n


def rmat_edges(
    num_vertices: int,
    num_edges: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    weighted: bool = False,
    chunk: int = 1 << 20,
    threads: int = 1,
) -> Iterator[EdgeChunk]:
    """R-MAT (Graph500 parameters by default): recursive quadrant sampling,
    vectorized over a chunk of edges at a time.

    Each chunk's generator is the seed's PCG64 (``default_rng(seed)``'s)
    advanced past the draws of the chunks before it, one 64-bit draw a
    double, so the stream is one generator's whatever ``threads`` is; with
    ``threads > 1`` a thread pool draws the chunks (numpy releases the GIL
    in its bulk draws and elementwise ops)."""
    scale = int(np.ceil(np.log2(max(num_vertices, 2))))
    d = 1.0 - a - b - c
    assert d >= -1e-9
    sizes = [min(chunk, num_edges - lo) for lo in range(0, num_edges, chunk)]
    draw = dict(num_vertices=num_vertices, scale=scale, a=a, b=b, c=c, d=d,
                weighted=weighted)
    per_edge = 2 * scale + int(weighted)    # doubles drawn for one edge

    def one(i):
        bits = np.random.PCG64(seed)
        bits.advance(per_edge * chunk * i)     # every earlier chunk is full
        return _rmat_chunk(np.random.Generator(bits), sizes[i], **draw)

    yield from ordered_map(one, len(sizes), threads)


def ordered_map(fn, n: int, threads: int):
    """``fn(0), ..., fn(n - 1)`` in order, computed on ``threads`` threads
    at most ``2 * threads`` ahead of the consumer."""
    if threads <= 1:
        yield from (fn(i) for i in range(n))
        return
    with ThreadPoolExecutor(threads) as pool:
        ahead = deque(pool.submit(fn, i) for i in range(min(2 * threads, n)))
        nxt = len(ahead)
        while ahead:
            out = ahead.popleft().result()
            if nxt < n:
                ahead.append(pool.submit(fn, nxt))
                nxt += 1
            yield out


def _rmat_chunk(rng, n, num_vertices, scale, a, b, c, d, weighted):
    src = np.zeros(n, dtype=np.int64)
    dst = np.zeros(n, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(n)
        # quadrant probabilities: [a b; c d] over (src_bit, dst_bit)
        src_bit = r >= (a + b)
        r2 = rng.random(n)
        dst_bit = np.where(
            src_bit,
            r2 >= (c / max(c + d, 1e-12)),
            r2 >= (a / max(a + b, 1e-12)),
        )
        src = (src << 1) | src_bit.astype(np.int64)
        dst = (dst << 1) | dst_bit.astype(np.int64)
    src %= num_vertices
    dst %= num_vertices
    val = rng.uniform(0.1, 10.0, n).astype(np.float32) if weighted else None
    return src, dst, val


def banded_edges(
    num_vertices: int,
    num_edges: int,
    bandwidth: int = 0,
    seed: int = 0,
    weighted: bool = False,
    chunk: int = 1 << 20,
) -> Iterator[EdgeChunk]:
    """Locality-structured graph: src falls within ``bandwidth`` of dst
    (wrapping), like meshes / road networks / time-ordered interaction
    graphs.  Tiles of such graphs touch only a few *source intervals*, so
    this is the workload where interval-aware co-scheduling of the
    out-of-core vertex state shows up (DESIGN.md §10); R-MAT/uniform src
    sets span all of V and every tile's footprint is everything."""
    w = bandwidth or max(1, num_vertices // 16)
    rng = np.random.default_rng(seed)
    left = num_edges
    while left > 0:
        n = min(chunk, left)
        dst = rng.integers(0, num_vertices, n, dtype=np.int64)
        off = rng.integers(-w, w + 1, n, dtype=np.int64)
        src = (dst + off) % num_vertices
        val = rng.uniform(0.1, 10.0, n).astype(np.float32) if weighted else None
        yield src, dst, val
        left -= n


def from_arrays(
    src: np.ndarray, dst: np.ndarray, val: Optional[np.ndarray] = None,
    chunk: int = 1 << 20,
) -> Iterator[EdgeChunk]:
    """Wrap in-memory edge arrays as a chunked stream (test/benchmark aid)."""
    for i in range(0, len(src), chunk):
        s = slice(i, i + chunk)
        yield (
            np.asarray(src[s], dtype=np.int64),
            np.asarray(dst[s], dtype=np.int64),
            None if val is None else np.asarray(val[s], dtype=np.float32),
        )


def symmetrized(stream: Iterator[EdgeChunk]) -> Iterator[EdgeChunk]:
    """Emit each edge in both directions (for WCC on directed inputs)."""
    for src, dst, val in stream:
        yield np.concatenate([src, dst]), np.concatenate([dst, src]), (
            None if val is None else np.concatenate([val, val])
        )
