"""Tile-skipping filters (paper §III-C-4).

The paper leaves a bloom filter per tile recording its source-vertex set;
a tile whose sources contain no updated vertex is skipped.  We provide:

  * ``BloomFilter``       — the paper-faithful probabilistic filter
  * ``SourceBlockBitmap`` — beyond-paper *exact* filter at block granularity
                            (1 bit per 2^k-vertex block), vectorizable with
                            a single AND over uint64 words.

Both are host-side scheduling structures; the engine enables skipping only
when the updated-vertex count is small (paper: "only actives this strategy
when having a small number of updated vertices").
"""
from __future__ import annotations

import numpy as np

_MIX1 = np.uint64(0xFF51AFD7ED558CCD)
_MIX2 = np.uint64(0xC4CEB9FE1A85EC53)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x *= _MIX1
        x ^= x >> np.uint64(33)
        x *= _MIX2
        x ^= x >> np.uint64(33)
    return x


class BloomFilter:
    """Vectorized k-hash bloom filter over vertex ids."""

    def __init__(self, num_bits: int = 1 << 16, num_hashes: int = 4):
        assert num_bits & (num_bits - 1) == 0, "num_bits must be a power of 2"
        self.num_bits = num_bits
        self.num_hashes = num_hashes
        self.bits = np.zeros(num_bits // 64, dtype=np.uint64)

    def _positions(self, ids: np.ndarray) -> np.ndarray:
        h1 = _mix64(np.asarray(ids, dtype=np.uint64))
        h2 = _mix64(h1 ^ _MIX2)
        ks = np.arange(self.num_hashes, dtype=np.uint64)[:, None]
        with np.errstate(over="ignore"):
            pos = (h1[None, :] + ks * h2[None, :]) & np.uint64(self.num_bits - 1)
        return pos  # [k, n]

    def add(self, ids: np.ndarray) -> None:
        """Set the k hash bits for every vertex id in ids ``[U]``
        (vectorized)."""
        pos = self._positions(ids).ravel()
        np.bitwise_or.at(self.bits, pos >> np.uint64(6),
                         np.uint64(1) << (pos & np.uint64(63)))

    def might_contain_any(self, ids: np.ndarray) -> bool:
        """True if ANY id in ids ``[U]`` may be present (no false negatives;
        false positives at the configured bits/hashes rate)."""
        if len(ids) == 0:
            return False
        pos = self._positions(ids)
        word = self.bits[(pos >> np.uint64(6)).astype(np.int64)]
        bit = (word >> (pos & np.uint64(63))) & np.uint64(1)
        return bool(np.any(bit.all(axis=0)))

    def nbytes(self) -> int:
        """Filter size in bytes (the per-tile scheduling-memory cost)."""
        return self.bits.nbytes


class SourceBlockBitmap:
    """Exact per-tile bitmap over vertex-id blocks of size 2^block_shift."""

    def __init__(self, num_vertices: int, block_shift: int = 8):
        self.block_shift = block_shift
        self.num_blocks = (num_vertices + (1 << block_shift) - 1) >> block_shift
        nwords = (self.num_blocks + 63) // 64
        self.words = np.zeros(nwords, dtype=np.uint64)

    def add(self, ids: np.ndarray) -> None:
        """Mark the 2^block_shift-vertex blocks covering ids ``[U]``."""
        blocks = np.unique(np.asarray(ids, dtype=np.int64) >> self.block_shift)
        np.bitwise_or.at(self.words, blocks >> 6,
                         np.uint64(1) << (blocks & 63).astype(np.uint64))

    def intersects(self, active_words: np.ndarray) -> bool:
        """Exact block-granular test: any common block with uint64 words
        active_words ``[B]`` (one AND; no false negatives)."""
        return bool(np.any(self.words & active_words))

    @staticmethod
    def active_words_from_ids(ids: np.ndarray, num_vertices: int,
                              block_shift: int = 8) -> np.ndarray:
        """Bitmap words ``[B]`` (B = ceil(blocks/64)) for an updated-vertex
        id set ids ``[U]`` — built once per superstep and tested against
        every tile filter."""
        bm = SourceBlockBitmap(num_vertices, block_shift)
        bm.add(ids)
        return bm.words

    def nbytes(self) -> int:
        """Bitmap size in bytes (the per-tile scheduling-memory cost)."""
        return self.words.nbytes


def build_tile_filters(tiles, num_vertices: int, kind: str = "bitmap",
                       block_shift: int = 8, bloom_bits: int = 1 << 16):
    """Build one filter per tile from its real source ids."""
    out = []
    for t in tiles:
        srcs = t.source_ids()
        if kind == "bitmap":
            f = SourceBlockBitmap(num_vertices, block_shift)
            f.add(srcs)
        else:
            f = BloomFilter(num_bits=bloom_bits)
            f.add(srcs)
        out.append(f)
    return out
