"""Numpy models of the CUDA kernels' layouts, held to the orders they must
keep.  The kernels run only on the card; these models run here.

* ``fused_row`` is ``gab_fused.cu``'s order for one row and column: lane
  l of a warp combines edges lo + l, lo + l + 32, ... from the identity,
  then a butterfly at offsets 16, 8, 4, 2, 1 with ``combine(own,
  partner)`` on every lane; lane 0 is the result.
* ``segment_kernel`` is ``segment_reduce.cu``'s layout: blocks of 256
  rows, warps of 32 rows, rows of 1..32 edges packed into windows of 32
  edges with a tree over positions inside each row, longer rows on the
  whole warp, query columns in chunks; hub rows go to a second launch
  that finds each exactly once from multiples of HUB_EDGES (``hub_rows``)
  and streams it in chunks of a multiple of 32 edges (``hub_row``).

The two must agree bit for bit — the engine's merged mode (segment
kernel) is held bit for bit to its tiled mode (fused kernel) — for every
row length, column count and value, -0.0, infinities, NaN and subnormals
included, for sum, min and max.  Float arithmetic is float32
round-to-nearest with each step rounded (as ``__fadd_rn``), NaN results
canonical (as the card's), min/max as ``seg_common.cuh``'s
``min_nan``/``max_nan``.  The model's sums are also held to the JAX
reference within ``rtol=1e-5, atol=1e-6`` (another order of summation).

``compact_kernel`` models ``compact.cu``: tiles on the 16-byte grid of
the mask's address, 16-byte chunks turned into bit masks by the multiply
trick, the packed two-round block scan, ranks and the fill, for every
alignment of the mask; it is held to ``repro.kernels.ref.compact``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref

F32 = np.float32
CANON_NAN = np.array([0x7FFFFFFF], dtype=np.uint32).view(np.float32)[0]
IDENT = {"sum": F32(0.0), "min": F32(np.inf), "max": F32(-np.inf)}
ROWS_PER_BLOCK = 256
SUM_TOL = dict(rtol=1e-5, atol=1e-6)


def combine(c, x, y):
    """``seg_common.cuh``'s combine<C>(x, y) on float32 scalars."""
    if c == "sum":
        with np.errstate(invalid="ignore", over="ignore"):
            r = F32(x + y)
        return CANON_NAN if np.isnan(r) else r
    if np.isnan(x) or np.isnan(y):
        return CANON_NAN
    if c == "min":
        return y if y < x else x
    return y if y > x else x


def fused_row(vals, c):
    """``gab_fused.cu``'s reduction of one row's values (one column)."""
    acc = [IDENT[c]] * 32
    for e, v in enumerate(vals):
        acc[e % 32] = combine(c, acc[e % 32], v)
    m = 16
    while m:
        acc = [combine(c, acc[l], acc[l ^ m]) for l in range(32)]
        m >>= 1
    return acc[0]


def _window_tree(vals, heads, c):
    """One window of the segment kernel: ``vals`` [32] per lane (identity
    past the last row), ``heads`` the start lane of each packed row and the
    lane past the last row; returns the head lanes' results."""
    last = heads[-1] - 1
    pos = np.empty(32, dtype=np.int64)
    length = np.zeros(32, dtype=np.int64)
    for h, t in zip(heads[:-1], heads[1:]):
        pos[h:t] = np.arange(t - h)
        length[h:t] = t - h
    v = [combine(c, IDENT[c], vals[l]) if l <= last else IDENT[c]
         for l in range(32)]
    longest = int(length.max())
    m = 16
    while m:
        if m < longest:
            down = [v[l + m] if l + m < 32 else v[l] for l in range(32)]
            v = [combine(c, v[l], down[l])
                 if l <= last and pos[l] < m and pos[l] + m < length[l]
                 else v[l] for l in range(32)]
        m >>= 1
    return [v[h] for h in heads[:-1]]


def segment_kernel(contrib, dst, num_rows, c, qc=None):
    """``segment_reduce.cu``'s layout over contrib [E, Q], ascending dst."""
    e_count, q_cols = contrib.shape
    if qc is None:
        qc = 1 if q_cols == 1 else 2 if q_cols == 2 else 4 if q_cols <= 4 else 8
    out = np.full((num_rows, q_cols), np.nan, dtype=np.float32)
    d = dst.astype(np.int64)
    for r0 in range(0, num_rows, ROWS_PER_BLOCK):
        nrows = min(ROWS_PER_BLOCK, num_rows - r0)
        bounds = np.searchsorted(d, r0 + np.arange(nrows + 1))
        for row0 in range(0, nrows, 32):
            owned = range(row0, min(row0 + 32, nrows))
            lo = {r: int(bounds[r]) for r in owned}
            hi = {r: int(bounds[r + 1]) for r in owned}
            for q0 in range(0, q_cols, qc):
                cols = range(q0, min(q0 + qc, q_cols))
                for r in owned:
                    if hi[r] == lo[r]:
                        out[r0 + r, list(cols)] = IDENT[c]
                ew, whi = lo[row0], hi[owned[-1]]
                while ew < whi:
                    rows = [r for r in owned if 1 <= hi[r] - lo[r] <= 32
                            and lo[r] >= ew and hi[r] <= ew + 32]
                    if not rows:
                        ew = next(hi[r] for r in owned
                                  if lo[r] == ew and hi[r] - lo[r] > 32)
                        continue
                    heads = [lo[r] - ew for r in rows] + [hi[rows[-1]] - ew]
                    for q in cols:
                        vals = [contrib[ew + l, q] if ew + l < e_count
                                else F32(0) for l in range(32)]
                        for r, x in zip(rows, _window_tree(vals, heads, c)):
                            out[r0 + r, q] = x
                    ew += heads[-1]
                for r in owned:
                    if hi[r] - lo[r] > 32:
                        for q in cols:
                            out[r0 + r, q] = fused_row(
                                contrib[lo[r]:hi[r], q], c)
    return out


HUB_EDGES = 4096
HUB_CHUNK_BYTES = 16384


def is_hub(lo, hi):
    """The row launch's test: the row holds m, the first multiple of
    HUB_EDGES at or after lo, and m + HUB_EDGES."""
    m = -(-lo // HUB_EDGES) * HUB_EDGES
    return m + HUB_EDGES < hi


def hub_rows(dst, num_rows):
    """The hub launch's discovery: multiple m of HUB_EDGES with
    dst[m] == dst[m + HUB_EDGES] in [0, R) and dst[m - HUB_EDGES] !=
    dst[m].  Returns the rows found, one entry per find."""
    found = []
    for j in range((len(dst) - 1) // HUB_EDGES):
        m = j * HUB_EDGES
        r = dst[m]
        if (0 <= r < num_rows and dst[m + HUB_EDGES] == r
                and (m == 0 or dst[m - HUB_EDGES] != r)):
            found.append(int(r))
    return found


def hub_row(vals, c, q_cols, itemsize=4):
    """The hub launch's consumer: chunks of (HUB_CHUNK_BYTES / itemsize /
    Q) & ~31 edges; lane l combines edge i of a chunk for i = l, l + 32,
    ...; then the 32-lane butterfly."""
    chunk = (HUB_CHUNK_BYTES // itemsize // q_cols) & ~31
    assert chunk >= 32
    acc = [IDENT[c]] * 32
    for c0 in range(0, len(vals), chunk):
        for i in range(c0, min(c0 + chunk, len(vals))):
            lane = (i - c0) % 32
            acc[lane] = combine(c, acc[lane], vals[i])
    m = 16
    while m:
        acc = [combine(c, acc[l], acc[l ^ m]) for l in range(32)]
        m >>= 1
    return acc[0]


def fused_rows(contrib, dst, num_rows, c):
    d = dst.astype(np.int64)
    bounds = np.searchsorted(d, np.arange(num_rows + 1))
    out = np.empty((num_rows, contrib.shape[1]), dtype=np.float32)
    for r in range(num_rows):
        for q in range(contrib.shape[1]):
            out[r, q] = fused_row(contrib[bounds[r]:bounds[r + 1], q], c)
    return out


def _special_values(rng, shape):
    """float32 values with -0.0, +0.0, +-inf, NaN and subnormals mixed in."""
    x = rng.normal(size=shape).astype(np.float32)
    pick = rng.random(shape)
    specials = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-42,
                         np.finfo(np.float32).tiny / 4], dtype=np.float32)
    k = rng.integers(0, len(specials), shape)
    return np.where(pick < 0.25, specials[k], x).astype(np.float32)


def _rows_of_lengths(lengths, out_of_range=True):
    """Ascending dst with row r holding lengths[r] edges, one -1 edge first
    and two edges at R and R + 3 last (dropped by the kernels)."""
    d = np.repeat(np.arange(len(lengths)), lengths)
    if out_of_range:
        d = np.concatenate([[-1], d, [len(lengths), len(lengths) + 3]])
    return d.astype(np.int32)


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("combine_name", ["sum", "min", "max"])
@pytest.mark.parametrize("q_cols", [1, 3, 8])
def test_segment_layout_equals_fused_order(combine_name, q_cols):
    rng = np.random.default_rng(100 + q_cols)
    lengths = np.arange(101)
    lengths = np.concatenate([lengths, rng.permutation(lengths)[:60],
                              np.zeros(7, dtype=np.int64)])
    dst = _rows_of_lengths(lengths)
    contrib = _special_values(rng, (dst.shape[0], q_cols))
    real = (dst >= 0) & (dst < len(lengths))
    got = segment_kernel(contrib, dst, len(lengths), combine_name)
    want = fused_rows(contrib[real], dst[real], len(lengths), combine_name)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("combine_name", ["sum", "min", "max"])
def test_segment_column_equals_single_column_run(combine_name):
    """A column of a Q = 8 run equals its Q = 1 run (chunks of 8 and of 4)."""
    rng = np.random.default_rng(7)
    lengths = rng.integers(0, 70, 300)
    dst = _rows_of_lengths(lengths, out_of_range=False)
    contrib = _special_values(rng, (dst.shape[0], 8))
    full = segment_kernel(contrib, dst, len(lengths), combine_name)
    halves = segment_kernel(contrib, dst, len(lengths), combine_name, qc=4)
    assert np.array_equal(_bits(full), _bits(halves))
    for q in (0, 5, 7):
        one = segment_kernel(contrib[:, q:q + 1], dst, len(lengths),
                             combine_name)
        assert np.array_equal(_bits(full[:, q:q + 1]), _bits(one))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 17, 31, 32])
def test_short_row_tree_needs_only_its_offsets(n):
    """A row of n <= 32 edges on any n consecutive lanes, reduced with
    the offsets below n only, gives the 32-lane butterfly's bits."""
    rng = np.random.default_rng(n)
    for c in ("sum", "min", "max"):
        assert _bits(fused_row([], c))[()] == _bits(IDENT[c])[()]
        for _ in range(20):
            vals = _special_values(rng, (32,))
            for start in sorted({0, 32 - n}):
                # lanes [0, start) hold a filler row, [start, start + n) ours
                heads = ([0] if start else []) + [start, start + n]
                got = _window_tree(list(vals), heads, c)[-1]
                want = fused_row(vals[start:start + n], c)
                assert _bits(got)[()] == _bits(want)[()], (c, n, start)


def test_hub_rows_found_once_and_match_row_launch():
    """Every row the row launch leaves as a hub is found by exactly one
    multiple in the hub launch, and nothing else is — at row lengths
    around the thresholds, hubs first and last, ids out of range."""
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 40, 3000)
    for r, n in ((0, 20000), (3, 4097), (4, 8191), (5, 8192), (9, 12289),
                 (100, 4096), (101, 4095), (2999, 9000)):
        lengths[r] = n
    for pad_lo, pad_hi in ((0, 0), (1, 0), (4097, 0), (0, 9000),
                           (5000, 5000)):
        d = np.concatenate([np.full(pad_lo, -1), np.repeat(
            np.arange(len(lengths)), lengths), np.full(pad_hi, len(lengths))])
        bounds = np.searchsorted(d, np.arange(len(lengths) + 1))
        want = sorted(r for r in range(len(lengths))
                      if is_hub(int(bounds[r]), int(bounds[r + 1])))
        found = hub_rows(d, len(lengths))
        assert sorted(found) == want and len(set(found)) == len(found)
        assert 0 in want and 101 not in want


@pytest.mark.parametrize("q_cols", [1, 3, 8])
def test_hub_chunks_keep_fused_order(q_cols):
    rng = np.random.default_rng(30 + q_cols)
    for c in ("sum", "min", "max"):
        for n in (4097, 6000):
            vals = _special_values(rng, (n,))
            assert _bits(hub_row(vals, c, q_cols))[()] == \
                _bits(fused_row(vals, c))[()]
    vals = _special_values(rng, (5000,))
    assert _bits(hub_row(vals, "sum", 4, itemsize=8))[()] == \
        _bits(fused_row(vals, "sum"))[()]


@pytest.mark.parametrize("q_cols", [1, 3, 8])
def test_segment_model_sums_match_reference(q_cols):
    rng = np.random.default_rng(20 + q_cols)
    lengths = rng.integers(0, 120, 600)
    dst = _rows_of_lengths(lengths, out_of_range=False)
    # positive messages for the sum (as PageRank's): no cancellation, so
    # two orders of summation agree to the tolerance
    pos = rng.random((dst.shape[0], q_cols)).astype(np.float32)
    got = segment_kernel(pos, dst, len(lengths), "sum")
    want = np.asarray(jref.segment_sum(jnp.asarray(pos), jnp.asarray(dst),
                                       len(lengths)))
    np.testing.assert_allclose(got, want, **SUM_TOL)
    contrib = rng.normal(size=(dst.shape[0], q_cols)).astype(np.float32)
    for c in ("min", "max"):
        got = segment_kernel(contrib, dst, len(lengths), c)
        want = getattr(jref, f"segment_{c}")(jnp.asarray(contrib),
                                             jnp.asarray(dst), len(lengths))
        assert np.array_equal(got, np.asarray(want))


# --- compact ---------------------------------------------------------------

THREADS, CHUNK, ROUNDS = 256, 16, 2
TILE = THREADS * CHUNK * ROUNDS


def nibble(w):
    """``compact.cu``'s nibble(): bits of the four nonzero bytes of w."""
    b = np.array([w], dtype=np.uint32).view(np.uint8)
    ne = np.where(b != 0, 1, 0).astype(np.uint8).view(np.uint32)[0]
    return int((np.uint64(ne) * np.uint64(0x00204081)
                & np.uint64(0xFFFFFFFF)) >> np.uint64(21)) & 0xF


def compact_kernel(mask_bytes, values, capacity, fill, a):
    """``compact.cu`` over mask_bytes [n] (uint8) whose first byte sits at
    offset ``a`` of a 16-byte line."""
    n = mask_bytes.shape[0]
    tiles = (n + a + TILE - 1) // TILE if n else 0
    out_idx = np.full(capacity, -12345, dtype=np.int64)
    out_val = np.full(capacity, -12345, dtype=np.int64)
    padded = np.zeros(tiles * TILE, dtype=np.uint8)
    padded[a:a + n] = mask_bytes
    prefix = 0
    for t in range(tiles):
        bits = np.zeros((ROUNDS, THREADS), dtype=np.int64)
        for r in range(ROUNDS):
            for th in range(THREADS):
                u0 = t * TILE + (r * THREADS + th) * CHUNK
                words = padded[u0:u0 + CHUNK].view(np.uint32)
                bits[r, th] = sum(nibble(w) << (4 * k)
                                  for k, w in enumerate(words))
        counts = np.vectorize(lambda x: bin(x).count("1"))(bits)
        packed = counts[0] + (counts[1] << 16)
        excl = np.cumsum(packed) - packed
        total = int(packed.sum())
        total0 = total & 0xFFFF
        rank = [excl & 0xFFFF, total0 + (excl >> 16)]
        for r in range(ROUNDS):
            for th in range(THREADS):
                u0 = t * TILE + (r * THREADS + th) * CHUNK
                k = int(rank[r][th])
                for j in range(CHUNK):
                    if bits[r, th] >> j & 1:
                        pos = prefix + k
                        k += 1
                        if pos >= capacity:
                            break
                        out_idx[pos] = u0 + j - a
                        out_val[pos] = values[u0 + j - a]
        prefix += total0 + (total >> 16)
    start = min(prefix, capacity)
    out_idx[start:] = fill
    out_val[start:] = 0
    return out_idx, out_val


@pytest.mark.parametrize("a", [0, 1, 7, 15])
@pytest.mark.parametrize("n,density,capacity", [
    (0, 0.0, 5), (1, 1.0, 3), (15, 0.5, 20), (TILE + 3, 0.3, 1000),
    (2 * TILE - 17, 0.05, 300), (TILE, 0.9, 100), (5000, 0.2, 0)])
def test_compact_model_matches_reference(a, n, density, capacity):
    rng = np.random.default_rng(n + a)
    mask = rng.random(n) < density
    # any nonzero byte is set, as the kernel reads it
    mask_bytes = np.where(mask, rng.integers(1, 256, n), 0).astype(np.uint8)
    values = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int64)
    fill = n if capacity % 2 else 7
    got_idx, got_val = compact_kernel(mask_bytes, values, capacity, fill, a)
    if n:
        want_idx, want_val = jref.compact(jnp.asarray(mask),
                                          jnp.asarray(values), capacity, fill)
    else:  # the JAX reference cannot gather from an empty array
        want_idx = np.full(capacity, fill)
        want_val = np.zeros(capacity)
    assert np.array_equal(got_idx, np.asarray(want_idx))
    set_count = min(int(mask.sum()), capacity)
    assert np.array_equal(got_val[:set_count],
                          np.asarray(want_val)[:set_count])
    assert (got_val[set_count:] == 0).all()


def test_nibble_gathers_byte_flags():
    for w in (0, 1, 0x01000000, 0x00010000, 0x00000100, 0x01010101,
              0xFF00FF00, 0x80000001, 0x00FFFF00):
        b = np.array([w], dtype=np.uint32).view(np.uint8)
        want = sum(1 << j for j in range(4) if b[j])
        assert nibble(w) == want, hex(w)
