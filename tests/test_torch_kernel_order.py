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
  that finds each exactly once from multiples of H (``hub_rows``; H =
  ``hub_edges(E)``, 256 at a tile's size) and streams it by four blocks
  of eight lanes, in chunks of a multiple of 32 edges (``hub_row``);
  ``layout_both`` is the two launches.

The two must agree bit for bit — the engine's merged mode (segment
kernel) is held bit for bit to its tiled mode (fused kernel) — for every
row length, column count and value, -0.0, infinities, NaN and subnormals
included, for sum, min and max.  Float arithmetic is float32
round-to-nearest with each step rounded (as ``__fadd_rn``), NaN results
canonical (as the card's), min/max as ``seg_common.cuh``'s
``min_nan``/``max_nan``.  The model's sums are also held to the JAX
reference within ``rtol=1e-5, atol=1e-6`` (another order of summation).

``fused_kernel`` is ``gab_fused.cu``: the same row launch over the
message ``src · a + b + add_const`` (each step rounded), rows past
num_rows left unreduced (the padding's sink row never a hub), hub rows
chunked by the message's streams, and the apply and mask as the epilogue
(``epilogue``).  It must give the segment model's bits followed by the
apply — the merged mode's composition — and agree with the JAX package's
``gab_fused`` (Pallas, interpret mode) within the sum tolerance.

``compact_kernel`` models ``compact.cu``: tiles on the 16-byte grid of
the mask's address, 16-byte chunks turned into bit masks by the multiply
trick, the packed two-round block scan, ranks and the fill, for every
alignment of the mask; it is held to ``repro.kernels.ref.compact``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import gab_fused as jfused
from repro.kernels import ref as jref
from repro_torch.kernels.gab_fused import FusedSpec

F32 = np.float32
CANON_NAN = np.array([0x7FFFFFFF], dtype=np.uint32).view(np.float32)[0]
IDENT = {"sum": F32(0.0), "min": F32(np.inf), "max": F32(-np.inf)}
# seg_common.cuh's Identity<int, C>, held in the int64 accumulator
INT32_IDENT = {"sum": 0, "min": 2**31 - 1, "max": -2**31}
ROWS_PER_BLOCK = 256
SUM_TOL = dict(rtol=1e-5, atol=1e-6)


def ident(c, dtype=F32):
    """The identity a row starts from: float32's, or ``Identity<int, C>``
    in the int64 accumulator for integer values."""
    if np.issubdtype(np.dtype(dtype), np.integer):
        return np.int64(INT32_IDENT[c])
    return IDENT[c]


def combine(c, x, y):
    """``seg_common.cuh``'s combine<C>(x, y) on float32 scalars, or on
    integers in the int64 accumulator."""
    if isinstance(x, np.integer):
        x, y = np.int64(x), np.int64(y)
        if c == "sum":
            return x + y
        return (y if y < x else x) if c == "min" else (y if y > x else x)
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
    acc = [ident(c, getattr(vals, "dtype", F32))] * 32
    for e, v in enumerate(vals):
        acc[e % 32] = combine(c, acc[e % 32], v)
    m = 16
    while m:
        acc = [combine(c, acc[l], acc[l ^ m]) for l in range(32)]
        m >>= 1
    return acc[0]


def _window_tree(vals, heads, c, dtype=F32):
    """One window of the segment kernel: ``vals`` [32] per lane (identity
    past the last row), ``heads`` the start lane of each packed row and the
    lane past the last row; returns the head lanes' results.  ``dtype`` is
    the values' (float32 or an integer type)."""
    last = heads[-1] - 1
    pos = np.empty(32, dtype=np.int64)
    length = np.zeros(32, dtype=np.int64)
    for h, t in zip(heads[:-1], heads[1:]):
        pos[h:t] = np.arange(t - h)
        length[h:t] = t - h
    e = ident(c, dtype)
    v = [combine(c, e, vals[l]) if l <= last else e for l in range(32)]
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


def _qc(q_cols):
    """The kernels' column chunk: 1, 2, 4 or 8 columns a pass."""
    return 1 if q_cols == 1 else 2 if q_cols == 2 else 4 if q_cols <= 4 else 8


def layout_rows(vals, dst, num_rows, c, qc, put, h,
                rows_per_block=ROWS_PER_BLOCK):
    """``seg_layout.cuh``'s row launch over vals [E, Q] (each edge's values
    as loaded) and ascending dst: blocks of rows_per_block rows (block_r:
    128, 256 or 512) below num_rows, whose slices end at the first edge of
    row min(r0 + rows_per_block, num_rows); warps of
    32 rows; rows of 1..32 edges packed into windows of 32 edges with a
    tree over positions inside each row; longer rows on the whole warp,
    except those ``is_hub`` (hub size h) leaves to the hub launch; query
    columns in chunks of qc.  Calls put(r, q, value) for each row and
    column it reduces."""
    e_count, q_cols = vals.shape
    d = dst.astype(np.int64)
    for r0 in range(0, num_rows, rows_per_block):
        nrows = min(rows_per_block, num_rows - r0)
        bounds = np.searchsorted(d, r0 + np.arange(nrows + 1))
        for row0 in range(0, nrows, 32):
            owned = range(row0, min(row0 + 32, nrows))
            lo = {r: int(bounds[r]) for r in owned}
            hi = {r: int(bounds[r + 1]) for r in owned}
            for q0 in range(0, q_cols, qc):
                cols = range(q0, min(q0 + qc, q_cols))
                for r in owned:
                    if hi[r] == lo[r]:
                        for q in cols:
                            put(r0 + r, q, ident(c, vals.dtype))
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
                        v = [vals[ew + l, q] if ew + l < e_count
                             else vals.dtype.type(0) for l in range(32)]
                        for r, x in zip(rows, _window_tree(v, heads, c,
                                                           vals.dtype)):
                            put(r0 + r, q, x)
                    ew += heads[-1]
                for r in owned:
                    if hi[r] - lo[r] > 32 and not is_hub(lo[r], hi[r], h):
                        for q in cols:
                            put(r0 + r, q, fused_row(vals[lo[r]:hi[r], q], c))


HUB_MIN_EDGES = 256
HUB_MAX_MULTIPLES = 16384
HUB_GROUPS = 4
HUB_CHUNK_BYTES = 16384


def hub_edges(num_edges, min_edges=HUB_MIN_EDGES):
    """``seg_layout.cuh``'s hub_shift() as a size: H, the least power of
    two of at least min_edges (block_e, HUB_MIN_EDGES by default) for which
    an edge list of num_edges holds at most HUB_MAX_MULTIPLES multiples of
    H."""
    h = min_edges
    while (num_edges - 1) // h > HUB_MAX_MULTIPLES:
        h *= 2
    return h


def is_hub(lo, hi, h):
    """The row launch's test: the row holds m, the first multiple of h at
    or after lo, and m + h."""
    m = -(-lo // h) * h
    return m + h < hi


def hub_rows(dst, num_rows, h):
    """The hub launch's discovery: multiple m of h with dst[m] == dst[m +
    h] in [0, num_rows) and dst[m - h] != dst[m].  Returns the rows found,
    one entry per find."""
    found = []
    for j in range((len(dst) - 1) // h):
        m = j * h
        r = dst[m]
        if (0 <= r < num_rows and dst[m + h] == r
                and (m == 0 or dst[m - h] != r)):
            found.append(int(r))
    return found


def hub_row(vals, c, streams, itemsize=4, groups=HUB_GROUPS):
    """The hub launch on one column: chunks spanning (HUB_CHUNK_BYTES /
    itemsize / streams · groups) & ~31 edges (streams: elements an edge);
    block g of the hub's ``groups`` stages and combines lanes [g·L, (g +
    1)·L) (L = 32 / groups) — lane l edge i of a chunk for i % 32 == l, in
    order — and writes their values to scratch; the last block runs the
    butterfly over the 32."""
    chunk = (HUB_CHUNK_BYTES // itemsize // streams * groups) & ~31
    assert chunk >= 32
    width = 32 // groups
    scratch = [None] * 32
    for g in range(groups):
        acc = {l: ident(c, vals.dtype)
               for l in range(g * width, (g + 1) * width)}
        for c0 in range(0, len(vals), chunk):
            for u in range(0, min(chunk, len(vals) - c0), 32):
                for l in acc:
                    if c0 + u + l < len(vals):
                        acc[l] = combine(c, acc[l], vals[c0 + u + l])
        for l, x in acc.items():
            scratch[l] = x
    m = 16
    while m:
        scratch = [combine(c, scratch[l], scratch[l ^ m]) for l in range(32)]
        m >>= 1
    return scratch[0]


def layout_both(vals, dst, num_rows, c, qc, put, streams, itemsize=4,
                blocks=(HUB_MIN_EDGES, ROWS_PER_BLOCK)):
    """Both launches of ``seg_layout.cuh`` over vals [E, Q] with hubs of
    ``hub_edges(E)``: the row launch (``layout_rows``, hub rows left out)
    and the hub launch over the rows ``hub_rows`` finds, chunked by the
    source's elements an edge (``streams``) and their size.  Every row
    below num_rows is put exactly once, no row past it at all."""
    q_cols = vals.shape[1]
    h = hub_edges(len(dst), blocks[0])
    puts = np.zeros((max(num_rows, 0), q_cols), dtype=np.int64)

    def counted(r, q, x):
        puts[r, q] += 1
        put(r, q, x)
    layout_rows(vals, dst, num_rows, c, qc, counted, h, blocks[1])
    d = dst.astype(np.int64)
    for r in hub_rows(dst, num_rows, h):
        lo, hi = np.searchsorted(d, r), np.searchsorted(d, r, side="right")
        for q in range(q_cols):
            counted(r, q, hub_row(vals[lo:hi, q], c, streams, itemsize))
    assert (puts == 1).all()


def segment_kernel(contrib, dst, num_rows, c, qc=None,
                   blocks=(HUB_MIN_EDGES, ROWS_PER_BLOCK)):
    """``segment_reduce.cu``'s layout over contrib [E, Q], ascending dst;
    float32 contributions give float32 rows, integer ones int64 rows (the
    accumulator, before the kernel's cast back)."""
    if np.issubdtype(contrib.dtype, np.integer):
        out = np.zeros((num_rows, contrib.shape[1]), dtype=np.int64)
    else:
        out = np.full((num_rows, contrib.shape[1]), np.nan, dtype=np.float32)

    def put(r, q, x):
        out[r, q] = x
    layout_both(contrib, dst, num_rows, c, qc or _qc(contrib.shape[1]), put,
                streams=contrib.shape[1], itemsize=contrib.itemsize,
                blocks=blocks)
    return out


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
    """Row lengths 0-100, then rows for the hub launch (every row of 513
    edges or more, and a row of 258..512 that holds two multiples of 256)
    beside rows under that size."""
    rng = np.random.default_rng(100 + q_cols)
    lengths = np.arange(101)
    lengths = np.concatenate([lengths, rng.permutation(lengths)[:60],
                              np.zeros(7, dtype=np.int64),
                              [513, 511, 1100, 33, 2600, 0, 4500]])
    dst = _rows_of_lengths(lengths)
    assert {168, 170, 172, 174} <= set(hub_rows(dst, len(lengths), 256))
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
    _check_hub_discovery(4096)


def _check_hub_discovery(h):
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 40, 3000)
    for r, n in ((0, 20000), (3, h + 1), (4, 2 * h - 1), (5, 2 * h),
                 (9, 3 * h + 1), (100, h), (101, h - 1), (2999, 9000)):
        lengths[r] = n
    for pad_lo, pad_hi in ((0, 0), (1, 0), (h + 1, 0), (0, 9000),
                           (5000, 5000)):
        d = np.concatenate([np.full(pad_lo, -1), np.repeat(
            np.arange(len(lengths)), lengths), np.full(pad_hi, len(lengths))])
        bounds = np.searchsorted(d, np.arange(len(lengths) + 1))
        want = sorted(r for r in range(len(lengths))
                      if is_hub(int(bounds[r]), int(bounds[r + 1]), h))
        found = hub_rows(d, len(lengths), h)
        assert sorted(found) == want and len(set(found)) == len(found)
        assert 0 in want and 101 not in want


@pytest.mark.parametrize("h", [256, 1024, 8192])
def test_hub_rows_found_once_at_each_hub_size(h):
    """The same at the other hub sizes a call can choose."""
    _check_hub_discovery(h)


def test_hub_size_grows_with_the_edge_list():
    """H is 256 up to HUB_MAX_MULTIPLES multiples of 256 (a tile of 2^20
    edges), then the least power of two that keeps the multiples at most
    HUB_MAX_MULTIPLES (a server's merged list of 2^26 edges: 4,096)."""
    assert hub_edges(1) == hub_edges(1_058_944) == 256
    assert hub_edges(256 * 16385) == 256
    assert hub_edges(256 * 16385 + 1) == 512
    assert hub_edges(1 << 26) == 4096
    for e in (1000, 3_000_001, 1 << 26, (1 << 26) + 1):
        h = hub_edges(e)
        assert (e - 1) // h <= HUB_MAX_MULTIPLES
        assert h == HUB_MIN_EDGES or (e - 1) // (h // 2) > HUB_MAX_MULTIPLES


@pytest.mark.parametrize("q_cols", [1, 2, 3, 4, 8, 9])
def test_hub_chunks_keep_fused_order(q_cols):
    """A hub streamed by 4 blocks of 8 lanes each, merged through scratch,
    gives the one-warp order's bits (chunks of 1,792 to 16,384 edges;
    q_cols counts every stream of an edge, as the fused source's a and
    b)."""
    rng = np.random.default_rng(30 + q_cols)
    for c in ("sum", "min", "max"):
        for n in (2049, 4097, 9000):
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


def skewed_int32_list(rows, seed=0):
    """ROADMAP C.1's list, with ``rows`` Zipf rows (2^17 on the card):
    Zipf(1.8) row lengths capped at 4,000, rows of 50,000, 9,000, 4,097,
    3,000, 1,025, 600 and 513 edges at rows k·rows/8 (k = 1..7), 20,000
    padding edges at dst = rows, int32 contributions in [-1000, 1000);
    reduced into rows + 1 rows.  ``chip_smoke.py`` builds the same."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(1.8, rows), 4000)
    for k, n in enumerate((50000, 9000, 4097, 3000, 1025, 600, 513)):
        lengths[(k + 1) * (rows // 8)] = n
    dst = np.concatenate([np.repeat(np.arange(rows), lengths),
                          np.full(20000, rows)]).astype(np.int32)
    contrib = rng.integers(-1000, 1000, dst.shape[0]).astype(np.int32)
    return dst, contrib, rows + 1


@pytest.mark.parametrize("combine_name", ["min", "max"])
def test_int32_min_max_on_a_skewed_list(combine_name):
    """The segment model on ROADMAP C.1's list shape (2^12 Zipf rows, the
    same long rows and padding) with negative int32 contributions: every
    row put exactly once (layout_both), no edge index past the slice, and
    the rows equal the port's plain version — the layout reads no address
    from a value."""
    import torch
    from repro_torch.kernels import ref as tref

    dst, contrib, num_rows = skewed_int32_list(1 << 12)
    h = hub_edges(len(dst))
    found = hub_rows(dst, num_rows, h)
    assert num_rows - 1 in found and len(found) == len(set(found)) > 7
    got = segment_kernel(contrib[:, None], dst, num_rows, combine_name)
    want = tref.segment_reduce(torch.from_numpy(contrib),
                               torch.from_numpy(dst), num_rows, combine_name)
    assert got.min() >= -1000 and got.max() < 1000
    assert np.array_equal(got[:, 0].astype(np.int32), want.numpy())


# --- gab_fused ---------------------------------------------------------------


def message(spec, src, a, b):
    """``gab_fused.cu``'s message per edge and column, float32, each step
    rounded: src · a + b + add_const."""
    m = src.astype(F32)
    with np.errstate(invalid="ignore", over="ignore"):
        if spec.scale_aux:
            m = (m * a[:, None]).astype(F32)
        if spec.add_edge:
            m = (m + b[:, None]).astype(F32)
        if spec.add_const is not None:
            m = (m + F32(spec.add_const)).astype(F32)
    return m


def epilogue(spec, acc, o, base):
    """``ApplyEpilogue::put`` on float32 scalars: the apply (affine with two
    roundings, or ``min_nan``/``max_nan`` against old) and the mask."""
    with np.errstate(invalid="ignore", over="ignore"):
        if spec.apply == "affine":
            alpha = F32(spec.alpha)
            lhs = alpha if base is None else F32(alpha * base)
            nv = F32(lhs + F32(F32(spec.beta) * acc))
            nv = CANON_NAN if np.isnan(nv) else nv
        else:
            nv = combine(spec.apply, o, acc)
        if spec.update_tol > 0.0:
            changed = abs(F32(nv - o)) > F32(spec.update_tol)
        else:
            changed = nv != o
    return nv, bool(changed)


def fused_kernel(spec, src, a, b, dst, old, base, num_rows,
                 blocks=(HUB_MIN_EDGES, ROWS_PER_BLOCK)):
    """``gab_fused.cu`` over src [E, Q], a/b [E] or None, ascending dst,
    old/base [row_cap, Q]: the message formed as each edge is loaded, both
    launches over rows below num_rows (``layout_both``, hubs chunked by
    the message's streams: Q + one for each of a, b), the epilogue on
    every reduced row, and old copied into the rows past num_rows."""
    q_cols = src.shape[1]
    new = old.copy()
    upd = np.zeros(old.shape, dtype=bool)

    def put(r, q, acc):
        new[r, q], upd[r, q] = epilogue(
            spec, acc, old[r, q], None if base is None else base[r, q])
    layout_both(message(spec, src, a, b), dst, num_rows, spec.combine,
                _qc(q_cols), put,
                streams=q_cols + (a is not None) + (b is not None),
                blocks=blocks)
    return new, upd


def segment_then_apply(spec, src, a, b, dst, old, base, num_rows):
    """The merged mode's composition: the message, the segment model over
    rows [0, num_rows), then the apply and the mask; rows past num_rows
    keep old and are not updated."""
    acc = segment_kernel(message(spec, src, a, b), dst, num_rows,
                         spec.combine)
    new = old.copy()
    upd = np.zeros(old.shape, dtype=bool)
    for r in range(num_rows):
        for q in range(old.shape[1]):
            new[r, q], upd[r, q] = epilogue(
                spec, acc[r, q], old[r, q], None if base is None
                else base[r, q])
    return new, upd


FUSED_LAYOUT_SPECS = {
    # every stream, a dst-side base and a tolerance (the PPR form, with b
    # and a constant besides)
    "sum": FusedSpec(combine="sum", scale_aux="w", add_edge=True,
                     add_const=0.25, apply="affine", alpha=0.15, beta=0.85,
                     base_aux="m", update_tol=1e-3),
    "min": FusedSpec(combine="min", add_edge=True, add_const=1.0,
                     apply="min"),
    "max": FusedSpec(combine="max", scale_aux="w", apply="max"),
}


def _fused_inputs(rng, spec, lengths, q_cols, pad_edges, extra_rows,
                  special=True):
    """Rows of the given lengths, then pad_edges padding edges at dst ==
    num_rows, old/base over row_cap = num_rows + extra_rows rows."""
    num_rows = len(lengths)
    row_cap = num_rows + extra_rows
    dst = np.concatenate([np.repeat(np.arange(num_rows), lengths),
                          np.full(pad_edges, num_rows)]).astype(np.int32)
    e = dst.shape[0]
    values = _special_values if special else (
        lambda g, shape: g.normal(size=shape).astype(np.float32))
    src = values(rng, (e, q_cols))
    a = values(rng, (e,)) if spec.scale_aux else None
    b = values(rng, (e,)) if spec.add_edge else None
    old = values(rng, (row_cap, q_cols))
    base = values(rng, (row_cap, q_cols)) if spec.base_aux else None
    return src, a, b, dst, old, base, num_rows


@pytest.mark.parametrize("combine_name", ["sum", "min", "max"])
@pytest.mark.parametrize("q_cols", [1, 3, 8])
def test_fused_layout_equals_segment_then_apply(combine_name, q_cols):
    """The fused layout gives the segment layout's bits followed by the
    apply, for row lengths 0-100 and a hub row, with -0.0, +-inf, NaN and
    subnormals in every stream; rows past num_rows keep old."""
    spec = FUSED_LAYOUT_SPECS[combine_name]
    rng = np.random.default_rng(200 + q_cols)
    lengths = np.arange(101)
    lengths = np.concatenate([lengths, rng.permutation(lengths)[:60],
                              [8492, 40, 1025, 2049, 3000],
                              np.zeros(7, dtype=np.int64), [40, 3]])
    args = _fused_inputs(rng, spec, lengths, q_cols, pad_edges=50,
                         extra_rows=300)
    assert hub_rows(args[3], args[-1], 256) == [161, 163, 164,
                                                          165]
    got_new, got_upd = fused_kernel(spec, *args)
    want_new, want_upd = segment_then_apply(spec, *args)
    assert np.array_equal(_bits(got_new), _bits(want_new))
    assert np.array_equal(got_upd, want_upd)
    num_rows, old = args[-1], args[4]
    assert np.array_equal(_bits(got_new[num_rows:]), _bits(old[num_rows:]))
    assert not got_upd[num_rows:].any()


BLOCK_E = (128, 256, 512, 1024, 2048)    # kernels/blocks.py's legal sets
BLOCK_R = (128, 256, 512)


@pytest.fixture(scope="module")
def default_block_runs():
    """Inputs and the default (256, 256) blocks' outputs of both models:
    more rows than a 512-row block, rows long enough to be hubs at
    H = 2048."""
    rng = np.random.default_rng(300)
    lengths = np.concatenate([np.arange(101), rng.permutation(101)[:90],
                              [513, 1100, 4200, 33, 0],
                              rng.integers(0, 40, 900)])
    assert len(lengths) > 2 * 512
    dst = _rows_of_lengths(lengths)
    assert hub_rows(dst, len(lengths), hub_edges(len(dst), 2048))
    seg = []
    for c, q in (("sum", 2), ("min", 1)):
        contrib = _special_values(rng, (dst.shape[0], q))
        seg.append((c, contrib, segment_kernel(contrib, dst, len(lengths),
                                                c)))
    spec = FUSED_LAYOUT_SPECS["sum"]
    args = _fused_inputs(rng, spec, lengths, 1, pad_edges=50, extra_rows=300)
    return lengths, dst, seg, spec, args, fused_kernel(spec, *args)


@pytest.mark.parametrize("block_r", BLOCK_R)
@pytest.mark.parametrize("block_e", BLOCK_E)
def test_every_block_pair_gives_the_default_bits(block_e, block_r,
                                                 default_block_runs):
    """The row order does not depend on which block owns a row or which
    launch reduces it: at every legal (block_e, block_r) both models give
    the default (256, 256)'s bits — the segment model (sum Q = 2, min
    Q = 1) and the fused model (the sum spec, Q = 1) — with every row
    below num_rows put exactly once (layout_both)."""
    lengths, dst, seg, spec, args, (want_new, want_upd) = default_block_runs
    for c, contrib, want in seg:
        got = segment_kernel(contrib, dst, len(lengths), c,
                             blocks=(block_e, block_r))
        assert np.array_equal(_bits(got), _bits(want)), c
    got_new, got_upd = fused_kernel(spec, *args, blocks=(block_e, block_r))
    assert np.array_equal(_bits(got_new), _bits(want_new))
    assert np.array_equal(got_upd, want_upd)


@pytest.mark.parametrize("combine_name", ["sum", "min", "max"])
def test_fused_column_equals_single_column_run(combine_name):
    """A column of a Q = 8 fused run equals its Q = 1 run, a hub row
    included (its chunks hold fewer edges at Q = 8)."""
    spec = FUSED_LAYOUT_SPECS[combine_name]
    rng = np.random.default_rng(9)
    lengths = np.concatenate([rng.integers(0, 70, 200), [8193]])
    src, a, b, dst, old, base, nr = _fused_inputs(
        rng, spec, lengths, 8, pad_edges=20, extra_rows=10)
    full_new, full_upd = fused_kernel(spec, src, a, b, dst, old, base, nr)
    for q in (0, 5, 7):
        col = slice(q, q + 1)
        one_new, one_upd = fused_kernel(
            spec, src[:, col], a, b, dst, old[:, col],
            None if base is None else base[:, col], nr)
        assert np.array_equal(_bits(full_new[:, col]), _bits(one_new))
        assert np.array_equal(full_upd[:, col], one_upd)


def test_padding_hub_is_skipped():
    """A tile whose padding edges (dst == num_rows < row_cap) would form a
    hub: the hub search bounded by num_rows does not find it, the last
    row block's slice ends at the first padding edge, a real hub below
    num_rows is still found, and the sink row keeps old."""
    spec = FUSED_LAYOUT_SPECS["sum"]
    rng = np.random.default_rng(11)
    lengths = rng.integers(0, 6, 500)
    lengths[250] = 8292
    pad = 9092
    src, a, b, dst, old, base, nr = _fused_inputs(
        rng, spec, lengths, 1, pad_edges=pad, extra_rows=300, special=False)
    assert nr == 500 and old.shape[0] == 800        # one block wholly past
    unbounded = hub_rows(dst, old.shape[0], 256)
    assert unbounded == [250, nr]                   # unbounded: a hub
    assert hub_rows(dst, nr, 256) == [250]
    d = dst.astype(np.int64)
    first_pad = int(np.searchsorted(d, nr))
    assert first_pad == dst.shape[0] - pad
    r0 = (nr - 1) // ROWS_PER_BLOCK * ROWS_PER_BLOCK
    assert np.searchsorted(d, r0 + min(ROWS_PER_BLOCK, nr - r0)) == first_pad
    got_new, got_upd = fused_kernel(spec, src, a, b, dst, old, base, nr)
    want_new, want_upd = segment_then_apply(spec, src, a, b, dst, old, base,
                                            nr)
    assert np.array_equal(_bits(got_new), _bits(want_new))
    assert np.array_equal(got_upd, want_upd)
    assert np.array_equal(_bits(got_new[nr:]), _bits(old[nr:]))
    assert not got_upd[nr:].any()


JAX_FUSED_SPECS = {
    "pagerank": FusedSpec(combine="sum", scale_aux="w", apply="affine",
                          alpha=0.15, beta=0.85, update_tol=1e-3),
    "ppr": FusedSpec(combine="sum", scale_aux="w", apply="affine",
                     alpha=0.15, beta=0.85, base_aux="m", update_tol=1e-9),
    "sssp": FusedSpec(combine="min", add_edge=True, apply="min"),
    "wcc": FusedSpec(combine="min", apply="min"),
    "bfs": FusedSpec(combine="min", add_const=1.0, apply="min"),
    "max": FusedSpec(combine="max", add_edge=True, apply="max"),
}


@pytest.mark.parametrize("name", sorted(JAX_FUSED_SPECS))
@pytest.mark.parametrize("q_cols", [1, 8])
def test_fused_model_matches_jax_gab_fused(name, q_cols):
    """The fused model against ``repro.kernels.gab_fused.gab_fused``
    (Pallas, interpret mode): sums within rtol=1e-5, atol=1e-6, min/max
    equal; the mask equal wherever the change lies farther than that
    tolerance from update_tol; rows past num_rows keep old."""
    spec = JAX_FUSED_SPECS[name]
    rng = np.random.default_rng(sorted(JAX_FUSED_SPECS).index(name) + q_cols)
    e, row_cap, num_rows = 1500, 300, 270
    n_real = e - e // 8
    dst = np.concatenate([np.sort(rng.integers(0, num_rows, n_real)),
                          np.full(e - n_real, num_rows)]).astype(np.int32)
    ev = np.concatenate([rng.uniform(0.5, 2.0, n_real),
                         np.zeros(e - n_real)]).astype(np.float32)
    src = rng.uniform(0.0, 5.0, (e, q_cols)).astype(np.float32)
    if spec.combine == "min":
        src[rng.random(src.shape) < 0.3] = np.inf     # unreached sources
    old = rng.uniform(0.0, 5.0, (row_cap, q_cols)).astype(np.float32)
    a = rng.uniform(0.1, 1.0, e).astype(np.float32) * ev \
        if spec.scale_aux else None
    b = ev if spec.add_edge else None
    base = (rng.uniform(0.0, 1.0, (row_cap, q_cols)).astype(np.float32)
            if spec.base_aux else None)
    new, upd = fused_kernel(spec, src, a, b, dst, old, base, num_rows)

    def j(x):
        return None if x is None else jnp.asarray(x)
    jspec = jfused.FusedSpec(**dataclasses.asdict(spec))
    jnew, jupd = jfused.gab_fused(jspec, j(src), j(a), j(b), j(dst), j(old),
                                  j(base), jnp.int32(num_rows), row_cap,
                                  interpret=True)
    jnew, jupd = np.asarray(jnew), np.asarray(jupd)
    if spec.combine == "sum":
        np.testing.assert_allclose(new, jnew, **SUM_TOL)
        margin = SUM_TOL["atol"] + SUM_TOL["rtol"] * np.abs(jnew)
        clear = np.abs(np.abs(jnew - old) - spec.update_tol) > margin
    else:
        assert np.array_equal(new, jnew)
        clear = np.ones(upd.shape, dtype=bool)
    assert clear[:num_rows].mean() > 0.9
    assert np.array_equal(upd[clear], jupd[clear])
    assert np.array_equal(new[num_rows:], old[num_rows:])
    assert not upd[num_rows:].any()


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
