"""The port's kernel modules on the CPU against the JAX package.

On a CPU tensor ``repro_torch.kernels.ops`` runs the kernels' plain
PyTorch versions (``ref``); the CUDA kernels themselves run only on the
card (chip_smoke.py holds them against these same plain versions).  Here
the plain versions are held against ``repro.kernels.ref`` and the Pallas
kernels in interpret mode, on the same inputs made with numpy.

Tolerances: min and max are exact (``array_equal``); sums are held to
``rtol=1e-5, atol=1e-6`` because the port sums a row in another order
than XLA's scatter or the MXU contraction (a segmented scan), so the
last bits of a float sum may differ.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apps as japps
from repro.kernels import gab_fused as jfused
from repro.kernels import gab_gather as jgather
from repro.kernels import ref as jref
from repro_torch.core import apps as tapps
from repro_torch.kernels import compact as tcompact
from repro_torch.kernels import gab_fused as tfused
from repro_torch.kernels import gab_gather as tgather
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SUM_TOL = dict(rtol=1e-5, atol=1e-6)


def _assert_match(got, want, combine):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if combine == "sum":
        np.testing.assert_allclose(got, want, **SUM_TOL)
    else:
        assert np.array_equal(got, want)


def _inputs(E, R, Q, seed, sorted_ids):
    rng = np.random.default_rng(seed)
    shape = (E,) if Q is None else (E, Q)
    c = rng.normal(size=shape).astype(np.float32)
    d = rng.integers(0, R, E).astype(np.int32)
    if sorted_ids:
        d = np.sort(d)
    return c, d


@pytest.mark.parametrize("E,R", [(64, 16), (1000, 300), (4096, 512),
                                 (777, 1), (128, 1024)])
@pytest.mark.parametrize("combine", ["sum", "min", "max"])
@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_reduce_matches_reference(E, R, combine, sorted_ids):
    c, d = _inputs(E, R, None, E + R, sorted_ids)
    got = getattr(tops, f"segment_{combine}")(
        torch.from_numpy(c), torch.from_numpy(d), R, sorted_ids=sorted_ids)
    assert got.dtype == torch.float32
    want = getattr(jref, f"segment_{combine}")(jnp.asarray(c),
                                               jnp.asarray(d), R)
    _assert_match(got, want, combine)
    pallas = jgather.segment_reduce_pallas(jnp.asarray(c), jnp.asarray(d), R,
                                           combine=combine, interpret=True)
    _assert_match(got, pallas, combine)


@pytest.mark.parametrize("E,R,Q", [(777, 130, 3), (1000, 300, 5), (64, 16, 2),
                                   (513, 257, 4), (3, 1, 7)])
@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_segment_reduce_multi_query(E, R, Q, combine):
    c, d = _inputs(E, R, Q, E * 7 + R + Q, True)
    got = tops.segment_reduce(torch.from_numpy(c), torch.from_numpy(d), R,
                              combine)
    assert tuple(got.shape) == (R, Q)
    want = getattr(jref, f"segment_{combine}")(jnp.asarray(c),
                                               jnp.asarray(d), R)
    _assert_match(got, want, combine)
    pallas = jgather.segment_reduce_pallas(jnp.asarray(c), jnp.asarray(d), R,
                                           combine=combine, interpret=True)
    _assert_match(got, pallas, combine)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_segment_reduce_integers_exact(dtype, combine):
    """Integers above 2^24 (where a float32 round trip loses bits) reduce
    exactly; empty rows hold the type's identity."""
    rng = np.random.default_rng(5)
    E, R = 600, 40
    c = (rng.integers(0, 1 << 10, E) + (1 << 25) + 1).astype(dtype)
    d = np.sort(rng.integers(0, R - 3, E)).astype(np.int32)  # last rows empty
    got = tops.segment_reduce(torch.from_numpy(c), torch.from_numpy(d), R,
                              combine).numpy()
    assert got.dtype == dtype
    info = np.iinfo(dtype)
    ident = {"sum": 0, "min": info.max, "max": info.min}[combine]
    want = np.full(R, ident, dtype=dtype)
    for r in range(R):
        row = c[d == r].astype(np.int64)
        if len(row):
            want[r] = {"sum": row.sum(), "min": row.min(),
                       "max": row.max()}[combine]
    assert np.array_equal(got, want)


def test_segment_reduce_drops_out_of_range_ids():
    """Ids outside [0, R) reduce nowhere, as in jax.ops.segment_sum."""
    c = np.arange(6, dtype=np.float32)
    d = np.array([-1, 0, 0, 2, 5, 9], dtype=np.int32)
    got = tops.segment_sum(torch.from_numpy(c), torch.from_numpy(d), 3)
    want = jref.segment_sum(jnp.asarray(c), jnp.asarray(d), 3)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _tile(E, row_cap, num_rows, seed):
    """A tile-shaped input: dst_local ascending over [0, num_rows), then
    padding edges pointing at the sink row num_rows."""
    rng = np.random.default_rng(seed)
    n_real = E - E // 8
    dst = np.concatenate([np.sort(rng.integers(0, num_rows, n_real)),
                          np.full(E - n_real, num_rows)]).astype(np.int32)
    ev = np.concatenate([rng.uniform(0.5, 2.0, n_real),
                         np.zeros(E - n_real)]).astype(np.float32)
    return rng, dst, ev


FUSED_SPECS = {
    "pagerank": (japps.PageRank().fused_spec(), tapps.PageRank().fused_spec()),
    "sssp": (japps.SSSP().fused_spec(), tapps.SSSP().fused_spec()),
    "wcc": (japps.WCC().fused_spec(), tapps.WCC().fused_spec()),
    "bfs": (japps.BFS().fused_spec(), tapps.BFS().fused_spec()),
    # an affine apply with a dst-side base (the PPR form): covers base_aux
    "affine_base": (jfused.FusedSpec(
        combine="sum", scale_aux="w", apply="affine", alpha=0.15, beta=0.85,
        base_aux="m", update_tol=1e-9), tfused.FusedSpec(
        combine="sum", scale_aux="w", apply="affine", alpha=0.15, beta=0.85,
        base_aux="m", update_tol=1e-9)),
    "max": (jfused.FusedSpec(combine="max", add_edge=True, apply="max"),
            tfused.FusedSpec(combine="max", add_edge=True, apply="max")),
}


@pytest.mark.parametrize("name", sorted(FUSED_SPECS))
@pytest.mark.parametrize("Q,weighted", [(1, False), (3, True)])
def test_gab_fused_ref_matches_pallas(name, Q, weighted):
    jspec, tspec = FUSED_SPECS[name]
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    E, row_cap, num_rows = 1500, 300, 270
    seed = sorted(FUSED_SPECS).index(name) * 10 + Q
    rng, dst, ev = _tile(E, row_cap, num_rows, seed)
    if not weighted:
        ev = (ev > 0).astype(np.float32)
    tail = () if Q == 1 else (Q,)
    src = rng.uniform(0.0, 5.0, (E,) + tail).astype(np.float32)
    if tspec.combine == "min":
        src[rng.random((E,) + tail) < 0.3] = np.inf   # unreached sources
    old = rng.uniform(0.0, 5.0, (row_cap,) + tail).astype(np.float32)
    inv = rng.uniform(0.1, 1.0, E).astype(np.float32)
    a = inv * ev if tspec.scale_aux else None
    b = ev if tspec.add_edge else None
    base = (rng.uniform(0.0, 1.0, (row_cap,) + tail).astype(np.float32)
            if tspec.base_aux else None)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    def j(x):
        return None if x is None else jnp.asarray(x)

    new, upd = tops.gab_fused(tspec, t(src), t(a), t(b), t(dst), t(old),
                              t(base), num_rows, row_cap)
    jnew, jupd = jfused.gab_fused(jspec, j(src), j(a), j(b), j(dst), j(old),
                                  j(base), jnp.int32(num_rows), row_cap,
                                  interpret=True)
    assert new.dtype == torch.float32 and upd.dtype == torch.bool
    _assert_match(new, jnew, tspec.combine)
    assert np.array_equal(upd.numpy(), np.asarray(jupd))
    # rows at or past num_rows keep old and are never updated
    assert np.array_equal(new.numpy()[num_rows:], old[num_rows:])
    assert not upd.numpy()[num_rows:].any()


def test_ops_rejects_other_devices():
    c = torch.zeros(4, device="meta")
    d = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tops.segment_sum(c, d, 2)


def test_cuda_wrappers_take_only_cuda_tensors():
    """The kernel wrappers never compute on the CPU themselves: a CPU
    tensor reaching them raises instead of running a plain version."""
    c = torch.zeros(4)
    d = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tgather.segment_reduce(c, d, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.gab_fused(tapps.WCC().fused_spec(), c, None, None, d,
                         torch.zeros(2), None, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tcompact.compact(torch.zeros(4, dtype=torch.bool), c, 2)


def _compact_inputs(n, density, dtype, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < density
    if dtype == np.float32:
        values = rng.normal(size=n).astype(np.float32)
    else:   # int32 beyond 2^24, where an f32 round trip loses bits
        values = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    return mask, values


def _assert_compact_matches(mask, values, capacity, fill_index):
    got_i, got_v = tops.compact(torch.from_numpy(mask),
                                torch.from_numpy(values), capacity,
                                fill_index=fill_index)
    want_i, want_v = jref.compact(jnp.asarray(mask), jnp.asarray(values),
                                  capacity, fill_index)
    assert got_i.dtype == torch.int32
    assert got_v.numpy().dtype == values.dtype
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy().view(np.uint32),
                          np.asarray(want_v).view(np.uint32))


@pytest.mark.parametrize("n", [1, 7, 512, 4099])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_compact_matches_reference(n, density, dtype):
    """The plain compact equals ``repro.kernels.ref.compact`` index for
    index and bit for bit, with the capacity below and above the popcount
    (the first K entries when it is below) and the default or a custom
    fill index at or past V (see the next test for one below V)."""
    mask, values = _compact_inputs(n, density, dtype, n + int(density * 100))
    pop = int(mask.sum())
    for capacity in sorted({max(pop - 3, 0), pop // 2, pop + 5}):
        for fill_index in (None, n + 7):
            _assert_compact_matches(mask, values, capacity, fill_index)


def test_compact_past_the_tpu_kernels_bound():
    """V = 2^24 + 1: the TPU kernel routes indices through f32 and needs
    V < 2^24; the port's indices are int32 throughout."""
    n = (1 << 24) + 1
    mask = np.zeros(n, dtype=bool)
    mask[[0, 3, (1 << 24) - 1, 1 << 24]] = True
    values = np.arange(n, dtype=np.int32)
    _assert_compact_matches(mask, values, 8, None)
    got_i, got_v = tops.compact(torch.from_numpy(mask),
                                torch.from_numpy(values), 3)
    assert got_i.tolist() == [0, 3, (1 << 24) - 1]
    assert got_v.tolist() == [0, 3, (1 << 24) - 1]


def test_compact_fill_below_v_holds_zero_values():
    """Unused slots hold (fill_index, 0) for any fill_index, as the TPU
    kernel's output (zeroed, then overwritten) does.  The reference's
    plain version reads values[fill_index] there when fill_index < V
    (repro/kernels/ref.py:34-35) — ROADMAP.md queue C."""
    mask = np.zeros(10, dtype=bool)
    mask[[3, 8]] = True
    values = np.arange(1, 11, dtype=np.float32)
    got_i, got_v = tops.compact(torch.from_numpy(mask),
                                torch.from_numpy(values), 5, fill_index=0)
    assert got_i.tolist() == [3, 8, 0, 0, 0]
    assert got_v.tolist() == [4.0, 9.0, 0.0, 0.0, 0.0]
    want_i, want_v = jref.compact(jnp.asarray(mask), jnp.asarray(values), 5,
                                  0)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.asarray(want_v).tolist() == [4.0, 9.0, 1.0, 1.0, 1.0]


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.uint8])
def test_compact_reads_any_mask_dtype_as_nonzero(dtype):
    mask = torch.tensor([0, 2, 0, -1, 1], dtype=torch.int32).to(dtype)
    if dtype == torch.uint8:
        mask = torch.tensor([0, 2, 0, 255, 1], dtype=dtype)
    values = torch.arange(5, dtype=torch.float32)
    idx, vals = tops.compact(mask, values, 4)
    assert idx.tolist() == [1, 3, 4, 5]
    assert vals.tolist() == [1.0, 3.0, 4.0, 0.0]
    want_i, _ = jref.compact(jnp.asarray(mask.numpy()), jnp.asarray(
        values.numpy()), 4)
    assert np.array_equal(idx.numpy(), np.asarray(want_i))


def test_compact_empty_and_zero_capacity():
    mask = torch.zeros(0, dtype=torch.bool)
    idx, vals = tref.compact(mask, torch.zeros(0), 3)
    assert idx.tolist() == [0, 0, 0] and vals.tolist() == [0.0] * 3
    idx, vals = tref.compact(torch.ones(5, dtype=torch.bool),
                             torch.ones(5), 0)
    assert idx.shape == (0,) and vals.shape == (0,)
