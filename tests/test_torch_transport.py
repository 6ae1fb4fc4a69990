"""The port's cluster transport against itself and the JAX package.

The cases of tests/test_transport.py on the port — every frame mode
(dense bitvector, sparse pairs, per-interval sections, multi-query column
modes) round-trips value bytes exactly over both transports, the codec
label says what ran — plus: port frames are byte-identical to
``repro.core.transport.encode_frame`` for the same update set and
compressor (1-D, ``[V, Q]``, interval sections, empty, with a control
record), each package decodes the other's frames, the ring wraps its
cursors, and both transports deliver in order.  The compressors pinned
for byte identity (``none``, ``zstd-1``) resolve the same way in both
packages: both fall back to zlib together when zstandard is absent.
"""
import os
import tempfile
import threading

import numpy as np
import pytest

from repro.core import transport as JT
from repro_torch import compat
from repro_torch.core import transport as T


def _rand_updates(rng, nv, density, qa=None):
    """Random sparse update triple at the given per-cell density."""
    if qa is None:
        upd = rng.random(nv) < density
        idx = np.nonzero(upd)[0].astype(np.int64)
        vals = rng.normal(size=len(idx)).astype(np.float32)
        return idx, vals, None
    mask = rng.random((nv, qa)) < density
    vmask = mask.any(axis=1)
    idx = np.nonzero(vmask)[0].astype(np.int64)
    m = mask[idx]
    vals = np.where(m, rng.normal(size=m.shape), 0.0).astype(np.float32)
    return idx, vals, m


def _assert_roundtrip(idx, vals, mask, dec):
    order = np.argsort(dec.idx)
    assert np.array_equal(dec.idx[order], idx)
    if mask is None:
        assert dec.mask is None
        assert np.array_equal(dec.vals[order], vals)
    else:
        assert np.array_equal(dec.mask[order], mask)
        got = np.where(dec.mask[order], dec.vals[order], 0.0)
        assert np.array_equal(got, np.where(mask, vals, 0.0))


@pytest.mark.parametrize("mode", ["dense", "sparse", "hybrid"])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.4, 0.9, 1.0])
def test_flat_1d_roundtrip(mode, density):
    rng = np.random.default_rng(int(density * 100) + len(mode))
    idx, vals, _ = _rand_updates(rng, 700, density)
    frame, header = T.encode_frame(idx, vals, None, 700, mode=mode)
    dec = T.decode_frame(frame)
    _assert_roundtrip(idx, vals, None, dec)
    assert dec.header["mode"] in ("dense", "sparse")
    assert header["wire_bytes"] == len(frame)
    if mode != "hybrid" and density > 0:
        assert dec.header["mode"] == mode


@pytest.mark.parametrize("compressor", ["none", "zstd-1", "zstd-3"])
def test_codec_label_reflects_fallback(compressor):
    rng = np.random.default_rng(3)
    idx, vals, _ = _rand_updates(rng, 300, 0.3)
    frame, header = T.encode_frame(idx, vals, None, 300,
                                   compressor=compressor)
    _assert_roundtrip(idx, vals, None, T.decode_frame(frame))
    if compressor == "none":
        assert header["codec"] == "none"
    else:
        want = "zstd" if compat.HAVE_ZSTD else "zlib"
        assert header["codec"].startswith(want)


@pytest.mark.parametrize("mode", ["dense", "sparse", "hybrid"])
def test_multi_query_column_modes_roundtrip(mode):
    rng = np.random.default_rng(11)
    nv = 400
    # per-column densities spanning the threshold -> mixed column modes
    mask = rng.random((nv, 5)) < np.array([0.9, 0.01, 0.5, 0.0, 0.2])
    idx = np.nonzero(mask.any(axis=1))[0].astype(np.int64)
    m = mask[idx]
    vals = np.where(m, rng.normal(size=m.shape), 0.0).astype(np.float32)
    frame, _ = T.encode_frame(idx, vals, m, nv, mode=mode)
    dec = T.decode_frame(frame)
    _assert_roundtrip(idx, vals, m, dec)
    if mode in ("dense", "sparse"):
        assert all(q == mode for q in dec.header["qmodes"])


@pytest.mark.parametrize("qa", [None, 3])
def test_interval_sections_roundtrip(qa):
    rng = np.random.default_rng(5)
    nv = 600
    splitter = np.array([0, 100, 250, 280, 500, 600], np.int64)
    idx, vals, mask = _rand_updates(rng, nv, 0.15, qa)
    keep = (idx < 250) | (idx >= 500)     # some intervals stay clean
    idx, vals = idx[keep], vals[keep]
    mask = mask[keep] if mask is not None else None
    frame, _ = T.encode_frame(idx, vals, mask, nv, splitter=splitter)
    dec = T.decode_frame(frame)
    _assert_roundtrip(idx, vals, mask, dec)
    assert dec.header["kind"] == "intervals"
    touched = set(np.searchsorted(splitter, idx, side="right") - 1)
    # clean intervals ship zero sections
    assert [s["iv"] for s in dec.header["sections"]] == sorted(touched)


def test_empty_updates_roundtrip():
    for splitter in (None, np.array([0, 50, 100], np.int64)):
        frame, _ = T.encode_frame(np.zeros(0, np.int64),
                                  np.zeros(0, np.float32), None, 100,
                                  splitter=splitter)
        dec = T.decode_frame(frame)
        assert len(dec.idx) == 0 and len(dec.vals) == 0


@pytest.mark.parametrize("qa,splitter", [(None, None), (4, None),
                                         (None, "iv"), (4, "iv")])
def test_hybrid_never_larger_than_pure_modes(qa, splitter):
    rng = np.random.default_rng(17)
    nv = 512
    sp = np.linspace(0, nv, 5).astype(np.int64) if splitter else None
    for density in (0.01, 0.2, 0.39, 0.41, 0.8):
        idx, vals, mask = _rand_updates(rng, nv, density, qa)
        sizes = {mode: len(T.encode_frame(idx, vals, mask, nv, splitter=sp,
                                          mode=mode)[0])
                 for mode in ("dense", "sparse", "hybrid")}
        assert sizes["hybrid"] <= min(sizes["dense"], sizes["sparse"])


def test_frame_bytes_deterministic():
    rng = np.random.default_rng(23)
    idx, vals, _ = _rand_updates(rng, 300, 0.3)
    f1, _ = T.encode_frame(idx, vals, None, 300)
    f2, _ = T.encode_frame(idx.copy(), vals.copy(), None, 300)
    assert f1 == f2


def test_decode_rejects_bad_magic():
    with pytest.raises(ValueError, match="magic"):
        T.decode_frame(b"XXXX" + bytes(16))


# ---------------------------------------------------------------------------
# Byte identity with the JAX package's frames, and decoding across
# ---------------------------------------------------------------------------

CONTROL = {"admit": [[9, 17]], "drain": [2], "pending": 1}


def _frame_case(name):
    """(idx, vals, mask, nv, splitter, control) of one named update set."""
    rng = np.random.default_rng(sum(map(ord, name)))
    nv, sp, control = 600, None, None
    if name == "flat-1d":
        idx, vals, mask = _rand_updates(rng, nv, 0.2)
    elif name == "flat-1d-dense":
        idx, vals, mask = _rand_updates(rng, nv, 0.8)
    elif name == "flat-vq":
        idx, vals, mask = _rand_updates(rng, nv, 0.3, qa=4)
    elif name == "intervals-1d":
        idx, vals, mask = _rand_updates(rng, nv, 0.1)
        sp = np.array([0, 150, 300, 450, 600], np.int64)
    elif name == "intervals-vq":
        idx, vals, mask = _rand_updates(rng, nv, 0.5, qa=3)
        sp = np.array([0, 200, 400, 600], np.int64)
    elif name == "empty":
        idx, vals, mask = (np.zeros(0, np.int64), np.zeros(0, np.float32),
                           None)
    elif name == "control":
        idx, vals, mask = _rand_updates(rng, nv, 0.05, qa=2)
        control = CONTROL
    else:
        raise ValueError(name)
    return idx, vals, mask, nv, sp, control


FRAME_CASES = ["flat-1d", "flat-1d-dense", "flat-vq", "intervals-1d",
               "intervals-vq", "empty", "control"]


@pytest.mark.parametrize("compressor", ["none", "zstd-1"])
@pytest.mark.parametrize("mode", ["dense", "sparse", "hybrid"])
@pytest.mark.parametrize("case", FRAME_CASES)
def test_frames_byte_identical_to_reference(case, mode, compressor):
    idx, vals, mask, nv, sp, control = _frame_case(case)
    kw = dict(splitter=sp, compressor=compressor, mode=mode,
              control=control)
    got, got_h = T.encode_frame(idx, vals, mask, nv, **kw)
    want, want_h = JT.encode_frame(idx, vals, mask, nv, **kw)
    assert got == want
    assert got_h == want_h


@pytest.mark.parametrize("case", FRAME_CASES)
def test_frames_decode_across_packages(case):
    idx, vals, mask, nv, sp, control = _frame_case(case)
    port_frame, _ = T.encode_frame(idx, vals, mask, nv, splitter=sp,
                                   control=control)
    ref_frame, _ = JT.encode_frame(idx, vals, mask, nv, splitter=sp,
                                   control=control)
    for dec in (JT.decode_frame(port_frame), T.decode_frame(ref_frame)):
        _assert_roundtrip(idx, vals, mask, dec)
        assert dec.header.get("control") == control
        assert dec.header["wire_bytes"] == len(port_frame)


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

def _transport_pair(kind, tmp):
    if kind == "shm":
        T.create_ring_files(tmp, 2, capacity=1 << 12)
    return T.make_transport(kind, 0, 2, tmp), T.make_transport(kind, 1, 2,
                                                               tmp)


@pytest.mark.parametrize("kind", ["shm", "tcp"])
def test_transport_ordered_delivery_and_large_messages(kind):
    tmp = tempfile.mkdtemp(prefix=f"transport_{kind}_")
    a, b = _transport_pair(kind, tmp)
    try:
        # messages larger than the shm ring's capacity go in chunks
        msgs = [os.urandom(n) for n in (1, 3, 5000, 20000, 7)]
        msgs += [i.to_bytes(4, "little") for i in range(200)]
        done = threading.Event()

        def send():
            for m in msgs:
                a.send(1, m)
            done.set()

        t = threading.Thread(target=send)
        t.start()
        got = []
        while len(got) < len(msgs):
            item = b.recv(timeout=10.0)
            assert item is not None, "transport recv timed out"
            src, payload = item
            assert src == 0
            got.append(payload)
        t.join(timeout=10.0)
        assert not t.is_alive() and done.is_set()
        assert got == msgs
        assert b.recv(timeout=0.05) is None
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("kind", ["shm", "tcp"])
def test_frames_cross_transport_byte_identically(kind):
    tmp = tempfile.mkdtemp(prefix=f"frames_{kind}_")
    a, b = _transport_pair(kind, tmp)
    try:
        rng = np.random.default_rng(29)
        cases = [_rand_updates(rng, 300, 0.9), _rand_updates(rng, 300, 0.01),
                 _rand_updates(rng, 300, 0.3, qa=3)]
        splitter = np.array([0, 100, 200, 300], np.int64)
        frames = []
        for k, (idx, vals, mask) in enumerate(cases):
            frame, _ = T.encode_frame(idx, vals, mask, 300,
                                      splitter=splitter if k == 1 else None)
            frames.append(frame)
            a.send(1, frame)
        for k, (idx, vals, mask) in enumerate(cases):
            src, payload = b.recv(timeout=10.0)
            assert payload == frames[k]
            _assert_roundtrip(idx, vals, mask, T.decode_frame(payload))
    finally:
        a.close()
        b.close()


def test_ring_channel_wraparound():
    tmp = tempfile.mkdtemp(prefix="ring_wrap_")
    path = os.path.join(tmp, "ch.buf")
    T.RingChannel.create(path, capacity=64)
    w = T.RingChannel(path, writer=True)
    r = T.RingChannel(path, writer=False)
    rng = np.random.default_rng(31)
    try:
        for _ in range(50):   # cursors wrap the 64-byte ring many times
            msg = rng.bytes(int(rng.integers(1, 50)))
            w.send_msg(msg, timeout=5.0)
            assert r.recv_msg(timeout=5.0) == msg
        assert r.recv_msg(timeout=0.01) is None
        # a message longer than the ring streams through it in chunks
        big = rng.bytes(1000)
        t = threading.Thread(target=w.send_msg, args=(big,),
                             kwargs=dict(timeout=5.0))
        t.start()
        assert r.recv_msg(timeout=5.0) == big
        t.join(timeout=5.0)
        assert not t.is_alive()
    finally:
        w.close()
        r.close()


def test_ring_write_times_out_when_full():
    tmp = tempfile.mkdtemp(prefix="ring_full_")
    path = os.path.join(tmp, "ch.buf")
    T.RingChannel.create(path, capacity=16)
    w = T.RingChannel(path, writer=True)
    try:
        with pytest.raises(TimeoutError, match="stalled"):
            w.send_msg(bytes(64), timeout=0.05)
    finally:
        w.close()


def test_make_transport_rejects_unknown():
    with pytest.raises(ValueError, match="unknown transport"):
        T.make_transport("carrier-pigeon", 0, 2, "/tmp")
