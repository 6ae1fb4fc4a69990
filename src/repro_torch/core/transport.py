"""Cluster transport of the port: framed vertex-update broadcast between
server processes (paper §III-C/§IV).

The port's copy of ``repro/core/transport.py``, numpy and stdlib only.
The single-process engine *measures* broadcast payloads through
``comm.plan_broadcast``/``plan_broadcast_intervals``; this module makes the
same wire formats actually travel between N server processes:

  * **Frames** (``encode_frame``/``decode_frame``) — a self-describing
    envelope around the exact payload layouts the planners produce: dense
    (``ceil(V/8)`` bitvector + ``[V]`` values), sparse ((u32 vertex,
    value) pairs), multi-query per-column sections ((u32 vertex, u32
    query) pair pool), and per-dirty-interval sections (8-byte
    (interval, count) header + a local payload per interval).  Value bytes
    round-trip exactly, which is what keeps cluster results bit-identical
    to the single-process engine.  A frame is byte-identical to the
    reference package's for the same update set and compressor, so each
    package decodes the other's frames.
  * **Hybrid selection** — with ``mode="hybrid"`` the encoder builds the
    dense, sparse, *and* threshold-mixed candidate bodies from the
    measured update density, compresses each, and ships the smallest; the
    hybrid frame is therefore never larger than the best pure mode.
  * **Transports** — :class:`RingTransport`, a shared-memory SPSC byte
    ring per directed server pair (mmap over a file in the run directory:
    spawn-safe, no resource-tracker leaks), and :class:`SocketTransport`,
    a TCP fallback with file-based port rendezvous for servers that do not
    share memory.  Both expose ``send(dst, payload)`` / ``recv(timeout)``;
    delivery per channel is ordered and reliable.

Thread-safety: ``send`` may be called by one thread per destination;
``recv`` by one consumer thread.  The cluster exchange protocol that sits
on top lives in ``core.distributed.ClusterExchange``.  Fault injection
around a transport is ROADMAP.md queue A.10.
"""
from __future__ import annotations

import dataclasses
import json
import mmap
import os
import queue
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core import comm
from repro_torch.graphio import formats

#: frame magic — "GraphH Frame v1"
FRAME_MAGIC = b"GHF1"

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


# ---------------------------------------------------------------------------
# Frame codec
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodedFrame:
    """A decoded update frame: the sparse-update triple the engine's
    barrier apply consumes, plus the frame header (mode choices, sizes)."""

    idx: np.ndarray            # [U] global updated vertex ids (int64)
    vals: np.ndarray           # [U] or [U, Q] update values (header dtype)
    mask: Optional[np.ndarray]  # [U, Q] per-query updated mask; None for 1-D
    header: dict               # frame header (mode, raw/wire bytes)


def _flat_body(vals_dense: np.ndarray, upd: np.ndarray, threshold: float,
               mode: str) -> tuple[bytes, str, Optional[tuple]]:
    """Uncompressed whole-range payload for one mode choice.  Returns
    (payload bytes, record mode label, per-column qmodes or None)."""
    if vals_dense.ndim == 2:
        payload, qmodes = comm.multi_query_payload(
            vals_dense, upd, threshold, mode)
        uniq = set(qmodes)
        label = "sparse" if not qmodes else (
            qmodes[0] if len(uniq) == 1 else "mixed")
        return payload, label, qmodes
    density = float(upd.mean()) if upd.size else 0.0
    use_dense = mode == "dense" or (mode == "hybrid" and density >= threshold)
    if use_dense:
        return comm.dense_payload(vals_dense, upd), "dense", None
    return comm.sparse_payload(vals_dense, upd), "sparse", None


def _range_body(vals_dense: np.ndarray, upd: np.ndarray, threshold: float,
                mode: str, comp_mode: int) -> tuple[bytes, int, str,
                                                    Optional[tuple]]:
    """Compressed body for one range under one fixed mode choice.  Returns
    (compressed body, raw payload bytes, mode label, qmodes)."""
    payload, label, qmodes = _flat_body(vals_dense, upd, threshold, mode)
    return (formats.compress_blob(payload, comp_mode), len(payload),
            label, qmodes)


def _densify_updates(idx: np.ndarray, vals: np.ndarray,
                     mask: Optional[np.ndarray], lo: int, hi: int,
                     dtype) -> tuple[np.ndarray, np.ndarray]:
    """Scatter a sparse update triple into dense local-range arrays
    ([hi-lo(, Q)] values + updated mask) for the payload encoders."""
    n = hi - lo
    local = idx - lo
    if mask is not None:
        qa = vals.shape[1]
        dense = np.zeros((n, qa), dtype)
        upd = np.zeros((n, qa), dtype=bool)
        dense[local] = vals
        upd[local] = mask
    else:
        dense = np.zeros(n, dtype)
        upd = np.zeros(n, dtype=bool)
        dense[local] = vals
        upd[local] = True
    return dense, upd


def encode_frame(
    idx: np.ndarray,
    vals: np.ndarray,
    mask: Optional[np.ndarray],
    nv: int,
    *,
    splitter: Optional[np.ndarray] = None,
    threshold: float = comm.DENSITY_THRESHOLD,
    compressor: str = "zstd-1",
    mode: str = "hybrid",
    control: Optional[dict] = None,
) -> tuple[bytes, dict]:
    """Encode one server's per-superstep update set into a wire frame.

    ``idx`` [U] global updated vertex ids; ``vals`` [U] or [U, Q] values;
    ``mask`` [U, Q] per-query updated mask (None for 1-D).  With
    ``splitter`` (int64[K+1] interval boundaries, DESIGN.md §10) the body
    is per-dirty-interval sections exactly like
    ``comm.plan_broadcast_intervals``; otherwise one whole-V payload like
    ``comm.plan_broadcast``.  A frame is a pure function of the update
    set plus the barrier's ``control`` record (no timings or other
    run-varying measurements — the exchange carries those in its
    fixed-width envelope), so its size is reproducible across runs.
    ``control``, when given, is a JSON-safe dict shipped verbatim in the
    header — the session's admission/drain records (DESIGN.md §13) ride
    here so every rank splices the same columns at the same barrier.

    Returns (frame bytes, header dict).  ``header["wire_bytes"]`` is the
    full frame size (what actually travels); ``header["raw_bytes"]`` the
    uncompressed payload size, matching the planners' accounting.

    ``mode="hybrid"`` is the measured-size refinement of the paper's
    density-threshold switch (DESIGN.md §11): the complete frame is built
    under forced-dense, forced-sparse, and the per-column/per-interval
    threshold mix, and the smallest frame ships — so a hybrid frame is
    never larger than the best pure mode, per server per superstep.
    """
    if mode == "hybrid":
        best = None
        for m in ("dense", "sparse", "threshold"):
            cand = encode_frame(idx, vals, mask, nv, splitter=splitter,
                                threshold=threshold, compressor=compressor,
                                mode=m, control=control)
            if best is None or len(cand[0]) < len(best[0]):
                best = cand
        return best
    if mode == "threshold":
        mode = "hybrid"   # the payload encoders' name for the threshold mix
    comp_mode, codec = comm.resolve_compressor(compressor)
    dtype = np.dtype(vals.dtype)
    qa = vals.shape[1] if vals.ndim == 2 else None
    idx = np.asarray(idx, dtype=np.int64)
    cells = nv * (qa or 1)
    updated_cells = int(mask.sum()) if mask is not None else len(idx)

    sections: list[dict] = []
    bodies: list[bytes] = []
    raw = 0
    if splitter is None:
        dense, upd = _densify_updates(idx, vals, mask, 0, nv, dtype)
        body, raw, label, qmodes = _range_body(
            dense, upd, threshold, mode, comp_mode)
        bodies.append(body)
        kind = "flat"
    else:
        kind = "intervals"
        label, qmodes = "interval", None
        splitter = np.asarray(splitter, dtype=np.int64)
        if len(idx):
            ivs = np.searchsorted(splitter, idx, side="right") - 1
            for iv in np.unique(ivs):
                lo, hi = int(splitter[iv]), int(splitter[iv + 1])
                sel = ivs == iv
                dense, upd = _densify_updates(
                    idx[sel], vals[sel],
                    mask[sel] if mask is not None else None, lo, hi, dtype)
                body, sraw, slabel, sqmodes = _range_body(
                    dense, upd, threshold, mode, comp_mode)
                bodies.append(body)
                raw += sraw + comm.INTERVAL_HEADER_BYTES
                sections.append(dict(
                    iv=int(iv), lo=lo, hi=hi, count=int(sel.sum()),
                    mode=slabel, qmodes=list(sqmodes) if sqmodes else None,
                    len=len(body)))

    header = dict(
        v=1, kind=kind, nv=int(nv), qa=qa, dtype=dtype.str,
        comp=comp_mode, codec=codec, mode=label,
        qmodes=list(qmodes) if qmodes else None,
        sections=sections or None,
        density=updated_cells / max(cells, 1),
        raw_bytes=int(raw),
    )
    if control:
        header["control"] = control
    body_all = b"".join(bodies)
    hb = json.dumps(header).encode()
    frame = b"".join([FRAME_MAGIC, _U32.pack(len(hb)), hb, body_all])
    header["wire_bytes"] = len(frame)
    return frame, header


def decode_frame(frame: bytes) -> DecodedFrame:
    """Invert :func:`encode_frame`.  Value bytes round-trip exactly (no
    float re-encoding); see tests/test_torch_transport.py for the property
    sweep over every mode, including the zlib-fallback codec."""
    if frame[:4] != FRAME_MAGIC:
        raise ValueError("bad frame magic")
    (hlen,) = _U32.unpack_from(frame, 4)
    header = json.loads(frame[8: 8 + hlen].decode())
    body = frame[8 + hlen:]
    header["wire_bytes"] = len(frame)
    dtype = np.dtype(header["dtype"])
    nv, qa = header["nv"], header["qa"]
    comp = header["comp"]

    def _decode_range(buf: bytes, n: int, mode: str, qmodes):
        if qa is not None:
            return comm.decode_multi_query_payload(buf, n, tuple(qmodes), dtype)
        if mode == "dense":
            i, v = comm.decode_dense_payload(buf, n, dtype)
        else:
            i, v = comm.decode_sparse_payload(buf, dtype)
        return i, v, None

    if header["kind"] == "flat":
        payload = formats.decompress_blob(body, comp)
        i, v, m = _decode_range(payload, nv, header["mode"],
                                header["qmodes"])
        return DecodedFrame(idx=i, vals=v, mask=m, header=header)

    parts_i: list[np.ndarray] = []
    parts_v: list[np.ndarray] = []
    parts_m: list[np.ndarray] = []
    off = 0
    for sec in header["sections"] or []:
        payload = formats.decompress_blob(body[off: off + sec["len"]], comp)
        off += sec["len"]
        i, v, m = _decode_range(payload, sec["hi"] - sec["lo"],
                                sec["mode"], sec["qmodes"])
        parts_i.append(i + sec["lo"])
        parts_v.append(v)
        if m is not None:
            parts_m.append(m)
    if parts_i:
        idx = np.concatenate(parts_i)
        vals = np.concatenate(parts_v)
        mask = np.concatenate(parts_m) if parts_m else None
    else:
        idx = np.zeros(0, np.int64)
        vals = (np.zeros((0, qa), dtype) if qa is not None
                else np.zeros(0, dtype))
        mask = np.zeros((0, qa), dtype=bool) if qa is not None else None
    return DecodedFrame(idx=idx, vals=vals, mask=mask, header=header)


# ---------------------------------------------------------------------------
# Shared-memory ring (mmap-backed SPSC byte ring per directed channel)
# ---------------------------------------------------------------------------

class RingChannel:
    """Single-producer single-consumer byte ring over an mmap'd file.

    Layout: ``head`` u64 (consumer cursor) | ``tail`` u64 (producer
    cursor) | ``capacity`` data bytes.  Cursors increase monotonically
    (byte positions, not wrapped), so free space is
    ``capacity - (tail - head)`` and the ring never confuses full with
    empty.  Messages are framed with a u32 length and may wrap; writes
    larger than the free space proceed in chunks as the consumer drains,
    so the capacity bounds memory, not message size.

    File-backed mmap rather than ``multiprocessing.shared_memory``: same
    page-cache-shared memory on the runtime's single-host deployments, but
    spawn-safe by name with no resource-tracker teardown warnings.  One
    writer process/thread and one reader process/thread per channel.
    """

    HEADER = 16

    def __init__(self, path: str, writer: bool, poll_s: float = 0.0005):
        self.path = path
        self.writer = writer
        self.poll_s = poll_s
        self._f = open(path, "r+b")
        size = os.path.getsize(path)
        self.capacity = size - self.HEADER
        self._mm = mmap.mmap(self._f.fileno(), size)

    @staticmethod
    def create(path: str, capacity: int) -> None:
        """Pre-create a zeroed channel file (parent does this for every
        directed server pair before spawning)."""
        with open(path, "wb") as f:
            f.write(b"\0" * (RingChannel.HEADER + capacity))

    # -- cursor accessors (u64 little-endian; aligned loads/stores) -------
    def _head(self) -> int:
        return _U64.unpack_from(self._mm, 0)[0]

    def _tail(self) -> int:
        return _U64.unpack_from(self._mm, 8)[0]

    def _set_head(self, v: int) -> None:
        _U64.pack_into(self._mm, 0, v)

    def _set_tail(self, v: int) -> None:
        _U64.pack_into(self._mm, 8, v)

    # -- byte-stream primitives ------------------------------------------
    def _write_stream(self, data: bytes, deadline: Optional[float]) -> None:
        mm, cap = self._mm, self.capacity
        off = 0
        tail = self._tail()
        while off < len(data):
            free = cap - (tail - self._head())
            if free == 0:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"ring write stalled: {self.path}")
                time.sleep(self.poll_s)
                continue
            n = min(free, len(data) - off)
            pos = tail % cap
            first = min(n, cap - pos)
            mm[self.HEADER + pos: self.HEADER + pos + first] = \
                data[off: off + first]
            if n > first:
                mm[self.HEADER: self.HEADER + n - first] = \
                    data[off + first: off + n]
            tail += n
            self._set_tail(tail)   # publish after the bytes land
            off += n

    def _read_stream(self, n: int, deadline: Optional[float]) -> Optional[bytes]:
        mm, cap = self._mm, self.capacity
        out = bytearray()
        head = self._head()
        while len(out) < n:
            avail = self._tail() - head
            if avail == 0:
                if deadline is not None and time.monotonic() > deadline:
                    return None if not out else self._fail_partial()
                time.sleep(self.poll_s)
                continue
            take = min(avail, n - len(out))
            pos = head % cap
            first = min(take, cap - pos)
            out += mm[self.HEADER + pos: self.HEADER + pos + first]
            if take > first:
                out += mm[self.HEADER: self.HEADER + take - first]
            head += take
            self._set_head(head)
        return bytes(out)

    def _fail_partial(self):
        raise TimeoutError(f"ring read stalled mid-message: {self.path}")

    # -- message framing --------------------------------------------------
    def send_msg(self, payload: bytes, timeout: Optional[float] = None) -> None:
        """Blocking framed send (u32 length + bytes)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        self._write_stream(_U32.pack(len(payload)) + payload, deadline)

    def recv_msg(self, timeout: Optional[float] = 0.0) -> Optional[bytes]:
        """Receive one framed message; returns None if no *complete header*
        arrives within ``timeout`` (a started message is always drained)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        hdr = self._read_stream(4, deadline)
        if hdr is None:
            return None
        (n,) = _U32.unpack(hdr)
        return self._read_stream(n, None)

    def poll(self) -> bool:
        """True if at least a message header is waiting."""
        return self._tail() - self._head() >= 4

    def close(self) -> None:
        """Unmap the ring (the file itself is owned by the run directory)."""
        self._mm.close()
        self._f.close()


class RingTransport:
    """Shared-memory transport: one :class:`RingChannel` per directed
    server pair, files named ``ring_<src>_<dst>.buf`` under the cluster
    run directory (created by the parent via :func:`create_ring_files`).
    ``recv`` round-robin-polls the inbound channels."""

    kind = "shm"

    def __init__(self, rank: int, n: int, run_dir: str):
        self.rank, self.n = rank, n
        self._out = {d: RingChannel(ring_path(run_dir, rank, d), writer=True)
                     for d in range(n) if d != rank}
        self._in = {s: RingChannel(ring_path(run_dir, s, rank), writer=False)
                    for s in range(n) if s != rank}

    def send(self, dst: int, payload: bytes,
             timeout: Optional[float] = None) -> None:
        """Ordered, reliable framed send to server ``dst``."""
        self._out[dst].send_msg(payload, timeout=timeout)

    def recv(self, timeout: float = 0.1) -> Optional[tuple[int, bytes]]:
        """Next (source rank, payload) from any inbound channel, or None
        after ``timeout`` seconds of silence."""
        deadline = time.monotonic() + timeout
        while True:
            # lint: allow(GH205): _in built in ascending rank order at construction
            for s, ch in self._in.items():
                if ch.poll():
                    msg = ch.recv_msg(timeout=None)
                    return s, msg
            if time.monotonic() > deadline:
                return None
            time.sleep(0.001)

    def close(self) -> None:
        """Unmap every channel."""
        # lint: allow(GH205): resource teardown — close order is irrelevant
        for ch in (*self._out.values(), *self._in.values()):
            ch.close()


def ring_path(run_dir: str, src: int, dst: int) -> str:
    """Channel file for the ``src -> dst`` ring under ``run_dir``."""
    return os.path.join(run_dir, f"ring_{src}_{dst}.buf")


def create_ring_files(run_dir: str, n: int, capacity: int = 1 << 22) -> None:
    """Pre-create all N*(N-1) directed ring files (parent-side setup)."""
    for s in range(n):
        for d in range(n):
            if s != d:
                RingChannel.create(ring_path(run_dir, s, d), capacity)


# ---------------------------------------------------------------------------
# Socket transport (TCP fallback, file-based port rendezvous)
# ---------------------------------------------------------------------------

class SocketTransport:
    """TCP transport for servers that do not share memory.

    Each server binds an ephemeral listener and publishes its port as
    ``port_<rank>`` in the run directory (atomic rename — the rendezvous
    needs only a shared filesystem, no coordinator).  Outbound connections
    are opened lazily per peer and announce the sender rank with a u32
    hello; an accept thread spawns one reader thread per inbound
    connection, all feeding a single ``recv`` queue.  Framing and ordering
    guarantees match :class:`RingTransport`."""

    kind = "tcp"

    #: lock discipline, enforced by tools/analyze.py --check locks
    #: (the lazily-connected outbound socket map; one lock per peer)
    _guarded_by = {"_out": "_out_locks"}

    def __init__(self, rank: int, n: int, run_dir: str,
                 host: str = "127.0.0.1", connect_timeout: float = 60.0):
        self.rank, self.n, self.run_dir = rank, n, run_dir
        self.host = host
        self.connect_timeout = connect_timeout
        self._q: "queue.Queue[tuple[int, bytes]]" = queue.Queue()
        self._out: dict[int, socket.socket] = {}
        self._out_locks = {d: threading.Lock() for d in range(n)}
        self._stop = threading.Event()
        self._listener = socket.create_server((host, 0))
        self._listener.settimeout(0.2)
        port = self._listener.getsockname()[1]
        tmp = os.path.join(run_dir, f"port_{rank}.tmp")
        with open(tmp, "w") as f:
            f.write(str(port))
        os.replace(tmp, os.path.join(run_dir, f"port_{rank}"))
        self._threads = [threading.Thread(target=self._accept_loop,
                                          name=f"graphh-accept-{rank}",
                                          daemon=True)]
        self._threads[0].start()

    # -- inbound ----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._reader, args=(conn,),
                                 name=f"graphh-sockrd-{self.rank}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _recv_exact(self, conn: socket.socket, n: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except socket.timeout:
                if self._stop.is_set():
                    return None
                continue
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return bytes(buf)

    def _reader(self, conn: socket.socket) -> None:
        conn.settimeout(0.5)
        hello = self._recv_exact(conn, 4)
        if hello is None:
            return
        (src,) = _U32.unpack(hello)
        while not self._stop.is_set():
            hdr = self._recv_exact(conn, 4)
            if hdr is None:
                return
            (ln,) = _U32.unpack(hdr)
            payload = self._recv_exact(conn, ln)
            if payload is None:
                return
            self._q.put((src, payload))

    # -- outbound ---------------------------------------------------------
    def _connect(self, dst: int) -> socket.socket:
        deadline = time.monotonic() + self.connect_timeout
        path = os.path.join(self.run_dir, f"port_{dst}")
        while True:
            try:
                with open(path) as f:
                    port = int(f.read())
                s = socket.create_connection((self.host, port), timeout=5.0)
                # the 5s timeout is for *connecting* only: a data socket
                # must block on sendall (a timeout mid-frame would corrupt
                # the stream framing after a partial write — the exchange
                # protocol owns per-superstep deadlines, not the socket)
                s.settimeout(None)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.sendall(_U32.pack(self.rank))
                return s
            except (OSError, ValueError):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"server {self.rank} could not reach peer {dst}")
                time.sleep(0.05)

    def send(self, dst: int, payload: bytes,
             timeout: Optional[float] = None) -> None:
        """Ordered, reliable framed send to server ``dst`` (lazy connect)."""
        with self._out_locks[dst]:
            if dst not in self._out:
                self._out[dst] = self._connect(dst)
            self._out[dst].sendall(_U32.pack(len(payload)) + payload)

    def recv(self, timeout: float = 0.1) -> Optional[tuple[int, bytes]]:
        """Next (source rank, payload) from any peer, or None on timeout."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        """Stop the accept/reader threads and close every socket."""
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for dst in range(self.n):
            with self._out_locks[dst]:
                s = self._out.pop(dst, None)
            if s is None:
                continue
            try:
                s.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)


TRANSPORTS = {"shm": RingTransport, "tcp": SocketTransport}


def make_transport(kind: str, rank: int, n: int, run_dir: str, **kw):
    """Construct a transport by name ("shm" ring | "tcp" sockets)."""
    cls = TRANSPORTS.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown transport {kind!r}; valid: {', '.join(sorted(TRANSPORTS))}")
    return cls(rank, n, run_dir, **kw)
