"""Distributed GAB of the port: the process-group path and the
multi-process cluster exchange protocol (DESIGN.md §11).

Mapping of the paper's cluster onto ``torch.distributed`` (the reference
maps it onto a TPU mesh):

  servers (MPI ranks)   -> ranks of a process group, one process each
  AA vertex replication -> vertex values replicated on every rank
  tile assignment       -> the padded tile stack cut into contiguous
                           blocks, one per rank, resident on its device
  Broadcast             -> all_reduce SUM of update-masked values (dense)
                           or all_gather of the compact kernel's fixed-
                           capacity (idx, val) pairs (sparse), chosen by
                           the measured global update density (hybrid)

The backend is chosen explicitly (:func:`init_process_group`): NCCL for a
CUDA device, gloo for the CPU, or the one the caller names.  Nothing here
switches backend or device on its own.

The second half of this module is the *process* cluster:
``ClusterExchange`` implements the per-superstep BSP barrier between N
real server processes — encode this server's updates into a
``core.transport`` frame, broadcast it to the N-1 peers, merge the
peers' decoded frames in rank order, and (with stealing enabled)
rebalance tile ownership from the measured per-server compute times.  The
out-of-core engine calls it at its barrier when built with
``server_rank``/``exchange`` (engine.py); ``launch.cluster`` owns the
process spawning.
"""
from __future__ import annotations

import dataclasses
import struct
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import comm, transport as transport_mod
from repro_torch.core.gab import (VertexProgram, stack_to_device,
                                  stacked_tiles_step, state_from_numpy)
from repro_torch.core.tiles import Tile, stack_tiles
from repro_torch.runtime.scheduler import rebalance_assignment


@dataclasses.dataclass
class DistConfig:
    """Knobs for the process-group distributed engine; the port adds
    ``device`` and names its kernels in ``seg_impl``."""
    comm_mode: str = "hybrid"       # dense | sparse | hybrid
    threshold: float = comm.DENSITY_THRESHOLD
    seg_impl: str = "fused"
    wire_dtype: Optional[str] = None   # e.g. "bfloat16" for a narrowed wire
    max_supersteps: int = 200
    # this rank's device: "cuda" launches the kernels, "cpu" runs their
    # plain versions (the tests)
    device: str = "cuda"


GROUP_TIMEOUT_S = 300.0


def rank_device(device: str, rank: int) -> str:
    """The device rank ``rank`` computes on: an indexed device as given,
    a bare ``"cuda"`` as card ``rank % device_count`` (one card a rank on
    a host of several), any other device as given."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(f"device {device!r} requested but PyTorch "
                               "sees no CUDA device")
        return f"cuda:{rank % n}"
    return device


def init_process_group(rank: int, world_size: int, init_method: str,
                       device: str = "cuda",
                       backend: Optional[str] = None) -> str:
    """Join the default process group as ``rank`` of ``world_size`` at
    ``init_method`` (e.g. ``tcp://localhost:29500``).  The backend is
    ``backend`` when given, else NCCL for a CUDA ``device`` and gloo for
    the CPU.  On the card this rank's card (:func:`rank_device`) is made
    the current device first, so that NCCL and every bare ``"cuda"``
    tensor of the rank land there, not all on card 0.  A collective that
    waits longer than ``GROUP_TIMEOUT_S`` fails instead of holding the
    cards.
    Returns the backend."""
    import datetime

    kind = torch.device(device).type
    if backend is None:
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"no default backend for device {device!r}")
        backend = "nccl" if kind == "cuda" else "gloo"
    if kind == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(torch.device(rank_device(device, rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(
                                seconds=GROUP_TIMEOUT_S))
    return backend


def pad_tile_count(num_tiles: int, num_shards: int) -> int:
    """Round ``num_tiles`` up to a multiple of ``num_shards``."""
    return ((num_tiles + num_shards - 1) // num_shards) * num_shards


def make_empty_tile_arrays(stk: dict) -> dict:
    """An inert tile: every edge points at the global sink row, zero rows."""
    ecap, rcap = stk["edge_cap"], stk["row_cap"]
    return dict(
        src=np.zeros((1, ecap), np.int32),
        dst_local=np.full((1, ecap), rcap, np.int32),
        val=np.zeros((1, ecap), np.float32),
        row_start=np.zeros((1,), np.int32),
        num_rows=np.zeros((1,), np.int32),
        num_edges=np.zeros((1,), np.int32),
    )


def pad_stack_to(stk: dict, total: int) -> dict:
    """Pad a ``stack_tiles`` dict along the tile axis to exactly ``total``
    tiles using inert tiles (all edges at the sink row, zero rows).  Padding
    changes no per-row result — used by the distributed engine to even out
    shards and by the pipelined engine to keep every batch ``stack_size``
    tiles long."""
    pad = total - len(stk["row_start"])
    if pad > 0:
        empty = make_empty_tile_arrays(stk)
        for k in ("src", "dst_local", "val", "row_start", "num_rows",
                  "num_edges"):
            stk[k] = np.concatenate([stk[k]] + [empty[k]] * pad, axis=0)
    return stk


def stack_and_pad(tiles: list[Tile], row_cap: int, num_shards: int) -> dict:
    """Stack tiles and pad the tile axis to a multiple of num_shards."""
    stk = stack_tiles(tiles, row_cap)
    return pad_stack_to(stk, pad_tile_count(len(tiles), num_shards))


def build_superstep(prog: VertexProgram, group, row_cap: int,
                    num_vertices: int, cfg: DistConfig = DistConfig()):
    """Returns a superstep ``(values, aux, stk) -> (values', density,
    branch)`` for one rank of ``group``.

    values/aux are this rank's replicas; ``stk`` is its block of the
    padded tile stack on its device (:meth:`DistributedGABEngine.
    shard_tiles`).  The rank runs ``gab.stacked_tiles_step`` over its
    block, then ``comm.hybrid_broadcast`` replicates the updates.
    Multi-query programs (values ``[V, Q]``) work unchanged: the stacked
    step is shape-polymorphic and the broadcast flattens to (vertex,
    query) cells, so the sparse capacity is scaled by Q."""
    nq = max(getattr(prog, "num_queries", 1), 1)
    capacity = comm.sparse_capacity(num_vertices * nq, cfg.threshold)
    wire = None if cfg.wire_dtype is None else getattr(torch, cfg.wire_dtype)

    def superstep(values, aux, stk):
        new_masked, upd = stacked_tiles_step(prog, values, aux, stk,
                                             row_cap, cfg.seg_impl)
        return comm.hybrid_broadcast(
            values, new_masked, upd, group, capacity=capacity,
            threshold=cfg.threshold, mode=cfg.comm_mode, value_dtype=wire)

    return superstep


class DistributedGABEngine:
    """In-memory distributed GAB over a process group, one rank a process
    (the multi-device execution path; the out-of-core disk tier is
    engine.py's job).  Every rank of ``group`` builds one and calls
    :meth:`run` with the same arguments."""

    def __init__(self, group=None, cfg: DistConfig = DistConfig()):
        self.group = group
        self.cfg = cfg
        self.rank = dist.get_rank(group)
        self.num_shards = dist.get_world_size(group)
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {cfg.device!r} requested but "
                               "PyTorch sees no CUDA device")

    def shard_tiles(self, tiles: list[Tile], row_cap: int) -> dict:
        """Stack + pad the tiles, and copy this rank's contiguous block of
        the stack to its device (``gab.stack_to_device``)."""
        stk = stack_and_pad(tiles, row_cap, self.num_shards)
        per = len(stk["row_start"]) // self.num_shards
        blk = slice(self.rank * per, (self.rank + 1) * per)
        out = stack_to_device(
            {k: stk[k][blk] for k in ("src", "dst_local", "val",
                                      "row_start", "num_rows")},
            self.device)
        out["row_cap"] = stk["row_cap"]
        out["edge_cap"] = stk["edge_cap"]
        return out

    def run(self, prog: VertexProgram, tiles: list[Tile], num_vertices: int,
            out_degree: np.ndarray, in_degree: np.ndarray,
            row_cap: int, max_supersteps: Optional[int] = None):
        """Run supersteps to convergence (global update density == 0) or the
        cap; returns (final values [V(, Q)] on the host, per-superstep
        history of ``superstep``, ``density``, ``branch`` and ``seconds``,
        host wall time from one superstep's density read to the next's:
        the read waits for the device, so each superstep's device work is
        counted once, give or take the broadcast's tail)."""
        state = prog.init(num_vertices, out_degree.astype(np.float64),
                          in_degree.astype(np.float64))
        state = state_from_numpy(state, self.device)
        values = state.pop("value")
        aux = state
        stk = self.shard_tiles(tiles, row_cap)
        step = build_superstep(prog, self.group, row_cap, num_vertices,
                               self.cfg)
        history = []
        max_ss = max_supersteps or self.cfg.max_supersteps
        for ss in range(max_ss):
            t0 = time.perf_counter()
            values, density, branch = step(values, aux, stk)
            history.append(dict(superstep=ss, density=density,
                                branch=branch,
                                seconds=time.perf_counter() - t0))
            if density == 0.0:
                break
        return values.cpu().numpy(), history


# ---------------------------------------------------------------------------
# Multi-process cluster exchange (DESIGN.md §11)
# ---------------------------------------------------------------------------

# Fixed-width exchange envelope prepended to every frame: (sequence number,
# sender's measured compute seconds, sender's updated-cell count).  Wire
# *measurements* live here — NOT in the frame — so frame bytes are a pure
# function of the update set (plus rank 0's deterministic admission control
# record, which rides in the frame header) and wire sizes are reproducible
# run to run.  The same layout as the reference's.
_ENVELOPE = struct.Struct("<IdQ")

#: the exchange's phases, each a ``record_function`` range and a seconds
#: counter of :attr:`ClusterExchange.seconds`
EXCHANGE_PHASES = ("exchange_encode", "exchange_send", "exchange_wait",
                   "exchange_decode", "exchange_merge")


@dataclasses.dataclass
class ExchangeResult:
    """Merged cluster-wide update set for one superstep (what the engine's
    barrier apply consumes), plus measured wire accounting and — when
    stealing moved tiles — the next superstep's full tile assignment."""

    idx: np.ndarray                 # [U] updated vertex ids, all servers
    vals: np.ndarray                # [U] or [U, Q] update values
    mask: Optional[np.ndarray]      # [U, Q] per-query mask; None for 1-D
    raw_bytes: int                  # cluster total, pre-compression
    wire_bytes: int                 # cluster total, actual frame bytes
    assignment: Optional[list] = None   # new per-server tile lists, or None
    peer_seconds: dict = dataclasses.field(default_factory=dict)
    #: rank 0's admission/drain control record for this barrier —
    #: identical on every rank, None when rank 0 shipped none
    control: Optional[dict] = None


class ClusterExchange:
    """Per-superstep BSP exchange between N server processes.

    Each server encodes its update set into one ``core.transport`` frame
    (hybrid dense/sparse chosen per server per superstep from the measured
    sizes), ships it to all peers, and blocks until every peer's frame for
    the same sequence number has arrived.  A background receiver thread
    drains and *decodes* inbound frames as they arrive, so a fast peer's
    broadcast overlaps this server's remaining tile compute — the
    cluster-level leg of the paper's I/O–compute–comm overlap.

    The merge is deterministic (rank order) and every server derives the
    same merged update set, so convergence checks and multi-query column
    retirement in the engine come out identical on every server with no
    extra control round — the exchange IS the global barrier.

    Stealing: with ``steal=True`` every frame carries its server's
    measured compute seconds; each server runs the same
    ``runtime.scheduler.rebalance_assignment`` on the same inputs, so all
    servers agree on the next superstep's tile ownership without a
    coordinator (the thief reads stolen tiles from the shared store, the
    victim's cache keeps its copies).

    Each phase of an exchange — encode and compress, send, wait for the
    peers, decode (on the receiver thread), merge — is a
    ``torch.profiler.record_function`` range and adds its wall time to
    :attr:`seconds`.

    Thread-safety: ``exchange()`` must be called by one thread (the engine
    loop); the receiver thread only touches the inbox under its lock.
    """

    #: lock discipline: _cond wraps the inbox mutex shared with the
    #: receiver thread
    _guarded_by = {"_inbox": "_cond", "_rx_error": "_cond",
                   "seconds": "_cond"}

    def __init__(self, transport, *, comm_mode: str = "hybrid",
                 compressor: str = "zstd-1",
                 threshold: float = comm.DENSITY_THRESHOLD,
                 assignment: Optional[list] = None,
                 edges_per_tile: Optional[np.ndarray] = None,
                 steal: bool = False, straggler_factor: float = 1.5,
                 timeout: float = 180.0):
        self.transport = transport
        self.rank, self.n = transport.rank, transport.n
        self.comm_mode = comm_mode
        self.compressor = compressor
        self.threshold = threshold
        self.assignment = ([list(a) for a in assignment]
                           if assignment is not None else None)
        self.edges_per_tile = edges_per_tile
        self.steal = steal and self.n > 1
        self.straggler_factor = straggler_factor
        self.timeout = timeout
        self.steal_moves = 0
        #: bytes this server actually put on the wire / their raw size
        self.sent_wire_bytes = 0
        self.sent_raw_bytes = 0
        #: wall seconds per phase (EXCHANGE_PHASES) over every exchange
        self.seconds = dict.fromkeys(EXCHANGE_PHASES, 0.0)
        self._seq = 0
        self._inbox: dict[int, dict[int, tuple]] = {}
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._rx_error: Optional[BaseException] = None
        self._rx: Optional[threading.Thread] = None
        if self.n > 1:
            self._rx = threading.Thread(target=self._recv_loop, daemon=True,
                                        name=f"graphh-exchange-{self.rank}")
            self._rx.start()

    def _add_seconds(self, phase: str, t0: float) -> None:
        with self._cond:
            self.seconds[phase] += time.perf_counter() - t0

    # -- receive side -----------------------------------------------------
    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            item = self.transport.recv(timeout=0.1)
            if item is None:
                continue
            src, payload = item
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function("exchange_decode"):
                    seq, secs, _updates = _ENVELOPE.unpack_from(payload, 0)
                    dec = transport_mod.decode_frame(
                        payload[_ENVELOPE.size:])
            except BaseException as exc:  # surfaced on the exchange caller
                with self._cond:
                    self._rx_error = exc
                    self._cond.notify_all()
                return
            with self._cond:
                self.seconds["exchange_decode"] += time.perf_counter() - t0
                self._inbox.setdefault(seq, {})[src] = (dec, secs)
                self._cond.notify_all()

    # -- exchange ---------------------------------------------------------
    def exchange(self, *, idx: np.ndarray, vals: np.ndarray,
                 mask: Optional[np.ndarray], nv: int,
                 splitter: Optional[np.ndarray] = None,
                 compute_seconds: float = 0.0,
                 control: Optional[dict] = None) -> ExchangeResult:
        """Broadcast this server's updates (idx ``[U]``, vals ``[U(, Q)]``,
        mask ``[U, Q]`` or None, splitter ``[K+1]``), wait for all peers,
        and return the rank-ordered merged update set (see class docstring).

        ``control`` (rank 0 only) is the session's admission/drain record
        for this barrier; it rides in rank 0's frame header and comes back
        in ``ExchangeResult.control`` on every rank, so all ranks splice
        the same query columns at the same barrier."""
        if control is not None and self.rank != 0:
            raise ValueError("admission control records originate at "
                             "rank 0 only")
        seq = self._seq
        self._seq += 1
        updates = int(mask.sum()) if mask is not None else len(idx)
        t0 = time.perf_counter()
        with torch.profiler.record_function("exchange_encode"):
            frame, header = transport_mod.encode_frame(
                idx, vals, mask, nv, splitter=splitter,
                threshold=self.threshold, compressor=self.compressor,
                mode=self.comm_mode, control=control)
        self._add_seconds("exchange_encode", t0)
        raw_b = header["raw_bytes"]
        wire_b = header["wire_bytes"]
        peers: dict[int, tuple] = {}
        if self.n > 1:
            self.sent_raw_bytes += raw_b
            self.sent_wire_bytes += wire_b
            t0 = time.perf_counter()
            with torch.profiler.record_function("exchange_send"):
                env = _ENVELOPE.pack(seq, compute_seconds, updates) + frame
                for dst in range(self.n):
                    if dst != self.rank:
                        self.transport.send(dst, env, timeout=self.timeout)
            self._add_seconds("exchange_send", t0)
            t0 = time.perf_counter()
            with torch.profiler.record_function("exchange_wait"):
                peers = self._wait_peers(seq)
            self._add_seconds("exchange_wait", t0)
            # lint: allow(GH205): arrival-ordered; folded with commutative integer addition only
            for dec, _secs in peers.values():
                raw_b += dec.header["raw_bytes"]
                wire_b += dec.header["wire_bytes"]

        t0 = time.perf_counter()
        with torch.profiler.record_function("exchange_merge"):
            parts = []
            secs = {}
            for r in range(self.n):
                if r == self.rank:
                    parts.append((idx, vals, mask))
                    secs[r] = compute_seconds
                elif r in peers:
                    dec, peer_secs = peers[r]
                    parts.append((dec.idx, dec.vals, dec.mask))
                    secs[r] = peer_secs
            m_idx = np.concatenate([p[0] for p in parts])
            m_val = np.concatenate([p[1] for p in parts])
            m_msk = (np.concatenate([p[2] for p in parts])
                     if mask is not None else None)

            new_assignment = None
            if self.steal and self.assignment is not None:
                moved = rebalance_assignment(
                    self.assignment, self.edges_per_tile,
                    [secs[r] for r in range(self.n)],
                    straggler_factor=self.straggler_factor)
                if moved is not None:
                    self.assignment, nmoves = moved
                    self.steal_moves += nmoves
                    new_assignment = [list(a) for a in self.assignment]
        self._add_seconds("exchange_merge", t0)
        out_control = control
        if self.rank != 0 and 0 in peers:
            out_control = peers[0][0].header.get("control")
        return ExchangeResult(idx=m_idx, vals=m_val, mask=m_msk,
                              raw_bytes=raw_b, wire_bytes=wire_b,
                              assignment=new_assignment, peer_seconds=secs,
                              control=out_control)

    def _wait_peers(self, seq: int) -> dict:
        deadline = time.monotonic() + self.timeout
        with self._cond:
            while True:
                if self._rx_error is not None:
                    raise RuntimeError(
                        f"server {self.rank}: receiver thread failed"
                    ) from self._rx_error
                got = self._inbox.get(seq, {})
                if len(got) == self.n - 1:
                    return self._inbox.pop(seq)
                if not self._cond.wait(timeout=0.1):
                    if time.monotonic() > deadline:
                        missing = [r for r in range(self.n)
                                   if r != self.rank and r not in got]
                        raise TimeoutError(
                            f"server {self.rank} superstep seq {seq}: no "
                            f"frame from peers {missing} within "
                            f"{self.timeout}s")

    def close(self) -> None:
        """Stop the receiver thread (the transport is closed by its owner)."""
        self._stop.set()
        if self._rx is not None:
            self._rx.join(timeout=2.0)
