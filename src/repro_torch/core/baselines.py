"""Baseline engines the paper compares against (§II, Table III, Fig. 1/10/11),
on PyTorch.

Mechanism-level reimplementations — each engine moves the same data the
real system moves (per Table III), with real compute and real file I/O
for the out-of-core ones:

  PregelStyle  (Pregel+)   : hash edge-cut, in-memory out-edges, sender-side
                             message combining, messages over "network"
  GASStyle     (PowerGraph): random vertex-cut, mirrors/master, partial
                             gathers + 2M|V| value exchanges
  GraphDStyle  (GraphD)    : Pregel semantics, edges streamed from disk every
                             superstep, messages spilled to disk at sender
  ChaosStyle   (Chaos)     : edge-centric streaming partitions; edges and
                             messages streamed via disk each superstep

All reuse the GAB VertexProgram hooks (message = gather(src_value,
edge_val), monoid combine, apply) on torch tensors on ``device`` (default
``"cuda"``; ``"cpu"`` for the tests), so PageRank/SSSP run unmodified on
every engine.  The values are float64 and the combine accumulates in
float64, as the reference's numpy does; edge and message files are
written and read on the host, and their bytes, the network's and the
partitions are the reference's (``repro/core/baselines.py``) exactly.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.gab import VertexProgram, state_from_numpy

Tensor = torch.Tensor


@dataclasses.dataclass
class BaselineStats:
    """Per-superstep accounting of one baseline engine (bytes are modelled
    network/disk traffic, not measured wire bytes)."""
    superstep: int
    seconds: float
    network_bytes: int
    disk_read_bytes: int
    disk_write_bytes: int
    updated_vertices: int


@dataclasses.dataclass
class BaselineResult:
    """Final values (host) + per-superstep history of one baseline run."""
    name: str
    values: np.ndarray
    history: list[BaselineStats]

    def mean_superstep_seconds(self, skip_first: bool = True) -> float:
        """Steady-state mean seconds per superstep (warm-up dropped unless
        that would leave nothing to average)."""
        hs = self.history[1:] if skip_first else self.history
        hs = hs or self.history
        return float(np.mean([h.seconds for h in hs])) if hs else 0.0


def _combine(combine: str):
    """``(vals [n], idx [n], rows) -> [rows]`` float64: the monoid over
    the values of each index (sum or min, as the reference)."""
    if combine == "sum":
        def seg_sum(vals, idx, n):
            out = torch.zeros(n, dtype=torch.float64, device=vals.device)
            return out.index_add_(0, idx, vals.to(torch.float64))
        return seg_sum
    if combine == "min":
        def seg_min(vals, idx, n):
            out = torch.full((n,), float("inf"), dtype=torch.float64,
                             device=vals.device)
            return out.scatter_reduce_(0, idx, vals.to(torch.float64),
                                       "amin")
        return seg_min
    raise ValueError(combine)


def _merge(combine: str, accum: Tensor, idx: Tensor, vals: Tensor) -> None:
    """accum[idx] ⊕= vals in place (``np.add.at`` / ``np.minimum.at``)."""
    if combine == "sum":
        accum.index_add_(0, idx, vals.to(torch.float64))
    else:
        accum.scatter_reduce_(0, idx, vals.to(torch.float64), "amin")


def _gather(prog: VertexProgram, values, edge_src, edge_val, aux) -> Tensor:
    src_vals = values[edge_src]
    src_aux = {k: aux[k][edge_src] for k in prog.src_aux}
    return prog.gather(src_vals, edge_val, src_aux)


def _apply(prog: VertexProgram, values, accum, aux) -> Tensor:
    # Apply everywhere: min-monoid apps are unchanged by the identity
    # accumulator, sum-monoid apps (PageRank) recompute every vertex —
    # identical semantics to the GAB engine.
    return prog.apply(values, accum, {k: aux[k] for k in prog.dst_aux})


def _host(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _Base:
    name = "base"

    def __init__(self, src, dst, val, num_vertices, num_servers=4,
                 msg_bytes=12, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but PyTorch "
                               "sees no CUDA device")
        self.src_np = np.asarray(src, dtype=np.int64)
        self.dst_np = np.asarray(dst, dtype=np.int64)
        self.val_np = (np.ones(len(self.src_np), np.float32) if val is None
                       else np.asarray(val, np.float32))
        self.src = self._dev(self.src_np)
        self.dst = self._dev(self.dst_np)
        self.val = self._dev(self.val_np)
        self.nv = num_vertices
        self.ns = num_servers
        self.msg_bytes = msg_bytes
        self.out_deg = np.bincount(self.src_np, minlength=num_vertices).astype(
            np.float64)
        self.in_deg = np.bincount(self.dst_np, minlength=num_vertices).astype(
            np.float64)

    def _dev(self, arr: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def run(self, prog: VertexProgram, max_supersteps=30) -> BaselineResult:
        """Run ``prog`` to no updated vertex or ``max_supersteps``."""
        state = state_from_numpy(
            prog.init(self.nv, self.out_deg, self.in_deg), self.device)
        values = state.pop("value").to(torch.float64)
        aux = state
        combine = _combine(prog.combine)
        history = []
        for ss in range(max_supersteps):
            t0 = time.perf_counter()
            new_values, net, dr, dw = self.superstep(prog, values, aux,
                                                     combine)
            if prog.update_tol > 0:
                upd = (new_values - values).abs() > prog.update_tol
            else:
                upd = new_values != values
            values = new_values
            n_upd = int(upd.sum())      # waits for the superstep's work
            history.append(BaselineStats(
                superstep=ss, seconds=time.perf_counter() - t0,
                network_bytes=net, disk_read_bytes=dr, disk_write_bytes=dw,
                updated_vertices=n_upd,
            ))
            if n_upd == 0:
                break
        return BaselineResult(self.name, _host(values), history)

    def superstep(self, prog, values, aux, combine):
        raise NotImplementedError

    def _accum(self, prog) -> Tensor:
        return torch.full((self.nv,), prog.identity,
                          dtype=torch.float64, device=self.device)


class PregelStyle(_Base):
    """Pregel+ mechanism: hash edge-cut; per-sender message combining."""

    name = "pregel+"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        owner = self.src % self.ns            # edge lives with its source
        self.by_server = [torch.nonzero(owner == s).flatten()
                          for s in range(self.ns)]

    def superstep(self, prog, values, aux, combine):
        """One superstep: per-server gather with sender-side combining;
        network bytes = combined messages crossing server boundaries."""
        net = 0
        accum = self._accum(prog)
        for s in range(self.ns):
            es = self.by_server[s]
            contrib = _gather(prog, values, self.src[es], self.val[es], aux)
            # sender-side combining per (dst) within this server
            dsts, inv = torch.unique(self.dst[es], return_inverse=True)
            combined = combine(contrib, inv, len(dsts))
            # network: combined messages whose target lives elsewhere
            remote = (dsts % self.ns) != s
            net += int(remote.sum()) * self.msg_bytes
            _merge(prog.combine, accum, dsts, combined)
        return _apply(prog, values, accum, aux), net, 0, 0


class GASStyle(_Base):
    """PowerGraph mechanism: random vertex-cut, mirror/master exchanges."""

    name = "powergraph"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        rng = np.random.default_rng(0)
        edge_server = self._dev(rng.integers(0, self.ns, len(self.src_np)))
        self.by_server = [torch.nonzero(edge_server == s).flatten()
                          for s in range(self.ns)]
        # replica sets: vertices present on a server (as src or dst)
        self.replica_counts = []
        for s in range(self.ns):
            es = self.by_server[s]
            vs = torch.unique(torch.cat([self.src[es], self.dst[es]]))
            self.replica_counts.append(int(vs.numel()))
        self.M = sum(self.replica_counts) / max(self.nv, 1)

    def superstep(self, prog, values, aux, combine):
        """One superstep: per-server partial aggregation (GAS
        mirror-style); network bytes = per-(server, dst) partials shipped
        to masters."""
        net = 0
        accum = self._accum(prog)
        for s in range(self.ns):
            es = self.by_server[s]
            contrib = _gather(prog, values, self.src[es], self.val[es], aux)
            dsts, inv = torch.unique(self.dst[es], return_inverse=True)
            partial = combine(contrib, inv, len(dsts))
            # mirrors send partial accumulators to masters
            net += len(dsts) * self.msg_bytes
            _merge(prog.combine, accum, dsts, partial)
        new_values = _apply(prog, values, accum, aux)
        # masters push new values back to every mirror
        net += sum(self.replica_counts) * self.msg_bytes
        return new_values, net, 0, 0


class GraphDStyle(PregelStyle):
    """GraphD mechanism: Pregel + edges re-streamed from disk every
    superstep and sender-side messages spilled to disk (Table III: read
    2|E|, write |E|)."""

    name = "graphd"

    def __init__(self, *a, workdir: Optional[str] = None, **kw):
        super().__init__(*a, **kw)
        self.dir = workdir or tempfile.mkdtemp(prefix="graphd_")
        self.edge_files = []
        for s in range(self.ns):
            es = _host(self.by_server[s])
            p = os.path.join(self.dir, f"edges{s}.bin")
            np.concatenate([
                self.src_np[es].astype("<i8"), self.dst_np[es].astype("<i8"),
            ]).tofile(p)
            with open(os.path.join(self.dir, f"vals{s}.bin"), "wb") as f:
                f.write(self.val_np[es].astype("<f4").tobytes())
            self.edge_files.append(p)

    def superstep(self, prog, values, aux, combine):
        """One superstep: edges streamed from disk each pass (no edge
        cache) — disk_read_bytes models the per-superstep re-read the paper
        criticizes."""
        net = dr = dw = 0
        accum = self._accum(prog)
        for s in range(self.ns):
            # stream edges from disk (no cache — the paper's complaint)
            raw = np.fromfile(self.edge_files[s], dtype="<i8")
            n = len(raw) // 2
            e_val = np.fromfile(os.path.join(self.dir, f"vals{s}.bin"),
                                dtype="<f4")
            dr += raw.nbytes + e_val.nbytes
            contrib = _gather(prog, values, self._dev(raw[:n]),
                              self._dev(e_val), aux)
            # spill raw (uncombined) messages to disk at sender side
            spill = os.path.join(self.dir, f"msgs{s}.bin")
            buf = np.rec.fromarrays([raw[n:], _host(contrib).astype("<f8")],
                                    names="dst,val")
            with open(spill, "wb") as f:
                f.write(buf.tobytes())
            dw += buf.nbytes
            back = np.fromfile(spill, dtype=buf.dtype)
            dr += back.nbytes
            dsts, inv = torch.unique(self._dev(back["dst"]),
                                     return_inverse=True)
            combined = combine(self._dev(back["val"]), inv, len(dsts))
            remote = (dsts % self.ns) != s
            net += int(remote.sum()) * self.msg_bytes
            _merge(prog.combine, accum, dsts, combined)
        return _apply(prog, values, accum, aux), net, dr, dw


class ChaosStyle(_Base):
    """Chaos mechanism: streaming partitions spread over the cluster;
    every superstep streams edges and messages through (networked)
    storage (Table III: network O(3|E|+3|V|))."""

    name = "chaos"

    def __init__(self, *a, num_partitions: Optional[int] = None,
                 workdir: Optional[str] = None, **kw):
        super().__init__(*a, **kw)
        self.np_ = num_partitions or self.ns * 4
        self.dir = workdir or tempfile.mkdtemp(prefix="chaos_")
        part = self.src_np % self.np_        # streaming partition by source
        for p in range(self.np_):
            es = np.nonzero(part == p)[0]
            np.concatenate([self.src_np[es], self.dst_np[es]]).astype(
                "<i8").tofile(os.path.join(self.dir, f"p{p}_edges.bin"))
            self.val_np[es].astype("<f4").tofile(
                os.path.join(self.dir, f"p{p}_vals.bin"))

    def superstep(self, prog, values, aux, combine):
        """One superstep: scatter messages spilled to disk partitions, then
        a gather pass re-reads them (Chaos-style 2-phase out-of-core)."""
        net = dr = dw = 0
        # scatter phase: stream edges, write messages into target partitions
        msg_bufs = [[] for _ in range(self.np_)]
        for p in range(self.np_):
            raw = np.fromfile(os.path.join(self.dir, f"p{p}_edges.bin"),
                              dtype="<i8")
            n = len(raw) // 2
            e_val = np.fromfile(os.path.join(self.dir, f"p{p}_vals.bin"),
                                dtype="<f4")
            dr += raw.nbytes + e_val.nbytes
            net += raw.nbytes + e_val.nbytes      # partitions are remote
            e_dst = self._dev(raw[n:])
            contrib = _gather(prog, values, self._dev(raw[:n]),
                              self._dev(e_val), aux)
            tgt_part = e_dst % self.np_
            for q in range(self.np_):
                m = tgt_part == q
                if bool(m.any()):
                    msg_bufs[q].append((e_dst[m], contrib[m]))
        accum = self._accum(prog)
        for q in range(self.np_):
            if not msg_bufs[q]:
                continue
            d = _host(torch.cat([x[0] for x in msg_bufs[q]]))
            v = _host(torch.cat([x[1] for x in msg_bufs[q]]))
            path = os.path.join(self.dir, f"p{q}_msgs.bin")
            rec = np.rec.fromarrays([d, v.astype("<f8")], names="dst,val")
            with open(path, "wb") as f:
                f.write(rec.tobytes())
            dw += rec.nbytes
            net += rec.nbytes
            back = np.fromfile(path, dtype=rec.dtype)
            dr += back.nbytes
            _merge(prog.combine, accum, self._dev(back["dst"]),
                   self._dev(back["val"]))
        new_values = _apply(prog, values, accum, aux)
        net += self.nv * self.msg_bytes * 3 // 2   # vertex state movement
        return new_values, net, dr, dw


ENGINES = {
    "pregel+": PregelStyle,
    "powergraph": GASStyle,
    "graphd": GraphDStyle,
    "chaos": ChaosStyle,
}
