"""Superstep-boundary graph checkpoints (DESIGN.md §12) — the port's copy
of ``repro/core/checkpoint.py``, on-disk compatible with it.

Builds on ``train.checkpoint.CheckpointManager`` (staged tmp-dir write,
atomic rename publish, ``LATEST`` pointer, keep-last-k GC) and adds what
the graph engine needs:

  * a **manifest** riding in ``meta.json`` — the superstep to resume at,
    live query columns, retirement/convergence state, and the per-server
    tile assignment (replicated, so any rank can restart from it and an
    N→M resize is just ``elastic.remap_assignment`` over it); serving
    sessions (DESIGN.md §13) extend it with per-slot query lineage —
    ``queries`` ({global qid: seed vertex} for every column ever
    admitted), ``admitted_at`` (per-column admission superstep) and
    ``next_qid`` — so a resumed session keeps renumbering and per-query
    accounting exactly where the saved one stopped;
  * **interval-block payloads** for ooc vertex state: each
    ``VertexStateStore`` block is serialized via its coldest
    already-current representation (``vstate.export_block`` — no
    recompression of clean spilled blocks) into ``blocks/``, and blocks
    unchanged since the previous checkpoint (version-tracked) are
    **hardlinked** from it instead of rewritten — the incremental flush
    the dirty-writeback invariant makes possible;
  * **collision-safe publish** for multi-rank writers: vertex state is
    fully replicated (All-in-All), so checkpoints at the same superstep
    are byte-identical on every rank; staging dirs are pid-suffixed and
    whichever rank publishes first wins, the rest discard.

Crash anywhere — including mid-write, torn by ``runtime.faults`` — and a
reader sees either the previous complete checkpoint or the new one,
never a mix.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

import numpy as np

from repro_torch.graphio import formats
from repro_torch.train.checkpoint import CheckpointManager

#: manifest schema marker (DESIGN.md §12)
MANIFEST_KIND = "graphh-superstep"


@dataclasses.dataclass
class GraphCheckpoint:
    """One loaded checkpoint: ``manifest`` (see DESIGN.md §12 for the
    schema), ``state`` (the saved leaf arrays, nested dict), and
    ``vstate`` (ooc interval arrays reassembled to full ``[V(,Q)]``
    ndarrays keyed by name; empty for in-memory saves)."""

    step: int
    manifest: dict
    state: dict
    vstate: dict

    def live_queries(self) -> dict[int, int]:
        """{global qid: seed vertex} for the query columns still live at
        this checkpoint — what a resumed serving session (DESIGN.md §13)
        re-registers before admitting new work.  Pre-session checkpoints
        carry no lineage; they resume with an empty map."""
        seeds = {int(g): int(s)
                 for g, s in self.manifest.get("queries", {}).items()}
        return {int(g): seeds.get(int(g), -1)
                for g in self.manifest.get("active_q", [])}


class GraphCheckpointer(CheckpointManager):
    """Checkpoint writer/reader for the superstep engine (module docstring).

    One instance per (engine, program) — ``directory`` is per-program in
    multi-program cluster launches.  Rank 0 writes the periodic
    checkpoints; preempted ranks may also save, and the pid-suffixed
    staging + first-publish-wins rename keeps concurrent writers safe."""

    def __init__(self, directory: str, keep: int = 2, fault=None):
        super().__init__(directory, keep=max(keep, 2), compress=False,
                         fault=fault)
        # (name, k) -> vstate block version at the last save, plus where
        # that save lives and its block metadata — the hardlink source
        self._versions: dict = {}
        self._last_dir: Optional[str] = None
        self._last_blocks: dict = {}

    # -- multi-writer safety -------------------------------------------------
    def _tmp_dir(self, step: int) -> str:
        """Pid-suffixed staging dir: two ranks saving the same superstep
        (preemption races) stage independently and race only on the
        atomic rename below."""
        return self._step_dir(step) + f".tmp.{os.getpid()}"

    def _publish(self, step: int, tmp: str) -> str:
        """First-publish-wins: replicated state makes same-step checkpoints
        byte-identical across ranks, so a loser just discards its copy."""
        final = self._step_dir(step)
        if os.path.isdir(final):
            shutil.rmtree(tmp, ignore_errors=True)
            return final
        try:
            os.replace(tmp, final)
        except OSError:
            # lost the rename race to a peer rank — its copy is identical
            shutil.rmtree(tmp, ignore_errors=True)
        return final

    # -- save ----------------------------------------------------------------
    def save_graph(self, superstep: int, state: dict, manifest: dict,
                   vstore=None) -> str:
        """Write one superstep-boundary checkpoint.

        ``state``: leaf arrays (values/aux/updated_ids/...), saved via the
        parent's staged-leaf path.  ``manifest``: the resume metadata dict
        (stored under meta.json ``extra``).  ``vstore``: when the engine
        runs ooc, its ``VertexStateStore`` — every interval block is
        flushed through its coldest current representation, unchanged
        blocks hardlink to the previous checkpoint's copy."""
        manifest = dict(manifest, kind=MANIFEST_KIND)
        tmp, meta = self._stage(superstep, state, extra_meta=manifest)
        new_versions: dict = {}
        if vstore is not None:
            bdir = os.path.join(tmp, "blocks")
            os.makedirs(bdir, exist_ok=True)
            arrays_meta: dict = {}
            for name in vstore.names():
                dt, tail = vstore.spec(name)
                entries = []
                for k in range(vstore.num_intervals):
                    ver = vstore.block_version(name, k)
                    fn = f"{name}.{k}.blk"
                    entry = self._stage_block(vstore, name, k, ver,
                                              os.path.join(bdir, fn),
                                              superstep)
                    entry["file"] = fn
                    entries.append(entry)
                    new_versions[(name, k)] = ver
                arrays_meta[name] = dict(dtype=np.dtype(dt).str,
                                         tail=list(tail), blocks=entries)
            manifest["vstate"] = dict(
                splitter=[int(x) for x in vstore.splitter],
                arrays=arrays_meta)
            meta["extra"] = manifest
        final = self._finalize(superstep, tmp, meta)
        if vstore is not None:
            self._versions = new_versions
            self._last_dir = final
            self._last_blocks = manifest["vstate"]["arrays"]
        return final

    def _stage_block(self, vstore, name: str, k: int, ver: int,
                     dest: str, superstep: int) -> dict:
        """Stage one interval block file; hardlink the previous save's copy
        when the block version is unchanged (fallback: copy, then
        re-export).  Returns its manifest entry ({"mode": int})."""
        prev_ver = self._versions.get((name, k))
        if (prev_ver == ver and self._last_dir is not None):
            src = os.path.join(self._last_dir, "blocks", f"{name}.{k}.blk")
            prev_entry = next(
                (e for e in self._last_blocks.get(name, {}).get("blocks", [])
                 if e.get("file") == f"{name}.{k}.blk"), None)
            if prev_entry is not None and os.path.exists(src):
                try:
                    os.link(src, dest)
                    return {"mode": prev_entry["mode"]}
                except OSError:
                    try:
                        shutil.copy2(src, dest)
                        return {"mode": prev_entry["mode"]}
                    except OSError:
                        pass        # source vanished mid-copy: re-export
        mode, blob = vstore.export_block(name, k)
        if self.fault is not None:
            self.fault.write(dest, blob, "ckpt.block", superstep)
        else:
            with open(dest, "wb") as f:
                f.write(blob)
        return {"mode": int(mode)}

    # -- load ----------------------------------------------------------------
    def peek_manifest(self) -> Optional[tuple[int, dict]]:
        """(step, manifest) of the latest checkpoint without loading any
        array — what engine construction reads to adopt the saved tile
        assignment (cheap JSON).  None when no checkpoint exists."""
        step = self.latest_step()
        if step is None:
            return None
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            meta = json.load(f)
        return step, meta.get("extra", {})

    def load_graph(self, step: Optional[int] = None
                   ) -> Optional[GraphCheckpoint]:
        """Load the latest (or a specific) checkpoint: manifest + leaf
        state + ooc interval arrays reassembled into full ndarrays.
        Returns None when the directory holds no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        manifest = meta.get("extra", {})
        _, state = self.restore(step)
        vstate: dict = {}
        vs = manifest.get("vstate")
        if vs:
            splitter = np.asarray(vs["splitter"], dtype=np.int64)
            for name, info in vs["arrays"].items():
                dt = np.dtype(info["dtype"])
                tail = tuple(info["tail"])
                parts = []
                for k, entry in enumerate(info["blocks"]):
                    lo, hi = int(splitter[k]), int(splitter[k + 1])
                    with open(os.path.join(d, "blocks", entry["file"]),
                              "rb") as f:
                        raw = formats.decompress_blob(f.read(),
                                                      int(entry["mode"]))
                    parts.append(np.frombuffer(raw, dtype=dt).reshape(
                        (hi - lo,) + tail))
                vstate[name] = np.concatenate(parts)
        return GraphCheckpoint(step=step, manifest=manifest, state=state,
                               vstate=vstate)
