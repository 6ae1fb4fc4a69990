"""Fault-tolerant, device-independent checkpointing — the port's jax-free
copy of ``repro/train/checkpoint.py``.

Design (DESIGN.md §5), byte-compatible with the reference so each package
reads the other's checkpoints:
  * every leaf of a nested dict of arrays is written as a full logical
    array, one ``np.save`` file ``<flat-path>.npy`` (or the raw bytes,
    zstd-compressed, as ``<flat-path>.npy.zst``), with its shape and dtype
    in ``meta.json`` under ``leaves`` and the caller's metadata under
    ``extra``; an empty dict is kept as an ``__empty_dict__`` marker leaf;
  * writes go to ``<dir>/step_<n>.tmp`` and are atomically renamed —
    a reader can never observe a torn checkpoint (crash-safe);
  * ``LATEST`` is a one-line pointer file, also atomically replaced;
  * keep-last-k garbage collection.

Leaves may be numpy arrays or torch tensors (copied to the host; never
``torch.save``, whose pickles the reference cannot read).  ``restore``
returns numpy leaves, or tensors on a device when asked.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.compat import zstd_compress, zstd_decompress


_EMPTY = "__empty_dict__"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        if not tree:
            # keep empty-dict nodes: the restored structure must match
            out[prefix + _EMPTY] = np.zeros((0,), np.int8)
            return out
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split(".")
        if parts[-1] == _EMPTY:
            d = root
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            continue
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a torch tensor is copied off its
    device)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_spec(leaf) -> tuple[list, str]:
    """(shape, numpy dtype name) of a numpy or torch leaf, as meta.json
    records them."""
    if isinstance(leaf, torch.Tensor):
        dt = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return list(leaf.shape), str(dt)
    arr = np.asarray(leaf)
    return list(arr.shape), str(arr.dtype)


class CheckpointManager:
    """Atomic keep-last-k checkpoints (see module docstring).

    ``fault`` optionally arms a ``runtime.faults.FaultInjector`` at the
    named crash points inside the save path (``ckpt.mid_write`` between
    leaves, ``ckpt.leaf`` on each leaf's bytes, ``ckpt.pre_rename``
    before the publish rename, ``ckpt.latest`` on the LATEST tmp write,
    ``ckpt.pre_latest`` before the LATEST replace) — the crash-atomicity
    tests drive every one of them and assert a reader never observes a
    torn checkpoint."""

    def __init__(self, directory: str, keep: int = 3, compress: bool = False,
                 fault=None):
        self.dir = directory
        self.keep = keep
        self.compress = compress
        self.fault = fault
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def _check(self, site: str, step: int) -> None:
        if self.fault is not None:
            self.fault.check(site, step)

    def _write_bytes(self, path: str, data: bytes, site: str,
                     step: int) -> None:
        """One file write, routed through the fault injector so a spec can
        tear it (persist a prefix, then die) at a named point."""
        if self.fault is not None:
            self.fault.write(path, data, site, step)
        else:
            with open(path, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _tmp_dir(self, step: int) -> str:
        """Staging dir name.  ``.tmp`` never matches the ``step_(\\d+)``
        reader regex, so a crash mid-stage leaves garbage, never a
        half-readable checkpoint."""
        return self._step_dir(step) + ".tmp"

    def _stage(self, step: int, state, extra_meta: Optional[dict]
               ) -> tuple[str, dict]:
        """Write every leaf into a fresh staging dir; returns (tmp, meta).
        Nothing is visible to readers until :meth:`_finalize` renames."""
        flat = _flatten(state)
        tmp = self._tmp_dir(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta = {"step": step, "leaves": {}, "extra": extra_meta or {}}
        for path, leaf in flat.items():
            self._check("ckpt.mid_write", step)
            arr = _to_numpy(leaf)
            meta["leaves"][path] = {"shape": list(arr.shape),
                                    "dtype": str(arr.dtype)}
            fn = os.path.join(tmp, path.replace("/", "_") + ".npy")
            if self.compress:
                blob = zstd_compress(arr.tobytes(order="C"), level=3)
                self._write_bytes(fn + ".zst", blob, "ckpt.leaf", step)
            else:
                bio = io.BytesIO()
                np.save(bio, arr)
                self._write_bytes(fn, bio.getvalue(), "ckpt.leaf", step)
        return tmp, meta

    def _finalize(self, step: int, tmp: str, meta: dict) -> str:
        """Write meta.json, atomically publish the staged dir, repoint
        LATEST, garbage-collect old checkpoints."""
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        self._check("ckpt.pre_rename", step)
        final = self._publish(step, tmp)
        self._write_latest(step)
        self._gc()
        return final

    def _publish(self, step: int, tmp: str) -> str:
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                       # atomic publish
        return final

    def save(self, step: int, state, extra_meta: Optional[dict] = None) -> str:
        """Write one checkpoint: stage every leaf, then atomically publish
        (tmp-dir rename) and repoint LATEST.  Crash-safe at every point —
        a reader sees either the previous checkpoint or this one, whole."""
        tmp, meta = self._stage(step, state, extra_meta)
        return self._finalize(step, tmp, meta)

    def _write_latest(self, step: int) -> None:
        # pid-suffixed tmp: concurrent writers (multi-rank graph saves)
        # must not truncate each other's staging file mid-replace
        tmp = os.path.join(self.dir, f"LATEST.tmp.{os.getpid()}")
        self._write_bytes(tmp, str(step).encode(), "ckpt.latest", step)
        self._check("ckpt.pre_latest", step)
        os.replace(tmp, os.path.join(self.dir, "LATEST"))

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if os.path.exists(p):
            try:
                with open(p) as f:
                    s = int(f.read().strip())
            except ValueError:
                s = None    # unreadable pointer: fall back to the dir scan
            if s is not None and os.path.isdir(
                    os.path.join(self.dir, f"step_{s:08d}")):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None,
                like=None) -> tuple[int, Any]:
        """Restore (step, state): numpy leaves, or torch tensors on
        ``device`` when one is given.  ``like``: an optional nested dict
        of arrays or tensors; each of its leaves must be in the
        checkpoint with the same shape and dtype, else ValueError."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if like is not None:
            for path, leaf in _flatten(like).items():
                info = meta["leaves"].get(path)
                want = _leaf_spec(leaf)
                if info is None or (info["shape"], info["dtype"]) != want:
                    raise ValueError(
                        f"checkpoint step {step} leaf {path!r}: "
                        f"{info} does not match {want}")
        flat = {}
        for path, info in meta["leaves"].items():
            fn = os.path.join(d, path.replace("/", "_") + ".npy")
            if os.path.exists(fn + ".zst"):
                with open(fn + ".zst", "rb") as f:
                    raw = zstd_decompress(f.read())
                arr = np.frombuffer(raw, dtype=np.dtype(info["dtype"])).reshape(
                    info["shape"]).copy()
            else:
                arr = np.load(fn)
            if path.endswith(_EMPTY) or device is None:
                flat[path] = arr            # the marker is structure, not data
            else:
                flat[path] = torch.from_numpy(arr).to(device)
        return step, _unflatten(flat)
