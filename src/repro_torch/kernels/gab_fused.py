"""Fused gather→combine→apply→mask tile step — the wrapper of
``csrc/gab_fused.cu`` and the :class:`FusedSpec` that drives it.

Counterpart of ``repro/kernels/gab_fused.py:gab_fused``.  The message
``src · a + b + add_const`` is formed inside the kernel, reduced per row
over the dst-sorted edges, and the vertex update and its updated mask are
applied in the epilogue, so the ``[E, Q]`` contributions and the
accumulator never reach device memory.  ``src_vals`` stays pre-gathered by
the caller, as in the reference.

The wrapper takes CUDA tensors only (``ops`` sends CPU tensors to
``ref.gab_fused_ref``), checks what the kernel accepts, allocates the
outputs and the hub launch's scratch (``blocks.hub_scratch``), launches
at the given block sizes on the current stream and counts the launch in
``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import blocks as _blocks

#: kernel launches since the counter was last set to 0
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Static description of a vertex program's gather/apply for fusion.

    Gather (per edge ``e``, query ``q``):
        ``contrib[q, e] = src[q, e] (· a[e]) (+ edge_val[e]) (+ add_const)``
    where ``a[e] = src_aux[scale_aux][e] · edge_val[e]`` is computed by the
    caller.  Covers every shipped app: PageRank/PPR scale by the shared
    1/out-degree factor, SSSP/landmarks add the edge weight, BFS adds 1.

    Apply (per row ``r``, query ``q``), on the block-resident accumulator:
        ``affine``: ``new = alpha · base + beta · accum`` (``base`` is the
        ``base_aux`` dst rows, or the implicit 1.0 — damped PageRank/PPR)
        ``min``/``max``: ``new = min/max(old, accum)`` (relaxation merge)

    The updated mask follows ``VertexProgram.updated_mask``: exact ``!=``
    when ``update_tol == 0`` else ``|new - old| > update_tol``.
    """

    combine: str                      # "sum" | "min" | "max"
    scale_aux: str | None = None      # src-aux name; a = aux[src] * edge_val
    add_edge: bool = False            # contrib += edge_val
    add_const: float | None = None    # contrib += const (BFS hop increment)
    apply: str = "min"                # "affine" | "min" | "max"
    alpha: float = 0.0                # affine: new = alpha*base + beta*accum
    beta: float = 1.0
    base_aux: str | None = None       # dst-aux name for base; None -> 1.0
    update_tol: float = 0.0


_COMBINE = {"sum": 0, "min": 1, "max": 2}
_APPLY = {"affine": 0, "min": 1, "max": 2}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "gab_fused_f32": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _L, _I, _I, _I, _F, _F,
         _F, _F, _I, _I, _P, _L, _P, _L, _P], ctypes.c_int),
    "gab_fused_hub_scratch": ([_L, _I, _I, ctypes.POINTER(_L)], None),
}


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"gab_fused: {name} must be {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"gab_fused: {name} must be contiguous")


def gab_fused(spec: FusedSpec, src_vals: torch.Tensor, a, b,
              dst_local: torch.Tensor, old: torch.Tensor, base,
              num_rows: int, row_cap: int, blocks=None):
    """One fused Gather+Apply tile step on the card.

    Shapes: src_vals ``[E(, Q)]`` float32; a, b ``[E]`` float32 exactly when
    the spec uses them (else None); dst_local ``[E]`` int32, ascending
    (padding edges point at or past ``num_rows``); old and base ``[R(, Q)]``
    with R = row_cap (base only with ``spec.base_aux``).

    ``blocks`` is ``(block_e, block_r)`` (``blocks.BLOCK_E`` x
    ``blocks.BLOCK_R``; None: the default); every legal pair gives the
    same bits.

    Returns ``(new [R(, Q)] float32, updated [R(, Q)] bool)``: rows at or
    beyond ``num_rows`` keep ``old`` and are not updated."""
    global LAUNCHES
    block_e, block_r = _blocks.check_blocks(blocks)
    if spec.combine not in _COMBINE or spec.apply not in _APPLY:
        raise ValueError(f"unsupported spec: {spec}")
    device = src_vals.device
    if device.type != "cuda":
        raise ValueError(f"gab_fused kernel needs CUDA tensors, got {device}")
    if src_vals.ndim not in (1, 2):
        raise ValueError(f"src_vals must be [E] or [E, Q], got "
                         f"{tuple(src_vals.shape)}")
    e = src_vals.shape[0]
    tail = tuple(src_vals.shape[1:])
    q = tail[0] if tail else 1
    f32 = torch.float32
    _check("src_vals", src_vals, (e,) + tail, f32, device)
    _check("dst_local", dst_local, (e,), torch.int32, device)
    _check("old", old, (row_cap,) + tail, f32, device)
    if (a is not None) != bool(spec.scale_aux):
        raise ValueError("gab_fused: pass a exactly when spec.scale_aux")
    if (b is not None) != spec.add_edge:
        raise ValueError("gab_fused: pass b exactly when spec.add_edge")
    if (base is not None) != bool(spec.base_aux):
        raise ValueError("gab_fused: pass base exactly when spec.base_aux")
    for name, t in (("a", a), ("b", b)):
        if t is not None:
            _check(name, t, (e,), f32, device)
    if base is not None:
        _check("base", base, (row_cap,) + tail, f32, device)

    new = torch.empty_like(old)
    upd = torch.empty(old.shape, dtype=torch.bool, device=device)
    if row_cap == 0 or q == 0:
        return new, upd
    lib = _build.load("gab_fused", _SIGNATURES)
    nbytes, ncounters = _blocks.scratch_size(lib.gab_fused_hub_scratch, e, q,
                                             block_e)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        part, cnt = _blocks.hub_scratch("gab_fused", device, nbytes,
                                        ncounters)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gab_fused_f32(
            src_vals.data_ptr(), ptr(a), ptr(b), dst_local.data_ptr(),
            old.data_ptr(), ptr(base), new.data_ptr(), upd.data_ptr(),
            e, row_cap, q, int(num_rows), _COMBINE[spec.combine],
            _APPLY[spec.apply], int(spec.add_const is not None),
            float(spec.add_const or 0.0), float(spec.alpha),
            float(spec.beta), float(spec.update_tol), block_e, block_r,
            ptr(part), nbytes, ptr(cnt), ncounters, stream)
    _build.check(lib, err, "gab_fused_f32")
    LAUNCHES += 1
    return new, upd
