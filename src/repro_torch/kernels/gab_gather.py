"""CUDA segment sum / min / max — the wrapper of ``csrc/segment_reduce.cu``.

Counterpart of ``repro/kernels/gab_gather.py:segment_reduce_pallas``.  The
TPU kernel builds a one-hot block per (row block, edge block) and
contracts it on the MXU; this one reduces each row's contiguous edge
range of the dst-sorted edge list (see the source for the design).

The wrapper takes CUDA tensors only (``ops`` sends CPU tensors to the
plain version), checks what the kernel accepts, allocates the output and
the hub launch's scratch (``blocks.hub_scratch``), launches at the given
block sizes on the current stream and counts the launch in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import blocks as _blocks

#: kernel launches since the counter was last set to 0
LAUNCHES = 0

_COMBINE = {"sum": 0, "min": 1, "max": 2}
_ENTRY = {torch.float32: "segment_reduce_f32",
          torch.int32: "segment_reduce_i32",
          torch.int64: "segment_reduce_i64"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _P, _P, _L, _L, _I, _I, _I, _I, _P, _L, _P, _L, _P]
_SIGNATURES = {fn: (_ARGS, _I) for fn in _ENTRY.values()}
_SIGNATURES["segment_reduce_hub_scratch"] = (
    [_L, _I, _I, _I, ctypes.POINTER(_L)], None)


def segment_reduce(contrib: torch.Tensor, dst: torch.Tensor,
                   num_segments: int, combine: str = "sum",
                   sorted_ids: bool = True, blocks=None) -> torch.Tensor:
    """Reduce contrib ``[E(, Q)]`` by dst ``[E]`` into ``[R(, Q)]`` rows
    (R = num_segments) on the card; empty rows get the identity (0, the
    type's largest value / +inf, its smallest / -inf).

    ``contrib`` is float32, int32 or int64 (integers reduce exactly in
    int64); ``dst`` is int32 and ascending.  ``sorted_ids=False`` first
    permutes the edges by a stable sort on dst — data movement only, the
    order of each row's sum stays fixed.  ``blocks`` is ``(block_e,
    block_r)`` (``blocks.BLOCK_E`` x ``blocks.BLOCK_R``; None: the
    default); every legal pair gives the same bits."""
    global LAUNCHES
    block_e, block_r = _blocks.check_blocks(blocks)
    if combine not in _COMBINE:
        raise ValueError(f"unknown combine: {combine}")
    if contrib.device.type != "cuda" or dst.device != contrib.device:
        raise ValueError("segment_reduce kernel needs contrib and dst on the "
                         f"same CUDA device, got {contrib.device} and "
                         f"{dst.device}")
    entry = _ENTRY.get(contrib.dtype)
    if entry is None:
        raise TypeError(f"segment_reduce kernel takes float32, int32 or "
                        f"int64 contributions, not {contrib.dtype}")
    if dst.dtype != torch.int32 or dst.ndim != 1:
        raise TypeError(f"dst must be int32 [E], got {dst.dtype} "
                        f"{tuple(dst.shape)}")
    if contrib.ndim not in (1, 2) or contrib.shape[0] != dst.shape[0]:
        raise ValueError(f"contrib {tuple(contrib.shape)} does not match "
                         f"dst {tuple(dst.shape)}")
    if not sorted_ids:
        dst, perm = torch.sort(dst, stable=True)
        contrib = contrib.index_select(0, perm)
    if not (contrib.is_contiguous() and dst.is_contiguous()):
        raise ValueError("segment_reduce kernel needs contiguous inputs")
    e = contrib.shape[0]
    q = 1 if contrib.ndim == 1 else contrib.shape[1]
    out = torch.empty((num_segments,) + tuple(contrib.shape[1:]),
                      dtype=contrib.dtype, device=contrib.device)
    if num_segments == 0 or q == 0:
        return out
    lib = _build.load("segment_reduce", _SIGNATURES)
    nbytes, ncounters = _blocks.scratch_size(
        lib.segment_reduce_hub_scratch, e, q, block_e,
        int(contrib.dtype != torch.float32))
    with torch.cuda.device(contrib.device):
        part, cnt = _blocks.hub_scratch("segment_reduce", contrib.device,
                                        nbytes, ncounters)
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            contrib.data_ptr(), dst.data_ptr(), out.data_ptr(), e,
            num_segments, q, _COMBINE[combine], block_e, block_r,
            None if part is None else part.data_ptr(), nbytes,
            None if cnt is None else cnt.data_ptr(), ncounters, stream)
    _build.check(lib, err, entry)
    LAUNCHES += 1
    return out
