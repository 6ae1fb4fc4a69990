"""CUDA stream compaction — the wrapper of ``csrc/compact.cu``.

Counterpart of ``repro/kernels/compact.py:compact_pallas``: the first K
set indices of a mask, ascending, with their values — the sparse
broadcast's (index, value) list.  The TPU kernel routes indices through
f32 lanes (V < 2^24) and relies on sequential grid steps; this one is a
single pass with a decoupled look-back across tiles, int32 indices and
the fill in the same launch (see the source).

The wrapper takes CUDA tensors only (``ops`` sends CPU tensors to
``ref.compact``), checks what the kernel accepts, allocates the outputs
and the zeroed look-back scratch, launches on the current stream and
counts the launch in ``LAUNCHES``.  A mask view at any byte offset is
taken as it is: the kernel reads its unaligned ends byte by byte.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the counter was last set to 0
LAUNCHES = 0

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "compact_u32": ([_P, _P, _L, _L, _I, _P, _P, _P, _L, _P], ctypes.c_int),
    "compact_scratch_len": ([_L], _L),
}
_INT32_MAX = (1 << 31) - 1


def compact(mask: torch.Tensor, values: torch.Tensor, capacity: int,
            fill_index: int | None = None):
    """First ``capacity`` set indices of mask ``[V]`` (ascending) and their
    values ``[V]``, as ``([K] int32, [K])`` with K = capacity, on the card;
    unused slots hold ``(fill_index, 0)``, ``fill_index`` defaulting to V.

    ``mask`` is bool, ``values`` float32 or int32 (moved as 32-bit words,
    so exact); both contiguous on one CUDA device, V < 2^31."""
    global LAUNCHES
    device = mask.device
    if device.type != "cuda" or values.device != device:
        raise ValueError("compact kernel needs mask and values on the same "
                         f"CUDA device, got {mask.device} and {values.device}")
    if mask.dtype != torch.bool or mask.ndim != 1:
        raise TypeError(f"mask must be bool [V], got {mask.dtype} "
                        f"{tuple(mask.shape)}")
    if values.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"compact kernel takes float32 or int32 values, not "
                        f"{values.dtype}")
    n = mask.shape[0]
    if tuple(values.shape) != (n,):
        raise ValueError(f"values {tuple(values.shape)} does not match mask "
                         f"{tuple(mask.shape)}")
    if not (mask.is_contiguous() and values.is_contiguous()):
        raise ValueError("compact kernel needs contiguous inputs")
    fill = n if fill_index is None else int(fill_index)
    if n > _INT32_MAX or not -_INT32_MAX - 1 <= fill <= _INT32_MAX:
        raise ValueError(f"compact kernel: V = {n} and fill_index = {fill} "
                         f"must fit in int32")
    capacity = int(capacity)
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    out_idx = torch.empty(capacity, dtype=torch.int32, device=device)
    out_val = torch.empty(capacity, dtype=values.dtype, device=device)
    if capacity == 0:
        return out_idx, out_val
    lib = _build.load("compact", _SIGNATURES)
    scratch_len = lib.compact_scratch_len(n)
    # the look-back flags and the tile counter start at 0
    scratch = torch.zeros(scratch_len, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.compact_u32(mask.data_ptr(), values.data_ptr(), n,
                              capacity, fill, out_idx.data_ptr(),
                              out_val.data_ptr(), scratch.data_ptr(),
                              scratch_len, stream)
    _build.check(lib, err, "compact_u32")
    LAUNCHES += 1
    return out_idx, out_val
