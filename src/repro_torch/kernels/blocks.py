"""Block sizes of the two GAB kernels and the hub launch's scratch.

Both kernels (``csrc/segment_reduce.cu``, ``csrc/gab_fused.cu``) take
``blocks = (block_e, block_r)`` at run time (``csrc/seg_layout.cuh``):

* ``block_r`` — the rows a row block owns, one thread a row;
* ``block_e`` — the least hub size H: a row holding two multiples of H
  edges goes to the hub launch, and H doubles from ``block_e`` until the
  edge list holds at most 16,384 multiples.

Every legal pair gives the same bits as the default: the order of a row's
sum does not depend on which block owns the row or on which launch
reduces it.  ``roofline/kernel_tune.py`` picks a pair per program family
and tile shape.

The hub launch keeps 32 lane partials a hub multiple and column pass, and
an arrival counter each, in device memory that the wrappers take from
PyTorch's caching allocator (:func:`hub_scratch`), so it never grows
outside it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

#: legal least hub sizes (powers of two) and rows a row block
BLOCK_E = (128, 256, 512, 1024, 2048)
BLOCK_R = (128, 256, 512)
#: the kernels' static default: H from 256 edges, 256 rows a block
DEFAULT_BLOCKS = (256, 256)

_LOCK = threading.Lock()
# (library, device index) -> [partials (uint8), counters (int32, zero),
# streams the buffers were used on]
_POOL: dict[tuple[str, int], list] = {}
# (library function, its arguments) -> (partial bytes, counters)
_SIZES: dict[tuple, tuple[int, int]] = {}


def check_blocks(blocks) -> tuple[int, int]:
    """``(block_e, block_r)`` of ``blocks`` (``None``: the default);
    raises ``ValueError`` naming the legal sets for any other pair."""
    if blocks is None:
        return DEFAULT_BLOCKS
    try:
        be, br = blocks
    except (TypeError, ValueError):
        be = br = None
    if be not in BLOCK_E or br not in BLOCK_R:
        raise ValueError(f"kernel blocks {blocks!r}: block_e must be one of "
                         f"{BLOCK_E} and block_r one of {BLOCK_R}")
    return int(be), int(br)


def scratch_size(fn, *args) -> tuple[int, int]:
    """``(partial bytes, counters)`` a call needs, from a library's
    ``*_hub_scratch(num_edges, q_cols, block_e, ..., out)`` (the kernels'
    own count, so the two never disagree), memoised."""
    key = (fn.__name__,) + args
    size = _SIZES.get(key)
    if size is None:
        out = (ctypes.c_longlong * 2)()
        fn(*args, out)
        size = _SIZES[key] = (int(out[0]), int(out[1]))
    return size


def hub_scratch(library: str, device: torch.device, nbytes: int,
                ncounters: int):
    """The hub launch's scratch of ``library``'s calls on ``device``: at
    least ``nbytes`` of lane partials and ``ncounters`` int32 counters at
    zero, or ``(None, None)`` when a call needs none.  One pair a library
    and device, grown (on the current stream, from PyTorch's allocator)
    when a call needs more and shared by every host thread: a library runs
    the hub launch of every call on its one side stream a device, in
    order, so two calls never use a pair at once, and each call leaves
    the counters at zero.  The current stream is recorded on the buffers,
    so a grown-out pair is not reused before the calls on it (joined into
    their callers' streams) have ended."""
    if nbytes <= 0 or ncounters <= 0:
        return None, None
    idx = (library, device.index if device.index is not None
           else torch.cuda.current_device())
    stream = torch.cuda.current_stream(device)
    with _LOCK:
        entry = _POOL.get(idx)
        if entry is None or entry[0].numel() < nbytes:
            part = torch.empty(nbytes, dtype=torch.uint8, device=device)
            cnt = entry[1] if entry is not None and \
                entry[1].numel() >= ncounters else None
            entry = [part, cnt, set()]
        if entry[1] is None or entry[1].numel() < ncounters:
            entry[1] = torch.zeros(ncounters, dtype=torch.int32,
                                   device=device)
            entry[2] = set()
        if stream.cuda_stream not in entry[2]:
            entry[0].record_stream(stream)
            entry[1].record_stream(stream)
            entry[2].add(stream.cuda_stream)
        _POOL[idx] = entry
        return entry[0], entry[1]
