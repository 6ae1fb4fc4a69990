"""Optional-dependency shims.

``zstandard`` is the preferred payload codec (fast, good ratios) but is not
part of the Python stdlib and may be absent from minimal containers.  The
stdlib ``zlib`` is the drop-in fallback — fittingly, the codec the GraphH
paper itself used for its edge-cache ladder (§III-D-2: snappy/zlib; see
DESIGN.md §3).  Level semantics map 1:1 (higher = slower, smaller).

Streams are self-describing: ``zstd_decompress`` sniffs the zstd frame magic
vs the zlib header, so a store written with one codec is readable whenever
that codec is importable, regardless of which codec is the current default.
"""
from __future__ import annotations

import zlib

try:  # pragma: no cover - environment-dependent
    import zstandard as _zstd
except ModuleNotFoundError:  # pragma: no cover
    _zstd = None

HAVE_ZSTD = _zstd is not None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def zstd_compress(data: bytes, level: int = 3) -> bytes:
    """Compress with zstd when available, else zlib at the same level."""
    if _zstd is not None:
        return _zstd.ZstdCompressor(level=level).compress(data)
    return zlib.compress(data, min(max(level, 1), 9))


def zstd_decompress(data: bytes) -> bytes:
    """Decompress a blob produced by :func:`zstd_compress` (either codec)."""
    if data[:4] == _ZSTD_MAGIC:
        if _zstd is None:
            raise RuntimeError(
                "blob is zstd-compressed but the 'zstandard' module is not "
                "installed (pip install zstandard, or rebuild the store)"
            )
        return _zstd.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)
