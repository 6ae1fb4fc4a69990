#!/usr/bin/env python3
"""ROADMAP C.1 and B.5 on one card: an earlier tree's segment kernel
against this checkout's.

    mkdir -p build/parent
    git archive <parent commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 chip_probe_c1.py build/parent/src/repro_torch/kernels/csrc

1. Builds the segment and fused libraries of both sources with
   ``kernels/_build.NVCC_FLAGS``, and the earlier segment library again
   with ptxas at -O0.
2. C.1's skewed list (``chip_smoke.skewed_int32_list``): int32 min and
   max at the default blocks through each segment library, each in a
   process of its own (a fault ends its CUDA context): equal to the plain
   version, or the CUDA error.
3. A tile-like list: R-MAT (Graph500 a, b, c) with 2^22 vertices and
   2^24 edges, the edges whose source is below 2^20, dst renumbered
   densely and sorted.  int32 sum, min and max, float32 sum (Q = 1 and
   8) and min, and the fused PageRank spec (Q = 1 and 8) through the
   earlier, this, this and the earlier library in turn: entries that
   differ from the plain version (sums: outside rtol=1e-5, atol=1e-6),
   CUDA-event ms (L2 flushed, median of 10) and the row and hub
   launches' device ms (``chip_smoke.row_hub_ms``).

Prints the card, a line per result and, last, one JSON object of all of
them.  Needs a CUDA device and nvcc.
"""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

O0 = ("-Xptxas", "-O0")


def libraries(old_csrc, names, extra=()):
    """{name: loaded library} built from ``old_csrc`` (or this checkout's
    csrc when None) with NVCC_FLAGS + extra."""
    from pathlib import Path

    from repro_torch.kernels import _build, gab_fused, gab_gather

    sigs = {"segment_reduce": gab_gather._SIGNATURES,
            "gab_fused": gab_fused._SIGNATURES}
    csrc, flags = _build.CSRC, _build.NVCC_FLAGS
    try:
        _build.CSRC = Path(old_csrc) if old_csrc else csrc
        _build.NVCC_FLAGS = flags + tuple(extra)
        _build._LIBS.clear()
        _build.build(names)
        return {n: _build.load(n, sigs[n]) for n in names}
    finally:
        _build.CSRC, _build.NVCC_FLAGS = csrc, flags
        _build._LIBS.clear()


def use(libs):
    from repro_torch.kernels import _build

    _build._LIBS.clear()
    _build._LIBS.update(libs)


def c1_case(old_csrc, extra):
    """One process: C.1's list through one segment library."""
    import torch

    from chip_smoke import skewed_int32_list
    from repro_torch.kernels import gab_gather, ref

    use(libraries(old_csrc, ("segment_reduce",), extra))
    d_np, c_np, r = skewed_int32_list(1 << 17)
    d = torch.from_numpy(d_np).cuda()
    c = torch.from_numpy(c_np).cuda()
    out = {}
    for combine in ("min", "max"):
        want = ref.segment_reduce(c, d, r, combine)
        got = gab_gather.segment_reduce(c, d, r, combine)
        torch.cuda.synchronize()
        out[combine] = int((got != want).sum())
    print(json.dumps(out))


def run_c1(tag, old_csrc, extra):
    args = [sys.executable, os.path.abspath(__file__), "--c1",
            old_csrc or "", *extra]
    proc = subprocess.run(args, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        res = {k: f"{v} rows differ" for k, v in json.loads(lines[-1]).items()}
    else:
        err = [ln for ln in proc.stderr.splitlines() if "Error" in ln]
        res = {"error": err[-1] if err else proc.stderr[-300:]}
    print(f"C.1 list, {tag}: {res}", flush=True)
    return res


def tile_like(torch, dev):
    from repro_torch.graphio import synth

    chunks = list(synth.rmat_edges(1 << 22, 1 << 24, seed=0))
    src = np.concatenate([c[0] for c in chunks])
    dst = np.concatenate([c[1] for c in chunks])
    _, inv = np.unique(dst[src < (1 << 20)], return_inverse=True)
    d = np.sort(inv).astype(np.int32)
    return torch.from_numpy(d).to(dev), int(d.max()) + 2


def tile_cases(torch, old, new, dev="cuda"):
    from chip_smoke import row_hub_ms, time_ms
    from repro_torch.kernels import gab_fused, gab_gather, ref
    from repro_torch.kernels.gab_fused import FusedSpec

    d, r = tile_like(torch, dev)
    e = d.shape[0]
    print(f"tile-like list: E {e}, R {r}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    ci = torch.randint(-(1 << 30), 1 << 30, (e,), generator=gen,
                       device=dev, dtype=torch.int32)
    cf = torch.rand(e, generator=gen, device=dev)
    cf8 = torch.rand((e, 8), generator=gen, device=dev)
    cn = torch.randn(e, generator=gen, device=dev)
    a = torch.rand(e, generator=gen, device=dev)
    spec = FusedSpec(combine="sum", apply="affine", alpha=0.15, beta=0.85,
                     scale_aux="inv_out_degree")

    def fused_args(c):
        old_v = torch.zeros((r,) + tuple(c.shape[1:]), device=dev)
        return (spec, c, a, None, d, old_v, None, r - 1, r)
    cases = {
        "int32 sum": (lambda f: f.segment_reduce(ci, d, r, "sum"), True),
        "int32 min": (lambda f: f.segment_reduce(ci, d, r, "min"), True),
        "int32 max": (lambda f: f.segment_reduce(ci, d, r, "max"), True),
        "float32 sum Q=1": (lambda f: f.segment_reduce(cf, d, r, "sum"),
                            False),
        "float32 sum Q=8": (lambda f: f.segment_reduce(cf8, d, r, "sum"),
                            False),
        "float32 min": (lambda f: f.segment_reduce(cn, d, r, "min"), True),
        "fused PageRank Q=1": (lambda f: f.gab_fused(*fused_args(cf))[0],
                               False),
        "fused PageRank Q=8": (lambda f: f.gab_fused(*fused_args(cf8))[0],
                               False),
    }

    plain = SimpleNamespace(segment_reduce=ref.segment_reduce,
                            gab_fused=ref.gab_fused_ref)
    kernel = SimpleNamespace(segment_reduce=gab_gather.segment_reduce,
                             gab_fused=gab_fused.gab_fused)
    want = {name: fn(plain) for name, (fn, _) in cases.items()}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for turn, (tag, libs) in enumerate((("earlier", old), ("this", new),
                                        ("this", new), ("earlier", old))):
        use(libs)
        for name, (fn, exact) in cases.items():
            got = fn(kernel)
            w = want[name]
            bad = (got != w) if exact else ~torch.isclose(
                got, w, rtol=1e-5, atol=1e-6)
            ms = time_ms(torch, lambda: fn(kernel), flush)
            split = row_hub_ms(torch, lambda: fn(kernel))
            row = dict(turn=turn, tree=tag, case=name,
                       differing=int(bad.sum()), ms=ms, row_ms=split["row"],
                       hub_ms=split["hub"])
            rows.append(row)
            print(f"{turn} {tag:7s} {name:18s} {row['differing']:6d} "
                  f"differ  {ms:.4f} ms  row {split['row']:.4f}  hub "
                  f"{split['hub']:.4f}", flush=True)
    return dict(edges=e, rows=r, results=rows)


def main(argv):
    if argv[:1] == ["--c1"]:
        c1_case(argv[1] or None, tuple(argv[2:]))
        return 0
    import torch

    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from chip_smoke import card_info

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_info(torch)
    old_csrc = os.path.abspath(argv[0])
    t0 = time.perf_counter()
    old = libraries(old_csrc, ("segment_reduce", "gab_fused"))
    new = libraries(None, ("segment_reduce", "gab_fused"))
    libraries(old_csrc, ("segment_reduce",), O0)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    c1 = {"earlier": run_c1("earlier", old_csrc, ()),
          "earlier, ptxas -O0": run_c1("earlier, ptxas -O0", old_csrc, O0),
          "this": run_c1("this", None, ())}
    tile = tile_cases(torch, old, new)
    print(json.dumps(dict(card=smi, c1=c1, tile=tile)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
