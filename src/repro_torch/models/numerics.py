"""How a bfloat16 run of a model is held against another: the per-row
logit bound, and the router's near ties that may send a token to other
experts.

A bfloat16 logit sums products rounded at its row's scale, not its own
(one near 0 carries its neighbours' error), so each logit is held within
the larger of ``LOGITS_ATOL`` and ``LOGITS_ULPS`` bfloat16 ulps of its
row's largest magnitude: about four ulps at the reduced models' 0.7,
where the CPU tests measured up to 1.1e-2, and 0.25 at a full-width row
whose largest logit passes 8.

Two runs that round in other places (two packages, the card and the
CPU) can order a token's k-th and (k+1)-th router logits otherwise where
they lie within a few ulps of each other, and the token then goes to
another expert.  :func:`router_flips` finds such tokens from both runs'
router logits (``moe.recording_router_logits`` in the port): at the first
MoE call whose top-k sets differ, every token that differs there must be
a near tie, its gap within ``NEAR_TIE_ULPS`` ulps of its row's largest
|router logit| (the scale at which the product rounds, as for the
logits).  What follows from such a flip is not a fault: the token's own
output, and where the flip lies before the last MoE layer the later
positions of its sequence (attention carries it) and the tokens routed
otherwise after it.  :class:`FlipTracker` marks those positions.
"""
from __future__ import annotations

import numpy as np
import torch

LOGITS_ATOL = 3e-2
LOGITS_ULPS = 4
NEAR_TIE_ULPS = 2
MAX_FLIP_SHARE = 1 / 32     # flipped tokens among those compared, at most


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def bf16_ulp(x) -> torch.Tensor:
    """The spacing of bfloat16 values at ``|x|`` (8 significant bits):
    ``2^(floor(log2 |x|) - 7)``, ``|x|`` taken at least the smallest
    normal, 2^-126."""
    x = _f32(x).abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def logit_errors(got, want, vocab: int):
    """Two logit tensors ``[..., V]`` compared over the first ``vocab``
    entries: per row (the leading dims), the largest |got - want|, that
    in bfloat16 ulps of the row's largest |want|, and that over the row's
    bound, the larger of ``LOGITS_ATOL`` and ``LOGITS_ULPS`` ulps."""
    got, want = _f32(got)[..., :vocab], _f32(want)[..., :vocab]
    err = (got - want).abs().amax(dim=-1)
    ulp = bf16_ulp(want.abs().amax(dim=-1))
    tol = torch.clamp(LOGITS_ULPS * ulp, min=LOGITS_ATOL)
    return err, err / ulp, err / tol


def bf16_logits_err(got, want, vocab: int, keep=None):
    """(the largest |got - want|, the largest in bfloat16 ulps of its
    row's largest |want|, the largest over the bound) of
    :func:`logit_errors`, over the rows where ``keep`` (a bool tensor of
    the leading dims) holds, or every row."""
    rows = logit_errors(got, want, vocab)
    if keep is not None:
        keep = torch.as_tensor(keep, dtype=torch.bool)
        rows = tuple(r[keep] for r in rows)
    return tuple(float(r.max()) if r.numel() else 0.0 for r in rows)


def _top_sets(logits, k):
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    return order[:, :k].sort(dim=-1).values


def router_flips(want, got, k: int, ulps: float = NEAR_TIE_ULPS) -> dict:
    """Where run ``got`` routes otherwise than run ``want``: both lists of
    the float32 router logits ``[T, E]`` of the same MoE calls in order
    (one forward's layers).  Returns ``layer`` (the first call whose top-k
    sets differ, None if none does), ``calls``, ``tokens`` that differ
    there with their ``gaps`` (want's k-th minus (k+1)-th logit in ulps of
    the row's largest |logit|; ties go to the lower expert id, as both
    packages break them), ``near_ties`` (every gap within ``ulps``) and
    ``later``: ``{call: tokens}`` routed otherwise in later calls."""
    out = dict(layer=None, calls=len(want), tokens=[], gaps=[],
               near_ties=True, later={})
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = _f32(w), _f32(g)
        differ = (_top_sets(w, k) != _top_sets(g, k)).any(dim=-1)
        idx = differ.nonzero().flatten().tolist()
        if not idx:
            continue
        if out["layer"] is not None:
            out["later"][i] = idx
            continue
        top = torch.sort(w, dim=-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]) / bf16_ulp(w.abs().amax(dim=-1))
        out.update(layer=i, tokens=idx, gaps=[float(gap[t]) for t in idx])
        out["near_ties"] = all(x <= ulps for x in out["gaps"])
    return out


class FlipTracker:
    """The positions of a batch of sequences that router flips may have
    moved, over the MoE forwards of one stream (a full forward, or a
    prefill and the decode steps after it), each added with the (row,
    position) of its tokens."""

    def __init__(self, k: int, ulps: float = NEAR_TIE_ULPS):
        self.k, self.ulps = k, ulps
        self.flips, self.tokens = [], 0
        self.first = {}                   # row -> first position moved
        self.single = set()               # (row, position) moved alone

    def add(self, want, got, rows, positions) -> dict:
        """One forward's router logits (``router_flips``); ``rows`` and
        ``positions`` give each of its tokens' place."""
        rows, positions = list(rows), list(positions)
        f = router_flips(want, got, self.k, self.ulps)
        self.tokens += len(rows)
        if f["layer"] is None:
            return f
        self.flips.append(f)
        moved = [(f["layer"], t) for t in f["tokens"]]
        moved += [(i, t) for i, ts in f["later"].items() for t in ts]
        for call, t in moved:
            b, s = rows[t], positions[t]
            if call < f["calls"] - 1:
                self.first[b] = min(self.first.get(b, s), s)
            else:
                self.single.add((b, s))
        return f

    def moved(self, row: int, position: int) -> bool:
        return position >= self.first.get(row, position + 1) \
            or (row, position) in self.single

    def flipped(self) -> int:
        """Tokens flipped at the first differing call of each forward."""
        return sum(len(f["tokens"]) for f in self.flips)

    def check(self, what: str) -> None:
        """Every first flip a near tie, and at most MAX_FLIP_SHARE of the
        tokens flipped."""
        far = [(f["layer"], t, g) for f in self.flips
               for t, g in zip(f["tokens"], f["gaps"]) if g > self.ulps]
        if far:
            raise AssertionError(
                f"{what}: routed otherwise away from a near tie (call, "
                f"token, gap in ulps of the row's largest logit): {far}")
        if self.flipped() > MAX_FLIP_SHARE * self.tokens:
            raise AssertionError(
                f"{what}: {self.flipped()} of {self.tokens} tokens flipped, "
                f"more than {MAX_FLIP_SHARE:.4g} of them")
