"""Three-term roofline of one per-device program — counterpart of
``repro/roofline/analysis.py``, on the H100's figures (``roofline/hw.py``).

  compute   = FLOPs / peak_FLOP/s            (per device: ``hlo_cost``
  memory    = bytes / HBM_bw                  counts the local ops)
  collective= collective_bytes / link_bw

``collective_bytes`` sums the collectives ``roofline/hlo_cost.py``
recorded: the operand sizes of all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute ops, per the assignment's definition (the
reference parses them from the optimized HLO text).

The reference's ``cost_analysis_terms(compiled)`` has no counterpart: it
reads XLA's own ``cost_analysis``, which counts a loop body once, and the
port compiles nothing.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline import hw

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def collective_bytes(records) -> dict:
    """Sum operand bytes per collective kind over a ``hlo_cost`` op record
    (the ops of ``hlo_cost.run(...).records``, or a record saved by
    ``launch/dryrun.py``): the reference's keys, with ``total`` and
    ``op_counts``."""
    from repro_torch.roofline import hlo_cost

    out: dict[str, int] = {}
    count: dict[str, int] = {}
    for kind, b in hlo_cost.collectives(records):
        out[kind] = out.get(kind, 0) + b
        count[kind] = count.get(kind, 0) + 1
    out["total"] = sum(v for k, v in out.items() if k != "total")
    out["op_counts"] = count
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float                  # per-device flops
    hbm_bytes: float              # per-device bytes accessed (conservative)
    coll_bytes: float             # per-device collective operand bytes
    compute_s: float
    memory_s: float               # conservative (op-boundary) bound
    memory_fused_s: float         # optimistic (fusion-granularity) bound
    collective_s: float
    bottleneck: str
    model_flops_total: float      # 6ND (train) / 2ND (inference), global
    useful_flops_ratio: float     # model_flops_per_device / flops
    step_s_bound: float           # max of the three terms
    mfu_bound: float              # model flops / (chips * peak * step_s_bound)

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline(flops: float, hbm_bytes: float, coll_bytes: float,
             n_chips: int, model_flops_total: float,
             links: int = 1, hbm_bytes_fused: float = None) -> RooflineTerms:
    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = hbm_bytes / hw.HBM_BW
    fused = hbm_bytes if hbm_bytes_fused is None else hbm_bytes_fused
    memory_fused_s = fused / hw.HBM_BW
    collective_s = coll_bytes / (hw.LINK_BW * links)
    # bottleneck / MFU use the fused (fusion-granularity) memory bound;
    # the conservative bound is reported alongside.
    terms = {"compute": compute_s, "memory": memory_fused_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step = max(compute_s, memory_fused_s, collective_s)
    mfu = (model_flops_total / (n_chips * hw.PEAK_FLOPS_BF16 * step)
           if step > 0 else 0.0)
    per_dev_model = model_flops_total / n_chips
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_bytes,
        compute_s=compute_s, memory_s=memory_s,
        memory_fused_s=memory_fused_s, collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops_total=model_flops_total,
        useful_flops_ratio=per_dev_model / flops if flops else 0.0,
        step_s_bound=step, mfu_bound=mfu,
    )


def model_flops(kind: str, n_params_active: int, tokens: int,
                embed_params: int = 0) -> float:
    """6ND for train, 2ND per forward token for prefill/decode.
    n_params excludes embedding table lookups (pass separately if desired)."""
    n = n_params_active - embed_params
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens
