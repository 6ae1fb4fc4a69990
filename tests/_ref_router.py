"""The JAX reference's MoE router logits, recorded for the bfloat16 tests
(tests/test_torch_families_bf16.py, tests/test_torch_train_bf16.py) to
hold against the port's (``repro_torch.models.moe.recording_router_logits``)
or to force onto the port's router.
"""
import jax
import jax.numpy as jnp
import numpy as np


def record_reference_router(monkeypatch) -> list:
    """Wraps the reference's ``moe_apply`` for the test: each call appends
    its float32 router logits ``[T, E]`` to the list returned, in call
    order, through a callback beside the reference's own product (the
    same expression, which XLA computes alike), inside jit and scan
    too."""
    import repro.models.moe as jmoe

    logs, apply = [], jmoe.moe_apply

    def recorded(p, x, cfg):
        xt = x.reshape(x.shape[0] * x.shape[1], x.shape[2])
        logits = (xt @ p["router"].astype(x.dtype)).astype(jnp.float32)
        jax.debug.callback(lambda a: logs.append(np.asarray(a)), logits,
                           ordered=True)
        return apply(p, x, cfg)

    monkeypatch.setattr(jmoe, "moe_apply", recorded)
    return logs


def forcing_router(monkeypatch, logs: list) -> list:
    """Wraps the port's router product (``moe.linear_f32``) for the test:
    each call returns the reference's float32 router logits of the same
    call, taken from ``logs`` (``record_reference_router``'s arrays of
    one step's forwards) as the one nearest the port's own, with the port's
    gradient (``want + (got - got.detach())``): the port then routes as
    the reference did, its recomputed forwards (remat) too.  Returns a
    list of (the nearest's distance, the second nearest's) of each call,
    for the caller to hold the match to."""
    import torch

    import repro_torch.models.moe as tmoe

    want = [torch.from_numpy(np.array(a)) for a in logs]
    matches, product = [], tmoe.linear_f32

    def forced(x, w):
        got = product(x, w)
        dist = sorted((float((got.detach() - a).abs().max()), i)
                      for i, a in enumerate(want) if a.shape == got.shape)
        matches.append((dist[0][0], dist[1][0] if len(dist) > 1
                        else float("inf")))
        return want[dist[0][1]] + (got - got.detach())

    monkeypatch.setattr(tmoe, "linear_f32", forced)
    return matches
