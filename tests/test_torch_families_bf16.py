"""All ten language models at the reference's own compute dtype, bfloat16,
against the JAX package on the CPU: train-mode logits, prefill, and two
decode steps into a bfloat16 cache, at the reduced configs, with the
reference's ``init(jax.random.key(1))`` parameters carried across by
``model_zoo.load_params`` (whisper with 10 encoder frames, internvl2
with its 8 patch embeddings before the tokens; gemma2-2b at one row of
30 tokens, so that its 16-token window rolls in the prefill and in both
decode steps).  The reference runs as the other tests run it
(``JAX_PLATFORMS=cpu``, its own calls).

Bound (``repro_torch.models.numerics``): each logit within the larger of
3e-2 and 4 bfloat16 ulps of its row's largest |logit| (measured up to
0.65 of it, rwkv6-1.6b's train logits).  The MoE archs are held to it
but where a router flip moved a token: both packages' router logits are
recorded (``moe.recording_router_logits`` in the port, a callback in the
reference's ``moe_apply``); at the first MoE layer whose top-k sets
differ, every differing token must be a near tie (its k-th and (k+1)-th
logits within 2 ulps of its row's largest |router logit|) and at most 1
in 32 tokens of a test may flip; the rows such a flip moved are left
out (``numerics.FlipTracker``).  Measured: in each MoE arch, token 4 of
the first row flips at layer 1 in the full forward and in the prefill,
its gap 0.39 ulps of its row (3.16 ulps of the logits themselves); its
train logits lie 2.9 of the bound off; every other row within 0.33 of
it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_families_lm as families_lm
from _ref_router import record_reference_router
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe
from repro_torch.models import numerics

RUN_KW = dict(remat="none", q_chunk=16, kv_chunk=16, loss_chunk=16,
              compute_dtype="bfloat16")


def pair(arch, key=1):
    """(reference model, its params, port model loaded with them, cfg),
    both in bfloat16."""
    return families_lm.pair(arch, key=key, run_kw=RUN_KW)


@pytest.fixture
def router_logs(monkeypatch):
    return record_reference_router(monkeypatch)


def _numel_by_dtype(tree, out=None):
    """{dtype: entries} of a nested cache of dicts, lists and arrays (the
    reference stacks its layers' caches, the port keeps one a layer)."""
    out = {} if out is None else out
    for v in (tree.values() if isinstance(tree, dict) else tree
              if isinstance(tree, (list, tuple)) else ()):
        _numel_by_dtype(v, out)
    if hasattr(tree, "dtype"):
        dt = str(tree.dtype).replace("torch.", "")
        out[dt] = out.get(dt, 0) + int(np.prod(tree.shape))
    return out


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_bf16_logits_match_reference(arch, router_logs):
    """Train-mode logits, prefill and two decode steps into a bfloat16
    cache against the reference's, each logit within the per-row bound
    but where a near-tie router flip moved it; the caches' entries in the
    reference's dtypes."""
    jm, params, tm, cfg = pair(arch)
    rng = np.random.default_rng(2)
    B, S = (1, 30) if arch == "gemma2-2b" else (2, 20)
    if arch == "gemma2-2b":
        assert cfg.sliding_window == 16 < S - 2
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    F = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    ex = rng.normal(size=(B, F, cfg.d_model)).astype(np.float32) if F \
        else None
    fr = rng.normal(size=(B, 10, cfg.d_model)).astype(np.float32)
    jt, bf = jnp.asarray(toks), jnp.bfloat16
    P = F + S - 2                       # prefilled positions
    calls, ref = [], router_logs        # (name, port's router logits)

    def port(name, fn):
        with tmoe.recording_router_logits() as log:
            out = fn()
        calls.append((name, log))
        return out

    with torch.no_grad():
        if cfg.encoder_layers:
            jh, _ = jm._dec_forward(params, jt, jm._cross_kv(
                params, jm.encode(params, jnp.asarray(fr))), "train",
                None, None)
            want = [jm._logits(params, jh)]
            jc = jm.init_cache(B, S, dtype=bf)
            jc, jp = jm.prefill(params, jt[:, :S - 2], jc, jnp.asarray(fr))
            got = [port("train", lambda: tm._logits(tm._dec_forward(
                toks, tm._cross_kv(tm.encode(fr)), "train", None,
                None)[0]))]
            c = tm.init_cache(B, S, dtype=torch.bfloat16)
            c, tp = port("prefill", lambda: tm.prefill(
                torch.from_numpy(toks[:, :S - 2]), c, fr))
        else:
            jex = None if ex is None else jnp.asarray(ex)
            jh, _ = jm.hidden(params, jt, jex, mode="train")
            want = [jm.logits(params, jh)]
            jc = jm.init_cache(B, F + S, dtype=bf)
            jc, jp = jm.prefill(params, jt[:, :S - 2], jc, extra_embeds=jex)
            got = [port("train", lambda: tm.logits(tm.hidden(
                torch.from_numpy(toks), ex, mode="train")[0]))]
            c = tm.init_cache(B, F + S, dtype=torch.bfloat16)
            c, tp = port("prefill", lambda: tm.prefill(
                torch.from_numpy(toks[:, :S - 2]), c, extra_embeds=ex))
        want.append(jp)
        got.append(tp)
        for i in (S - 2, S - 1):
            jc, jd = jm.decode_step(params, jt[:, i:i + 1], jc,
                                    jnp.int32(F + i))
            c, td = port("decode", lambda: tm.decode_step(
                torch.from_numpy(toks[:, i:i + 1]), c, F + i))
            want.append(jd)
            got.append(td)
    assert _numel_by_dtype(c) == _numel_by_dtype(jc)

    # each forward's rows and positions, by stream: the full forward, and
    # the prefill with the decode steps that read its cache
    full = numerics.FlipTracker(max(cfg.experts_per_token, 1))
    served = numerics.FlipTracker(max(cfg.experts_per_token, 1))
    places = {"train": (full, [(b, s) for b in range(B)
                               for s in range(F + S)]),
              "prefill": (served, [(b, s) for b in range(B)
                                   for s in range(P)])}
    if cfg.moe:
        # both ran the full forward, the prefill and the two decode steps
        # in that order, one router call a MoE layer each
        per = len(calls[0][1])
        assert per and len(ref) == per * len(calls)
        assert all(len(log) == per for _, log in calls)
        ref_by = [ref[i * per:(i + 1) * per] for i in range(len(calls))]
        for d, ((name, log), want_log) in enumerate(zip(calls, ref_by)):
            if name == "decode":
                pos = P + d - 2
                tracker, where = served, [(b, pos) for b in range(B)]
            else:
                tracker, where = places[name]
            tracker.add(want_log, log, *zip(*where))
        full.check(f"{arch} train forward")
        served.check(f"{arch} prefill and decode")
        assert full.flipped() + served.flipped() <= \
            numerics.MAX_FLIP_SHARE * (full.tokens + served.tokens)

    v = cfg.vocab_size
    keep = [torch.tensor([[not full.moved(b, s) for s in range(F + S)]
                          for b in range(B)]),
            torch.tensor([[not served.moved(b, P - 1)] for b in range(B)])]
    keep += [torch.tensor([[not served.moved(b, F + i)] for b in range(B)])
             for i in (S - 2, S - 1)]
    for name, g, w, k in zip(("train", "prefill", "decode 1", "decode 2"),
                             got, want, keep):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        err, ulps, over = numerics.bf16_logits_err(g, w, v, k)
        assert over <= 1.0, (name, err, ulps, over)
        assert bool(k.any()), name

