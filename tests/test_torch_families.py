"""The port's family modules (``models/moe.py``, ``rglru.py``, ``rwkv6.py``,
``encdec.py``) against the JAX package's functions on the CPU, on the same
numpy inputs and the reference's own parameters.  Tolerances (absolute,
float32):

* ``F32_ATOL = 1e-5``, as tests/test_torch_models.py: MoE's output
  (measured up to 5.4e-7), the conv (exact), RWKV6's time and channel
  mix and block (its loop steps as the reference's scan; measured up to
  1.9e-6), the encoder-decoder (measured up to 2.0e-6);
* RG-LRU's scan: the same ``F32_ATOL``.  The port scans in log2(S)
  doubling rounds and the reference's ``associative_scan`` in another
  tree, so the two sum in different orders: measured up to 1.1e-6 on
  states of magnitude ~1;
* MoE's routing: the ``[E, C]`` token grid and the kept assignments
  ``array_equal`` to the reference's, at the default capacity (with
  drops) and at capacity factor 8 (none).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.base import RunConfig
from repro_torch.models import encdec as tencdec
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv

F32_ATOL = 1e-5
FAMILIES = ["recurrentgemma-9b", "rwkv6-1.6b", "whisper-base",
            "granite-moe-1b-a400m", "dbrx-132b", "internvl2-76b"]
RUN = RunConfig(remat="none", q_chunk=16, kv_chunk=16, loss_chunk=16,
                compute_dtype="float32")


def _cfg(arch, **overrides):
    from repro.configs import registry as jreg

    jcfg = jreg.get_config(arch, reduced=True)
    tcfg = treg.get_config(arch, reduced=True)
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        tcfg = dataclasses.replace(tcfg, **overrides)
    return jcfg, tcfg


def _load(module, tree):
    """Copy a reference sub-tree into a port module by attribute names."""
    with torch.no_grad():
        for k, v in tree.items():
            if isinstance(v, dict):
                _load(getattr(module, k), v)
            else:
                getattr(module, k).copy_(torch.from_numpy(np.array(v)))
    return module


def _close(got, want, atol=F32_ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _ref_grid(jmoe, params, x, cfg, monkeypatch):
    """The reference's moe_apply output and its [E, C] token grid, read
    back from the gathered tokens ``xe`` (its first sharding constraint):
    each row of xe is the row of x it copied, or zeros (T)."""
    seen = []

    def spy(a, *spec):
        seen.append(np.asarray(a))
        return a
    monkeypatch.setattr(jmoe, "cns", spy)
    out = np.asarray(jmoe.moe_apply(params, jnp.asarray(x), cfg))
    xe = seen[0]
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    grid = np.full(xe.shape[:2], T)
    for e in range(xe.shape[0]):
        for c in range(xe.shape[1]):
            hit = np.nonzero((xt == xe[e, c]).all(-1))[0]
            if len(hit):
                assert not (xe[e, c] == 0).all()
                grid[e, c] = hit[0]
            else:
                assert (xe[e, c] == 0).all()
    return out, grid


@pytest.mark.parametrize("factor", [None, 8.0])
def test_moe_apply_matches_reference(factor, monkeypatch):
    """granite-moe reduced (E = 4, k = 2), 128 tokens of mean 0.5 and
    expert 0's router column raised, so that expert 0 is over capacity at
    the default factor: the token grid and the kept assignments equal the
    reference's, the output within F32_ATOL; at factor 8 nothing is
    dropped."""
    from repro.models import moe as jmoe

    jcfg, cfg = _cfg("granite-moe-1b-a400m", **(
        {} if factor is None else {"moe_capacity_factor": factor}))
    params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(3), jcfg))
    params["router"] = params["router"].copy()
    params["router"][:, 0] += 0.3
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 64, cfg.d_model)) + 0.5).astype(np.float32)
    want, grid = _ref_grid(jmoe, params, x, jcfg, monkeypatch)

    p = _load(tmoe.MoE(cfg), params)
    got = tmoe.moe_apply(p, torch.from_numpy(x), cfg)
    _close(got, want)
    T, E = 128, cfg.num_experts
    C = tmoe.moe_capacity(T, cfg)
    assert C == jmoe.moe_capacity(T, jcfg) == grid.shape[1]
    logits = torch.from_numpy(x.reshape(T, -1)) @ p.router
    _, eids = torch.topk(logits, cfg.experts_per_token, sorted=True)
    slot, tgrid = tmoe.moe_dispatch(eids, cfg, C)
    np.testing.assert_array_equal(tgrid.numpy(), grid)
    kept = {(t, int(eids[t, k])) for t in range(T)
            for k in range(eids.shape[1]) if int(slot[t, k]) < E * C}
    ref_kept = {(int(grid[e, c]), e) for e in range(E) for c in range(C)
                if grid[e, c] < T}
    assert kept == ref_kept
    dropped = T * cfg.experts_per_token - len(kept)
    assert (dropped > 0) == (factor is None), dropped


def test_moe_combine_sums_in_expert_order():
    """A token's k outputs are added in ascending expert id, whatever
    top-k's order: the port's output equals, bit for bit, a combine that
    adds the gated rows expert by expert into zeros (the reference's
    scatter order)."""
    _, cfg = _cfg("dbrx-132b", moe_capacity_factor=8.0)
    p = tmoe.MoE(cfg)
    p.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 40, cfg.d_model)).astype(np.float32))
    got = tmoe.moe_apply(p, x, cfg)[0]
    xt = x[0]
    logits = xt @ p.router
    g, eids = torch.topk(logits, cfg.experts_per_token, sorted=True)
    g = torch.softmax(g, -1)
    want = torch.zeros_like(xt)
    for e in range(cfg.num_experts):
        for t in range(xt.shape[0]):
            hit = (eids[t] == e).nonzero()
            if len(hit):
                h = xt[t] @ p.wi[e]
                h = tmoe.L._act(xt[t] @ p.wg[e], cfg.act) * h
                want[t] = want[t] + (h @ p.wo[e]) * g[t, hit[0, 0]]
    _close(got, want.numpy(), atol=F32_ATOL)


def test_moe_capacity_matches_reference():
    from repro.configs import registry as jreg
    from repro.models import moe as jmoe

    for arch in ("granite-moe-1b-a400m", "dbrx-132b"):
        for full in (False, True):
            jcfg = jreg.get_config(arch, reduced=not full)
            tcfg = treg.get_config(arch, reduced=not full)
            for t in (1, 7, 24, 1024, 4096):
                assert tmoe.moe_capacity(t, tcfg) == jmoe.moe_capacity(t, jcfg)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru():
    from repro.models import rglru as jr

    jcfg, cfg = _cfg("recurrentgemma-9b")
    params = jax.tree.map(np.asarray, jr.rglru_init(jax.random.key(2), jcfg))
    return jr, jcfg, params, _load(trglru.RGLRU(cfg), params), cfg


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_reference(with_state):
    from repro.models import rglru as jr

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    st = rng.normal(size=(2, 3, 16)).astype(np.float32) if with_state \
        else None
    jout, jst = jr._conv1d(jnp.asarray(x), jnp.asarray(w),
                           None if st is None else jnp.asarray(st))
    out, nst = trglru._conv1d(torch.from_numpy(x), torch.from_numpy(w),
                              None if st is None else torch.from_numpy(st))
    _close(out, jout, atol=0)
    _close(nst, jst, atol=0)


@pytest.mark.parametrize("S", [1, 2, 5, 16, 23])
def test_linear_scan_equals_the_recurrence(S):
    """The doubling scan against h_t = a_t h_{t-1} + b_t step by step in
    float64: within 1e-6 for a in (0, 1)."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.05, 1.0, size=(2, S, 3)).astype(np.float32)
    b = rng.normal(size=(2, S, 3)).astype(np.float32)
    got = trglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    h = np.zeros((2, 3))
    want = np.zeros((2, S, 3))
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(with_h0):
    jr, _, params, p, cfg = _rglru()
    rng = np.random.default_rng(4)
    xb = rng.normal(size=(2, 23, cfg.rnn_width)).astype(np.float32)
    h0 = rng.normal(size=(2, cfg.rnn_width)).astype(np.float32) if with_h0 \
        else None
    jy, jh = jr.rglru_scan(params, jnp.asarray(xb),
                           None if h0 is None else jnp.asarray(h0))
    y, h = trglru.rglru_scan(p, torch.from_numpy(xb),
                             None if h0 is None else torch.from_numpy(h0))
    assert h.dtype == torch.float32
    _close(y, jy)
    _close(h, jh)


def test_rglru_step_and_gates_match_reference():
    jr, _, params, p, cfg = _rglru()
    rng = np.random.default_rng(6)
    xb = rng.normal(size=(3, 1, cfg.rnn_width)).astype(np.float32)
    h = rng.normal(size=(3, cfg.rnn_width)).astype(np.float32)
    jy, jh = jr.rglru_step(params, jnp.asarray(xb), jnp.asarray(h))
    y, hn = trglru.rglru_step(p, torch.from_numpy(xb), torch.from_numpy(h))
    _close(y, jy)
    _close(hn, jh)
    ja, jb = jr._gates(params, jnp.asarray(xb))
    a, bx = trglru._gates(p, torch.from_numpy(xb))
    _close(a, ja)
    _close(bx, jb)
    assert bool(((a > 0) & (a < 1)).all())


def test_rnn_block_prefill_then_step_matches_reference():
    """rnn_block_apply in train mode, then prefill with a cache (conv and
    h carried) and one decode step: outputs and both caches against the
    reference's."""
    jr, jcfg, params, p, cfg = _rglru()
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    jout, jnone = jr.rnn_block_apply(params, jnp.asarray(x), jcfg)
    out, none = trglru.rnn_block_apply(p, torch.from_numpy(x), cfg)
    assert jnone is None and none is None
    _close(out, jout)
    jc = jr.rnn_cache_init(2, jcfg, jnp.float32)
    c = trglru.rnn_cache_init(2, cfg, torch.float32)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in c.items()} == {k: (v.shape, str(v.dtype))
                                       for k, v in jc.items()}
    jout, jc = jr.rnn_block_apply(params, jnp.asarray(x[:, :11]), jcfg, jc)
    out, c = trglru.rnn_block_apply(p, torch.from_numpy(x[:, :11]), cfg, c)
    _close(out, jout)
    jout, jc = jr.rnn_block_apply(params, jnp.asarray(x[:, 11:]), jcfg, jc)
    out, c = trglru.rnn_block_apply(p, torch.from_numpy(x[:, 11:]), cfg, c)
    _close(out, jout)
    _close(c["conv"], jc["conv"])
    _close(c["h"], jc["h"])


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _rwkv():
    from repro.models import rwkv6 as jk

    jcfg, cfg = _cfg("rwkv6-1.6b")
    params = jax.tree.map(np.asarray, jk.rwkv_init(jax.random.key(7), jcfg))
    return jk, jcfg, params, _load(trwkv.RWKV(cfg), params), cfg


def _rwkv_cache(cfg, seed):
    rng = np.random.default_rng(seed)
    d, h = cfg.d_model, cfg.d_model // 64
    return {"tmix": {"shift": rng.normal(size=(2, 1, d)).astype(np.float32),
                     "state": rng.normal(size=(2, h, 64, 64)).astype(
                         np.float32) * 0.1},
            "cmix": {"shift": rng.normal(size=(2, 1, d)).astype(np.float32)}}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("with_cache", [False, True])
def test_time_mix_matches_reference(with_cache):
    jk, jcfg, params, p, cfg = _rwkv()
    x = np.random.default_rng(9).normal(size=(2, 13, cfg.d_model)).astype(
        np.float32)
    cache = _rwkv_cache(cfg, 10)["tmix"] if with_cache else None
    jout, jc = jk.time_mix(params["tmix"], jnp.asarray(x), jcfg,
                           None if cache is None
                           else jax.tree.map(jnp.asarray, cache))
    out, c = trwkv.time_mix(p.tmix, torch.from_numpy(x), cfg,
                            None if cache is None else _torch_tree(cache))
    _close(out, jout)
    _close(c["shift"], jc["shift"])
    _close(c["state"], jc["state"])
    assert c["state"].dtype == torch.float32


@pytest.mark.parametrize("with_cache", [False, True])
def test_channel_mix_matches_reference(with_cache):
    jk, jcfg, params, p, cfg = _rwkv()
    x = np.random.default_rng(11).normal(size=(2, 7, cfg.d_model)).astype(
        np.float32)
    cache = _rwkv_cache(cfg, 12)["cmix"] if with_cache else None
    jout, jc = jk.channel_mix(params["cmix"], jnp.asarray(x), jcfg,
                              None if cache is None
                              else jax.tree.map(jnp.asarray, cache))
    out, c = trwkv.channel_mix(p.cmix, torch.from_numpy(x), cfg,
                               None if cache is None else _torch_tree(cache))
    _close(out, jout)
    _close(c["shift"], jc["shift"])


def test_rwkv_block_and_cache_init_match_reference():
    """rwkv_block_apply with a cache (written in place in the port) and
    without one (a new cache in both packages, as in train mode);
    rwkv_cache_init's shapes and dtypes."""
    from repro.models.layers import norm_init
    from repro_torch.models import layers as tl

    jk, jcfg, params, p, cfg = _rwkv()
    ln = {"scale": np.linspace(0.5, 1.5, cfg.d_model).astype(np.float32)}
    tln = tl.Norm(cfg.d_model)
    with torch.no_grad():
        tln.scale.copy_(torch.from_numpy(ln["scale"]))
    x = np.random.default_rng(13).normal(size=(2, 6, cfg.d_model)).astype(
        np.float32)
    assert set(norm_init(4)) == {"scale"}
    for cache in (None, _rwkv_cache(cfg, 14)):
        jout, jc = jk.rwkv_block_apply(
            params, jnp.asarray(x), jcfg, ln, ln,
            None if cache is None else jax.tree.map(jnp.asarray, cache))
        out, c = trwkv.rwkv_block_apply(p, torch.from_numpy(x), cfg, tln, tln,
                                        None if cache is None
                                        else _torch_tree(cache))
        _close(out, jout)
        for path in (("tmix", "shift"), ("tmix", "state"), ("cmix", "shift")):
            _close(c[path[0]][path[1]], jc[path[0]][path[1]])
    jc = jk.rwkv_cache_init(3, jcfg, jnp.bfloat16)
    c = trwkv.rwkv_cache_init(3, cfg, torch.bfloat16)
    for a, b in ((c["tmix"]["shift"], jc["tmix"]["shift"]),
                 (c["tmix"]["state"], jc["tmix"]["state"]),
                 (c["cmix"]["shift"], jc["cmix"]["shift"])):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
    assert trwkv.rwkv_head_dim(cfg) == jk.rwkv_head_dim(jcfg) == 64


# ---------------------------------------------------------------------------
# encoder-decoder
# ---------------------------------------------------------------------------

def _encdec(key=1):
    from repro.configs.base import RunConfig as JRun
    from repro.models.model_zoo import build_model as jbuild

    jcfg, cfg = _cfg("whisper-base")
    jm = jbuild(jcfg, JRun(**dataclasses.asdict(RUN)))
    params = jm.init(jax.random.key(key))
    tm = tzoo.load_params(tzoo.build_model(cfg, RUN),
                          jax.tree.map(np.asarray, params))
    return jm, params, tm, cfg


@pytest.mark.parametrize("top", [23, 1000])
def test_sinusoidal_matches_reference(top):
    """Within F32_ATOL up to position 23 (the decoder tests' lengths); to
    position 1,000 within 1e-7 · position: XLA's exp and torch's differ by
    an ulp on some frequencies (the exponents are equal), which an angle
    of p radians carries as p ulps (measured 6.1e-5 at 1,000)."""
    from repro.models import encdec as je

    pos = np.arange(top + 1)[None]
    for d in (2, 3, 64, 512):
        _close(tencdec.sinusoidal(torch.from_numpy(pos), d, torch.float32),
               je.sinusoidal(jnp.asarray(pos), d, jnp.float32),
               atol=max(F32_ATOL, 1e-7 * top))


def test_encode_and_cross_kv_match_reference():
    jm, params, tm, cfg = _encdec()
    fr = np.random.default_rng(0).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    jenc = jm.encode(params, jnp.asarray(fr))
    jxk, jxv = jm._cross_kv(params, jenc)
    with torch.no_grad():
        enc = tm.encode(torch.from_numpy(fr))
        xkv = tm._cross_kv(enc)
    _close(enc, jenc)
    assert len(xkv) == cfg.num_layers == jxk.shape[0]
    for i, kv in enumerate(xkv):
        _close(kv["k"], jxk[i])
        _close(kv["v"], jxv[i])


def test_encdec_prefill_and_decode_match_reference():
    """prefill (its cross K/V carried as xkv) and two decode steps against
    the reference's logits, and the decode against the full forward."""
    jm, params, tm, cfg = _encdec(key=3)
    rng = np.random.default_rng(1)
    B, S = 2, 20
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fr = rng.normal(size=(B, 10, cfg.d_model)).astype(np.float32)
    v = cfg.vocab_size
    jc = jm.init_cache(B, S, dtype=jnp.float32)
    assert jc["xkv"] is None
    jc, jpre = jm.prefill(params, jnp.asarray(toks[:, :S - 2]), jc,
                          jnp.asarray(fr))
    jc, jd1 = jm.decode_step(params, jnp.asarray(toks[:, S - 2:S - 1]), jc,
                             jnp.int32(S - 2))
    jc, jd2 = jm.decode_step(params, jnp.asarray(toks[:, S - 1:]), jc,
                             jnp.int32(S - 1))
    with torch.no_grad():
        c = tm.init_cache(B, S, dtype=torch.float32)
        assert c["xkv"] is None and len(c["dec"]) == cfg.num_layers
        assert tuple(c["dec"][0]["k"].shape) == (B, S, cfg.num_heads, 16)
        c, pre = tm.prefill(torch.from_numpy(toks[:, :S - 2]), c,
                            torch.from_numpy(fr))
        assert len(c["xkv"]) == cfg.num_layers
        c, d1 = tm.decode_step(torch.from_numpy(toks[:, S - 2:S - 1]), c,
                               S - 2)
        c, d2 = tm.decode_step(torch.from_numpy(toks[:, S - 1:]), c, S - 1)
        h, _ = tm._dec_forward(toks, tm._cross_kv(tm.encode(fr)), "train",
                               None, None)
        full = tm._logits(h[:, -1:])
    for got, want in ((pre, jpre), (d1, jd1), (d2, jd2)):
        _close(got[..., :v], np.asarray(want)[..., :v])
    assert float((full - d2).abs().max()) < 2e-3
    _close(c["dec"][1]["k"], jc["dec"]["k"][1])


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_export_then_load_is_the_identity(arch):
    """export_params gives the reference's tree for every family — the
    stacked encoder/decoder leaves, moe/{router, wi, wg, wo}, the R and K
    leaves in cycles — leaf for leaf and bit for bit; loading it back
    changes nothing; a port-initialised model's export runs in the
    reference's forward with the port's logits."""
    from repro.configs.base import RunConfig as JRun
    from repro.models.model_zoo import build_model as jbuild
    from repro.models.model_zoo import active_param_count as jactive

    jcfg, cfg = _cfg(arch)
    jm = jbuild(jcfg, JRun(**dataclasses.asdict(RUN)))
    params = jm.init(jax.random.key(4))
    tm = tzoo.load_params(tzoo.build_model(cfg, RUN),
                          jax.tree.map(np.asarray, params))
    tree = tzoo.export_params(tm)
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert np.array_equal(np.asarray(a), b)
    np_params = jax.tree.map(np.asarray, params)
    assert tzoo.param_count(tm) == tzoo.param_count(tree) == \
        tzoo.param_count(np_params)
    assert tzoo.active_param_count(cfg, tm) == \
        tzoo.active_param_count(cfg, np_params) == jactive(jcfg, params)

    other = tzoo.build_model(cfg, RUN).init(7)
    again = tzoo.export_params(tzoo.load_params(
        tzoo.build_model(cfg, RUN), tzoo.export_params(other)))
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(
            tzoo.export_params(other))[0],
            jax.tree_util.tree_flatten_with_path(again)[0]):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (1, 10)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tzoo.export_params(other))
    if cfg.encoder_layers:
        fr = rng.normal(size=(1, 6, cfg.d_model)).astype(np.float32)
        jh, _ = jm._dec_forward(jp, jnp.asarray(toks), jm._cross_kv(
            jp, jm.encode(jp, jnp.asarray(fr))), "train", None, None)
        with torch.no_grad():
            th, _ = other._dec_forward(toks, other._cross_kv(
                other.encode(fr)), "train", None, None)
    else:
        jh, _ = jm.hidden(jp, jnp.asarray(toks), mode="train")
        with torch.no_grad():
            th, _ = other.hidden(torch.from_numpy(toks), mode="train")
    _close(th, jh)


def test_load_params_refuses_a_wrong_family_leaf():
    """A missing expert leaf or a stacked encoder leaf of the wrong depth
    is refused, naming its path."""
    from repro.configs.base import RunConfig as JRun
    from repro.models.model_zoo import build_model as jbuild

    for arch, path in (("granite-moe-1b-a400m",
                        ("cycles", "0G", "moe", "wg")),
                       ("whisper-base", ("encoder", "mlp", "wi"))):
        jcfg, cfg = _cfg(arch)
        tree = jax.tree.map(np.asarray, jbuild(jcfg, JRun()).init(
            jax.random.key(0)))
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]][:, :-1]
        with pytest.raises(ValueError, match="/".join(path)):
            tzoo.load_params(tzoo.build_model(cfg, RUN), tree)
        del node[path[-1]]
        with pytest.raises(KeyError, match=path[-1]):
            tzoo.load_params(tzoo.build_model(cfg, RUN), tree)
