"""The port's dense decoders (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package on the CPU.

Parameters come from the reference's ``LM.init(jax.random.key(k))`` and
reach the port through ``model_zoo.load_params``.  Tolerances (absolute,
on logits of magnitude ~0.7 at the reduced configs' random init):

* float32: ``F32_ATOL = 1e-5`` against the reference (measured up to
  6.9e-7: another order of summation in the matmuls and attention);
* bfloat16: ``BF16_ATOL = 3e-2`` (measured up to 1.1e-2, about four
  bfloat16 ulps at 0.7: the two packages round the bf16 matmuls'
  outputs in different places);
* decode against the full forward, within the port: the reference's own
  test bound, ``2e-3``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.base import RunConfig, ShapeCell
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.transformer import padded_vocab

DENSE = ["qwen3-1.7b", "gemma2-2b", "deepseek-7b", "qwen3-14b"]
F32_ATOL = 1e-5
BF16_ATOL = 3e-2
DECODE_ATOL = 2e-3
ATOL = {"float32": F32_ATOL, "bfloat16": BF16_ATOL}


def run_config(dtype="float32", chunk=16):
    return RunConfig(remat="none", q_chunk=chunk, kv_chunk=chunk,
                     loss_chunk=chunk, compute_dtype=dtype)


def pair(arch, dtype="float32", key=1, **overrides):
    """(reference model, its params, port model loaded with them, cfg)."""
    from repro.configs import registry as jreg
    from repro.configs.base import RunConfig as JRun
    from repro.models.model_zoo import build_model as jbuild

    jcfg = jreg.get_config(arch, reduced=True)
    tcfg = treg.get_config(arch, reduced=True)
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        tcfg = dataclasses.replace(tcfg, **overrides)
    jrun = JRun(remat="none", q_chunk=16, kv_chunk=16, loss_chunk=16,
                compute_dtype=dtype)
    jm = jbuild(jcfg, jrun)
    params = jm.init(jax.random.key(key))
    tm = tzoo.load_params(tzoo.build_model(tcfg, run_config(dtype)),
                          jax.tree.map(np.asarray, params))
    return jm, params, tm, tcfg


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_logits_match_reference(arch, dtype):
    """hidden (train mode) + logits, prefill and decode_step logits, each
    against the reference on the same parameters and tokens."""
    jm, params, tm, cfg = pair(arch, dtype)
    B, S = 2, 24
    toks = _tokens(cfg, (B, S))
    v = cfg.vocab_size
    jh, _ = jm.hidden(params, jnp.asarray(toks), mode="train")
    jc = jm.init_cache(B, S, dtype=jnp.float32)
    jc, jpre = jm.prefill(params, jnp.asarray(toks[:, :S - 1]), jc)
    _, jdec = jm.decode_step(params, jnp.asarray(toks[:, S - 1:]), jc,
                             jnp.int32(S - 1))
    with torch.no_grad():
        th, none = tm.hidden(torch.from_numpy(toks), mode="train")
        cache = tm.init_cache(B, S, dtype=torch.float32)
        cache, tpre = tm.prefill(torch.from_numpy(toks[:, :S - 1]), cache)
        _, tdec = tm.decode_step(torch.from_numpy(toks[:, S - 1:]), cache,
                                 S - 1)
    assert none is None
    atol = ATOL[dtype]
    got, want = _np(tm.logits(th).detach()), _np(jm.logits(params, jh))
    np.testing.assert_allclose(got[..., :v], want[..., :v], rtol=0, atol=atol)
    np.testing.assert_allclose(_np(tpre)[..., :v], _np(jpre)[..., :v],
                               rtol=0, atol=atol)
    np.testing.assert_allclose(_np(tdec)[..., :v], _np(jdec)[..., :v],
                               rtol=0, atol=atol)
    assert th.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b"])
def test_decode_matches_full_forward(arch):
    """Counterpart of tests/test_models.py: prefill S - 1 tokens, decode the
    last; its logits equal the full forward's last within 2e-3."""
    _, _, tm, cfg = pair(arch, key=1)
    B, S = 2, 24
    toks = torch.from_numpy(_tokens(cfg, (B, S)))
    with torch.no_grad():
        h, _ = tm.hidden(toks, mode="train")
        full = tm.logits(h[:, -1:])
        cache = tm.init_cache(B, S, dtype=torch.float32)
        cache, _ = tm.prefill(toks[:, :S - 1], cache)
        _, dec = tm.decode_step(toks[:, S - 1:S], cache, torch.tensor(S - 1))
    assert float((full - dec).abs().max()) < DECODE_ATOL


def test_sliding_window_cache_rolls():
    """gemma2-style local layer with S > window (16): the rolling cache's
    decode equals the full forward's last-token logits, and the
    reference's decode logits."""
    jm, params, tm, cfg = pair("gemma2-2b", key=2)
    assert cfg.sliding_window == 16
    B, S = 1, 30
    toks = _tokens(cfg, (B, S))
    t = torch.from_numpy(toks)
    with torch.no_grad():
        h, _ = tm.hidden(t, mode="train")
        full = tm.logits(h[:, -1:])
        cache = tm.init_cache(B, S, dtype=torch.float32)
        assert cache[0]["k"].shape[1] == 16 and cache[1]["k"].shape[1] == S
        cache, _ = tm.prefill(t[:, :S - 1], cache)
        _, dec = tm.decode_step(t[:, S - 1:S], cache, S - 1)
    assert float((full - dec).abs().max()) < DECODE_ATOL
    jc = jm.init_cache(B, S, dtype=jnp.float32)
    jc, _ = jm.prefill(params, jnp.asarray(toks[:, :S - 1]), jc)
    jc, jdec = jm.decode_step(params, jnp.asarray(toks[:, S - 1:]), jc,
                              jnp.int32(S - 1))
    np.testing.assert_allclose(_np(dec), _np(jdec), rtol=0, atol=F32_ATOL)
    # after the decode write, the local layer's rolled buffer holds the
    # reference's K/V slot for slot
    np.testing.assert_allclose(
        cache[0]["k"].numpy(), np.asarray(jc["cycles"]["0L"]["k"][0]),
        rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("window", [None, 9])
def test_blockwise_attention_matches_naive(window):
    """Counterpart of tests/test_models.py (q/kv chunks of 8 over 37
    positions, a naive masked softmax, 2e-4), and against the reference's
    blockwise_attention (F32_ATOL)."""
    from repro.models.layers import blockwise_attention as jblock

    rng = np.random.default_rng(0)
    B, S, H, Hkv, Dh = 2, 37, 4, 2, 16
    q = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    out = tlayers.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, q_chunk=8, kv_chunk=8).numpy()
    kk = np.repeat(k, H // Hkv, axis=2)
    vv = np.repeat(v, H // Hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(Dh)
    pos = np.arange(S)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = np.where(mask[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bkhd->bqhd", p, vv)
    np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
    ref = jblock(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                 window=window, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=F32_ATOL)


def test_rope_norms_and_gelu_match_reference():
    """rope (halves, theta 1e6), rmsnorm and layernorm (population
    variance), and gelu (the tanh form jax.nn.gelu defaults to)."""
    from repro.models import layers as jl

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32) * 3
    pos = np.arange(5)[None, :] + 1000
    np.testing.assert_allclose(
        tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=0, atol=1e-5)
    scale = rng.normal(size=8).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        np.testing.assert_allclose(
            tlayers.norm_apply(torch.from_numpy(scale), torch.from_numpy(x),
                               kind).numpy(),
            np.asarray(jl.norm_apply({"scale": jnp.asarray(scale)},
                                     jnp.asarray(x), kind)),
            rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tlayers._act(torch.from_numpy(x), "gelu").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=0, atol=1e-6)


def test_vocab_padding_masked():
    """A dense config at vocab_size 500: the table is padded to 512 and the
    pad logits of prefill and decode are -1e30; the real ones match the
    reference."""
    jm, params, tm, cfg = pair("qwen3-1.7b", vocab_size=500)
    assert padded_vocab(cfg) == 512 and tm.embed_tok.shape[0] == 512
    toks = _tokens(cfg, (1, 8))
    with torch.no_grad():
        cache = tm.init_cache(1, 16, dtype=torch.float32)
        cache, pre = tm.prefill(torch.from_numpy(toks), cache)
        _, dec = tm.decode_step(torch.tensor([[3]]), cache, 8)
    for lg in (pre, dec):
        assert bool((lg[..., 500:] == -1e30).all())
    jc = jm.init_cache(1, 16, dtype=jnp.float32)
    _, jpre = jm.prefill(params, jnp.asarray(toks), jc)
    np.testing.assert_allclose(_np(pre)[..., :500], _np(jpre)[..., :500],
                               rtol=0, atol=F32_ATOL)


def test_tail_layers_follow_the_cycles():
    """gemma2 reduced at 3 layers (pattern LG): one full cycle and a tail
    L — the tail's parameters land on the third block and the logits match
    the reference."""
    jm, params, tm, cfg = pair("gemma2-2b", num_layers=3)
    assert tm.block_kinds == ["L", "G", "L"]
    assert set(params["tail"]) == {"0L"}
    np.testing.assert_array_equal(tm.blocks[2].mlp.wi.numpy(),
                                  np.asarray(params["tail"]["0L"]["mlp"]["wi"]))
    np.testing.assert_array_equal(
        tm.blocks[1].attn.wq.numpy(),
        np.asarray(params["cycles"]["1G"]["attn"]["wq"][0]))
    toks = _tokens(cfg, (2, 20))
    jh, _ = jm.hidden(params, jnp.asarray(toks), mode="train")
    with torch.no_grad():
        th, _ = tm.hidden(torch.from_numpy(toks), mode="train")
    np.testing.assert_allclose(_np(tm.logits(th)), _np(jm.logits(params, jh)),
                               rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_export_then_load_is_the_identity(arch):
    """export_params gives the reference's tree, leaf for leaf and bit for
    bit, and loading it back changes nothing; a port-initialised model's
    export loads into the reference's forward with matching logits."""
    jm, params, tm, cfg = pair(arch, key=4)
    tree = tzoo.export_params(tm)
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert np.array_equal(np.asarray(a), b)
    assert tzoo.param_count(tm) == tzoo.param_count(tree) == \
        tzoo.param_count(jax.tree.map(np.asarray, params))
    other = tzoo.build_model(cfg, run_config()).init(7)
    again = tzoo.export_params(tzoo.load_params(
        tzoo.build_model(cfg, run_config()), tzoo.export_params(other)))
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(
            tzoo.export_params(other))[0],
            jax.tree_util.tree_flatten_with_path(again)[0]):
        assert np.array_equal(a, b)
    toks = _tokens(cfg, (1, 10))
    jh, _ = jm.hidden(jax.tree.map(jnp.asarray, tzoo.export_params(other)),
                      jnp.asarray(toks), mode="train")
    with torch.no_grad():
        th, _ = other.hidden(torch.from_numpy(toks), mode="train")
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=0, atol=F32_ATOL)


def test_load_params_refuses_a_wrong_shape():
    _, params, tm, _ = pair("qwen3-1.7b")
    tree = jax.tree.map(np.asarray, params)
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm/scale"):
        tzoo.load_params(tm, tree)
    del tree["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        tzoo.load_params(tm, tree)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b",
                                  "dbrx-132b", "granite-moe-1b-a400m",
                                  "whisper-base"])
def test_later_families_raise_naming_their_slice(arch):
    with pytest.raises(NotImplementedError, match="A.13.3"):
        tzoo.build_model(treg.get_config(arch, reduced=True))


def test_registry_matches_reference():
    """ARCH_IDS, every config, the rule sets, default run configs,
    input_specs' shapes and dtypes and synthetic_batch equal the
    reference's for every arch and cell."""
    from repro.configs import registry as jreg

    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.LONG_CONTEXT_ARCHS == jreg.LONG_CONTEXT_ARCHS
    assert treg.FSDP_ARCHS == jreg.FSDP_ARCHS
    assert list(treg.SHAPE_CELLS) == list(jreg.SHAPE_CELLS)
    for arch in treg.ARCH_IDS:
        for reduced in (False, True):
            assert dataclasses.asdict(treg.get_config(arch, reduced)) == \
                dataclasses.asdict(jreg.get_config(arch, reduced))
        cfg_t, cfg_j = treg.get_config(arch, True), jreg.get_config(arch, True)
        for name, cell in treg.SHAPE_CELLS.items():
            assert treg.cell_runnable(arch, name) == \
                jreg.cell_runnable(arch, name)
            assert dataclasses.asdict(treg.default_run_config(arch, cell)) == \
                dataclasses.asdict(jreg.default_run_config(
                    arch, jreg.SHAPE_CELLS[name]))
            ts = treg.input_specs(cfg_t, cell, batch_override=2)
            js = jreg.input_specs(cfg_j, jreg.SHAPE_CELLS[name],
                                  batch_override=2)
            assert list(ts) == list(js)
            for k in ts:
                assert tuple(ts[k].shape) == tuple(js[k].shape)
                assert ts[k].dtype == js[k].dtype.name
        cell = ShapeCell("smoke", "train", 32, 2)
        tb = treg.synthetic_batch(cfg_t, cell, batch=2, seq=32, seed=3)
        jb = jreg.synthetic_batch(cfg_j, cell, batch=2, seq=32, seed=3)
        assert list(tb) == list(jb)
        for k in tb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
