"""The port's whole models of every family (RG-LRU, RWKV6, MoE, the vision
frontend, the encoder-decoder) against the JAX package on the CPU, at the
reduced configs, with the reference's ``init(jax.random.key(k))``
parameters carried across by ``model_zoo.load_params``; their train
steps, serving engine, serve functions and CLIs.  Tolerances:

* logits, float32: ``F32_ATOL = 1e-5`` (tests/test_torch_models.py;
  measured up to 1.3e-6, RWKV6's loop and RG-LRU's doubling scan
  included);
* loss within ``1e-5`` and each gradient leaf within ``1e-5`` of its
  largest magnitude (tests/test_torch_train_grads.py; measured up to
  9.5e-7, and 6.7e-6 of the scale for rwkv6, 2.9e-6 for the others);
* decode against the full forward, within the port: ``2e-3``, the
  reference test's bound;
* three train steps at weight decay 0: every leaf of the state within
  ``STATE_ATOL = 2e-5`` (tests/test_torch_train_steps.py; measured 4.2e-6
  for granite-moe, 4.9e-6 for whisper), the stats
  within rtol 1e-5, atol 1e-6; RWKV6 within ``RWKV_STATE_ATOL = 5e-5``
  (measured 2.5e-5 on ``tmix/wg``): its gradients agree with the
  reference's within 1e-5 of each leaf's scale, but Adam moves every
  entry by up to lr = 1e-3 a step whatever its gradient's size, and the
  backward through its time loop sums in another order than the
  reference's scan, so entries whose gradients are rounding noise move
  apart further than the dense decoders';
* greedy tokens equal, where every sampled step's top-2 gap exceeds
  ``2 · F32_ATOL``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.base import RunConfig, ShapeCell
from repro_torch.models import model_zoo as tzoo
from repro_torch.serve import engine as teng
from repro_torch.serve.serve_step import build_serve_fns
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 1e-5
DECODE_ATOL = 2e-3
LOSS_ATOL = 1e-5
GRAD_REL = 1e-5
STATE_ATOL = 2e-5
RWKV_STATE_ATOL = 5e-5
OPT_KW = dict(lr=1e-3, warmup_steps=2, decay_steps=100)
FAMILIES = ["recurrentgemma-9b", "rwkv6-1.6b", "whisper-base",
            "granite-moe-1b-a400m", "dbrx-132b", "internvl2-76b"]
STATEFUL = ["recurrentgemma-9b", "rwkv6-1.6b", "granite-moe-1b-a400m"]
RUN_KW = dict(remat="none", q_chunk=16, kv_chunk=16, loss_chunk=16,
              compute_dtype="float32")
RUN = RunConfig(**RUN_KW)
CELL = ShapeCell("smoke", "train", 32, 2)


def _cfgs(arch, **overrides):
    from repro.configs import registry as jreg

    jcfg = jreg.get_config(arch, reduced=True)
    tcfg = treg.get_config(arch, reduced=True)
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        tcfg = dataclasses.replace(tcfg, **overrides)
    return jcfg, tcfg


def pair(arch, key=1, run_kw=RUN_KW, **overrides):
    """(reference model, its params, port model loaded with them, cfg)."""
    from repro.configs.base import RunConfig as JRun
    from repro.models.model_zoo import build_model as jbuild

    jcfg, tcfg = _cfgs(arch, **overrides)
    jm = jbuild(jcfg, JRun(**run_kw))
    params = jm.init(jax.random.key(key))
    tm = tzoo.load_params(tzoo.build_model(tcfg, RunConfig(**run_kw)),
                          jax.tree.map(np.asarray, params))
    return jm, params, tm, tcfg


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, dtype=np.asarray(x).dtype),
                        tree)


def _walk(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            yield from _walk(got[k], want[k], f"{path}/{k}")
    else:
        yield path, np.asarray(got), np.asarray(want)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_arch_smoke_forward_and_grad(arch):
    """Counterpart of tests/test_models.py's smoke test over all ten
    archs: the loss and every gradient leaf equal the reference's on its
    parameters and synthetic batch (not only finite), and the gradient sum
    is finite and positive."""
    from repro.train import train_step as jts

    jm, params, tm, cfg = pair(arch, key=0)
    from repro.configs import registry as jreg

    batch = treg.synthetic_batch(cfg, CELL, batch=2, seq=32)
    jbatch = {k: jnp.asarray(v) for k, v in jreg.synthetic_batch(
        jreg.get_config(arch, reduced=True), CELL, batch=2, seq=32).items()}
    for k in batch:
        np.testing.assert_array_equal(batch[k], np.asarray(jbatch[k]))
    jl, jg = jax.value_and_grad(jts.model_loss_fn(
        jm, jreg.get_config(arch, reduced=True)))(params, jbatch)

    ptree = tzoo.param_tree(tm)
    flat = [p for leaf in topt.leaves(ptree) for p in topt.members(leaf)]
    tm.requires_grad_(True)
    loss = tts.model_loss_fn(tm, cfg)(tm, batch)
    grads = iter(torch.autograd.grad(loss, flat))
    tg = tzoo._numpy(topt.member_map(lambda _: next(grads), ptree))
    loss = float(loss.detach())
    assert np.isfinite(loss)
    assert abs(loss - float(jl)) <= LOSS_ATOL
    gn = 0.0
    for path, g, w in _walk(tg, jax.tree.map(
            lambda x: np.asarray(x, np.float32), jg)):
        scale = float(np.max(np.abs(w)))
        assert scale > 0, path
        assert float(np.max(np.abs(g - w))) <= GRAD_REL * scale, path
        gn += float(np.sum(np.abs(g)))
    assert np.isfinite(gn) and gn > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_logits_match_reference(arch):
    """Train-mode logits, prefill and two decode steps against the
    reference's, on its parameters and tokens (whisper with 10 frames,
    internvl2 with its 8 patch embeddings before the tokens)."""
    jm, params, tm, cfg = pair(arch, key=1)
    rng = np.random.default_rng(2)
    B, S = 2, 20
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    v = cfg.vocab_size
    F = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    ex = rng.normal(size=(B, F, cfg.d_model)).astype(np.float32) if F \
        else None
    fr = rng.normal(size=(B, 10, cfg.d_model)).astype(np.float32)
    jt = jnp.asarray(toks)
    with torch.no_grad():
        if cfg.encoder_layers:
            jh, _ = jm._dec_forward(params, jt, jm._cross_kv(
                params, jm.encode(params, jnp.asarray(fr))), "train",
                None, None)
            want = [jm._logits(params, jh)]
            jc = jm.init_cache(B, S, dtype=jnp.float32)
            jc, jp = jm.prefill(params, jt[:, :S - 2], jc, jnp.asarray(fr))
            th, _ = tm._dec_forward(toks, tm._cross_kv(tm.encode(fr)),
                                    "train", None, None)
            got = [tm._logits(th)]
            c = tm.init_cache(B, S, dtype=torch.float32)
            c, tp = tm.prefill(torch.from_numpy(toks[:, :S - 2]), c, fr)
        else:
            jex = None if ex is None else jnp.asarray(ex)
            jh, _ = jm.hidden(params, jt, jex, mode="train")
            want = [jm.logits(params, jh)]
            jc = jm.init_cache(B, F + S, dtype=jnp.float32)
            jc, jp = jm.prefill(params, jt[:, :S - 2], jc, extra_embeds=jex)
            th, _ = tm.hidden(torch.from_numpy(toks), ex, mode="train")
            got = [tm.logits(th)]
            c = tm.init_cache(B, F + S, dtype=torch.float32)
            c, tp = tm.prefill(torch.from_numpy(toks[:, :S - 2]), c,
                               extra_embeds=ex)
        want.append(jp)
        got.append(tp)
        for i in (S - 2, S - 1):
            jc, jd = jm.decode_step(params, jt[:, i:i + 1], jc,
                                    jnp.int32(F + i))
            c, td = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), c,
                                   F + i)
            want.append(jd)
            got.append(td)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g)[..., :v], _np(w)[..., :v], rtol=0,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b",
                                  "whisper-base"])
def test_decode_matches_full_forward(arch):
    """Counterpart of tests/test_models.py: prefill S - 1 tokens, decode the
    last; its logits equal the full forward's last within 2e-3."""
    _, _, tm, cfg = pair(arch, key=1)
    rng = np.random.default_rng(0)
    B, S = 2, 24
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        if cfg.encoder_layers:
            fr = torch.from_numpy(rng.normal(size=(B, S // 2, cfg.d_model))
                                  .astype(np.float32))
            h, _ = tm._dec_forward(t, tm._cross_kv(tm.encode(fr)), "train",
                                   None, None)
            full = tm._logits(h[:, -1:])
            cache = tm.init_cache(B, S, dtype=torch.float32)
            cache, _ = tm.prefill(t[:, :S - 1], cache, fr)
        else:
            h, _ = tm.hidden(t, mode="train")
            full = tm.logits(h[:, -1:])
            cache = tm.init_cache(B, S, dtype=torch.float32)
            cache, _ = tm.prefill(t[:, :S - 1], cache)
        _, dec = tm.decode_step(t[:, S - 1:S], cache, torch.tensor(S - 1))
    assert float((full - dec).abs().max()) < DECODE_ATOL, arch


def test_moe_decode_matches_with_high_capacity():
    """Counterpart of tests/test_models.py: dbrx reduced at capacity factor
    8 (no assignment dropped), decode against the full forward."""
    _, _, tm, cfg = pair("dbrx-132b", key=1, moe_capacity_factor=8.0)
    B, S = 2, 16
    t = torch.from_numpy(_tokens(cfg, (B, S)))
    with torch.no_grad():
        h, _ = tm.hidden(t, mode="train")
        full = tm.logits(h[:, -1:])
        cache = tm.init_cache(B, S, dtype=torch.float32)
        cache, _ = tm.prefill(t[:, :S - 1], cache)
        _, dec = tm.decode_step(t[:, S - 1:S], cache, torch.tensor(S - 1))
    assert float((full - dec).abs().max()) < DECODE_ATOL


def test_vision_decode_after_frontend_tokens():
    """internvl2 reduced: F = 8 patch embeddings then S - 1 tokens
    prefilled, the last token decoded at cache_len F + S - 1, against the
    full forward over the embeddings and all S tokens."""
    _, _, tm, cfg = pair("internvl2-76b", key=2)
    F, B, S = cfg.frontend_tokens, 2, 12
    t = torch.from_numpy(_tokens(cfg, (B, S)))
    pe = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, F, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        h, _ = tm.hidden(t, pe, mode="train")
        assert h.shape[1] == F + S
        full = tm.logits(h[:, -1:])
        cache = tm.init_cache(B, F + S, dtype=torch.float32)
        cache, _ = tm.prefill(t[:, :S - 1], cache, extra_embeds=pe)
        _, dec = tm.decode_step(t[:, S - 1:], cache, F + S - 1)
    assert float((full - dec).abs().max()) < DECODE_ATOL


@pytest.mark.parametrize("arch", ["whisper-base", "granite-moe-1b-a400m"])
def test_vocab_padding_masked(arch):
    """whisper (51,865 → 51,968) and granite (49,155 → 49,408) at full
    width pad their vocab; at the reduced width with the full vocab the
    pad logits are -1e30 after prefill and decode."""
    from repro_torch.models.transformer import padded_vocab

    full = treg.get_config(arch)
    assert padded_vocab(full) == {"whisper-base": 51968,
                                  "granite-moe-1b-a400m": 49408}[arch]
    _, _, tm, cfg = pair(arch, key=0, vocab_size=full.vocab_size)
    toks = torch.from_numpy(_tokens(cfg, (1, 6)))
    with torch.no_grad():
        c = tm.init_cache(1, 8, dtype=torch.float32)
        if cfg.encoder_layers:
            c, pre = tm.prefill(toks, c, torch.zeros(1, 4, cfg.d_model))
        else:
            c, pre = tm.prefill(toks, c)
        _, dec = tm.decode_step(toks[:, :1], c, 6)
    for lg in (pre, dec):
        assert lg.shape[-1] == padded_vocab(full)
        assert bool((lg[..., cfg.vocab_size:] == -1e30).all())
        assert bool((lg[..., :cfg.vocab_size] > -1e29).all())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-base",
                                  "granite-moe-1b-a400m"])
def test_remat_block_equals_none(arch):
    """Checkpointing recomputes the same forward (the encoder's and
    decoder's layers, the cycles of R and MoE blocks): loss and every
    gradient bit for bit."""
    cfg = treg.get_config(arch, reduced=True)
    batch = tdata.SyntheticLM(cfg, 2, 24, seed=2).batch_at(0)
    out = []
    for remat in ("none", "block"):
        model = tzoo.build_model(cfg, RunConfig(**{**RUN_KW,
                                                   "remat": remat})).init(3)
        params = tzoo.param_tree(model)
        flat = [p for leaf in topt.leaves(params) for p in topt.members(leaf)]
        model.requires_grad_(True)
        loss = tts.model_loss_fn(model, cfg)(model, batch)
        out.append((float(loss.detach()), torch.autograd.grad(loss, flat)))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-1.6b",
                                  "whisper-base"])
def test_steps_match_reference(arch):
    """Three whole steps of the reference's jitted step and the port's from
    the same state at weight decay 0: params, m, v and the step counters
    within STATE_ATOL, the stats too."""
    from repro.configs.base import RunConfig as JRun
    from repro.train import train_step as jts
    from repro.train.optimizer import OptConfig as JOpt

    jcfg, tcfg = _cfgs(arch)
    jstep, jinit, _ = jts.build_train_step(jcfg, JRun(**RUN_KW),
                                           JOpt(**OPT_KW, weight_decay=0.0))
    tstep, _, _ = tts.build_train_step(
        tcfg, RUN, topt.OptConfig(**OPT_KW, weight_decay=0.0), device="cpu")
    jstate = jinit(jax.random.key(4))
    tstate = tzoo.load_state(_np_tree(jstate), tcfg, RUN, "cpu")
    src = tdata.SyntheticLM(tcfg, 4, 32, seed=0)
    for i in range(3):
        b = src.batch_at(i)
        jstate, jstats = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        tstate, tstats = tstep(tstate, b)
        assert sorted(tstats) == sorted(jstats)
        for k in jstats:
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    atol = RWKV_STATE_ATOL if arch == "rwkv6-1.6b" else STATE_ATOL
    for path, g, w in _walk(tzoo.export_state(tstate), _np_tree(jstate)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        err = float(np.max(np.abs(g.astype(np.float64) - w))) if g.size \
            else 0.0
        assert err <= atol, (path, err)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_cross_package_resume_whisper(tmp_path, first):
    """The encoder-decoder's stacked train state crosses both ways: one
    package trains 2 steps and checkpoints, the other restores and trains
    one more, equal to the first's 3 straight steps within STATE_ATOL."""
    from repro.configs.base import RunConfig as JRun
    from repro.train import train_step as jts
    from repro.train.checkpoint import CheckpointManager as JManager
    from repro.train.optimizer import OptConfig as JOpt

    jcfg, tcfg = _cfgs("whisper-base")
    jstep, jinit, _ = jts.build_train_step(jcfg, JRun(**RUN_KW),
                                           JOpt(**OPT_KW, weight_decay=0.0))
    tstep, tinit, _ = tts.build_train_step(
        tcfg, RUN, topt.OptConfig(**OPT_KW, weight_decay=0.0), device="cpu")
    src = tdata.SyntheticLM(tcfg, 2, 16, seed=1)
    batches = [src.batch_at(i) for i in range(3)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    ck = str(tmp_path / "ck")
    if first == "reference":
        state = jinit(jax.random.key(5))
        for b in jb[:2]:
            state, _ = jstep(state, b)
        JManager(ck).save(2, state)
        state, _ = jstep(state, jb[2])
        want = _np_tree(state)
        step, tree = CheckpointManager(ck).restore()
        got, _ = tstep(tzoo.load_state(tree, tcfg, RUN, "cpu"), batches[2])
        got = tzoo.export_state(got)
    else:
        state = tinit(6)
        for b in batches[:2]:
            state, _ = tstep(state, b)
        CheckpointManager(ck).save(2, tzoo.export_state(state))
        state, _ = tstep(state, batches[2])
        want = tzoo.export_state(state)
        step, got = JManager(ck).restore()
        got, _ = jstep(jax.tree.map(jnp.asarray, got), jb[2])
        got = _np_tree(got)
    assert step == 2
    for path, g, w in _walk(got, want):
        assert float(np.max(np.abs(np.asarray(g, np.float64) - w))) \
            <= STATE_ATOL, path


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(cls, cfg, n=5, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(4, 10))).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


@pytest.mark.parametrize("arch", STATEFUL)
def test_engine_batched_equals_alone(arch):
    """Counterpart of tests/test_runtime.py for the R, K and MoE decoders:
    5 requests through 2 slots — each slot's conv/h, shifts/state or K/V
    inserted by _insert_slot — equal each request served alone in a
    1-slot engine."""
    cfg = treg.get_config(arch, reduced=True)
    model = tzoo.build_model(cfg, RUN).init(0)
    reqs = _requests(teng.Request, cfg)
    eng = teng.ServeEngine(cfg, RUN, model, slots=2, max_len=48,
                           device="cpu")
    outs = {o.rid: o.tokens for o in eng.run_requests(reqs)}
    assert len(outs) == 5
    for rid in (0, 3):
        single = teng.ServeEngine(cfg, RUN, model, slots=1, max_len=48,
                                  device="cpu")
        ref = single.run_requests([teng.Request(
            rid=rid, prompt=reqs[rid].prompt, max_new_tokens=6)])
        assert outs[rid] == ref[0].tokens, rid


@pytest.mark.parametrize("arch", STATEFUL)
def test_engine_matches_reference_engine(arch):
    """The reference's ServeEngine and the port's on the same parameters
    and requests (7 requests, 3 slots, refills): equal greedy tokens and
    stats, every sampled step's top-2 gap above 2 · F32_ATOL."""
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JEngine

    jm, params, _, cfg = pair(arch, key=3)
    jcfg, _ = _cfgs(arch)
    jeng = JEngine(jcfg, RUN, params, slots=3, max_len=40)
    want = {o.rid: o.tokens for o in jeng.run_requests(
        _requests(JRequest, jcfg, n=7, max_new=8, seed=1))}
    eng = teng.ServeEngine(cfg, RUN, jax.tree.map(np.asarray, params),
                           slots=3, max_len=40, device="cpu")
    gaps = []
    sample = eng._sample

    def spy(logits, req, step):
        top = torch.topk(torch.as_tensor(logits).float(), 2).values
        gaps.append(float(top[0] - top[1]))
        return sample(logits, req, step)
    eng._sample = spy
    got = {o.rid: o.tokens for o in eng.run_requests(
        _requests(teng.Request, cfg, n=7, max_new=8, seed=1))}
    assert min(gaps) > 2 * F32_ATOL, min(gaps)
    assert got == want
    assert eng.stats == jeng.stats


def test_insert_slot_writes_every_state_kind():
    """_insert_slot puts a 1-batch cache of every kind — K/V, RG-LRU's
    conv and h, RWKV6's nested shifts and state — into its slot and
    leaves the other slots alone."""
    cfgs = [treg.get_config(a, reduced=True)
            for a in ("recurrentgemma-9b", "rwkv6-1.6b")]
    for cfg in cfgs:
        m = tzoo.build_model(cfg, RUN)
        full = m.init_cache(3, 10, torch.float32)
        one = m.init_cache(1, 10, torch.float32)
        leaves = []

        def fill(tree):
            for k, v in (tree.items() if isinstance(tree, dict)
                         else enumerate(tree)):
                if isinstance(v, torch.Tensor):
                    v.fill_(len(leaves) + 1.0)
                    leaves.append(v)
                else:
                    fill(v)
        fill(one)
        teng._insert_slot(full, one, 1)

        def check(tree, other):
            for k, v in (tree.items() if isinstance(tree, dict)
                         else enumerate(tree)):
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v[1], other[k][0])
                    assert not v[0].any() and not v[2].any()
                else:
                    check(v, other[k])
        check(full, one)
        assert {type(c) for c in full} == {dict}


def test_engine_and_cli_refuse_an_encoder_decoder():
    """ServeEngine and the serve CLI refuse whisper-base before serving:
    a request carries no enc_frames.  It is served through
    build_serve_fns (test_serve_fns_match_reference)."""
    from repro_torch.launch import serve as tserve

    cfg = treg.get_config("whisper-base", reduced=True)
    model = tzoo.build_model(cfg, RUN).init(0)
    with pytest.raises(ValueError, match="enc_frames.*build_serve_fns"):
        teng.ServeEngine(cfg, RUN, model, slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        tserve.main(["--arch", "whisper-base", "--reduced", "--device",
                     "cpu"])


def test_reference_engine_cannot_serve_an_encoder_decoder():
    """ROADMAP.md C: the reference's ServeEngine calls model.prefill(p, t,
    c) (repro/serve/engine.py:81-82), and EncDecLM.prefill needs
    enc_frames: its first request dies with a TypeError."""
    from repro.configs import registry as jreg
    from repro.configs.base import RunConfig as JRun
    from repro.models.model_zoo import build_model as jbuild
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JEngine

    jcfg = jreg.get_config("whisper-base", reduced=True)
    params = jbuild(jcfg, JRun(**RUN_KW)).init(jax.random.key(0))
    eng = JEngine(jcfg, JRun(**RUN_KW), params, slots=2, max_len=32)
    with pytest.raises(TypeError, match="enc_frames"):
        eng.run_requests([JRequest(rid=0, prompt=np.arange(5, dtype=np.int32),
                                   max_new_tokens=2)])


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_serve_fns_match_reference(arch):
    """build_serve_fns without a mesh, prefill with enc_frames (whisper)
    or patch_embeds (internvl2), then decode: the logits equal the
    reference's jitted serve functions' on the same parameters."""
    from repro.serve import serve_step as jss

    jm, params, _, cfg = pair(arch, key=5)
    jcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(4)
    B, S = 2, 9
    F = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = ({"enc_frames": rng.normal(size=(B, 6, cfg.d_model))}
             if cfg.encoder_layers else
             {"patch_embeds": rng.normal(size=(B, F, cfg.d_model))})
    extra = {k: v.astype(np.float32) for k, v in extra.items()}
    jf = jss.build_serve_fns(jcfg, RUN, max_len=F + 16, batch=B,
                             cache_dtype=jnp.float32)
    jc, jpre = jf["prefill"](params, jf["init_cache"](), {
        "tokens": jnp.asarray(toks[:, :S - 1]),
        **{k: jnp.asarray(v) for k, v in extra.items()}})
    _, jdec = jf["decode"](params, jc, jnp.asarray(toks[:, S - 1:]),
                           jnp.int32(F + S - 1))
    tf = build_serve_fns(cfg, RUN, max_len=F + 16, batch=B,
                         cache_dtype=torch.float32, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    tc, tpre = tf["prefill"](tree, tf["init_cache"](), {
        "tokens": toks[:, :S - 1], **extra})
    _, tdec = tf["decode"](tree, tc, toks[:, S - 1:], F + S - 1)
    v = cfg.vocab_size
    for g, w in ((tpre, jpre), (tdec, jdec)):
        np.testing.assert_allclose(_np(g)[..., :v], _np(w)[..., :v], rtol=0,
                                   atol=F32_ATOL)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_lm_train_then_serve(tmp_path):
    """Counterpart of tests/test_system.py::test_lm_train_then_serve with
    the port's CLIs: granite-moe reduced trained 12 steps with
    checkpoints, then its checkpoint served through --ckpt-dir."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    ck = str(tmp_path / "ck")
    losses = ttrain.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                          "--steps", "12", "--batch", "4", "--seq", "32",
                          "--ckpt-dir", ck, "--ckpt-every", "6",
                          "--log-every", "6", "--device", "cpu"])
    assert losses[-1] < losses[0]
    outs = tserve.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                        "--requests", "4", "--slots", "2", "--max-new", "4",
                        "--max-len", "48", "--prompt-len", "6",
                        "--ckpt-dir", ck, "--device", "cpu"])
    assert len(outs) == 4
    assert all(len(o.tokens) == 4 for o in outs)


def test_reference_trained_checkpoint_served_by_port(tmp_path, capsys):
    """granite-moe reduced trained by the reference's train CLI; the
    port's serve CLI serves its checkpoint with the reference serve CLI's
    tokens."""
    from repro.launch import serve as jserve
    from repro.launch import train as jtrain
    from repro_torch.launch import serve as tserve

    ck = str(tmp_path / "ck")
    jtrain.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--steps",
                 "6", "--batch", "4", "--seq", "32", "--ckpt-dir", ck,
                 "--ckpt-every", "3", "--log-every", "3"])
    argv = ["--arch", "granite-moe-1b-a400m", "--reduced", "--requests",
            "4", "--slots", "2", "--max-new", "5", "--max-len", "48",
            "--prompt-len", "6", "--ckpt-dir", ck]
    want = {o.rid: o.tokens for o in jserve.main(argv)}
    got = {o.rid: o.tokens for o in tserve.main(argv + ["--device", "cpu"])}
    assert "loaded params from" in capsys.readouterr().out
    assert got == want


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "whisper-base",
                                  "internvl2-76b"])
def test_train_cli_trains_every_family(tmp_path, arch):
    """``python -m repro_torch.launch.train --arch ... --reduced --device
    cpu`` for the K decoder, the encoder-decoder (enc_frames batches) and
    the vision frontend (patch_embeds): the reference CLI's parameter
    count, the loss falls."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--steps", "8", "--batch", "2", "--seq", "32",
         "--log-every", "4", "--device", "cpu"], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    cfg = treg.get_config(arch, reduced=True)
    n = tzoo.param_count(tzoo.build_model(cfg, RUN, "meta"))
    assert lines[0].endswith(f"params = {n:,}")
    first, last = lines[-1].split("(start ")
    assert float(first.split()[-1]) < float(last.rstrip(")"))
