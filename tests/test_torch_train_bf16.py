"""Whole bfloat16 train steps of the port (``train_step.build_train_step``
on ``device="cpu"``) held against the JAX package's jitted step on the
CPU, at the ``train_4k`` cell's RunConfig from each package's
``registry.default_run_config`` (microbatch 2, 4 for dbrx-132b and
internvl2-76b, remat "block", compute dtype bfloat16) with the sequence
cut to 64 (so the chunks are 64), on all ten reduced archs (whisper-base
with its encoder frames, internvl2-76b with its patch embeddings, from
``SyntheticLM``), weight decay 0, from the reference's
``init_state(jax.random.key(k))`` carried across by
``model_zoo.load_state``.  Tolerances:

* each step's loss within ``LOSS_ATOL = 1e-3``
  (tests/test_torch_train_grads.py's bfloat16 bound; measured up to
  5.1e-4, granite-moe);
* after three steps, every float leaf of the train state within
  ``STATE_REL`` of its largest magnitude: the params and the first
  moments within 5e-2, the gradient bound of
  tests/test_torch_train_grads.py (measured up to 2.3e-2 and 2.8e-2,
  granite-moe), the second moments within 1e-1, twice that, as a second
  moment squares its gradient (measured up to 4.1e-2): both packages
  round the bfloat16 products in other places, so gradients differ by
  up to ~2e-2 of their scale; the params also within ``PARAM_ATOL =
  6e-3`` absolute (measured up to 3.8e-3): Adam moves an entry by about
  lr = 1e-3 a step whatever its gradient's size, so an entry whose
  gradient is rounding noise can move the other way in each of the three
  steps; the step counters equal.  qwen3-1.7b measured within 1.5e-4,
  1.3e-2 and 1.4e-3 of these.

Beyond those bounds, two named exceptions, each shown where it applies:

* a MoE arch's loss beyond ``LOSS_ATOL`` at a step, within
  ``FLIP_LOSS_ATOL = 3e-3`` (dbrx-132b's third step measured 2.23e-3):
  each step's forward on the reference's parameters, run by both
  packages, must route a token otherwise only at a near tie
  (``numerics.router_flips``: 2 ulps of the row's largest router logit
  at the first differing layer), at most 1 in 32 tokens, with at least
  one such flip up to that step; and the three steps run again with the
  reference's router logits forced onto the port's (their values, the
  port's gradient: ``_ref_router.forcing_router``) must hold every loss
  to ``LOSS_ATOL`` and the state to the bounds above (dbrx-132b:
  1.0e-4, 9.4e-5, 2.6e-4: the flips in the first two steps' forwards,
  at 0.75, 0.16 and 0.25 ulps, moved the experts' weights, and the third
  step's loss with them);
* ``LEAF_REL``: rwkv6-1.6b's first moment of ``u`` within 0.12 of its
  scale (measured 0.094; ROADMAP C.10), the noisiest of rwkv6's first
  moments in bfloat16 in both packages.  The second witness is asserted
  beside it: the
  float32 state after the same steps (the two packages within 1.3e-5 of
  its scale there) lies nearer the port's bfloat16 state (0.117) than
  the reference's (0.145; compiled without XLA's excess precision, 0.219).

The RG-LRU gates, the router's logits, RWKV6's decay LoRA and the loss's
logits are products whose result the reference casts to float32 at
once; rounded to bfloat16 first, recurrentgemma-9b's state lay 0.073
(first moments) and 0.148 (second moments) of a leaf's scale from the
reference's, beyond STATE_REL and 8x the reference's own bfloat16 error
there (ROADMAP C.9); taken in float32, 0.025 and 0.058.

A bfloat16 job failed at step 5 and resumed from its step-4 checkpoint
equals 10 straight steps bit for bit on the CPU, every leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ref_router import forcing_router, record_reference_router
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.models import model_zoo as tzoo
from repro_torch.runtime.ft import (FailureInjector, FaultTolerantLoop,
                                    SimulatedFailure)
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train.checkpoint import CheckpointManager

LOSS_ATOL = 1e-3
STATE_REL = {"params": 5e-2, "m": 5e-2, "v": 1e-1}
PARAM_ATOL = 6e-3
FLIP_LOSS_ATOL = 3e-3
LEAF_REL = {("rwkv6-1.6b", "/opt/m/cycles/0K/rwkv/tmix/u"): 0.12}   # C.10
OPT_KW = dict(lr=1e-3, warmup_steps=2, decay_steps=100, weight_decay=0.0)
ARCHS = list(treg.ARCH_IDS)
MICROBATCH = {"dbrx-132b": 4, "internvl2-76b": 4}   # the others 2
SEQ = 64
BATCH = 4


def _runs(arch):
    """The train_4k cell's RunConfig in each package at SEQ, bfloat16."""
    from repro.configs import registry as jreg
    from repro.configs.base import SHAPE_CELLS as JCELLS

    t = treg.default_run_config(
        arch, dataclasses.replace(SHAPE_CELLS["train_4k"], seq_len=SEQ))
    j = jreg.default_run_config(
        arch, dataclasses.replace(JCELLS["train_4k"], seq_len=SEQ))
    assert (t.compute_dtype, t.microbatch, t.remat, t.q_chunk) == \
        ("bfloat16", MICROBATCH.get(arch, 2), "block", SEQ)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return j, t


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


def _ref_steps(arch, jcfg, jrun, batches, key=4):
    """The reference's jitted step from ``init_state(key)`` over
    ``batches``: (the states before each step and after the last, as
    numpy trees; the losses)."""
    from repro.train import train_step as jts
    from repro.train.optimizer import OptConfig as JOpt

    jstep, jinit, _ = jts.build_train_step(jcfg, jrun, JOpt(**OPT_KW))
    state = jinit(jax.random.key(key))
    states, losses = [_np_tree(state)], []
    for b in batches:
        state, stats = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(_np_tree(state))
        losses.append(float(stats["loss"]))
    return states, losses


def _step_flips(jcfg, jrun, tcfg, trun, params, batch, monkeypatch):
    """(router_flips of each microbatch's full forward on ``params`` (the
    reference's, before a step) run by both packages, the reference's
    router logits of those forwards in call order)."""
    from repro.models.model_zoo import build_model as jbuild

    from repro_torch.models import moe as tmoe
    from repro_torch.models import numerics

    jm = jbuild(jcfg, jrun)
    tm = tzoo.load_params(tzoo.build_model(tcfg, trun), params)
    n, out, logs = trun.microbatch, [], []
    rows = BATCH // n
    for i in range(n):
        toks = batch["tokens"][i * rows:(i + 1) * rows]
        with monkeypatch.context() as mp:
            ref = record_reference_router(mp)
            jm.hidden(jax.tree.map(jnp.asarray, params), jnp.asarray(toks),
                      mode="train")
        with tmoe.recording_router_logits() as log, torch.no_grad():
            tm.hidden(torch.from_numpy(toks), mode="train")
        out.append(numerics.router_flips(list(ref), log,
                                         tcfg.experts_per_token))
        logs += ref
    return out, logs


def _port_steps(tcfg, trun, state, batches, monkeypatch, forced=None):
    """The port's step from the reference's numpy ``state`` over
    ``batches``: (its final state exported, the losses, and where
    ``forced`` gives each step's reference router logits, forced onto the
    port's router, the (nearest, second nearest) distance of each call's
    match)."""
    tstep, _, _ = tts.build_train_step(tcfg, trun, topt.OptConfig(**OPT_KW),
                                       device="cpu")
    tstate = tzoo.load_state(state, tcfg, trun, "cpu")
    losses, matches = [], []
    for i, b in enumerate(batches):
        with monkeypatch.context() as mp:
            if forced is not None:
                matches += forcing_router(mp, forced[i])
            tstate, tstats = tstep(tstate, b)
        losses.append(float(tstats["loss"]))
    return tzoo.export_state(tstate), losses, matches


def _check_state(arch, got, want):
    """Every leaf of ``got`` against ``want`` (numpy trees): ints equal,
    floats within STATE_REL of the leaf's scale by kind, or LEAF_REL
    where it names the leaf, and params within PARAM_ATOL.  Returns the
    LEAF_REL leaves' paths."""
    named = []
    for path, g, w in _walk(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if not g.size:
            continue
        if w.dtype.kind in "iu":
            assert np.array_equal(g, w), path
            continue
        err = float(np.max(np.abs(g.astype(np.float64) - w)))
        scale = max(float(np.max(np.abs(w))), 1e-30)
        parts = path.split("/")
        kind = parts[2] if parts[1] == "opt" else "params"
        rel = LEAF_REL.get((arch, path))
        if rel is not None:
            named.append(path)
        assert err <= (rel or STATE_REL[kind]) * scale, (path, err / scale)
        if path.startswith("/params"):
            assert err <= PARAM_ATOL, (path, err)
    return named


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_steps_match_reference(arch, monkeypatch):
    """Three whole bfloat16 steps of the reference's jitted step and the
    port's from the same state: each loss within LOSS_ATOL, the final
    state within STATE_REL of each leaf's scale (by kind: params, m, v)
    and the params within PARAM_ATOL; beyond them only a MoE loss that the
    reference's routing, forced onto the port, brings within LOSS_ATOL,
    and the LEAF_REL leaf with its witness (module docstring)."""
    from repro.configs import registry as jreg

    from repro_torch.models import numerics

    jrun, trun = _runs(arch)
    jcfg = jreg.get_config(arch, reduced=True)
    tcfg = treg.get_config(arch, reduced=True)
    src = tdata.SyntheticLM(tcfg, BATCH, SEQ, seed=0)
    batches = [src.batch_at(i) for i in range(3)]
    jstates, jlosses = _ref_steps(arch, jcfg, jrun, batches)
    tstate, tlosses, _ = _port_steps(tcfg, trun, jstates[0], batches,
                                     monkeypatch)
    diffs = [abs(t - j) for t, j in zip(tlosses, jlosses)]
    off = [i for i, d in enumerate(diffs) if d > LOSS_ATOL]
    if off:
        assert tcfg.moe and max(diffs) <= FLIP_LOSS_ATOL, \
            (tlosses, jlosses)
        flips, logs = zip(*[_step_flips(jcfg, jrun, tcfg, trun,
                                        jstates[i]["params"], b, monkeypatch)
                            for i, b in enumerate(batches)])
        for i, step in enumerate(flips):
            first = [f for f in step if f["layer"] is not None]
            assert all(f["near_ties"] for f in first) \
                and sum(len(f["tokens"]) for f in first) \
                <= numerics.MAX_FLIP_SHARE * batches[i]["tokens"].size, \
                (i, step)
        assert any(f["layer"] is not None
                   for step in flips[:max(off) + 1] for f in step), \
            (diffs, flips)
        forced, flosses, matches = _port_steps(tcfg, trun, jstates[0],
                                               batches, monkeypatch, logs)
        assert all(near < 0.25 * second for near, second in matches), \
            matches
        assert all(abs(t - j) <= LOSS_ATOL
                   for t, j in zip(flosses, jlosses)), (flosses, jlosses)
        _check_state(arch, forced, jstates[-1])
    named = _check_state(arch, tstate, jstates[-1])
    if named:
        f32 = dataclasses.replace(jrun, compute_dtype="float32")
        w32 = {p: w for p, w, _ in _walk(
            _ref_steps(arch, jcfg, f32, batches)[0][-1], jstates[-1])}
        got = {p: g for p, g, _ in _walk(tstate, jstates[-1])}
        for path, w, _ in _walk(jstates[-1], jstates[-1]):
            if path in named:
                w32p = w32[path].astype(np.float64)
                assert np.max(np.abs(got[path] - w32p)) \
                    <= np.max(np.abs(w - w32p)), path


def test_bf16_resume_bit_for_bit(tmp_path):
    """Reduced granite-moe in bfloat16 at the train_4k RunConfig: a job
    checkpointing every 2 steps, failed at step 5 and resumed from step
    4, equals 10 straight steps in every leaf of the train state, bit for
    bit."""
    arch = "granite-moe-1b-a400m"
    _, run = _runs(arch)
    cfg = treg.get_config(arch, reduced=True)
    step, init, _ = tts.build_train_step(cfg, run, topt.OptConfig(**OPT_KW),
                                         device="cpu")
    src = tdata.SyntheticLM(cfg, BATCH, SEQ, seed=0)
    batches = [src.batch_at(i) for i in range(10)]
    state = init(0)
    for b in batches:
        state, _ = step(state, b)
    straight = tzoo.export_state(state)

    ft = FaultTolerantLoop(CheckpointManager(str(tmp_path / "ck")),
                           save_every=2, on_preempt_save=False,
                           export=tzoo.export_state)
    inj = FailureInjector({5})

    def job():
        start, st = ft.resume_or_init(lambda: init(0))
        for s in range(start, 10):
            inj.check(s)
            st, _ = step(st, batches[s])
            ft.maybe_save(s + 1, st)
        return start, st

    with pytest.raises(SimulatedFailure):
        job()
    start, resumed = job()
    assert start == 4
    for path, g, w in _walk(tzoo.export_state(resumed), straight):
        assert g.dtype == w.dtype and g.shape == w.shape \
            and g.tobytes() == w.tobytes(), path
