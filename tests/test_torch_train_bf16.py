"""Whole bfloat16 train steps of the port (``train_step.build_train_step``
on ``device="cpu"``) held against the JAX package's jitted step on the
CPU, at the ``train_4k`` cell's RunConfig from each package's
``registry.default_run_config`` (microbatch 2, remat "block", compute
dtype bfloat16) with the sequence cut to 64 (so the chunks are 64), on
reduced qwen3-1.7b and granite-moe-1b-a400m, weight decay 0, from the
reference's ``init_state(jax.random.key(k))`` carried across by
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

A bfloat16 job failed at step 5 and resumed from its step-4 checkpoint
equals 10 straight steps bit for bit on the CPU, every leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
OPT_KW = dict(lr=1e-3, warmup_steps=2, decay_steps=100, weight_decay=0.0)
ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m"]
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
        ("bfloat16", 2, "block", SEQ)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_steps_match_reference(arch):
    """Three whole bfloat16 steps of the reference's jitted step and the
    port's from the same state: each loss within LOSS_ATOL, the final
    state within STATE_REL of each leaf's scale (by kind: params, m, v)
    and the params within PARAM_ATOL."""
    from repro.configs import registry as jreg
    from repro.train import train_step as jts
    from repro.train.optimizer import OptConfig as JOpt

    jrun, trun = _runs(arch)
    jcfg = jreg.get_config(arch, reduced=True)
    tcfg = treg.get_config(arch, reduced=True)
    jstep, jinit, _ = jts.build_train_step(jcfg, jrun, JOpt(**OPT_KW))
    tstep, _, _ = tts.build_train_step(tcfg, trun, topt.OptConfig(**OPT_KW),
                                       device="cpu")
    jstate = jinit(jax.random.key(4))
    tstate = tzoo.load_state(_np_tree(jstate), tcfg, trun, "cpu")
    src = tdata.SyntheticLM(tcfg, BATCH, SEQ, seed=0)
    for i in range(3):
        b = src.batch_at(i)
        jstate, jstats = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        tstate, tstats = tstep(tstate, b)
        assert abs(float(tstats["loss"]) - float(jstats["loss"])) \
            <= LOSS_ATOL, (i, float(tstats["loss"]), float(jstats["loss"]))
    for path, g, w in _walk(tzoo.export_state(tstate), _np_tree(jstate)):
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
        assert err <= STATE_REL[kind] * scale, (path, err / scale)
        if path.startswith("/params"):
            assert err <= PARAM_ATOL, (path, err)


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
