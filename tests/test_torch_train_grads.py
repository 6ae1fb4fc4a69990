"""The port's loss and gradients (``LM.loss``, ``train_step.model_loss_fn``)
held against the JAX package's on the CPU, on the four dense reduced
configs, with the reference's ``LM.init(jax.random.key(k))`` parameters
carried across by ``model_zoo.load_params``.  Tolerances:

* float32: the loss within ``1e-5`` (measured up to 4.8e-7), each
  gradient leaf within ``1e-5`` of its largest magnitude (measured up to
  1.9e-6: other orders of summation in the matmuls and attention);
* bfloat16: the loss within ``1e-3`` (measured up to 2.4e-4), each leaf
  within ``5e-2`` of its largest magnitude (measured up to 1.8e-2: the
  two packages round bf16 products in other places);
* remat "block" against "none" in the port: ``torch.equal``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPE_CELLS, RunConfig
from repro_torch.models import model_zoo as tzoo
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

DENSE = ["qwen3-1.7b", "gemma2-2b", "deepseek-7b", "qwen3-14b"]
LOSS_ATOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_REL = {"float32": 1e-5, "bfloat16": 5e-2}


def _run(dtype="float32", **kw):
    return dict(remat="none", q_chunk=16, kv_chunk=16, loss_chunk=16,
                compute_dtype=dtype, **kw)


def _configs(arch):
    from repro.configs import registry as jreg

    return jreg.get_config(arch, reduced=True), treg.get_config(arch,
                                                                reduced=True)


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


def _port_grads(model, cfg, batch):
    """(loss, gradients as the reference's stacked numpy tree)."""
    params = tzoo.param_tree(model)
    flat = [p for leaf in topt.leaves(params) for p in topt.members(leaf)]
    model.requires_grad_(True)
    loss = tts.model_loss_fn(model, cfg)(model, batch)
    grads = iter(torch.autograd.grad(loss, flat))
    return float(loss.detach()), tzoo._numpy(
        topt.member_map(lambda _: next(grads), params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch, dtype):
    from repro.configs.base import RunConfig as JRun
    from repro.models.model_zoo import build_model as jbuild
    from repro.train import train_step as jts

    jcfg, tcfg = _configs(arch)
    jm = jbuild(jcfg, JRun(**_run(dtype)))
    params = jm.init(jax.random.key(0))
    batch = tdata.SyntheticLM(tcfg, 2, 40, seed=1).batch_at(0)
    jl, jg = jax.jit(jax.value_and_grad(jts.model_loss_fn(jm, jcfg)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tzoo.load_params(tzoo.build_model(tcfg, RunConfig(**_run(dtype))),
                          _np_tree(params))
    tl, tg = _port_grads(tm, tcfg, batch)
    assert abs(tl - float(jl)) <= LOSS_ATOL[dtype]
    for path, g, w in _walk(tg, jax.tree.map(
            lambda x: np.asarray(x, np.float32), jg)):
        scale = float(np.max(np.abs(w)))
        assert scale > 0, path
        assert float(np.max(np.abs(g - w))) <= GRAD_REL[dtype] * scale, path


@pytest.mark.parametrize("arch", DENSE)
def test_remat_block_equals_none(arch):
    """Checkpointing each cycle recomputes the same forward: loss and every
    gradient bit for bit, the tail included (3 layers of gemma2's "LG"
    leave one in the tail)."""
    _, cfg = _configs(arch)
    if arch == "gemma2-2b":
        cfg = dataclasses.replace(cfg, num_layers=3)
    batch = tdata.SyntheticLM(cfg, 2, 40, seed=2).batch_at(0)
    out = []
    for remat in ("none", "block"):
        model = tzoo.build_model(cfg, RunConfig(**{**_run(), "remat": remat}))
        out.append(_port_grads(model.init(3), cfg, batch))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    for path, a, b in _walk(g1, g0):
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("arch", DENSE)
def test_arch_smoke_forward_and_grad(arch):
    """Counterpart of tests/test_models.py's smoke test for the dense
    archs: a finite loss and a positive finite gradient sum."""
    cfg = treg.get_config(arch, reduced=True)
    model = tzoo.build_model(cfg, RunConfig(**_run())).init(0)
    assert tzoo.param_count(model) > 0
    batch = treg.synthetic_batch(cfg, SHAPE_CELLS["train_4k"], batch=2,
                                 seq=32)
    loss, grads = _port_grads(model, cfg, batch)
    assert np.isfinite(loss), arch
    gn = sum(float(np.sum(np.abs(g))) for _, g, _ in _walk(grads, grads))
    assert np.isfinite(gn) and gn > 0, arch
