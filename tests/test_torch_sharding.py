"""The port's sharding rules against the JAX package's, spec for spec, with
no ranks: ``param_specs``, ``state_specs`` (``opt_state_spec_from_param``),
``sanitize_spec``, ``cache_pspec`` and the cache shardings of
``serve_step``, for all ten registry archs at full width and reduced, on
meshes (16, 16), (2, 16, 16), (2, 2), (4, 1) and (1, 4), under
``sharding_mode`` fsdp and tp, ZeRO-1 on and off, ``seq_shard_decode`` on
and off, an encoder-decoder's prefilled cache included.

The reference's side needs no devices: its shapes come from
``jax.eval_shape`` and its mesh is a ``jax.sharding.AbstractMesh`` (its
rules read only ``mesh.shape``); the port's shapes come from the meta
device.  The reference stacks each ``cycles`` leaf (and an
encoder-decoder's ``encoder``/``decoder``/``dec``/``xkv`` leaves) as
``[n, ...]``; a port member's spec is the leaf's without the stack entry.
The exceptions, each asserted side by side with the reference's spec:

* the experts of a stacked MoE leaf, whose reference spec is written for
  ``[E, D, F]`` and lands on the stack axis (ROADMAP.md C);
* RG-LRU's ``conv`` state, which the reference's ``_cache_shardings``
  gives the KV rule (ROADMAP.md C);
* ZeRO-1 where the reference puts the data axis on the stack axis of a
  moment: a member has no stack axis, so its moment takes the same rule
  on its own dims (a difference by design: per-cycle placements).
"""
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

from repro_torch.configs import registry as treg
from repro_torch.configs.base import RunConfig
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import sharding as shd
from repro_torch.serve import serve_step as tserve
from repro_torch.train import train_step as tts

ARCHS = list(treg.ARCH_IDS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
BATCH, MAX_LEN = 8, 64


def _mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _rules(mesh, fsdp, zero1):
    from repro.models import sharding as jshd

    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return (jshd.Rules(dp_axes=dp, fsdp=fsdp, zero1=zero1),
            shd.Rules(dp_axes=dp, fsdp=fsdp, zero1=zero1))


def _t(spec):
    """A spec as a plain tuple of entries."""
    return tuple(spec)


def _get(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


_MODELS = {}


def _models(arch, reduced):
    """(reference train-state shapes, reference model, port meta model)."""
    key = (arch, reduced)
    if key not in _MODELS:
        from repro.configs import registry as jreg
        from repro.configs.base import RunConfig as JRun
        from repro.train import train_step as jts

        jcfg = jreg.get_config(arch, reduced=reduced)
        _, init, _ = jts.build_train_step(jcfg, JRun())
        shapes = jax.eval_shape(init, jax.random.key(0))
        from repro.models.model_zoo import build_model as jbuild

        _MODELS[key] = (shapes, jbuild(jcfg, JRun()),
                        tzoo.build_model(treg.get_config(arch, reduced),
                                         RunConfig(), "meta"))
    return _MODELS[key]


def _is_expert(path):
    return shd.is_expert("/".join(path))


def _check_member(path, stacked, got, ref, exceptions):
    """A member's spec against its reference leaf's without the stack
    entry; where that entry is not None, the pair is recorded in
    ``exceptions`` instead."""
    got, ref = _t(got), _t(ref)
    if not stacked:
        assert got == ref, (path, got, ref)
        return
    if ref and ref[0] is not None:
        exceptions.append(("/".join(path), ref, got))
        return
    assert got == ref[1:], (path, got, ref)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_reference(arch, reduced):
    from repro.models import sharding as jshd
    from repro.train import train_step as jts

    shapes, _, model = _models(arch, reduced)
    for mname in MESHES:
        mesh = _mesh(mname)
        for fsdp in (True, False):
            for zero1 in (True, False):
                jr, tr = _rules(mesh, fsdp, zero1)
                want = jts.state_specs(shapes, jr, mesh)
                got = tts.state_specs({"params": model}, tr, mesh)
                for path, p, idx in tzoo._layout(model):
                    stacked = idx is not None
                    ref_p = _get(want["params"], path)
                    got_p = _get(got["params"], path)
                    got_p = got_p[idx] if stacked else got_p
                    if stacked and _is_expert(path):
                        # the defect: the member takes the unstacked rule
                        assert _t(got_p) == _t(jshd.sanitize_spec(
                            jshd._leaf_spec("/".join(path), p.dim(), jr),
                            tuple(p.shape), mesh))
                    else:
                        _check_member(path, stacked, got_p, ref_p, [])
                    for k in ("m", "v"):
                        ref_m = _get(want["opt"][k], path)
                        got_m = _get(got["opt"][k], path)
                        got_m = got_m[idx] if stacked else got_m
                        mexc = []
                        if not _is_expert(path):
                            _check_member(path, stacked, got_m, ref_m, mexc)
                        if mexc or _is_expert(path):
                            # ZeRO-1 on the stack axis, or an expert: the
                            # member's own param spec under the same rule
                            assert zero1 or _is_expert(path), mexc
                            assert _t(got_m) == _t(
                                jshd.opt_state_spec_from_param(
                                    PartitionSpec(*got_p), jr,
                                    tuple(p.shape), mesh)), mexc
                assert _t(got["opt"]["step"]) == () == _t(want["opt"]["step"])
                assert _t(got["step"]) == () == _t(want["step"])


@pytest.mark.parametrize("arch,mesh_name,wi,wo", [
    ("granite-moe-1b-a400m", "16x16", ((None, "data", None),
                                       ("model", "data", None)),
     ((None, None, "data"), ("model", None, "data"))),
    ("dbrx-132b", "16x16", ((None, "data", None), ("model", "data", None)),
     ((None, None, "data"), ("model", None, "data"))),
])
def test_expert_specs_defect_side_by_side(arch, mesh_name, wi, wo):
    """The reference's expert specs land on the stacked leaf's cycle axis
    (``model``) and expert axis (``data``); the port's members shard the
    experts over ``model`` as intended."""
    from repro.models import sharding as jshd

    shapes, _, model = _models(arch, False)
    mesh = _mesh(mesh_name)
    jr, tr = _rules(mesh, True, True)
    want = jshd.param_specs(shapes["params"], jr, mesh)
    got = shd.param_specs(model, tr, mesh)
    for name, (ref_spec, port_spec) in (("wi", wi), ("wg", wi), ("wo", wo)):
        assert _t(want["cycles"]["0G"]["moe"][name]) == ref_spec
        assert all(_t(sp) == port_spec
                   for sp in got["cycles"]["0G"]["moe"][name])


def _ref_caches(arch, reduced, batch=BATCH):
    """The reference's cache shapes, and for an encoder-decoder its
    prefilled cache's too."""
    _, jmodel, _ = _models(arch, reduced)
    cache = jax.eval_shape(lambda: jmodel.init_cache(batch, MAX_LEN))
    if jmodel.cfg.encoder_layers == 0:
        return cache, None
    shapes = _models(arch, reduced)[0]["params"]
    toks = jax.ShapeDtypeStruct((batch, MAX_LEN - 1), jnp.int32)
    frames = jax.ShapeDtypeStruct((batch, MAX_LEN // 2, jmodel.cfg.d_model),
                                  jnp.bfloat16)
    full = jax.eval_shape(lambda p, c, t, f: jmodel.prefill(p, t, c, f)[0],
                          shapes, cache, toks, frames)
    return cache, full


def _port_caches(model, batch=BATCH):
    cache = model.init_cache(batch, MAX_LEN)
    if not isinstance(model, tzoo.EncDecLM):
        return cache, None
    cfg = model.cfg
    xkv = jax_free_empty((batch, MAX_LEN // 2, cfg.num_heads,
                          cfg.resolved_head_dim()))
    return cache, {"dec": cache["dec"],
                   "xkv": [{"k": xkv, "v": xkv} for _ in model.decoder]}


def jax_free_empty(shape):
    import torch

    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def _ref_cache_specs(cache, mesh, jr, seq, monkeypatch):
    from repro.serve import serve_step as jserve

    monkeypatch.setattr(jserve, "NamedSharding", lambda m, sp: sp)
    return jserve._cache_shardings(cache, mesh, jr, seq)


def _heads_kept(model, path, t, mesh, seq):
    """Whether the port keeps a KV cache's kv heads split over the model
    axis where the reference replicates them: an MHA decoder's cache
    (every query head its own kv head) whose heads do not divide the axis
    while their flat width does, so that its kv projections hold whole
    heads a rank and the cache follows them (ROADMAP C.6)."""
    cfg = model.cfg
    ranks = shd.mesh_shape(mesh).get("model", 1)
    return (not seq and t.dim() == 4 and path.split("/")[-1] in ("k", "v")
            and cfg.num_kv_heads == cfg.num_heads == t.shape[2]
            and t.shape[2] % ranks != 0
            and t.shape[2] * t.shape[3] % ranks == 0)


def _check_caches(arch, reduced, mesh_name, seq, monkeypatch, batch=BATCH):
    _, _, model = _models(arch, reduced)
    mesh = _mesh(mesh_name)
    jr, tr = _rules(mesh, True, False)
    exc = []
    for ref_cache, port_cache in zip(_ref_caches(arch, reduced, batch),
                                     _port_caches(model, batch)):
        if ref_cache is None:
            continue
        want = _ref_cache_specs(ref_cache, mesh, jr, seq, monkeypatch)
        got = tserve.cache_specs(model, port_cache, tr, mesh, seq)
        for (path, stacked, node, key), (_, _, gnode, gkey) in zip(
                tserve._cache_paths(model, port_cache),
                tserve._cache_paths(model, got)):
            got_sp = gnode[gkey]
            ref_sp = _get(want, path.split("/"))
            if path.endswith("/conv"):
                # the defect: the batch over dp, as the intended rule
                assert _t(got_sp) == _t(shd.sanitize_spec(
                    shd.P(tr.dp, None, None), node[key].shape, mesh))
                if _t(got_sp) != _t(ref_sp)[int(stacked):]:
                    exc.append((path, _t(ref_sp), _t(got_sp)))
                continue
            if _heads_kept(model, path, node[key], mesh, seq):
                # by design: the reference replicates these kv heads
                assert _t(got_sp)[2] == "model", (path, got_sp)
                got_sp = shd.P(*_t(got_sp)[:2], None, *_t(got_sp)[3:])
            strict = []
            _check_member(path.split("/"), stacked, got_sp, ref_sp, strict)
            assert not strict, strict
    return exc


@pytest.mark.parametrize("seq", [False, True], ids=["heads", "seq"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, reduced, seq, monkeypatch):
    for mesh_name in MESHES:
        exc = _check_caches(arch, reduced, mesh_name, seq, monkeypatch)
        assert not exc or arch == "recurrentgemma-9b", exc


def test_conv_cache_defect_side_by_side(monkeypatch):
    """recurrentgemma-9b's stacked ``cycles/0R/conv`` (12, 8, 3, 4096) on a
    (4, 2) mesh: the reference's rule shards the cycle axis over data (the
    path ends in ``v``, the KV rule); the port shards the batch, as the
    ``h`` beside it."""
    from repro.serve import serve_step as jserve

    MESHES["4x2"] = ((4, 2), ("data", "model"))
    try:
        ref_cache, _ = _ref_caches("recurrentgemma-9b", False)
        mesh = _mesh("4x2")
        jr, tr = _rules(mesh, True, False)
        monkeypatch.setattr(jserve, "NamedSharding", lambda m, sp: sp)
        want = jserve._cache_shardings(ref_cache, mesh, jr, False)
        assert ref_cache["cycles"]["0R"]["conv"].shape == (12, 8, 3, 4096)
        assert _t(want["cycles"]["0R"]["conv"]) == ("data", None, None, None)
        assert _t(want["cycles"]["0R"]["h"]) == (None, "data", None)
        _, _, model = _models("recurrentgemma-9b", False)
        port_cache, _ = _port_caches(model)
        got = tserve.cache_specs(model, port_cache, tr, mesh)
        assert all(_t(c["conv"]) == ("data", None, None)
                   for c in got if "conv" in c)
        exc = _check_caches("recurrentgemma-9b", False, "4x2", False,
                            monkeypatch)
        assert exc and all(p.endswith("/conv") for p, _, _ in exc)
    finally:
        del MESHES["4x2"]


@pytest.mark.parametrize("ndim", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_cache_pspec_matches_reference(ndim, seq, mesh_name):
    from repro.serve import serve_step as jserve

    mesh = _mesh(mesh_name)
    jr, tr = _rules(mesh, True, False)
    assert _t(tserve.cache_pspec("x", ndim, tr, seq)) == \
        _t(jserve.cache_pspec("x", ndim, jr, seq))


SPECS = [(None, "data"), ("model", None), (("pod", "data"), "model"),
         ("data", "model", None), (None, None, "data"), ("pod", None),
         ("gone", "model"), ()]
SHAPES = [(32, 48), (6, 16), (16, 3, 8), (2, 7, 64), (64,)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sanitize_and_opt_state_spec_match_reference(mesh_name):
    from repro.models import sharding as jshd

    mesh = _mesh(mesh_name)
    for spec in SPECS:
        for shape in SHAPES:
            want = jshd.sanitize_spec(PartitionSpec(*spec), shape, mesh)
            got = shd.sanitize_spec(shd.P(*spec), shape, mesh)
            assert _t(got) == _t(want), (spec, shape)
            if len(spec) > len(shape):
                continue
            for zero1 in (True, False):
                jr, tr = _rules(mesh, True, zero1)
                assert _t(shd.opt_state_spec_from_param(
                    got, tr, shape, mesh)) == _t(
                    jshd.opt_state_spec_from_param(want, jr, shape, mesh))


def test_placements_of_a_spec():
    """A spec's placements on a named mesh: Shard(i) where entry i names
    the mesh dim (both dims of a tuple entry), Replicate elsewhere and on
    a dim of size 1; an entry out of the mesh's order raises."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 2, "model": 4}

    got = shd.placements(shd.P(("pod", "data"), None, "model"), Mesh())
    assert got == [Shard(0), Shard(0), Shard(2)]
    assert shd.placements(shd.P(None, "data"), Mesh()) == \
        [Replicate(), Shard(1), Replicate()]
    Mesh.shape = {"pod": 1, "data": 2, "model": 1}
    assert shd.placements(shd.P(("pod", "data"), None, "model"), Mesh()) \
        == [Replicate(), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="order"):
        shd.placements(shd.P(("data", "pod")), Mesh())
    with pytest.raises(ValueError, match="twice"):
        shd.placements(shd.P("data", "data"), Mesh())
