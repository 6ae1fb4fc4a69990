"""The language models over a device mesh: spawned gloo ranks on the CPU
(one launch per world size — 1, 2 and 4 — runs every case, each rank on
one torch thread), held against the port's mesh-free functions and the
JAX package's jitted single-device step.

* Train (reduced qwen3-1.7b under fsdp and tp, reduced granite-moe under
  fsdp; remat "block", ZeRO-1, weight decay 0): three whole steps on
  meshes (2, 2), (4, 1), (1, 4), (2, 1), (1, 2) and (1, 1) equal the
  mesh-free step and the reference's within ``rtol=2e-4, atol=2e-5`` (the
  reference's microbatch tolerance) — losses and every leaf of the
  state; every parameter and moment is a DTensor placed by its spec with
  the local shard's expected shape.  The same run twice, and a run failed
  after step 2 and resumed from its checkpoint, are equal bit for bit.
* Serve (reduced qwen3-1.7b — also under ``seq_shard_decode`` —,
  gemma2-2b, recurrentgemma-9b, rwkv6-1.6b, whisper-base with
  ``enc_frames``) on (2, 2): prefill and two decode steps within 1e-5 of
  the mesh-free ``build_serve_fns`` and of the reference's on the same
  parameters; every cache tensor placed by its spec.
* ``seq_sharded_decode_attention`` over 2 and 4 sequence shards within
  1e-6 of ``decode_attention``; the cache writes on shards equal to plain
  indexing.
* Elastic: (4, 1) -> (2, 2) through ``rescale_via_checkpoint`` and
  ``reshard``; the next loss within 1e-5 of continuing on (4, 1) (the
  reference's test allows 1e-3); the mesh checkpoint restores into the
  reference's ``CheckpointManager`` with the port's leaves.
* World 1: ``build_train_step`` and ``build_serve_fns`` take a (1, 1)
  mesh; ``make_cluster_mesh(1)`` works and a wider one raises, as does a
  mesh whose size is not the world's.
* Per-shard init (every mesh of worlds 1, 2 and 4): ``init_state`` of
  reduced deepseek-7b, qwen3-1.7b and gemma2-2b under fsdp and tp, ZeRO-1
  on and off, equals bit for bit, shard for shard and placement for
  placement, the whole ``init(seed)`` distributed; no tensor it makes is
  larger than the model's largest leaf.
* What ran whole on every rank of the model axis (ROADMAP C.5, C.6,
  C.7), on (1, 4): reduced rwkv6-1.6b (2 heads: each rank one head's
  half of the value columns, the output that split of the flat dim),
  reduced rwkv6 with 6 heads (``head_chunk``'s 2, 2, 2 and 0 a rank in
  its loop), reduced qwen3-1.7b with 6 query heads (their projections
  split by whole heads, 2, 2, 2 and 0 a rank) and reduced whisper-base
  with 6 (MHA: k, v and the cross-attention split so too) train three
  steps within ``TOL`` of the mesh-free step; a leaf split by whole heads
  holds its rank's heads (``_expected_heads``), and its per-shard init
  equals the whole init's shards bit for bit.  Decode with 6 heads on (1,
  4), qwen3 and whisper (its KV cache split on its heads), within
  ``SERVE_ATOL`` of the mesh-free port.

The JAX package is imported inside the tests only: the spawned ranks
import this module and need only torch.
"""
import dataclasses
import multiprocessing as mp
import os
import queue
import tempfile
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import registry as treg
from repro_torch.configs.base import RunConfig
from repro_torch.core.distributed import init_process_group
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import sharding as shd
from repro_torch.runtime import elastic
from repro_torch.serve import serve_step as tserve
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train.checkpoint import CheckpointManager

TOL = dict(rtol=2e-4, atol=2e-5)
SERVE_ATOL = 1e-5
FLASH_ATOL = 1e-6
ELASTIC_ATOL = 1e-5
LINEAR_ATOL = 1e-5      # float32 products of 8 terms, partial sums reduced
LSE_ATOL = 4e-6         # float32 at values up to ~16: two ulps
# rwkv6's state against the reference's (not against the port's mesh-free
# step, held to TOL): the port's mesh-free step itself ends 6.75e-5 from
# the reference's on one entry of tmix/wo, whose m and v agree within 2e-4
# of their size (the RWKV loop sums in another order than the reference's
# scan; tests/test_torch_families_lm.py's RWKV_STATE_ATOL is the same
# effect at another batch)
RWKV_REF_ATOL = 1e-4
OPT_KW = dict(lr=1e-3, warmup_steps=2, decay_steps=100, weight_decay=0.0)
SEED = 3
B, S, STEPS = 4, 16, 3
TRAIN = {"qwen-fsdp": ("qwen3-1.7b", "fsdp"),
         "qwen-tp": ("qwen3-1.7b", "tp"),
         "moe": ("granite-moe-1b-a400m", "fsdp")}
MESHES = {1: {"1x1": (1, 1)},
          2: {"2x1": (2, 1), "1x2": (1, 2)},
          4: {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}}
# (1, 4) only: (arch, sharding mode, config overrides); rwkv6's heads are
# its width's 64-wide slices
TRAIN_1X4 = {"rwkv": ("rwkv6-1.6b", "tp", {}),
             "heads6": ("qwen3-1.7b", "fsdp", {"num_heads": 6}),
             "rwkv-heads6": ("rwkv6-1.6b", "tp", {"num_heads": 6,
                                                   "num_kv_heads": 6,
                                                   "d_model": 384}),
             "whisper-heads6": ("whisper-base", "tp", {"num_heads": 6,
                                                       "num_kv_heads": 6}),
             "heads6-topk": ("qwen3-1.7b", "fsdp", {"num_heads": 6})}
# a case's gradient compression where it is not "none": top-k keeps an
# error-feedback residual a parameter, laid out as the parameter
TRAIN_COMPRESSION = {"heads6-topk": "topk"}
HEADS6 = {"num_heads": 6}
# decode with 6 query heads on (1, 4): (arch, overrides); whisper-base's
# are MHA, so its kv projections and its decode cache split by heads too
SERVE_HEADS6 = {"qwen3-1.7b": HEADS6,
                "whisper-base": {"num_heads": 6, "num_kv_heads": 6}}
INIT_ARCHS = ("deepseek-7b", "qwen3-1.7b", "gemma2-2b")
SERVE = ("qwen3-1.7b", "gemma2-2b", "recurrentgemma-9b", "rwkv6-1.6b",
         "whisper-base")
SERVE_B, PROMPT, DECODES, MAX_LEN = 2, 12, 2, 32
AXES = ("data", "model")


def _train_run(mode, compression="none"):
    return RunConfig(sharding_mode=mode, remat="block", q_chunk=16,
                     kv_chunk=16, loss_chunk=16, compute_dtype="float32",
                     grad_compression=compression)


def _case_run(name):
    """The RunConfig of a train case of TRAIN or TRAIN_1X4."""
    return _train_run(_train_config(name)[1],
                      TRAIN_COMPRESSION.get(name, "none"))


def _serve_run(seq_shard=False):
    return RunConfig(remat="none", q_chunk=16, kv_chunk=16,
                     compute_dtype="float32", seq_shard_decode=seq_shard)


def _batches(cfg, n=STEPS):
    src = tdata.SyntheticLM(cfg, B, S, seed=0)
    return [src.batch_at(i) for i in range(n)]


def _serve_inputs(cfg):
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size,
                        (SERVE_B, PROMPT + DECODES)).astype(np.int32)
    inputs = {"tokens": toks[:, :PROMPT]}
    if cfg.encoder_layers > 0:
        inputs["enc_frames"] = rng.normal(
            size=(SERVE_B, MAX_LEN // 2, cfg.d_model)).astype(np.float32)
    return inputs, toks[:, PROMPT:]


def _serve(fns, model, cfg):
    """Prefill logits, then each decode step's."""
    inputs, nxt = _serve_inputs(cfg)
    cache, logits = fns["prefill"](model, fns["init_cache"](), inputs)
    out = [logits]
    for t in range(DECODES):
        cache, logits = fns["decode"](model, cache,
                                      torch.from_numpy(nxt[:, t:t + 1]),
                                      PROMPT + t)
        out.append(logits)
    return [o.float().numpy() for o in out], cache


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _local_shape(shape, spec, mesh, heads=None):
    """The local shard's shape: the spec's split as DTensor makes it (an
    uneven one ``ceil(n / ranks)`` a rank, the last fewer or none), and
    along a dim of ``heads`` ``(dim, n)`` this rank's ``ceil(n /
    ranks)`` whole heads of the model axis."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    out = list(shape)
    for i, s in enumerate(tuple(spec)[:len(shape)]):
        for a in ((s,) if isinstance(s, str) else s or ()):
            ranks = mesh.size(names.index(a))
            c = -(-out[i] // ranks)
            out[i] = max(0, min(c, out[i] - coord[names.index(a)] * c))
    if heads is not None:
        dim, n = heads
        ranks = shd.axis_size(mesh, "model")
        c = -(-n // ranks)
        r = mesh.get_coordinate()[list(mesh.mesh_dim_names).index("model")]
        out[dim] = max(0, min(c, n - r * c)) * (shape[dim] // n)
    return tuple(out)


def _expected_heads(model, specs, mesh):
    """For each parameter of ``model`` in ``_flat(param_tree)``'s order,
    ``(dim, heads)`` where the model axis must split it by whole heads —
    an attention weight's flat heads dim (wq's and a cross-attention's
    columns, wo's rows; wk's and wv's where every query head has its own
    kv head) that the spec splits over the model axis, which the heads do
    not divide — else None."""
    cfg = model.cfg
    ranks = shd.axis_size(mesh, "model")
    paths = _flat(tzoo._tree_of(model, lambda path, p, idx: path))
    out = []
    for path, sp in zip(paths, specs):
        parent, last = path[-2], path[-1]
        dim = 0 if last == "wo" else 1
        grouped = (parent == "attn" and last in ("wk", "wv")
                   and cfg.num_kv_heads != cfg.num_heads)
        n = cfg.num_heads
        split = (parent in ("attn", "cross")
                 and last in ("wq", "wk", "wv", "wo") and not grouped
                 and len(sp) > dim and sp[dim] == "model" and n % ranks)
        out.append((dim, n) if split else None)
    return out


def _misplaced(tensors, specs, mesh, heads=None):
    """Every (tensor, spec) pair whose tensor is not a DTensor on ``mesh``
    with the spec's placements and local shape (``heads``: each tensor's
    split by whole heads, :func:`_expected_heads`)."""
    bad = []
    heads = heads or [None] * len(tensors)
    for t, sp, h in zip(tensors, specs, heads):
        if (not shd.is_dtensor(t) or t.device_mesh != mesh
                or list(t.placements) != shd.placements(sp, mesh)
                or tuple(t.to_local().shape)
                != _local_shape(t.shape, sp, mesh, h)
                or shd.heads_of(t) != h):
            bad.append((tuple(t.shape), sp))
    return bad


def _flat(tree):
    return [m for leaf in topt.leaves(tree) for m in topt.members(leaf)]


def _state_misplaced(state, specs, mesh):
    model = state["params"]
    heads = _expected_heads(model, _flat(specs["params"]), mesh)
    bad = _misplaced(_flat(tzoo.param_tree(model)), _flat(specs["params"]),
                     mesh, heads)
    for k in ("m", "v"):
        bad += _misplaced(_flat(state["opt"][k]), _flat(specs["opt"][k]),
                          mesh, heads)
    if "ef" in state:
        bad += _misplaced(_flat(state["ef"]["residual"]),
                          _flat(specs["ef"]["residual"]), mesh, heads)
    return bad


def _train_config(name, registry=treg):
    """(reduced config by ``registry``, the port's or the reference's,
    sharding mode) of a train case of TRAIN or TRAIN_1X4."""
    arch, mode, kw = TRAIN[name] + ({},) if name in TRAIN else \
        TRAIN_1X4[name]
    return dataclasses.replace(registry.get_config(arch, reduced=True),
                               **kw), mode


def _train_case(name, mesh, check_init=False):
    """Three steps of a train case: misplaced leaves, losses, the state,
    the most heads one call of the RWKV loop ran on this rank, and (with
    ``check_init``) the leaves whose per-shard init differs from the
    whole init's shards."""
    from repro_torch.models import rwkv6 as trwkv

    cfg, _ = _train_config(name)
    step, init, sh = tts.build_train_step(
        cfg, _case_run(name), topt.OptConfig(**OPT_KW), mesh=mesh,
        device="cpu")
    state = init(SEED)
    unequal = None
    if check_init:
        model = tzoo.build_model(cfg, _case_run(name), "cpu").init(SEED)
        want = sh["state"].place(tzoo.export_state(
            tts._fresh_state(model, False, "cpu"), host=False))
        unequal = [i for i, (a, b) in enumerate(zip(
            _flat(tzoo.param_tree(state["params"])),
            _flat(tzoo.param_tree(want["params"]))))
            if not _same_shards(a, b)]
    bad = _state_misplaced(state, sh["specs"], mesh)
    losses, looped = [], []
    loop = trwkv._wkv_loop

    def spy(r, *args):
        looped.append(r.shape[2])
        return loop(r, *args)
    trwkv._wkv_loop = spy
    try:
        for b in _batches(cfg):
            state, stats = step(state, b)
            losses.append(float(stats["loss"]))
    finally:
        trwkv._wkv_loop = loop
    bad += _state_misplaced(state, sh["specs"], mesh)
    return {"misplaced": bad, "losses": losses,
            "state": tzoo.export_state(state),
            "looped_heads": max(looped, default=0), "init_unequal": unequal}


def _resume_case(mesh, ckpt_dir, rank):
    """qwen-fsdp: two steps, a checkpoint, the state dropped (a failed
    job), the restore placed on the mesh, the third step."""
    cfg = treg.get_config("qwen3-1.7b", reduced=True)
    step, init, sh = tts.build_train_step(
        cfg, _train_run("fsdp"), topt.OptConfig(**OPT_KW), mesh=mesh,
        device="cpu")
    state = init(SEED)
    batches = _batches(cfg)
    for b in batches[:2]:
        state, _ = step(state, b)
    tree = tzoo.export_state(state)
    mgr = CheckpointManager(ckpt_dir)
    if rank == 0:
        mgr.save(2, tree)
    dist.barrier()
    del state
    _, state = mgr.restore(shardings=sh["state"])
    misplaced = _state_misplaced(state, sh["specs"], mesh)
    state, _ = step(state, batches[2])
    return {"state": tzoo.export_state(state), "misplaced": misplaced}


def _serve_case(arch, mesh, seq_shard=False, overrides=None):
    cfg = dataclasses.replace(treg.get_config(arch, reduced=True),
                              **(overrides or {}))
    run = _serve_run(seq_shard)
    fns = tserve.build_serve_fns(cfg, run, mesh=mesh, max_len=MAX_LEN,
                                 batch=SERVE_B, cache_dtype=torch.float32,
                                 device="cpu")
    model = tzoo.build_model(cfg, run, "cpu").init(SEED)
    logits, cache = _serve(fns, model, cfg)
    specs = tserve.cache_specs(model, cache, fns["rules"], mesh, seq_shard)
    tensors, want = [], []
    for _, _, node, key in tserve._cache_paths(model, cache):
        tensors.append(node[key])
    for _, _, node, key in tserve._cache_paths(model, specs):
        want.append(node[key])
    bad = _misplaced(tensors, want, mesh)
    pspecs = _flat(shd.param_specs(model, fns["rules"], mesh))
    bad += _misplaced(_flat(tzoo.param_tree(model)), pspecs, mesh,
                      _expected_heads(model, pspecs, mesh))
    return {"logits": logits, "misplaced": bad}


def _flash_case(mesh, axis):
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 1, 4, 16, generator=g)
    k = torch.randn(2, 32, 2, 16, generator=g)
    v = torch.randn(2, 32, 2, 16, generator=g)
    out = {}
    for cap in (None, 50.0):
        for cl in (torch.tensor([20, 32]), torch.tensor(7)):
            want = tlayers.decode_attention(q, k, v, cl, softcap=cap)
            kd = shd.distribute(k, shd.P(None, axis), mesh)
            vd = shd.distribute(v, shd.P(None, axis), mesh)
            got = tlayers.seq_sharded_decode_attention(q, kd, vd, cl, mesh,
                                                       axis, softcap=cap)
            out[(cap, cl.dim())] = float((got - want).abs().max())
    return out


def _write_case(meshes):
    """The cache writes on shards against plain indexing — a span, the
    rolling prefill's two spans, a decode's slots — under the placements a
    cache takes (kv heads, the sequence, the sequence over both axes):
    the count of elements that differ, by mesh and spec."""
    g = torch.Generator().manual_seed(7)
    buf0 = torch.randn(4, 8, 2, 3, generator=g)
    span = torch.randn(4, 5, 2, 3, generator=g)
    row = torch.randn(4, 2, 3, generator=g)
    slot = torch.tensor([0, 7, 3, 4])
    want = buf0.clone()
    want[:, 2:7] = span
    want[:, 6:8] = span[:, :2]
    want[:, 0:3] = span[:, 2:]
    want[torch.arange(4), slot] = row
    out = {}
    for mname, mesh in meshes.items():
        for spec in (shd.P("data", None, "model"), shd.P("data", "model"),
                     shd.P(None, ("data", "model"))):
            buf = shd.distribute(buf0, spec, mesh)
            shd.write_span_(buf, 2, shd.distribute(span, shd.P("data"), mesh))
            shd.write_span_(buf, 6, span[:, :2])
            shd.write_span_(buf, 0, span[:, 2:])
            shd.write_slots_(buf, slot, shd.distribute(
                row, shd.P(None, "model"), mesh))
            out[f"{mname} {spec!r}"] = int((buf.full_tensor() != want).sum())
    return out


# (x spec, w spec) of sharding.linear's cases on x [4, 6, 8], w [8, 16]:
# data parallel + column parallel (FSDP), row parallel (FSDP), x's
# contraction split against a whole w, a whole x against w's split rows,
# the two split over different axes, w's columns over both axes
LINEAR_SPECS = ((shd.P("data", None, None), shd.P("data", "model")),
                (shd.P("data", None, "model"), shd.P("model", "data")),
                (shd.P("data", None, "model"), shd.P(None, None)),
                (shd.P("data", None, None), shd.P("model", None)),
                (shd.P(None, None, "model"), shd.P("data", None)),
                (shd.P(None, None, None), shd.P(None, ("data", "model"))))
LSE_SPECS = (shd.P("data", None, "model"), shd.P(None, None, ("data", "model")),
             shd.P("data", "model", None), shd.P(None, None, None))


def _max_err(got, want):
    return float((got.full_tensor() - want).abs().max())


def _linear_case(meshes):
    """``sharding.linear`` against ``x @ w`` and its gradients under
    autograd, by mesh and (x spec, w spec): the largest differences."""
    g = torch.Generator().manual_seed(9)
    x0 = torch.randn(4, 6, 8, generator=g)
    w0 = torch.randn(8, 16, generator=g)
    dy = torch.randn(4, 6, 16, generator=g)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    want = x @ w
    gx, gw = torch.autograd.grad((want * dy).sum(), (x, w))
    out = {}
    for mname, mesh in meshes.items():
        for xs, ws in LINEAR_SPECS:
            xd = shd.distribute(x0, xs, mesh).requires_grad_()
            wd = shd.distribute(w0, ws, mesh).requires_grad_()
            y = shd.linear(xd, wd)
            loss = (y * shd.like(dy, y)).sum().full_tensor()
            dx, dw = torch.autograd.grad(loss, (xd, wd))
            out[(mname, repr(xs), repr(ws))] = (
                _max_err(y, want), _max_err(dx, gx), _max_err(dw, gw))
    return out


def _head_split_case(mesh):
    """A wo-like ``[96, 8]`` weight of 6 heads of 16 split by whole heads
    over the model axis of (1, 4): its local rows, its gather, an
    untagged copy's gather and box (each must raise), the copy's gather
    once ``keep_heads`` tags it, and ``heads_out`` of an output whole on
    the axis (narrowed to each rank's heads) and of one split on its
    heads, against the plain product."""
    from torch.distributed.tensor import Replicate, Shard

    g = torch.Generator().manual_seed(5)
    w0 = torch.randn(96, 8, generator=g)
    o0 = torch.randn(2, 3, 6, 16, generator=g)
    want = o0.reshape(2, 3, 96) @ w0
    w = shd.distribute_as(w0, [Replicate(), Shard(0)], mesh, (0, 6))
    lost = w * 1.0

    def err(a, b):
        return float((shd.full(a) - b).abs().max())
    out = {"local_rows": w.to_local().shape[0], "full": err(w, w0)}
    for name, fn in (("full", shd.full), ("box", shd.shard_box)):
        try:
            fn(lost)
            out[f"lost_{name}"] = None
        except ValueError as e:
            out[f"lost_{name}"] = str(e)
    out["kept"] = err(shd.keep_heads(lost, w), w0)      # tags lost itself
    for name, pl in (("whole", [Replicate(), Replicate()]),
                     ("split", [Replicate(), Shard(2)])):
        o = shd.distribute_as(o0, pl, mesh)
        out[f"out_{name}"] = err(shd.heads_out(o, w), want)
    return out


def _lse_case(meshes):
    """``sharding.logsumexp`` against ``torch.logsumexp`` over the last
    dim and its gradient, rows with -inf and -1e30 entries among them, by
    mesh and spec: the largest differences and whether the result keeps
    the input's splits but the last dim's."""
    from torch.distributed.tensor import Replicate

    g = torch.Generator().manual_seed(10)
    x0 = torch.randn(4, 6, 16, generator=g) * 4
    x0[0, 1, 3:] = -1e30
    x0[2, 0, :7] = float("-inf")
    w = torch.randn(4, 6, generator=g)
    x = x0.clone().requires_grad_()
    want = torch.logsumexp(x, dim=-1)
    gx, = torch.autograd.grad((want * w).sum(), x)
    out = {}
    for mname, mesh in meshes.items():
        for spec in LSE_SPECS:
            xd = shd.distribute(x0, spec, mesh).requires_grad_()
            lse = shd.logsumexp(xd)
            dx, = torch.autograd.grad(
                (lse * shd.like(w, lse)).sum().full_tensor(), xd)
            kept = [Replicate() if p.is_shard(2) else p
                    for p in xd.placements]
            out[(mname, repr(spec))] = (_max_err(lse, want),
                                        _max_err(dx, gx),
                                        list(lse.placements) == kept)
    return out


def _remat_thread_case(mesh):
    """Reduced granite-moe's loss under remat "block" over the mesh, its
    gradients taken on this thread and on a new one, where the mesh
    context is unset, as autograd runs a CUDA backward on a thread of its
    own: the largest difference of the gradients, or the error raised
    (the recompute's ``cns`` did nothing there: the expert grid came back
    whole, ``CheckpointError``)."""
    import threading

    cfg = treg.get_config("granite-moe-1b-a400m", reduced=True)
    run = _train_run("fsdp")
    rules = tts.default_rules(mesh, run)
    model = shd.distribute_model_(
        tzoo.build_model(cfg, run, "cpu").init(SEED), mesh, rules)
    model.requires_grad_(True)
    params = list(model.parameters())
    batch = _batches(cfg, 1)[0]

    def loss():
        b = {k: shd.distribute(torch.as_tensor(v), shd.P(rules.dp), mesh)
             for k, v in batch.items()}
        with torch.enable_grad():
            return model.loss(b["tokens"], b["labels"])

    out = {}
    with shd.use_mesh(mesh, rules):             # as build_train_step's
        here = torch.autograd.grad(loss(), params)
        other = loss()

        def backward():
            # the card's autograd thread inherits the caller's implicit
            # replication, not its context variables
            from torch.distributed.tensor.experimental import \
                implicit_replication
            try:
                with implicit_replication():
                    out["grads"] = torch.autograd.grad(other, params)
            except Exception as e:              # reported to the test
                out["error"] = repr(e)[:500]
        t = threading.Thread(target=backward)
        t.start()
        t.join()
    if "error" in out:
        return out["error"]
    return max(float((a.full_tensor() - b.full_tensor()).abs().max())
               for a, b in zip(out["grads"], here))


class _LargestTensor:
    """A dispatch-mode spy: the bytes of the largest tensor an op makes
    while it is on (a DTensor's local shard; meta tensors aside)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        spy = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in torch.utils._pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        t = t.to_local() if shd.is_dtensor(t) else t
                        if t.device.type != "meta":
                            spy.largest = max(spy.largest, t.numel()
                                              * t.element_size())
                return out
        self.largest, self.mode = 0, Mode()


def _same_shards(a, b):
    """Two DTensors with equal placements and bit-equal local shards."""
    return (list(a.placements) == list(b.placements)
            and a.to_local().dtype == b.to_local().dtype
            and torch.equal(a.to_local().view(torch.int32),
                            b.to_local().view(torch.int32)))


def _init_case(meshes):
    """``init_state`` over each mesh against the whole ``init(seed)``
    distributed (the path it replaced), by (mesh, arch, mode, zero1):
    the leaves (parameters, m, v) whose shards differ, their count, the
    largest tensor the per-shard init made and the model's largest
    leaf, in bytes."""
    out = {}
    wholes = {}
    for mname, mesh in meshes.items():
        for arch in INIT_ARCHS:
            cfg = treg.get_config(arch, reduced=True)
            if arch not in wholes:
                model = tzoo.build_model(cfg, _train_run("fsdp"),
                                         "cpu").init(SEED)
                wholes[arch] = tzoo.export_state(
                    tts._fresh_state(model, False, "cpu"), host=False)
            for mode in ("fsdp", "tp"):
                for zero1 in (True, False):
                    run = dataclasses.replace(_train_run(mode), zero1=zero1)
                    _, init, sh = tts.build_train_step(
                        cfg, run, topt.OptConfig(**OPT_KW), mesh=mesh,
                        device="cpu")
                    spy = _LargestTensor()
                    with spy.mode:
                        state = init(SEED)
                    want = sh["state"].place(wholes[arch])
                    largest = max(p.numel() * p.element_size()
                                  for p in want["params"].parameters())
                    got_l = _flat(tzoo.param_tree(state["params"])) + \
                        _flat(state["opt"]["m"]) + _flat(state["opt"]["v"])
                    want_l = _flat(tzoo.param_tree(want["params"])) + \
                        _flat(want["opt"]["m"]) + _flat(want["opt"]["v"])
                    out[(mname, arch, mode, zero1)] = dict(
                        unequal=[i for i, (a, b) in enumerate(zip(
                            got_l, want_l)) if not _same_shards(a, b)],
                        leaves=(len(got_l), len(want_l)),
                        largest_made=spy.largest, largest_leaf=largest)
    return out


def _elastic_case(ckpt_dir, rank):
    cfg = treg.get_config("qwen3-1.7b", reduced=True)
    run = RunConfig(remat="none", q_chunk=16, kv_chunk=16, loss_chunk=16,
                    compute_dtype="float32")
    mesh_a = tmesh.make_mesh((4, 1), AXES, device="cpu")
    mesh_b = tmesh.make_mesh((2, 2), AXES, device="cpu")
    opt_cfg = topt.OptConfig(**OPT_KW)
    step_a, init, sh_a = tts.build_train_step(cfg, run, opt_cfg,
                                              mesh=mesh_a, device="cpu")
    step_b, _, sh_b = tts.build_train_step(cfg, run, opt_cfg, mesh=mesh_b,
                                           device="cpu")
    b0, b1 = _batches(cfg, 2)
    state, _ = step_a(init(SEED), b0)
    saved = tzoo.export_state(state)
    _, state_c = elastic.rescale_via_checkpoint(
        CheckpointManager(ckpt_dir), 1, state, sh_b["state"])
    state_r = elastic.reshard(state, sh_b["state"])
    bad = (_state_misplaced(state_c, sh_b["specs"], mesh_b)
           + _state_misplaced(state_r, sh_b["specs"], mesh_b))
    _, s_c = step_b(state_c, b1)
    _, s_r = step_b(state_r, b1)
    _, s_a = step_a(state, b1)
    return {"loss_a": float(s_a["loss"]), "loss_c": float(s_c["loss"]),
            "loss_r": float(s_r["loss"]), "misplaced": bad,
            "saved": saved if rank == 0 else None}


def _world1_cases():
    out = {}
    mesh = tmesh.make_mesh((1, 1), AXES, device="cpu")
    cfg = treg.get_config("qwen3-1.7b", reduced=True)
    run = _serve_run()
    fns = tserve.build_serve_fns(cfg, run, mesh=mesh, max_len=MAX_LEN,
                                 batch=SERVE_B, cache_dtype=torch.float32,
                                 device="cpu")
    out["serve_shardings"] = fns["shardings"] is not None
    out["serve_logits"], _ = _serve(
        fns, tzoo.build_model(cfg, run, "cpu").init(SEED), cfg)
    out["cluster_axes"] = tmesh.make_cluster_mesh(1, "cpu").mesh_dim_names
    for name, fn in (("cluster2", lambda: tmesh.make_cluster_mesh(2, "cpu")),
                     ("mesh2", lambda: tmesh.make_mesh((2, 1), AXES, "cpu"))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _worker(rank, world, init_file, ckpt_root, results):
    try:
        torch.set_num_threads(1)
        init_process_group(rank, world, f"file://{init_file}", device="cpu")
        out = {"train": {}}
        meshes = {k: tmesh.make_mesh(v, AXES, device="cpu")
                  for k, v in MESHES[world].items()}
        out["linear"] = _linear_case(meshes)
        out["lse"] = _lse_case(meshes)
        out["init"] = _init_case(meshes)
        for mname, mesh in meshes.items():
            for name in TRAIN:
                r = _train_case(name, mesh)
                out["train"][(mname, name)] = r if rank == 0 else \
                    {"misplaced": r["misplaced"]}
        if world == 4:
            mesh = meshes["2x2"]
            out["again"] = _train_case("qwen-fsdp", mesh)["state"]
            out["resume"] = _resume_case(mesh, os.path.join(ckpt_root, "r"),
                                         rank)
            out["serve"] = {
                (arch, seq): _serve_case(arch, mesh, seq)
                for arch, seq in [(a, False) for a in SERVE]
                + [("qwen3-1.7b", True)]}
            out["elastic"] = _elastic_case(os.path.join(ckpt_root, "e"), rank)
            out["remat_thread"] = _remat_thread_case(mesh)
            for name in TRAIN_1X4:
                r = _train_case(name, meshes["1x4"], check_init=True)
                out["train"][("1x4", name)] = r if rank == 0 else \
                    {k: r[k] for k in ("misplaced", "looped_heads",
                                       "init_unequal")}
            out["serve_heads6"] = {
                arch: _serve_case(arch, meshes["1x4"], overrides=kw)
                for arch, kw in SERVE_HEADS6.items()}
            out["write"] = _write_case({k: meshes[k] for k in ("2x2", "1x4")})
            out["head_split"] = _head_split_case(meshes["1x4"])
            out["flash"] = {2: _flash_case(mesh, "model"),
                            4: _flash_case(meshes["1x4"], "model")}
        if world == 2:
            out["flash"] = {2: _flash_case(meshes["1x2"], "model")}
        if world == 1:
            out.update(_world1_cases())
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


_LAUNCHES = {}
WORLDS = (1, 2, 4)


def _start(world):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    root = tempfile.mkdtemp(prefix="mesh_")
    init_file = os.path.join(root, "init")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, init_file, root, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs, results, root


def _collect(world, procs, results, root):
    got = {}
    try:
        for _ in range(world):
            rank, status, payload = results.get(timeout=600)
            assert status == "ok", f"rank {rank}:\n{payload}"
            got[rank] = payload
    except queue.Empty:
        pytest.fail(f"world {world}: ranks "
                    f"{sorted(set(range(world)) - set(got))} reported nothing")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return got, root


def _launch(world):
    """The results of world size ``world``'s launch, {rank: results}, and
    its scratch directory.  The first call starts the launches of every
    world size at once (one thread a rank), then waits for this one."""
    if not _LAUNCHES:
        _LAUNCHES.update({w: _start(w) for w in WORLDS})
    if not isinstance(_LAUNCHES[world], dict):
        _LAUNCHES[world] = dict(zip(("got", "root"),
                                    _collect(world, *_LAUNCHES[world])))
    return _LAUNCHES[world]["got"], _LAUNCHES[world]["root"]


# ---------------------------------------------------------------------------
# the mesh-free references (in the test process)
# ---------------------------------------------------------------------------

_FREE = {}


def _free_train(name):
    """The port's mesh-free steps and the reference's jitted ones from the
    same initial state, for a case of TRAIN or TRAIN_1X4: (port losses,
    port state, reference losses, reference state)."""
    if name in _FREE:
        return _FREE[name]
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.configs.base import RunConfig as JRun
    from repro.train import train_step as jts
    from repro.train.optimizer import OptConfig as JOpt

    cfg, _ = _train_config(name)
    run = _case_run(name)
    step, init, _ = tts.build_train_step(cfg, run, topt.OptConfig(**OPT_KW),
                                         device="cpu")
    state = init(SEED)
    jstate = jax.tree.map(jnp.asarray, tzoo.export_state(state))
    jstep, _, _ = jts.build_train_step(
        _train_config(name, jreg)[0],
        JRun(**{k: getattr(run, k) for k in (
            "sharding_mode", "remat", "q_chunk", "kv_chunk", "loss_chunk",
            "compute_dtype", "grad_compression")}), JOpt(**OPT_KW))
    losses, jlosses = [], []
    for b in _batches(cfg):
        state, stats = step(state, b)
        losses.append(float(stats["loss"]))
        jstate, jstats = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        jlosses.append(float(jstats["loss"]))
    jtree = jax.tree.map(np.asarray, jstate)
    _FREE[name] = (losses, tzoo.export_state(state), jlosses, jtree)
    return _FREE[name]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _assert_trees(got, want, **tol):
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(gl) == sorted(wl)
    for k in wl:
        assert gl[k].shape == wl[k].shape, k
        np.testing.assert_allclose(gl[k].astype(np.float64), wl[k],
                                   err_msg=k, **tol)


def _assert_bits(got, want):
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(gl) == sorted(wl)
    for k in wl:
        g, w = np.atleast_1d(gl[k]), np.atleast_1d(wl[k])
        assert g.dtype == w.dtype and np.array_equal(
            g.view(np.uint8), w.view(np.uint8)), k


def _free_serve(arch, seq_shard=False, overrides=None):
    cfg = dataclasses.replace(treg.get_config(arch, reduced=True),
                              **(overrides or {}))
    run = _serve_run(seq_shard)
    fns = tserve.build_serve_fns(cfg, run, max_len=MAX_LEN, batch=SERVE_B,
                                 cache_dtype=torch.float32, device="cpu")
    return _serve(fns, tzoo.build_model(cfg, run, "cpu").init(SEED), cfg)[0]


_REF_SERVE = {}


def _ref_serve(arch):
    """The reference's jitted ``build_serve_fns`` (no mesh) on the same
    parameters (``export_params``), tokens and ``enc_frames``: prefill
    logits, then each decode step's."""
    if arch in _REF_SERVE:
        return _REF_SERVE[arch]
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.configs.base import RunConfig as JRun
    from repro.serve import serve_step as jss

    cfg = treg.get_config(arch, reduced=True)
    run = _serve_run()
    params = jax.tree.map(jnp.asarray, tzoo.export_params(
        tzoo.build_model(cfg, run, "cpu").init(SEED)))
    fns = jss.build_serve_fns(
        jreg.get_config(arch, reduced=True),
        JRun(**{k: getattr(run, k) for k in (
            "remat", "q_chunk", "kv_chunk", "compute_dtype")}),
        max_len=MAX_LEN, batch=SERVE_B, cache_dtype=jnp.float32)
    inputs, nxt = _serve_inputs(cfg)
    cache, logits = fns["prefill"](params, fns["init_cache"](),
                                   {k: jnp.asarray(v)
                                    for k, v in inputs.items()})
    out = [logits]
    for t in range(DECODES):
        cache, logits = fns["decode"](params, cache,
                                      jnp.asarray(nxt[:, t:t + 1]),
                                      jnp.int32(PROMPT + t))
        out.append(logits)
    _REF_SERVE[arch] = [np.asarray(o, np.float32) for o in out]
    return _REF_SERVE[arch]


def _assert_serve(got, arch, seq_shard=False):
    """Logits within ``SERVE_ATOL`` of the port's mesh-free functions and
    of the reference's (on the real vocab: the padded columns are masked
    in both)."""
    v = treg.get_config(arch, reduced=True).vocab_size
    for g, w, j in zip(got, _free_serve(arch, seq_shard), _ref_serve(arch)):
        np.testing.assert_allclose(g, w, rtol=0, atol=SERVE_ATOL)
        np.testing.assert_allclose(g[..., :v], j[..., :v], rtol=0,
                                   atol=SERVE_ATOL)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

TRAIN_IDS = [(w, m, n) for w in (4, 2, 1) for m in MESHES[w] for n in TRAIN]


@pytest.mark.parametrize("world,mname,name", TRAIN_IDS,
                         ids=[f"w{w}-{m}-{n}" for w, m, n in TRAIN_IDS])
def test_train_steps_match_mesh_free_and_reference(world, mname, name):
    got, _ = _launch(world)
    losses, state, jlosses, jstate = _free_train(name)
    r = got[0]["train"][(mname, name)]
    np.testing.assert_allclose(r["losses"], losses, **TOL)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)
    _assert_trees(r["state"], state, **TOL)
    _assert_trees(r["state"], jstate, **TOL)
    for rank in got:
        assert got[rank]["train"][(mname, name)]["misplaced"] == []


@pytest.mark.parametrize("name", list(TRAIN_1X4))
def test_whole_heads_train_on_their_shares(name):
    """(1, 4): reduced rwkv6-1.6b, whose 2 heads do not divide the model
    axis (each rank one head's half of the value columns), rwkv6 with 6
    heads (the loop on ``head_chunk``'s 2, 2, 2 and 0 a rank), reduced
    qwen3-1.7b with 6 query heads (their projections split by whole
    heads, 2, 2, 2 and 0 a rank), also under top-k compression (its
    error-feedback residual gathered for the threshold at every step),
    and reduced whisper-base with 6 (MHA: its kv projections and
    cross-attention so split too, rank 3 without heads or kv heads):
    three steps' losses and state within TOL of the port's mesh-free step
    and of the reference's jitted one (rwkv6's state within RWKV_REF_ATOL
    of the reference's, the 6-head rwkv6's of the mesh-free step's too);
    every parameter, moment and residual placed by its spec, and by whole
    heads where it must be, on every rank; no call of the RWKV loop on more than
    ``ceil(H / 4)`` heads; the per-shard init's shards those of the whole
    init bit for bit."""
    got, _ = _launch(4)
    losses, state, jlosses, jstate = _free_train(name)
    r = got[0]["train"][("1x4", name)]
    np.testing.assert_allclose(r["losses"], losses, **TOL)
    np.testing.assert_allclose(r["losses"], jlosses, **TOL)
    rwkv_tol = TOL if not name.startswith("rwkv") else dict(
        TOL, atol=RWKV_REF_ATOL)
    # the 6-head rwkv6 (d 384) against the mesh-free step too: its split
    # loop sums in another order, and Adam moves an entry whose gradient
    # is rounding noise (one of tmix/wg's 294,912 by 3.4e-5: the effect
    # RWKV_REF_ATOL's comment names)
    _assert_trees(r["state"], state,
                  **(rwkv_tol if name == "rwkv-heads6" else TOL))
    _assert_trees(r["state"], jstate, **rwkv_tol)
    heads = _train_config(name)[0].d_model // 64 if \
        name.startswith("rwkv") else None
    for rank in got:
        case = got[rank]["train"][("1x4", name)]
        assert case["misplaced"] == []
        assert case["init_unequal"] == []
        if heads is not None:
            assert case["looped_heads"] <= -(-heads // 4), case
            assert rank > 0 or case["looped_heads"] > 0, case


@pytest.mark.parametrize("arch", list(SERVE_HEADS6))
def test_decode_with_heads_that_do_not_divide_the_axis(arch):
    """(1, 4), reduced qwen3-1.7b with 6 query heads (2, 2, 2 and 0 a
    rank, wq and wo split by whole heads) and reduced whisper-base with 6
    (MHA: every attention weight so split, its cross-attention's too, and
    the decoder's KV cache split on its heads as DTensor splits 6):
    prefill and two decode steps' logits within SERVE_ATOL of the
    mesh-free port; every parameter and cache tensor placed by its spec,
    by whole heads where it must be."""
    got, _ = _launch(4)
    want = _free_serve(arch, overrides=SERVE_HEADS6[arch])
    for rank in got:
        r = got[rank]["serve_heads6"][arch]
        assert r["misplaced"] == []
        for g, w in zip(r["logits"], want):
            np.testing.assert_allclose(g, w, rtol=0, atol=SERVE_ATOL)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_per_shard_init_equals_the_whole_init(world):
    """``init_state`` over every mesh of the world makes each rank's
    shards leaf by leaf: the parameters, m and v of reduced deepseek-7b,
    qwen3-1.7b and gemma2-2b (stacked cycles) under fsdp and tp, ZeRO-1
    on and off, equal bit for bit and placement for placement the whole
    ``init(seed)`` distributed, on every rank."""
    got, _ = _launch(world)
    for rank in got:
        cases = got[rank]["init"]
        assert len(cases) == len(MESHES[world]) * len(INIT_ARCHS) * 4
        for key, c in cases.items():
            assert c["leaves"][0] == c["leaves"][1] > 0, key
            assert c["unequal"] == [], key


@pytest.mark.parametrize("world", [1, 2, 4])
def test_per_shard_init_makes_no_tensor_larger_than_a_leaf(world):
    """A dispatch-mode spy over ``init_state``: the largest tensor it
    makes on a rank is at most the model's largest leaf (the whole leaf
    it draws before keeping its shard), never a whole model's state."""
    got, _ = _launch(world)
    for rank in got:
        for key, c in got[rank]["init"].items():
            assert 0 < c["largest_made"] <= c["largest_leaf"], (key, c)


def test_train_state_is_sharded_by_the_specs():
    """The rules reach the ranks: under fsdp on (2, 2) the embedding is
    split over both axes, and granite-moe's experts over the model axis."""
    got, _ = _launch(4)
    # misplaced == [] above checks placements and shard shapes per rank;
    # here the specs themselves
    mesh = _AbstractMesh({"data": 2, "model": 2})
    cfg = treg.get_config("granite-moe-1b-a400m", reduced=True)
    model = tzoo.build_model(cfg, _train_run("fsdp"), "meta")
    rules = tts.default_rules(_Named(("data", "model")), _train_run("fsdp"))
    specs = tts.state_specs({"params": model}, rules, mesh)
    assert specs["params"]["embed"]["tok"] == shd.P("model", "data")
    assert specs["params"]["cycles"]["0G"]["moe"]["wi"][0] == \
        shd.P("model", "data", None)
    assert specs["opt"]["m"]["final_norm"]["scale"] == shd.P("data")
    assert all(not r["train"][("2x2", "moe")]["misplaced"]
               for r in got.values())


class _AbstractMesh:
    def __init__(self, shape):
        self.shape = shape


class _Named:
    def __init__(self, names):
        self.mesh_dim_names = names


def test_mesh_run_twice_is_bitwise_equal():
    got, _ = _launch(4)
    _assert_bits(got[0]["again"], got[0]["train"][("2x2", "qwen-fsdp")]
                 ["state"])


def test_mesh_resume_is_bitwise_equal():
    got, _ = _launch(4)
    assert all(r["resume"]["misplaced"] == [] for r in got.values())
    _assert_bits(got[0]["resume"]["state"],
                 got[0]["train"][("2x2", "qwen-fsdp")]["state"])


SERVE_IDS = [(a, False) for a in SERVE] + [("qwen3-1.7b", True)]


@pytest.mark.parametrize("arch,seq", SERVE_IDS,
                         ids=[a + ("-seq" if s else "") for a, s in SERVE_IDS])
def test_serve_matches_mesh_free(arch, seq):
    """(2, 2): every rank's logits as the mesh-free port's and the
    reference's; every cache tensor and parameter placed by its spec."""
    got, _ = _launch(4)
    for rank in got:
        r = got[rank]["serve"][(arch, seq)]
        assert r["misplaced"] == []
        _assert_serve(r["logits"], arch, seq)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_linear_on_shards_matches_matmul(world):
    """``sharding.linear`` on each rank's share: the product and both
    gradients within LINEAR_ATOL of the plain ones (float32 sums in
    another order)."""
    got, _ = _launch(world)
    for rank in got:
        cases = got[rank]["linear"]
        assert len(cases) == len(MESHES[world]) * len(LINEAR_SPECS)
        for key, errs in cases.items():
            assert max(errs) <= LINEAR_ATOL, (key, errs)


def test_a_head_split_keeps_its_layout_or_is_refused():
    """(1, 4): a weight of 6 heads split by whole heads (2, 2, 2 and 0 a
    rank) gathers to its value; a copy computed from it carries no tag,
    and ``full`` and ``shard_box`` refuse it on every rank (a gather by
    DTensor's own split would pair the wrong columns, or hang) until
    ``keep_heads`` tags it again; ``heads_out`` equals the plain product
    within LINEAR_ATOL whether the heads' output is whole on the axis or
    split on its heads."""
    got, _ = _launch(4)
    for rank in got:
        r = got[rank]["head_split"]
        assert r["local_rows"] == (32, 32, 32, 0)[rank], r
        assert r["full"] == 0 and r["kept"] == 0, r
        for name in ("lost_full", "lost_box"):
            assert r[name] is not None and "lost its tag" in r[name], r
        assert max(r["out_whole"], r["out_split"]) <= LINEAR_ATOL, r


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_logsumexp_matches_torch(world):
    """``sharding.logsumexp`` on each rank's vocab shard against
    ``torch.logsumexp`` and its gradient, within LSE_ATOL; the batch
    split kept, the reduced dim's replicated."""
    got, _ = _launch(world)
    for rank in got:
        cases = got[rank]["lse"]
        assert len(cases) == len(MESHES[world]) * len(LSE_SPECS)
        for key, (ev, eg, placed) in cases.items():
            assert ev <= LSE_ATOL and eg <= LSE_ATOL, (key, ev, eg)
            assert placed, key


def test_remat_recompute_keeps_the_mesh_context():
    """(2, 2): granite-moe's gradients taken on a thread without the mesh
    context (autograd's CUDA thread) equal those taken on the forward's
    thread bit for bit: the checkpoint's recompute places its tensors as
    the forward did (``sharding.remat``)."""
    got, _ = _launch(4)
    for rank in got:
        assert got[rank]["remat_thread"] == 0.0, got[rank]["remat_thread"]


@pytest.mark.parametrize("world,shards", [(2, 2), (4, 2), (4, 4)])
def test_seq_sharded_decode_attention(world, shards):
    got, _ = _launch(world)
    for rank in got:
        errs = got[rank]["flash"][shards]
        assert max(errs.values()) <= FLASH_ATOL, errs


def test_cache_writes_on_shards():
    got, _ = _launch(4)
    for rank in got:
        w = got[rank]["write"]
        assert len(w) == 6 and not any(w.values()), w


def test_elastic_reshard_across_meshes():
    got, _ = _launch(4)
    for rank in got:
        e = got[rank]["elastic"]
        assert e["misplaced"] == []
        assert abs(e["loss_c"] - e["loss_a"]) <= ELASTIC_ATOL
        assert abs(e["loss_r"] - e["loss_a"]) <= ELASTIC_ATOL


def test_mesh_checkpoint_restores_in_the_reference():
    from repro.train.checkpoint import CheckpointManager as JManager

    got, root = _launch(4)
    _, tree = JManager(os.path.join(root, "e")).restore(1)
    _assert_bits(tree, got[0]["elastic"]["saved"])


def test_build_train_step_takes_a_mesh():
    """A (1, 1) gloo mesh in a spawned rank: the step that raised before
    the mesh was ported runs, and matches the mesh-free one."""
    got, _ = _launch(1)
    losses = _free_train("qwen-fsdp")[0]
    np.testing.assert_allclose(got[0]["train"][("1x1", "qwen-fsdp")]
                               ["losses"], losses, **TOL)


def test_build_serve_fns_takes_a_mesh():
    got, _ = _launch(1)
    r = got[0]
    assert r["serve_shardings"]
    _assert_serve(r["serve_logits"], "qwen3-1.7b")


def test_cluster_mesh_and_world_size_checks():
    got, _ = _launch(1)
    r = got[0]
    assert r["cluster_axes"] == ("server",)
    assert "need 2 ranks" in r["cluster2"]
    assert "world size 2" in r["mesh2"]


def test_make_mesh_refuses_without_a_process_group():
    with pytest.raises(ValueError, match="none is initialised"):
        tmesh.make_mesh((1, 1), AXES, device="cpu")
    with pytest.raises(ValueError, match="need 1 ranks"):
        tmesh.make_cluster_mesh(1, device="cpu")
