#!/usr/bin/env python3
"""The port on four H100s of one host over NCCL, one rank a card.

    python3 chip_probe_four.py        # on a host with four H100s

Refuses, exiting 1 and naming the count, on fewer than four cards.  Builds
the three CUDA kernels once in this process (the ranks load the built
libraries), builds ``chip_smoke.py``'s SCALE 22 R-MAT store and its
one-process reference runs on card 0, then checks four paths:

(a) The graph mesh: ``DistributedGABEngine`` at NCCL world size 4, one
    rank a card, the padded tile stack split into a contiguous block a
    rank.  PageRank for ``PR_SUPERSTEPS`` in dense, sparse and hybrid
    comm, MultiSourceBFS at Q = 8 in hybrid to convergence: on every rank
    the values equal the one-process tiled run bit for bit (the dense
    broadcast sums one contributor a cell, so NCCL's order moves no bit).
    Reported: ms a superstep, the branch a superstep, the bytes a rank
    hands to NCCL (an all-reduce's tensor, an all-gather's gathered
    output), and the ``gab_fused`` / ``compact`` launches a rank (each
    must be > 0).
(b) The cluster runtime: ``run_cluster`` at N = 4, one card a rank:
    PageRank and MultiSourceBFS at Q = 8 with ``chip_smoke.py`` phase 14's
    admission, every rank bit for bit equal to one process.
(c) deepseek-7b at full width and ``CUT_LAYERS`` layers, on (data, model)
    = (4, 1) and (2, 2), and reduced qwen3-1.7b with 6 query heads on
    (1, 4) (``HEADS``: heads that do not divide the model axis, whose
    projections are split by whole heads, 2, 2, 2 and 0 a rank) and its
    twin with 8 (``HEADS_TWIN``: 2 a rank), the reference's FSDP rules
    and ZeRO-1: the shards of ``init_state`` (made leaf by leaf) equal bit
    for bit those of the whole ``init(seed)`` on the same card,
    distributed, and its peak over what it keeps at most the largest leaf
    (here and in (d)); the losses of ``STEPS`` steps within ``LM_TOL`` of
    the mesh-free run of the same config on card 0 of this process.  The
    two reduced cases' next step runs under the dry run's counting mode
    (``roofline/hlo_cost.py``, as ``chip_smoke.py`` phase 23 (b) runs it
    on the card): the operand bytes and ops each rank hands to NCCL must
    be equal in the two (ROADMAP C.6).
(d) deepseek-7b at full depth on (4, 1), ``FULL_BATCH``, ``STEPS`` steps
    under remat "block": finite losses, torch's peak a card below the
    card's memory, ms a step.  The state (110.6 GB) is not checkpointed.
    Its losses rise over the warm-up, the mesh-free cut's too; a second
    witness, mesh-free on card 0 at (c)'s deepseek cut on one batch: the
    loss's derivative along its gradient by central differences within
    ``GRAD_RTOL`` of the gradient's norm, and the loss falling after the
    train step's first update at a hundredth of (c)'s learning rate (the
    change at each lr beside its first-order prediction).

Prints the cards' names and power limits (nvidia-smi), writes
``chiprun_out/chip_probe_four.json`` and exits 1 when any check fails.
Imports no jax and nothing of the JAX package.
"""
import faulthandler
import gc
import json
import multiprocessing as mp
import os
import queue
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402

import chip_smoke as S  # noqa: E402

WORLD = 4
LM_ARCH = "deepseek-7b"
CUT_LAYERS = 2
CUT_BATCH = (8, 256)                # (c): batch x seq, every mesh
CUT_MESHES = ((4, 1), (2, 2))
HEADS = ("qwen3-1.7b", 6, (1, 4))   # (c): reduced, 6 query heads
HEADS_TWIN = 8                      # (c): the twin whose heads divide
FULL_BATCH = (8, 512)               # (d)
STEPS = 3
LM_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_mesh.py TOL
WITNESS_PEAKS = (3e-4, 3e-5, 3e-6)  # lm_opt's peak lr, a tenth, a 100th
GRAD_DL = 0.01                      # the loss's first-order change a side
GRAD_RTOL = 0.01
WATCHDOG_S = 900                    # stacks to stderr if still running
RANKS_TIMEOUT_S = 600               # a hung rank fails the run
OUT = os.path.join(ROOT, "chiprun_out", "chip_probe_four.json")


def log(msg):
    print(msg, flush=True)


class Card:
    """The ``torch.cuda`` clock and memory calls of a rank's device; on
    the CPU (the ranks rehearsed on gloo) they do nothing and read 0."""

    def __init__(self, torch, device):
        self.cuda = torch.cuda if str(device).startswith("cuda") else None

    def sync(self):
        if self.cuda:
            self.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.cuda.reset_peak_memory_stats()

    def allocated(self):
        return self.cuda.memory_allocated() if self.cuda else 0

    def peak(self):
        return self.cuda.max_memory_allocated() if self.cuda else 0

    def total(self):
        return (self.cuda.get_device_properties(
            self.cuda.current_device()).total_memory if self.cuda else 0)

    def free(self):
        gc.collect()
        if self.cuda:
            self.cuda.empty_cache()


def lm_run(seq):
    """The train run of (c) and (d): launch/train.py's, FSDP and ZeRO-1."""
    from repro_torch.configs.base import RunConfig

    return RunConfig(remat="block", q_chunk=min(512, seq),
                     kv_chunk=min(512, seq), loss_chunk=min(512, seq),
                     compute_dtype="float32", sharding_mode="fsdp",
                     zero1=True)


def lm_opt(lr=3e-4):
    from repro_torch.train.optimizer import OptConfig

    return OptConfig(lr=lr, warmup_steps=10, decay_steps=100)


def lm_steps(card, step, state, cfg, batch, seq):
    """``STEPS`` steps of ``SyntheticLM`` batches, each timed (host clock,
    synchronised): (state, losses, seconds a step)."""
    from repro_torch.train.data import SyntheticLM

    src = SyntheticLM(cfg, batch, seq, seed=0)
    losses, secs = [], []
    for i in range(STEPS):
        b = src.batch_at(i)
        card.sync()
        t0 = time.perf_counter()
        state, stats = step(state, b)
        card.sync()
        secs.append(time.perf_counter() - t0)
        losses.append(float(stats["loss"]))
    return state, losses, secs


class Collectives:
    """The bytes this rank hands to ``torch.distributed.all_reduce`` (the
    tensor) and ``all_gather`` (the gathered output) while on: what the
    graph mesh's broadcast moves through NCCL."""

    def __init__(self, dist):
        self.dist, self.bytes = dist, {"all_reduce": 0, "all_gather": 0}
        self.orig = (dist.all_reduce, dist.all_gather)

    def __enter__(self):
        ar, ag = self.orig

        def all_reduce(t, *a, **k):
            self.bytes["all_reduce"] += t.numel() * t.element_size()
            return ar(t, *a, **k)

        def all_gather(out, t, *a, **k):
            self.bytes["all_gather"] += sum(o.numel() * o.element_size()
                                            for o in out)
            return ag(out, t, *a, **k)
        self.dist.all_reduce, self.dist.all_gather = all_reduce, all_gather
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce, self.dist.all_gather = self.orig


def graph_mesh(torch, job):
    """(a) on this rank: each run's history, launches, NCCL bytes and
    whether its values equal the one-process run's (read from
    ``job["refs"]``)."""
    import torch.distributed as dist

    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.core.distributed import DistConfig, DistributedGABEngine
    from repro_torch.graphio.formats import TileStore

    store = TileStore(job["store"])
    store.load_meta()
    plan, tiles, ind, outd = S.load_tiles(store)
    runs = []
    for app, prog, mode, cap in (
            [("pagerank", PageRank(), m, S.PR_SUPERSTEPS)
             for m in ("dense", "sparse", "hybrid")]
            + [("msbfs", MultiSourceBFS(sources=job["sources"]), "hybrid",
                S.BFS_MAX_SUPERSTEPS)]):
        S.reset_launches()
        eng = DistributedGABEngine(None, DistConfig(comm_mode=mode,
                                                    device=job["device"]))
        dist.barrier()
        t0 = time.perf_counter()
        with Collectives(dist) as coll:
            vals, hist = eng.run(prog, tiles, plan.num_vertices, outd, ind,
                                 plan.row_cap, max_supersteps=cap)
        seconds = time.perf_counter() - t0
        want = np.load(job["refs"][app])
        steps = [h["seconds"] for h in hist]
        runs.append(dict(
            app=app, mode=mode, supersteps=len(hist), seconds=seconds,
            equal=S.same_bits(vals, want) and len(hist) == job["ss"][app],
            branches=[h["branch"] for h in hist],
            density=[h["density"] for h in hist],
            per_superstep_ms=[1e3 * t for t in steps],
            steady_ms=1e3 * float(np.mean(steps[1:] if len(steps) > 1
                                          else steps)),
            nccl_bytes=dict(coll.bytes), launches=S.read_launches()))
        del eng
        Card(torch, job["device"]).free()
    return runs


def state_shards(state):
    """Every parameter, m and v member of a train state, in order."""
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer as opt

    def flat(tree):
        return [m for leaf in opt.leaves(tree) for m in opt.members(leaf)]
    return (flat(model_zoo.param_tree(state["params"]))
            + flat(state["opt"]["m"]) + flat(state["opt"]["v"]))


def same_shard(torch, a, b):
    la, lb = a.to_local(), b.to_local()
    return (list(a.placements) == list(b.placements)
            and la.shape == lb.shape and la.dtype == lb.dtype
            and torch.equal(la.view(torch.int32), lb.view(torch.int32)))


def lm_cut(torch, job):
    """(c) on this rank: per case (name, config, mesh), init_state against
    the whole init's shards, then ``STEPS`` steps."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_zoo
    from repro_torch.train import train_step as ts

    dev = job["device"]
    card = Card(torch, dev)
    batch, seq = job["cut_batch"]
    run = lm_run(seq)
    out = []
    for name, cfg, shape in job["cut_cases"]:
        mesh = make_mesh(shape, ("data", "model"), device=dev)
        step, init, sh = ts.build_train_step(cfg, run, lm_opt(), mesh=mesh,
                                             device=dev)
        card.sync()
        base = card.allocated()
        card.reset_peak()
        t0 = time.perf_counter()
        state = init(job["seed"])
        card.sync()
        init_s = time.perf_counter() - t0
        init_peak, held = card.peak() - base, card.allocated() - base
        whole = model_zoo.build_model(cfg, run, dev).init(job["seed"])
        largest = max(p.numel() * p.element_size()
                      for p in whole.parameters())
        want = ts._distribute_state(ts._fresh_state(whole, False, dev),
                                    mesh, sh["rules"])
        got_l, want_l = state_shards(state), state_shards(want)
        unequal = sum(not same_shard(torch, a, b)
                      for a, b in zip(got_l, want_l))
        unequal += abs(len(got_l) - len(want_l))
        n_leaves = len(got_l)
        del whole, want, want_l, got_l
        card.free()
        state, losses, secs = lm_steps(card, step, state, cfg, batch, seq)
        coll = counted_step(step, state, cfg, batch, seq) \
            if heads_case(name) else None
        out.append(dict(case=name, mesh=list(shape), leaves=n_leaves,
                        unequal_leaves=int(unequal), init_s=init_s,
                        init_peak_bytes=int(init_peak),
                        init_held_bytes=int(held),
                        largest_leaf_bytes=int(largest), losses=losses,
                        step_ms=[1e3 * t for t in secs], collectives=coll))
        del state, step, init
        card.free()
    return out


def counted_step(step, state, cfg, batch, seq):
    """One more step under the dry run's counting mode: the collective
    operand bytes (by kind and in all) and ops this rank hands to NCCL."""
    from repro_torch.roofline import analysis, hlo_cost
    from repro_torch.train.data import SyntheticLM

    b = SyntheticLM(cfg, batch, seq, seed=0).batch_at(STEPS)
    rec = [r.as_list() for r in hlo_cost.run(step, state, b).records]
    coll = analysis.collective_bytes(rec)
    return dict(bytes=int(coll["total"]),
                ops=int(sum(coll["op_counts"].values())),
                by_kind={k: int(v) for k, v in coll.items()
                         if k not in ("total", "op_counts")})


def lm_full(torch, job, cfg):
    """(d) on this rank: the full-depth model on (4, 1), ``STEPS`` steps."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_zoo
    from repro_torch.train import train_step as ts

    dev = job["device"]
    card = Card(torch, dev)
    batch, seq = job["full_batch"]
    mesh = make_mesh((job["world"], 1), ("data", "model"), device=dev)
    step, init, _ = ts.build_train_step(cfg, lm_run(seq), lm_opt(),
                                        mesh=mesh, device=dev)
    card.sync()
    base = card.allocated()
    card.reset_peak()
    t0 = time.perf_counter()
    state = init(job["seed"])
    card.sync()
    init_s = time.perf_counter() - t0
    init_peak, held = card.peak() - base, card.allocated() - base
    largest = max(p.numel() * p.element_size() for p in
                  model_zoo.build_model(cfg, device="meta").parameters())
    state, losses, secs = lm_steps(card, step, state, cfg, batch, seq)
    out = dict(mesh=[job["world"], 1], batch=batch, seq=seq, init_s=init_s,
               init_peak_bytes=int(init_peak), init_held_bytes=int(held),
               largest_leaf_bytes=int(largest), losses=losses,
               step_ms=[1e3 * t for t in secs],
               torch_peak_bytes=int(card.peak()),
               card_bytes=int(card.total()))
    del state, step, init
    card.free()
    return out


def lm_config(layers=None):
    import dataclasses

    from repro_torch.configs import registry

    cfg = registry.get_config(LM_ARCH)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def heads_case(name) -> bool:
    """Whether (c)'s case ``name`` is one of the reduced head cases."""
    return name.startswith(f"{HEADS[0]} reduced")


def cut_cases():
    """(c)'s cases, (name, config, mesh shape), in order."""
    import dataclasses

    from repro_torch.configs import registry

    cut = f"{LM_ARCH} {CUT_LAYERS} layers"
    arch, heads, shape = HEADS
    return ([(cut, lm_config(CUT_LAYERS), m) for m in CUT_MESHES]
            + [(f"{arch} reduced, {h} heads", dataclasses.replace(
                registry.get_config(arch, reduced=True), num_heads=h),
                shape) for h in (heads, HEADS_TWIN)])


def rank_main(rank, port, job, results):
    """One rank of (a), (c) and (d): its card by its rank, NCCL."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import init_process_group, rank_device

    faulthandler.dump_traceback_later(job["watchdog_s"], exit=False)
    try:
        from repro_torch.models.layers import exact_matmuls
        exact_matmuls()
        backend = init_process_group(rank, job["world"],
                                     f"tcp://localhost:{port}",
                                     device=job["device"])
        job = dict(job, device=rank_device(job["device"], rank))
        out = dict(backend=backend, device=job["device"],
                   card=torch.cuda.get_device_name(job["device"])
                   if Card(torch, job["device"]).cuda else "cpu")
        t0 = time.perf_counter()
        out["graph"] = graph_mesh(torch, job)
        out["graph_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["lm_cut"] = lm_cut(torch, job)
        out["lm_cut_s"] = time.perf_counter() - t0
        if job.get("full_cfg") is not None:
            t0 = time.perf_counter()
            out["lm_full"] = lm_full(torch, job, job["full_cfg"])
            out["lm_full_s"] = time.perf_counter() - t0
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(job, timeout_s, target=None):
    """Spawn ``job["world"]`` ranks of ``target`` (:func:`rank_main` when
    None; called as ``target(rank, port, job, results)``), wait for each
    one's report: {rank: (status, payload)}."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = S.free_port()
    procs = [ctx.Process(target=target or rank_main,
                         args=(r, port, job, results), daemon=True)
             for r in range(job["world"])]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < len(procs) and time.monotonic() < deadline:
            try:
                rank, status, payload = results.get(timeout=5)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            got[rank] = (status, payload)
            if status == "error":
                log(f"rank {rank} failed:\n{payload}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return got


def references(torch, store, sources, s9, ref_dir):
    """The one-process runs on card 0: tiled PageRank (phase 5's),
    MultiSourceBFS at Q = 8 to convergence (phase 8's), and phase 14's
    MultiSourceBFS with the ninth query admitted after superstep 1; the
    first two saved under ``ref_dir`` for the ranks."""
    from repro_torch.core.apps import MultiSourceBFS, PageRank

    t0 = time.perf_counter()
    pr = S.engine(store).run(PageRank(), max_supersteps=S.PR_SUPERSTEPS)
    msbfs = S.engine(store, tile_skipping=False).run(
        MultiSourceBFS(sources=sources), max_supersteps=S.BFS_MAX_SUPERSTEPS)
    single = S.engine(store, tile_skipping=False,
                      admit_plan=((1, (s9,)),)).run(
        MultiSourceBFS(sources=sources), max_supersteps=S.PR_SUPERSTEPS)
    refs = {}
    for app, res in (("pagerank", pr), ("msbfs", msbfs)):
        refs[app] = os.path.join(ref_dir, f"{app}.npy")
        np.save(refs[app], res.values)
    log(f"references (one process, card 0): pagerank {pr.supersteps} "
        f"supersteps at {S.steady_ms(pr):.1f} ms, msbfs Q = {len(sources)} "
        f"{msbfs.supersteps} supersteps at {S.steady_ms(msbfs):.1f} ms; "
        f"{time.perf_counter() - t0:.1f} s")
    return pr, msbfs, single, refs


def cluster_four(torch, store, pr, single, sources, s9):
    """(b): run_cluster at N = 4, a card a rank, against one process."""
    from repro_torch.core.apps import MultiSourceBFS, PageRank
    from repro_torch.core.engine import EngineConfig
    from repro_torch.launch.cluster import ClusterConfig, run_cluster

    ecfg = EngineConfig(seg_impl="fused", tile_skipping=False,
                        admit_plan=((1, (s9,)),),
                        max_supersteps=S.PR_SUPERSTEPS)
    t0 = time.perf_counter()
    res = run_cluster(store.root, [PageRank(), MultiSourceBFS(
        sources=sources)], ClusterConfig(num_servers=WORLD, device="cuda",
                                         engine=ecfg,
                                         launch_timeout_seconds=600))
    wall = time.perf_counter() - t0
    unequal = []
    for a, want in enumerate((pr, single)):
        for r in range(WORLD):
            got = res.rank_results[r][a]
            if not (S.same_bits(got.values, want.values)
                    and got.supersteps == want.supersteps
                    and [x.admitted_queries for x in got.history]
                    == [x.admitted_queries for x in want.history]):
                unequal.append((r, a))
    apps = []
    for a, name in enumerate(("pagerank", f"msbfs Q={len(sources)}+1")):
        r0 = res.results[a]
        apps.append(dict(app=name, supersteps=r0.supersteps,
                         steady_ms=S.steady_ms(r0),
                         per_superstep_ms=[1e3 * x.seconds
                                           for x in r0.history],
                         wire_bytes=[x.wire_bytes for x in r0.history],
                         admitted=[list(x.admitted_queries)
                                   for x in r0.history]))
        log(f"cluster N={WORLD} {name}: {r0.supersteps} supersteps, "
            f"{S.steady_ms(r0):.1f} ms a superstep steady, wire "
            f"{[x.wire_bytes for x in r0.history]} B")
    ranks = [dict(rank=rep["rank"], device=rep["device"],
                  seconds=rep["seconds"], launches=rep["launches"],
                  torch_peak_bytes=rep.get("torch_peak_bytes"))
             for rep in res.rank_reports]
    for rep in ranks:
        log(f"  cluster rank {rep['rank']} on {rep['device']}: "
            f"{rep['seconds']:.1f} s, launches {rep['launches']}")
    return dict(n=WORLD, wall_s=wall, unequal=unequal, apps=apps,
                ranks=ranks)


def lm_free(torch, name, cfg, device="cuda", cut_batch=CUT_BATCH):
    """(c)'s reference for case ``name``: the same config, mesh-free, on
    card 0."""
    from repro_torch.train import train_step as ts

    card = Card(torch, device)
    batch, seq = cut_batch
    step, init, _ = ts.build_train_step(cfg, lm_run(seq), lm_opt(),
                                        device=device)
    state = init(0)
    state, losses, secs = lm_steps(card, step, state, cfg, batch, seq)
    del state, step, init
    card.free()
    log(f"lm {name} mesh-free on card 0: losses {losses}, "
        f"{np.mean(secs[1:]) * 1e3:.1f} ms a step")
    return dict(losses=losses, step_ms=[1e3 * t for t in secs])


def witness(torch, cfg):
    """(d)'s second witness on (c)'s deepseek cut, mesh-free on card 0, on
    ``SyntheticLM``'s batch 0 throughout: (1) the loss's derivative along
    its gradient g by central differences, ``(L(p + e g/|g|) - L(p - e
    g/|g|)) / 2e`` with ``e = GRAD_DL / |g|``, against ``|g|``; (2) for
    each peak lr of ``WITNESS_PEAKS``, the train step's first update (at
    a tenth of the peak: the warm-up) and the loss again on the same
    batch: its change against the first-order change that update
    predicts, ``-lr * sum(g * d)``, d AdamW's first direction (``g s /
    (|g| s + eps)``, s the clip's scale, plus the decay of matrices)."""
    from repro_torch.models import model_zoo
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import lr_schedule

    card = Card(torch, "cuda")
    batch, seq = CUT_BATCH
    run = lm_run(seq)
    b = SyntheticLM(cfg, batch, seq, seed=0).batch_at(0)
    model = model_zoo.build_model(cfg, run, "cuda").init(0)
    params = [p.requires_grad_(True) for p in model.parameters()]
    tokens, labels = (torch.as_tensor(b[k], device="cuda")
                      for k in ("tokens", "labels"))
    model.loss(tokens, labels).backward()
    grads = [p.grad for p in params]
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    e = GRAD_DL / norm
    opt = lm_opt()
    sc = min(1.0, opt.grad_clip / norm)
    with torch.no_grad():
        slope = float(sum(
            (g.double() * (g * sc / (g.abs() * sc + opt.eps) + (
                opt.weight_decay * p if p.dim() >= 2 else 0))).sum()
            for p, g in zip(params, grads)))
        loss = float(model.loss(tokens, labels))
        for by in (e, -2 * e):
            for p, g in zip(params, grads):
                p.add_(g, alpha=by / norm)
            if by > 0:
                up = float(model.loss(tokens, labels))
        down = float(model.loss(tokens, labels))
    deriv = (up - down) / (2 * e)
    del model, params, grads
    card.free()
    log(f"witness {LM_ARCH} {CUT_LAYERS} layers: loss {loss:.6f}, |g| "
        f"{norm:.6f}, central difference {deriv:.6f} (step {e:.3e})")
    first = []
    for peak in WITNESS_PEAKS:
        step, init, _ = ts.build_train_step(cfg, run, lm_opt(peak),
                                            device="cuda")
        state, st0 = step(init(0), b)
        state, st1 = step(state, b)
        lr = float(lr_schedule(lm_opt(peak), 1))
        first.append(dict(peak_lr=peak, lr=lr, before=float(st0["loss"]),
                          after=float(st1["loss"]),
                          change=float(st1["loss"] - st0["loss"]),
                          first_order=-lr * slope))
        del state, step, init
        card.free()
        log(f"witness: first update at lr {lr:.1e}: loss "
            f"{first[-1]['before']:.6f} -> {first[-1]['after']:.6f}, "
            f"first order {first[-1]['first_order']:+.6f}")
    return dict(loss=loss, grad_norm=norm, step=e, derivative=deriv,
                rel_err=abs(deriv / norm - 1), first_update=first)


def checks(out):
    """The failed checks' descriptions (empty when all hold)."""
    bad = []
    ranks = out["ranks"]
    for r, rep in ranks.items():
        if rep["status"] != "ok":
            bad.append(f"rank {r}: {rep['error'][-500:]}")
            continue
        for run in rep["graph"]:
            if not run["equal"]:
                bad.append(f"(a) rank {r} {run['app']} {run['mode']}: "
                           "differs from one process")
        launched = {k: sum(run["launches"][k] for run in rep["graph"])
                    for k in ("gab_fused", "compact")}
        if not all(launched.values()):
            bad.append(f"(a) rank {r}: launches {launched}")
        for c in rep["lm_cut"] + [rep.get("lm_full") or {}]:
            if c and c["init_peak_bytes"] - c["init_held_bytes"] > \
                    c["largest_leaf_bytes"]:
                bad.append(f"rank {r}: init's peak {c['init_peak_bytes']} B"
                           f" over the {c['init_held_bytes']} B it keeps is "
                           f"more than the largest leaf")
        for c in rep["lm_cut"]:
            if c["unequal_leaves"]:
                bad.append(f"(c) rank {r} {c['mesh']}: {c['unequal_leaves']}"
                           " shards differ from the whole init's")
            want = out["lm_free"][c["case"]]["losses"]
            if not np.allclose(c["losses"], want, **LM_TOL):
                bad.append(f"(c) rank {r} {c['case']} {c['mesh']}: losses "
                           f"{c['losses']} vs {want}")
        coll = {c["case"]: c["collectives"] for c in rep["lm_cut"]
                if heads_case(c["case"])}
        pair = [coll.get(f"{HEADS[0]} reduced, {h} heads")
                for h in (HEADS[1], HEADS_TWIN)]
        if None in pair or (pair[0]["bytes"], pair[0]["ops"]) != \
                (pair[1]["bytes"], pair[1]["ops"]):
            bad.append(f"(c) rank {r}: collectives with {HEADS[1]} heads "
                       f"{pair[0]} vs {HEADS_TWIN} heads {pair[1]} (C.6)")
        full = rep.get("lm_full")
        if full is None:
            bad.append(f"(d) rank {r}: not run")
        elif not (np.all(np.isfinite(full["losses"]))
                  and full["torch_peak_bytes"] <= full["card_bytes"]):
            bad.append(f"(d) rank {r}: losses {full['losses']}, peak "
                       f"{full['torch_peak_bytes']} of {full['card_bytes']}")
    if len(ranks) != WORLD:
        bad.append(f"{len(ranks)} of {WORLD} ranks reported")
    w = out["witness"]
    if not w["rel_err"] <= GRAD_RTOL:
        bad.append(f"(d) witness: central difference {w['derivative']} vs "
                   f"|g| {w['grad_norm']}")
    if not w["first_update"][-1]["change"] < 0:
        bad.append(f"(d) witness: the loss does not fall after the first "
                   f"update at the smallest lr: {w['first_update'][-1]}")
    if out["cluster"]["unequal"]:
        bad.append(f"(b) (rank, app) differing from one process: "
                   f"{out['cluster']['unequal']}")
    for rep in out["cluster"]["ranks"]:
        if not rep["launches"]["gab_fused"]:
            bad.append(f"(b) rank {rep['rank']}: no gab_fused launch")
    return bad


def summary(out):
    """The lines PERF.md reads."""
    for r, rep in sorted(out["ranks"].items()):
        if rep["status"] != "ok":
            continue
        for run in rep["graph"]:
            log(f"(a) rank {r} on {rep['device']} {run['app']} "
                f"{run['mode']}: {run['supersteps']} supersteps, "
                f"{run['steady_ms']:.1f} ms a superstep steady, branches "
                f"{run['branches']}, NCCL bytes {run['nccl_bytes']}, "
                f"launches {run['launches']}, equal {run['equal']}")
        for c in rep["lm_cut"]:
            log(f"(c) rank {r} {c['case']} {c['mesh']}: {c['leaves']} "
                f"shards, {c['unequal_leaves']} unequal; init "
                f"{c['init_s']:.1f} s, "
                f"peak +{c['init_peak_bytes']} B (largest leaf "
                f"{c['largest_leaf_bytes']} B, held {c['init_held_bytes']} "
                f"B); losses {c['losses']}; ms a step {c['step_ms']}"
                + (f"; collectives a step {c['collectives']}"
                   if c.get("collectives") else ""))
        full = rep.get("lm_full")
        if full:
            log(f"(d) rank {r}: init {full['init_s']:.1f} s (peak "
                f"{full['init_peak_bytes']} B, held "
                f"{full['init_held_bytes']} B, largest leaf "
                f"{full['largest_leaf_bytes']} B), losses {full['losses']}, "
                f"ms a step {full['step_ms']}, torch peak "
                f"{full['torch_peak_bytes']} of {full['card_bytes']} B")


def main():
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < WORLD:
        print(f"chip_probe_four: needs {WORLD} CUDA devices, PyTorch sees "
              f"{n}", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)
    t_all = time.perf_counter()
    from repro_torch.models.layers import exact_matmuls
    exact_matmuls()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {n}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    builds = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(builds)}")

    work = os.path.join(ROOT, "build", "chip_probe_four")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
               cards=n)
    try:
        t0 = time.perf_counter()
        store, plan, src, dst, out["store"] = S.build_store(
            os.path.join(work, "store"))
        out_degree = store.load_degrees()[1]
        sources = S.pick_sources(out_degree)
        s9, _ = S.pick_admitted(src, dst, out_degree, sources)
        del src, dst
        pr, msbfs, single, refs = references(torch, store, sources, s9,
                                             work)
        out["references_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cases = cut_cases()
        out["lm_free"] = {name: lm_free(torch, name, cfg) for name, cfg
                          in {n: c for n, c, _ in cases}.items()}
        out["lm_free_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["witness"] = witness(torch, lm_config(CUT_LAYERS))
        out["witness_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["cluster"] = cluster_four(torch, store, pr, single, sources, s9)
        out["cluster_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        job = dict(world=WORLD, device="cuda", store=store.root,
                   sources=sources, refs=refs,
                   ss=dict(pagerank=pr.supersteps, msbfs=msbfs.supersteps),
                   seed=0, cut_cases=cases, cut_batch=CUT_BATCH,
                   full_cfg=lm_config(), full_batch=FULL_BATCH,
                   watchdog_s=max(60.0, WATCHDOG_S
                                  - (time.perf_counter() - t_all)))
        t0 = time.perf_counter()
        got = run_ranks(job, RANKS_TIMEOUT_S)
        out["ranks_s"] = time.perf_counter() - t0
        out["ranks"] = {r: ({"status": "ok", **p} if st == "ok" else
                            {"status": st, "error": p})
                        for r, (st, p) in got.items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary(out)
    bad = checks(out)
    out["failed"] = bad
    out["seconds"] = time.perf_counter() - t_all
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, default=str)
    faulthandler.cancel_dump_traceback_later()
    for b in bad:
        log(f"FAILED {b}")
    log(f"total {out['seconds']:.1f} s")
    print(json.dumps({"ok": not bad, "failed": len(bad),
                      "cards": n, "kind": torch.cuda.get_device_name(0)}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
