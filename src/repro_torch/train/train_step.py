"""The train step: microbatched gradient accumulation, remat, optional
gradient compression, mesh-aware shardings — the counterpart of
``repro/train/train_step.py``.

``build_train_step`` returns ``(step_fn, init_state, None)`` without a
mesh, ``(step_fn, init_state, shardings)`` with one.  The train
state is ``{"params": model, "opt": {"m", "v", "step"}, "step"[, "ef":
{"residual"}]}`` (``models/model_zoo.py``); ``step_fn(state, batch)``
updates it in place, as the reference donates it, and returns ``(state,
stats)`` with the reference's stats: ``loss``, ``lr``, ``grad_norm``, and
under top-k ``density`` and ``wire_ratio`` (0-d tensors).  It also takes
the reference's train state as numpy, a restored checkpoint of either
package, and loads it into a new model first.

Over a device mesh (``launch/mesh.py``; every rank calls the step with
the same global batch) the state lives where the reference's specs put it
(:func:`state_specs`): each parameter is a DTensor placed by
``sharding.param_specs`` (FSDP over the data axis under
``sharding_mode="fsdp"``, the model axis by the tensor-parallel rules),
m, v and top-k's residual in their ZeRO-1 placements, the step counters
replicated.  Each microbatch is sharded over the data axes; the forward
and backward run on DTensors (``sharding.use_mesh``); the gradients come
back in the parameters' placements, and AdamW updates m and v on their
shards and writes each parameter back in its own.  ``shardings["state"]``
is a :class:`StateShardings`, which places a train state — the port's,
or the reference's tree restored from a checkpoint — on its mesh
(``runtime/elastic.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model_zoo
from repro_torch.models import sharding as shd
from repro_torch.serve.graph_service import bind_device
from repro_torch.train import optimizer as opt


def model_loss_fn(model, cfg: ModelConfig):
    """Uniform loss entry point across families: ``loss_fn(params,
    batch)``, where ``params`` is the model whose weights to use (the
    port's modules hold their weights; ``model`` when None).  An
    encoder-decoder takes ``batch["enc_frames"]``, a vision frontend
    ``batch["patch_embeds"]``."""
    def loss_fn(params, batch):
        m = model if params is None else params
        if cfg.encoder_layers > 0:
            return m.loss(batch["tokens"], batch["labels"],
                          batch["enc_frames"])
        if cfg.frontend == "vision":
            return m.loss(batch["tokens"], batch["labels"],
                          extra_embeds=batch["patch_embeds"])
        return m.loss(batch["tokens"], batch["labels"])
    return loss_fn


def _microbatch(batch: dict, n: int, i: int) -> dict:
    """Slice i of n, contiguous along axis 0."""
    def slc(x):
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]
    return {k: slc(v) for k, v in batch.items()}


def _fresh_state(model, use_ef: bool, device, mesh=None,
                 rules=None) -> dict:
    """The train state of an initialised ``model``: zero moments (and
    top-k residual), step 0.  Over a mesh the zeros are DTensors in their
    ZeRO-1 placements (:func:`state_specs`), each rank making only its
    shards."""
    model.requires_grad_(True)
    params = model_zoo.param_tree(model)
    step = torch.zeros((), dtype=torch.int32, device=device)
    if mesh is None:
        state = {"params": model, "opt": opt.adamw_init(params),
                 "step": step}
        if use_ef:
            state["ef"] = opt.ef_init(params)
        return state
    specs = state_specs({"params": model, **({"ef": {}} if use_ef else {})},
                        rules, mesh)

    def zeros(tree):
        return opt.member_map(lambda p, sp: shd.zeros(
            p.shape, shd.placements(sp, mesh), mesh, device,
            shd.heads_of(p)), params, tree)
    state = {"params": model,
             "opt": {"m": zeros(specs["opt"]["m"]),
                     "v": zeros(specs["opt"]["v"]), "step": step.clone()},
             "step": step}
    if use_ef:
        state["ef"] = {"residual": zeros(specs["ef"]["residual"])}
    return state


def default_rules(mesh, run: RunConfig) -> shd.Rules:
    """The reference's rules for a mesh: the batch over its pod and data
    axes, FSDP under ``sharding_mode="fsdp"``, ZeRO-1 as ``run.zero1``."""
    names = mesh.mesh_dim_names
    return shd.Rules(dp_axes=tuple(a for a in ("pod", "data") if a in names),
                     fsdp=run.sharding_mode == "fsdp", zero1=run.zero1)


def state_specs(state, rules: shd.Rules, mesh=None) -> dict:
    """PartitionSpec tree for the full train state: the parameters'
    (``sharding.param_specs``; ``state["params"]`` is a model, on the meta
    device will do), m, v and the residual by ZeRO-1
    (``opt_state_spec_from_param`` on each member's spec and shape), the
    step counters replicated."""
    model = state["params"]
    param_sp = shd.param_specs(model, rules, mesh)
    shapes = opt.member_map(lambda p: tuple(p.shape),
                            model_zoo.param_tree(model))

    def map_opt():
        return opt.member_map(
            lambda sp, shape: shd.opt_state_spec_from_param(sp, rules, shape,
                                                            mesh),
            param_sp, shapes)

    out = {"params": param_sp,
           "opt": {"m": map_opt(), "v": map_opt(), "step": shd.P()},
           "step": shd.P()}
    if "ef" in state:
        out["ef"] = {"residual": map_opt()}
    return out


class StateShardings:
    """Where a train state lives: ``mesh`` (None: plain tensors on
    ``device``) with ``rules`` for ``cfg`` and ``run``.  :meth:`place`
    puts a state there."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, mesh, rules,
                 device):
        self.cfg, self.run, self.mesh, self.device = cfg, run, mesh, device
        self.rules = rules if mesh is None or rules is not None else \
            default_rules(mesh, run)

    def specs(self, use_ef: bool) -> Optional[dict]:
        """:func:`state_specs` of this placement (None without a mesh)."""
        if self.mesh is None:
            return None
        model = model_zoo.build_model(self.cfg, self.run, "meta")
        return state_specs({"params": model, **({"ef": {}} if use_ef else {})},
                           self.rules, self.mesh)

    def place(self, state) -> dict:
        """A new train state here holding ``state``'s values: the port's
        state (on any mesh or none; gathered whole first) or the
        reference's tree (numpy or tensors, a restored checkpoint)."""
        if isinstance(state["params"], nn.Module):
            state = model_zoo.export_state(state, host=False)
        new = model_zoo.load_state(state, self.cfg, self.run, self.device)
        if self.mesh is None:
            return new
        return _distribute_state(new, self.mesh, self.rules)


def _distribute_state(state: dict, mesh, rules: shd.Rules) -> dict:
    """A plain train state, equal on every rank, placed on ``mesh`` by
    :func:`state_specs` (each rank keeps its shards)."""
    specs = state_specs(state, rules, mesh)
    shd.distribute_model_(state["params"], mesh, rules)
    params = model_zoo.param_tree(state["params"])

    def put(x, sp, p):
        return shd.distribute(x, sp, mesh, shd.heads_of(p))

    state["opt"] = {"m": opt.member_map(put, state["opt"]["m"],
                                        specs["opt"]["m"], params),
                    "v": opt.member_map(put, state["opt"]["v"],
                                        specs["opt"]["v"], params),
                    "step": state["opt"]["step"]}
    if "ef" in state:
        state["ef"] = {"residual": opt.member_map(
            put, state["ef"]["residual"], specs["ef"]["residual"], params)}
    return state


def build_train_step(
    cfg: ModelConfig,
    run: RunConfig,
    opt_cfg: opt.OptConfig = opt.OptConfig(),
    mesh=None,
    rules=None,
    donate: bool = True,
    device: str = "cuda",
):
    """Returns ``(step_fn, init_state, shardings)`` (module docstring):
    ``shardings`` is None without a mesh, else ``dict(state=
    StateShardings, batch=placements, rules=Rules, specs=state_specs)``
    with the reference's default rules unless ``rules`` is given.
    ``init_state(seed)`` builds the model's ``init(seed)`` and zeroed
    optimizer state on ``device``, which is the card unless the caller
    asks for another: without one it raises, as ``ServeEngine`` does.
    Over a mesh each rank makes only its shards
    (``model_zoo.init_on_mesh``: one whole leaf at a time, drawn as the
    whole ``init(seed)`` draws it; m, v and the residual as zero
    shards).  With ``donate=False`` the step leaves its input state as it
    was."""
    device = bind_device(device)
    loss_fn = model_loss_fn(None, cfg)
    use_ef = run.grad_compression == "topk"
    where = StateShardings(cfg, run, mesh, rules, device)
    rules = where.rules

    def init_state(seed: int = 0) -> dict:
        if mesh is None:
            return _fresh_state(model_zoo.build_model(cfg, run, device)
                                .init(seed), use_ef, device)
        model = model_zoo.init_on_mesh(
            model_zoo.build_model(cfg, run, "meta"), seed, mesh, rules,
            device)
        return _fresh_state(model, use_ef, device, mesh, rules)

    def shard_batch(mb: dict) -> dict:
        if mesh is None:
            return mb
        return {k: shd.distribute(v, shd.P(rules.dp), mesh)
                for k, v in mb.items()}

    def step_fn(state, batch):
        if not isinstance(state["params"], nn.Module):
            state = where.place(state)
        elif not donate:
            state = where.place(state)          # a copy
        model = state["params"]
        params = model_zoo.param_tree(model)
        flat = [p for leaf in opt.leaves(params) for p in opt.members(leaf)]
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        nmb = run.microbatch
        loss_sum, acc = None, None
        with shd.use_mesh(mesh, rules):
            for i in range(nmb):
                mb = shard_batch(_microbatch(batch, nmb, i) if nmb > 1
                                 else batch)
                with torch.enable_grad():
                    loss = loss_fn(model, mb)
                    grads = torch.autograd.grad(loss, flat)
                # the gradients in their parameters' placements (a partial
                # sum over the data axes is reduced here)
                grads = [shd.placed_as(g, p) for g, p in zip(grads, flat)]
                loss = shd.full(loss.detach())
                if nmb == 1:
                    # 0 + g and g / 1 are exact: the reference's accumulator
                    # would hold the gradients as they are
                    loss_sum, acc = loss, [g.float() for g in grads]
                    continue
                if acc is None:
                    loss_sum = torch.zeros((), dtype=torch.float32,
                                           device=loss.device)
                    acc = [torch.zeros_like(g, dtype=torch.float32)
                           for g in grads]
                loss_sum = loss_sum + loss
                for a, g in zip(acc, grads):
                    a.add_(g.float())
                del grads
            if nmb > 1:
                loss = loss_sum / nmb
                acc = [a / nmb for a in acc]
            it = iter(acc)
            grads = opt.member_map(lambda _: next(it), params)
            del acc

            if run.grad_compression == "bf16":
                grads = opt.member_map(
                    lambda g: g.to(torch.bfloat16).float(), grads)
            stats_extra = {}
            if use_ef:
                grads, state["ef"], stats_extra = opt.topk_compress(
                    grads, state["ef"])

            _, state["opt"], stats = opt.adamw_update(params, grads,
                                                      state["opt"], opt_cfg)
        state["step"] = state["step"] + 1
        return state, {**stats, **stats_extra, "loss": loss}

    if mesh is None:
        return step_fn, init_state, None
    return step_fn, init_state, dict(
        state=where, batch=shd.placements(shd.P(rules.dp), mesh),
        rules=rules, specs=where.specs(use_ef))
