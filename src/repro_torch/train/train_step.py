"""The train step: microbatched gradient accumulation, remat, optional
gradient compression — the counterpart of ``repro/train/train_step.py``
on one device.

``build_train_step`` returns ``(step_fn, init_state, None)``.  The train
state is ``{"params": model, "opt": {"m", "v", "step"}, "step"[, "ef":
{"residual"}]}`` (``models/model_zoo.py``); ``step_fn(state, batch)``
updates it in place, as the reference donates it, and returns ``(state,
stats)`` with the reference's stats: ``loss``, ``lr``, ``grad_norm``, and
under top-k ``density`` and ``wire_ratio`` (0-d tensors).  It also takes
the reference's train state as numpy, a restored checkpoint of either
package, and loads it into a new model first.

The reference jit-compiles the step with mesh-aware shardings
(``state_specs``, ZeRO-1, FSDP); training over a device mesh is
ROADMAP.md A.13.2b, so ``mesh`` must be None here.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model_zoo
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


def _fresh_state(model, use_ef: bool) -> dict:
    model.requires_grad_(True)
    params = model_zoo.param_tree(model)
    state = {"params": model, "opt": opt.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if use_ef:
        state["ef"] = opt.ef_init(params)
    return state


def _clone_state(state: dict, cfg, run, device) -> dict:
    """A copy that shares no storage with ``state``."""
    return model_zoo.load_state(model_zoo.export_state(state), cfg, run,
                                device)


def build_train_step(
    cfg: ModelConfig,
    run: RunConfig,
    opt_cfg: opt.OptConfig = opt.OptConfig(),
    mesh=None,
    rules=None,
    donate: bool = True,
    device: str = "cuda",
):
    """Returns ``(step_fn, init_state, None)`` (module docstring).
    ``init_state(seed)`` builds the model's ``init(seed)`` and zeroed optimizer
    state on ``device``, which is the card unless the caller asks for
    another: without one it raises, as ``ServeEngine`` does.  With
    ``donate=False`` the step leaves its input state as it was."""
    if mesh is not None or rules is not None:
        raise NotImplementedError("training over a device mesh is not "
                                  "ported yet (ROADMAP.md A.13.2b)")
    device = bind_device(device)
    loss_fn = model_loss_fn(None, cfg)
    use_ef = run.grad_compression == "topk"

    def init_state(seed: int = 0) -> dict:
        model = model_zoo.build_model(cfg, run, device).init(seed)
        return _fresh_state(model, use_ef)

    def step_fn(state, batch):
        if not isinstance(state["params"], nn.Module):
            state = model_zoo.load_state(state, cfg, run, device)
        elif not donate:
            state = _clone_state(state, cfg, run, device)
        model = state["params"]
        params = model_zoo.param_tree(model)
        flat = [p for leaf in opt.leaves(params) for p in opt.members(leaf)]
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        nmb = run.microbatch
        loss_sum, acc = None, None
        for i in range(nmb):
            mb = _microbatch(batch, nmb, i) if nmb > 1 else batch
            with torch.enable_grad():
                loss = loss_fn(model, mb)
                grads = torch.autograd.grad(loss, flat)
            loss = loss.detach()
            if nmb == 1:
                # 0 + g and g / 1 are exact: the reference's accumulator
                # would hold the gradients as they are
                loss_sum, acc = loss, [g.float() for g in grads]
                continue
            if acc is None:
                loss_sum = torch.zeros((), dtype=torch.float32,
                                       device=loss.device)
                acc = [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in flat]
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

    return step_fn, init_state, None
