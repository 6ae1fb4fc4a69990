"""Build a model from a ModelConfig, count its parameters, and carry
weights between the JAX package's parameter tree and the port's modules.

The reference's tree (``LM.init``, or ``state["params"]`` of a
``CheckpointManager`` restore) is ``{"embed": {"tok"}, "final_norm":
{"scale"}, "cycles": {"<i><kind>": block}, "tail": {"<i><kind>": block}}``
plus ``"lm_head"`` when untied, where a block is ``{"ln1": {"scale"},
"attn": {"wq", "wk", "wv", "wo"(, "q_ln", "k_ln")}, "ln2": {"scale"},
"mlp": {"wi", "wo"(, "wg")}}`` and every ``cycles`` leaf is stacked
``[n_cycles, ...]``.  Block ``c·len(pattern) + i`` of the port is
``cycles/<i><kind>[c]``; the tail follows the cycles.

The train state (``train/train_step.py``) is ``{"params": LM, "opt": {"m",
"v", "step"}, "step"[, "ef": {"residual"}]}``, where m, v and the
residual are :func:`param_tree`-shaped: one float32 tensor for each
parameter, a ``cycles`` leaf a list of one tensor a cycle.
:func:`export_state` writes it as the reference's train state (every
``cycles`` leaf stacked) and :func:`load_state` reads that back, so a
checkpoint of either package's train CLI resumes in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, run: RunConfig = RunConfig(), device=None):
    """An uninitialised :class:`LM` on ``device`` (parameters allocated,
    filled by ``LM.init`` or :func:`load_params`).  Encoder-decoder
    configs are ROADMAP.md A.13.3."""
    if cfg.encoder_layers > 0:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP.md A.13.3)")
    return LM(cfg, run, device)


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from (p for _, p in tree.named_parameters())
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    """Parameters of a model or of a parameter tree."""
    return int(sum(int(np.prod(x.shape)) for x in _leaves(params)))


def active_param_count(cfg: ModelConfig, params) -> int:
    """MoE-aware: router + top-k experts only (for MODEL_FLOPS = 6*N_active*D)."""
    n = param_count(params)
    if not cfg.moe:
        return n
    expert = 0

    def walk(tree, path=""):
        nonlocal expert
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + "/" + k)
        elif "/moe/" in path and path.rsplit("/", 1)[-1] in ("wi", "wg", "wo"):
            expert += int(np.prod(tree.shape))
    walk(params)
    inactive = expert * (1 - cfg.experts_per_token / max(cfg.num_experts, 1))
    return int(n - inactive)


def _block_params(blk) -> dict:
    """A block's parameters in the reference's block layout."""
    attn = {"wq": blk.attn.wq, "wk": blk.attn.wk, "wv": blk.attn.wv,
            "wo": blk.attn.wo}
    if blk.cfg.qk_norm:
        attn["q_ln"] = {"scale": blk.attn.q_ln.scale}
        attn["k_ln"] = {"scale": blk.attn.k_ln.scale}
    mlp = {"wi": blk.mlp.wi, "wo": blk.mlp.wo}
    if blk.mlp.wg is not None:
        mlp["wg"] = blk.mlp.wg
    return {"ln1": {"scale": blk.ln1.scale}, "attn": attn,
            "ln2": {"scale": blk.ln2.scale}, "mlp": mlp}


def _layout(model: LM):
    """(path, parameter, index into the leaf's cycle axis or None) for
    every parameter of the model, in the reference tree's paths."""
    out = [(("embed", "tok"), model.embed_tok, None),
           (("final_norm", "scale"), model.final_norm.scale, None)]
    if model.lm_head is not None:
        out.append((("lm_head",), model.lm_head, None))
    pat, n = model.pattern, model.n_full_cycles

    def walk(tree, path, idx):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,), idx)
            else:
                out.append((path + (k,), v, idx))
    for j, blk in enumerate(model.blocks):
        c, i = divmod(j, len(pat))
        if c < n:
            walk(_block_params(blk), ("cycles", f"{i}{blk.kind}"), c)
        else:
            walk(_block_params(blk), ("tail", f"{i}{blk.kind}"), None)
    return out


def _get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            raise KeyError(f"parameter tree has no {'/'.join(path)}")
        tree = tree[k]
    return tree


def load_params(model: LM, tree) -> LM:
    """Copy the reference's parameter tree (numpy arrays or tensors) into
    ``model``; shapes must match exactly, and every parameter of the model
    must be in the tree.  Returns the model."""
    with torch.no_grad():
        for path, p, idx in _layout(model):
            src = _get(tree, path)
            if idx is not None:
                src = src[idx]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.array(src, dtype=np.float32))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: shape "
                                 f"{tuple(src.shape)} does not match the "
                                 f"model's {tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


def _tree_of(model: LM, value) -> dict:
    """The reference's tree with ``value(path, parameter, cycle index or
    None)`` at each parameter, a ``cycles`` leaf the list of its
    per-cycle values."""
    tree: dict = {"cycles": {}, "tail": {}}
    for path, p, idx in _layout(model):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        v = value(path, p, idx)
        if idx is None:
            node[path[-1]] = v
        else:
            node.setdefault(path[-1], []).append(v)
    return tree


def param_tree(model: LM) -> dict:
    """The model's parameters in the reference's tree, a ``cycles`` leaf
    the list of its per-cycle parameters (the optimizer's leaves)."""
    return _tree_of(model, lambda path, p, idx: p)


def _numpy(tree):
    """A tree of tensors as numpy arrays, each list stacked."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return np.stack([_numpy(t) for t in tree])
    return tree.detach().cpu().numpy()


def export_params(model: LM) -> dict:
    """The model's parameters as the reference's tree of float32 numpy
    arrays (``cycles`` leaves stacked), the inverse of
    :func:`load_params`."""
    return _numpy(param_tree(model))


def export_state(state: dict) -> dict:
    """The port's train state as the reference's (numpy; module
    docstring)."""
    out = {"params": export_params(state["params"]),
           "opt": _numpy(state["opt"]), "step": _numpy(state["step"])}
    if "ef" in state:
        out["ef"] = _numpy(state["ef"])
    return out


def _like(model: LM, tree, device) -> dict:
    """``tree`` (the reference's layout, stacked) as float32 tensors on
    ``device`` shaped as :func:`param_tree`."""
    def value(path, p, idx):
        src = _get(tree, path)
        src = _tensor(src if idx is None else src[idx], torch.float32,
                      device)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(src.shape)} "
                             f"does not match the model's {tuple(p.shape)}")
        return src
    return _tree_of(model, value)


def _tensor(x, dtype, device) -> torch.Tensor:
    """A copy of a numpy array or tensor as ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype, copy=True)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def load_state(tree, cfg: ModelConfig, run: RunConfig = RunConfig(),
               device=None) -> dict:
    """The inverse of :func:`export_state`: a new model on ``device``
    holding ``tree["params"]`` (parameters that take gradients), and the
    optimizer (and error-feedback) state as tensors there."""
    model = load_params(build_model(cfg, run, device), tree["params"])
    model.requires_grad_(True)
    opt = tree["opt"]
    state = {"params": model,
             "opt": {"m": _like(model, opt["m"], device),
                     "v": _like(model, opt["v"], device),
                     "step": _tensor(opt["step"], torch.int32, device)},
             "step": _tensor(tree["step"], torch.int32, device)}
    if "ef" in tree:
        state["ef"] = {"residual": _like(model, tree["ef"]["residual"],
                                         device)}
    return state
