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


def export_params(model: LM) -> dict:
    """The model's parameters as the reference's tree of float32 numpy
    arrays (``cycles`` leaves stacked), the inverse of
    :func:`load_params`."""
    tree: dict = {"cycles": {}, "tail": {}}
    stacks: dict = {}
    for path, p, idx in _layout(model):
        arr = p.detach().float().cpu().numpy()
        if idx is not None:
            stacks.setdefault(path, []).append(arr)
            continue
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    for path, arrs in stacks.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack(arrs)
    return tree
