"""Build a model from a ModelConfig, count its parameters, and carry
weights between the JAX package's parameter tree and the port's modules.

The reference's decoder-only tree (``LM.init``, or ``state["params"]`` of
a ``CheckpointManager`` restore) is ``{"embed": {"tok"}, "final_norm":
{"scale"}, "cycles": {"<i><kind>": block}, "tail": {"<i><kind>": block}}``
plus ``"lm_head"`` when untied, where every ``cycles`` leaf is stacked
``[n_cycles, ...]``.  A block is ``{"ln1", "attn": {"wq", "wk", "wv",
"wo"(, "q_ln", "k_ln")}, "ln2", "mlp": {"wi", "wo"(, "wg")}}`` for ``G``
and ``L`` — ``"moe": {"router", "wi", "wg", "wo"}`` in place of ``mlp``
with ``cfg.moe`` —, ``{"ln1", "rnn": {"wx", "wy", "conv", "gate_a",
"gate_x", "a_param", "wo"}, "ln2", "mlp"}`` for ``R`` and ``{"ln1",
"ln2", "rwkv": {"tmix": {"mix", "wr", "wk", "wv", "wg", "w_decay",
"decay_lora_a", "decay_lora_b", "u", "ln_out", "wo"}, "cmix": {"mix",
"wk", "wv", "wr"}}}`` for ``K`` (a norm is ``{"scale"}``).  Block
``c·len(pattern) + i`` of the port is ``cycles/<i><kind>[c]``; the tail
follows the cycles.  The encoder-decoder's tree is ``{"embed": {"tok"},
"encoder": enc block, "enc_norm", "decoder": dec block, "final_norm"}``,
every ``encoder`` and ``decoder`` leaf stacked over its layers: an enc
block is ``{"ln1", "attn", "ln2", "mlp"}``, a dec block adds ``"ln_x"``
and ``"cross": {"wq", "wk", "wv", "wo"}``.

The train state (``train/train_step.py``) is ``{"params": model, "opt":
{"m", "v", "step"}, "step"[, "ef": {"residual"}]}``, where m, v and the
residual are :func:`param_tree`-shaped: one float32 tensor for each
parameter, a stacked leaf a list of one tensor a cycle or layer.
:func:`export_state` writes it as the reference's train state (every
``cycles`` leaf stacked) and :func:`load_state` reads that back, so a
checkpoint of either package's train CLI resumes in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.sharding import full, heads_of
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, run: RunConfig = RunConfig(), device=None):
    """An uninitialised :class:`EncDecLM` for ``encoder_layers > 0``, else
    an :class:`LM`, on ``device`` (parameters allocated, filled by
    ``init`` or :func:`load_params`)."""
    if cfg.encoder_layers > 0:
        return EncDecLM(cfg, run, device)
    return LM(cfg, run, device)


def init_on_mesh(model, seed: int, mesh, rules, device):
    """``model.init(seed)`` for a model built on the meta device, each rank
    keeping only its shards: leaf by leaf in ``init``'s order, from
    ``init``'s generator on ``device``, each leaf made whole there, drawn,
    its shard kept as a DTensor placed by ``sharding.param_specs`` (by
    whole heads where ``sharding.leaf_heads`` says so), and the leaf
    freed.  Each shard equals bit for bit the shard of the whole
    ``init(seed)`` on ``device``; the peak this adds is one whole leaf.
    Returns the model."""
    from repro_torch.models import layers
    from repro_torch.models import sharding as shd

    pl = shd.param_placements(model, mesh, rules)

    def make(module, name, fill):
        p = module._parameters[name]
        whole = torch.empty(p.shape, dtype=p.dtype, device=device)
        with torch.no_grad():
            fill(whole)
        heads = shd.leaf_heads(module, name, pl[id(p)], mesh, rules)
        module._parameters[name] = shd.parameter(
            shd.own_shard(whole, pl[id(p)], mesh, heads), p.requires_grad)
    with layers.leaf_by_leaf(make, device):
        model.init(seed)
    return model


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from (p for _, p in tree.named_parameters())
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    """Parameters of a model or of a parameter tree."""
    return int(sum(int(np.prod(x.shape)) for x in _leaves(params)))


def active_param_count(cfg: ModelConfig, params) -> int:
    """MoE-aware: router + top-k experts only (for MODEL_FLOPS =
    6*N_active*D).  ``params``: a model or the reference's tree."""
    n = param_count(params)
    if not cfg.moe:
        return n
    if isinstance(params, nn.Module):
        params = param_tree(params)
    expert = 0

    def walk(tree, path=""):
        nonlocal expert
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + "/" + k)
        elif "/moe/" in path and path.rsplit("/", 1)[-1] in ("wi", "wg", "wo"):
            expert += sum(int(np.prod(t.shape)) for t in
                          (tree if isinstance(tree, list) else [tree]))
    walk(params)
    inactive = expert * (1 - cfg.experts_per_token / max(cfg.num_experts, 1))
    return int(n - inactive)


def _norm(n) -> dict:
    return {"scale": n.scale}


def _attn_params(attn) -> dict:
    out = {"wq": attn.wq, "wk": attn.wk, "wv": attn.wv, "wo": attn.wo}
    if attn.cfg.qk_norm:
        out["q_ln"] = _norm(attn.q_ln)
        out["k_ln"] = _norm(attn.k_ln)
    return out


def _mlp_params(mlp) -> dict:
    out = {"wi": mlp.wi, "wo": mlp.wo}
    if mlp.wg is not None:
        out["wg"] = mlp.wg
    return out


def _block_params(blk) -> dict:
    """A block's parameters in the reference's block layout."""
    if blk.kind == "K":
        tm, cm = blk.rwkv.tmix, blk.rwkv.cmix
        return {"ln1": _norm(blk.ln1), "ln2": _norm(blk.ln2), "rwkv": {
            "tmix": {"mix": tm.mix, "wr": tm.wr, "wk": tm.wk, "wv": tm.wv,
                     "wg": tm.wg, "w_decay": tm.w_decay,
                     "decay_lora_a": tm.decay_lora_a,
                     "decay_lora_b": tm.decay_lora_b, "u": tm.u,
                     "ln_out": _norm(tm.ln_out), "wo": tm.wo},
            "cmix": {"mix": cm.mix, "wk": cm.wk, "wv": cm.wv,
                     "wr": cm.wr}}}
    out = {"ln1": _norm(blk.ln1), "ln2": _norm(blk.ln2)}
    if blk.kind == "R":
        r = blk.rnn
        out["rnn"] = {"wx": r.wx, "wy": r.wy, "conv": r.conv,
                      "gate_a": r.gate_a, "gate_x": r.gate_x,
                      "a_param": r.a_param, "wo": r.wo}
    else:
        out["attn"] = _attn_params(blk.attn)
    if hasattr(blk, "moe"):
        m = blk.moe
        out["moe"] = {"router": m.router, "wi": m.wi, "wg": m.wg,
                      "wo": m.wo}
    else:
        out["mlp"] = _mlp_params(blk.mlp)
    return out


def _enc_block_params(blk) -> dict:
    return {"ln1": _norm(blk.ln1), "attn": _attn_params(blk.attn),
            "ln2": _norm(blk.ln2), "mlp": _mlp_params(blk.mlp)}


def _dec_block_params(blk) -> dict:
    c = blk.cross
    return {"ln1": _norm(blk.ln1), "attn": _attn_params(blk.attn),
            "ln_x": _norm(blk.ln_x),
            "cross": {"wq": c.wq, "wk": c.wk, "wv": c.wv, "wo": c.wo},
            "ln2": _norm(blk.ln2), "mlp": _mlp_params(blk.mlp)}


def _layout(model):
    """(path, parameter, index into the leaf's stack axis or None) for
    every parameter of the model, in the reference tree's paths."""
    out = []

    def walk(tree, path, idx):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,), idx)
            else:
                out.append((path + (k,), v, idx))

    if isinstance(model, EncDecLM):
        walk({"embed": {"tok": model.embed_tok},
              "enc_norm": _norm(model.enc_norm),
              "final_norm": _norm(model.final_norm)}, (), None)
        for j, blk in enumerate(model.encoder):
            walk(_enc_block_params(blk), ("encoder",), j)
        for j, blk in enumerate(model.decoder):
            walk(_dec_block_params(blk), ("decoder",), j)
        return out
    out += [(("embed", "tok"), model.embed_tok, None),
            (("final_norm", "scale"), model.final_norm.scale, None)]
    if model.lm_head is not None:
        out.append((("lm_head",), model.lm_head, None))
    pat, n = model.pattern, model.n_full_cycles
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


def load_params(model, tree):
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


def _tree_of(model, value) -> dict:
    """The reference's tree with ``value(path, parameter, stack index or
    None)`` at each parameter, a stacked leaf the list of its per-cycle
    (or per-layer) values."""
    tree: dict = {} if isinstance(model, EncDecLM) else {"cycles": {},
                                                         "tail": {}}
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


def param_tree(model) -> dict:
    """The model's parameters in the reference's tree, a ``cycles`` leaf
    the list of its per-cycle parameters (the optimizer's leaves)."""
    return _tree_of(model, lambda path, p, idx: p)


def _numpy(tree, host: bool = True):
    """A tree of tensors as numpy arrays, each list stacked; a DTensor
    (a model or state on a device mesh) gathered whole first.  With
    ``host=False``, as whole tensors where they lie."""
    if isinstance(tree, dict):
        return {k: _numpy(v, host) for k, v in tree.items()}
    if isinstance(tree, list):
        parts = [_numpy(t, host) for t in tree]
        return np.stack(parts) if host else torch.stack(parts)
    t = full(tree.detach(), heads_of(tree))
    # a copy: a CPU tensor's numpy() would alias the live state
    return t.to("cpu", copy=True).numpy() if host else t


def export_params(model, host: bool = True) -> dict:
    """The model's parameters as the reference's tree of float32 numpy
    arrays (``cycles`` leaves stacked), the inverse of
    :func:`load_params`; whole tensors where they lie with
    ``host=False``."""
    return _numpy(param_tree(model), host)


def export_state(state: dict, host: bool = True) -> dict:
    """The port's train state as the reference's (numpy; module
    docstring).  Over a device mesh every leaf is gathered whole, so the
    tree is the one the mesh-free state gives.  With ``host=False`` the
    leaves are whole tensors where they lie."""
    out = {"params": export_params(state["params"], host),
           "opt": _numpy(state["opt"], host),
           "step": _numpy(state["step"], host)}
    if "ef" in state:
        out["ef"] = _numpy(state["ef"], host)
    return out


def _like(model, tree, device) -> dict:
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
