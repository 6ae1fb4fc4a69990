"""Serve step builders: the prefill and decode functions of one model,
with mesh-aware shardings — counterpart of ``repro/serve/serve_step.py``.

Over a device mesh (``launch/mesh.py``; every rank calls the functions
with the same inputs) the parameters are DTensors placed by
``sharding.param_specs`` and each cache tensor by :func:`cache_specs`:
KV caches with the batch over the data axes and the kv heads — or, under
``run.seq_shard_decode``, the sequence — over the model axis, recurrent
states with the batch over the data axes.  The reference's cache tree
stacks each ``cycles`` leaf (and an encoder-decoder's ``dec`` and ``xkv``
leaves) as ``[n_stack, ...]``; the port keeps one tensor a block, whose
spec is the leaf's without its stack entry.  At RG-LRU's ``conv`` state
the reference's rule takes the KV rule (its path ends in ``v``) and puts
the data axes on the stack axis; the port places it by the intended
recurrent rule, the batch over the data axes (ROADMAP.md C).
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers, model_zoo
from repro_torch.models import sharding as shd
from repro_torch.models.encdec import EncDecLM


def cache_pspec(path: str, ndim: int, rules: shd.Rules,
                seq_shard: bool = False) -> shd.P:
    """KV leaves: [n_cyc?, B, S, Hkv, Dh]; rnn/rwkv states: [.., B, ...]."""
    dp = rules.dp
    if ndim >= 4:          # kv cache (maybe with leading stack dim)
        spec = [None] * ndim
        spec[-4] = dp
        if seq_shard:
            spec[-3] = rules.tp_axis
        else:
            spec[-2] = rules.tp_axis
        return shd.P(*spec)
    if ndim >= 2:          # recurrent states [.., B, ...]
        spec = [None] * ndim
        if ndim == 2:
            spec[0] = dp
        else:
            spec[-3 if ndim >= 3 else 0] = dp
        return shd.P(*spec)
    return shd.P()


def _state_pspec(ndim: int, rules: shd.Rules) -> shd.P:
    """A recurrent state leaf: the batch over dp (stacked [n, B, ...] vs
    [B, ...])."""
    spec = [None] * ndim
    spec[1 if ndim >= 3 else 0] = rules.dp
    return shd.P(*spec)


def cache_leaf_spec(path: str, ndim: int, stacked: bool, rules: shd.Rules,
                    seq_shard: bool = False) -> shd.P:
    """The spec of one port cache tensor of ``ndim`` dims at the reference
    path ``path`` (``stacked``: the reference stacks it over cycles or
    layers).  The reference's leaf rule (``_cache_shardings``) on the
    stacked shape, without the stack entry; ``conv`` by the recurrent rule
    (module docstring)."""
    if path.split("/")[-1] == "conv":           # [B, W-1, R]
        return shd.P(rules.dp, *([None] * (ndim - 1)))
    full_ndim = ndim + 1 if stacked else ndim
    if path.endswith("k") or path.endswith("v"):
        sp = cache_pspec(path, full_ndim, rules, seq_shard)
    else:
        sp = _state_pspec(full_ndim, rules)
    return shd.P(*sp[1:]) if stacked else sp


def _cache_paths(model, cache):
    """(reference path, stacked, port container, key) of every cache
    tensor, in the reference's cache tree."""
    out = []

    def walk(node, path, stacked):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, path + (k,), stacked)
            elif v is not None:
                out.append(("/".join(path + (k,)), stacked, node, k))

    if isinstance(model, EncDecLM):
        for blk in cache["dec"]:
            walk(blk, ("dec",), True)
        for blk in cache.get("xkv") or []:
            for k, name in (("k", "0"), ("v", "1")):
                out.append((f"xkv/{name}", True, blk, k))
        return out
    pat, n = model.pattern, model.n_full_cycles
    for j, c in enumerate(cache):
        cyc, i = divmod(j, len(pat))
        kind = model.block_kinds[j]
        if cyc < n:
            walk(c, ("cycles", f"{i}{kind}"), True)
        else:
            walk(c, ("tail", f"{i}{kind}"), False)
    return out


def _copy(node):
    """A cache's dicts and lists copied, its tensors shared."""
    if isinstance(node, dict):
        return {k: _copy(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_copy(v) for v in node]
    return node


def cache_specs(model, cache, rules: shd.Rules, mesh=None,
                seq_shard: bool = False):
    """The spec of every tensor of ``cache`` (``model.init_cache``, or a
    prefilled one), in the cache's own structure; with a mesh,
    divisibility-sanitized, except that a KV cache keeps its kv heads
    split over the model axis where its projections split them by whole
    heads (:func:`_heads_follow`)."""
    out = _copy(cache)
    for path, stacked, node, key in _cache_paths(model, out):
        t = node[key]
        sp = cache_leaf_spec(path, t.dim(), stacked, rules, seq_shard)
        if mesh is not None:
            safe = shd.sanitize_spec(sp, t.shape, mesh)
            if _heads_follow(model, sp, safe, t, rules, mesh):
                safe = shd.P(*safe[:2], sp[2], *safe[3:])
            sp = safe
        node[key] = sp
    return out


def _heads_follow(model, spec, safe, t, rules, mesh) -> bool:
    """Whether a KV cache tensor ``t [B, S, Hkv, Dh]`` keeps
    its kv heads split over the model axis although they do not divide
    it: its spec names the axis there, and the kv projections hold whole
    heads a rank there (``layers.kv_split_by_heads``, and the rules split
    their flat width), so the cache holds the heads its rank computes, as
    DTensor splits them."""
    if (t.dim() != 4 or spec[2] != rules.tp_axis or safe[2] is not None
            or rules.tp_axis not in shd.mesh_shape(mesh)):
        return False
    ranks = shd.axis_size(mesh, rules.tp_axis)
    return (layers.kv_split_by_heads(model.cfg)
            and (t.shape[2] * t.shape[3]) % ranks == 0)


def _cache_shardings(model, cache, mesh, rules: shd.Rules,
                     seq_shard: bool = False):
    """The DTensor placements of every cache tensor (:func:`cache_specs`)."""
    out = cache_specs(model, cache, rules, mesh, seq_shard)
    for _, _, node, key in _cache_paths(model, out):
        node[key] = shd.placements(node[key], mesh)
    return out


def _place_cache(model, cache, mesh, rules, seq_shard: bool):
    """Every tensor of ``cache`` placed on the mesh by its spec, in place
    (a DTensor elsewhere redistributed)."""
    want = _cache_shardings(model, cache, mesh, rules, seq_shard)
    for (_, _, node, key), (_, _, wnode, _) in zip(
            _cache_paths(model, cache), _cache_paths(model, want)):
        t, pl = node[key], wnode[key]
        node[key] = (shd.moved(t, pl, mesh) if shd.is_dtensor(t)
                     else shd.distribute_as(t, pl, mesh))
    return cache


def build_serve_fns(cfg: ModelConfig, run: RunConfig, mesh=None,
                    max_len: int = 2048, batch: int = 1,
                    cache_dtype=torch.bfloat16, device="cuda"):
    """Returns dict(model, init_cache, prefill, decode, shardings, rules).
    ``prefill(params, cache, batch_inputs)`` and ``decode(params, cache,
    token, cache_len)`` return ``(cache, logits)``; ``params`` is a model,
    or the reference's parameter tree, which is loaded into ``model``
    (once per tree object).  ``batch_inputs`` holds ``tokens`` and, for an
    encoder-decoder, ``enc_frames`` (the prefilled cache then carries the
    cross-attention K/V), or for a vision frontend ``patch_embeds``.

    Without a mesh ``shardings`` and ``rules`` are None.  With one (module
    docstring) a model passed in is distributed in place and a cache is
    placed by :func:`cache_specs`, each when it first arrives (a cache
    write then writes each rank's shard in place), the inputs
    are sharded over the data axes when ``batch`` divides them and
    replicated otherwise, and the logits come back whole on every rank;
    ``shardings`` holds the parameters' placements and specs and the
    caches' placements before and after an encoder-decoder's prefill."""
    model = model_zoo.build_model(cfg, run, device)
    loaded = [None]
    rules = None
    if mesh is not None:
        rules = shd.Rules(
            dp_axes=tuple(a for a in ("pod", "data")
                          if a in mesh.mesh_dim_names),
            fsdp=run.sharding_mode == "fsdp", zero1=False)
        dp_ok = batch % shd.axis_size(mesh, rules.dp) == 0
        in_spec = shd.P(rules.dp) if dp_ok else shd.P()
    # what these functions placed on the mesh: a model and a cache are
    # placed when they first arrive, not at every call
    placed_models = weakref.WeakSet()
    placed_cache = weakref.WeakValueDictionary()      # id -> cache tensor

    def _model(params):
        m = params
        if not isinstance(params, torch.nn.Module):
            m = model
            if loaded[0] is not params:
                if mesh is not None:
                    shd.undistribute_model_(model)
                    placed_models.discard(model)
                model_zoo.load_params(model, params)
                loaded[0] = params
        if mesh is not None and m not in placed_models:
            shd.distribute_model_(m, mesh, rules)
            placed_models.add(m)
        return m

    def _ctx():
        return shd.use_mesh(mesh, rules)

    def _inputs(x, m):
        x = torch.as_tensor(x, device=m.device)
        return x if mesh is None else shd.distribute(x, in_spec, mesh)

    def _place(m, cache):
        """A cache with a tensor these functions did not place (a new
        one, or an encoder-decoder's after prefill adds the cross K/V)
        placed by :func:`cache_specs`."""
        if mesh is None:
            return cache
        paths = _cache_paths(m, cache)
        if any(placed_cache.get(id(node[key])) is not node[key]
               for _, _, node, key in paths):
            _place_cache(m, cache, mesh, rules, run.seq_shard_decode)
            for _, _, node, key in paths:
                placed_cache[id(node[key])] = node[key]
        return cache

    def init_cache():
        return _place(model, model.init_cache(batch, max_len, cache_dtype))

    def prefill(params, cache, batch_inputs):
        with torch.inference_mode(), _ctx():
            m = _model(params)
            cache = _place(m, cache)
            tokens = _inputs(batch_inputs["tokens"], m)
            if cfg.encoder_layers > 0:
                cache, logits = m.prefill(
                    tokens, cache, _inputs(batch_inputs["enc_frames"], m))
            else:
                extra = batch_inputs.get("patch_embeds")
                cache, logits = m.prefill(
                    tokens, cache,
                    extra_embeds=None if extra is None else _inputs(extra, m))
            return _place(m, cache), shd.full(logits)

    def decode(params, cache, token, cache_len):
        with torch.inference_mode(), _ctx():
            m = _model(params)
            cache = _place(m, cache)
            cache, logits = m.decode_step(_inputs(token, m), cache,
                                          cache_len)
            return cache, shd.full(logits)

    if mesh is None:
        return dict(model=model, init_cache=init_cache, prefill=prefill,
                    decode=decode, shardings=None, rules=None)

    meta = model_zoo.build_model(cfg, run, "meta")
    pspecs = shd.param_specs(meta, rules, mesh)
    cshapes = meta.init_cache(batch, max_len, cache_dtype)
    # decode consumes the *prefilled* cache, whose structure can be richer
    # than init_cache (whisper adds cross-attention K/V at prefill time)
    dec_shapes = cshapes
    if cfg.encoder_layers > 0:
        h, dh = cfg.num_heads, cfg.resolved_head_dim()
        xkv = torch.empty((batch, max_len // 2, h, dh), dtype=cache_dtype,
                          device="meta")
        dec_shapes = {"dec": cshapes["dec"],
                      "xkv": [{"k": xkv, "v": xkv} for _ in meta.decoder]}
    seq = run.seq_shard_decode
    return dict(model=model, init_cache=init_cache, prefill=prefill,
                decode=decode,
                shardings=dict(
                    params=shd.param_shardings(meta, mesh, rules),
                    cache=_cache_shardings(meta, cshapes, mesh, rules, seq),
                    dec_cache=_cache_shardings(meta, dec_shapes, mesh, rules,
                                               seq),
                    specs=pspecs),
                rules=rules)
