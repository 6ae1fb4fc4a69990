"""Serve step builders: the prefill and decode functions of one model —
counterpart of ``repro/serve/serve_step.py`` for one device.

The reference jit-compiles the two with mesh-aware shardings (KV caches
over the data and model axes, ``cache_pspec``, ``_cache_shardings``);
serving over a device mesh is ROADMAP.md A.13.2, so ``mesh`` must be
None here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model_zoo


def build_serve_fns(cfg: ModelConfig, run: RunConfig, mesh=None,
                    max_len: int = 2048, batch: int = 1,
                    cache_dtype=torch.bfloat16, device="cuda"):
    """Returns dict(model, init_cache, prefill, decode, shardings=None,
    rules=None).  ``prefill(params, cache, batch_inputs)`` and
    ``decode(params, cache, token, cache_len)`` return ``(cache,
    logits)``; ``params`` is an LM, or the reference's parameter tree,
    which is loaded into ``model`` (once per tree object)."""
    if mesh is not None:
        raise NotImplementedError("serving over a device mesh is not "
                                  "ported yet (ROADMAP.md A.13.2)")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  "is not ported yet (ROADMAP.md A.13.3)")
    model = model_zoo.build_model(cfg, run, device)
    loaded = [None]

    def _model(params):
        if isinstance(params, torch.nn.Module):
            return params
        if loaded[0] is not params:
            model_zoo.load_params(model, params)
            loaded[0] = params
        return model

    def init_cache():
        return model.init_cache(batch, max_len, cache_dtype)

    @torch.inference_mode()
    def prefill(params, cache, batch_inputs):
        return _model(params).prefill(batch_inputs["tokens"], cache)

    @torch.inference_mode()
    def decode(params, cache, token, cache_len):
        return _model(params).decode_step(token, cache, cache_len)

    return dict(model=model, init_cache=init_cache, prefill=prefill,
                decode=decode, shardings=None, rules=None)
