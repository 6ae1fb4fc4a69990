"""Batched serving engine with continuous batching (slot refill) —
counterpart of ``repro/serve/engine.py``.

Requests carry their own prompt/length; the engine keeps B cache slots:

  * empty slots are filled one at a time: the request's prompt is
    prefilled into a fresh 1-slot cache, whose state — K/V, RG-LRU's conv
    and h, RWKV6's shifts and state — is inserted into the batched cache,
    with a per-slot cache_len vector;
  * one decode step advances every active slot;
  * finished slots (EOS or max_new) are refilled from the queue.

Every decoder-only family is served: layer kinds ``G``, ``L``, ``R`` and
``K``, mixture-of-experts FFNs, and a vision frontend's text path (a
request carries tokens only).  An encoder-decoder config is refused: its
prefill needs ``enc_frames``, which a request does not carry (the
reference's engine dies on it, ROADMAP.md C); serve it through
``serve_step.build_serve_fns``.  The engine runs on one device,
``"cuda"`` by default, and raises when CUDA is asked for and PyTorch sees
no card; it never falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model_zoo
from repro_torch.serve.graph_service import bind_device


@dataclasses.dataclass
class Request:
    """One serving request: prompt token ids plus decode limits."""

    rid: int
    prompt: np.ndarray           # [L] int32
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 => greedy
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    """Finished request: generated tokens + prefill/decode wall time."""

    rid: int
    tokens: list
    prefill_s: float = 0.0
    decode_s: float = 0.0


def _insert_slot(batched, single, slot: int):
    """Insert a 1-batch cache (a list of per-block dicts of tensors, nested
    for ``K``) into slot ``slot`` of a batched cache, in place — batch
    axis 0 of every tensor (the reference's axis 1 under its stacked
    ``cycles``)."""
    if isinstance(batched, torch.Tensor):
        batched[slot] = single[0]
        return batched
    items = (batched.items() if isinstance(batched, dict)
             else enumerate(batched))
    for key, full in items:
        _insert_slot(full, single[key], slot)
    return batched


def check_servable(cfg: ModelConfig) -> None:
    """Raise ValueError for an encoder-decoder config (module docstring)."""
    if cfg.encoder_layers > 0:
        raise ValueError(
            f"{cfg.name}: ServeEngine serves decoder-only models; an "
            "encoder-decoder's prefill needs enc_frames, which a request "
            "does not carry (the reference's engine calls model.prefill "
            "without them and dies with a TypeError).  Serve it through "
            "serve_step.build_serve_fns.")


class ServeEngine:
    """Continuous-batching engine over a fixed pool of cache slots:
    per-slot prefill fills empty slots, one decode step advances every
    active slot, finished slots refill from the queue (module docstring).
    ``params``: an LM (served as it is, moved to ``device``), or the
    reference's parameter tree (loaded into a new LM by
    ``model_zoo.load_params``).  Single-threaded — callers serialize
    access themselves."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params,
                 slots: int = 4, max_len: int = 512,
                 cache_dtype=torch.float32, device: str = "cuda"):
        check_servable(cfg)
        self.device = torch.device(bind_device(device))
        self.cfg = cfg
        self.run = run
        if isinstance(params, torch.nn.Module):
            self.model = params.to(self.device)
        else:
            self.model = model_zoo.load_params(
                model_zoo.build_model(cfg, run, self.device), params)
        self.slots = slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.cache = self.model.init_cache(slots, max_len, cache_dtype)
        self.cache_len = np.zeros(slots, np.int32)
        self.active = np.zeros(slots, bool)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_out: list[list] = [[] for _ in range(slots)]
        self.stats = dict(prefill_calls=0, decode_steps=0, tokens=0)

    def single_cache_fn(self) -> list:
        return self.model.init_cache(1, self.max_len, self.cache_dtype)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _fill_slot(self, slot: int, req: Request) -> None:
        t0 = time.perf_counter()
        sc = self.single_cache_fn()
        toks = torch.as_tensor(np.asarray(req.prompt, np.int32),
                               device=self.device)[None, :]
        sc, logits = self.model.prefill(toks, sc)
        self.cache = _insert_slot(self.cache, sc, slot)
        nxt = self._sample(logits[0, -1], req, step=0)
        self.cache_len[slot] = len(req.prompt)
        self.active[slot] = True
        self.slot_req[slot] = req
        self.slot_out[slot] = [int(nxt)]
        self.stats["prefill_calls"] += 1
        self._prefill_s = time.perf_counter() - t0

    def _sample(self, logits, req: Request, step: int):
        """Sample the next token; ``step`` is this request's decode-step
        counter, so the (rid, step) seed pair is fresh every step but a
        rerun of the same request reproduces the same sequence.  Greedy
        takes the first maximum; sampling draws with numpy's
        ``default_rng((rid, step))`` from the softmax of ``logits / T`` in
        float64, divided by its float64 sum.  The reference divides by the
        float32 sum, which numpy's ``choice`` refuses when it is off by
        more than ~1.5e-8 (ROADMAP.md C); where it accepts, the draws are
        the same."""
        logits = torch.as_tensor(logits)
        if req.temperature <= 0:
            return int(torch.argmax(logits))
        p = torch.softmax(logits / req.temperature, dim=-1)
        p = p.double().cpu().numpy()
        return int(np.random.default_rng((req.rid, step)).choice(
            len(p), p=p / p.sum()))

    def _slot_done(self, slot: int) -> bool:
        req = self.slot_req[slot]
        out = self.slot_out[slot]
        if len(out) >= req.max_new_tokens:
            return True
        if req.eos_id is not None and out and out[-1] == req.eos_id:
            return True
        if self.cache_len[slot] + len(out) >= self.max_len - 1:
            return True
        return False

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def run_requests(self, requests: list[Request]) -> list[Completion]:
        """Serve ``requests`` to completion with slot refill; completions
        are returned in finish order, not submission order."""
        queue = list(requests)
        done: list[Completion] = []
        completions: dict[int, Completion] = {}

        while queue or self.active.any():
            # refill empty slots (continuous batching)
            for s in range(self.slots):
                if not self.active[s] and queue:
                    req = queue.pop(0)
                    self._fill_slot(s, req)
                    completions[req.rid] = Completion(req.rid, [],
                                                      prefill_s=self._prefill_s)
            if not self.active.any():
                break

            # one decode step for every slot (inactive slots decode garbage,
            # results discarded — the batched step is a single call)
            last = np.zeros((self.slots, 1), np.int32)
            for s in range(self.slots):
                if self.active[s]:
                    last[s, 0] = self.slot_out[s][-1]
            t0 = time.perf_counter()
            cl = torch.as_tensor(self.cache_len + np.maximum(
                np.array([len(o) for o in self.slot_out]) - 1, 0),
                dtype=torch.int32, device=self.device)
            self.cache, logits = self.model.decode_step(
                torch.as_tensor(last, device=self.device), self.cache, cl)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.stats["decode_steps"] += 1

            for s in range(self.slots):
                if not self.active[s]:
                    continue
                req = self.slot_req[s]
                nxt = self._sample(logits[s, -1], req,
                                   step=len(self.slot_out[s]))
                self.slot_out[s].append(int(nxt))
                completions[req.rid].decode_s += dt / max(self.active.sum(), 1)
                self.stats["tokens"] += 1
                if self._slot_done(s):
                    comp = completions[req.rid]
                    comp.tokens = list(self.slot_out[s])
                    done.append(comp)
                    self.active[s] = False
                    self.slot_req[s] = None
        return done
