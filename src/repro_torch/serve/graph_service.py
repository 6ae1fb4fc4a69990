"""Online graph-query serving over step-driven engine sessions — the
port's counterpart of ``repro/serve/graph_service.py``, with the same
names, semantics, counters and lock declarations, over the port's engine
(DESIGN.md §13; beyond the GraphH paper, which is batch-only).

The batch engine already retires converged query columns mid-run;
:class:`~repro_torch.core.engine.EngineSession` adds the inverse — splicing
fresh queries into the freed ``[V, Q]`` slots at a barrier.  This module
turns that pair into a long-running service:

  * ``submit(app, seed)`` (any thread) queues a query and returns a
    :class:`QueryTicket`;
  * the serve loop (ONE serving thread — run ``serve()`` in the main
    thread so the SIGTERM guard is live) opens one engine session per
    app family, steps the live sessions round-robin, and admits queued
    queries at barriers under a **batched admission policy**: wait until
    ``min_fill`` queries are queued (amortizing the all-dirty superstep
    an admission forces) but never past ``max_wait_s``;
  * per-query **deadlines**: a live query past its deadline is drained
    at the next barrier — its ticket finishes with status ``timeout``
    and the partial column as the result;
  * per-query **latency accounting**: queue wait, service time, total,
    and the superstep count (identical to a fresh single-query run's,
    by the admission-equivalence invariant);
  * **graceful drain** on SIGTERM (or ``request_drain()``): admission
    stops, in-flight queries either run to convergence
    (``drain_mode="finish"``) or the sessions checkpoint with their
    per-slot query lineage (``drain_mode="checkpoint"``, resumable via
    ``resume=True``), then ``serve()`` returns — exit 0.

Sessions are ephemeral: when a session finishes (everything converged,
nothing queued for its app) it is finalized and discarded; the next
submit for that app opens a fresh one.  Engines — and their edge-tile
caches, skip filters, interval bookkeeping — persist for the service
lifetime, so a new session starts with warm caches.

The device: a CUDA ``cfg.device`` is pinned to an explicit ``cuda:<i>``
when the service is built (and raises there when PyTorch sees no card),
because torch's current device is per thread and the serve loop may run
on another thread than the one that built the service; ``serve()`` makes
that card current on its thread.  Only the serve loop steps the engines.
Tickets, the result cache and the HTTP frontend hold host numpy arrays
only: ``EngineSession.query_result`` copies a column off the card once.

Multi-tenant fairness (DESIGN.md §16): every submit carries a ``tenant``
label, pending queries queue **per tenant**, and each admit-at-barrier
selects across the backlogged tenants by **weighted deficit round-robin**
— tenant ``t`` earns ``weight[t]`` credit per round and spends one credit
per admitted query, so over any sustained backlog the admitted shares
track the configured weights within one query and a hot tenant can never
starve the others.  Idle tenants bank no credit (their deficit resets),
so fairness is work-conserving.

Result cache: with a :class:`ResultCache` attached, a submit whose
``(app, seed, graph fingerprint)`` was served before returns the cached
column immediately — ``status="done"``, ``cache_hit=True``, no ``[V, Q]``
slot consumed, no admission barrier.  Only converged (``done``) results
are cached; deadline-drained partials never are.  The fingerprint
(:meth:`~repro_torch.graphio.formats.TileStore.fingerprint`, equal to the
reference's for one store) keys the cache to the preprocessed graph
bytes, so one cache instance may safely front several services over
different graphs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.apps import APPS
from repro_torch.core.engine import EngineConfig, OutOfCoreEngine
from repro_torch.runtime.ft import PreemptionGuard

#: app families the service accepts: batched [V, Q] programs only (the
#: admission protocol splices query columns; 1-D programs have none)
SERVABLE = ("ppr", "msbfs", "landmarks")

#: tenant label used when a submit does not name one
DEFAULT_TENANT = "default"


def parse_tenants(spec: str) -> dict[str, float]:
    """Parse a CLI tenant-weight spec, e.g. ``"alice:3,bob:1"`` (a bare
    name means weight 1).  Weights must be positive."""
    out: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, w = part.split(":", 1)
            weight = float(w)
        else:
            name, weight = part, 1.0
        name = name.strip()
        if not name:
            raise ValueError(f"--tenants: empty tenant name in {spec!r}")
        if not weight > 0:
            raise ValueError(f"--tenants: weight for {name!r} must be "
                             f"positive, got {weight:g}")
        out[name] = weight
    if not out:
        raise ValueError(f"--tenants: no tenants in {spec!r}")
    return out


class ResultCache:
    """Exact, thread-safe LRU result cache for served queries.

    Keys are ``(app, seed, graph_fingerprint)`` — the fingerprint scopes
    entries to one preprocessed graph, so a shared cache never serves a
    result across differing graphs.  Values are the frozen [V] column and
    its superstep count; ``get`` returns defensive copies, so a hit is
    bit-identical to the cold execution that populated it and immune to
    caller mutation."""

    #: lock discipline, enforced by tools/analyze.py --check locks
    _guarded_by = {"_entries": "_lock", "hits": "_lock", "misses": "_lock"}

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: dict = {}          # key -> (values [V], supersteps)
        self.hits = 0
        self.misses = 0

    def get(self, app: str, seed: int, fingerprint: str):
        """``(values [V], supersteps)`` for a hit (fresh copies), else
        None; counts the hit/miss either way."""
        key = (app, int(seed), fingerprint)
        with self._lock:
            hit = self._entries.pop(key, None)
            if hit is None:
                self.misses += 1
                return None
            self._entries[key] = hit      # re-insert = LRU touch
            self.hits += 1
            values, supersteps = hit
            return values.copy(), supersteps

    def put(self, app: str, seed: int, fingerprint: str,
            values: np.ndarray, supersteps: int) -> None:
        """Insert one converged result (the caller promises exactness —
        drained partials must not be cached); evicts LRU past capacity."""
        key = (app, int(seed), fingerprint)
        with self._lock:
            self._entries.pop(key, None)
            self._entries[key] = (np.asarray(values).copy(),
                                  int(supersteps))
            while len(self._entries) > self.capacity:
                self._entries.pop(next(iter(self._entries)))

    def snapshot(self) -> dict:
        """Hit/miss/entry counters (stats surface)."""
        with self._lock:
            return dict(hits=self.hits, misses=self.misses,
                        entries=len(self._entries),
                        capacity=self.capacity)


@dataclasses.dataclass
class QueryTicket:
    """One submitted query's lifecycle + latency record.

    ``status``: queued → running → done | timeout (``failed`` when the
    service shut down before the query could finish).  ``result`` holds
    the query's [V] value column once finished (partial values for
    timeouts).  Times are ``time.perf_counter()`` seconds.
    """

    rid: int
    app: str
    seed: int
    tenant: str = DEFAULT_TENANT
    deadline_s: Optional[float] = None
    cache_hit: bool = False
    submitted_s: float = 0.0
    status: str = "queued"
    gq: int = -1                     # global qid inside the app's session
    admitted_s: float = 0.0
    finished_s: float = 0.0
    supersteps: int = -1
    result: Optional[np.ndarray] = None
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    @property
    def queue_wait_s(self) -> float:
        """Seconds from submit to admission at a barrier."""
        return max(0.0, self.admitted_s - self.submitted_s)

    @property
    def service_s(self) -> float:
        """Seconds from admission to retirement (or drain)."""
        return max(0.0, self.finished_s - self.admitted_s)

    @property
    def total_s(self) -> float:
        """Submit-to-finish latency — what the client observes."""
        return max(0.0, self.finished_s - self.submitted_s)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the query finished (done/timeout/failed)."""
        return self._event.wait(timeout)


def bind_device(device: str) -> str:
    """``device`` with a CUDA device pinned to an explicit index (the
    current device of the calling thread when it names none); other
    devices unchanged.  Raises when CUDA is asked for and PyTorch sees no
    card — the service never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but PyTorch sees "
                           "no CUDA device")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return f"cuda:{index}"


class GraphService:
    """Long-running graph-query service over one TileStore (module
    docstring).  ``cfg`` is the engine config template; the service
    forces ``preemptible=False`` (it owns the SIGTERM guard — the engine
    must not race it for the handlers), pins ``cfg.device`` to one card
    (:func:`bind_device`) and fans out per-app checkpoint directories
    under ``cfg.checkpoint_dir`` when one is set."""

    # ``_wake`` is a Condition wrapping ``_lock`` — either name guards.
    # ``_sessions``/``completed`` are serve-thread-owned by design and
    # deliberately undeclared.
    _guarded_by = {
        "_pending": ("_lock", "_wake"),
        "_live": ("_lock", "_wake"),
        "_tickets": ("_lock", "_wake"),
        "_deficit": ("_lock", "_wake"),
        "_next_rid": ("_lock", "_wake"),
        "_draining": ("_lock", "_wake"),
        "_stopped": ("_lock", "_wake"),
        "stats": ("_lock", "_wake"),
        "tenant_stats": ("_lock", "_wake"),
    }

    def __init__(self, store, cfg: EngineConfig, *,
                 q_slots: int = 8,
                 min_fill: int = 1,
                 max_wait_s: float = 0.05,
                 default_deadline_s: Optional[float] = None,
                 max_supersteps: int = 200,
                 drain_mode: str = "finish",
                 resume: bool = False,
                 tenants: Optional[dict] = None,
                 result_cache=None):
        if drain_mode not in ("finish", "checkpoint"):
            raise ValueError(f"drain_mode {drain_mode!r}")
        if drain_mode == "checkpoint" and not cfg.checkpoint_dir:
            raise ValueError("drain_mode='checkpoint' needs a "
                             "cfg.checkpoint_dir")
        self.store = store
        self.cfg = dataclasses.replace(cfg, preemptible=False,
                                       resume=resume,
                                       device=bind_device(cfg.device))
        self.q_slots = max(1, int(q_slots))
        self.min_fill = max(1, int(min_fill))
        self.max_wait_s = float(max_wait_s)
        self.default_deadline_s = default_deadline_s
        self.max_supersteps = int(max_supersteps)
        self.drain_mode = drain_mode
        #: configured tenant -> weight map (None = every tenant weight 1);
        #: unknown tenants are admitted at weight 1, never rejected
        self.tenants = dict(tenants) if tenants else None
        if self.tenants and any(w <= 0 for w in self.tenants.values()):
            raise ValueError("tenant weights must be positive")
        #: exact result cache (shared ResultCache, an int capacity, or None)
        if isinstance(result_cache, int):
            result_cache = (ResultCache(result_cache) if result_cache > 0
                            else None)
        self.cache: Optional[ResultCache] = result_cache
        self.fingerprint = store.fingerprint()
        self.num_vertices = int(store.load_plan().num_vertices)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        #: pending queues keyed app -> tenant -> FIFO ticket list
        self._pending: dict[str, dict[str, list[QueryTicket]]] = {}
        #: deficit-round-robin credit, keyed app -> tenant
        self._deficit: dict[str, dict[str, float]] = {}
        self._live: dict[str, dict[int, QueryTicket]] = {}
        self._tickets: dict[int, QueryTicket] = {}
        self._engines: dict[str, OutOfCoreEngine] = {}
        self._sessions: dict = {}
        self._next_rid = 0
        self._draining = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.guard = PreemptionGuard()
        self.completed: list[QueryTicket] = []
        self.stats = dict(submitted=0, done=0, timeout=0, failed=0,
                          refused=0, cache_hits=0, cache_misses=0,
                          supersteps=0, sessions_opened=0)
        #: per-tenant submitted/admitted/done counters (fairness audit)
        self.tenant_stats: dict[str, dict] = {}
        if resume and cfg.checkpoint_dir:
            self._resume_sessions()

    # -- client surface ----------------------------------------------------
    def submit(self, app: str, seed: int,
               deadline_s: Optional[float] = None,
               tenant: str = DEFAULT_TENANT) -> QueryTicket:
        """Queue one query (thread-safe); returns its ticket.  A result-
        cache hit resolves the ticket immediately (``cache_hit=True``, no
        slot consumed).  Raises ``RuntimeError`` once the service is
        draining — clients must back off (HTTP maps this to 503), and the
        refusal is counted so ``submitted == done + timeout + failed +
        refused`` holds at drain."""
        if app not in SERVABLE:
            raise ValueError(f"app {app!r} not servable (batched apps "
                             f"only: {', '.join(SERVABLE)})")
        seed = int(seed)
        if not 0 <= seed < self.num_vertices:
            raise ValueError(f"seed {seed} outside [0, "
                             f"{self.num_vertices}) for this graph")
        tenant = str(tenant) or DEFAULT_TENANT
        hit = (self.cache.get(app, seed, self.fingerprint)
               if self.cache is not None else None)
        with self._lock:
            self.stats["submitted"] += 1
            ts = self.tenant_stats.setdefault(
                tenant, dict(submitted=0, admitted=0, done=0, refused=0))
            ts["submitted"] += 1
            if self._draining or self._stopped:
                self.stats["refused"] += 1
                ts["refused"] += 1
                raise RuntimeError("service is draining — not admitting")
            now = time.perf_counter()
            t = QueryTicket(rid=self._next_rid, app=app, seed=seed,
                            tenant=tenant,
                            deadline_s=(deadline_s if deadline_s is not None
                                        else self.default_deadline_s),
                            submitted_s=now)
            self._next_rid += 1
            self._tickets[t.rid] = t
            if hit is not None:
                values, supersteps = hit
                t.cache_hit = True
                t.status = "done"
                t.admitted_s = t.finished_s = now
                t.result = values
                t.supersteps = supersteps
                self.stats["done"] += 1
                self.stats["cache_hits"] += 1
                ts["done"] += 1
                self.completed.append(t)
                t._event.set()
                return t
            if self.cache is not None:
                self.stats["cache_misses"] += 1
            self._pending.setdefault(app, {}).setdefault(
                tenant, []).append(t)
            self._wake.notify()
        return t

    def get(self, rid: int) -> Optional[QueryTicket]:
        """Look up a ticket by request id (thread-safe); None if unknown —
        the HTTP frontend's GET /v1/query/<rid> backend."""
        with self._lock:
            return self._tickets.get(int(rid))

    def request_drain(self) -> None:
        """Begin graceful drain (what SIGTERM triggers): stop admitting,
        finish or checkpoint in-flight work, then ``serve()`` returns."""
        with self._lock:
            self._draining = True
            self._wake.notify()

    # -- serve loop --------------------------------------------------------
    def serve(self) -> None:
        """Run the serve loop until drained.  Call from the MAIN thread
        for live SIGTERM handling (``PreemptionGuard`` is inert
        elsewhere); background use goes through ``start()`` +
        ``request_drain()``.  The service's card is this thread's current
        device while the loop runs."""
        dev = torch.device(self.cfg.device)
        on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
        with self.guard, on_card:
            try:
                while True:
                    if self.guard.triggered:
                        with self._lock:
                            self._draining = True
                    if self._tick():
                        break
            finally:
                self._shutdown()

    def start(self) -> threading.Thread:
        """Run ``serve()`` on a daemon thread (benchmarks/tests; SIGTERM
        latching is inert off-main-thread — use ``request_drain()``)."""
        self._thread = threading.Thread(target=self.serve,
                                        name="graph-serve", daemon=True)
        self._thread.start()
        return self._thread

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the ``start_background()`` serve thread to exit."""
        if self._thread is not None:
            self._thread.join(timeout)

    def _weight(self, tenant: str) -> float:
        """Configured DRR weight; unknown tenants serve at weight 1."""
        return float((self.tenants or {}).get(tenant, 1.0))

    def _pending_count(self, app: str) -> int:
        """Queued tickets for ``app`` across tenants (under the lock)."""
        return sum(len(q) for q in self._pending.get(app, {}).values())

    def _oldest_pending_s(self, app: str) -> float:
        """Earliest submit time still queued for ``app`` (under the
        lock); +inf when nothing is queued."""
        heads = [q[0].submitted_s
                 for q in self._pending.get(app, {}).values() if q]
        return min(heads) if heads else float("inf")

    def _drr_take(self, app: str, k: int) -> list:
        """Select up to ``k`` pending tickets for ``app`` by weighted
        deficit round-robin across its tenants (module docstring); called
        under the lock.  Each round every backlogged tenant — cycled in
        sorted order, so selection is deterministic — earns ``weight``
        credit and spends one credit per admitted query; a tenant whose
        queue empties forfeits its banked credit.  Terminates: credit
        strictly grows per round while a tenant is backlogged, so any
        positive weight admits within ``ceil(1/weight)`` rounds."""
        queues = self._pending.get(app)
        if not queues:
            return []
        deficit = self._deficit.setdefault(app, {})
        batch: list = []
        while len(batch) < k:
            backlogged = sorted(t for t, q in queues.items() if q)
            if not backlogged:
                break
            for t in list(deficit):
                if not queues.get(t):
                    del deficit[t]          # idle tenants bank no credit
            for tenant in backlogged:
                deficit[tenant] = (deficit.get(tenant, 0.0)
                                   + self._weight(tenant))
                q = queues[tenant]
                while q and deficit[tenant] >= 1.0 and len(batch) < k:
                    batch.append(q.pop(0))
                    deficit[tenant] -= 1.0
        return batch

    def _admit_batch(self, app: str, sess, batch) -> None:
        """Splice a DRR-selected batch into the session's free slots and
        mark the tickets running (under the lock)."""
        if not batch:
            return
        gqs = sess.admit([t.seed for t in batch])
        now = time.perf_counter()
        for t, g in zip(batch, gqs):
            t.gq = g
            t.status = "running"
            t.admitted_s = now
            self._live[app][g] = t
            self.tenant_stats.setdefault(
                t.tenant,
                dict(submitted=0, admitted=0, done=0,
                     refused=0))["admitted"] += 1

    def _tick(self) -> bool:
        """One serve-loop iteration; True when fully drained."""
        now = time.perf_counter()
        with self._lock:
            draining = self._draining
            if draining and self.drain_mode == "checkpoint":
                return True    # _shutdown checkpoints the live sessions
            # open sessions for apps whose batching policy fired
            for app in list(self._pending):
                if not self._pending_count(app) or draining:
                    continue
                if app not in self._sessions:
                    sess = self._open_session(app)
                    if sess is not None:
                        continue    # first batch rode the open
                sess = self._sessions.get(app)
                if sess is None:
                    continue
                free = max(0, self.q_slots - len(sess.active_queries))
                queued = self._pending_count(app)
                if free and (queued >= self.min_fill
                             or now - self._oldest_pending_s(app)
                             >= self.max_wait_s):
                    self._admit_batch(app, sess, self._drr_take(app, free))
            # deadline sweep: drain live queries past their deadline
            for app, live in self._live.items():
                overdue = [t.gq for t in live.values()
                           if t.deadline_s is not None
                           and t.status == "running"
                           and now - t.submitted_s > t.deadline_s]
                if overdue and app in self._sessions:
                    self._sessions[app].drain(overdue)
            idle = not self._sessions
        if idle:
            if draining:
                return True    # _shutdown fails whatever is still queued
            with self._wake:
                self._wake.wait(timeout=self.max_wait_s)
            return False
        # step every live session once, round-robin (outside the lock:
        # submit() stays responsive during a superstep)
        for app in list(self._sessions):
            sess = self._sessions[app]
            st = sess.step()
            with self._lock:
                self.stats["supersteps"] += 1
            self._finish(app, sess, st.retired_queries, "done")
            self._finish(app, sess, st.drained_queries, "timeout")
            if sess.finished:
                self._close_session(app, sess)
        return False

    def _open_session(self, app: str):
        """Open a session for ``app`` seeded with a DRR-selected batch
        (the initial batch needs no admission barrier — it IS the
        program).  Called under the lock."""
        batch = self._drr_take(app, self.q_slots)
        if not batch:
            return None
        eng = self._engine(app)
        prog = APPS[app]().with_queries([t.seed for t in batch])
        sess = eng.open_session(prog, q_slots=self.q_slots,
                                max_supersteps=self.max_supersteps)
        self._sessions[app] = sess
        self._live.setdefault(app, {})
        self.stats["sessions_opened"] += 1
        now = time.perf_counter()
        for gq, t in zip(sess.active_queries, batch):
            t.gq = gq
            t.status = "running"
            t.admitted_s = now
            self._live[app][gq] = t
            self.tenant_stats.setdefault(
                t.tenant,
                dict(submitted=0, admitted=0, done=0,
                     refused=0))["admitted"] += 1
        return sess

    def _engine(self, app: str) -> OutOfCoreEngine:
        """The service-lifetime engine for ``app`` (edge caches and skip
        filters stay warm across sessions)."""
        eng = self._engines.get(app)
        if eng is None:
            cfg = self.cfg
            if cfg.checkpoint_dir:
                cfg = dataclasses.replace(
                    cfg, checkpoint_dir=os.path.join(cfg.checkpoint_dir,
                                                     app))
            eng = self._engines[app] = OutOfCoreEngine(self.store, cfg)
        return eng

    def _finish(self, app: str, sess, gqs, status: str) -> None:
        """Finalize tickets whose columns froze at the last barrier;
        converged (``done``) results populate the cache — drained
        partials never do."""
        if not gqs:
            return
        now = time.perf_counter()
        with self._lock:
            for g in gqs:
                t = self._live.get(app, {}).pop(int(g), None)
                if t is None:       # resumed column with no local ticket
                    continue
                t.status = status
                t.finished_s = now
                t.result = sess.query_result(t.gq)
                t.supersteps = sess.query_supersteps(t.gq)
                self.completed.append(t)
                self.stats[status] += 1
                if status == "done":
                    self.tenant_stats.setdefault(
                        t.tenant,
                        dict(submitted=0, admitted=0, done=0,
                             refused=0))["done"] += 1
                    if self.cache is not None:
                        self.cache.put(t.app, t.seed, self.fingerprint,
                                       t.result, t.supersteps)
                t._event.set()

    def _close_session(self, app: str, sess) -> None:
        """Finalize a finished session; any columns still live at
        max_supersteps finish as timeouts with their partial values."""
        stranded = tuple(sess.active_queries)
        sess.result()
        self._finish(app, sess, stranded, "timeout")
        sess.close()
        del self._sessions[app]

    # -- drain / resume ----------------------------------------------------
    def _shutdown(self) -> None:
        """Drain epilogue: finish or checkpoint in-flight sessions, fail
        whatever is still queued, wake all waiters."""
        if self.drain_mode == "checkpoint":
            for app, sess in list(self._sessions.items()):
                if self._engines[app].ckpt is not None:
                    sess.checkpoint()
                sess.close()
                del self._sessions[app]
            # live tickets stay unresolved here by design: the resumed
            # service re-registers them from the manifest lineage
            with self._lock:
                for live in self._live.values():
                    for t in live.values():
                        t.status = "failed"
                        self.stats["failed"] += 1
                        t._event.set()
                    live.clear()
        else:
            while self._sessions:
                for app in list(self._sessions):
                    sess = self._sessions[app]
                    st = sess.step()
                    with self._lock:
                        self.stats["supersteps"] += 1
                    self._finish(app, sess, st.retired_queries, "done")
                    self._finish(app, sess, st.drained_queries, "timeout")
                    if sess.finished:
                        self._close_session(app, sess)
        with self._lock:
            self._stopped = True
            for tenant_queues in self._pending.values():
                for queue in tenant_queues.values():
                    for t in queue:
                        t.status = "failed"
                        self.stats["failed"] += 1
                        t._event.set()
                    queue.clear()

    def _resume_sessions(self) -> None:
        """Reopen checkpointed serving sessions (drain_mode='checkpoint'
        shutdown): per-app subdirs of ``cfg.checkpoint_dir`` holding a
        non-final boundary are restored, and their live columns get
        synthetic tickets rebuilt from the manifest's query lineage."""
        root = self.cfg.checkpoint_dir
        for app in SERVABLE:
            if not os.path.isdir(os.path.join(root, app)):
                continue
            eng = self._engine(app)
            if eng.ckpt is None:
                continue
            peek = eng.ckpt.peek_manifest()
            if peek is None or peek[1].get("final"):
                continue
            lineage = {int(g): int(s) for g, s in
                       (peek[1].get("queries") or {}).items()}
            live = [int(g) for g in peek[1].get("active_q") or []]
            prog = APPS[app]().with_queries(
                [lineage.get(g, 0) for g in live] or [0])
            sess = eng.open_session(prog, q_slots=self.q_slots,
                                    max_supersteps=self.max_supersteps)
            self._sessions[app] = sess
            self._live.setdefault(app, {})
            self.stats["sessions_opened"] += 1
            now = time.perf_counter()
            for gq in sess.active_queries:
                t = QueryTicket(rid=self._next_rid, app=app,
                                seed=lineage.get(gq, -1),
                                submitted_s=now, status="running", gq=gq,
                                admitted_s=now)
                self._next_rid += 1
                self.stats["submitted"] += 1
                self._tickets[t.rid] = t
                self._live[app][gq] = t
        # resume applies to the restore pass only: later sessions on the
        # same engines must start fresh, not re-load a stale checkpoint
        self.cfg = dataclasses.replace(self.cfg, resume=False)
        for eng in self._engines.values():
            eng.cfg = dataclasses.replace(eng.cfg, resume=False)

    # -- reporting ---------------------------------------------------------
    @property
    def draining(self) -> bool:
        """True once drain began (healthz turns 503, submits refuse)."""
        with self._lock:
            return self._draining or self._stopped

    def stats_snapshot(self) -> dict:
        """Consistent copy of the service/tenant/cache counters plus the
        drain flag — the HTTP ``/v1/stats`` payload backend."""
        with self._lock:
            snap = dict(
                stats=dict(self.stats),
                tenants={t: dict(d) for t, d in self.tenant_stats.items()},
                draining=self._draining or self._stopped,
                pending={app: self._pending_count(app)
                         for app in self._pending},
                fingerprint=self.fingerprint,
            )
        snap["cache"] = (self.cache.snapshot()
                        if self.cache is not None else None)
        return snap

    def latency_summary(self) -> dict:
        """p50/p99 total latency + component means over completed
        queries (the bench's and runbook's one-stop report)."""
        done = [t for t in self.completed if t.status == "done"]
        with self._lock:
            timeouts = self.stats["timeout"]
        if not done:
            return dict(count=0, timeouts=timeouts)
        tot = np.asarray([t.total_s for t in done])
        return dict(
            count=len(done),
            timeouts=timeouts,
            p50_ms=float(np.percentile(tot, 50) * 1e3),
            p99_ms=float(np.percentile(tot, 99) * 1e3),
            mean_queue_ms=float(np.mean([t.queue_wait_s for t in done])
                                * 1e3),
            mean_service_ms=float(np.mean([t.service_s for t in done])
                                  * 1e3),
            mean_supersteps=float(np.mean([t.supersteps for t in done])),
        )
