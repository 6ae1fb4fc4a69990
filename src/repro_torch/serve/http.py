"""JSON-over-HTTP frontend for the graph-query service (DESIGN.md §16) —
the port's counterpart of ``repro/serve/http.py``: the same routes, wire
format, validation, status codes and counters.

Stdlib-only (``http.server.ThreadingHTTPServer`` — no new dependencies,
same constraint as the ast-only lint suite).  One :class:`HttpFrontend`
wraps a running
:class:`~repro_torch.serve.graph_service.GraphService`:

  ``POST /v1/query``          body ``{"app", "seed", "deadline_ms"?,
                              "tenant"?}`` → the ticket as JSON (``rid``
                              is the handle for later polls); a result-
                              cache hit comes back already ``done``
  ``GET  /v1/query/<rid>``    ticket status + latency split; finished
                              tickets carry the exact [V] result column
                              (base64 of the raw little-endian bytes —
                              JSON floats would not round-trip bits)
  ``GET  /v1/stats``          service + per-tenant + cache + HTTP counters
  ``GET  /healthz``           ``200 ok`` / ``503 draining``

Error semantics: every malformed request — non-JSON body, unknown app,
out-of-range or non-integer seed, absurd deadline, bad tenant label —
yields a structured ``4xx`` ``{"error": ...}`` and never crashes the
handler thread; unexpected handler exceptions come back as structured
``500``s.  Once the service drains (SIGTERM), ``POST /v1/query`` and
``/healthz`` return **503** with ``Retry-After`` so load balancers back
off, while ``GET /v1/query/<rid>`` keeps answering — clients collect
in-flight results during the drain window.

Fault injection (the port's ``runtime/faults.py``): the response path is
a named site — ``site=http_response`` with ``kind=delay`` sleeps before
writing, ``kind=drop`` closes the connection without a response (a lost
reply on the wire).  Dropped responses mutate nothing: the ticket registry is
keyed by ``rid``, so a client retry of the same rid observes the
completed result.

Request handling runs on ``ThreadingHTTPServer``'s per-connection
threads; everything they touch is either per-request local, the
service's own thread-safe surface (``submit``/``get``/
``stats_snapshot``), or :class:`HttpFrontend` counters under its lock
(``_guarded_by``, enforced by tools/analyze.py).
"""
from __future__ import annotations

import base64
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from repro_torch.serve.graph_service import (DEFAULT_TENANT, SERVABLE,
                                             GraphService, QueryTicket)

#: request bodies past this are rejected with 413 (tickets are tiny)
MAX_BODY_BYTES = 1 << 20
#: deadlines outside (0, MAX_DEADLINE_MS] are structured 400s
MAX_DEADLINE_MS = 86_400_000.0
#: tenant labels: printable, non-empty, bounded
MAX_TENANT_LEN = 64


class BadRequest(ValueError):
    """Raised by request validation; the handler maps it to a structured
    4xx response (``.status`` defaults to 400)."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


def encode_array(a: np.ndarray) -> dict:
    """JSON-safe exact encoding of an array: dtype + shape + base64 of
    the raw little-endian bytes (bit-exact round-trip, unlike JSON
    floats)."""
    a = np.ascontiguousarray(a)
    return dict(dtype=str(a.dtype), shape=list(a.shape),
                data_b64=base64.b64encode(a.tobytes()).decode("ascii"))


def decode_array(d: dict) -> np.ndarray:
    """Inverse of :func:`encode_array` (shared by tests and clients)."""
    raw = base64.b64decode(d["data_b64"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]).copy()


def ticket_json(t: QueryTicket) -> dict:
    """The wire form of one ticket: identity, status, latency split, and
    — once finished — the exact result column."""
    finished = t.status in ("done", "timeout", "failed")
    out = dict(rid=t.rid, app=t.app, seed=t.seed, tenant=t.tenant,
               status=t.status, cache_hit=t.cache_hit,
               supersteps=t.supersteps)
    if finished:
        out.update(
            queue_ms=t.queue_wait_s * 1e3,
            service_ms=t.service_s * 1e3,
            total_ms=t.total_s * 1e3,
            result=(encode_array(t.result) if t.result is not None
                    else None),
        )
    return out


def parse_query_body(raw: bytes, num_vertices: int) -> dict:
    """Validate a ``POST /v1/query`` body; returns submit() kwargs.

    Everything a client can get wrong is a :class:`BadRequest` — the
    handler thread must survive arbitrary bytes here."""
    if len(raw) > MAX_BODY_BYTES:
        raise BadRequest(f"body exceeds {MAX_BODY_BYTES} bytes", 413)
    try:
        body = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise BadRequest(f"body is not valid JSON: {e}") from e
    if not isinstance(body, dict):
        raise BadRequest("body must be a JSON object")
    app = body.get("app")
    if not isinstance(app, str) or app not in SERVABLE:
        raise BadRequest(f"app must be one of {', '.join(SERVABLE)}; "
                         f"got {app!r}")
    seed = body.get("seed")
    if isinstance(seed, bool) or not isinstance(seed, int):
        raise BadRequest(f"seed must be an integer vertex id; got "
                         f"{seed!r}")
    if not 0 <= seed < num_vertices:
        raise BadRequest(f"seed {seed} outside [0, {num_vertices}) "
                         "for this graph")
    deadline_ms = body.get("deadline_ms")
    deadline_s: Optional[float] = None
    if deadline_ms is not None:
        if (isinstance(deadline_ms, bool)
                or not isinstance(deadline_ms, (int, float))
                or not math.isfinite(deadline_ms)
                or not 0 < deadline_ms <= MAX_DEADLINE_MS):
            raise BadRequest(
                f"deadline_ms must be a finite number in "
                f"(0, {MAX_DEADLINE_MS:g}]; got {deadline_ms!r}")
        deadline_s = float(deadline_ms) / 1e3
    tenant = body.get("tenant", DEFAULT_TENANT)
    if (not isinstance(tenant, str) or not tenant
            or len(tenant) > MAX_TENANT_LEN or not tenant.isprintable()):
        raise BadRequest("tenant must be a non-empty printable string "
                         f"of at most {MAX_TENANT_LEN} chars; got "
                         f"{tenant!r}")
    return dict(app=app, seed=seed, deadline_s=deadline_s, tenant=tenant)


class _Handler(BaseHTTPRequestHandler):
    """Per-connection request handler (``frontend`` is bound by the
    :class:`HttpFrontend` that instantiates the server)."""

    frontend: "HttpFrontend" = None      # type: ignore[assignment]
    server_version = "graphh-serve/1"

    # -- plumbing ----------------------------------------------------------
    def log_message(self, fmt, *args):   # noqa: D102 - stdlib signature
        pass                             # no per-request stderr chatter

    def _count(self, key: str) -> None:
        fe = self.frontend
        with fe._lock:
            fe.http_stats[key] = fe.http_stats.get(key, 0) + 1

    def _send_json(self, status: int, payload: dict,
                   retry_after: Optional[int] = None) -> None:
        """Serialize + send one JSON response, honoring the
        ``http_response`` fault site (delay sleeps here; drop closes the
        connection with nothing written — the client must retry)."""
        fe = self.frontend
        if fe.fault is not None:
            fe.fault.check("http_response")
            if fe.fault.drop("http_response"):
                self._count("dropped_responses")
                self.close_connection = True
                return
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", str(retry_after))
        self.end_headers()
        self.wfile.write(body)
        if status >= 500:
            self._count("errors_5xx")
        elif status >= 400:
            self._count("errors_4xx")

    def _guarded(self, fn) -> None:
        """Run one route; any uncaught exception becomes a structured 500
        instead of killing the handler thread silently."""
        self._count("requests")
        try:
            fn()
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True     # client went away mid-write
        except Exception as e:               # noqa: BLE001 - last resort
            try:
                self._send_json(500, dict(error=f"internal error: "
                                                f"{type(e).__name__}: {e}"))
            except Exception:                # noqa: BLE001 - socket gone
                self.close_connection = True

    # -- routes ------------------------------------------------------------
    def do_POST(self) -> None:               # noqa: N802 - stdlib naming
        """``POST /v1/query`` — validate, submit, return the ticket."""
        self._guarded(self._post_query)

    def do_GET(self) -> None:                # noqa: N802 - stdlib naming
        """``GET /v1/query/<rid>`` | ``/v1/stats`` | ``/healthz``."""
        self._guarded(self._get)

    def _post_query(self) -> None:
        if self.path.rstrip("/") != "/v1/query":
            self._send_json(404, dict(error=f"no such endpoint "
                                            f"{self.path!r}"))
            return
        svc = self.frontend.service
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self._send_json(400, dict(error="bad Content-Length"))
            return
        raw = self.rfile.read(min(length, MAX_BODY_BYTES + 1))
        try:
            kw = parse_query_body(raw, svc.num_vertices)
        except BadRequest as e:
            self._send_json(e.status, dict(error=str(e)))
            return
        try:
            t = svc.submit(**kw)
        except RuntimeError:
            # draining: load balancers must back off (503 + Retry-After)
            self._count("refused_503")
            self._send_json(503, dict(error="service is draining — "
                                            "not admitting"),
                            retry_after=1)
            return
        except ValueError as e:
            self._send_json(400, dict(error=str(e)))
            return
        self._send_json(200, ticket_json(t))

    def _get(self) -> None:
        svc = self.frontend.service
        path = self.path.rstrip("/") or "/"
        if path == "/healthz":
            if svc.draining:
                self._send_json(503, dict(status="draining"),
                                retry_after=1)
            else:
                self._send_json(200, dict(status="ok"))
            return
        if path == "/v1/stats":
            snap = svc.stats_snapshot()
            snap["http"] = self.frontend.counters()
            snap["latency"] = svc.latency_summary()
            self._send_json(200, snap)
            return
        if path.startswith("/v1/query/"):
            rid_str = path[len("/v1/query/"):]
            try:
                rid = int(rid_str)
            except ValueError:
                self._send_json(400, dict(error=f"rid must be an "
                                                f"integer; got {rid_str!r}"))
                return
            t = svc.get(rid)
            if t is None:
                self._send_json(404, dict(error=f"unknown rid {rid}"))
                return
            self._send_json(200, ticket_json(t))
            return
        self._send_json(404, dict(error=f"no such endpoint {self.path!r}"))


class HttpFrontend:
    """Threaded HTTP server bound to one :class:`GraphService` (module
    docstring).  ``port=0`` binds an ephemeral port (``self.port`` holds
    the real one).  ``fault`` is an optional
    :class:`~repro_torch.runtime.faults.FaultInjector` armed at the
    ``http_response`` site."""

    #: lock discipline, enforced by tools/analyze.py --check locks
    _guarded_by = {"http_stats": "_lock"}

    def __init__(self, service: GraphService, *, host: str = "127.0.0.1",
                 port: int = 0, fault=None):
        self.service = service
        self.fault = fault
        self._lock = threading.Lock()
        self.http_stats: dict = dict(requests=0, errors_4xx=0,
                                     errors_5xx=0, refused_503=0,
                                     dropped_responses=0)
        fe = self

        class _Bound(_Handler):
            frontend = fe

        self.server = ThreadingHTTPServer((host, int(port)), _Bound)
        self.server.daemon_threads = True
        self.host, self.port = self.server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        """Base URL clients should hit."""
        return f"http://{self.host}:{self.port}"

    def counters(self) -> dict:
        """Copy of the HTTP-layer counters (under the lock)."""
        with self._lock:
            return dict(self.http_stats)

    def start(self) -> "HttpFrontend":
        """Serve on a daemon thread; returns self (chainable)."""
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="graph-http", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop accepting, close the listening socket, join the server
        thread.  Idempotent."""
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
