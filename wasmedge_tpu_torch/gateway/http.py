"""HTTP front door: the wire protocol over GatewayService.

Stdlib-only (http.server ThreadingHTTPServer — one thread per
connection, keep-alive), because the container bakes no web framework
and the protocol is deliberately small:

  POST /v1/invoke        {"module","func","args","tenant","deadline_ms",
                          "async"} -> 200 result | 202 + poll URL
  GET  /v1/requests/<id> poll an async/timed-out request
  POST /v1/modules       register a guest module at runtime (JSON
                          {"name","wasm_b64"} or raw application/wasm
                          with ?name=) -> 201 + generation
  GET  /v1/status        queue/occupancy/generation counters (JSON)
  GET  /healthz          TRUTHFUL health (gateway/health.py): serving
                          liveness, last-swap outcome, queue
                          saturation, checkpoint/journal write health.
                          200 healthy, 200 + status "degraded" with
                          the failing checks in the body, 503
                          unhealthy — machine-readable either way.

Status-code contract (the machine-readable rejection taxonomy of
common/errors.rejection_info on the wire):

  429 + Retry-After   QueueSaturated backpressure / tenant rate limit
                      / degraded-mode load shedding (ShedLoad carries
                      detail "shed") — the retryable classes
  504                 DeadlineExceeded (queued or in flight)
  401 / 403           auth stub rejection / permanent admission block,
                      registration not allowed
  404                 unknown module, function, or request id; a
                      PRUNED async id carries detail "pruned" so a
                      client holding a real 202 can tell "aged out"
                      from "never existed"
  400                 malformed request, bad/unbatchable wasm
                      (Load/Validation ErrCode in the body), or a
                      static admission policy violation
                      (StaticPolicyViolation + per-limit violations
                      list, analysis/policy.py)
  409                 duplicate module name
  503 + Retry-After   retryable infrastructure: a rolled-back
                      generation build/swap (GenerationBuildFailed),
                      a failed durable journal write (the 202 id was
                      never issued), gateway shutting down
  503                 server terminal failure
  200 {"ok": false}   the request RAN and trapped — guest-level
                      failures carry the ErrCode taxonomy in the body,
                      exactly like the CLI's per-request reporting

Auth: `Authorization: Bearer <key>` or `X-Api-Key: <key>`; the key
resolves the tenant (gateway/tenants.py).

A copy of `wasmedge_tpu/gateway/http.py` without its chaos seams
(`http_response_delay` / `http_response_drop`, which only the JAX
package's chaos schedule arms: ROADMAP A7.10).  The routes of subsystems
the port does not have yet answer the JAX package's 404 `NotFound` "no
route" body: `GET /metrics` (A7.6), `GET /v1/requests/<id>/stream` and
`POST /v1/requests/<id>/wake` (A7.4), `/v1/fleet/*` and `POST
/v1/reshard` (A7.9).
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from wasmedge_tpu_torch.common.errors import (
    EngineFailure,
    ErrCode,
    InstantiationError,
    LoadError,
    ValidationError,
    WasmError,
    rejection_info,
)
from wasmedge_tpu_torch.gateway.durable import DurabilityError
from wasmedge_tpu_torch.gateway.health import ShedLoad
from wasmedge_tpu_torch.gateway.service import (
    GatewayClosed,
    GatewayRequest,
    GatewayService,
)
from wasmedge_tpu_torch.gateway.tenants import AuthError, RateLimited
from wasmedge_tpu_torch.serve.queue import (
    DeadlineExceeded,
    QueueSaturated,
    ServeRejected,
)


def error_payload(exc: BaseException) -> dict:
    """The body half of the rejection contract: WasmErrors carry their
    ErrCode taxonomy (rejection_info); edge-layer rejections carry a
    stable name + the same retryable flag shape."""
    if isinstance(exc, RateLimited):
        out = {"name": "RateLimited", "retryable": True,
               "message": str(exc)}
        if math.isfinite(exc.retry_after_s):
            out["retry_after_s"] = exc.retry_after_s
        return out
    if isinstance(exc, AuthError):
        return {"name": "AuthError", "retryable": False,
                "message": str(exc)}
    if isinstance(exc, KeyError):
        return {"name": "NotFound", "retryable": False,
                "message": str(exc.args[0]) if exc.args else "not found"}
    return rejection_info(exc)


def submit_status_of(exc: BaseException) -> int:
    """HTTP status for a rejection BEFORE the request ran (auth, rate,
    admission, registration, routing)."""
    if isinstance(exc, AuthError):
        return 401
    if isinstance(exc, (RateLimited, QueueSaturated, ShedLoad)):
        return 429
    if isinstance(exc, DeadlineExceeded):
        return 504
    if isinstance(exc, KeyError):
        return 404
    if isinstance(exc, DurabilityError):
        # the journal write failed, so the id was never accepted:
        # service unavailable, retry against a recovered gateway
        return 503
    if isinstance(exc, (EngineFailure, GatewayClosed)):
        # terminal generation failure, a rolled-back generation
        # build/swap (GenerationBuildFailed, retryable), or the
        # gateway going down: service unavailable, NOT a permission
        # problem — clients may retry against a recovered gateway
        return 503
    if isinstance(exc, (LoadError, ValidationError, InstantiationError)):
        return 400
    if isinstance(exc, WasmError):
        if exc.code == ErrCode.ModuleNameConflict:
            return 409
        if exc.code == ErrCode.Terminated and not exc.retryable:
            # the tenant's own policy forbids this request permanently
            # (quota/weight <= 0 admission block)
            return 403
        return 400
    if isinstance(exc, (ValueError, TypeError)):
        return 400
    return 500


def retry_after_of(exc: BaseException) -> Optional[str]:
    """Retry-After for every retryable rejection (backpressure, rate
    limit, shedding, rolled-back swap, failed journal write) — the
    header IS the machine-readable half of "try again"."""
    after = getattr(exc, "retry_after_s", None)
    if isinstance(exc, RateLimited) or getattr(exc, "retryable", False):
        if after is None or not math.isfinite(after):
            return "1"
        return str(max(1, math.ceil(after)))
    return None


def result_response(req: GatewayRequest) -> Tuple[int, dict]:
    """Response for a COMPLETED request.  Transport-level failures map
    to 5xx (deadline 504, server terminal 503); a guest that ran and
    trapped is a 200 with ok=false + the ErrCode taxonomy in the body
    — the same per-request reporting discipline as the CLI."""
    base = {"request_id": req.id, "func": req.func,
            "tenant": req.tenant, "generation": req.gen_id}
    err = req.future.error
    if err is None:
        return 200, dict(base, ok=True, status="done",
                         result=[int(c) for c in req.future.result(0)])
    body = dict(base, ok=False, status="error", err=error_payload(err))
    if isinstance(err, DeadlineExceeded):
        return 504, body
    if isinstance(err, (EngineFailure, ServeRejected)):
        # the guest never ran: terminal generation failure, non-drain
        # shutdown kill, or the unservable-after-acceptance sweep —
        # 5xx, never the 200 ok:false reserved for real guest traps
        return 503, body
    return 200, body


class GatewayHandler(BaseHTTPRequestHandler):
    """One request per invocation; the service does the thinking."""

    server_version = "wasmedge-tpu-gateway"
    protocol_version = "HTTP/1.1"

    # the HTTP server is a serving surface, not a logger: access lines
    # go to the flight recorder (count_http + gateway spans), never to
    # stderr where they would interleave with the CLI's JSON
    def log_message(self, fmt, *args):
        pass

    @property
    def svc(self) -> GatewayService:
        return self.server.service

    # -- plumbing ----------------------------------------------------------
    def _reply(self, code: int, body, content_type="application/json",
               headers=None):
        data = body if isinstance(body, (bytes, bytearray)) \
            else json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)
        self.svc.count_http(code)

    def _reject(self, exc: BaseException, code: Optional[int] = None):
        code = submit_status_of(exc) if code is None else code
        headers = {}
        after = retry_after_of(exc)
        if after is not None:
            headers["Retry-After"] = after
        self._reply(code, {"ok": False, "err": error_payload(exc)},
                    headers=headers)

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _api_key(self) -> Optional[str]:
        auth = self.headers.get("Authorization")
        if auth and auth.lower().startswith("bearer "):
            return auth[7:].strip()
        return self.headers.get("X-Api-Key")

    # -- routes ------------------------------------------------------------
    def _no_route(self, path: str):
        return self._reply(404, {"ok": False, "err": {
            "name": "NotFound", "retryable": False,
            "message": f"no route {path}"}})

    def do_GET(self):
        url = urlparse(self.path)
        try:
            if url.path == "/v1/status":
                return self._reply(200, self.svc.status())
            if url.path == "/healthz":
                # truthful health: a dead serving thread or terminally
                # failed generation answers 503, a degraded gateway
                # answers 200 with the failing checks in the body
                h = self.svc.health()
                return self._reply(200 if h["ok"] else 503, h)
            if url.path.startswith("/v1/requests/") \
                    and not url.path.endswith("/stream"):
                return self._get_request(url.path)
            return self._no_route(url.path)
        except Exception as e:  # route handlers raise the taxonomy
            return self._reject(e)

    def do_POST(self):
        url = urlparse(self.path)
        try:
            if url.path == "/v1/invoke":
                return self._invoke(url)
            if url.path == "/v1/modules":
                return self._register(url)
            return self._no_route(url.path)
        except Exception as e:
            return self._reject(e)

    # -- handlers ----------------------------------------------------------
    def _invoke(self, url):
        body = self._read_body()
        try:
            doc = json.loads(body or b"{}")
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
        except json.JSONDecodeError as e:
            raise ValueError(f"malformed JSON body: {e}") from e
        func = doc.get("func")
        if not func or not isinstance(func, str):
            raise ValueError('missing required field "func"')
        args = doc.get("args", [])
        if not isinstance(args, list):
            raise ValueError('"args" must be a list of integers')
        args = [int(a) for a in args]
        module = doc.get("module")
        deadline_ms = doc.get("deadline_ms")
        deadline_s = float(deadline_ms) / 1000.0 \
            if deadline_ms is not None else None
        q = parse_qs(url.query)
        async_ = bool(doc.get("async")) or q.get("async", ["0"])[0] \
            in ("1", "true")
        tenant = self.svc.tenants.authenticate(self._api_key(),
                                               doc.get("tenant"))
        req = self.svc.submit(func, args, module=module, tenant=tenant,
                              deadline_s=deadline_s)
        if async_:
            return self._reply(202, {
                "ok": True, "status": "pending", "request_id": req.id,
                "poll": f"/v1/requests/{req.id}"})
        # sync: wait for the future — a deadline bounds the wait (the
        # serving loop kills the lane at the deadline, plus scheduling
        # grace); otherwise the gateway's sync cap applies, and a
        # still-running request degrades to the async contract
        timeout = (deadline_s + 5.0) if deadline_s is not None else None
        if not self.svc.wait(req, timeout_s=timeout):
            return self._reply(202, {
                "ok": True, "status": "pending", "request_id": req.id,
                "poll": f"/v1/requests/{req.id}"})
        code, out = result_response(req)
        return self._reply(code, out)

    def _get_request(self, path: str):
        try:
            rid = int(path.rsplit("/", 1)[1])
        except ValueError:
            raise ValueError(f"bad request id in {path!r}") from None
        state, req = self.svc.request_state(rid)
        if req is None:
            if state == "pruned":
                # the id WAS real; its resolved entry aged out of the
                # result cache — distinct detail so a polling client
                # can stop retrying instead of doubting its own 202
                return self._reply(404, {"ok": False, "err": {
                    "name": "NotFound", "retryable": False,
                    "detail": "pruned",
                    "message": f"request {rid} was resolved and its "
                               f"result pruned from the cache"}})
            raise KeyError(f"no request {rid}")
        if not req.future.done:
            return self._reply(200, {"ok": True, "status": "pending",
                                     "request_id": req.id})
        code, out = result_response(req)
        return self._reply(code, out)

    def _register(self, url):
        q = parse_qs(url.query)
        body = self._read_body()
        ctype = (self.headers.get("Content-Type") or "").split(";")[0] \
            .strip().lower()
        claimed = q.get("tenant", [None])[0]
        name = q.get("name", [None])[0]
        if ctype in ("application/wasm", "application/octet-stream"):
            data = body
        else:
            try:
                doc = json.loads(body or b"{}")
            except json.JSONDecodeError as e:
                raise ValueError(f"malformed JSON body: {e}") from e
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
            name = doc.get("name", name)
            claimed = doc.get("tenant", claimed)
            b64 = doc.get("wasm_b64")
            if not b64:
                raise ValueError(
                    'missing "wasm_b64" (or POST raw bytes with '
                    'Content-Type: application/wasm and ?name=)')
            import base64

            try:
                data = base64.b64decode(b64, validate=True)
            except Exception as e:
                raise ValueError(f"bad wasm_b64: {e}") from e
        if not name:
            raise ValueError('missing module "name"')
        tenant = self.svc.tenants.authenticate(self._api_key(), claimed)
        if not self.svc.tenants.can_register(tenant):
            return self._reply(403, {"ok": False, "err": {
                "name": "Forbidden", "retryable": False,
                "message": f"tenant {tenant!r} may not register "
                           f"modules"}})
        info = self.svc.register_module(name, wasm_bytes=data,
                                        source=f"http/{tenant}",
                                        tenant=tenant)
        return self._reply(201, dict(info, ok=True))


class GatewayHTTPServer(ThreadingHTTPServer):
    """stdlib's threading server with a deep listen backlog.  With its
    default of 5 the kernel queues six connections the accept thread has
    not taken yet (it shares the interpreter lock with the serving and
    handler threads) and drops the SYN of every further one, which the
    client retries 1, 3, 7, 15 and 31 s later: 64 clients and their
    polls made a registration wait 31 s for its connection on the
    card.  The JAX package keeps the default."""

    request_queue_size = 1024
    daemon_threads = True


class Gateway:
    """Service + HTTP server + background accept loop in one handle.

    `port=0` binds an ephemeral port (tests, smoke); the bound address
    is `gw.host`/`gw.port` after construction.  `start()` returns self;
    `shutdown()` stops accepting, then drains the serving generations.
    """

    def __init__(self, service: GatewayService, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self.httpd = GatewayHTTPServer((host, port), GatewayHandler)
        self.httpd.service = service
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Gateway":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self.httpd.serve_forever,
                kwargs={"poll_interval": 0.05},
                name=f"wasmedge-gateway:{self.port}", daemon=True)
            self._thread.start()
        return self

    def shutdown(self, drain: bool = True,
                 timeout_s: Optional[float] = None):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.service.shutdown(drain=drain, timeout_s=timeout_s)

    def kill(self):
        """Simulated SIGKILL (chaos harness): close the listening
        socket and stop the serving threads with NO drain, NO future
        resolution, NO journal flush — on-disk state is exactly what a
        real crash leaves.  Restart with GatewayService(resume=True)
        over the same state_dir."""
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.service.kill()
