"""The port's HTTP gateway against the JAX package's, over real sockets on
port 0: one seeded script (register at boot, invoke, a faulted
registration rolled back, the re-POST swapping in a generation while
requests of the old one are in flight, then requests to both modules)
gives equal results, generations, status codes, Retry-After headers and
rejection bodies (404, 400, 409, 401, 403, 429, 504, 503) on both; the
routes of later ROADMAP items answer 404; and a tier-0 capable echo
module's stdout is sunk or not as the registry says (a concatenated image
serves every host call at tier 1, through the module's own WASI
instance).

One module-scoped gateway of each package, two lanes, a small stack: a
JAX generation compiles once per module set on the CPU (about 5 s).
"""

import base64
import json
import re
import time
from http.client import HTTPConnection

import pytest

from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.gateway import Gateway as RefGateway
from wasmedge_tpu.gateway import GatewayService as RefGatewayService
from wasmedge_tpu.gateway import GatewayTenants as RefGatewayTenants
from wasmedge_tpu.testing.faults import Fault as RefFault
from wasmedge_tpu.testing.faults import FaultInjector as RefFaultInjector
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.gateway import Gateway, GatewayService, GatewayTenants
from wasmedge_tpu_torch.models import build_echo, build_fib
from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE
from wasmedge_tpu_torch.testing.faults import Fault, FaultInjector
from wasmedge_tpu_torch.utils.builder import ModuleBuilder

ALICE = {"X-Api-Key": "sk-alice"}
TENANTS = {"tenants": {
    "alice": {"api_key": "sk-alice", "weight": 2.0, "quota": 2},
    "bob": {"api_key": "sk-bob", "can_register": False},
    "slow": {"rate_per_s": 0.001, "burst": 1},
}}


def fib_py(n):
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


def build_dbl() -> bytes:
    """A second guest for runtime registration: dbl(n) = 2n + 7."""
    b = ModuleBuilder()
    b.add_function(["i64"], ["i64"], [],
                   [("local.get", 0), ("i64.const", 2), "i64.mul",
                    ("i64.const", 7), "i64.add"], export="dbl")
    return b.build()


def build_unlinkable() -> bytes:
    """Imports a host function nothing provides: instantiation fails."""
    b = ModuleBuilder()
    b.import_func("env", "mystery", ["i32"], ["i32"])
    b.add_function(["i32"], ["i32"], [], [("local.get", 0), ("call", 0)],
                   export="f")
    return b.build()


def _conf(pkg):
    conf = (Configure if pkg == "port" else RefConfigure)()
    conf.batch.steps_per_launch = 256
    conf.batch.value_stack_depth = 128
    conf.batch.call_stack_depth = 64
    return conf


def _gateway(pkg, **kw):
    """A started gateway of either package: fib registered at boot, the
    tenants above, the second generation build faulted."""
    if pkg == "port":
        svc = GatewayService(
            conf=_conf(pkg), lanes=2, device="cpu",
            tenants=GatewayTenants.from_dict(TENANTS),
            faults=FaultInjector([Fault(point="generation_build", at=1)]),
            **kw)
        cls = Gateway
    else:
        svc = RefGatewayService(
            conf=_conf(pkg), lanes=2,
            tenants=RefGatewayTenants.from_dict(TENANTS),
            faults=RefFaultInjector([RefFault(point="generation_build",
                                              at=1)]), **kw)
        cls = RefGateway
    svc.register_module("fib", wasm_bytes=build_fib(), source="boot")
    return cls(svc, port=0).start()


@pytest.fixture(scope="module")
def pair():
    gws = {"port": _gateway("port"), "ref": _gateway("ref")}
    yield gws
    for gw in gws.values():
        gw.shutdown(drain=False)


def rpc(gw, method, path, body=None, headers=None, timeout=120.0):
    c = HTTPConnection(gw.host, gw.port, timeout=timeout)
    try:
        data = json.dumps(body).encode() if isinstance(body, dict) else body
        c.request(method, path, body=data, headers=headers or {})
        r = c.getresponse()
        raw = r.read()
        hdrs = dict(r.getheaders())
    finally:
        c.close()
    try:
        doc = json.loads(raw)
    except (ValueError, UnicodeDecodeError):
        doc = raw.decode(errors="replace")
    return r.status, doc, hdrs


def _norm(doc):
    """A body without what differs by construction: request ids and poll
    URLs (each package counts its own ids), digits inside messages (the
    ids they name), the refill hint's float (it moves with the clock),
    and a 201's static-analysis summary (the port's analysis has no cost
    verdict yet: ROADMAP A7.8)."""
    if not isinstance(doc, dict):
        return doc
    out = {}
    for k, v in doc.items():
        if k in ("request_id", "poll", "retry_after_s", "analysis"):
            continue
        if k == "message" and isinstance(v, str):
            v = re.sub(r"\d+", "N", v)
        out[k] = _norm(v) if isinstance(v, dict) else v
    return out


def both(pair, method, path, body=None, headers=None):
    """The same call on both gateways: (status, body, Retry-After) each,
    the port's first."""
    out = []
    for pkg in ("port", "ref"):
        st, doc, hdrs = rpc(pair[pkg], method, path, body, headers)
        out.append((st, doc, hdrs.get("Retry-After")))
    return out


def same(pair, method, path, body=None, headers=None):
    got, want = both(pair, method, path, body, headers)
    assert got[0] == want[0], (got, want)
    g, w = _norm(got[1]), _norm(want[1])
    if got[0] == 504:
        # a deadline expires in the queue or in flight as the serving
        # loop's timing falls, on either side: the message says which
        for d in (g, w):
            assert re.search("expired|deadline", d["err"].pop("message"))
    assert g == w, (got, want)
    if got[0] == 429:
        # the refill hint moves with each side's own clock
        assert abs(int(got[2]) - int(want[2])) <= 2, (got, want)
    else:
        assert got[2] == want[2], (got, want)
    return got


def _poll(gw, rid, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st, doc, _ = rpc(gw, "GET", f"/v1/requests/{rid}")
        if not (isinstance(doc, dict) and doc.get("status") == "pending"):
            return st, doc
        time.sleep(0.02)
    raise TimeoutError(f"request {rid} still pending")


def test_register_invoke_and_swap_with_requests_in_flight(pair):
    """The seeded script on both gateways: results, generations and
    codes equal; the faulted registration rolls back with 503 and
    Retry-After; requests admitted before the swap finish on generation
    1; the old generation drains."""
    st, doc, _ = same(pair, "POST", "/v1/invoke",
                      {"module": "fib", "func": "fib", "args": [8]})
    assert st == 200 and doc["result"] == [21] and doc["generation"] == 1
    ids = {"port": [], "ref": []}
    for n in (10, 9, 8):
        for (st, doc, _), pkg in zip(
                both(pair, "POST", "/v1/invoke",
                     {"func": "fib", "args": [n], "async": True}),
                ("port", "ref")):
            assert st == 202, doc
            ids[pkg].append(doc["request_id"])
    wasm64 = base64.b64encode(build_dbl()).decode()
    st, doc, after = same(pair, "POST", "/v1/modules",
                          {"name": "dbl", "wasm_b64": wasm64}, ALICE)
    assert st == 503 and after == "1", doc
    assert doc["err"]["retryable"] is True
    lowered = {pkg: gw.service.registry.lowered_count
               for pkg, gw in pair.items()}
    # the re-POST (raw bytes this time) adopts the stashed lowering
    st, doc, _ = same(pair, "POST", "/v1/modules?name=dbl", build_dbl(),
                      dict(ALICE, **{"Content-Type": "application/wasm"}))
    assert st == 201 and doc["generation"] == 2, doc
    assert doc["modules"] == ["fib", "dbl"] and doc["exports"] == ["dbl"]
    for pkg, gw in pair.items():
        assert gw.service.registry.lowered_count == lowered[pkg]
    for n in (3, 1000, 7):
        st, doc, _ = same(pair, "POST", "/v1/invoke",
                          {"module": "dbl", "func": "dbl", "args": [n]})
        assert st == 200 and doc["result"] == [2 * n + 7]
        assert doc["generation"] == 2
    st, doc, _ = same(pair, "POST", "/v1/invoke",
                      {"module": "fib", "func": "fib", "args": [9]})
    assert st == 200 and doc["result"] == [34]
    got = {}
    for pkg, gw in pair.items():
        got[pkg] = [_norm(_poll(gw, rid)[1]) for rid in ids[pkg]]
    assert got["port"] == got["ref"]
    assert [d["result"] for d in got["port"]] == \
        [[fib_py(n)] for n in (10, 9, 8)]
    assert all(d["generation"] == 1 for d in got["port"])
    for pkg, gw in pair.items():
        deadline = time.monotonic() + 60.0
        while gw.service.status()["draining_generations"]:
            assert time.monotonic() < deadline, pkg
            time.sleep(0.05)
        c = gw.service.counters
        assert (c["generations"], c["rollbacks"]) == (2, 1), pkg
    st, doc, _ = same(pair, "GET", "/healthz")
    assert st == 200 and doc["status"] == "healthy"


WASM_B64 = {"garbage": base64.b64encode(b"not wasm at all").decode(),
            "unlinkable": base64.b64encode(build_unlinkable()).decode(),
            "fib": base64.b64encode(build_fib()).decode()}

REJECTIONS = {
    "unknown_module": ("POST", "/v1/invoke",
                       {"module": "nope", "func": "f", "args": []}, None,
                       404),
    "unknown_func": ("POST", "/v1/invoke",
                     {"module": "fib", "func": "nofunc"}, None, 404),
    "unknown_request": ("GET", "/v1/requests/999999999", None, None, 404),
    "bad_request_id": ("GET", "/v1/requests/abc", None, None, 400),
    "garbage_wasm": ("POST", "/v1/modules",
                     {"name": "junk", "wasm_b64": WASM_B64["garbage"]},
                     ALICE, 400),
    "unlinkable": ("POST", "/v1/modules",
                   {"name": "orphan", "wasm_b64": WASM_B64["unlinkable"]},
                   ALICE, 400),
    "bad_name": ("POST", "/v1/modules",
                 {"name": "a:b", "wasm_b64": WASM_B64["fib"]}, ALICE, 400),
    "missing_name": ("POST", "/v1/modules",
                     {"wasm_b64": WASM_B64["fib"]}, ALICE, 400),
    "duplicate": ("POST", "/v1/modules",
                  {"name": "fib", "wasm_b64": WASM_B64["fib"]}, ALICE, 409),
    "default_may_not_register": ("POST", "/v1/modules",
                                 {"name": "anon", "wasm_b64":
                                  WASM_B64["fib"]}, None, 403),
    "malformed_json": ("POST", "/v1/invoke", b"{not json",
                       {"Content-Type": "application/json"}, 400),
    "missing_func": ("POST", "/v1/invoke", {"args": [1]}, None, 400),
    "args_not_list": ("POST", "/v1/invoke", {"func": "fib", "args": 3},
                      None, 400),
    "arg_too_wide": ("POST", "/v1/invoke",
                     {"func": "fib", "args": [1 << 70]}, None, 400),
    "keyed_without_key": ("POST", "/v1/invoke",
                          {"func": "fib", "args": [3], "tenant": "alice"},
                          None, 401),
    "unknown_key": ("POST", "/v1/invoke", {"func": "fib", "args": [3]},
                    {"Authorization": "Bearer sk-wrong"}, 401),
    "key_mismatch": ("POST", "/v1/invoke",
                     {"func": "fib", "args": [3], "tenant": "bob"},
                     {"Authorization": "Bearer sk-alice"}, 401),
    "may_not_register": ("POST", "/v1/modules",
                         {"name": "bobs", "wasm_b64": WASM_B64["fib"]},
                         {"X-Api-Key": "sk-bob"}, 403),
    "deadline": ("POST", "/v1/invoke",
                 {"func": "fib", "args": [14], "deadline_ms": 1}, None, 504),
    "no_route": ("GET", "/v1/nothing", None, None, 404),
    "no_post_route": ("POST", "/v1/nothing", {}, None, 404),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_rejection_equals_jax(pair, case):
    method, path, body, headers, code = REJECTIONS[case]
    st, doc, _ = same(pair, method, path, body, headers)
    assert st == code, doc
    assert doc["ok"] is False
    st, doc, _ = rpc(pair["port"], "GET", "/v1/status")
    assert not {"junk", "orphan", "bobs", "anon"} & set(doc["modules"])


def test_keyed_tenants_served_like_jax(pair):
    st, doc, _ = same(pair, "POST", "/v1/invoke",
                      {"func": "fib", "args": [7]},
                      {"Authorization": "Bearer sk-alice"})
    assert st == 200 and doc["tenant"] == "alice" and doc["result"] == [13]
    st, doc, _ = same(pair, "POST", "/v1/invoke",
                      {"func": "fib", "args": [6]}, {"X-Api-Key": "sk-bob"})
    assert st == 200 and doc["tenant"] == "bob"
    for gw in pair.values():
        srv = gw.service.current.server
        assert srv.queue.quotas == {"alice": 2}
        assert srv.queue.weights == {"alice": 2.0, "bob": 1.0, "slow": 1.0}


def test_rate_limit_429_equals_jax(pair):
    body = {"func": "fib", "args": [4], "tenant": "slow"}
    st, doc, _ = same(pair, "POST", "/v1/invoke", body)
    assert st == 200 and doc["result"] == [3]
    st, doc, after = same(pair, "POST", "/v1/invoke", body)
    assert st == 429 and after is not None and int(after) >= 900
    assert doc["err"]["name"] == "RateLimited"
    for gw in pair.values():
        assert gw.service.counters["rate_limited"] == 1


@pytest.mark.parametrize("method,path", [
    ("GET", "/metrics"), ("GET", "/v1/requests/1/stream"),
    ("POST", "/v1/requests/1/wake"), ("GET", "/v1/fleet/status"),
    ("POST", "/v1/fleet/heartbeat"), ("POST", "/v1/reshard")])
def test_routes_of_later_items_answer_not_found(pair, method, path):
    st, doc, _ = rpc(pair["port"], method, path,
                     {} if method == "POST" else None)
    assert st == 404
    assert doc == {"ok": False, "err": {"name": "NotFound",
                                        "retryable": False,
                                        "message": f"no route {path}"}}


def test_status_and_vm_gateway():
    """`VM.gateway()` gives an unstarted Gateway over the VM's module on
    the device asked for; /v1/status carries the health block and the
    counters."""
    from wasmedge_tpu_torch.vm.vm import VM

    vm = VM(_conf("port"))
    vm.load_wasm(build_fib())
    vm.validate()
    vm.instantiate()
    gw = vm.gateway(lanes=2, device="cpu")
    assert gw._thread is None
    gw.start()
    try:
        st, doc, _ = rpc(gw, "POST", "/v1/invoke",
                         {"module": "main", "func": "fib", "args": [9]})
        assert st == 200 and doc["result"] == [34]
        st, doc, _ = rpc(gw, "GET", "/v1/status")
        assert st == 200 and doc["modules"] == {"main": ["fib"]}
        assert doc["device"] == "cpu" and doc["durable"] is False
        assert doc["health"]["status"] == "healthy"
        assert doc["gateway"]["completed"] == 1
    finally:
        gw.shutdown()
    with pytest.raises(Exception):
        VM().gateway(device="cpu")   # no instantiated module


@pytest.mark.parametrize("sink", [True, False])
def test_echo_stdout_sunk_or_written(capfd, sink):
    """A WASI echo module in a generation: with `sink_stdout` nothing
    reaches the process's stdout; without it exactly the guest's bytes."""
    svc = GatewayService(conf=_conf("port"), lanes=2, device="cpu",
                         sink_stdout=sink)
    try:
        svc.preload([("fib", build_fib()), ("echo", build_echo())])
        capfd.readouterr()
        reqs = [svc.submit("echo", [3], module="echo"),
                svc.submit("fib", [6], module="fib"),
                svc.submit("echo", [2], module="echo")]
        for r in reqs:
            assert svc.wait(r, timeout_s=120.0)
        assert [r.future.result(0) for r in reqs] == [[0], [8], [0]]
        out = capfd.readouterr().out.encode()
        assert out == (b"" if sink else ECHO_MESSAGE * 10)
        hc = svc.current.engine.hostcall_stats
        assert hc["tier1_calls"] == 10 and hc["tier0_calls"] == 0
    finally:
        svc.shutdown()


def test_gateway_closed_answers_503(pair):
    """Last: the services shut down under their HTTP servers; an invoke
    then draws 503 with Retry-After (come back), not the 403 of an
    admission block."""
    for gw in pair.values():
        gw.service.shutdown()
    st, doc, after = same(pair, "POST", "/v1/invoke",
                          {"func": "fib", "args": [3]})
    assert st == 503 and after == "1" and doc["err"]["retryable"] is True
    st, doc, after = same(pair, "POST", "/v1/modules",
                          {"name": "late", "wasm_b64": WASM_B64["fib"]},
                          ALICE)
    assert st == 503 and after == "1"


def test_a_burst_of_connections_is_queued_not_dropped():
    """64 clients connecting at once to a gateway whose accept loop has
    not taken any yet: the kernel queues every handshake (the listen
    backlog), where stdlib's default backlog of 5 completes six and
    drops the others' SYNs, which their clients retry a second and more
    later."""
    import select
    import socket

    svc = GatewayService(lanes=2, device="cpu")
    gw = Gateway(svc, port=0)   # bound and listening, not accepting yet
    socks = []
    try:
        for _ in range(64):
            s = socket.socket()
            s.setblocking(False)
            s.connect_ex((gw.host, gw.port))
            socks.append(s)
        done = set()
        deadline = time.monotonic() + 0.5
        while len(done) < len(socks) and time.monotonic() < deadline:
            _, ready, _ = select.select(
                [], [s for s in socks if s not in done], [], 0.05)
            done.update(s for s in ready if s.getsockopt(
                socket.SOL_SOCKET, socket.SO_ERROR) == 0)
        assert len(done) == len(socks)
    finally:
        for s in socks:
            s.close()
        gw.start().shutdown()
