"""The port's gateway units against the JAX package's on the same inputs:
the tenants table (auth stub, token bucket, shedding tiers, FairQueue
maps), the refusal of the tenants-file keys of subsystems the port does
not have yet, the durable store (a round trip read by the other package,
the corrupt-newest fallback), the durable result entries, the
`HealthGate` states over one stand-in service, and the rejection
contract (rejection_info, the HTTP status, Retry-After and body of each
rejection class)."""

import json
import os

import pytest

from wasmedge_tpu.common.errors import (
    ErrCode as RefErrCode, WasmError as RefWasmError,
    rejection_info as ref_rejection_info)
from wasmedge_tpu.gateway import durable as ref_durable
from wasmedge_tpu.gateway import health as ref_health
from wasmedge_tpu.gateway import http as ref_http
from wasmedge_tpu.gateway import service as ref_service
from wasmedge_tpu.gateway import tenants as ref_tenants
from wasmedge_tpu.serve import queue as ref_queue
from wasmedge_tpu_torch.common.errors import (
    ErrCode, WasmError, rejection_info)
from wasmedge_tpu_torch.gateway import durable, health, http, service, tenants
from wasmedge_tpu_torch.serve import queue

PKGS = {"port": (tenants, durable, health, http, service, queue),
        "ref": (ref_tenants, ref_durable, ref_health, ref_http, ref_service,
                ref_queue)}

POLICIES = {
    "open": {},
    "keyed": {"tenants": {"keyed": {"api_key": "sk-k", "weight": 3.0},
                          "open": {}}},
    "closed": {"require_auth": True, "default_tenant": "anon",
               "tenants": {"alice": {"api_key": "sk-alice", "weight": 2.0,
                                     "quota": 8, "rate_per_s": 50,
                                     "burst": 100, "can_register": True},
                           "bob": {"api_key": "sk-bob", "weight": 1.0,
                                   "can_register": False}}},
    "one_tier": {"require_auth": True,
                 "tenants": {"a": {"api_key": "ka", "weight": 0.5},
                             "b": {"api_key": "kb", "weight": 0.5}}},
    "open_half": {"tenants": {"a": {"weight": 0.5}, "b": {"weight": 0.5}}},
    "gold": {"tenants": {"gold": {"weight": 3.0}}},
}

AUTH_CASES = [(None, None), (None, "open"), (None, "keyed"), ("sk-k", None),
              ("sk-k", "keyed"), ("sk-k", "open"), ("sk-wrong", None),
              (None, "alice"), ("sk-alice", None), ("sk-alice", "bob"),
              ("sk-bob", "bob"), (None, "anon"), ("ka", None)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", list(POLICIES))
def test_tenants_table_equals_jax(name):
    doc = POLICIES[name]
    got = tenants.GatewayTenants.from_dict(json.loads(json.dumps(doc)))
    want = ref_tenants.GatewayTenants.from_dict(json.loads(json.dumps(doc)))
    assert got.weights() == want.weights()
    assert got.quotas() == want.quotas()
    assert got.shed_weight_floor() == want.shed_weight_floor()
    assert got.require_auth == want.require_auth
    assert got.default_tenant == want.default_tenant
    for t in ("alice", "bob", "keyed", "open", "gold", "a", "x"):
        assert got.can_register(t) == want.can_register(t), t
        assert got.effective_weight(t) == want.effective_weight(t), t
    for key, claimed in AUTH_CASES:
        assert _outcome(lambda: got.authenticate(key, claimed)) == \
            _outcome(lambda: want.authenticate(key, claimed)), (key, claimed)


def test_tenants_file_json_and_toml(tmp_path):
    doc = POLICIES["closed"]
    pj = tmp_path / "t.json"
    pj.write_text(json.dumps(doc))
    pt = tmp_path / "t.toml"
    pt.write_text('require_auth = true\n[tenants.alice]\napi_key = '
                  '"sk-alice"\nweight = 2.0\nquota = 8\n')
    for p in (pj, pt):
        got = tenants.GatewayTenants.from_file(str(p))
        want = ref_tenants.GatewayTenants.from_file(str(p))
        assert got.weights() == want.weights()
        assert got.quotas() == want.quotas()
        assert got.authenticate("sk-alice", None) == \
            want.authenticate("sk-alice", None)


@pytest.mark.parametrize("doc,item", [
    ({"tenants": {"t": {"analysis": {"max_cost": 10}}}}, "A7.8"),
    ({"analysis": {"max_cost": 10}, "tenants": {}}, "A7.8"),
    ({"tenants": {"t": {"resident_budget_bytes": 1 << 20}}}, "A7.3"),
])
def test_tenants_file_refuses_keys_of_later_items(doc, item):
    """The JAX package reads these keys; the port refuses them with the
    ROADMAP item that brings them, never ignores them."""
    with pytest.raises(ValueError, match=item):
        tenants.GatewayTenants.from_dict(doc)


def test_unknown_policy_key_refused_like_jax():
    doc = {"tenants": {"t": {"wieght": 2.0}}}
    with pytest.raises(ValueError) as got:
        tenants.GatewayTenants.from_dict(doc)
    with pytest.raises(ValueError) as want:
        ref_tenants.GatewayTenants.from_dict(doc)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rate,burst", [(2.0, 3.0), (0.0, 1.0), (10.0, 0.5)])
def test_token_bucket_equals_jax(monkeypatch, rate, burst):
    """The same arrival times through both buckets: the same admissions and
    the same refill hints."""
    clock = [100.0]
    monkeypatch.setattr(tenants.time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(ref_tenants.time, "monotonic", lambda: clock[0])
    got = tenants.TokenBucket(rate, burst)
    want = ref_tenants.TokenBucket(rate, burst)
    for dt in (0.0, 0.0, 0.1, 0.0, 0.0, 0.5, 0.05, 1.0, 0.0, 0.0, 0.0, 2.0):
        clock[0] += dt
        assert got.try_take() == want.try_take()
        assert got.tokens == want.tokens


def test_rate_limit_raises_like_jax(monkeypatch):
    clock = [5.0]
    monkeypatch.setattr(tenants.time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(ref_tenants.time, "monotonic", lambda: clock[0])
    doc = {"tenants": {"slow": {"rate_per_s": 1.0, "burst": 1}}}
    for pkg in (tenants, ref_tenants):
        t = pkg.GatewayTenants.from_dict(doc)
        t.check_rate("slow")
        with pytest.raises(pkg.RateLimited) as exc:
            t.check_rate("slow")
        assert exc.value.retry_after_s == 1.0
        t.check_rate("other")   # no bucket, no limit


# -- the durable store ------------------------------------------------------
def _write(pkg_durable, d):
    store = pkg_durable.DurableStore(d, keep=2, result_cache=3)
    store.save_module_bytes("ab" * 32, b"\0asm\1\0\0\0")
    store.write_manifest([{"name": "fib", "sha256": "ab" * 32,
                           "tenant": None, "source": "boot"}], 3,
                         "serve/gen-000003", 1)
    for k in range(3):
        store.write_journal([{"id": 10 + k, "func": "fib:fib",
                              "args": [k], "tenant": "t"}],
                            [{"id": j, "ok": True, "result": [j]}
                             for j in range(5)], max_id=12 + k, min_id=1)
    return store


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_durable_round_trip_across_packages(tmp_path, writer, reader):
    d = str(tmp_path)
    _write(PKGS[writer][1], d)
    store = PKGS[reader][1].DurableStore(d, keep=2, result_cache=3)
    manifest, journal = store.load()
    assert manifest["generation"] == 3 and manifest["restarts"] == 1
    assert manifest["modules"][0]["name"] == "fib"
    assert journal["unresolved"] == [{"id": 12, "func": "fib:fib",
                                      "args": [2], "tenant": "t"}]
    # the result cache's depth is applied at the write
    assert [e["id"] for e in journal["resolved"]] == [2, 3, 4]
    assert (journal["max_id"], journal["min_id"]) == (14, 1)
    assert store.module_bytes("ab" * 32) == b"\0asm\1\0\0\0"
    # two members of each kind kept
    names = sorted(os.listdir(d))
    assert sum(n.startswith("journal-") for n in names) == 2
    assert store.serve_dir_for(3) == os.path.join(d, "serve", "gen-000003")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_corrupt_newest_journal_falls_back(tmp_path, pkg):
    d = str(tmp_path)
    store = PKGS[pkg][1].DurableStore(d)
    store.write_journal([{"id": 1, "func": "f", "args": []}], [])
    store.write_journal([{"id": 2, "func": "f", "args": []}], [])
    newest = sorted(fn for fn in os.listdir(d)
                    if fn.startswith("journal-"))[-1]
    with open(os.path.join(d, newest), "w") as f:
        f.write('{"truncated')
    store2 = PKGS[pkg][1].DurableStore(d)
    _, journal = store2.load()
    assert journal["unresolved"][0]["id"] == 1
    assert store2.load_errors == 1


def test_journal_write_fault_raises_before_any_file(tmp_path):
    from wasmedge_tpu_torch.testing.faults import (
        Fault, FaultInjector, InjectedFault)

    inj = FaultInjector([Fault(point="journal_write", at=0,
                               match={"kind": "journal"})])
    store = durable.DurableStore(str(tmp_path), faults=inj)
    with pytest.raises(InjectedFault):
        store.write_journal([], [])
    assert not [f for f in os.listdir(tmp_path) if f.startswith("journal")]
    store.write_journal([], [])
    assert store.load()[1]["unresolved"] == []


def test_drop_serve_dir_refuses_paths_outside(tmp_path):
    store = durable.DurableStore(str(tmp_path / "state"))
    outside = tmp_path / "keep"
    outside.mkdir()
    store.drop_serve_dir(str(outside))
    assert outside.exists()
    inside = store.serve_dir_for(1)
    os.makedirs(inside)
    store.drop_serve_dir(inside)
    assert not os.path.exists(inside)


class _Req:
    def __init__(self, q, rid, err=None, cells=(7, 9)):
        self.id, self.tenant, self.func = rid, "t", "m:f"
        self.future = q.ServeFuture(rid)
        if err is None:
            self.future._resolve(list(cells))
        else:
            self.future._reject(err)


def _errors(q, errs):
    return {"ok": None, "deadline": q.DeadlineExceeded("late"),
            "lifecycle": q.ServeRejected("server shut down"),
            "trap": errs.WasmError(errs.ErrCode.DivideByZero),
            "error": RuntimeError("boom")}


@pytest.mark.parametrize("kind", ["ok", "deadline", "lifecycle", "trap",
                                  "error"])
def test_resolved_entries_equal_jax(kind):
    import wasmedge_tpu.common.errors as ref_errs
    import wasmedge_tpu_torch.common.errors as errs

    got = durable._resolved_entry(_Req(queue, 5, _errors(queue, errs)[kind]))
    want = ref_durable._resolved_entry(
        _Req(ref_queue, 5, _errors(ref_queue, ref_errs)[kind]))
    assert got == want
    if kind != "ok":
        back = durable.resolved_error(got)
        ref_back = ref_durable.resolved_error(want)
        assert type(back).__name__ == type(ref_back).__name__
        assert str(back) == str(ref_back)
        assert int(back.code) == int(ref_back.code)


# -- health -----------------------------------------------------------------
class _Srv:
    def __init__(self, k, streak, failed, thread, stop, depth, cap):
        self.failed = failed
        self._thread = thread
        self._stop = stop
        self.k = k
        self.k.queue_capacity = cap
        self.queue = [0] * depth
        self.checkpoint_fail_streak = streak
        self.last_checkpoint_error = OSError("disk full") if streak else None


class _Gen:
    def __init__(self, srv):
        self.gen_id, self.server = 3, srv


class _Svc:
    def __init__(self, gen, last_swap, durable_on, journal_streak, forced,
                 tn, shed=True):
        self.current = gen
        self.last_swap = last_swap
        self.durable = object() if durable_on else None
        self.counters = {"journal_errors": journal_streak}
        self._journal_fail_streak = journal_streak
        self.force_degraded = forced
        self.tenants = tn
        self.shed_on_degraded = shed


class _Thread:
    def __init__(self, alive):
        self.alive = alive

    def is_alive(self):
        return self.alive


HEALTH_CASES = {
    "healthy": dict(),
    "no_generation": dict(gen=False),
    "failed": dict(failed=True),
    "dead_driver": dict(alive=False),
    "stopped_driver": dict(alive=False, stop=True),
    "saturated": dict(depth=9, cap=10),
    "below_saturation": dict(depth=7, cap=10),
    "checkpoint_streak": dict(streak=2),
    "rollback": dict(last_swap={"ok": False, "generation": 1,
                                "error": "InjectedFault('x')"}),
    "swap_ok": dict(last_swap={"ok": True, "generation": 2, "error": None}),
    "journal_failing": dict(durable_on=True, journal_streak=1),
    "journal_ok": dict(durable_on=True),
    "forced": dict(forced=True),
}


def _svc(pkg, c, tn):
    from wasmedge_tpu.common.configure import ServeConfigure as RefServe
    from wasmedge_tpu_torch.common.configure import ServeConfigure

    gen = None
    if c.get("gen", True):
        err = ValueError("dead") if c.get("failed") else None
        srv = _Srv((ServeConfigure if pkg == "port" else RefServe)(),
                   c.get("streak", 0), err, _Thread(c.get("alive", True)),
                   c.get("stop", False), c.get("depth", 0), c.get("cap", 64))
        gen = _Gen(srv)
    return _Svc(gen, c.get("last_swap"), c.get("durable_on", False),
                c.get("journal_streak", 0), c.get("forced", False), tn)


@pytest.mark.parametrize("case", list(HEALTH_CASES))
def test_health_states_equal_jax(case):
    c = HEALTH_CASES[case]
    got = health.health_of(_svc("port", c, None))
    want = ref_health.health_of(_svc("ref", c, None))
    assert (got["ok"], got["status"]) == (want["ok"], want["status"])
    assert set(got["checks"]) == set(want["checks"])
    for name, chk in got["checks"].items():
        ref = want["checks"][name]
        assert (chk["ok"], chk["level"]) == (ref["ok"], ref["level"]), name
        if name == "checkpoint" and not chk["ok"]:
            # the port's detail adds the server's last checkpoint error
            assert chk["detail"].startswith(ref["detail"])
            assert "disk full" in chk["detail"]
        else:
            assert chk["detail"] == ref["detail"], name


@pytest.mark.parametrize("policy,tenant,forced", [
    ("gold", "bronze", True), ("gold", "gold", True), ("gold", "bronze",
                                                        False),
    ("open", "anyone", True), ("one_tier", "a", True),
    ("open_half", "a", True), ("open_half", "z", True)])
def test_health_gate_sheds_like_jax(policy, tenant, forced):
    out = {}
    for pkg, mods in PKGS.items():
        tn = mods[0].GatewayTenants.from_dict(POLICIES[policy])
        svc = _svc(pkg, {"forced": forced}, tn)
        gate = mods[2].HealthGate(svc)
        try:
            gate.maybe_shed(tenant)
            out[pkg] = None
        except mods[2].ShedLoad as e:
            out[pkg] = (e.retryable, e.retry_after_s, str(e),
                        rejection_info(e) if pkg == "port"
                        else ref_rejection_info(e))
    assert out["port"] == out["ref"]


def test_health_gate_memoizes(monkeypatch):
    clock = [10.0]
    monkeypatch.setattr(health.time, "monotonic", lambda: clock[0])
    svc = _svc("port", {}, None)
    gate = health.HealthGate(svc, ttl_s=0.5)
    assert gate.health()["status"] == "healthy"
    svc.force_degraded = True
    assert gate.health()["status"] == "healthy"   # memoized
    clock[0] += 0.6
    assert gate.health()["status"] == "degraded"
    svc.force_degraded = False
    assert gate.health(fresh=True)["status"] == "healthy"


# -- the rejection contract --------------------------------------------------
def _rejections(pkg):
    t, d, h, _, s, q = PKGS[pkg]
    errs_mod = __import__(
        "wasmedge_tpu_torch.common.errors" if pkg == "port"
        else "wasmedge_tpu.common.errors", fromlist=["x"])
    E, C = errs_mod.WasmError, errs_mod.ErrCode
    return {
        "queue_saturated": q.QueueSaturated("full", retry_after_s=0.25),
        "queue_saturated_no_hint": q.QueueSaturated(),
        "deadline": q.DeadlineExceeded(),
        "serve_rejected": q.ServeRejected("server shut down"),
        "rate_limited": t.RateLimited("bob", 2.5),
        "rate_limited_inf": t.RateLimited("bob", float("inf")),
        "auth": t.AuthError("missing API key"),
        "not_found": KeyError("no registered module 'nope'"),
        "not_found_bare": KeyError(),
        "shed": h.ShedLoad("bronze", "forced"),
        "durability": d.DurabilityError("journal write failed"),
        "build_failed": s.GenerationBuildFailed("generation 2 build failed"),
        "closed": s.GatewayClosed(),
        "engine_failure": errs_mod.EngineFailure("dead"),
        "load": errs_mod.LoadError(C.MalformedMagic),
        "validation": errs_mod.ValidationError(C.TypeCheckFailed),
        "instantiation": errs_mod.InstantiationError(C.UnknownImport),
        "conflict": E(C.ModuleNameConflict, "module 'fib' already "
                      "registered"),
        "blocked": E(C.Terminated, "no admission capacity"),
        "illegal_name": E(C.IllegalPath, "invalid module name"),
        "value": ValueError("module not batchable"),
        "type": TypeError("bad"),
        "other": RuntimeError("boom"),
    }


@pytest.mark.parametrize("name", list(_rejections("port")))
def test_rejection_contract_equals_jax(name):
    got = _rejections("port")[name]
    want = _rejections("ref")[name]
    assert http.submit_status_of(got) == ref_http.submit_status_of(want)
    assert http.retry_after_of(got) == ref_http.retry_after_of(want)
    assert http.error_payload(got) == ref_http.error_payload(want)
    if isinstance(got, WasmError):
        assert rejection_info(got) == ref_rejection_info(want)


def test_admission_block_is_403_and_closed_is_503():
    assert http.submit_status_of(service.GatewayClosed()) == 503
    assert http.submit_status_of(WasmError(ErrCode.Terminated)) == 403
    assert WasmError(ErrCode.Terminated).retryable is False
    assert RefWasmError(RefErrCode.Terminated).retryable is False
    assert service.GatewayClosed().retryable is True
