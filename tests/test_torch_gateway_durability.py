"""The port's durable gateway on the CPU, after the JAX package's
tests/test_gateway_durability.py: a faulted generation build rolls back
atomically and its re-POST lowers nothing; a swap fault never half-swaps;
a kernel that does not build, and a build past the timeout (through the
monkeypatched build hook), roll back as retryable GenerationBuildFailed
and the retry succeeds; a faulted journal write rejects the submission
and withdraws it; withdraw; shedding while degraded (never for a single
tier); the pruned-id 404; a checkpoint write that fails degrades health
until one succeeds; kill and resume bring back the modules and every
async id with its model's value (no timing assertion: the port adopts a
checkpoint the JAX load refuses, ROADMAP C14, so an id may come back in
flight or re-queued)."""

import time

import pytest
import torch

from wasmedge_tpu_torch.batch.interp import KernelBuildError
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import rejection_info
from wasmedge_tpu_torch.gateway import (
    DurabilityError, Gateway, GatewayService, GatewayTenants,
    GenerationBuildFailed, ShedLoad)
from wasmedge_tpu_torch.gateway import service as gw_service
from wasmedge_tpu_torch.gateway.http import retry_after_of, submit_status_of
from wasmedge_tpu_torch.gateway.registry import ModuleRegistry
from wasmedge_tpu_torch.models import build_fib
from wasmedge_tpu_torch.testing.faults import Fault, FaultInjector
from wasmedge_tpu_torch.utils.builder import ModuleBuilder


def fib_py(n):
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


def _conf():
    conf = Configure()
    conf.batch.steps_per_launch = 256
    conf.batch.value_stack_depth = 128
    conf.batch.call_stack_depth = 64
    return conf


def build_dbl() -> bytes:
    b = ModuleBuilder()
    b.add_function(["i64"], ["i64"], [],
                   [("local.get", 0), ("i64.const", 2), "i64.mul",
                    ("i64.const", 7), "i64.add"], export="dbl")
    return b.build()


def _svc(**kw):
    svc = GatewayService(conf=kw.pop("conf", None) or _conf(), lanes=2,
                         device="cpu", **kw)
    svc.register_module("fib", wasm_bytes=build_fib(), source="boot")
    return svc


def _invoke(svc, func, args, module=None, tenant="default"):
    req = svc.submit(func, args, module=module, tenant=tenant)
    assert svc.wait(req, timeout_s=120.0)
    return req.future.result(0)


def _assert_rolled_back(svc, exc, gen_before):
    assert exc.retryable is True
    assert rejection_info(exc)["retryable"] is True
    assert submit_status_of(exc) == 503
    assert retry_after_of(exc) == "1"
    assert svc.generation == gen_before
    assert len(svc._gens) == 1   # nothing half-installed
    assert svc.registry.names == ["fib"]
    assert svc.last_swap is not None and not svc.last_swap["ok"]
    assert svc.health()["checks"]["last_swap"]["ok"] is False


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GatewayService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModuleRegistry()


@pytest.mark.parametrize("point", ["generation_build", "generation_swap"])
def test_build_and_swap_faults_roll_back_atomically(point):
    svc = _svc(faults=FaultInjector([Fault(point=point, at=1)]))
    try:
        before = _invoke(svc, "fib", [9], module="fib")
        gen_before = svc.generation
        lowered = svc.registry.lowered_count
        with pytest.raises(GenerationBuildFailed) as exc:
            svc.register_module("dbl", wasm_bytes=build_dbl())
        _assert_rolled_back(svc, exc.value, gen_before)
        assert svc.counters["rollbacks"] == 1
        # the prior generation serves as before
        assert _invoke(svc, "fib", [9], module="fib") == before \
            == [fib_py(9)]
        # dbl was lowered once; the retry adopts the stashed engine
        assert svc.registry.lowered_count == lowered + 1
        out = svc.register_module("dbl", wasm_bytes=build_dbl())
        # a swap fault comes after its build committed the number
        assert out["generation"] == gen_before + (
            1 if point == "generation_build" else 2)
        assert svc.registry.lowered_count == lowered + 1
        assert svc.registry.compile_cache.counts["probe_hits"] == 1
        assert svc.last_swap["ok"] is True
        assert _invoke(svc, "dbl", [5], module="dbl") == [17]
        assert _invoke(svc, "fib", [7], module="fib") == [13]
    finally:
        svc.shutdown()


def test_kernel_build_failure_rolls_back(monkeypatch):
    """A generation whose kernel does not build rolls back: retryable,
    the prior generation serving, nothing of the failed one serving."""
    svc = _svc()
    calls = []

    def broken(engine):
        calls.append(engine)
        raise KernelBuildError("nvcc failed (1) on fused_x.cu")

    try:
        monkeypatch.setattr(gw_service, "build_generation_kernels", broken)
        with pytest.raises(GenerationBuildFailed) as exc:
            svc.register_module("dbl", wasm_bytes=build_dbl())
        assert "KernelBuildError" in str(exc.value)
        _assert_rolled_back(svc, exc.value, 1)
        assert len(calls) == 1 and calls[0].module_names == ["fib", "dbl"]
        assert svc.counters["generations"] == 1
        assert _invoke(svc, "fib", [8], module="fib") == [21]
        with pytest.raises(KeyError):
            svc.submit("dbl", [1], module="dbl")
        monkeypatch.undo()
        lowered = svc.registry.lowered_count
        assert svc.register_module("dbl", wasm_bytes=build_dbl())[
            "generation"] == 2
        assert svc.registry.lowered_count == lowered
        assert _invoke(svc, "dbl", [4], module="dbl") == [15]
    finally:
        svc.shutdown()


def test_build_timeout_rolls_back_and_the_retry_succeeds(monkeypatch):
    """A build past `build_timeout_s` (a wedged nvcc, through the build
    hook) releases the registration at the timeout and rolls back; the
    retry lowers nothing and swaps in generation 2."""
    svc = _svc(build_timeout_s=0.3)
    orig = gw_service.build_generation_kernels
    release = []

    def wedged(engine):
        deadline = time.monotonic() + 10.0
        while not release and time.monotonic() < deadline:
            time.sleep(0.01)
        return orig(engine)

    try:
        monkeypatch.setattr(gw_service, "build_generation_kernels", wedged)
        with pytest.raises(GenerationBuildFailed) as exc:
            svc.register_module("dbl", wasm_bytes=build_dbl())
        # released at the timeout, while the wedged build still waited
        assert "timeout" in str(exc.value) and not release
        _assert_rolled_back(svc, exc.value, 1)
        release.append(True)   # the abandoned build ends and commits nothing
        monkeypatch.setattr(gw_service, "build_generation_kernels", orig)
        lowered = svc.registry.lowered_count
        out = svc.register_module("dbl", wasm_bytes=build_dbl())
        assert out["generation"] == 2 and out["modules"] == ["fib", "dbl"]
        assert svc.registry.lowered_count == lowered
        assert _invoke(svc, "fib", [8], module="fib") == [21]
        assert _invoke(svc, "dbl", [4], module="dbl") == [15]
    finally:
        svc.shutdown()


def test_journal_write_fault_rejects_and_withdraws(tmp_path):
    inj = FaultInjector([Fault(point="journal_write", at=0,
                               match={"kind": "journal"})])
    svc = _svc(faults=inj, state_dir=str(tmp_path / "state"))
    try:
        with pytest.raises(DurabilityError) as exc:
            svc.submit("fib", [8], module="fib")
        assert exc.value.retryable is True
        assert submit_status_of(exc.value) == 503
        assert svc.counters["journal_errors"] == 1
        assert svc.counters["received"] == 0
        assert len(svc._requests) == 0
        h = svc.health()
        assert h["status"] == "degraded"
        assert h["checks"]["journal"]["ok"] is False
        assert _invoke(svc, "fib", [8], module="fib") == [21]
        assert svc.health()["checks"]["journal"]["ok"] is True
    finally:
        svc.shutdown()


def test_withdraw_pulls_a_queued_request_back():
    svc = _svc()
    try:
        srv = svc.current.server
        with srv._lock:   # hold the serving loop off its admission
            f1 = svc.submit("fib", [5], module="fib")
            f2 = svc.submit("fib", [6], module="fib")
            assert srv.withdraw(f2.id) is True
            assert srv.withdraw(f2.id) is False
        assert svc.wait(f1, timeout_s=60.0)
        assert f1.future.result(0) == [5]
        assert not f2.future.done
        assert srv.counters["rejected"] == 1
    finally:
        svc.shutdown()


def test_degraded_gateway_sheds_only_its_lowest_tier():
    tenants = GatewayTenants.from_dict({"tenants": {"gold": {"weight": 3.0}}})
    svc = _svc(tenants=tenants)
    try:
        svc.force_degraded = True
        with pytest.raises(ShedLoad) as exc:
            svc.submit("fib", [8], module="fib", tenant="bronze")
        info = rejection_info(exc.value)
        assert info["retryable"] is True and info["detail"] == "shed"
        assert submit_status_of(exc.value) == 429
        assert svc.counters["shed"] == 1
        assert svc.shed_counts == {"bronze": 1}
        assert _invoke(svc, "fib", [7], module="fib", tenant="gold") == [13]
        svc.force_degraded = False
        assert svc.health()["status"] == "healthy"   # refreshes the memo
        assert _invoke(svc, "fib", [6], module="fib",
                       tenant="bronze") == [8]
    finally:
        svc.shutdown()
    single = _svc()
    try:
        single.force_degraded = True
        assert single.health()["status"] == "degraded"
        assert _invoke(single, "fib", [6], module="fib") == [8]
    finally:
        single.shutdown()


def test_pruned_id_answers_its_own_404():
    from tests.test_torch_gateway import rpc

    svc = _svc(result_cache=2)
    gw = Gateway(svc, port=0).start()
    try:
        ids = []
        for n in (5, 6, 7):
            req = svc.submit("fib", [n], module="fib")
            assert svc.wait(req, timeout_s=60.0)
            ids.append(req.id)
        assert svc.request_state(ids[0]) == ("pruned", None)
        st, doc, _ = rpc(gw, "GET", f"/v1/requests/{ids[0]}")
        assert st == 404 and doc["err"]["detail"] == "pruned"
        st, doc, _ = rpc(gw, "GET", "/v1/requests/999999999")
        assert st == 404 and "detail" not in doc["err"]
        st, doc, _ = rpc(gw, "GET", f"/v1/requests/{ids[2]}")
        assert st == 200 and doc["result"] == [13]
    finally:
        gw.shutdown(drain=False)


def test_checkpoint_fault_degrades_health_until_a_save():
    """A serve checkpoint that fails to write raises the server's streak
    (health: degraded, the error in the detail); the next good save
    clears it."""
    inj = FaultInjector([Fault(point="checkpoint_save", at=0)])
    svc = _svc(faults=inj)
    try:
        srv = svc.current.server
        req = svc.submit("fib", [7], module="fib")
        assert svc.wait(req, timeout_s=60.0)
        assert req.future.result(0) == [13]
        assert srv.checkpoint() is None
        assert srv.checkpoint_fail_streak == 1
        h = svc.health()
        assert h["status"] == "degraded"
        assert h["checks"]["checkpoint"]["ok"] is False
        assert "InjectedFault" in h["checks"]["checkpoint"]["detail"]
        assert srv.checkpoint() is not None
        assert srv.checkpoint_fail_streak == 0
        assert srv.last_checkpoint_error is None
        assert svc.health()["status"] == "healthy"
    finally:
        svc.shutdown()


def test_kill_and_resume_restore_modules_and_ids(tmp_path):
    d = str(tmp_path / "state")
    svc = _svc(state_dir=d)
    svc.register_module("dbl", wasm_bytes=build_dbl())
    done = svc.submit("fib", [8], module="fib")
    assert svc.wait(done, timeout_s=60.0)
    pending = [svc.submit("fib", [n], module="fib") for n in (11, 10)]
    pending.append(svc.submit("dbl", [20], module="dbl"))
    time.sleep(0.2)
    svc.kill()   # no drain, no flush

    svc2 = GatewayService(conf=_conf(), lanes=2, state_dir=d, resume=True,
                          device="cpu")
    try:
        assert svc2.registry.names == ["fib", "dbl"]
        assert svc2.counters["generations"] == 1
        assert svc2.counters["restarts"] == 1
        state, req = svc2.request_state(done.id)
        assert state == "ok" and req.future.result(0) == [21]
        assert svc2.counters["completed"] == 0
        for old, want in zip(pending, ([89], [55], [47])):
            state, req = svc2.request_state(old.id)
            assert state == "ok", old.id
            assert req.future.wait(120.0)
            assert req.future.result(0) == want
        fresh = svc2.submit("dbl", [1], module="dbl")
        assert fresh.id > max(r.id for r in pending)
        assert svc2.wait(fresh, timeout_s=60.0)
        assert fresh.future.result(0) == [9]
        assert svc2.health()["status"] == "healthy"
    finally:
        svc2.shutdown()
    svc3 = GatewayService(conf=_conf(), lanes=2, state_dir=d, resume=True,
                          device="cpu")
    try:
        assert svc3.counters["restarts"] == 2
        assert svc3.registry.names == ["fib", "dbl"]
    finally:
        svc3.shutdown()


@pytest.mark.parametrize("kw,item", [
    (dict(devices=[0]), "A7.9"), (dict(fleet=["h:1"]), "A7.9"),
    (dict(autoscale={}), "A7.9")])
def test_knobs_of_later_items_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        GatewayService(device="cpu", **kw)


def test_compile_cache_knob_raises():
    # the tier's directory comes with A7.7: no knob to set and ignore
    assert not hasattr(_conf().imagestore, "compile_cache_dir")
    conf = _conf()
    conf.imagestore.compile_cache = True
    with pytest.raises(NotImplementedError, match="A7.7"):
        GatewayService(conf=conf, device="cpu")


@pytest.mark.parametrize("cadence", [None, 1])
def test_checkpoint_fail_streak_equals_jax(tmp_path, cadence):
    """The server's checkpoint-write health against the JAX server's on
    the same script: a faulted `checkpoint_save` raises the streak and
    keeps its error, a good save clears both (on demand, or at the
    serving loop's cadence)."""
    from tests.test_torch_serve_recovery import _conf as serve_conf
    from tests.test_torch_serve_recovery import _server
    from tests.test_torch_supervisor import injector

    seen = {}
    for pkg in ("port", "ref"):
        inj = injector(pkg, [dict(point="checkpoint_save", at=0, times=2)])
        srv = _server(pkg, serve_conf(pkg, checkpoint_every_rounds=cadence),
                      lanes=2, faults=inj, checkpoint_dir=str(tmp_path / pkg))
        futs = [srv.submit("fib", [n]) for n in (7, 9)]
        streaks = []
        if cadence is None:
            srv.step()
            for _ in range(3):
                path = srv.checkpoint()
                streaks.append((path is None, srv.checkpoint_fail_streak,
                                type(srv.last_checkpoint_error).__name__))
            srv.run_until_idle()
        else:
            while srv.step():
                streaks.append((srv.checkpoint_fail_streak,
                                type(srv.last_checkpoint_error).__name__))
        seen[pkg] = (streaks, [f.result(0) for f in futs], inj.counts,
                     [f.fault_class for f in srv.failures])
        srv.shutdown(drain=False)
    assert seen["port"] == seen["ref"]
    streaks = seen["port"][0]
    if cadence is None:
        assert streaks == [(True, 1, "InjectedFault"),
                           (True, 2, "InjectedFault"), (False, 0, "NoneType")]
    else:
        assert streaks[:3] == [(1, "InjectedFault"), (2, "InjectedFault"),
                               (0, "NoneType")]
