"""The port's continuous-batching serving layer (serve/) on the CPU.

The serve tests of tests/test_serve.py held against the port's own solo
runs: results bit-identical to a solo `execute_batch`, lanes recycled,
deterministic admission under a seeded schedule, a quota against a
flooding tenant, weighted DRR order, queued deadlines and a full queue,
in-flight deadline kills and the step budget.  One seeded script runs
through the JAX server and the port's: results, admission order and
counters equal.  A server over a `MultiModuleBatchEngine` (two modules,
and config 5's four), `VM.serve`, the background serving thread, and a launch
failure that fails the server once its retries are spent.  (The launch after an install round,
kernel against plain, is in test_torch_serve_card.py.)
"""

import numpy as np
import pytest

from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.serve import BatchServer as RefServer
from wasmedge_tpu_torch.batch.multitenant import MultiModuleBatchEngine
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import EngineFailure, ErrCode, WasmError
from wasmedge_tpu_torch.models import (
    build_coremark_kernel, build_fac, build_fib, build_loop_sum)
from wasmedge_tpu_torch.models.fixtures import (
    fib_model, serve_load, serve_model, u32_cells)
from wasmedge_tpu_torch.serve import (
    BatchServer, DeadlineExceeded, FairQueue, QueueSaturated, ServeRequest)
from wasmedge_tpu_torch.vm.vm import VM
from tests.test_torch_multitenant import inst_of

pytestmark = pytest.mark.serve


def _fib(n):
    return int(fib_model([n])[0])


def _conf(pkg="port"):
    conf = (Configure if pkg == "port" else RefConfigure)()
    conf.batch.steps_per_launch = 256
    conf.batch.value_stack_depth = 128
    conf.batch.call_stack_depth = 64
    if pkg == "ref":
        conf.obs.enabled = True   # the admission events
        conf.batch.fuse_superinstructions = False
        conf.batch.tierup = False
    return conf


def _server(conf=None, lanes=4, **kw):
    conf = conf or _conf()
    inst, store = inst_of("port", build_fib(), conf)
    return BatchServer(inst, store=store, conf=conf, lanes=lanes,
                       device="cpu", **kw)


# ---------------------------------------------------------------------------
# results parity, recycling, reuse
# ---------------------------------------------------------------------------
def test_results_bit_identical_to_solo_execute_batch():
    ns = [5, 11, 12, 7, 3, 12, 9, 2, 10, 6]
    srv = _server(lanes=4)
    futs = [srv.submit("fib", [n]) for n in ns]
    srv.run_until_idle()
    got = [f.result(0)[0] for f in futs]
    vm = VM(_conf())
    vm.load_wasm(build_fib()).validate().instantiate()
    solo = vm.execute_batch("fib", [np.asarray(ns, np.int64)],
                            lanes=len(ns), device="cpu")
    assert solo.completed.all()
    assert got == [int(x) for x in solo.results[0]]
    # continuous batching recycled lanes (10 requests, 4 lanes)
    assert srv.counters["recycled_lanes"] >= 6
    assert srv.counters["completed"] == len(ns)
    assert srv.counters["retired_instructions"] == int(solo.retired.sum())
    # the drained server is reusable
    f2 = srv.submit("fib", [13])
    srv.run_until_idle()
    assert f2.result(0)[0] == _fib(13)


# ---------------------------------------------------------------------------
# deterministic admission, and the JAX server on the same script
# ---------------------------------------------------------------------------
def _seeded_drive(seed, srv):
    """Interleaved submit / step schedule; returns (results by submission
    index, futures)."""
    rng = np.random.RandomState(seed)
    futs = []
    for _ in range(5):
        for _ in range(int(rng.randint(1, 4))):
            n = int(rng.randint(3, 12))
            futs.append(srv.submit("fib", [n],
                                   tenant=f"t{int(rng.randint(2))}"))
        srv.step()
    srv.run_until_idle()
    return [f.result(0)[0] for f in futs], futs


def _admits(srv, futs):
    """(submission index, tenant, lane) in admission order."""
    first = futs[0].request_id
    return [(rid - first, tenant, lane)
            for rid, tenant, lane in srv.admissions]


def test_deterministic_admission_under_seeded_schedule():
    s1 = _server(lanes=2)
    r1, f1 = _seeded_drive(42, s1)
    s2 = _server(lanes=2)
    r2, f2 = _seeded_drive(42, s2)
    assert _admits(s1, f1) == _admits(s2, f2)
    assert r1 == r2 == [_fib(n) for n in _script_ns(42)]
    assert len(s1.admissions) == len(r1) > 0


def _script_ns(seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(5):
        for _ in range(int(rng.randint(1, 4))):
            out.append(int(rng.randint(3, 12)))
            rng.randint(2)
    return out


def test_seeded_script_equals_jax_server():
    """One seeded script through the JAX server and the port's: the same
    results, admission order (request, tenant, lane) and counters."""
    port = _server(lanes=2)
    got, pf = _seeded_drive(42, port)
    inst, store = inst_of("ref", build_fib(), _conf("ref"))
    ref = RefServer(inst, store=store, conf=_conf("ref"), lanes=2)
    want, rf = _seeded_drive(42, ref)
    assert got == want
    first = rf[0].request_id
    ref_admits = [(e["args"]["id"] - first, e["args"]["tenant"],
                   e["args"]["lane"])
                  for e in ref.obs.events if e["name"] == "admit"]
    assert _admits(port, pf) == ref_admits
    assert port.counters == {k: ref.counters[k] for k in port.counters}


# ---------------------------------------------------------------------------
# fairness
# ---------------------------------------------------------------------------
def test_flooding_tenant_cannot_starve_quota_tenant():
    srv = _server(lanes=4, quotas={"flood": 2, "blocked": 0})
    # a tenant configured out of admission is rejected at submit, and not
    # with QueueSaturated ("try later" never clears)
    with pytest.raises(WasmError) as exc:
        srv.submit("fib", [5], tenant="blocked")
    assert not isinstance(exc.value, QueueSaturated)
    flood = [srv.submit("fib", [9], tenant="flood") for _ in range(16)]
    paid = [srv.submit("fib", [5], tenant="paid") for _ in range(5)]
    max_flood_in_flight = 0
    while srv.step():
        max_flood_in_flight = max(max_flood_in_flight,
                                  srv._flight_by_tenant().get("flood", 0))
    assert max_flood_in_flight <= 2
    admits = [tenant for _, tenant, _ in srv.admissions]
    last_paid = max(i for i, t in enumerate(admits) if t == "paid")
    assert last_paid < 14, admits  # all 5 paid admits inside the flood
    assert [f.result(0)[0] for f in flood] == [_fib(9)] * 16
    assert [f.result(0)[0] for f in paid] == [_fib(5)] * 5


def test_weighted_drr_queue_order():
    q = FairQueue(capacity=100, weights={"a": 2.0, "b": 1.0})
    for i in range(6):
        q.push(ServeRequest("f", (i,), tenant="a"))
    for i in range(6):
        q.push(ServeRequest("f", (100 + i,), tenant="b"))
    picks = q.pop(9, {})
    by_tenant = [r.tenant for r in picks]
    # weight 2:1: tenant a gets two admissions per DRR round to b's one
    assert by_tenant[:3] == ["a", "a", "b"]
    assert by_tenant.count("a") == 6
    assert by_tenant.count("b") == 3
    # FIFO within each tenant
    assert [r.args[0] for r in picks if r.tenant == "b"] == [100, 101, 102]
    # a tiny positive weight is served slowly, never starved
    q2 = FairQueue(10, weights={"tiny": 0.0005})
    q2.push(ServeRequest("f", (1,), tenant="tiny"))
    assert len(q2.pop(1, {})) == 1


# ---------------------------------------------------------------------------
# deadlines and backpressure
# ---------------------------------------------------------------------------
def test_queued_deadline_expiry_and_queue_full():
    conf = _conf()
    conf.serve.queue_capacity = 2
    srv = _server(conf=conf, lanes=1)
    long = srv.submit("fib", [14])
    srv.step()                       # the only lane is now busy
    doomed = srv.submit("fib", [5], deadline_s=0.0)
    srv.step()                       # expires unadmitted
    with pytest.raises(DeadlineExceeded):
        doomed.result(0)
    assert srv.counters["expired"] == 1
    srv.submit("fib", [5])
    srv.submit("fib", [5])
    with pytest.raises(QueueSaturated):
        srv.submit("fib", [5])       # bounded queue: reject, not drop
    srv.run_until_idle()
    assert long.result(0)[0] == _fib(14)
    assert srv.counters["completed"] == 3


def test_in_flight_deadline_kill_and_step_budget():
    conf = _conf()
    conf.serve.max_steps_per_request = 512
    srv = _server(conf=conf, lanes=4)
    doomed = srv.submit("fib", [18], deadline_s=0.0005)
    big = srv.submit("fib", [20])     # far beyond 512 steps
    ok = srv.submit("fib", [6])
    srv.run_until_idle()
    assert ok.result(0)[0] == _fib(6)
    with pytest.raises(DeadlineExceeded):
        doomed.result(0)
    assert srv.counters["killed"] >= 2
    assert isinstance(big.error, WasmError)
    assert big.error.code == ErrCode.CostLimitExceeded
    # killed lanes are recyclable
    again = srv.submit("fib", [7])
    srv.run_until_idle()
    assert again.result(0)[0] == _fib(7)


def test_withdraw_a_queued_request():
    srv = _server(lanes=1)
    f1 = srv.submit("fib", [10])
    srv.step()
    f2 = srv.submit("fib", [4])
    assert srv.withdraw(f2.request_id)
    assert not srv.withdraw(f1.request_id)   # already admitted
    srv.run_until_idle()
    assert f1.result(0)[0] == _fib(10) and not f2.done
    assert srv.counters["rejected"] == 1


# ---------------------------------------------------------------------------
# many modules, VM.serve, the serving thread, a failed launch
# ---------------------------------------------------------------------------
CONFIG5 = (("fib", build_fib), ("fac", build_fac),
           ("loop_sum", build_loop_sum), ("coremark", build_coremark_kernel))


def _multi_server(mods, lanes, **kw):
    conf = _conf()
    modules = [(name, *inst_of("port", build(), conf))
               for name, build in mods]
    return BatchServer(engine=MultiModuleBatchEngine(
        modules, conf=conf, lanes=lanes, device="cpu"), **kw)


def test_server_over_two_modules():
    srv = _multi_server(CONFIG5[:2], lanes=5)
    reqs = [("fib:fib", n) for n in (3, 9, 12, 1)] + \
        [("fac:fac", n) for n in (1, 5, 20)] + [("fib", 7)]
    futs = [srv.submit(f, [n], tenant=f.split(":")[0]) for f, n in reqs]
    srv.run_until_idle()
    for (f, n), fut in zip(reqs, futs):
        want = serve_model("fib:fib" if f == "fib" else f, [n])[0]
        assert fut.result(0)[0] == int(want), (f, n)
    assert srv.counters["completed"] == len(reqs)
    assert srv.counters["recycled_lanes"] == len(reqs) - 5
    # lanes of both modules shared a warp
    assert {t for _, t, _ in srv.admissions} == {"fib", "fac"}


def test_server_over_config5_modules():
    """A seeded config-5 load at a small size over four modules, weights
    and a quota: every future equals its model."""
    srv = _multi_server(CONFIG5, lanes=12,
                        weights={"t0": 1, "t1": 1, "t2": 2, "t3": 4},
                        quotas={"t1": 3})
    load = serve_load(40, 20261018, ranges={
        "fib": (1, 12), "fac": (1, 20), "loop_sum": (1, 300),
        "coremark": (1, 40)})
    futs = [srv.submit(f, [n], tenant=t) for t, f, n in load]
    srv.run_until_idle()
    for (t, f, n), fut in zip(load, futs):
        want = serve_model(f, [n])[0]
        got = fut.result(0)[0]
        assert (got if f == "fac:fac" else int(u32_cells(got))) == \
            int(want), (f, n)
    assert srv.counters["completed"] == 40
    assert srv.counters["recycled_lanes"] == 40 - 12


def test_vm_serve_with_gas():
    """VM.serve: the instantiated module's server; a Statistics cost
    limit is each request's fuel, as in execute_batch."""
    vm = VM(_conf())
    vm.load_wasm(build_fib()).validate().instantiate()
    srv = vm.serve(lanes=3, device="cpu")
    futs = [srv.submit("fib", [n]) for n in (4, 10, 15, 2)]
    srv.run_until_idle()
    assert [f.result(0)[0] for f in futs] == [_fib(n) for n in (4, 10, 15, 2)]
    vm2 = VM(_conf())
    vm2.statistics().cost_measuring = True
    vm2.statistics().cost_limit = 300
    vm2.load_wasm(build_fib()).validate().instantiate()
    srv = vm2.serve(lanes=2, device="cpu")
    short, long = srv.submit("fib", [5]), srv.submit("fib", [15])
    srv.run_until_idle()
    assert short.result(0)[0] == 5
    assert long.error.code == ErrCode.CostLimitExceeded
    assert srv.counters["trapped"] == 1


def test_background_thread_and_shutdown():
    srv = _server(lanes=2).start()
    futs = [srv.submit("fib", [n]) for n in (6, 9, 11)]
    assert all(f.wait(60) for f in futs)
    assert [f.result(0)[0] for f in futs] == [8, 34, 89]
    srv.shutdown(drain=True)
    with pytest.raises(WasmError):
        srv.submit("fib", [3])
    # without draining, queued work is rejected
    srv = _server(lanes=1)
    f1 = srv.submit("fib", [5])
    srv.shutdown(drain=False)
    assert f1.done and f1.error is not None


def test_launch_failure_fails_the_server():
    """A launch that keeps failing fails the server once its retries are
    spent: each of the first `max_retries` failures is recovered (the
    in-flight request goes back to the queue), the next fails the server
    with EngineFailure, which every in-flight and queued future gets
    (tests/test_torch_serve_recovery.py holds recovery against the JAX
    server)."""
    conf = _conf()
    conf.serve.backoff_base_s = 0.0
    conf.serve.max_retries = 2
    srv = _server(conf, lanes=2)
    running = srv.submit("fib", [12])
    srv.step()
    queued = [srv.submit("fib", [3]) for _ in range(3)]

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    srv.engine.run_slice = broken
    for _ in range(2):
        assert srv.step()   # recovered; the work waits in the queue
        assert srv.failed is None and not running.done
    with pytest.raises(EngineFailure):
        srv.step()
    assert isinstance(srv.failed, EngineFailure)
    assert [f.fault_class for f in srv.failures] == ["launch"] * 3
    for f in [running] + queued:
        assert isinstance(f.error, EngineFailure)
    assert not srv.step()
    with pytest.raises(EngineFailure):
        srv.submit("fib", [3])
    c = srv.counters
    assert c["submitted"] == c["completed"] + c["killed"] + c["rejected"]
