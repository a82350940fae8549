"""Lane compaction in the serving layer, against the JAX server.

The server owns the boundary pass (`BatchServer._compact_round`: after
admission, while lanes are bound, narrowing off) and remaps its lane ->
request bindings, kills, free lanes and recycling history through each
permutation; its engine never compacts on its own.  Checks: the JAX
package's `test_serving_bindings_follow_lanes_through_permutation`
(tests/test_compact.py:421) on the port, and one seeded script over
config 5's four modules (a `MultiModuleBatchEngine`, weights and a
quota) through the JAX server and the port's, both with compaction on:
every future's result, the admission order, the counters and the
compactor's fires and moved lanes are equal.
"""

import numpy as np

from wasmedge_tpu.batch.multitenant import (
    MultiModuleBatchEngine as RefMultiModule)
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.serve import BatchServer as RefServer
from wasmedge_tpu_torch.batch.multitenant import MultiModuleBatchEngine
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.models import build_fib
from wasmedge_tpu_torch.models.fixtures import (
    compact_conf, fib_model, serve_load, serve_model, u32_cells)
from wasmedge_tpu_torch.serve import BatchServer
from tests.test_torch_multitenant import inst_of
from tests.test_torch_serve import CONFIG5


def _conf(pkg, lanes):
    conf = (Configure if pkg == "port" else RefConfigure)()
    conf.batch.lanes = lanes
    conf.batch.steps_per_launch = 48
    conf.batch.value_stack_depth = 128
    conf.batch.call_stack_depth = 64
    compact_conf(conf)
    if pkg == "ref":
        conf.obs.enabled = True   # the admission events
        conf.batch.fuse_superinstructions = False
        conf.batch.tierup = False
    return conf


def test_serving_bindings_follow_lanes_through_permutation():
    conf = _conf("port", 8)
    inst, store = inst_of("port", build_fib(), conf)
    srv = BatchServer(inst, store=store, conf=conf, lanes=8, device="cpu")
    ns = [11, 4, 9, 6, 12, 5, 10, 7, 8, 13, 4, 9, 12, 6]
    futs = [(n, srv.submit("fib", [n])) for n in ns]
    srv.run_until_idle()
    assert srv._compactor.stats["fires"] >= 1
    assert srv._compactor.narrow is False
    assert srv.engine.compactor is None   # the engine's pass stays off
    assert srv.engine._compact_external
    for n, f in futs:
        assert f.result(5)[0] == int(fib_model([n])[0])
    c = srv.counters
    assert c["completed"] == len(ns) and c["recycled_lanes"] > 0
    srv.shutdown()


def _drive(srv, load, seed):
    """A seeded submit / step schedule of `load`; returns the futures."""
    rng = np.random.RandomState(seed)
    futs, k = [], 0
    while k < len(load):
        for _ in range(int(rng.randint(1, 9))):
            if k < len(load):
                t, f, n = load[k]
                futs.append(srv.submit(f, [n], tenant=t))
                k += 1
        srv.step()
    srv.run_until_idle()
    return futs


def test_compacted_serving_equals_jax_server():
    lanes = 12
    load = serve_load(48, 20261018, ranges={
        "fib": (1, 12), "fac": (1, 20), "loop_sum": (1, 300),
        "coremark": (1, 40)})
    kw = dict(weights={"t0": 1, "t1": 1, "t2": 2, "t3": 4},
              quotas={"t1": 3})
    servers = {}
    for pkg in ("port", "ref"):
        conf = _conf(pkg, lanes)
        modules = [(name, *inst_of(pkg, build(), conf))
                   for name, build in CONFIG5]
        if pkg == "port":
            eng = MultiModuleBatchEngine(modules, conf=conf, lanes=lanes,
                                         device="cpu")
            servers[pkg] = BatchServer(engine=eng, **kw)
        else:
            servers[pkg] = RefServer(
                engine=RefMultiModule(modules, conf=conf, lanes=lanes), **kw)
    port, ref = servers["port"], servers["ref"]
    pf = _drive(port, load, 5)
    rf = _drive(ref, load, 5)
    for (t, f, n), a, b in zip(load, pf, rf):
        assert a.result(0) == b.result(0), (f, n)
        got = a.result(0)[0]
        assert (got if f == "fac:fac" else int(u32_cells(got))) == \
            int(serve_model(f, [n])[0]), (f, n)
    first = rf[0].request_id
    ref_admits = [(e["args"]["id"] - first, e["args"]["tenant"],
                   e["args"]["lane"])
                  for e in ref.obs.events if e["name"] == "admit"]
    p0 = pf[0].request_id
    assert [(rid - p0, t, lane) for rid, t, lane in port.admissions] \
        == ref_admits
    assert port.counters == {k: ref.counters[k] for k in port.counters}
    assert port.counters["completed"] == len(load)
    pc, rc = port._compactor.stats, ref._compactor.stats
    assert pc["fires"] >= 1
    for k in ("fires", "noop_fires", "moved_lanes", "rounds"):
        assert pc[k] == rc[k], k
    assert port.compact_s > 0
