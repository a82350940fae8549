"""The server's checkpoints and recovery on the port, against the JAX server.

The counterparts of tests/test_serve.py:256-330: a failed launch
restored from a checkpoint with requests in flight (also with lane
compaction on), a failure with no lineage that re-queues every in-flight
request, the terminal failure past `max_retries`, a cross-process resume
that adopts the in-flight requests under fresh futures, and (the port
alone) a kernel that does not build failing the server at once (a failed
serve round and stdout across a restore are in
test_torch_serve_recovery_stdout.py).  Each script runs through the
port's server (device="cpu", the plain versions) and the JAX server on
the same module, requests and faults: every future's result equal to the
JAX server's and to Python's fib, and the fault classes, retries,
injector counts and lineage step counts equal.
"""

import pytest

from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import EngineFailure as RefEngineFailure
from wasmedge_tpu.serve import BatchServer as RefServer
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import EngineFailure
from wasmedge_tpu_torch.models import build_fib
from wasmedge_tpu_torch.models.fixtures import compact_conf, fib_model
from wasmedge_tpu_torch.serve import BatchServer
from tests.test_torch_multitenant import inst_of
from tests.test_torch_supervisor import PKGS, injector

pytestmark = [pytest.mark.serve, pytest.mark.faults]


def _fib(n):
    return int(fib_model([n])[0])


def _conf(pkg, compact=False, **serve):
    conf = (Configure if pkg == "port" else RefConfigure)()
    conf.batch.steps_per_launch = 256
    conf.batch.value_stack_depth = 128
    conf.batch.call_stack_depth = 64
    conf.serve.backoff_base_s = 0.0   # no sleeping in tests
    if compact:
        compact_conf(conf, steps_per_launch=48)
    for k, v in serve.items():
        setattr(conf.serve, k, v)
    if pkg == "ref":
        conf.batch.fuse_superinstructions = False
        conf.batch.tierup = False
    return conf


def _server(pkg, conf, data=None, lanes=4, imports=(), **kw):
    inst, store = inst_of(pkg, data or build_fib(), conf, imports)
    if pkg == "port":
        return BatchServer(inst, store=store, conf=conf, lanes=lanes,
                           device="cpu", **kw)
    return RefServer(inst, store=store, conf=conf, lanes=lanes, **kw)


def _drive(tmp_path, ns, specs=(), compact=False, **serve):
    """The same request script through both servers; returns {pkg:
    (server, futures, injector)} after checking them against each other
    and Python's fib."""
    out = {}
    for pkg in PKGS:
        inj = injector(pkg, specs)
        d = tmp_path / pkg
        srv = _server(pkg, _conf(pkg, compact, **serve), faults=inj,
                      checkpoint_dir=str(d))
        futs = [srv.submit("fib", [n]) for n in ns]
        srv.run_until_idle()
        out[pkg] = (srv, futs, inj)
    (ps, pf, pi), (rs, rf, ri) = out["port"], out["ref"]
    got = [f.result(0)[0] for f in pf]
    assert got == [f.result(0)[0] for f in rf] == [_fib(n) for n in ns]
    assert [f.fault_class for f in ps.failures] == \
        [f.fault_class for f in rs.failures]
    assert ps.retries == rs.retries
    assert pi.counts == ri.counts and pi.log == ri.log
    assert [m.steps for m in ps._lineage.members] == \
        [m.steps for m in rs._lineage.members]
    for k in ("completed", "killed", "rejected", "rounds"):
        assert ps.counters[k] == rs.counters[k], k
    return out


# ---------------------------------------------------------------------------
# crash restore, requeue, terminal failure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compact", [False, True],
                         ids=["uncompacted", "compacted"])
def test_crash_restore_from_checkpoint_in_flight(tmp_path, compact):
    ns = [6, 12, 14, 4, 9, 13, 5, 11]
    out = _drive(tmp_path, ns, [dict(point="launch", at=4)],
                 compact=compact, checkpoint_every_rounds=2)
    srv, _, inj = out["port"]
    assert inj.fired == 1 and srv.retries == 1
    assert [f.fault_class for f in srv.failures] == ["launch"]
    assert inj.counts["checkpoint_load"] == 1   # restored from a member
    assert srv.failed is None
    if compact:
        assert srv._compactor.stats["fires"] == \
            out["ref"][0]._compactor.stats["fires"]


def test_crash_requeue_without_checkpoint(tmp_path):
    # no lineage: recovery re-queues every in-flight request at the head
    # of the queue and replays them from the start
    ns = [7, 13, 5, 10, 14, 6]
    out = _drive(tmp_path, ns, [dict(point="launch", at=3)])
    srv, _, inj = out["port"]
    assert inj.fired == 1 and srv.retries == 1
    assert "checkpoint_load" not in inj.counts


def test_terminal_failure_rejects_futures(tmp_path):
    for pkg, err in (("port", EngineFailure), ("ref", RefEngineFailure)):
        inj = injector(pkg, [dict(point="launch", at=0, times=99)])
        srv = _server(pkg, _conf(pkg, max_retries=1), faults=inj)
        futs = [srv.submit("fib", [12]) for _ in range(3)]
        with pytest.raises(err):
            srv.run_until_idle()
        for f in futs:
            assert isinstance(f.error, err)
        with pytest.raises(err):
            srv.submit("fib", [5])
        assert [f.fault_class for f in srv.failures] == ["launch"] * 2
        assert inj.counts == {"launch": 2}
        c = srv.counters
        assert c["killed"] == 3 and c["completed"] == 0


def test_build_error_fails_the_server_at_once():
    """A kernel that does not build is no launch fault: the port's server
    fails at once with it, retries left or not, and records it (the JAX
    server has no such error)."""
    from wasmedge_tpu_torch.batch.interp import KernelBuildError

    inj = injector("port", [dict(
        point="launch", at=1, exc=lambda ctx: KernelBuildError("nvcc"))])
    srv = _server("port", _conf("port", max_retries=3), faults=inj)
    futs = [srv.submit("fib", [12]) for _ in range(3)]
    with pytest.raises(KernelBuildError):
        srv.run_until_idle()
    assert isinstance(srv.failed, KernelBuildError)
    for f in futs:
        assert isinstance(f.error, KernelBuildError)
    assert [f.fault_class for f in srv.failures] == ["launch"]
    assert srv.retries == 1 and inj.counts == {"launch": 2}


# ---------------------------------------------------------------------------
# cross-process resume
# ---------------------------------------------------------------------------
def test_cross_process_resume_adopts_in_flight(tmp_path):
    ns = [9, 14, 6, 13, 7, 11]
    got = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        srv = _server(pkg, _conf(pkg), checkpoint_dir=d)
        for n in ns:
            srv.submit("fib", [n])
        for _ in range(2):
            srv.step()
        assert srv.checkpoint() is not None
        bound = {lane: req.args[0] for lane, req in srv._bindings.items()}
        assert bound   # something was in flight at the snapshot
        del srv   # the process dies
        srv2 = _server(pkg, _conf(pkg), checkpoint_dir=d, resume=True)
        assert len(srv2.adopted) == len(bound)
        srv2.run_until_idle()
        for fut in srv2.adopted.values():
            assert fut.done and fut.error is None
        # the adopted requests finish with the answers for the arguments
        # the journal recorded
        res = sorted(f.result(0)[0] for f in srv2.adopted.values())
        assert res == sorted(_fib(n) for n in bound.values())
        # fresh submissions take ids after the adopted requests'
        fresh = srv2.submit("fib", [4])
        assert fresh.request_id > max(srv2.adopted)
        srv2.run_until_idle()
        assert fresh.result(0)[0] == _fib(4)
        got[pkg] = (sorted(bound.items()), res, srv2.total)
    assert got["port"] == got["ref"]


def test_vm_serve_checkpoint_and_resume(tmp_path):
    """VM.serve(checkpoint_dir=, resume=) on the port: a server's
    snapshot adopted by the next server of the same VM."""
    from wasmedge_tpu_torch.vm.vm import VM

    vm = VM(_conf("port"))
    vm.load_wasm(build_fib()).validate().instantiate()
    srv = vm.serve(lanes=4, device="cpu", checkpoint_dir=str(tmp_path))
    futs = [srv.submit("fib", [n]) for n in (14, 13, 12, 11, 5)]
    srv.step()
    path = srv.checkpoint()
    assert path.endswith(f"serve-{srv.total:012d}.npz")
    srv2 = vm.serve(lanes=4, device="cpu", checkpoint_dir=str(tmp_path),
                    resume=True)
    assert sorted(srv2.adopted) == sorted(f.request_id for f in futs[:4])
    srv2.run_until_idle()
    assert sorted(f.result(0)[0] for f in srv2.adopted.values()) == \
        sorted(_fib(n) for n in (14, 13, 12, 11))
    assert srv2.stats is vm.statistics()
