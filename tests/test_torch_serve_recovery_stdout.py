"""Stdout across a restore, and a failed serve round, against the JAX
package (the counterparts of tests/test_serve.py:405-420).

A supervised tier-0 echo batch prints each record exactly once when it is
restored to a checkpoint (the journaled cursor rewinds, the written mark
stays) and to its start (every save fails), as the JAX supervisor does.
A server prints every request's records at least once across a crash
restore.  A failed serve round (tier-1 fd_write) is recovered like a
failed launch.  ROADMAP C14: the JAX package's checkpoint load refuses a
snapshot that holds a stopped lane whose entry function has returned
(its sp sits below its operand base), so its server restores such a
serving state from scratch; the port's load holds that order only on
lanes that run.
"""

import os

import numpy as np
import pytest

from wasmedge_tpu.batch import checkpoint as ref_checkpoint
from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.batch.supervisor import BatchSupervisor as RefSupervisor
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.host.wasi import WasiModule as RefWasiModule
from wasmedge_tpu_torch.batch import checkpoint
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.supervisor import BatchSupervisor
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.host.wasi import WasiModule
from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE, build_echo
from tests.test_torch_multitenant import inst_of
from tests.test_torch_serve_recovery import _conf, _server
from tests.test_torch_supervisor import PKGS, injector

pytestmark = [pytest.mark.serve, pytest.mark.faults]


def test_serve_fault_recovers(tmp_path):
    """A failed serve round (echo's tier-1 fd_write, tier 0 off) is
    recovered like a failed launch."""
    out = {}
    for pkg in PKGS:
        conf = _conf(pkg, checkpoint_every_rounds=1)
        conf.batch.tier0_hostcalls = False
        conf.batch.steps_per_launch = 40
        wasi = (WasiModule if pkg == "port" else RefWasiModule)()
        wasi.init_wasi(dirs=[], prog_name="echo")
        wasi.env.fds[1].os_fd = os.open(os.devnull, os.O_WRONLY)
        inj = injector(pkg, [dict(point="serve", at=1)])
        srv = _server(pkg, conf, build_echo(), imports=[wasi], faults=inj,
                      checkpoint_dir=str(tmp_path / pkg))
        futs = [srv.submit("echo", [k % 3 + 1]) for k in range(6)]
        srv.run_until_idle()
        os.close(wasi.env.fds[1].os_fd)
        out[pkg] = ([f.result(0)[0] for f in futs],
                    [f.fault_class for f in srv.failures], inj.counts)
    assert out["port"] == out["ref"]
    assert out["port"][1] == ["serve"]


# ---------------------------------------------------------------------------
# stdout across a restore
# ---------------------------------------------------------------------------
def _echo_wasi(pkg, path):
    wasi = (WasiModule if pkg == "port" else RefWasiModule)()
    wasi.init_wasi(dirs=[], prog_name="echo")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    wasi.env.fds[1].os_fd = fd
    return wasi, fd


def _echo_supervised(pkg, tmp_path, name, specs=()):
    """tests/test_serve.py's `_run_echo_supervised`: tier-0 echo(5) x 4
    under the supervisor, 40 steps a launch, a checkpoint every 40."""
    conf = (Configure if pkg == "port" else RefConfigure)()
    conf.batch.steps_per_launch = 40
    conf.batch.value_stack_depth = 64
    conf.batch.call_stack_depth = 16
    conf.supervisor.checkpoint_every_steps = 40
    conf.supervisor.backoff_base_s = 0.0
    if pkg == "ref":
        conf.supervisor.use_kernel_tier = False
        conf.batch.fuse_superinstructions = False
        conf.batch.tierup = False
    path = tmp_path / f"{name}-{pkg}.out"
    wasi, fd = _echo_wasi(pkg, path)
    try:
        inst, store = inst_of(pkg, build_echo(), conf, [wasi])
        if pkg == "port":
            eng = BatchEngine(inst, store=store, conf=conf, lanes=4,
                              device="cpu")
        else:
            eng = RefEngine(inst, store=store, conf=conf, lanes=4)
        inj = injector(pkg, specs)
        cls = BatchSupervisor if pkg == "port" else RefSupervisor
        sup = cls(eng, conf=conf, faults=inj,
                  checkpoint_dir=str(tmp_path / f"{name}-{pkg}.ckpt"))
        res = sup.run("echo", [np.full(4, 5, np.int64)],
                      max_steps=1_000_000)
        assert res.completed.all()
    finally:
        os.close(fd)
    return path.read_bytes(), [f.fault_class for f in sup.failures]


@pytest.mark.parametrize("restore", ["checkpoint", "initial"])
def test_supervised_stdout_exactly_once_across_restore(tmp_path, restore):
    """A restored tier-0 batch prints each record once: to a checkpoint
    (the journaled cursor rewinds, the written mark stays) and to the
    initial state (every save fails)."""
    specs = [dict(point="launch", at=2)] if restore == "checkpoint" else [
        dict(point="checkpoint_save", at=0, times=99),
        dict(point="launch", at=1)]
    clean = _echo_supervised("port", tmp_path, "clean")[0]
    assert clean.count(ECHO_MESSAGE) == 4 * 5 * 2
    for pkg in PKGS:
        out, classes = _echo_supervised(pkg, tmp_path, restore, specs)
        assert "launch" in classes
        assert out == clean, pkg


def test_server_stdout_at_least_once_across_restore(tmp_path):
    """A server restored to a checkpoint prints every request's records at
    least once (a replay may print again what the failed attempt
    printed); results equal to the JAX server's.  The JAX server refuses
    its checkpoint (C14: a stopped echo lane's sp is below its operand
    base) and re-runs every request in flight from scratch; the port's
    restores the checkpoint."""
    iters = [2, 5, 3, 4, 1, 5]
    out = {}
    for pkg in PKGS:
        path = tmp_path / f"{pkg}.out"
        wasi, fd = _echo_wasi(pkg, path)
        conf = _conf(pkg, checkpoint_every_rounds=1)
        conf.batch.steps_per_launch = 40
        inj = injector(pkg, [dict(point="launch", at=3)])
        try:
            srv = _server(pkg, conf, build_echo(), imports=[wasi],
                          faults=inj, checkpoint_dir=str(tmp_path / pkg))
            futs = [srv.submit("echo", [n]) for n in iters]
            srv.run_until_idle()
        finally:
            os.close(fd)
        out[pkg] = (path.read_bytes(), [f.result(0)[0] for f in futs],
                    srv.failures, inj.counts)
    (data, got, fails, counts), ref = out["port"], out["ref"]
    assert got == ref[1]
    assert data.count(ECHO_MESSAGE) >= 2 * sum(iters)
    assert ref[0].count(ECHO_MESSAGE) >= 2 * sum(iters)
    assert [f.fault_class for f in fails] == ["launch"]
    assert counts["checkpoint_load"] == 1   # restored from the member
    assert [f.fault_class for f in ref[2]] == ["launch", "checkpoint"]
    assert "stack pointers" in ref[2][1].error


def test_stopped_lane_checkpoint_loads(tmp_path):
    """C14 pinned: echo(1, 30, 30, 30) saved after lane 0 returned; the
    JAX package's load refuses its own file, the port's loads its own and
    finishes equal to the uninterrupted run."""
    args = [np.array([1, 30, 30, 30], np.int64)]
    res = {}
    for pkg in PKGS:
        conf = (Configure if pkg == "port" else RefConfigure)()
        conf.batch.steps_per_launch = 10
        if pkg == "ref":
            conf.batch.fuse_superinstructions = False
            conf.batch.tierup = False
        wasi, fd = _echo_wasi(pkg, os.devnull)
        try:
            inst, store = inst_of(pkg, build_echo(), conf, [wasi])
            if pkg == "port":
                eng = BatchEngine(inst, store=store, conf=conf, lanes=4,
                                  device="cpu")
            else:
                eng = RefEngine(inst, store=store, conf=conf, lanes=4)
            st, total = eng.initial_state(eng.export_func_idx("echo"),
                                          args), 0
            while int(np.asarray(st.trap)[0]) == 0:
                st, total = eng.run_from_state(st, total, total + 10)
            path = tmp_path / f"{pkg}.npz"
            if pkg == "port":
                assert int(st.trap[0]) == -1 and (st.trap[1:] == 0).all()
                checkpoint.save(path, eng, st, total)
                st2, t2 = checkpoint.load(path, eng)
                st2, t2 = eng.run_from_state(st2, t2, 100_000)
                res[pkg] = (st2.trap.numpy(), st2.retired.numpy(), t2)
            else:
                assert int(np.asarray(st.trap)[0]) == -1
                ref_checkpoint.save(path, eng, st, total)
                with pytest.raises(ValueError, match="stack pointers"):
                    ref_checkpoint.load(path, eng)
                st, total = eng.run_from_state(st, total, 100_000)
                res[pkg] = (np.asarray(st.trap), np.asarray(st.retired),
                            total)
        finally:
            os.close(fd)
    for a, b in zip(res["port"], res["ref"]):
        assert np.array_equal(a, b)
