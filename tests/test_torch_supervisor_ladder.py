"""The supervisor's ladder, quarantine, multi-tenant runs and resume on the
port, held against the JAX package (tests/test_supervisor.py).

The helpers and the comparison are test_torch_supervisor.py's: results,
`trap`, `retired`, fault classes with their lanes, injector counts and
lineage step counts equal to the JAX supervisor's on the same module,
arguments and faults.  Cases: a poison lane sent to the scalar rung, and
one terminated when the module has host imports; a runaway lane
(`build_selective_runaway`, `lane_step_cap`); demotion to `cuda_unfused`
(finishing there, from the start and from the lineage) and on to
`scalar`, and `EngineFailure` when every rung is used up; a multi-tenant
run (where the JAX load refuses a member, ROADMAP C14); a cross-process
`resume=True`; `scalar_rerun`'s trap codes and its gas meter (C13).
The port's departures from the JAX ladder (ROADMAP C15) are pinned here
too: under an engine on the card there is no rung on the host, so the
ladder ends at `cuda_unfused` and a poisoned lane is terminated; a kernel
that does not build is raised, not retried; and the engine is given back
as it came.

The demotion cases run the JAX side with superinstruction fusion on, so
that its ladder has the `simt_unfused` rung the port's `cuda_unfused`
stands for; every launch of its fused rung faults there, so no step of
it runs and its step counting (a superinstruction one step) does not
show.  Demoting after checkpoints would show it, so that case is held
against the port's own unsupervised run.
"""

import numpy as np
import pytest

from wasmedge_tpu.batch.image import TRAP_DONE as REF_TRAP_DONE
from wasmedge_tpu.batch.multitenant import (
    MultiTenantBatchEngine as RefMultiTenant, Tenant as RefTenant)
from wasmedge_tpu.batch.supervisor import scalar_rerun as ref_scalar_rerun
from wasmedge_tpu_torch.batch import supervisor as port_supervisor
from wasmedge_tpu_torch.batch.image import TRAP_DONE
from wasmedge_tpu_torch.batch.interp import KernelBuildError
from wasmedge_tpu_torch.batch.multitenant import (
    MultiTenantBatchEngine, Tenant)
from wasmedge_tpu_torch.batch.supervisor import scalar_rerun
from wasmedge_tpu_torch.common.errors import EngineFailure, ErrCode
from wasmedge_tpu_torch.models import build_fib, build_loop_sum
from wasmedge_tpu_torch.models.fixtures import compact_conf, fib_model
from wasmedge_tpu_torch.testing.faults import build_selective_runaway
from wasmedge_tpu_torch.utils.builder import ModuleBuilder
from tests.test_torch_multitenant import inst_of
from tests.test_torch_supervisor import (
    LANES, PKGS, assert_same_result, assert_same_run, conf_of, echo_pair,
    echo_run, engine_of, fib_args, fib_cells, incidents, injector, pair,
    supervise)

pytestmark = pytest.mark.faults


# ---------------------------------------------------------------------------
# poison lanes, runaways
# ---------------------------------------------------------------------------
def test_poison_lane_demoted_to_scalar(tmp_path):
    args = fib_args()
    # the same lane-attributed fault fires poison_lane_retries times: lane
    # 3 goes to the scalar engine (fib has no host imports)
    port, _ = pair(tmp_path, build_fib(), "fib", args,
                   [dict(point="launch", at=2, times=2, lanes=(3,))],
                   poison_lane_retries=2)
    assert port.inj.fired == 2
    assert port.res.completed.all()   # lane 3 too, through the scalar rung
    assert np.array_equal(port.res.results[0], fib_cells(args))
    poisons = [f for f in port.sup.failures if f.fault_class == "poison_lane"]
    assert len(poisons) == 1 and poisons[0].lanes == (3,)
    assert poisons[0].tier == "scalar"


def test_poison_lane_terminated_with_host_imports(tmp_path):
    # a module with host imports cannot go to the scalar engine (its WASI
    # side effects would apply twice): the lane is terminated
    lanes = 8
    port, _ = echo_pair(tmp_path, lanes, 2,
                        [dict(point="launch", at=1, times=2, lanes=(2,))],
                        poison_lane_retries=2)
    assert port.res.trap[2] == int(ErrCode.Terminated)
    done = np.ones(lanes, bool)
    done[2] = False
    assert port.res.completed[done].all()
    assert incidents(port).count(("poison_lane", (2,))) == 1


def test_runaway_lane_terminated(tmp_path):
    args = np.arange(LANES).astype(np.int64)
    args[5] = -1  # lane 5 loops forever
    port, _ = pair(tmp_path, build_selective_runaway(), "work", [args],
                   max_steps=10_000_000, lane_step_cap=5_000)
    assert port.res.trap[5] == int(ErrCode.Terminated)
    others = np.ones(LANES, bool)
    others[5] = False
    assert port.res.completed[others].all()
    want = np.array([n * (n - 1) // 2 for n in range(LANES)])
    assert np.array_equal(port.res.results[0][others], want[others])
    assert incidents(port) == [("runaway", (5,))]
    assert port.res.steps < 10_000_000


# ---------------------------------------------------------------------------
# the ladder: cuda -> cuda_unfused -> scalar
# ---------------------------------------------------------------------------
def test_demotes_to_unfused_and_finishes(tmp_path):
    args = fib_args(9)
    clean, _ = pair(tmp_path / "clean", build_fib(), "fib", args)
    port, _ = pair(tmp_path / "f", build_fib(), "fib", args,
                   [dict(point="launch", at=0, times=3)], fused_ref=True,
                   max_retries=2)
    assert port.sup.tier == "cuda_unfused"
    assert port.sup.engine.fusion == "none"
    assert [c for c, _ in incidents(port)] == ["launch"] * 3 + ["demote"]
    assert_same_result(port.res, clean.res)


def test_demoted_rung_adopts_the_lineage(tmp_path):
    """A failure run of max_retries + 1 after the second checkpoint: the
    unfused rung adopts the newest member and finishes equal to the
    unsupervised run (both on the port)."""
    args = fib_args(13)
    eng = engine_of("port", build_fib(), conf_of("port"))
    want = eng.run("fib", args, max_steps=500_000)
    eng = engine_of("port", build_fib(), conf_of("port", max_retries=2))
    run = supervise("port", eng, "fib", args,
                    [dict(point="launch", at=5, times=3)],
                    ckdir=tmp_path)
    assert run.sup.tier == "cuda_unfused"
    assert [c for c, _ in incidents(run)] == ["launch"] * 3 + ["demote"]
    # a restore after each of the three faults, and the adoption
    assert run.inj.counts["checkpoint_load"] == 4
    assert_same_result(run.res, want)


def test_ladder_demotes_to_scalar_engine(tmp_path):
    args = fib_args(9)
    port, _ = pair(tmp_path, build_fib(), "fib", args,
                   [dict(point="launch", at=0, times=1000)], fused_ref=True,
                   max_retries=2)
    assert port.sup.tier == "scalar"
    assert port.res.completed.all()
    assert np.array_equal(port.res.results[0], fib_cells(args))
    classes = [c for c, _ in incidents(port)]
    assert classes.count("demote") == 2
    assert classes.count("launch") == 6   # max_retries + 1 per cuda rung


def test_ladder_exhaustion_raises_engine_failure(tmp_path):
    # echo has host imports: no scalar rung; a permanent launch failure
    # surfaces as EngineFailure carrying the FailureRecords
    errs = {}
    for pkg in PKGS:
        with pytest.raises(Exception) as ei:
            echo_run(pkg, tmp_path, 8, 1,
                     [dict(point="launch", at=0, times=1000)],
                     fused_ref=True, max_retries=1)
        errs[pkg] = ei.value
    assert isinstance(errs["port"], EngineFailure)
    assert type(errs["ref"]).__name__ == "EngineFailure"
    port = [f.fault_class for f in errs["port"].failures]
    assert port == [f.fault_class for f in errs["ref"].failures]
    assert port == ["launch", "launch", "demote"] * 2


# ---------------------------------------------------------------------------
# the card: no rung on the host (ROADMAP C15), build errors, the engine
# given back
# ---------------------------------------------------------------------------
def test_on_card_follows_the_engine_device():
    import types

    import torch

    assert port_supervisor.on_card(
        types.SimpleNamespace(device=torch.device("cuda")))
    assert port_supervisor.on_card(types.SimpleNamespace(device="cuda:0"))
    assert not port_supervisor.on_card(
        engine_of("port", build_fib(), conf_of("port")))


def test_card_ladder_ends_at_cuda_unfused(tmp_path, monkeypatch):
    """ROADMAP C15: under an engine on the card, a launch that always
    fails exhausts `cuda` and `cuda_unfused` and raises EngineFailure,
    where the JAX ladder goes on to its scalar rung and answers from the
    host.  The engine runs on the CPU here, reported as on the card."""
    monkeypatch.setattr(port_supervisor, "on_card", lambda eng: True)
    args = fib_args(9)
    spec = [dict(point="launch", at=0, times=1000)]
    eng = engine_of("port", build_fib(), conf_of("port", max_retries=2))
    with pytest.raises(EngineFailure) as ei:
        supervise("port", eng, "fib", args, spec, ckdir=tmp_path / "port")
    classes = [f.fault_class for f in ei.value.failures]
    assert classes == (["launch"] * 3 + ["demote"]) * 2
    assert [f.tier for f in ei.value.failures if f.fault_class ==
            "demote"] == ["cuda", "cuda_unfused"]
    ref = supervise("ref", engine_of("ref", build_fib(),
                                     conf_of("ref", True, max_retries=2)),
                    "fib", args, spec, ckdir=tmp_path / "ref")
    assert ref.res.completed.all()   # answered by its scalar rung
    assert np.array_equal(ref.res.results[0], fib_cells(args))
    assert [c for c, _ in incidents(ref)] == classes


def test_card_poison_lane_terminated(tmp_path, monkeypatch):
    """ROADMAP C15: under an engine on the card a poisoned lane of a
    module with no host imports is terminated (ErrCode.Terminated), where
    the JAX supervisor re-runs it on the host; the other lanes and the
    incidents are the same."""
    monkeypatch.setattr(port_supervisor, "on_card", lambda eng: True)
    args = fib_args()
    spec = [dict(point="launch", at=2, times=2, lanes=(3,))]
    runs = {}
    for pkg in PKGS:
        eng = engine_of(pkg, build_fib(), conf_of(pkg, poison_lane_retries=2))
        runs[pkg] = supervise(pkg, eng, "fib", args, spec,
                              ckdir=tmp_path / pkg)
    port, ref = runs["port"], runs["ref"]
    assert port.res.trap[3] == int(ErrCode.Terminated)
    assert ref.res.trap[3] == REF_TRAP_DONE
    others = np.arange(LANES) != 3
    assert np.array_equal(port.res.results[0][others],
                          fib_cells(args)[others])
    assert np.array_equal(port.res.trap[others], ref.res.trap[others])
    assert np.array_equal(port.res.retired[others], ref.res.retired[others])
    assert incidents(port) == incidents(ref)
    poison = [f for f in port.sup.failures if f.fault_class == "poison_lane"]
    assert poison[0].tier == "cuda" and "Terminated" in poison[0].error
    assert port.inj.counts == ref.inj.counts


def test_build_error_is_raised_not_retried(tmp_path):
    """A kernel that does not build is no launch fault: the supervisor
    raises it at once, with no retry, demotion or record."""
    eng = engine_of("port", build_fib(), conf_of("port"))
    spec = [dict(point="launch", at=1,
                 exc=lambda ctx: KernelBuildError("nvcc failed (1)"))]
    inj = injector("port", spec)
    sup = port_supervisor.BatchSupervisor(eng, faults=inj,
                                          checkpoint_dir=str(tmp_path))
    with pytest.raises(KernelBuildError):
        sup.run("fib", fib_args(), max_steps=500_000)
    assert sup.failures == [] and sup.retries == 0
    assert inj.counts["launch"] == 2 and sup.engine.fusion != "none"


def test_engine_given_back_after_a_run(tmp_path):
    """The supervised run is uncompacted; the engine is given back as it
    came, after a failed run too, so a later unsupervised run on it arms
    its compactor as configured."""
    conf = compact_conf(conf_of("port"), steps_per_launch=100)
    eng = engine_of("port", build_fib(), conf)
    args = fib_args()
    got = supervise("port", eng, "fib", args, ckdir=tmp_path / "a")
    assert eng._compact_external is False and eng.compactor is None
    with pytest.raises(KernelBuildError):
        supervise("port", eng, "fib", args,
                  [dict(point="launch", at=0,
                        exc=lambda ctx: KernelBuildError("nvcc"))],
                  ckdir=tmp_path / "b")
    assert eng._compact_external is False and eng.compactor is None
    want = eng.run("fib", args, max_steps=500_000)
    assert eng.compactor is not None   # armed by the unsupervised run
    assert np.array_equal(got.res.results[0], want.results[0])
    assert np.array_equal(got.res.trap, want.trap)


# ---------------------------------------------------------------------------
# many tenants; resume in another process
# ---------------------------------------------------------------------------
def mt_engine(pkg, conf):
    out = []
    for data, func, args in (
            (build_fib(), "fib", (np.arange(8) % 10).astype(np.int64)),
            (build_loop_sum(), "loop_sum",
             (np.arange(8) * 7).astype(np.int64))):
        eng = engine_of(pkg, data, conf, lanes=8)
        out.append((Tenant if pkg == "port" else RefTenant)(
            eng, func, [args], 8))
    if pkg == "port":
        return MultiTenantBatchEngine(out, conf=conf, device="cpu")
    return RefMultiTenant(out, conf=conf)


def test_multitenant_fault_resume_bitmatch(tmp_path):
    """fib and loop_sum tenants, one launch fault after the first
    checkpoint.  loop_sum(0)'s lane has returned by then, so the JAX
    load refuses that member (ROADMAP C14: its sp sits below its operand
    base) and replays from the start, where the port restores it: the
    results, traps and retired counts are equal, and the JAX run has one
    more incident, the refused member, and more launches."""
    runs = {}
    for name, specs in (("clean", ()), ("f", [dict(point="launch", at=2)])):
        for pkg in PKGS:
            runs[name, pkg] = supervise(
                pkg, mt_engine(pkg, conf_of(pkg)), None, None, specs,
                ckdir=tmp_path / name / pkg)
    assert_same_run(runs["clean", "port"], runs["clean", "ref"])
    port, ref = runs["f", "port"], runs["f", "ref"]
    assert port.inj.fired == ref.inj.fired == 1 and len(port.res) == 2
    for a, b, c in zip(port.res, ref.res, runs["clean", "port"].res):
        assert a.completed.all()
        assert_same_result(a, b)
        assert_same_result(a, c)
    assert incidents(port) == [("launch", ())]
    assert incidents(ref) == [("launch", ()), ("checkpoint", ())]
    assert "stack pointers" in ref.sup.failures[1].error
    assert port.inj.counts["checkpoint_load"] == \
        ref.inj.counts["checkpoint_load"] == 1
    assert port.inj.counts["launch"] < ref.inj.counts["launch"]
    assert np.array_equal(port.res[0].results[0],
                          fib_model(np.arange(8) % 10))
    assert [int(x) for x in port.res[1].results[0]] == \
        [sum(range(n * 7)) for n in range(8)]


class Crash(BaseException):
    """A process that dies mid-run: no supervisor catches it."""


def test_resume_continues_from_the_lineage(tmp_path):
    """The first run dies at its seventh launch (after three checkpoints);
    a second supervisor on a fresh engine resumes the lineage and
    finishes equal to the uninterrupted run, in both packages alike."""
    args = fib_args(13)
    runs = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        crash = [dict(point="launch", at=7, exc=lambda ctx: Crash())]
        with pytest.raises(Crash):
            supervise(pkg, engine_of(pkg, build_fib(), conf_of(pkg)), "fib",
                      args, crash, ckdir=d)
        runs[pkg] = supervise(pkg, engine_of(pkg, build_fib(),
                                             conf_of(pkg)), "fib", args,
                              ckdir=d, resume=True)
    assert_same_run(runs["port"], runs["ref"])
    port = runs["port"]
    assert port.inj.counts["checkpoint_load"] == 1   # the adoption
    clean = supervise("port", engine_of("port", build_fib(), conf_of("port")),
                      "fib", args, ckdir=tmp_path / "clean")
    assert_same_result(port.res, clean.res)
    # the resumed run went on from the newest member, step 600 (the
    # checkpoints at 200, 400 and 600 of the run that died at 700)
    assert port.inj.counts["launch"] == clean.inj.counts["launch"] - 6


# ---------------------------------------------------------------------------
# scalar_rerun
# ---------------------------------------------------------------------------
def _inv_module():
    b = ModuleBuilder()
    b.add_function(["i32"], ["i32"], [], [
        ("i32.const", 1), ("local.get", 0), "i32.div_s",
    ], export="inv")
    return b.build()


def test_scalar_rerun_reports_real_trap_codes():
    out = {}
    for pkg, fn in (("port", scalar_rerun), ("ref", ref_scalar_rerun)):
        conf = conf_of(pkg)
        inst, _ = inst_of(pkg, _inv_module(), conf)
        out[pkg] = fn(inst, conf, "inv", inst.exports["inv"][1],
                      [np.array([2, 0], np.int64)],
                      np.array([0, 1], np.int64), 10_000)
    cells, trap, recs = out["port"]
    assert not recs
    assert trap[0] == TRAP_DONE == REF_TRAP_DONE and cells[0, 0] == 0
    assert trap[1] == int(ErrCode.DivideByZero)
    assert np.array_equal(cells, out["ref"][0])
    assert np.array_equal(trap, out["ref"][1])


def test_scalar_rerun_meters_gas():
    """ROADMAP C13: the port's scalar rung holds a lane to `max_steps`
    instructions (CostLimitExceeded past them); the JAX package's builds
    its Executor with no Statistics, whose engine then counts no gas, so
    the same lane runs to its end there."""
    data = build_selective_runaway()
    out = {}
    for pkg, fn in (("port", scalar_rerun), ("ref", ref_scalar_rerun)):
        conf = conf_of(pkg)
        inst, _ = inst_of(pkg, data, conf)
        out[pkg] = fn(inst, conf, "work", inst.exports["work"][1],
                      [np.array([3, 2000], np.int64)],
                      np.array([0, 1], np.int64), 1_000)
    port_cells, port_trap, _ = out["port"]
    ref_cells, ref_trap, _ = out["ref"]
    assert port_trap[0] == ref_trap[0] == TRAP_DONE
    assert port_cells[0, 0] == ref_cells[0, 0] == 3
    assert port_trap[1] == int(ErrCode.CostLimitExceeded)
    assert ref_trap[1] == REF_TRAP_DONE
    assert ref_cells[0, 1] == 2000 * 1999 // 2


# ---------------------------------------------------------------------------
# the VM's entry point
# ---------------------------------------------------------------------------
def test_vm_execute_batch_supervised_and_resume(tmp_path):
    """VM.execute_batch(supervised=True) equals the unsupervised run and
    records into the VM's Statistics; resume=True (implying supervised)
    adopts the lineage in `checkpoint_dir`; on a machine with no card
    the default device raises rather than running on the CPU."""
    import torch

    from wasmedge_tpu_torch.vm.vm import VM

    vm = VM(conf_of("port"))
    vm.load_wasm(build_fib()).validate().instantiate()
    args = fib_args(12)
    want = vm.execute_batch("fib", args, lanes=LANES, device="cpu")
    got = vm.execute_batch("fib", args, lanes=LANES, device="cpu",
                           supervised=True, checkpoint_dir=str(tmp_path))
    assert_same_result(got, want)
    assert len(list(tmp_path.glob("ckpt-*.npz"))) == 2   # keep 2
    again = vm.execute_batch("fib", args, lanes=LANES, device="cpu",
                             resume=True, checkpoint_dir=str(tmp_path))
    assert_same_result(again, want)
    assert vm.statistics().failures == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vm.execute_batch("fib", args, lanes=LANES, supervised=True)
