"""Supervised batch execution on the port, held against the JAX package.

The counterpart of tests/test_supervisor.py: the port's `BatchSupervisor`
over its `BatchEngine` (device="cpu", the plain versions) and the JAX
package's over its `BatchEngine` with the kernel tier off, on the same
module, arguments and fault schedule (16 lanes, 100 steps a launch, a
checkpoint every 200 steps, no backoff).  Each case holds, port against
JAX: results, `trap` and `retired`, the fault classes with their lanes,
the injector's arrival counts at every seam and its log, and the
lineage's step counts.  This file: launch and serve faults, a fault
before the first checkpoint, corrupt newest members (truncated, a
flipped span) with the lineage falling back, a `checkpoint_load` fault, a
failed `checkpoint_save`, the wall-clock cadence and records landing in
`Statistics.dump()["failures"]`.  The ladder, quarantine, multi-tenant and
resume cases are in test_torch_supervisor_ladder.py.

The JAX side runs its SIMT engine with superinstruction fusion and
tier-up off: its fused step counts a superinstruction as one step, where
the port's fused encodings keep one step an instruction, so only the
per-op JAX engine takes the same launches and checkpoints at the same
steps as the port's default (blocks).
"""

import dataclasses
import os

import numpy as np
import pytest

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.batch.supervisor import BatchSupervisor as RefSupervisor
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.statistics import Statistics as RefStatistics
from wasmedge_tpu.host.wasi import WasiModule as RefWasiModule
from wasmedge_tpu.testing import faults as ref_faults
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.supervisor import BatchSupervisor
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.statistics import Statistics
from wasmedge_tpu_torch.host.wasi import WasiModule
from wasmedge_tpu_torch.models import build_fib
from wasmedge_tpu_torch.models.fixtures import fib_model
from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE, build_echo
from wasmedge_tpu_torch.testing import faults as port_faults
from tests.test_torch_multitenant import inst_of

pytestmark = pytest.mark.faults

LANES = 16
PKGS = ("port", "ref")


def conf_of(pkg, fused_ref=False, **sup):
    conf = (Configure if pkg == "port" else RefConfigure)()
    conf.batch.steps_per_launch = 100
    conf.batch.rng_seed = 7
    conf.supervisor.backoff_base_s = 0.0   # no sleeping in tests
    conf.supervisor.checkpoint_every_steps = 200
    for k, v in sup.items():
        setattr(conf.supervisor, k, v)
    if pkg == "ref":
        conf.supervisor.use_kernel_tier = False
        conf.batch.tierup = False
        conf.batch.fuse_superinstructions = fused_ref
    return conf


def engine_of(pkg, data, conf, lanes=LANES, imports=()):
    inst, store = inst_of(pkg, data, conf, imports)
    if pkg == "port":
        return BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                           device="cpu")
    return RefEngine(inst, store=store, conf=conf, lanes=lanes)


def faults_mod(pkg):
    return port_faults if pkg == "port" else ref_faults


def injector(pkg, specs):
    """A FaultInjector of `pkg` over `specs` (Fault keyword dicts)."""
    fm = faults_mod(pkg)
    return fm.FaultInjector([fm.Fault(**s) for s in specs])


@dataclasses.dataclass
class Run:
    sup: object
    res: object
    inj: object
    stats: object
    out: bytes = b""


def supervise(pkg, engine, func, args, specs=(), max_steps=500_000,
              ckdir=None, resume=None):
    """One supervised run of `engine` in package `pkg`; `specs` may be a
    callable of the package (for faults whose `before` uses its
    helpers)."""
    if callable(specs):
        specs = specs(pkg)
    inj = injector(pkg, specs)
    stats = (Statistics if pkg == "port" else RefStatistics)()
    cls = BatchSupervisor if pkg == "port" else RefSupervisor
    sup = cls(engine, stats=stats, faults=inj, checkpoint_dir=str(ckdir),
              resume=resume)
    res = sup.run(func, args, max_steps=max_steps) if func is not None \
        else sup.run(max_steps=max_steps)
    return Run(sup, res, inj, stats)


def incidents(run):
    return [(f.fault_class, tuple(f.lanes)) for f in run.sup.failures]


def assert_same_result(a, b):
    for ra, rb in zip(a.results, b.results):
        assert np.array_equal(ra, rb)
    assert np.array_equal(a.trap, b.trap)
    assert np.array_equal(a.retired, b.retired)
    assert a.steps == b.steps


def assert_same_run(port, ref):
    """Port against JAX: results, trap, retired; fault classes and lanes;
    injector counts and log; lineage step counts."""
    if isinstance(port.res, list):
        assert len(port.res) == len(ref.res)
        for a, b in zip(port.res, ref.res):
            assert_same_result(a, b)
    else:
        assert_same_result(port.res, ref.res)
    assert incidents(port) == incidents(ref)
    assert port.inj.counts == ref.inj.counts
    assert port.inj.log == ref.inj.log
    assert [m.steps for m in port.sup._lineage.members] == \
        [m.steps for m in ref.sup._lineage.members]
    assert port.out == ref.out


def pair(tmp_path, data, func, args, specs=(), fused_ref=False,
         max_steps=500_000, **sup):
    """The same supervised run in both packages; returns (port, ref)."""
    runs = {}
    for pkg in PKGS:
        eng = engine_of(pkg, data, conf_of(pkg, fused_ref, **sup))
        runs[pkg] = supervise(pkg, eng, func, args, specs, max_steps,
                              tmp_path / pkg)
    assert_same_run(runs["port"], runs["ref"])
    return runs["port"], runs["ref"]


def fib_args(mod=11):
    return [(np.arange(LANES) % mod).astype(np.int64)]


def fib_cells(args):
    return fib_model(args[0]).astype(np.int64)


def echo_run(pkg, tmp_path, lanes, iters, specs=(), fused_ref=False,
             **sup):
    """One supervised fd_write echo run of `pkg` with fd 1 routed to a
    file; tier 0 off, so that every call parks on the tier-1 serve
    seam."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    conf = conf_of(pkg, fused_ref, **sup)
    conf.batch.tier0_hostcalls = False
    sink_path = tmp_path / f"{pkg}.out"
    sink = os.open(sink_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    try:
        wasi = (WasiModule if pkg == "port" else RefWasiModule)()
        wasi.init_wasi(dirs=[], prog_name="echo")
        wasi.env.fds[1].os_fd = sink
        eng = engine_of(pkg, build_echo(), conf, lanes, [wasi])
        run = supervise(pkg, eng, "echo", [np.full(lanes, iters, np.int64)],
                        specs, 200_000, tmp_path / f"{pkg}-ck")
    finally:
        os.close(sink)
    run.out = sink_path.read_bytes()
    return run


def echo_pair(tmp_path, lanes, iters, specs=(), **sup):
    """echo_run in both packages, held against each other."""
    port, ref = (echo_run(pkg, tmp_path, lanes, iters, specs, **sup)
                 for pkg in PKGS)
    assert_same_run(port, ref)
    return port, ref


# ---------------------------------------------------------------------------
# a failed launch, a failed serve round
# ---------------------------------------------------------------------------
def test_launch_fault_resume_bitmatch(tmp_path):
    args = fib_args()
    clean, _ = pair(tmp_path / "clean", build_fib(), "fib", args)
    assert not clean.sup.failures
    port, ref = pair(tmp_path / "f", build_fib(), "fib", args,
                     [dict(point="launch", at=3)])
    assert port.inj.fired == 1
    assert port.res.completed.all()
    assert np.array_equal(port.res.results[0], fib_cells(args))
    assert_same_result(port.res, clean.res)
    assert incidents(port) == [("launch", ())]
    assert port.sup.failures[0].retry == 1
    assert port.sup.tier == "cuda"


def test_launch_fault_before_first_checkpoint(tmp_path):
    args = [np.full(LANES, 9, np.int64)]
    port, _ = pair(tmp_path, build_fib(), "fib", args,
                   [dict(point="launch", at=0)])
    assert port.res.completed.all()
    assert (port.res.results[0] == int(fib_model([9])[0])).all()
    assert "checkpoint_load" not in port.inj.counts   # nothing to load


def test_serve_fault_resume_bitmatch(tmp_path):
    lanes, iters = 8, 2
    clean, _ = echo_pair(tmp_path / "clean", lanes, iters)
    # the fault fires at the first serve round, before any byte reaches
    # the fd, so the recovery writes each record once
    port, _ = echo_pair(tmp_path / "f", lanes, iters,
                        [dict(point="serve", at=0)])
    assert port.inj.fired == 1
    assert port.res.completed.all()
    assert incidents(port) == [("serve", ())]
    assert_same_result(port.res, clean.res)
    assert port.out == clean.out
    assert port.out.count(ECHO_MESSAGE) == lanes * iters * 2


# ---------------------------------------------------------------------------
# corrupt or truncated checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_corrupt_newest_falls_back(tmp_path, mode):
    """The newest member is corrupted just before the fault; the restore
    records it, falls back to the older member and still finishes
    bit-identical to the uninterrupted run."""
    args = fib_args(12)
    clean, _ = pair(tmp_path / "clean", build_fib(), "fib", args,
                    keep_checkpoints=3)

    def specs(pkg):
        ckdir = tmp_path / "f" / pkg

        def corrupt_newest():
            cks = sorted(ckdir.glob("ckpt-*.npz"))
            assert cks, "the fault fired before any checkpoint existed"
            faults_mod(pkg).corrupt_checkpoint(cks[-1], mode=mode)
        return [dict(point="launch", at=4, before=corrupt_newest)]

    port, _ = pair(tmp_path / "f", build_fib(), "fib", args, specs,
                   keep_checkpoints=3)
    assert port.res.completed.all()
    assert_same_result(port.res, clean.res)
    classes = [c for c, _ in incidents(port)]
    assert classes == ["launch", "checkpoint"]
    bad = [f for f in port.sup.failures if f.fault_class == "checkpoint"]
    assert bad[0].checkpoint.endswith(".npz")  # the member is named


def test_injected_checkpoint_load_fault(tmp_path):
    args = [np.full(LANES, 10, np.int64)]
    port, _ = pair(tmp_path, build_fib(), "fib", args,
                   [dict(point="launch", at=4),
                    dict(point="checkpoint_load", at=0)],
                   keep_checkpoints=3)
    assert port.res.completed.all()
    assert (port.res.results[0] == int(fib_model([10])[0])).all()
    assert [c for c, _ in incidents(port)].count("checkpoint") == 1


def test_checkpoint_save_failure_is_nonfatal(tmp_path):
    args = [np.full(LANES, 10, np.int64)]
    port, _ = pair(tmp_path, build_fib(), "fib", args,
                   [dict(point="checkpoint_save", at=0, times=99)])
    assert port.res.completed.all()
    assert all(c == "checkpoint" for c, _ in incidents(port))
    assert not list((tmp_path / "port").glob("ckpt-*.npz"))


def test_wall_clock_cadence_fires_with_large_step_cadence(tmp_path):
    # cadences are "whichever fires first": a huge step cadence must not
    # starve the wall-clock one of its checks at launch boundaries
    conf = conf_of("port", checkpoint_every_steps=10 ** 9,
                   checkpoint_every_s=1e-9)
    run = supervise("port", engine_of("port", build_fib(), conf), "fib",
                    [np.full(LANES, 11, np.int64)], ckdir=tmp_path)
    assert run.res.completed.all()
    assert list(tmp_path.glob("ckpt-*.npz"))


def test_supervisor_records_land_in_statistics(tmp_path):
    port, ref = pair(tmp_path, build_fib(), "fib",
                     [np.full(LANES, 8, np.int64)],
                     [dict(point="launch", at=1)])
    assert port.res.completed.all()
    assert [f.fault_class for f in port.stats.failures] == ["launch"]
    dumped = port.stats.dump()
    assert dumped["failures"][0]["fault_class"] == "launch"
    assert [f["fault_class"] for f in dumped["failures"]] == \
        [f["fault_class"] for f in ref.stats.dump()["failures"]]
