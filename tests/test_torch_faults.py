"""The port's fault seams and lineage, against the JAX package's.

`batch/lineage.py` (scan, install, add, prune, the newest-good walk),
`testing/faults.py` (the injector's determinism and its `match` counter,
`seeded_faults`, `flip_bit_bytes` / `flip_file`, `corrupt_checkpoint`,
`build_selective_runaway`), `FailureRecord` and `Statistics.dump()`, the
knobs of `SupervisorConfigure` and `ServeConfigure` the port carries,
and the request journal and re-queue of serve/queue.py: each equal to
the JAX package's on the same inputs.
"""

import dataclasses

import numpy as np
import pytest

from wasmedge_tpu.batch.lineage import Lineage as RefLineage
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.statistics import FailureRecord as RefRecord
from wasmedge_tpu.serve.queue import FairQueue as RefQueue
from wasmedge_tpu.serve.queue import ServeRequest as RefRequest
from wasmedge_tpu.testing import faults as ref_faults
from wasmedge_tpu_torch.batch.lineage import Lineage
from wasmedge_tpu_torch.common import statistics
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.serve.queue import (
    FairQueue, ServeRequest, advance_request_ids)
from wasmedge_tpu_torch.testing import faults

pytestmark = pytest.mark.faults


# ---------------------------------------------------------------------------
# the lineage
# ---------------------------------------------------------------------------
def _touch(d, names):
    for n in names:
        (d / n).write_bytes(b"x")


def test_lineage_scan_install_and_walk(tmp_path):
    _touch(tmp_path, ["ckpt-000000000400.npz", "ckpt-000000000200.npz",
                      "ckpt-000000001000.npz", "ckpt-x.npz", "other.npz",
                      "ckpt-000000000600.npz.sha256"])
    got = Lineage.scan(str(tmp_path), r"ckpt-(\d+)\.npz")
    assert got == RefLineage.scan(str(tmp_path), r"ckpt-(\d+)\.npz")
    assert [s for _, s in got] == [200, 400, 1000]
    assert Lineage.scan(str(tmp_path / "missing"), r"x(\d+)") == []
    for cls in (Lineage, RefLineage):
        lin = cls()
        lin.install(got)
        bad = []

        def load(m):
            if m.steps == 1000:
                raise ValueError("corrupt")
            return m.steps

        assert lin.walk_newest(load, lambda e, m: bad.append(m.steps)) \
            == 400
        assert bad == [1000] and len(lin) == 2
        assert lin.newest().steps == 400 and lin.next_seq() == 401
        assert lin.walk_newest(lambda m: 1 / 0, lambda e, m: None) is None
        assert not lin and lin.newest() is None and lin.next_seq() == 0


def test_lineage_add_replaces_and_prune_unlinks(tmp_path):
    logs = {}
    for name, cls in (("port", Lineage), ("ref", RefLineage)):
        lin, gone = cls(), []
        for steps in (100, 200, 200, 300, 400):
            lin.add(str(tmp_path / f"c{steps}"), steps, payload={"s": steps})
        assert [m.steps for m in lin.members] == [100, 200, 300, 400]

        def unlink(p):
            gone.append(p)
            if p.endswith("c100"):
                raise OSError("a failed delete never fails the run")
        lin.prune(2, unlink=unlink)
        logs[name] = ([(m.steps, m.payload) for m in lin.members], gone)
        lin.prune(0, unlink=gone.append)   # keeps at least one
        assert len(lin) == 1
        lin.reset()
        assert not lin
    assert logs["port"] == logs["ref"]
    assert logs["port"][0] == [(300, {"s": 300}), (400, {"s": 400})]


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------
def _drive(mod, specs, arrivals):
    inj = mod.FaultInjector([mod.Fault(**s) for s in specs])
    seen = []
    for point, ctx in arrivals:
        try:
            inj.fire(point, **ctx)
        except mod.InjectedFault as e:
            seen.append((e.point, e.index, e.lanes, str(e)))
    return seen, inj.counts, inj.log, inj.fired


def test_injector_is_deterministic_and_equals_jax():
    arrivals = [(p, {}) for _ in range(8) for p in ("launch", "serve")]
    for seed in (42, 43, 7):
        specs = [dict(point=f.point, at=f.at)
                 for f in faults.seeded_faults(seed=seed, n=3)]
        assert specs == [dict(point=f.point, at=f.at) for f in
                         ref_faults.seeded_faults(seed=seed, n=3)]
        first = _drive(faults, specs, arrivals)
        assert first[0]   # the seeded plan fires
        assert _drive(faults, specs, arrivals) == first
        assert _drive(ref_faults, specs, arrivals) == first
    assert [(f.point, f.at) for f in faults.seeded_faults(42, n=3)] != \
        [(f.point, f.at) for f in faults.seeded_faults(43, n=3)]


def test_injector_match_counts_its_own_arrivals():
    """A matched fault indexes the arrivals whose context matches, not
    every arrival at the seam; `times`, `lanes`, `message`, `before` and
    `exc` as in the JAX package."""
    calls = []
    specs = [dict(point="launch", at=1, match={"dev": 2}, lanes=(5,)),
             dict(point="launch", at=4, times=2, message="boom",
                  before=lambda: calls.append("before"))]
    arrivals = [("launch", {"dev": d}) for d in (1, 2, 2, 1, 2, 1, 2)]
    got = _drive(faults, specs, arrivals)
    calls_port = list(calls)
    calls.clear()
    assert got == _drive(ref_faults, specs, arrivals)
    assert calls_port == calls == ["before", "before"]
    seen = got[0]
    assert seen[0][:3] == ("launch", 1, (5,))   # dev 2's second arrival
    assert [s[1] for s in seen[1:]] == [4, 5] and seen[1][3] == "boom"

    class Custom(Exception):
        pass

    inj = faults.FaultInjector([faults.Fault(
        point="serve", exc=lambda ctx: Custom(ctx))])
    with pytest.raises(Custom) as ei:
        inj.fire("serve", total=7)
    assert ei.value.args[0] == {"total": 7, "point": "serve", "index": 0}
    assert inj.fired == 1 and inj.counts == {"serve": 1}


# ---------------------------------------------------------------------------
# file damage, the runaway module
# ---------------------------------------------------------------------------
def test_flip_bit_bytes_and_file_equal_jax(tmp_path):
    data = bytes(range(256)) * 3
    for seed, bit in ((0, None), (5, 3), (1234, 7)):
        out = faults.flip_bit_bytes(data, seed=seed, bit=bit)
        assert out == ref_faults.flip_bit_bytes(data, seed=seed, bit=bit)
        diff = np.frombuffer(out, np.uint8) ^ np.frombuffer(data, np.uint8)
        assert int(np.unpackbits(diff).sum()) == 1
    assert faults.flip_bit_bytes(b"") == b""
    for name, mod in (("port", faults), ("ref", ref_faults)):
        (tmp_path / name).write_bytes(data)
        mod.flip_file(tmp_path / name, seed=9)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()


@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_corrupt_checkpoint_equals_jax(tmp_path, mode):
    data = np.random.RandomState(3).bytes(4000)
    for name, mod in (("port", faults), ("ref", ref_faults)):
        (tmp_path / name).write_bytes(data)
        mod.corrupt_checkpoint(tmp_path / name, mode=mode, seed=11)
    out = (tmp_path / "port").read_bytes()
    assert out == (tmp_path / "ref").read_bytes()
    if mode == "truncate":
        assert out == data[:2000]
    else:
        assert len(out) == len(data) and out != data
    with pytest.raises(ValueError, match="unknown corruption mode"):
        faults.corrupt_checkpoint(tmp_path / "port", mode="melt")


def test_selective_runaway_module_equals_jax():
    assert faults.build_selective_runaway() == \
        ref_faults.build_selective_runaway()


# ---------------------------------------------------------------------------
# FailureRecord, Statistics, the knobs
# ---------------------------------------------------------------------------
def test_failure_record_and_statistics_dump():
    statistics.clear_failures()
    rec = statistics.FailureRecord(fault_class="poison_lane",
                                   error="x", lanes=(3, 9), retry=2,
                                   checkpoint="c.npz", tier="scalar")
    ref = RefRecord(fault_class="poison_lane", error="x", lanes=(3, 9),
                    retry=2, checkpoint="c.npz", tier="scalar")
    assert rec.asdict() == ref.asdict()
    assert rec.stamp().time_s > 0 and rec.mono_s > 0
    t = rec.time_s
    assert rec.stamp().time_s == t   # idempotent
    st = statistics.Statistics()
    assert "failures" not in st.dump()
    st.add_failure(rec)
    d = st.dump()
    assert d["failures"] == [rec.asdict()]
    assert d["failures"][0]["lanes"] == [3, 9]
    assert statistics.recent_failures() == [rec]
    statistics.record_failure(statistics.FailureRecord("launch"))
    assert [r.fault_class for r in statistics.recent_failures()] == \
        ["poison_lane", "launch"]
    st.reset()
    assert st.failures == []
    statistics.clear_failures()
    assert statistics.recent_failures() == []


def test_supervision_knobs_equal_jax_defaults():
    port, ref = Configure(), RefConfigure()
    fields = [f.name for f in dataclasses.fields(port.supervisor)]
    # the mesh knobs wait for more than one card; the kernel tier has no
    # counterpart; the scalar rung follows the engine's device; the
    # directory and resume are parameters of BatchSupervisor
    left_out = {"use_kernel_tier", "use_shard_drive", "max_device_retries",
                "eject_devices", "allow_scalar_tier", "checkpoint_dir",
                "resume"}
    assert set(fields) | left_out == \
        {f.name for f in dataclasses.fields(ref.supervisor)}
    for name in fields:
        assert getattr(port.supervisor, name) == \
            getattr(ref.supervisor, name), name
    assert not hasattr(port.serve, "checkpoint_dir")   # BatchServer's
    for name in ("checkpoint_every_rounds", "keep_checkpoints", "max_retries", "backoff_base_s",
                 "backoff_factor", "backoff_max_s"):
        assert getattr(port.serve, name) == getattr(ref.serve, name), name


# ---------------------------------------------------------------------------
# the request journal and the re-queue
# ---------------------------------------------------------------------------
def test_request_journal_and_push_front():
    a = ServeRequest("fib", (7,), tenant="t1")
    ref = RefRequest("fib", (7,), tenant="t1", request_id=a.id)
    assert a.asdict() == ref.asdict() == \
        {"id": a.id, "func": "fib", "args": [7], "tenant": "t1"}
    b = ServeRequest.from_journal(a.asdict())
    assert (b.id, b.func_name, b.args, b.tenant) == \
        (a.id, "fib", (7,), "t1")
    advance_request_ids(a.id + 100)
    assert ServeRequest("fib", (1,)).id > a.id + 100
    orders = []
    for qcls, rcls in ((FairQueue, ServeRequest), (RefQueue, RefRequest)):
        q = qcls(2)
        reqs = [rcls("f", (k,), tenant=t, request_id=k)
                for k, t in enumerate("aab")]
        q.push(reqs[2])
        q.push_front(reqs[:2])   # past the capacity: never dropped
        assert len(q) == 3
        orders.append([r.args[0] for r in q.pop(3, {})])
    assert orders[0] == orders[1]
    assert sorted(orders[0]) == [0, 1, 2]
