"""B3 end to end with a memory: the port with `optimistic` on against the Pallas kernel's optimistic mode.

The fixtures of `tests/test_optimistic.py` that hold a memory, at its 8
lanes, each with `mem_hbm` False and True in both engines:
`PallasUniformEngine(..., interpret=True)` with `optimistic` on beside
the port's engine on the CPU with `optimistic` on; results and traps
equal, `retired` equal to the JAX SIMT `BatchEngine`'s
(`test_torch_optimistic_pallas.compare`).  Partial-lane out-of-bounds
loads and per-lane store addresses roll the port's warp back; the
snapshot-interval fixture runs with an interval of 64 (JAX's
`SNAP_STEPS = 64`, the port's `snap_max = 64`) and commits many times
without rolling back.
"""

import numpy as np
import pytest

from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import ErrCode
from wasmedge_tpu_torch.utils.builder import ModuleBuilder
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_optimistic_pallas import LANES, compare


@pytest.mark.parametrize("hbm", [False, True])
def test_partial_lane_oob_load_rolls_back(hbm):
    b = ModuleBuilder()
    b.add_memory(1, 1)
    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("i32.load", 2, 0),
    ], export="f")
    addr = np.array([0, 4, 8, 70000, 0, 4, 70000, 8])
    _, got, eng = compare(b.build(), "f", [addr], hbm)
    for lane in range(LANES):
        want = int(ErrCode.MemoryOutOfBounds) if addr[lane] >= 65536 else -1
        assert got.trap[lane] == want, (hbm, lane)
    assert eng.optimistic_stats["rollbacks"] == 1


@pytest.mark.parametrize("hbm", [False, True])
def test_divergent_load_addresses_lane_exact(hbm):
    b = ModuleBuilder()
    b.add_memory(1, 1)
    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("local.get", 0), ("i32.store", 2, 0),
        ("local.get", 0), ("i32.load", 2, 0),
    ], export="f")
    addr = (np.arange(LANES) * 512) % 65000
    _, got, eng = compare(b.build(), "f", [addr], hbm)
    assert (np.asarray(got.results[0]) == addr).all(), hbm
    assert eng.optimistic_stats["rollbacks"] == 1


@pytest.mark.parametrize("hbm", [False, True])
def test_snapshot_interval_commits(hbm):
    b = ModuleBuilder()
    b.add_memory(1, 1)
    b.add_function(["i32"], ["i32"], ["i32", "i32"], [
        ("block", None),
        ("loop", None),
        ("local.get", 1), ("local.get", 0), "i32.ge_u", ("br_if", 1),
        ("local.get", 1), ("i32.const", 4), "i32.mul",
        ("local.get", 1), ("i32.const", 0x55AA55), "i32.xor",
        ("i32.store", 2, 0),
        ("local.get", 2),
        ("local.get", 1), ("i32.const", 4), "i32.mul", ("i32.load", 2, 0),
        "i32.add", ("local.set", 2),
        ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
        ("br", 0),
        "end", "end",
        ("local.get", 2),
    ], export="f")
    data = b.build()
    n = 500
    _, got, eng = compare(data, "f", [np.full(LANES, n)], hbm,
                          snap_steps=64, snap_max=64)
    s_ex, s_store, s_inst = ref_instantiate(data, RefConfigure())
    expect = s_ex.invoke(s_store, s_inst.find_func("f"), [n])[0]
    got_v = np.asarray(got.results[0], np.int64) & 0xFFFFFFFF
    assert (got_v == (int(expect) & 0xFFFFFFFF)).all(), hbm
    stats = eng.optimistic_stats
    assert stats["rollbacks"] == 0
    # one 50,000-step launch: a commit at the first dispatch boundary 64
    # steps past the last one (a fused block is at most 24 ops)
    assert stats["commits"] >= int(got.retired[0]) // (64 + 24), stats
