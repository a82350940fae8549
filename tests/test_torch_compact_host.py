"""Lane compaction launch by launch with host calls, against the JAX
package.

As test_torch_compact_launch.py, over the tier-0 zoo's divergent cases
(`models.fixtures.build_tier0_zoo`, `tier0_cases`) with WASI: with tier 0
off every call parks at its stub and is served between launches (parked
lanes are live and sort into the live prefix); with tier 0 on
clock_time_get, random_get and fd_write retire in the interpreter, and the
stdout buffer (`so_buf`, `so_off`) moves with its lane.  random_get seeds
its stream by the physical lane, so the port is held to the JAX run under
the same permutation.  Each call is one boundary, one launch, its serve
round and its stdout flush; after every call every plane, the total, the
compactor's `src`, width and stats are equal, and the stdout bytes of
both packages are equal at the end.
"""

import os
import time

import numpy as np
import pytest

import wasmedge_tpu.batch.engine as ref_engine_mod
from wasmedge_tpu.batch.compact import arm as ref_arm
from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.host.wasi import WasiModule as RefWasiModule
import wasmedge_tpu_torch.batch.engine as port_engine_mod
from wasmedge_tpu_torch.batch.engine import mem_window_of, optimistic_of
from wasmedge_tpu_torch.batch.interp import device_tables
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.batch.tier0 import t0_statics
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.host.wasi import WasiModule
from wasmedge_tpu_torch.models.fixtures import (
    build_tier0_zoo, compact_conf, tier0_cases)
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_compact_launch import replay
from tests.test_torch_interp import _ref_planes
from tests.test_torch_multitenant import inst_of

CHUNK = 8
D, CD = 64, 16
LANES = 40  # a whole warp and a part of one
RNG_SEED = 0x8BADF00D
TT = np.array([[-123456789, 0x179F], [0x7FFFFFF0, 0x2A]], np.int32)
ZOO = tier0_cases(LANES, 20261018)
# case -> (export, args, tier 0 on)
CASES = {"digit_parked": (*ZOO["digit"], False),
         "digit_tier0": (*ZOO["digit"], True),
         "random_tier0": (*ZOO["random"], True)}
# (encoding, optimistic, mem_hbm) by case: per op and in blocks, careful
# and optimistic, windows and direct memory access
CONFIGS = {"digit_parked": [("none", False, None), ("none", None, False),
                            ("blocks", None, None), ("blocks", False, False)],
           "digit_tier0": [("none", False, None), ("blocks", None, None),
                           ("blocks", False, False)],
           "random_tier0": [("none", None, False), ("blocks", None, None)]}


@pytest.fixture(autouse=True)
def _host_entropy(monkeypatch):
    """The host's cputime clocks and random bytes, fixed alike for both
    packages (the parked calls read them)."""
    monkeypatch.setattr(time, "process_time_ns", lambda: 0x1234_5678_9ABC)
    monkeypatch.setattr(time, "thread_time_ns", lambda: 0x0FED_CBA9_8765)
    monkeypatch.setattr(os, "urandom",
                        lambda n: bytes((37 * i + 11) & 0xFF
                                        for i in range(n)))


def _knobs(conf, tier0, ref):
    b = conf.batch
    b.steps_per_launch = CHUNK
    b.value_stack_depth, b.call_stack_depth = D, CD
    b.memory_pages_per_lane = 1
    b.tier0_hostcalls = tier0
    b.rng_seed = RNG_SEED
    compact_conf(conf)
    if ref:
        b.fuse_superinstructions = False
        b.tierup = False
    return conf


def _wasi(pkg, path):
    wasi = RefWasiModule() if pkg == "ref" else WasiModule()
    wasi.init_wasi(args=["alpha", "be"])
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
    wasi.env.fds[1].os_fd = wasi.env.fds[2].os_fd = fd
    return wasi, fd


_TRAJ = {}


def trajectory(case, tmp_path_factory):
    if case not in _TRAJ:
        func, args, tier0 = CASES[case]
        conf = _knobs(RefConfigure(), tier0, True)
        path = tmp_path_factory.mktemp("ref") / "out"
        wasi, fd = _wasi("ref", path)
        _, store, inst = ref_instantiate(build_tier0_zoo(), conf,
                                         imports=[wasi])
        ref = RefEngine(inst, store=store, conf=conf, lanes=LANES)
        ref_arm(ref)
        st = ref.initial_state(ref.export_func_idx(func),
                               [np.asarray(a, np.int64) for a in args])
        start, steps, total = _ref_planes(st), [], 0
        comp = ref.compactor
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_engine_mod, "t0_time_planes", lambda: TT.copy())
            while (np.asarray(st.trap) == 0).any():
                st, total = ref.run_from_state(st, total, total + 1)
                steps.append((total, _ref_planes(st), comp.src.copy(),
                              comp.width, dict(comp.stats)))
                assert len(steps) < 400
        os.close(fd)
        _TRAJ[case] = (start, steps, path.read_bytes())
    return _TRAJ[case]


@pytest.mark.parametrize("case,fusion,optimistic,mem_hbm",
                         [(c, *cfg) for c in CASES for cfg in CONFIGS[c]])
def test_compacted_host_launches_match_jax(case, fusion, optimistic, mem_hbm,
                                          tmp_path, tmp_path_factory,
                                          monkeypatch):
    start, steps, out = trajectory(case, tmp_path_factory)
    func, args, tier0 = CASES[case]
    conf = _knobs(Configure(), tier0, False)
    conf.batch.optimistic, conf.batch.mem_hbm = optimistic, mem_hbm
    conf.batch.block_fusion = fusion == "blocks"
    wasi, fd = _wasi("port", tmp_path / "out")
    inst, store = inst_of("port", build_tier0_zoo(), conf, [wasi])
    eng = BatchEngine(inst, store=store, conf=conf, lanes=LANES,
                      device="cpu")
    if fusion != eng.fusion:
        eng.tables = device_tables(
            eng.img, "cpu", fusion,
            mem_window=mem_window_of(mem_hbm, eng.img),
            optimistic=optimistic_of(optimistic), stack_depth=D,
            t0kinds=eng.t0kinds,
            t0=None if eng.t0kinds is None else t0_statics(eng.cfg))
        eng.warps = WarpState.new(LANES, "cpu") if eng.tables.optimistic \
            else None
    assert (eng.t0kinds is not None) == tier0
    monkeypatch.setattr(port_engine_mod, "t0_time_planes", lambda: TT.copy())
    exact = fusion == "none" and not eng.tables.optimistic
    replay(eng, start, steps,
           f"{case} [{fusion}, opt={optimistic}, hbm={mem_hbm}]", exact)
    os.close(fd)
    assert (tmp_path / "out").read_bytes() == out and len(out) > 0 \
        or case == "random_tier0"
    comp = eng.compactor
    assert comp.stats["fires"] >= 1
    if not tier0:
        assert eng.hostcall_stats["tier1_calls"] > 0
