"""B3, optimistic convergence: the port's plain version against the reference, launch by launch, and its leader model.

Per launch (64 lanes: two warps): the reference's image and initial state
are carried into the port (`wasmedge_tpu_torch.batch.convert`); the
reference SIMT `BatchEngine.run_from_state` (superinstruction fusion and
tier-up off), the port's plain interpreter with `optimistic` on (one
`WarpState` across the launches) and with it off each run one launch, and
after every launch every plane of both port states must equal the
reference's (pc, sp, fp, opbase, call_depth, trap, retired, fuel,
mem_pages, frames, globals, memory; the stack planes in the rows below
each lane's sp, the rows a rolled-back wrong path or a fused block may
leave dead above it).  This file runs the per-op encoding;
`test_torch_optimistic_blocks.py` and `test_torch_optimistic_super.py`
run B2 blocks and B6 superinstructions.  Fixtures: converged fib, the
fib mix, the trap zoo, divergent load addresses, the window ping-pong,
vmix, `br_if` conditions that are nonzero but differ per lane, and a
function called from two lane-dependent call sites at the same stack
height with launch boundaries inside it (its warps start launches
converged and return through different frame rows); each with a memory
in both memory modes.  Divergent fixtures must roll back, converged ones
must not.

The leader model (plain version only): the first interval of a launch is
512 dispatches, a rollback halves a warp's interval down to 256, clean
launches double it back to 131072, a window miss that would write a
dirty way back and a bulk op are commit points.

The CUDA kernel needs the card: its test is marked `cuda` and skips here
(`chip_smoke.py` holds it against this plain version on the H100, every
plane and row and the per-warp state after every launch).
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu_torch.batch import interp_ref
from wasmedge_tpu_torch.batch import laneops
from wasmedge_tpu_torch.batch import optimistic as opt_mod
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import BatchEngine, BatchState
from wasmedge_tpu_torch.batch.interp import LAUNCHES, device_tables, run_chunk
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import build_fib
from wasmedge_tpu_torch.models.fixtures import (
    build_bulk_zoo, build_call_sites, build_divergent_addresses,
    build_nonzero_conditions, build_trap_zoo, build_vmix,
    build_window_pingpong, bulk_zoo_args, window_pingpong_args, zoo_args)
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_interp import (
    CD, D, PAGES, _image_of, _ref_conf, _ref_planes)

LANES = 64
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "wasmedge_tpu_torch", "csrc")


# name -> (module, export, lane args, steps per launch, rollbacks):
# rollbacks True when some warp must roll back, False when none may
CASES = {
    "fib_converged": (build_fib, "fib", [np.full(LANES, 10)], 300, False),
    "fib_mix": (build_fib, "fib", [np.arange(LANES) % 9 + 3], 300, True),
    "trap_zoo": (build_trap_zoo, "zoo", zoo_args(LANES), 64, True),
    "divergent_addresses": (build_divergent_addresses, "f",
                            [np.arange(LANES) * 516 % 65000], 64, True),
    "window_pingpong": (build_window_pingpong, "pingpong",
                        window_pingpong_args(LANES), 64, True),
    "window_pingpong_converged": (
        build_window_pingpong, "pingpong",
        [np.full(LANES, int(a[5])) for a in window_pingpong_args(LANES)],
        64, False),
    "vmix": (build_vmix, "vmix", [np.arange(LANES) % 5 + 2], 64, True),
    "nonzero_conditions": (build_nonzero_conditions, "f",
                           [np.arange(LANES) * 7919 + 3], 64, False),
    "call_sites": (build_call_sites, "f", [np.arange(LANES)], 64, True),
}
# the cases whose module holds v128 ops (no superinstructions)
SIMD_CASES = ("window_pingpong", "window_pingpong_converged", "vmix")
# the cases whose module has a memory: they run in both memory modes
MEMORY_CASES = ("trap_zoo", "divergent_addresses", "window_pingpong",
                "window_pingpong_converged", "vmix")


def modes(cases):
    """(case, mem_window) pairs: both memory modes where there is a
    memory."""
    return [(c, w) for c in cases
            for w in ((False, True) if c in MEMORY_CASES else (False,))]


@functools.lru_cache(maxsize=None)
def reference_launches(case, max_launches=400):
    """The reference's image, its initial planes and its planes after
    each launch of `case` (one run serves every encoding and memory
    mode of the port)."""
    build, func, args, chunk, _ = CASES[case]
    conf = _ref_conf(None, chunk)
    _, store, inst = ref_instantiate(build(), conf)
    ref = RefEngine(inst, store=store, conf=conf, lanes=LANES)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    first, after = _ref_planes(st), []
    total = 0
    for _ in range(max_launches):
        st, new_total = ref.run_from_state(st, total, total + chunk)
        after.append(_ref_planes(st))
        if new_total - total < chunk or not (after[-1]["trap"] == 0).any():
            return _image_of(ref.img), first, after
        total = new_total
    raise AssertionError("reference still running after max_launches")


def per_launch(case, fusion, mem_window):
    """The reference, the port with `optimistic` on and the port with it
    off, one launch each from the same image and state; every plane
    equal after every launch (stacks below sp).  Returns the port's
    optimistic state and its WarpState."""
    chunk = CASES[case][3]
    img, first, after = reference_launches(case)
    assert img.has_memory == (case in MEMORY_CASES)
    on = device_tables(img, "cpu", fusion, mem_window=mem_window,
                       optimistic=True)
    off = device_tables(img, "cpu", fusion, mem_window=mem_window)
    port = state_from_reference(first, device="cpu")
    careful = port.clone()
    warps = WarpState.new(LANES, "cpu")
    for launch, want in enumerate(after):
        run_chunk(on, port, chunk, False, warps)
        run_chunk(off, careful, chunk, False)
        assert_live_planes(port.to_numpy(), want, f"on, launch {launch}")
        assert_live_planes(careful.to_numpy(), want,
                           f"off, launch {launch}")
    return port, warps


def check_case(case, fusion, mem_window):
    port, warps = per_launch(case, fusion, mem_window)
    rolls = CASES[case][4]
    stats = warps.stats()
    assert stats["entered"] >= 1, stats
    if rolls:
        assert stats["rollbacks"] >= 1, stats
    else:
        assert stats["rollbacks"] == 0, stats
        assert stats["commits"] >= stats["entered"], stats
    if case == "nonzero_conditions":
        assert (port.stack_lo[0] == 50).all()
    if case == "call_sites":
        # each lane back at its own call site: 101 for odd x, 102 for even
        assert port.stack_lo[0].tolist() == [
            101 + (x + 1) % 2 for x in range(LANES)]
        # a warp rolls back at the arms and again at g's return
        assert stats["rollbacks"] >= 2 * (LANES // 32), stats
    return port, warps


@pytest.mark.parametrize("case, mem_window", modes(CASES))
def test_per_op_matches_simt_every_launch(case, mem_window):
    check_case(case, "none", mem_window)


# -- the leader model -----------------------------------------------------------
def _engine(data, lanes=32, **knobs):
    conf = Configure()
    conf.batch.value_stack_depth, conf.batch.call_stack_depth = D, CD
    conf.batch.memory_pages_per_lane = PAGES
    for k, v in knobs.items():
        setattr(conf.batch, k, v)
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    inst = instantiate(StoreManager(), mod, conf)
    return BatchEngine(inst, conf=conf, lanes=lanes, device="cpu"), inst


def _launch(data, func, args, chunk, warps=None, mem_hbm=None,
            fusion="none", lanes=32):
    """One launch of the plain version with `optimistic` on; returns the
    WarpState."""
    eng, inst = _engine(data, lanes, mem_hbm=mem_hbm)
    tb = device_tables(eng.img, "cpu", fusion, mem_window=eng.mem_window,
                       optimistic=True)
    st = eng.initial_state(inst.exports[func][1], args)
    warps = warps or WarpState.new(lanes, "cpu")
    interp_ref.run_chunk(tb, st, chunk, False, warps)
    return warps


@pytest.mark.parametrize("chunk, commits", [(512, 1), (513, 2)])
def test_first_interval_is_512(chunk, commits):
    """A converged warp commits once at the launch's end, and once more
    when the launch runs past its 512th dispatch."""
    w = _launch(build_fib(), "fib", [np.full(32, 20)], chunk)
    assert w.stats() == {"entered": 1, "rollbacks": 0, "commits": commits}


@pytest.mark.parametrize("snap, after", [(512, 256), (256, 256),
                                         (131072, 65536)])
def test_a_rollback_halves_the_interval_down_to_256(snap, after):
    w = WarpState.new(32, "cpu")
    w.snap.fill_(snap)
    _launch(build_fib(), "fib", [np.arange(32) % 11 + 3], 300, w)
    assert w.rollbacks.tolist() == [1] and w.snap.tolist() == [after]


def test_clean_launches_double_back_to_131072():
    w = WarpState.new(32, "cpu")
    w.snap.fill_(opt_mod.SNAP_MIN)
    seen = []
    for _ in range(11):
        _launch(build_fib(), "fib", [np.full(32, 15)], 300, w)
        seen.append(int(w.snap[0]))
    assert seen == [512 << k for k in range(9)] + [131072, 131072]
    assert int(w.rollbacks[0]) == 0


def test_a_dirty_write_back_is_a_commit_point():
    """The converged ping-pong evicts dirty ways: with the windows each
    such miss adds a commit to what the direct run commits."""
    args = [np.full(32, int(a[5])) for a in window_pingpong_args(32)]
    win = _launch(build_window_pingpong(), "pingpong", args, 2000,
                  mem_hbm=True)
    direct = _launch(build_window_pingpong(), "pingpong", args, 2000,
                     mem_hbm=False)
    assert win.stats()["rollbacks"] == direct.stats()["rollbacks"] == 0
    assert win.stats()["commits"] > direct.stats()["commits"] >= 1


@pytest.mark.parametrize("mem_hbm", [True, False])
def test_a_bulk_op_is_a_commit_point(mem_hbm):
    """A converged warp at memory.fill commits and runs the rest of the
    launch per lane: one commit, no exit validation after it; the state
    equals the careful run's."""
    eng, inst = _engine(build_bulk_zoo(), mem_hbm=mem_hbm)
    args = [np.full(32, int(a[20])) for a in bulk_zoo_args(32, "fill", 3)]
    st = eng.initial_state(inst.exports["fill"][1], args)
    careful = st.clone()
    w = WarpState.new(32, "cpu")
    for opt in (True, False):
        tb = device_tables(eng.img, "cpu", "none", mem_window=eng.mem_window,
                           optimistic=opt)
        interp_ref.run_chunk(tb, st if opt else careful, 20000, False, w)
    assert w.stats() == {"entered": 1, "rollbacks": 0, "commits": 1}
    assert (st.trap == -1).all()
    for f, p in careful.planes().items():
        assert torch.equal(st.planes()[f], p), f


def test_engine_counts_and_the_careful_engine():
    """`optimistic_stats` sums the warps' counts; with `optimistic`
    False the tables are careful and nothing is counted."""
    ns = np.arange(64) % 9 + 3
    want = [laneops_fib(int(n)) for n in ns]
    stats = {}
    for opt in (None, False):
        eng, _ = _engine(build_fib(), 64, optimistic=opt,
                         steps_per_launch=300)
        res = eng.run("fib", [ns])
        assert res.results[0].tolist() == want
        assert eng.tables.optimistic is (opt is None)
        stats[opt] = eng.optimistic_stats
    assert stats[None]["entered"] >= 2 and stats[None]["rollbacks"] == 2
    assert stats[False] == {"entered": 0, "rollbacks": 0, "commits": 0}


def laneops_fib(n):
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


def test_plain_version_counts_no_launch():
    before = dict(LAUNCHES)
    _launch(build_fib(), "fib", [np.full(32, 5)], 100)
    assert LAUNCHES == before


def test_cuda_constants_match_python():
    """optimistic.cuh's interval constants and the ALU subs whose trap is
    a decision equal the plain version's."""
    with open(os.path.join(CSRC, "optimistic.cuh")) as f:
        src = f.read()
    for name, val in (("OPT_SNAP_STEPS", opt_mod.SNAP_STEPS),
                      ("OPT_SNAP_MIN", opt_mod.SNAP_MIN),
                      ("OPT_FIRST", opt_mod.FIRST_INTERVAL)):
        assert re.search(rf"constexpr int {name} = {val};", src), name
    assert "(unsigned)(sub - 3) <= 3u || (unsigned)(sub - 28) <= 3u" in src
    assert "sub == 23 || sub == 24 || (unsigned)(sub - 49) <= 5u" in src
    assert {s for s in range(76) if laneops.alu2_traps(s)} == \
        set(range(3, 7)) | set(range(28, 32))
    assert {s for s in range(61) if laneops.alu1_traps(s)} == \
        {23, 24} | set(range(49, 55))


@pytest.mark.cuda
def test_cuda_optimistic_kernel_matches_plain_every_launch():
    """On the card: the optimistic kernel and its plain version from the
    same state, every plane and row and the per-warp state equal after
    every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the "
                    "H100)")
    for case in ("fib_mix", "trap_zoo", "window_pingpong", "call_sites"):
        build, func, args, chunk, _ = CASES[case]
        for fusion in ("none", "blocks"):
            eng, inst = _engine(build(), LANES)
            tb = device_tables(eng.img, "cuda", fusion,
                               mem_window=eng.mem_window, optimistic=True)
            tc = device_tables(eng.img, "cpu", fusion,
                               mem_window=eng.mem_window, optimistic=True)
            st = eng.initial_state(inst.exports[func][1], args)
            gpu = BatchState(**{f: t.cuda() for f, t in st.planes().items()})
            wg, wc = WarpState.new(LANES, "cuda"), WarpState.new(LANES, "cpu")
            for _ in range(200):
                run_chunk(tb, gpu, chunk, False, wg)
                run_chunk(tc, st, chunk, False, wc)
                torch.cuda.synchronize()
                for f, p in st.planes().items():
                    assert torch.equal(gpu.planes()[f].cpu(), p), (case, f)
                for f in WarpState.COUNTERS:
                    assert torch.equal(getattr(wg, f).cpu(),
                                       getattr(wc, f)), (case, f)
                if not bool((st.trap == 0).any()):
                    break
