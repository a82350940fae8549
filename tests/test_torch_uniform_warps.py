"""B3's uniform warps: the entry rule in the plain version, and runs per launch against the reference.

A warp that is on (its lanes share their control registers), whole (32
lanes) and whose lanes equal its lane 0 in the stack rows below sp, the
frame rows below the call depth, the globals and the live memory rows
holds one state: the CUDA kernel runs it without shuffles or snapshots
(`csrc/optimistic.cuh` `WarpUniform`), and `WarpState.uniform` counts its
entries.  The entry rule (plain version, `OptRun.uniform`), one fixture
each: lanes equal everywhere, or differing only at or above sp, at or
above the depth or beyond their pages, are uniform; a stack row below sp,
a frame row, a global or the last live memory word that differs in one
lane, and the partial warp of 40 lanes, are not.  Per launch (64 lanes:
two warps), the reference SIMT `BatchEngine` and the port's plain
interpreter with `optimistic` on from the same image and state: every
plane equal after every launch (stacks below sp; tolerance: bit-exact),
and the per-warp counts as the rule says (every entry uniform and no
rollback for the flagship-shaped runs, none uniform for the fib mix).
With a state changed so that the rule refuses it, the optimistic run
equals the careful one.  The CUDA kernel against its plain version needs
the card (marked `cuda`; `chip_smoke.py` runs it on the H100).
"""

import functools

import numpy as np
import pytest
import torch

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu_torch.batch import interp_ref
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import BatchEngine, BatchState
from wasmedge_tpu_torch.batch.interp import device_tables, run_chunk
from wasmedge_tpu_torch.batch.optimistic import OptRun, WarpState
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import build_fib, build_memory_workload
from wasmedge_tpu_torch.models.fixtures import build_uniform_probe
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_interp import (
    CD, D, PAGES, _image_of, _ref_conf, _ref_planes)

LANES = 64
PROBE_N = 12


def _engine(data, lanes, mem_hbm=None):
    conf = Configure()
    conf.batch.value_stack_depth, conf.batch.call_stack_depth = D, CD
    conf.batch.memory_pages_per_lane = PAGES
    conf.batch.mem_hbm = mem_hbm
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    inst = instantiate(StoreManager(), mod, conf)
    return BatchEngine(inst, conf=conf, lanes=lanes, device="cpu"), inst


def probe_state(lanes, steps=40):
    """The probe after one careful launch of `steps`: every lane inside
    rec(PROBE_N, 5), with stack rows, frames, the global and memory
    live."""
    eng, inst = _engine(build_uniform_probe(), lanes)
    tb = device_tables(eng.img, "cpu", "none", mem_window=eng.mem_window)
    st = eng.initial_state(inst.exports["rec"][1],
                           [np.full(lanes, PROBE_N), np.full(lanes, 5)])
    interp_ref.run_chunk(tb, st, steps, False)
    assert (st.trap == 0).all() and (st.call_depth > 1).all()
    return eng, st


def _bump(plane, row, lane=5):
    plane[row, lane] += 1


# name -> (lanes, change of the probe's state, uniform per warp; None:
# lane 5 of warp 0 changed below sp, the depth or the pages, so warp 0 is
# not uniform and warp 1 is)
ENTRY_CASES = {
    "equal": (LANES, None, [1, 1]),
    "at_or_above_sp": (LANES, lambda st: (
        _bump(st.stack_lo, int(st.sp[5])), _bump(st.stack_hi, D - 1)),
        [1, 1]),
    "at_or_above_depth": (LANES, lambda st: (
        _bump(st.fr_ret_pc, int(st.call_depth[5])),
        _bump(st.fr_fp, CD - 1)), [1, 1]),
    "beyond_pages": (LANES, lambda st: (
        _bump(st.mem, 16384), _bump(st.mem, st.mem.shape[0] - 1)), [1, 1]),
    "stack_row_below_sp": (LANES, lambda st: _bump(
        st.stack_lo, int(st.sp[5]) - 1), None),
    "frame_row": (LANES, lambda st: _bump(st.fr_opbase, 0), None),
    "global": (LANES, lambda st: _bump(st.glob_lo, 0), None),
    "last_live_word": (LANES, lambda st: _bump(st.mem, 16383), None),
    "partial_warp_of_40": (40, None, [1, 0]),
}
REFUSED = tuple(c for c, v in ENTRY_CASES.items() if v[2] is None)


@pytest.mark.parametrize("case", list(ENTRY_CASES))
def test_entry_rule(case):
    lanes, change, want = ENTRY_CASES[case]
    want = want or [0, 1]
    eng, st = probe_state(lanes)
    if change is not None:
        change(st)
    tb = device_tables(eng.img, "cpu", "none", mem_window=eng.mem_window,
                       optimistic=True)
    run = OptRun(tb, st, 100, WarpState.new(lanes, "cpu"), None)
    assert run.on.tolist() == [True] * len(want)
    assert run.uniform.to(torch.int32).tolist() == want


@pytest.mark.parametrize("case", REFUSED)
def test_refused_warps_equal_the_careful_run(case):
    """A state the rule refuses runs the leader loop (at least its first
    launch: a difference that is dead, overwritten before it is read,
    leaves the lanes one state again); its planes equal the careful
    run's (stacks below sp) after every launch."""
    eng, st = probe_state(LANES)
    ENTRY_CASES[case][1](st)
    careful = st.clone()
    on = device_tables(eng.img, "cpu", "none", mem_window=eng.mem_window,
                       optimistic=True)
    off = device_tables(eng.img, "cpu", "none", mem_window=eng.mem_window)
    warps = WarpState.new(LANES, "cpu")
    for launch in range(40):
        interp_ref.run_chunk(on, st, 50, False, warps)
        interp_ref.run_chunk(off, careful, 50, False)
        assert_live_planes(st.to_numpy(), careful.to_numpy(),
                           f"{case}, launch {launch}")
        if not bool((careful.trap == 0).any()):
            break
    u, e = warps.uniform.tolist(), warps.entered.tolist()
    assert u[0] < e[0] and u[1] == e[1] >= 1, (u, e)


# name -> (module, export, lane args, steps per launch, every entry uniform)
RUNS = {
    "probe": (build_uniform_probe, "rec",
              [np.full(LANES, PROBE_N), np.full(LANES, 5)], 40, True),
    "fib_converged": (build_fib, "fib", [np.full(LANES, 10)], 300, True),
    "mem_checksum": (lambda: build_memory_workload(2), "mem_checksum",
                     [np.full(LANES, 160)], 700, True),
    "fib_mix": (build_fib, "fib", [np.arange(LANES) % 11 + 3], 300, False),
}
MEMORY_RUNS = ("probe", "mem_checksum")


@functools.lru_cache(maxsize=None)
def reference_launches(case, max_launches=400):
    build, func, args, chunk, _ = RUNS[case]
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


def modes():
    return [(c, f, w) for c in RUNS for f in ("none", "blocks")
            for w in ((False, True) if c in MEMORY_RUNS else (False,))]


@pytest.mark.parametrize("case, fusion, mem_window", modes())
def test_per_launch_matches_simt_and_counts_uniform_entries(case, fusion,
                                                            mem_window):
    chunk, uniform = RUNS[case][3], RUNS[case][4]
    img, first, after = reference_launches(case)
    tb = device_tables(img, "cpu", fusion, mem_window=mem_window,
                       optimistic=True)
    st = state_from_reference(first, device="cpu")
    warps = WarpState.new(LANES, "cpu")
    for launch, want in enumerate(after):
        run_chunk(tb, st, chunk, False, warps)
        assert_live_planes(st.to_numpy(), want, f"launch {launch}")
    got = {f: getattr(warps, f).tolist() for f in WarpState.COUNTERS}
    assert all(e >= 1 for e in got["entered"]), got
    if uniform:
        assert got["uniform"] == got["entered"], got
        assert got["rollbacks"] == [0, 0], got
        assert all(c >= e for c, e in zip(got["commits"], got["entered"]))
    else:
        assert got["uniform"] == [0, 0], got
        assert sum(got["rollbacks"]) >= 1, got


@pytest.mark.cuda
def test_cuda_uniform_kernel_matches_plain_every_launch():
    """On the card: the optimistic kernel and its plain version from the
    same state, every plane and row and the per-warp state (w_uniform
    included) equal after every launch, uniform and refused warps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on the "
                    "H100)")
    for case in ("equal", "global", "partial_warp_of_40"):
        lanes, change, _ = ENTRY_CASES[case]
        for fusion in ("none", "blocks"):
            for mem_hbm in (None, False):
                eng, st = probe_state(lanes)
                if change is not None:
                    change(st)
                tb = device_tables(eng.img, "cuda", fusion,
                                   mem_window=mem_hbm is None,
                                   optimistic=True)
                tc = device_tables(eng.img, "cpu", fusion,
                                   mem_window=mem_hbm is None,
                                   optimistic=True)
                gpu = BatchState(**{f: t.cuda()
                                    for f, t in st.planes().items()})
                wg = WarpState.new(lanes, "cuda")
                wc = WarpState.new(lanes, "cpu")
                for _ in range(100):
                    run_chunk(tb, gpu, 50, False, wg)
                    run_chunk(tc, st, 50, False, wc)
                    torch.cuda.synchronize()
                    for f, p in st.planes().items():
                        assert torch.equal(gpu.planes()[f].cpu(), p), \
                            (case, f)
                    for f in WarpState.COUNTERS:
                        assert torch.equal(getattr(wg, f).cpu(),
                                           getattr(wc, f)), (case, f)
                    if not bool((st.trap == 0).any()):
                        break
