"""B4's per-row valid and dirty bits: the window fixtures per launch against the reference, and the window counts of the plain `MemWindows`.

The CUDA kernel keeps a valid and a dirty bit per row of each way
(`csrc/memwin.cuh`): a miss moves no row in, a whole-word store into a row
that is not valid writes it with no fill, a partial store fills its one
row first, a load of a row that is not valid fills the rest of the way,
and a write-back stores the dirty rows only.  What it leaves in the plane
is what the plain `MemWindows` (whole ways) leaves, and both count misses
and ways written back by one rule (`memwin.COUNTS`, the kernel's
`interp.window_counts`).  Fixtures (`models.fixtures.build_win_rows`): a
store-only sweep across a way boundary, store8 / store16 / an unaligned
v128 store into rows that are not valid, a load after whole-word stores,
and a commit of a uniform warp with some rows dirty.  Each runs per launch
against the reference SIMT `BatchEngine` in both memory modes (every
plane equal after every launch, stacks below sp; tolerance: bit-exact),
careful and optimistic; its window counts in one launch are checked
against the numbers the rule gives by hand.  The kernel's row counts need
the card (`chip_smoke.py`).
"""

import functools

import numpy as np
import pytest

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu_torch.batch import interp_ref, memwin
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.interp import device_tables, run_chunk
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.models.fixtures import build_win_rows
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_interp import _image_of, _ref_conf, _ref_planes

LANES = 32


def _args(case):
    a = np.arange(LANES)
    x = np.random.default_rng(7).integers(-2**31, 2**31, LANES)
    return {
        "sweep": [np.zeros(LANES), np.full(LANES, 160)],
        "partial": [a * 4 + 1 + 2 * (a % 2), x],  # unaligned v128 stores
        "store_load": [a * 8, x],
        # one state in every lane: a uniform warp commits at its interval
        "commit_rows": [np.full(LANES, 96), np.full(LANES, 12345),
                        np.full(LANES, 200)],
    }[case]


# export -> (steps per launch against the reference, (misses, ways
# written back) per lane in one careful launch, and in one optimistic one)
CASES = {
    "sweep": (300, (2, 2), (2, 3)),
    "partial": (9, (1, 1), (2, 1)),
    "store_load": (5, (1, 1), (2, 1)),
    "commit_rows": (500, (1, 1), (1, 2)),
}


@functools.lru_cache(maxsize=None)
def reference_launches(case):
    chunk = CASES[case][0]
    conf = _ref_conf(None, chunk)
    _, store, inst = ref_instantiate(build_win_rows(), conf)
    ref = RefEngine(inst, store=store, conf=conf, lanes=LANES)
    st = ref.initial_state(ref.export_func_idx(case),
                           [np.asarray(v, np.int64) for v in _args(case)])
    first, after = _ref_planes(st), []
    total = 0
    for _ in range(200):
        st, new_total = ref.run_from_state(st, total, total + chunk)
        after.append(_ref_planes(st))
        if new_total - total < chunk or not (after[-1]["trap"] == 0).any():
            return _image_of(ref.img), first, after
        total = new_total
    raise AssertionError("reference still running after 200 launches")


@pytest.mark.parametrize("optimistic", [False, True])
@pytest.mark.parametrize("mem_window", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_per_launch_matches_simt(case, mem_window, optimistic):
    img, first, after = reference_launches(case)
    tb = device_tables(img, "cpu", "none", mem_window=mem_window,
                       optimistic=optimistic)
    st = state_from_reference(first, device="cpu")
    warps = WarpState.new(LANES, "cpu")
    for launch, want in enumerate(after):
        run_chunk(tb, st, CASES[case][0], False, warps)
        assert_live_planes(st.to_numpy(), want, f"launch {launch}")
    assert (st.trap == -1).all()


@pytest.mark.parametrize("optimistic", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_window_counts_by_hand(case, optimistic):
    """One launch to the end through the windows: misses and ways written
    back per lane as the rule gives them (the sweep: rows 0..159 miss at
    rows 0 and 128 and both ways go back at the end; every other fixture
    stays in one way; optimistic, the uniform warps of the sweep and of
    `commit_rows` commit at their first interval, 512 dispatches, with
    dirty rows in one way, which goes back then and again at the end,
    and the warps of `partial` and `store_load`, whose lanes' addresses
    differ, roll back at the exit: their windows are dropped, not written
    back, and the careful re-run misses once more)."""
    want = CASES[case][2 if optimistic else 1]
    img, first, after = reference_launches(case)
    tb = device_tables(img, "cpu", "none", mem_window=True,
                       optimistic=optimistic)
    st = state_from_reference(first, device="cpu")
    warps = WarpState.new(LANES, "cpu")
    memwin.clear_counts()
    interp_ref.run_chunk(tb, st, 100_000, False, warps)
    np.testing.assert_array_equal(st.to_numpy()["mem"], after[-1]["mem"])
    assert memwin.COUNTS == {"misses": want[0] * LANES,
                             "ways_written_back": want[1] * LANES}
    if optimistic:
        uniform = case in ("sweep", "commit_rows")  # every lane one state
        assert warps.entered.tolist() == [1]
        assert warps.uniform.tolist() == [int(uniform)]
        assert warps.rollbacks.tolist() == [int(not uniform)]


def test_counts_clear():
    memwin.COUNTS["misses"] = 3
    memwin.clear_counts()
    assert memwin.COUNTS == {"misses": 0, "ways_written_back": 0}
