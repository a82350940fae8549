"""B5's warp-cooperative row pass: its fixtures on the port's plain version against the reference engines.

The CUDA kernel runs memory.fill / memory.copy as one pass per group of
the lanes of a warp at the op together (every fill one group, copies by
src - dst), walking rows 16 bytes a thread, with per-lane byte masks
(`csrc/interp.cu` `bulk_op`); its plain version (`batch/interp_ref.py`
`_bulk`, `_fill_copy`) is unchanged.  The fixtures
(`models.fixtures.bulk_warp_case` over `build_bulk_warp`, one op and
two loads) shape the ops
for that pass: converged fills and copies with byte shifts 0-3, forward
and backward, overlapping; lane-dependent dst and n with one delta and
with two deltas in one warp; a lane out of bounds and n == 0 lanes in a
converged warp; some at 100 lanes (a partial last warp) and 99 (rows that
are not 16 bytes).

Per launch: the reference SIMT `BatchEngine.run_from_state` and the
port's plain interpreter from the same image and state, every plane equal
after every launch (as tests/test_torch_interp.py `_per_launch`, one page
per lane and 256 steps per launch).  End of run: results and traps
against the reference Pallas kernel (`PallasUniformEngine(...,
interpret=True)`), bit-exact, and retired counts too where no lane traps
(ROADMAP.md §C2: Pallas counts 1 or 2 fewer per lane when a lane of the
block traps).

The kernel needs the card: its test is marked `cuda` and skips here
(`chip_smoke.py` holds it against the plain version on the H100 in both
memory modes, optimistic and careful, and counts its warp passes).
"""

import numpy as np
import pytest
import torch

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu_torch.batch import interp, interp_ref
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.interp import device_tables, run_chunk
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models.fixtures import (
    BULK_WARP_CASES, build_bulk_warp, bulk_warp_case)
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_interp import (
    _assert_planes, _assert_same_state, _image_of, _pallas_run, _port_run,
    _ref_planes)

LANES = 32
CHUNK = 8
# cases also run at 100 lanes (a partial warp) and 99 (L % 4 != 0)
PARTIAL = ("fill_lanes", "copy_two_deltas", "copy_oob_and_empty")


def _page_words(lanes):
    """The memory plane before the op: the data segment's words."""
    _, store, inst = ref_instantiate(build_bulk_warp(), _conf())
    ref = RefEngine(inst, store=store, conf=_conf(), lanes=lanes)
    st = ref.initial_state(ref.export_func_idx("fill"),
                           [np.zeros(lanes, np.int64)] * 3)
    return np.asarray(st.mem)


def _check_outcome(case, lanes, trap):
    if case.endswith("oob_and_empty"):
        oob = np.arange(lanes) % 32 == 3
        assert (trap[oob] == int(ErrCode.MemoryOutOfBounds)).all()
        assert (trap[~oob] == -1).all()
    else:
        assert (trap == -1).all()


def _conf():
    conf = RefConfigure()
    b = conf.batch
    b.steps_per_launch = CHUNK
    b.value_stack_depth, b.call_stack_depth = 64, 16
    b.memory_pages_per_lane = 1
    b.fuse_superinstructions = False
    b.tierup = False
    return conf


def _per_launch(func, args, lanes, max_launches=100):
    """The reference SIMT engine and the port's plain interpreter on
    build_bulk_warp, launch by launch, every plane equal after each."""
    conf = _conf()
    _, store, inst = ref_instantiate(build_bulk_warp(), conf)
    ref = RefEngine(inst, store=store, conf=conf, lanes=lanes)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    tables = device_tables(_image_of(ref.img), "cpu")
    port = state_from_reference(_ref_planes(st), device="cpu")
    total = 0
    for launch in range(max_launches):
        st, new_total = ref.run_from_state(st, total, total + CHUNK)
        run_chunk(tables, port, CHUNK, False)
        want = _ref_planes(st)
        _assert_planes(port.to_numpy(), want, f"launch {launch}")
        if new_total - total < CHUNK or not (want["trap"] == 0).any():
            return port, launch + 1
        total = new_total
    raise AssertionError("reference still running after max_launches")


@pytest.mark.parametrize(
    "case, lanes", [(c, LANES) for c in BULK_WARP_CASES]
    + [(c, n) for c in PARTIAL for n in (100, 99)])
def test_plain_interpreter_matches_simt_every_launch(case, lanes):
    func, args = bulk_warp_case(lanes, case)
    port, launches = _per_launch(func, args, lanes)
    assert launches >= 1
    _check_outcome(case, lanes, port.trap.numpy())
    if not case.endswith("oob_and_empty"):
        # the op ran: the plane moved from the page's data
        assert not np.array_equal(port.mem.numpy()[:, 0],
                                  _page_words(lanes)[:, 0])


def test_cases_shape_the_groups_the_pass_forms():
    """The fixtures give what their names say: one delta, two deltas in
    every warp, the out-of-bounds lane and the n == 0 lanes."""
    _, (dst, src, n) = bulk_warp_case(64, "copy_two_deltas")
    assert set((src - dst)[0::2]) == {-6} and set((src - dst)[1::2]) == {7}
    _, (dst, src, n) = bulk_warp_case(64, "copy_one_delta")
    assert set(src - dst) == {-6} and len(set(dst)) > 16 and len(set(n)) > 16
    for s in range(4):
        _, (dst, src, n) = bulk_warp_case(8, f"copy_bwd_shift{s}")
        assert (src - dst == -(12 + s)).all() and (n > 12 + s).all()
    _, (dst, _, n) = bulk_warp_case(64, "copy_oob_and_empty")
    assert (dst[[3, 35]] + n[[3, 35]] > 65536).all()
    assert (n[[5, 9, 37, 41]] == 0).all()


@pytest.mark.parametrize("case", ["copy_two_deltas", "fill_oob_and_empty",
                                  "copy_bwd_shift3"])
def test_end_of_run_matches_pallas_kernel(case):
    func, args = bulk_warp_case(LANES, case)
    data = build_bulk_warp()
    a = [np.asarray(x, np.int64) for x in args]
    want = _pallas_run(data, func, a, LANES)
    got = _port_run(data, func, a, LANES, steps_per_launch=4096)
    np.testing.assert_array_equal(got.trap, want.trap)
    if (want.trap == -1).all():
        np.testing.assert_array_equal(got.retired, want.retired)
    else:
        # ROADMAP.md §C2: with a lane trapping, Pallas counts 1 or 2 fewer
        assert ((got.retired - want.retired) >= 0).all()
        assert ((got.retired - want.retired) <= 2).all()
    done = want.trap == -1
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g[done], w[done])


@pytest.mark.cuda
@pytest.mark.parametrize("case, lanes", [
    ("copy_two_deltas", 64), ("copy_fwd_shift3", 100),
    ("fill_oob_and_empty", 99), ("copy_bwd_shift1", 64)])
def test_cuda_warp_pass_matches_plain_interpreter_every_launch(case, lanes):
    """On the card: the kernel's warp pass and the plain version from the
    same state, every plane after every launch, and the pass taken."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    conf = Configure()
    conf.batch.memory_pages_per_lane = 1
    mod = Validator(conf).validate(Loader(conf).parse_module(
        build_bulk_warp()))
    store = StoreManager()
    inst = instantiate(store, mod, conf)
    eng = BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                      device="cuda")
    func, args = bulk_warp_case(lanes, case)
    st = eng.initial_state(inst.exports[func][1], args)
    ref = st.clone()
    interp.bulk_counts(eng.tables, clear=True)
    for _ in range(100):
        interp.run_chunk(eng.tables, st, 64, False)
        interp_ref.run_chunk(eng.tables, ref, 64, False)
        _assert_same_state(st, ref)
        if not bool((st.trap == 0).any()):
            break
    torch.cuda.synchronize()
    assert interp.bulk_counts(eng.tables)["warp_passes"] > 0
