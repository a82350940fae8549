"""B2 fused basic blocks: the port's plain engine against the reference, launch by launch.

The reference's image and initial state are carried into the port
(`wasmedge_tpu_torch.batch.convert`); the reference SIMT
`BatchEngine.run_from_state` (superinstruction fusion and tier-up off, so
one step is one instruction) and the port's plain interpreter with the
"blocks" encoding each run one launch, and after every launch every plane
must be equal (pc, sp, fp, opbase, call_depth, trap, retired, fuel,
mem_pages, frames, globals, memory), the stack planes in the rows below
each lane's sp: a fused block does not write the cells that die inside it,
which the per-op step writes above the final sp.  Small `steps_per_launch`
values (7, 13, 64) end launches inside blocks, and fuel and step budgets
that end one op before, at and one op after a block's last op hold the
port's rule that a fused dispatch runs only when the budget covers it.

The CUDA kernel needs the card: its test is marked `cuda` and skips here
(`chip_smoke.py` runs the full set at 256 lanes, all rows compared).
"""

import numpy as np
import pytest
import torch

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu_torch.batch import interp_ref
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import BatchState
from wasmedge_tpu_torch.batch.interp import (
    LAUNCHES, device_tables, run_chunk)
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.models import (
    build_coremark_kernel, build_fac, build_fib, build_loop_sum,
    build_memory_workload)
from wasmedge_tpu_torch.models.fixtures import (
    ZOO_CASES, build_guard_mix, build_oob_mix, build_trap_zoo, oob_args,
    zoo_args)
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_interp import _image_of, _ref_conf, _ref_planes

STACK_PLANES = ("stack_lo", "stack_hi", "stack_e2", "stack_e3")


def assert_live_planes(got: dict, want: dict, where: str):
    """Every plane equal; the stack planes in the rows below each lane's
    sp (sp itself equal first)."""
    np.testing.assert_array_equal(got["sp"], want["sp"], err_msg=where)
    live = np.arange(want["stack_lo"].shape[0])[:, None] < want["sp"][None]
    for f in BatchState.FIELDS:
        assert (got[f] is None) == (want[f] is None), f"plane {f}, {where}"
        if want[f] is None:
            continue
        if f in STACK_PLANES:
            np.testing.assert_array_equal(got[f][live], want[f][live],
                                          err_msg=f"plane {f}, {where}")
        else:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"plane {f}, {where}")


def per_launch(fusion, data, func, args, chunk, fuel=None,
               max_launches=3000):
    """The reference and the port's plain engine (encoding `fusion`) from
    the same image and state, one launch each; the live planes equal
    after every launch.  Returns (port state, tables, launches)."""
    conf = _ref_conf(fuel, chunk)
    _, store, inst = ref_instantiate(data, conf)
    lanes = len(np.asarray(args[0]))
    ref = RefEngine(inst, store=store, conf=conf, lanes=lanes)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    tables = device_tables(_image_of(ref.img), "cpu", fusion)
    port = state_from_reference(_ref_planes(st), device="cpu")
    total = 0
    for launch in range(max_launches):
        st, new_total = ref.run_from_state(st, total, total + chunk)
        run_chunk(tables, port, chunk, fuel is not None)
        want = _ref_planes(st)
        assert_live_planes(port.to_numpy(), want, f"launch {launch}")
        if new_total - total < chunk or not (want["trap"] == 0).any():
            return port, tables, launch + 1
        total = new_total
    raise AssertionError("reference still running after max_launches")


# name -> (module, export, lane args, steps per launch, fuel)
CASES = {
    "fib_converged": (build_fib, "fib", [np.full(8, 9)], 7, None),
    "fib_divergent": (build_fib, "fib", [np.arange(12) % 8 + 2], 13, None),
    "fib_fuel": (build_fib, "fib", [np.arange(12) % 8 + 3], 64, 300),
    "fac_i64": (build_fac, "fac", [np.arange(8) * 3], 7, None),
    "loop_sum": (build_loop_sum, "loop_sum", [np.arange(8) * 5], 13, None),
    "mem_checksum": (build_memory_workload, "mem_checksum",
                     [np.arange(8) * 9 + 1], 64, None),
    "coremark": (build_coremark_kernel, "coremark", [np.arange(8) * 3 + 1],
                 13, None),
    "trap_zoo": (build_trap_zoo, "zoo", zoo_args(ZOO_CASES), 7, None),
    "guard_mix": (build_guard_mix, "guard",
                  [np.arange(12) * 5 - 3, np.arange(12) % 7 + 1], 13, None),
    "oob_mix": (build_oob_mix, "oob", oob_args(14, 1), 7, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_match_simt_every_launch(case):
    build, func, args, chunk, fuel = CASES[case]
    port, tables, launches = per_launch("blocks", build(), func, args, chunk,
                                        fuel)
    assert tables.shapes and launches >= 1
    trap = port.trap.numpy()
    if fuel is not None:
        assert (trap == int(ErrCode.CostLimitExceeded)).any()
    elif case == "oob_mix":
        assert (trap == int(ErrCode.MemoryOutOfBounds)).sum() >= 6
        assert (trap == -1).sum() >= 4
    elif case != "trap_zoo":
        assert (trap == -1).all()


def _entry_block_len(data, func):
    """The fused length of the block at the export's entry."""
    conf = _ref_conf(None, 64)
    _, store, inst = ref_instantiate(data, conf)
    ref = RefEngine(inst, store=store, conf=conf, lanes=1)
    img = _image_of(ref.img)
    tables = device_tables(img, "cpu", "blocks")
    entry = int(ref.inst.lowered.funcs[ref.export_func_idx(func)].entry_pc)
    return int(tables.flen[entry])


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("budget", ["chunk", "fuel"])
def test_budget_edges_at_a_block_end(budget, delta):
    """A launch (or the fuel) that ends one op before, at and one op after
    the last op of the entry block: the block runs fused only when the
    budget covers it (fuel: when more than its length is left), and the
    state is the per-op state either way."""
    data = build_guard_mix()
    n = _entry_block_len(data, "guard")
    assert n >= 5
    args = [np.arange(6) * 5 - 3, np.arange(6) % 3 + 1]
    if budget == "chunk":
        per_launch("blocks", data, "guard", args, n + delta)
    else:
        port, _, _ = per_launch("blocks", data, "guard", args, 64,
                                fuel=n + delta)
        assert (port.trap.numpy() == int(ErrCode.CostLimitExceeded)).all()


def test_engine_picks_the_encoding():
    """block_fusion None or True: blocks; False: superinstructions without
    v128 ops, one op per dispatch with them."""
    from wasmedge_tpu_torch.models import build_simd_loop
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.executor.instantiate import instantiate
    from wasmedge_tpu_torch.loader import Loader
    from wasmedge_tpu_torch.runtime.store import StoreManager
    from wasmedge_tpu_torch.validator import Validator

    def engine(data, bf):
        conf = Configure()
        conf.batch.value_stack_depth, conf.batch.call_stack_depth = 64, 16
        if bf != "default":
            conf.batch.block_fusion = bf
        mod = Validator(conf).validate(Loader(conf).parse_module(data))
        inst = instantiate(StoreManager(), mod, conf)
        return BatchEngine(inst, conf=conf, lanes=4, device="cpu")

    for data, simd in ((build_fib(), False), (build_simd_loop(), True)):
        for bf, want in (("default", "blocks"), (None, "blocks"),
                         (True, "blocks"),
                         (False, "none" if simd else "super")):
            eng = engine(data, bf)
            assert eng.fusion == want == eng.tables.fusion, (simd, bf)
    # the plain version counts no launch
    before = dict(LAUNCHES)
    res = engine(build_fib(), None).run("fib", [np.full(4, 12)])
    assert (res.results[0] == 144).all() and LAUNCHES == before


@pytest.mark.cuda
def test_cuda_blocks_match_plain_every_launch_all_rows():
    """On the card: the module's fused kernel and the plain version from
    the same state, launch by launch, every plane and every stack row
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tests.test_torch_interp import _assert_same_state
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.executor.instantiate import instantiate
    from wasmedge_tpu_torch.loader import Loader
    from wasmedge_tpu_torch.runtime.store import StoreManager
    from wasmedge_tpu_torch.validator import Validator

    conf = Configure()
    conf.batch.value_stack_depth, conf.batch.call_stack_depth = 64, 32
    conf.batch.memory_pages_per_lane = 3
    for data, func, args in (
            (build_trap_zoo(), "zoo", zoo_args(64)),
            (build_guard_mix(), "guard", [np.arange(64) * 5 - 3,
                                          np.arange(64) % 7 + 1]),
            (build_oob_mix(), "oob", oob_args(64, 1))):
        mod = Validator(conf).validate(Loader(conf).parse_module(data))
        inst = instantiate(StoreManager(), mod, conf)
        eng = BatchEngine(inst, conf=conf, lanes=64, device="cuda")
        assert eng.tables.fusion == "blocks"
        st = eng.initial_state(inst.exports[func][1], args)
        ref = st.clone()
        for _ in range(300):
            run_chunk(eng.tables, st, 13, False)
            interp_ref.run_chunk(eng.tables, ref, 13, False)
            _assert_same_state(st, ref)
            if not bool((st.trap == 0).any()):
                break
