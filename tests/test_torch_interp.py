"""The port's warp-interpreter against the reference engines.

Per launch: the reference's image and initial state are carried into the
port (`wasmedge_tpu_torch.batch.convert`), then the reference SIMT
`BatchEngine.run_from_state` (superinstruction fusion and tier-up off, so
one step is one instruction) and the port's plain interpreter each run
one launch of `CHUNK` steps, and every plane (pc, sp, fp, opbase,
call_depth, trap, retired, fuel, mem_pages, stacks, frames, globals,
memory) must be bit-identical after every launch.

End of run: results and traps must equal the reference Pallas kernel
(`PallasUniformEngine(..., interpret=True)`), and the ALU module's
results and traps must equal the scalar oracle lane by lane.

The CUDA kernel itself needs the card: its test is marked `cuda` and
skips here.
"""

import numpy as np
import pytest
import torch

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import TrapError
from wasmedge_tpu.common.types import typed_to_bits
from wasmedge_tpu_torch.batch import interp_ref
from wasmedge_tpu_torch.batch.convert import (
    image_from_reference, state_from_reference)
from wasmedge_tpu_torch.batch.engine import BatchEngine, BatchState
from wasmedge_tpu_torch.batch.image import DeviceImage
from wasmedge_tpu_torch.batch.interp import device_tables, run_chunk
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import (
    build_coremark_kernel, build_fac, build_fib, build_loop_sum,
    build_memory_workload)
from wasmedge_tpu_torch.models.fixtures import (
    ZOO_CASES, alu_args, build_alu_edge, build_trap_zoo, zoo_args)
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate

CHUNK = 64
D, CD, PAGES = 64, 32, 3


def _ref_conf(fuel=None, chunk=CHUNK):
    conf = RefConfigure()
    b = conf.batch
    b.steps_per_launch = chunk
    b.value_stack_depth, b.call_stack_depth = D, CD
    b.memory_pages_per_lane = PAGES
    b.fuse_superinstructions = False
    b.tierup = False
    b.fuel_per_launch = fuel
    return conf


def _image_of(ref_img) -> DeviceImage:
    planes = {f: getattr(ref_img, f) for f in DeviceImage.NUMPY_FIELDS}
    scalars = {f: getattr(ref_img, f) for f in DeviceImage.SCALAR_FIELDS}
    return image_from_reference(planes, scalars)


def _ref_planes(st) -> dict:
    """The reference state's planes as numpy (None where it has none:
    stack_e2 / stack_e3 of an image without v128 ops)."""
    return {f: None if getattr(st, f) is None else np.asarray(getattr(st, f))
            for f in BatchState.FIELDS}


def _assert_planes(got: dict, want: dict, where: str):
    """Every plane equal, and the optional planes absent on both sides
    alike."""
    for f in BatchState.FIELDS:
        assert (got[f] is None) == (want[f] is None), f"plane {f}, {where}"
        if want[f] is not None:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"plane {f}, {where}")


def _assert_same_state(a, b):
    """Two port states (on any device) equal plane by plane."""
    pa, pb = a.planes(), b.planes()
    assert pa.keys() == pb.keys()
    for f in pa:
        assert torch.equal(pa[f], pb[f]), f


def _per_launch(data, func, args, lanes, fuel=None, max_launches=400):
    """Run both engines launch by launch; assert every plane equal after
    each launch.  Returns the final port state and the launch count."""
    conf = _ref_conf(fuel)
    _, store, inst = ref_instantiate(data, conf)
    ref = RefEngine(inst, store=store, conf=conf, lanes=lanes)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    tables = device_tables(_image_of(ref.img), "cpu")
    port = state_from_reference(_ref_planes(st), device="cpu")
    total = 0
    for launch in range(max_launches):
        st, new_total = ref.run_from_state(st, total, total + CHUNK)
        run_chunk(tables, port, CHUNK, fuel is not None)
        _assert_planes(port.to_numpy(), _ref_planes(st), f"launch {launch}")
        want = _ref_planes(st)
        if new_total - total < CHUNK or not (want["trap"] == 0).any():
            return port, launch + 1
        total = new_total
    raise AssertionError("reference still running after max_launches")


def _fib_mix(lanes):
    return [np.arange(lanes) % 11 + 3]


CASES = {
    "fib_converged": (build_fib, "fib", lambda n: [np.full(n, 10)], 8, None),
    "fib_divergent": (build_fib, "fib", _fib_mix, 16, None),
    "fib_fuel": (build_fib, "fib", _fib_mix, 16, 300),
    "fac_i64": (build_fac, "fac", lambda n: [np.arange(n) * 3], 8, None),
    "loop_sum": (build_loop_sum, "loop_sum",
                 lambda n: [np.arange(n) * 7], 8, None),
    "mem_checksum": (build_memory_workload, "mem_checksum",
                     lambda n: [np.arange(n) * 9 + 1], 8, None),
    "coremark": (build_coremark_kernel, "coremark",
                 lambda n: [np.arange(n) * 5 + 1], 8, None),
    "trap_zoo": (build_trap_zoo, "zoo", lambda n: zoo_args(n), ZOO_CASES,
                 None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_interpreter_matches_simt_every_launch(case):
    build, func, args, lanes, fuel = CASES[case]
    port, launches = _per_launch(build(), func, args(lanes), lanes, fuel)
    assert launches >= 1
    trap = port.trap.numpy()
    if fuel is not None:
        assert (trap == int(ErrCode.CostLimitExceeded)).any()
        assert (trap == -1).any()
    elif case == "trap_zoo":
        _assert_zoo_outcomes(port)
    else:
        assert (trap == -1).all()


def _assert_zoo_outcomes(port):
    """The zoo's lanes end in each trap of the slice, and memory.grow
    reaches the ceiling and then fails (grow_all: 2 grows, 3 pages)."""
    trap = port.trap.numpy()
    want = {0: ErrCode.DivideByZero, 1: ErrCode.IntegerOverflow,
            2: ErrCode.MemoryOutOfBounds, 3: ErrCode.CallStackExhausted,
            4: ErrCode.Unreachable, 5: ErrCode.IndirectCallTypeMismatch,
            6: ErrCode.UndefinedElement, 7: ErrCode.UninitializedElement,
            10: ErrCode.InvalidConvToInt, 11: ErrCode.StackOverflow}
    for k, code in want.items():
        assert trap[k] == int(code), k
    assert trap[8] == -1 and port.stack_lo[0, 8].item() == 203
    assert port.mem_pages[8].item() == 3
    assert trap[9] == -1 and trap[12] == -1


def _pallas_run(data, func, args, lanes, fuel=None):
    """The reference Pallas kernel in interpret mode: the careful kernel
    (K with its B1 handlers) without basic-block fusion, driven by the
    block scheduler with its SIMT residue."""
    from wasmedge_tpu.batch.pallas_engine import PallasUniformEngine

    conf = RefConfigure()
    b = conf.batch
    b.steps_per_launch = 50_000
    b.value_stack_depth, b.call_stack_depth = D, CD
    b.memory_pages_per_lane = PAGES
    b.fuel_per_launch = fuel
    b.optimistic = False
    b.block_fusion = False
    b.fuse_superinstructions = False
    b.tierup = False
    _, store, inst = ref_instantiate(data, conf)
    eng = PallasUniformEngine(inst, store=store, conf=conf, lanes=lanes,
                              interpret=True)
    return eng.run(func, [np.asarray(a, np.int64) for a in args])


def _port_run(data, func, args, lanes, **knobs):
    conf = Configure()
    conf.batch.value_stack_depth, conf.batch.call_stack_depth = D, CD
    conf.batch.memory_pages_per_lane = PAGES
    for k, v in knobs.items():
        setattr(conf.batch, k, v)
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    store = StoreManager()
    inst = instantiate(store, mod, conf)
    eng = BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                      device="cpu")
    return eng.run(func, [np.asarray(a, np.int64) for a in args])


PALLAS_CASES = {
    "converged": (build_fib, "fib", [np.full(8, 10)], 8, None),
    "divergent": (build_fib, "fib", _fib_mix(16), 16, None),
    "fuel": (build_fib, "fib", [np.arange(8) % 4 + 8], 8, 600),
    "traps_and_grow": (build_trap_zoo, "zoo", zoo_args(ZOO_CASES),
                       ZOO_CASES, None),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_end_of_run_matches_pallas_kernel(case):
    build, func, args, lanes, fuel = PALLAS_CASES[case]
    want = _pallas_run(build(), func, args, lanes, fuel)
    got = _port_run(build(), func, args, lanes, steps_per_launch=4096,
                    fuel_per_launch=fuel)
    np.testing.assert_array_equal(got.trap, want.trap)
    done = want.trap == -1
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g[done], w[done])
    if case == "converged":
        # per-lane retired agrees on converged runs; the reference's
        # block-scheduler handoff undercounts divergent ones, so there
        # `retired` is held against BatchEngine (the per-launch tests)
        np.testing.assert_array_equal(got.retired, want.retired)


def test_alu_module_matches_scalar_oracle():
    """Every ALU op, edge operands including subnormals, lane by lane
    against the reference's scalar interpreter (IEEE binary32/64)."""
    data = build_alu_edge()
    lanes = 24
    x, y = alu_args(lanes, seed=3)
    for func in ("alu", "alu_traps"):
        res = _port_run(data, func, [x, y], lanes, steps_per_launch=100_000)
        for lane in range(lanes):
            ex, store, inst = ref_instantiate(data, RefConfigure())
            fi = inst.find_func(func)
            try:
                out = ex.invoke(store, fi, [int(x[lane]), int(y[lane])])
            except TrapError as te:
                assert res.trap[lane] == int(te.code), (func, lane)
                continue
            assert res.trap[lane] == -1, (func, lane, res.trap[lane])
            want = typed_to_bits(fi.functype.results[0], out[0])
            assert int(res.results[0][lane]) & (2**64 - 1) == want, \
                (func, lane)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_interpreter_every_launch():
    """On the card: the kernel and the plain interpreter from the same
    state, launch by launch, every plane equal (chip_smoke.py runs the
    full set at 256 lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    conf = Configure()
    conf.batch.value_stack_depth, conf.batch.call_stack_depth = D, CD
    conf.batch.memory_pages_per_lane = PAGES
    mod = Validator(conf).validate(Loader(conf).parse_module(build_trap_zoo()))
    store = StoreManager()
    inst = instantiate(store, mod, conf)
    eng = BatchEngine(inst, store=store, conf=conf, lanes=64, device="cuda")
    st = eng.initial_state(inst.exports["zoo"][1], zoo_args(64))
    ref = st.clone()
    for _ in range(50):
        run_chunk(eng.tables, st, CHUNK, False)
        interp_ref.run_chunk(eng.tables, ref, CHUNK, False)
        _assert_same_state(st, ref)
        if not bool((st.trap == 0).any()):
            break
