"""v128 on the port's warp-interpreter against the reference engines.

Per launch: the reference's image and initial state are carried into the
port, then the reference SIMT `BatchEngine.run_from_state` (fusion and
tier-up off) and the port's plain interpreter each run one launch, and
every plane, the v128 words `stack_e2` / `stack_e3` included, must be
bit-identical after every launch: vmix, vloop at small n, the v128 memory
zoo, the v128 control module, fuel running out on a v128 op and on a
v128.store, and a module that keeps v128 words under a host call's frame
(one serve round per call, the reference's host-call test harness).

End of run: results and traps equal the reference Pallas kernel
(`PallasUniformEngine(..., interpret=True)`) on vmix, and every sweep
module (together every batchable v128 op) and every fixture equal the
scalar oracle lane by lane, with random and corner-byte operands.

The CUDA kernel needs the card: its test is marked `cuda` and skips
here (chip_smoke.py runs the same fixtures at 256 lanes).
"""

import numpy as np
import pytest
import torch

from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import TrapError
from wasmedge_tpu.common.types import typed_to_bits
from wasmedge_tpu_torch.batch import interp_ref
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.image import batchability
from wasmedge_tpu_torch.batch.interp import (
    H_VSTORE, device_tables, run_chunk)
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import build_simd_loop
from wasmedge_tpu_torch.models.fixtures import (
    build_simd_host, build_simd_sweep, build_v128_control,
    build_v128_mem_zoo, build_vmix, simd_sweep_args, simd_sweeps,
    v128_zoo_args)
from wasmedge_tpu_torch.models.programs import simd_loop_model
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_hostcall import _env_import
from tests.test_torch_hostcall import _per_launch as _per_launch_served
from tests.test_torch_interp import (
    D, CD, PAGES, _assert_same_state, _pallas_run, _per_launch, _port_run)

SWEEPS = simd_sweeps()


def _ctl_args(n):
    return [np.arange(n, dtype=np.int64) * 0x123456789 - 7,
            np.arange(n) * 5 + 3]


def _wrap_args(n):
    return [np.resize(np.array([0, 4, 7, 8, 9, 16, 0x20, -16]), n),
            np.arange(n) * 11]


CASES = {
    "vmix": (build_vmix, "vmix", lambda n: [np.arange(n) % 7 + 3], 8),
    "vloop": (build_simd_loop, "vloop", lambda n: [np.arange(n) * 5 % 37],
              8),
    "mem_zoo": (build_v128_mem_zoo, "rw", lambda n: v128_zoo_args(n, 5),
                18),
    "mem_zoo_carry": (build_v128_mem_zoo, "wrap", _wrap_args, 8),
    "control": (build_v128_control, "ctl", _ctl_args, 16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_interpreter_matches_simt_every_launch(case):
    build, func, args, lanes = CASES[case]
    port, launches = _per_launch(build(), func, args(lanes), lanes)
    assert launches >= 1 and port.stack_e2 is not None
    trap = port.trap.numpy()
    if case == "mem_zoo":
        # the last six addresses are out of bounds: 65515 on the second
        # store, 65520 / 65530 / 65533 on the first load, -1 and -8 on a
        # carry in addr + offset
        oob = np.resize(np.arange(18) >= 12, lanes)
        assert (trap[oob] == int(ErrCode.MemoryOutOfBounds)).all()
        assert (trap[~oob] == -1).all()
    elif case == "mem_zoo_carry":
        assert (trap == int(ErrCode.MemoryOutOfBounds)).all()
    else:
        assert (trap == -1).all()
    if case == "vloop":
        ns = args(lanes)[0]
        got = port.stack_lo[0].numpy().view(np.uint32)
        assert [int(g) for g in got] == [simd_loop_model(int(n)) for n in ns]


def _first_step_at(build, func, args, lanes, hid):
    """Steps before lane 0 first reaches handler `hid` (plain engine)."""
    eng, inst = _port_engine(build())
    eng.lanes = lanes
    st = eng.initial_state(inst.exports[func][1], args)
    for step in range(10_000):
        if int(eng.tables.hid[int(st.pc[0])]) == hid:
            return step
        interp_ref.run_chunk(eng.tables, st, 1, False)
    raise AssertionError("handler never reached")


def _port_inst(data):
    conf = Configure()
    conf.batch.value_stack_depth, conf.batch.call_stack_depth = D, CD
    conf.batch.memory_pages_per_lane = PAGES
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    store = StoreManager()
    return conf, store, instantiate(store, mod, conf)


def _port_engine(data, lanes=8):
    conf, store, inst = _port_inst(data)
    return BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                       device="cpu"), inst


@pytest.mark.parametrize("where", ["v128.const", "v128.store"])
def test_fuel_runs_out_on_a_v128_op(where):
    """With fuel for exactly the instructions up to it, every lane runs out
    on vmix's first instruction (v128.const) or on the memory zoo's first
    v128.store: the op's effects stay, the control state does not move."""
    if where == "v128.const":
        build, func, args, lanes, fuel = (
            build_vmix, "vmix", [np.arange(8) + 2], 8, 1)
    else:
        args = v128_zoo_args(8, 3)
        build, func, lanes = build_v128_mem_zoo, "rw", 8
        fuel = _first_step_at(build, func, args, lanes, H_VSTORE) + 1
    port, _ = _per_launch(build(), func, args, lanes, fuel=fuel)
    assert (port.trap.numpy() == int(ErrCode.CostLimitExceeded)).all()
    assert (port.retired.numpy() == fuel).all()


def test_host_call_over_v128_words_matches_simt_every_serve_round():
    """The serve round writes the host result's lo / hi only; the v128
    words left in that row travel on through return, as in the
    reference."""
    x = np.arange(16) * 9 - 20
    port, _, _, calls = _per_launch_served(
        build_simd_host(), "f", [x], 16, [_env_import("ref")],
        [_env_import("port")])
    assert calls >= 2
    assert (port.trap.numpy() == -1).all()
    want = (x * 2 & 0xFFFFFFFF) + ((x & 0xFFFFFFFF) << 32 | (x & 0xFFFFFFFF))
    got = port.stack_lo[0].numpy().view(np.uint32).astype(np.uint64) | (
        port.stack_hi[0].numpy().view(np.uint32).astype(np.uint64) << 32)
    np.testing.assert_array_equal(got, want.astype(np.uint64))
    # the rows under the call held v128 words: e2/e3 are not all zero
    assert bool((port.stack_e2 != 0).any())


def test_end_of_run_matches_pallas_kernel():
    """vmix on the reference Pallas kernel in interpret mode (its v128
    handlers and unaligned v128 memory), results and traps (its per-lane
    `retired` undercounts divergent lanes, ROADMAP C2: the per-launch
    tests hold `retired` against BatchEngine)."""
    args = [np.arange(8) % 5 + 9]
    want = _pallas_run(build_vmix(), "vmix", args, 8)
    got = _port_run(build_vmix(), "vmix", args, 8, steps_per_launch=4096)
    np.testing.assert_array_equal(got.trap, want.trap)
    np.testing.assert_array_equal(got.results[0], want.results[0])


def _oracle_check(data, func, args, lanes):
    res = _port_run(data, func, args, lanes, steps_per_launch=100_000)
    for lane in range(lanes):
        ex, store, inst = ref_instantiate(data, RefConfigure())
        fi = inst.find_func(func)
        try:
            out = ex.invoke(store, fi, [int(a[lane]) for a in args])
        except TrapError as te:
            assert res.trap[lane] == int(te.code), (func, lane)
            continue
        assert res.trap[lane] == -1, (func, lane, res.trap[lane])
        want = typed_to_bits(fi.functype.results[0], out[0])
        assert int(res.results[0][lane]) & (2**64 - 1) == want, (func, lane)


@pytest.mark.parametrize("corners", [False, True], ids=["random", "corners"])
@pytest.mark.parametrize("sweep", list(SWEEPS))
def test_sweep_matches_scalar_oracle(sweep, corners):
    data = build_simd_sweep(SWEEPS[sweep])
    _oracle_check(data, "f", simd_sweep_args(8, 11, corners), 8)


@pytest.mark.parametrize("case", list(CASES))
def test_fixture_matches_scalar_oracle(case):
    build, func, args, lanes = CASES[case]
    _oracle_check(build(), func, args(lanes), lanes)


def test_batchable_v128_set_is_admitted_and_the_rest_refused():
    """Every op of SUPPORTED_V128 runs (the sweeps, vmix and the memory
    zoo hold them all); the v128 forms the reference does not batch are
    refused by name."""
    from wasmedge_tpu_torch.batch.simdops import SUPPORTED_V128
    from wasmedge_tpu_torch.common.opcodes import OPCODES, name_of

    seen = set()
    for data in [build_simd_sweep(b) for b in SWEEPS.values()] + [
            build_vmix(), build_v128_mem_zoo()]:
        eng, inst = _port_engine(data)
        lowered = inst.lowered
        seen |= {name_of(op) for op in lowered.op[:lowered.code_len]
                 if op < len(OPCODES)}  # not the lowered branch forms
        assert eng.img.has_simd and eng.tables.has_simd
    assert SUPPORTED_V128 <= seen
    from wasmedge_tpu_torch.utils.wat import parse_wat

    for op in ("v128.load8x8_s", "v128.load32_splat", "v128.load64_zero"):
        data = parse_wat(f"""(module (memory 1) (func (export "f")
            (drop ({op} (i32.const 0)))))""")
        _, _, inst = _port_inst(data)
        assert batchability(inst.lowered) == f"unsupported op {op}"
        with pytest.raises(ValueError, match=op):
            _port_engine(data)


def test_images_without_v128_keep_two_planes():
    from wasmedge_tpu_torch.models import build_fib

    eng, inst = _port_engine(build_fib())
    st = eng.initial_state(inst.exports["fib"][1], [np.full(8, 5)])
    assert not eng.tables.has_simd
    assert st.stack_e2 is None and st.stack_e3 is None
    assert set(st.planes()) == set(st.FIELDS) - {"stack_e2", "stack_e3"}
    clone = st.clone()
    assert clone.stack_e2 is None and st.to_numpy()["stack_e3"] is None


SIMD_FIXTURES = {**{f"sweep_{k}": (lambda k=k: build_simd_sweep(SWEEPS[k]),
                                   "f", lambda n: simd_sweep_args(n, 7))
                    for k in SWEEPS},
                 **{k: (v[0], v[1], v[2]) for k, v in CASES.items()}}


@pytest.mark.cuda
@pytest.mark.parametrize("fixture", list(SIMD_FIXTURES))
def test_cuda_kernel_matches_plain_interpreter_every_launch(fixture):
    """On the card: the kernel's kSimd instantiation and the plain
    interpreter from the same state, launch by launch, every plane (e2
    and e3 included) equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    build, func, args = SIMD_FIXTURES[fixture]
    eng, inst = _port_engine(build(), lanes=64)
    eng.device = torch.device("cuda")
    eng.tables = device_tables(eng.img, eng.device)
    st = eng.initial_state(inst.exports[func][1], args(64))
    ref = st.clone()
    for _ in range(200):
        run_chunk(eng.tables, st, 64, False)
        interp_ref.run_chunk(eng.tables, ref, 64, False)
        _assert_same_state(st, ref)
        if not bool((st.trap == 0).any()):
            break
