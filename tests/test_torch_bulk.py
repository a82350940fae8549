"""memory.fill and memory.copy on the port against the reference engines.

Per launch: the reference's image and initial state are carried into the
port and the reference SIMT engine and the port's plain interpreter run
launch by launch with every plane compared (tests/test_torch_interp.py's
`_per_launch`).  The cases cover aligned and unaligned destinations,
copies whose source lies -5, -1, 1, 3 and 6 bytes from the destination
(overlapping forward and backward), lane-dependent lengths, n == 0 at the
end of memory and past it, out-of-bounds fills and copies on some lanes
only, and fuel running out on the bulk instruction itself; the modules of
tests/test_pallas_engine.py's bulk-memory cases are among them.

End of run: results and traps against the reference Pallas kernel
(`PallasUniformEngine(..., interpret=True)`) and the scalar oracle; the
bulk workload of chip_smoke.py, cut down, against its bytearray model.

The CUDA kernel needs the card: its test is marked `cuda` and skips here.
"""

import numpy as np
import pytest
import torch

from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import TrapError
from wasmedge_tpu.common.types import typed_to_bits
from wasmedge_tpu_torch.batch import interp_ref
from wasmedge_tpu_torch.batch.engine import BatchEngine, BatchState
from wasmedge_tpu_torch.batch.interp import run_chunk
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import build_bulk_workload
from wasmedge_tpu_torch.models.fixtures import build_bulk_zoo, bulk_zoo_args
from wasmedge_tpu_torch.models.programs import bulk_workload_model
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.utils.builder import ModuleBuilder
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_interp import _pallas_run, _per_launch, _port_run

LANES = 8


def _fill_then_copy():
    """test_pallas_engine.py test_bulk_memory_fill_and_copy's module: a
    fill, a forward-overlapping copy by 2 bytes, and a window checksum."""
    b = ModuleBuilder()
    b.add_memory(1, 1)
    b.add_function(
        ("i32", "i32", "i32"), ("i32",), (),
        [("local.get", 0), ("local.get", 1), ("local.get", 2),
         ("memory.fill",),
         ("local.get", 0), ("i32.const", 2), ("i32.add",),
         ("local.get", 0), ("local.get", 2), ("memory.copy",),
         ("local.get", 0), ("i32.load", 0, 2),
         ("local.get", 0), ("i32.load", 0, 6), ("i32.add",),
         ("local.get", 0), ("i32.load8_u", 0, 11), ("i32.add",)],
        export="f")
    return b.build()


def _fill_then_copy_args(n):
    return [np.array([0, 8, 13, 100, 255, 1000, 4093, 64]),
            np.arange(n) + 0xA0, np.array([4, 9, 16, 3, 8, 32, 1, 64])]


def _fill_oob():
    """test_bulk_memory_oob_lanes's module: lane 1 fills past the end."""
    b = ModuleBuilder()
    b.add_memory(1, 1)
    b.add_function(("i32", "i32"), (), (),
                   [("local.get", 0), ("i32.const", 0x5A),
                    ("local.get", 1), ("memory.fill",)], export="f")
    return b.build()


def _fill_oob_args(n):
    return [np.array([0, 0xFFF0, 0, 4, 8, 12, 16, 20]),
            np.array([4, 0x20, 0, 4, 4, 4, 4, 4])]


def _copy_patterned():
    """test_memcopy_unaligned_overlap_in_kernel's module: 128 patterned
    bytes, one copy, the word at the destination."""
    b = ModuleBuilder()
    b.add_memory(1, 1)
    body = []
    for i in range(0, 128, 4):
        body += [("i32.const", i),
                 ("i32.const", (i * 0x01010101 + 0x0F1E2D3C) & 0x7FFFFFFF),
                 ("i32.store", 2, 0)]
    body += [("local.get", 0), ("local.get", 1), ("local.get", 2),
             ("memory.copy",), ("local.get", 0), ("i32.load", 0, 0)]
    b.add_function(("i32", "i32", "i32"), ("i32",), (), body, export="cp")
    return b.build()


def _copy_delta_args(delta):
    def args(n):
        dsts = 100 + np.arange(n)
        return [dsts, dsts + delta, np.array([1, 2, 3, 4, 7, 9, 16, 31])]
    return args


def _zoo(op, seed):
    return lambda n: bulk_zoo_args(n, op, seed)


# name: (module, export, lane args, lanes, fuel)
CASES = {
    "fill_zoo": (build_bulk_zoo, "fill", _zoo("fill", 1), 16, None),
    "copy_zoo": (build_bulk_zoo, "copy", _zoo("copy", 2), 16, None),
    # the bulk op is each lane's 4th instruction: fuel 4 runs out on it
    "fill_fuel_out": (build_bulk_zoo, "fill", _zoo("fill", 3), 16, 4),
    "copy_fuel_out": (build_bulk_zoo, "copy", _zoo("copy", 4), 16, 4),
    "fill_then_copy": (_fill_then_copy, "f", _fill_then_copy_args, LANES,
                       None),
    "fill_oob": (_fill_oob, "f", _fill_oob_args, LANES, None),
    **{f"copy_delta_{d}": (_copy_patterned, "cp", _copy_delta_args(d),
                           LANES, None)
       for d in (-5, -1, 1, 3, 6, 64, -64)},
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_interpreter_matches_simt_every_launch(case):
    build, func, args, lanes, fuel = CASES[case]
    port, launches = _per_launch(build(), func, args(lanes), lanes, fuel)
    trap = port.trap.numpy()
    if fuel is not None:
        # the in-bounds lanes ran the op (and wrote) before fuel ran out
        oob = trap == int(ErrCode.MemoryOutOfBounds)
        assert oob.any() and (trap[~oob] ==
                              int(ErrCode.CostLimitExceeded)).all()
        assert (port.retired.numpy() == 4).all()
    elif case.endswith("zoo"):
        assert (trap == int(ErrCode.MemoryOutOfBounds)).any()
        assert (trap == -1).sum() >= lanes // 2
    elif case == "fill_oob":
        assert trap[1] == int(ErrCode.MemoryOutOfBounds)


@pytest.mark.parametrize("case", ["fill_zoo", "copy_zoo", "fill_then_copy",
                                  "fill_oob", "copy_delta_-5",
                                  "copy_delta_3"])
def test_end_of_run_matches_pallas_and_scalar(case):
    build, func, args, lanes, _ = CASES[case]
    data, a = build(), [np.asarray(x, np.int64) for x in args(lanes)]
    want = _pallas_run(data, func, a, lanes)
    got = _port_run(data, func, a, lanes, steps_per_launch=4096)
    np.testing.assert_array_equal(got.trap, want.trap)
    done = want.trap == -1
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g[done], w[done])
    for lane in range(lanes):
        ex, store, inst = ref_instantiate(data, RefConfigure())
        fi = inst.find_func(func)
        try:
            out = ex.invoke(store, fi, [int(x[lane]) for x in a])
        except TrapError as te:
            assert got.trap[lane] == int(te.code), lane
            continue
        assert got.trap[lane] == -1, lane
        for r, (t, v) in enumerate(zip(fi.functype.results, out)):
            assert int(got.results[r][lane]) & (2**64 - 1) == \
                typed_to_bits(t, v), lane


SMALL_BULK = dict(fill_bytes=700, copy_bytes=300, fold_words=300)


def test_bulk_workload_matches_bytearray_model():
    lanes, iters = 6, 3
    seeds = np.arange(lanes) * 37 + 5
    res = _port_run(build_bulk_workload(**SMALL_BULK), "bulk",
                    [seeds, np.full(lanes, iters)], lanes,
                    steps_per_launch=4096)
    assert (res.trap == -1).all()
    want, _ = bulk_workload_model(seeds, iters, **SMALL_BULK)
    assert ((res.results[0] & 0xFFFFFFFF) == want).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fill_zoo", "copy_zoo", "fill_fuel_out",
                                  "bulk_workload"])
def test_cuda_kernel_matches_plain_interpreter_every_launch(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if case == "bulk_workload":
        build, func, fuel = (lambda: build_bulk_workload(**SMALL_BULK),
                             "bulk", None)
        args = lambda n: [np.arange(n) * 37 + 5, 3]
    else:
        build, func, args, _, fuel = CASES[case]
    conf = Configure()
    conf.batch.fuel_per_launch = fuel
    mod = Validator(conf).validate(Loader(conf).parse_module(build()))
    store = StoreManager()
    inst = instantiate(store, mod, conf)
    eng = BatchEngine(inst, store=store, conf=conf, lanes=64, device="cuda")
    st = eng.initial_state(inst.exports[func][1], args(64))
    ref = st.clone()
    for _ in range(100):
        run_chunk(eng.tables, st, 64, fuel is not None)
        interp_ref.run_chunk(eng.tables, ref, 64, fuel is not None)
        for f in BatchState.FIELDS:
            assert torch.equal(getattr(st, f), getattr(ref, f)), f
        if not bool((st.trap == 0).any()):
            break
