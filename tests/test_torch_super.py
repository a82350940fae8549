"""B6 superinstructions: the port's plain engine against the reference, launch by launch.

As `test_torch_blocks.py`, with the "super" encoding (the peephole
families GCA, GCB, GCC, A2R, GCS, GGA, GGS, GGBZ, GGBNZ and GBR of
`batch/fusion.py` `fuse_image`): after every launch every plane equals the
reference SIMT `BatchEngine`'s, the stack planes in the rows below each
lane's sp.  Each module below holds several of the families; the test
checks that together they hold all ten.
"""

import numpy as np
import pytest

from wasmedge_tpu_torch.batch.fusion import super_family
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.models import (
    build_coremark_kernel, build_fac, build_fib, build_loop_sum,
    build_memory_workload)
from wasmedge_tpu_torch.models.fixtures import (
    ZOO_CASES, build_guard_mix, build_oob_mix, build_trap_zoo, oob_args,
    zoo_args)
from tests.test_torch_blocks import per_launch

CASES = {
    "fib_converged": (build_fib, "fib", [np.full(8, 9)], 13, None),
    "fib_divergent": (build_fib, "fib", [np.arange(12) % 8 + 2], 7, None),
    "fib_fuel": (build_fib, "fib", [np.arange(12) % 8 + 3], 64, 301),
    "fac_i64": (build_fac, "fac", [np.arange(8) * 3], 13, None),
    "loop_sum": (build_loop_sum, "loop_sum", [np.arange(8) * 5], 7, None),
    "mem_checksum": (build_memory_workload, "mem_checksum",
                     [np.arange(8) * 9 + 1], 13, None),
    "coremark": (build_coremark_kernel, "coremark", [np.arange(8) * 3 + 1],
                 64, None),
    "trap_zoo": (build_trap_zoo, "zoo", zoo_args(ZOO_CASES), 13, None),
    "guard_mix": (build_guard_mix, "guard",
                  [np.arange(12) * 5 - 3, np.arange(12) % 7 + 1], 7, None),
    "oob_mix": (build_oob_mix, "oob", oob_args(14, 2), 13, None),
}

_SEEN = set()


@pytest.mark.parametrize("case", list(CASES))
def test_super_match_simt_every_launch(case):
    build, func, args, chunk, fuel = CASES[case]
    port, tables, launches = per_launch("super", build(), func, args, chunk,
                                        fuel)
    fams = {super_family(h)[0] for h in set(tables.hid.tolist())
            if super_family(h)}
    assert fams, "no superinstruction in the module"
    _SEEN.update(fams)
    trap = port.trap.numpy()
    if fuel is not None:
        assert (trap == int(ErrCode.CostLimitExceeded)).any()
    elif case not in ("trap_zoo", "oob_mix"):
        assert (trap == -1).all()


def test_the_modules_hold_all_ten_families():
    from wasmedge_tpu_torch.batch.fusion import SUPER_LEN
    from wasmedge_tpu_torch.batch.interp import H_FUSE_GBR, device_tables
    from tests.test_torch_fusion import _image_of, _ref_image

    fams = set()
    for name in ("fib", "fac", "loop_sum", "mem_checksum", "coremark",
                 "trap_zoo", "guard_mix", "oob_mix", "bulk"):
        t = device_tables(_image_of(_ref_image(name)), "cpu", "super")
        fams |= {super_family(h)[0] for h in set(t.hid.tolist())
                 if super_family(h)}
    assert fams == set(SUPER_LEN) | {H_FUSE_GBR}, sorted(fams)


@pytest.mark.cuda
def test_cuda_super_match_plain_every_launch_all_rows():
    """On the card: the module's superinstruction kernel and the plain
    version from the same state, launch by launch, every plane and every
    stack row equal."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wasmedge_tpu_torch.batch import interp_ref
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.batch.interp import run_chunk
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.executor.instantiate import instantiate
    from wasmedge_tpu_torch.loader import Loader
    from wasmedge_tpu_torch.runtime.store import StoreManager
    from wasmedge_tpu_torch.validator import Validator
    from tests.test_torch_interp import _assert_same_state

    conf = Configure()
    conf.batch.value_stack_depth, conf.batch.call_stack_depth = 64, 32
    conf.batch.memory_pages_per_lane = 3
    conf.batch.block_fusion = False
    for data, func, args in (
            (build_trap_zoo(), "zoo", zoo_args(64)),
            (build_guard_mix(), "guard", [np.arange(64) * 5 - 3,
                                          np.arange(64) % 7 + 1]),
            (build_coremark_kernel(), "coremark", [np.arange(64) % 9 + 1])):
        mod = Validator(conf).validate(Loader(conf).parse_module(data))
        inst = instantiate(StoreManager(), mod, conf)
        eng = BatchEngine(inst, conf=conf, lanes=64, device="cuda")
        assert eng.tables.fusion == "super"
        st = eng.initial_state(inst.exports[func][1], args)
        ref = st.clone()
        for _ in range(300):
            run_chunk(eng.tables, st, 13, False)
            interp_ref.run_chunk(eng.tables, ref, 13, False)
            _assert_same_state(st, ref)
            if not bool((st.trap == 0).any()):
                break
