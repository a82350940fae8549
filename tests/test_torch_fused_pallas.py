"""Fused encodings, end of run: the port against the reference Pallas kernel and the scalar oracle.

(block_fusion False here; True in `test_torch_fused_pallas_blocks.py`.)

The port's engine on the CPU (plain interpreter) with `block_fusion`
True (B2 blocks) and False (B6 superinstructions, or one op per dispatch
for a module with v128 ops) against `PallasUniformEngine(...,
interpret=True)` with the same knob (the careful kernel, driven by its
block scheduler with the SIMT residue), and against the reference's
scalar interpreter (`Executor.invoke`, one instance per lane): traps
equal, and the results of every lane that finished.  Per-lane `retired`
is held against the reference SIMT `BatchEngine` by the per-launch tests;
here it is only compared on converged fib, where the Pallas kernel's
count is exact (ROADMAP queue C).
"""

import numpy as np
import pytest

from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import TrapError
from wasmedge_tpu.common.types import typed_to_bits
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.models import build_fib
from wasmedge_tpu_torch.models.fixtures import (
    ZOO_CASES, build_trap_zoo, build_vmix, zoo_args)
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_interp import CD, D, PAGES, _port_run

CASES = {
    "fib_converged": (build_fib, "fib", [np.full(8, 10)]),
    "fib_divergent": (build_fib, "fib", [np.arange(12) % 9 + 3]),
    "trap_zoo": (build_trap_zoo, "zoo", zoo_args(ZOO_CASES)),
    "vmix": (build_vmix, "vmix", [np.arange(6) % 5 + 2]),
}


def _pallas(data, func, args, block_fusion):
    from wasmedge_tpu.batch.pallas_engine import PallasUniformEngine

    conf = RefConfigure()
    b = conf.batch
    b.steps_per_launch = 50_000
    b.value_stack_depth, b.call_stack_depth = D, CD
    b.memory_pages_per_lane = PAGES
    b.optimistic = False
    b.block_fusion = block_fusion
    b.fuse_superinstructions = False
    b.tierup = False
    _, store, inst = ref_instantiate(data, conf)
    eng = PallasUniformEngine(inst, store=store, conf=conf,
                              lanes=len(args[0]), interpret=True)
    assert eng.eligible, eng.ineligible_reason
    return eng.run(func, [np.asarray(a, np.int64) for a in args])


def _scalar(data, func, args, lane):
    ex, store, inst = ref_instantiate(data, RefConfigure())
    fi = inst.find_func(func)
    try:
        out = ex.invoke(store, fi, [int(a[lane]) for a in args])
    except TrapError as te:
        return None, int(te.code)
    return [typed_to_bits(t, v) for t, v in
            zip(fi.functype.results, out)], -1


def check_end_of_run(case, block_fusion):
    build, func, args = CASES[case]
    got = _port_run(build(), func, args, len(args[0]), steps_per_launch=4096,
                    block_fusion=block_fusion)
    want = _pallas(build(), func, args, block_fusion)
    np.testing.assert_array_equal(got.trap, want.trap)
    done = want.trap == -1
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g[done], w[done])
    if case == "fib_converged":
        np.testing.assert_array_equal(got.retired, want.retired)
    exhausted = {int(ErrCode.CallStackExhausted), int(ErrCode.StackOverflow)}
    for lane in range(len(args[0])):
        cells, code = _scalar(build(), func, args, lane)
        if code in exhausted:
            # which limit a runaway recursion meets first depends on the
            # stack geometry (the batch engines' 64 rows and 32 frames)
            assert int(got.trap[lane]) in exhausted, lane
            continue
        assert got.trap[lane] == code, (lane, got.trap[lane], code)
        for r, c in enumerate(cells or ()):
            assert int(got.results[r][lane]) & (2**64 - 1) == c, lane


@pytest.mark.parametrize("case", list(CASES))
def test_super_end_of_run_matches_pallas_and_scalar(case):
    """block_fusion False: B6 superinstructions (vmix: one op per
    dispatch, as the Pallas kernel runs a module with v128 ops)."""
    check_end_of_run(case, False)
