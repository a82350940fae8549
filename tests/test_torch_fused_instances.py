"""B2 blocks as instance cases: the generated text, and the new fixtures launch by launch.

A "blocks" build generates one case of `Fused::at_pc` per block head pc
(up to `fusegen.MAX_INSTANCE_CASES`), dispatched by pc, with every
immediate a literal and the block's br / brnz / return / call terminal in
the case; heads beyond the cap keep their shape's case.  The generator
checks: the text is deterministic, no instance case reads a code plane,
and no generated case calls the out-of-line v128 ops.

The fixtures (terminals in the case, a brnz with a kept value, return at
depth 0 with and without a value, calls that trap E_CALL_STACK at the
frame limit and E_STACK_OVERFLOW, a call that runs out of both stacks at
once (E_STACK_OVERFLOW, as the reference decides), budget and fuel
edges on a block that ends in a call, a module with more heads than the
cap) run as in
`test_torch_blocks.py`: the reference SIMT `BatchEngine` and the port's
plain engine with the "blocks" encoding from the same image and state,
one launch each, every plane equal after every launch (the stack planes
in the rows below sp); tolerance: bit-exact.  The plain version is what
the kernel is held to, row for row, on the card (the `cuda` test here and
`chip_smoke.py`).
"""

import re

import numpy as np
import pytest
import torch

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu_torch.batch import fusegen, interp_ref
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.fusion import H_BLOCK_BASE
from wasmedge_tpu_torch.batch.interp import (
    H_BR, H_BRNZ, H_CALL, H_RETURN, device_tables, run_chunk)
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.models import (
    build_coremark_kernel, build_fib, build_memory_workload,
    build_simd_loop)
from wasmedge_tpu_torch.models.fixtures import (
    build_block_terminals, build_call_traps, build_guard_mix,
    build_many_heads, build_oob_mix, build_trap_zoo, build_vmix,
    build_vsub_blocks)
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_interp import _image_of, _ref_conf, _ref_planes

# what an instance case must not read: the code planes, the v128 table,
# the fused planes and the run-time row readers
CODE_READS = ("p.a[", "p.b[", "p.c[", "p.ilo[", "p.ihi[", "p.v128[",
              "p.hid[", "p.flen[", "p.hid0[", "fused_vrow", "fused_vshuffle")
HEADS_OVER_CAP = fusegen.MAX_INSTANCE_CASES + 40


def _ref_engine(data, lanes, chunk=64, fuel=None, depth=None):
    conf = _ref_conf(fuel, chunk)
    if depth is not None:
        conf.batch.value_stack_depth, conf.batch.call_stack_depth = depth
    _, store, inst = ref_instantiate(data, conf)
    return RefEngine(inst, store=store, conf=conf, lanes=lanes)


def _tables(data, depth=None):
    ref = _ref_engine(data, 1, depth=depth)
    return device_tables(_image_of(ref.img), "cpu", "blocks")


def per_launch(data, func, args, chunk, fuel=None, depth=None,
               max_launches=400):
    """The reference and the port's plain engine ("blocks") from the same
    image and state, one launch each, the live planes equal after every
    launch; (value-stack depth, call-stack depth) `depth` replaces the
    tests' 64 / 32.  Returns (port state, tables)."""
    lanes = len(np.asarray(args[0]))
    ref = _ref_engine(data, lanes, chunk, fuel, depth)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    tables = device_tables(_image_of(ref.img), "cpu", "blocks")
    port = state_from_reference(_ref_planes(st), device="cpu")
    total = 0
    for launch in range(max_launches):
        st, new_total = ref.run_from_state(st, total, total + chunk)
        run_chunk(tables, port, chunk, fuel is not None)
        want = _ref_planes(st)
        assert_live_planes(port.to_numpy(), want, f"launch {launch}")
        if new_total - total < chunk or not (want["trap"] == 0).any():
            return port, tables
        total = new_total
    raise AssertionError("reference still running after max_launches")


def instance_cases(src: str) -> dict:
    """pc -> the text of its instance case in a generated source."""
    body = src[src.index("switch (pcc) {"):]
    body = body[:body.index("      default:")]
    parts = re.split(r"\n(?=      case \d+: \{)", body)[1:]
    return {int(re.match(r"\s*case (\d+):", p).group(1)): p for p in parts}


def heads_of(tables) -> list:
    return (tables.hid >= H_BLOCK_BASE).nonzero().squeeze(1).tolist()


MODULES = {
    "fib": build_fib, "coremark": build_coremark_kernel,
    "mem_checksum": build_memory_workload, "vloop": build_simd_loop,
    "vmix": build_vmix, "terminals": build_block_terminals,
    "call_traps": build_call_traps, "vsub": build_vsub_blocks,
    "trap_zoo": build_trap_zoo, "guard_mix": build_guard_mix,
    "oob_mix": build_oob_mix,
}


@pytest.mark.parametrize("name", list(MODULES))
def test_instance_cases_read_no_code_plane(name):
    data = MODULES[name]()
    t1, t2 = _tables(data), _tables(data)
    src = t1.fused_source
    assert src == t2.fused_source
    cases = instance_cases(src)
    heads = heads_of(t1)
    assert heads and sorted(cases) == heads
    for pc, text in cases.items():
        for read in CODE_READS:
            assert read not in text, (pc, read)
        # the budget test against the block's literal length, and the
        # head's own op when it fails
        n = int(t1.flen[pc])
        assert f"if (left < {n} || (p.fuel_on && fuel <= {n}))" in text
        assert f"return {int(t1.hid0[pc])};" in text
    assert "v2_op(" not in src and "v1_op(" not in src
    # no shape case: every head has its instance case
    assert f"case {H_BLOCK_BASE}:" not in src


def test_terminals_run_in_their_case():
    """A block ending in br, brnz, return or call runs it in its case
    (FUSED_DONE, n counting the terminal); any other terminal is left to
    the per-op code (its handler id returned, n the block's ops)."""
    seen = set()
    for build in (build_block_terminals, build_trap_zoo, build_fib,
                  build_vmix):
        t = _tables(build())
        for pc, text in instance_cases(t.fused_source).items():
            shape = t.shapes[int(t.hid[pc]) - H_BLOCK_BASE]
            term = shape[-1][1] if shape[-1][0] == "term" else None
            if term in (H_BR, H_BRNZ, H_RETURN, H_CALL):
                seen.add(term)
                assert f"n = {len(shape)};\n        return FUSED_DONE;" \
                    in text, (pc, term)
            elif term is not None:
                assert f"return {term};" in text, (pc, term)
                assert f"n = {len(shape) - 1};" in text
    assert seen == {H_BR, H_BRNZ, H_RETURN, H_CALL}
    src = _tables(build_block_terminals()).fused_source
    for part in ("opt_save_frame(p, s.lane, cd, os.o.fhi)", "E_CALL_STACK",
                 "E_STACK_OVERFLOW", "TRAP_DONE", "w.agree((u32)p.fr_ret_pc",
                 "for (int k = 0; k < 3; ++k) s.put(fp_new + 1 + k, 0);"):
        assert part in src, part
    # a call out of both stacks at once traps E_STACK_OVERFLOW, as the
    # per-op step and the reference decide: its test comes first
    for text in instance_cases(src).values():
        if "E_CALL_STACK" in text:
            assert text.index("trap = E_STACK_OVERFLOW;") < \
                text.index("trap = E_CALL_STACK;"), text


def test_heads_beyond_the_cap_take_their_shape_case():
    t = _tables(build_many_heads(HEADS_OVER_CAP))
    heads = heads_of(t)
    assert len(heads) > fusegen.MAX_INSTANCE_CASES
    cases = instance_cases(t.fused_source)
    assert sorted(cases) == heads[:fusegen.MAX_INSTANCE_CASES]
    sids = {int(t.hid[pc]) - H_BLOCK_BASE
            for pc in heads[fusegen.MAX_INSTANCE_CASES:]}
    step = t.fused_source[:t.fused_source.index("at_pc(")]
    for sid in sids:
        assert f"      case {H_BLOCK_BASE + sid}: {{" in step
    assert "step<kSimd, kWin>(p, s, m, w, h" in t.fused_source


# name -> (module, export, lane args, steps per launch, fuel, depth)
CASES = {
    "terminals_13": (build_block_terminals, "terms",
                     [np.arange(12) * 5 + 1], 13, None, None),
    "terminals_256": (build_block_terminals, "terms",
                      [np.arange(12) * 5 + 1], 256, None, None),
    "void_return_at_depth_0": (build_block_terminals, "void_top",
                               [np.arange(8) * 3], 7, None, None),
    "call_stack_exhausted": (build_call_traps, "deep",
                             [np.arange(12) * 2], 64, None, (256, 16)),
    "stack_overflow": (build_call_traps, "deep", [np.arange(12) * 2], 64,
                       None, (64, 64)),
    # deep's frames are 5 rows apart with a top of 7: at depths 84 / 16 the
    # call from depth 15 is out of the call stack and of the value stack
    "call_both_limits": (build_call_traps, "deep", [np.arange(12) * 2], 64,
                         None, (84, 16)),
    "heads_over_cap": (lambda: build_many_heads(HEADS_OVER_CAP), "heads",
                       [np.arange(4) * 7919 + 1], 4096, None, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_instance_fixtures_match_simt_every_launch(case):
    build, func, args, chunk, fuel, depth = CASES[case]
    port, tables = per_launch(build(), func, args, chunk, fuel, depth)
    trap = port.trap.numpy()
    if case == "call_stack_exhausted":
        assert (trap == int(ErrCode.CallStackExhausted)).any()
        assert (trap == -1).any()
    elif case == "stack_overflow":
        assert (trap == int(ErrCode.StackOverflow)).any()
        assert (trap == -1).any()
    elif case == "call_both_limits":
        assert (trap == int(ErrCode.StackOverflow)).any()
        assert not (trap == int(ErrCode.CallStackExhausted)).any()
        assert (trap == -1).any()
    else:
        assert (trap == -1).all()


def _entry_len():
    t = _tables(build_block_terminals())
    ref = _ref_engine(build_block_terminals(), 1)
    entry = int(ref.inst.lowered.funcs[ref.export_func_idx("entry")]
                .entry_pc)
    shape = t.shapes[int(t.hid[entry]) - H_BLOCK_BASE]
    assert shape[-1] == ("term", H_CALL)
    return len(shape)


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("budget", ["chunk", "fuel"])
def test_budget_edges_at_a_block_ending_in_a_call(budget, delta):
    """A launch (or the fuel) one step short of, equal to and one past
    the length of a block whose terminal is its call: the instance case
    runs (call included) only when the steps cover it and more fuel than
    its length is left; the state is the per-op state either way."""
    n = _entry_len()
    args = [np.arange(6) * 5 + 1]
    if budget == "chunk":
        per_launch(build_block_terminals(), "entry", args, n + delta)
    else:
        port, _ = per_launch(build_block_terminals(), "entry", args, 64,
                             fuel=n + delta)
        assert (port.trap.numpy() ==
                int(ErrCode.CostLimitExceeded)).all()


@pytest.mark.cuda
def test_cuda_instance_cases_match_plain_every_launch_all_rows():
    """On the card: the fixtures' fused kernels, careful and optimistic,
    and the plain version from the same state, launch by launch, every
    plane and every stack row equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tests.test_torch_interp import _assert_same_state
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.batch.optimistic import WarpState
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.executor.instantiate import instantiate
    from wasmedge_tpu_torch.loader import Loader
    from wasmedge_tpu_torch.runtime.store import StoreManager
    from wasmedge_tpu_torch.validator import Validator

    for case, (build, func, args, chunk, fuel, depth) in CASES.items():
        for opt in (None, False):
            conf = Configure()
            conf.batch.value_stack_depth, conf.batch.call_stack_depth = \
                depth or (64, 32)
            conf.batch.optimistic = opt
            conf.batch.fuel_per_launch = fuel
            mod = Validator(conf).validate(Loader(conf).parse_module(
                build()))
            inst = instantiate(StoreManager(), mod, conf)
            lanes = 64
            eng = BatchEngine(inst, conf=conf, lanes=lanes, device="cuda")
            st = eng.initial_state(inst.exports[func][1],
                                   [np.resize(a, lanes) for a in args])
            ref = st.clone()
            wk, wp = ((WarpState.new(lanes, "cuda"),
                       WarpState.new(lanes, "cuda"))
                      if eng.tables.optimistic else (None, None))
            for _ in range(300):
                run_chunk(eng.tables, st, chunk, fuel is not None, wk)
                interp_ref.run_chunk(eng.tables, ref, chunk,
                                     fuel is not None, wp)
                _assert_same_state(st, ref)
                if not bool((st.trap == 0).any()):
                    break
