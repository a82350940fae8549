"""B6 superinstructions as instance cases: the generated text, and the plain runs launch by launch.

A "super" build generates one case of `Fused::at_pc` per superinstruction
pc (up to `fusegen.MAX_INSTANCE_CASES`), dispatched by pc, with every
operand a literal (local offsets, the constant as one u64, the stored
local, branch targets and keep counts, the budget's length) and GCC's
call and A2R's return run in the case; pcs beyond the cap keep their
id's case of `Fused::step`, reached through the hid plane.  Checks:

  - the text: one instance case per superinstruction pc, none reading a
    code or fused plane (no `p.fa` ... `p.fihi`, no `p.flen`), the budget
    test against the literal length with the head's own op when it
    fails, GCC's call and A2R's return inside their cases (the B2
    terminals' code: the value stack tested before the call stack, the
    frame row saved for a B3 rollback, agreed return rows), every family
    of `fuse_image` present over the modules;
  - per launch: the reference SIMT `BatchEngine` and the port's plain
    engine with the "super" encoding, careful and with `optimistic` on,
    from the same image and state, one launch each, every plane equal
    after every launch (the stack planes in the rows below sp), with
    launch budgets and fuel that end inside a superinstruction;
  - a module past a lowered instance cap.

The plain version is what the kernel is held to, row for row, on the
card (`chip_smoke.py`); tolerance: bit-exact.
"""

import functools

import numpy as np
import pytest

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu_torch.batch import fusegen
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.fusion import SUPER_LEN, super_family
from wasmedge_tpu_torch.batch.interp import (
    H_FUSE_A2R_BASE, H_FUSE_GBR, H_FUSE_GCC_BASE, device_tables, run_chunk)
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.models import (
    build_coremark_kernel, build_fac, build_fib, build_loop_sum,
    build_memory_workload)
from wasmedge_tpu_torch.models.fixtures import (
    ZOO_CASES, build_block_terminals, build_call_traps, build_guard_mix,
    build_oob_mix, build_trap_zoo, oob_args, zoo_args)
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_fused_instances import instance_cases
from tests.test_torch_interp import _image_of, _ref_conf, _ref_planes

# what a superinstruction's instance case must not read: the code and
# fused planes
PLANE_READS = ("p.fa[", "p.fb[", "p.fc[", "p.filo[", "p.fihi[", "p.flen[",
               "p.hid[", "p.hid0[", "p.a[", "p.b[", "p.c[", "p.ilo[",
               "p.ihi[", "__ldg(")

MODULES = {
    "fib": build_fib, "fac": build_fac, "loop_sum": build_loop_sum,
    "mem_checksum": build_memory_workload,
    "coremark": build_coremark_kernel, "trap_zoo": build_trap_zoo,
    "guard_mix": build_guard_mix, "oob_mix": build_oob_mix,
    "terminals": build_block_terminals, "call_traps": build_call_traps,
}


@functools.lru_cache(maxsize=None)
def _image(name):
    conf = _ref_conf(None, 64)
    _, store, inst = ref_instantiate(MODULES[name](), conf)
    return _image_of(RefEngine(inst, store=store, conf=conf, lanes=1).img)


def super_pcs(tables) -> list:
    return [pc for pc, h in enumerate(tables.hid.tolist())
            if super_family(h)]


@pytest.mark.parametrize("name", list(MODULES))
def test_instance_cases_are_literal(name):
    t1 = device_tables(_image(name), "cpu", "super")
    t2 = device_tables(_image(name), "cpu", "super")
    src = t1.fused_source
    assert src == t2.fused_source
    assert "static constexpr bool kByPc = true;" in src
    cases = instance_cases(src)
    pcs = super_pcs(t1)
    assert pcs and sorted(cases) == pcs
    for pc, text in cases.items():
        for read in PLANE_READS:
            assert read not in text, (pc, read)
        n = int(t1.flen[pc])
        assert f"if (left < {n} || (p.fuel_on && fuel <= {n}))" in text
        assert f"return {int(t1.hid0[pc])};" in text
        base, _ = super_family(int(t1.hid[pc]))
        if base == H_FUSE_GCC_BASE:
            # the call in the case: its frame row, a rollback's saved
            # row, its traps with the value stack tested first
            assert f"p.fr_ret_pc[r] = {pc + 4};" in text
            assert "opt_save_frame(p, s.lane, cd, os.o.fhi)" in text
            assert text.index("trap = E_STACK_OVERFLOW;") < \
                text.index("trap = E_CALL_STACK;")
        if base == H_FUSE_A2R_BASE:
            assert "trap = TRAP_DONE;" in text
            assert "w.agree((u32)p.fr_ret_pc[r])" in text
        if base in (H_FUSE_GCC_BASE, H_FUSE_A2R_BASE):
            assert f"n = {n};\n        return FUSED_DONE;" in text
            assert "s.note(sp);" in text
        assert "return FUSED_DONE;" in text and "return true;" not in text
    # no pc past the cap: no id case in Fused::step, no step default
    step = src[:src.index("at_pc(")]
    assert "      case " not in step
    assert "step<kSimd, kWin>(p, s, m, w, h" not in src


def test_every_family_has_instance_cases():
    """The modules hold all ten families, and each family's cases run
    their terminals in the case (GCC a call, A2R a return; the counts of
    `terminal_counts`)."""
    fams, calls, returns = set(), 0, 0
    for name in MODULES:
        t = device_tables(_image(name), "cpu", "super")
        for pc in super_pcs(t):
            fams.add(super_family(int(t.hid[pc]))[0])
        counts = fusegen.terminal_counts(t.fused_source)
        hid = t.hid.tolist()
        assert counts["call"] == sum(super_family(h)[0] == H_FUSE_GCC_BASE
                                     for h in hid if super_family(h))
        assert counts["return"] == sum(super_family(h)[0] == H_FUSE_A2R_BASE
                                       for h in hid if super_family(h))
        calls += counts["call"]
        returns += counts["return"]
    assert fams == set(SUPER_LEN) | {H_FUSE_GBR}, sorted(fams)
    assert calls and returns


def test_superinstructions_past_the_cap(monkeypatch):
    """With the cap below the module's superinstruction pcs, the first
    ones get instance cases and the rest their id's case of
    `Fused::step`, through at_pc's default (the hid plane, the fused
    length and the head's own op from the planes)."""
    monkeypatch.setattr(fusegen, "MAX_INSTANCE_CASES", 5)
    t = device_tables(_image("coremark"), "cpu", "super")
    pcs = super_pcs(t)
    assert len(pcs) > 5
    src = t.fused_source
    assert sorted(instance_cases(src)) == pcs[:5]
    step = src[:src.index("at_pc(")]
    for h in {int(t.hid[pc]) for pc in pcs[5:]}:
        assert f"      case {h}: {{" in step
    default = src[src.index("      default: {", src.index("at_pc(")):]
    assert "step<kSimd, kWin>(p, s, m, w, h" in default
    assert "(unsigned)(h - H_FUSE_GCA_BASE) >" in default
    assert "__ldg(&p.flen[pcc])" in default


# name -> (module, export, lane args, steps per launch, fuel)
CASES = {
    "fib_steps_3": (build_fib, "fib", [np.arange(12) % 6 + 2], 3, None),
    "fib_steps_5": (build_fib, "fib", [np.arange(12) % 8 + 2], 5, None),
    "fib_fuel": (build_fib, "fib", [np.arange(12) % 8 + 3], 64, 301),
    "fac_steps_7": (build_fac, "fac", [np.arange(8) * 3], 7, None),
    "loop_sum_fuel": (build_loop_sum, "loop_sum", [np.arange(8) * 5 + 9],
                      13, 203),
    "coremark_steps_7": (build_coremark_kernel, "coremark",
                         [np.arange(8) * 2 + 1], 7, None),
    "trap_zoo_steps_7": (build_trap_zoo, "zoo", zoo_args(ZOO_CASES), 7,
                         None),
    "guard_mix_fuel": (build_guard_mix, "guard",
                       [np.arange(12) * 5 - 3, np.arange(12) % 7 + 1], 7,
                       37),
    "oob_mix_steps_3": (build_oob_mix, "oob", oob_args(14, 2), 3, None),
    "call_traps": (build_call_traps, "deep", [np.arange(12) * 2], 6, None),
}


def _inside(tables, pcs) -> bool:
    """Whether any pc lies inside a superinstruction (past its head)."""
    hid, flen = tables.hid.tolist(), tables.flen.tolist()
    inner = {pc + k for pc, h in enumerate(hid) if super_family(h)
             for k in range(1, flen[pc])}
    return bool(inner & set(int(p) for p in pcs))


@pytest.mark.parametrize("case", list(CASES))
def test_super_plain_matches_simt_every_launch(case):
    """The reference and the port's plain "super" engine, careful and
    with optimistic convergence on, from the same image and state, one
    launch each; every plane equal after every launch, and some launch
    ends with lanes inside a superinstruction (the budget or the fuel
    did not cover it, so its head ran its own op)."""
    build, func, args, chunk, fuel = CASES[case]
    lanes = len(np.asarray(args[0]))
    conf = _ref_conf(fuel, chunk)
    if case == "call_traps":
        conf.batch.value_stack_depth, conf.batch.call_stack_depth = 256, 16
    _, store, inst = ref_instantiate(build(), conf)
    ref = RefEngine(inst, store=store, conf=conf, lanes=lanes)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    img = _image_of(ref.img)
    careful = device_tables(img, "cpu", "super")
    kopt = device_tables(img, "cpu", "super", optimistic=True)
    assert careful.fused_source != kopt.fused_source
    port = state_from_reference(_ref_planes(st), device="cpu")
    opt = port.clone()
    warps = WarpState.new(lanes, "cpu")
    total, inside = 0, False
    for launch in range(3000):
        st, new_total = ref.run_from_state(st, total, total + chunk)
        run_chunk(careful, port, chunk, fuel is not None)
        run_chunk(kopt, opt, chunk, fuel is not None, warps)
        want = _ref_planes(st)
        assert_live_planes(port.to_numpy(), want, f"careful, launch {launch}")
        assert_live_planes(opt.to_numpy(), want, f"kOpt, launch {launch}")
        live = want["trap"] == 0
        inside |= _inside(careful, want["pc"][live])
        if new_total - total < chunk or not live.any():
            break
        total = new_total
    else:
        raise AssertionError("reference still running after 3000 launches")
    trap = port.trap.numpy()
    if fuel is not None:
        assert (trap == int(ErrCode.CostLimitExceeded)).any()
        inside |= _inside(careful, port.pc.numpy()[
            trap == int(ErrCode.CostLimitExceeded)])
    if case == "call_traps":
        assert (trap == int(ErrCode.CallStackExhausted)).any()
    assert inside, "no launch or fuel budget ended inside a superinstruction"
    assert warps.stats()["entered"] >= 1


def test_plain_runs_past_the_cap_match(monkeypatch):
    """The plain version is the same whatever the cap (it has no cases):
    coremark with the cap below its superinstruction pcs, careful and
    kOpt, launch by launch against the reference."""
    monkeypatch.setattr(fusegen, "MAX_INSTANCE_CASES", 5)
    build, func, args, chunk = (build_coremark_kernel, "coremark",
                                [np.arange(8) * 3 + 1], 13)
    conf = _ref_conf(None, chunk)
    _, store, inst = ref_instantiate(build(), conf)
    ref = RefEngine(inst, store=store, conf=conf, lanes=8)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    img = _image_of(ref.img)
    tabs = [device_tables(img, "cpu", "super", optimistic=o)
            for o in (False, True)]
    assert all("step<kSimd, kWin>(p, s, m, w, h" in t.fused_source
               for t in tabs)
    ports = [state_from_reference(_ref_planes(st), device="cpu")
             for _ in tabs]
    warps = WarpState.new(8, "cpu")
    total = 0
    for launch in range(3000):
        st, new_total = ref.run_from_state(st, total, total + chunk)
        run_chunk(tabs[0], ports[0], chunk, False)
        run_chunk(tabs[1], ports[1], chunk, False, warps)
        want = _ref_planes(st)
        for port in ports:
            assert_live_planes(port.to_numpy(), want, f"launch {launch}")
        if new_total - total < chunk or not (want["trap"] == 0).any():
            break
        total = new_total
    assert (ports[0].trap.numpy() == -1).all()
