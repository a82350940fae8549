"""B6 superinstructions on one GPU: the by-pc build against the hid-dispatched one, and a set of super fixtures against the plain version.

Run from the root of a checkout:  python3 tools/super_probe.py

fib's super encoding is built two ways, optimistic (B3, the default) and
careful: "pc", as the repository generates it (one case of
`Fused::at_pc` per superinstruction pc, operands literal, GCC's call and
A2R's return in the case), and "hid", the same module generated without
instance cases (`fusegen.cuda_source` with no image: each superinstruction
id a case of `Fused::step`, dispatched by the hid plane, its operands
loaded from the rewritten planes and its terminal left to the per-op
code, as B6 ran before its instance cases).  All builds run at once,
with the fixtures' below; per build its nvcc seconds, registers and
spills (ptxas), SASS bytes and indirect branches.  Then, in turns pc, hid,
hid, pc: one 256-step fib(30) x 4096 launch from the initial state
(median of 21, CUDA events), and whole runs of fib(30) and fib(27) x 4096
at 2^20 steps a launch (CUDA events around `BatchEngine.run`), every
run's results and retired counts equal.  Then chip_smoke.py's fused and
optimistic jobs in the super encoding for FIXTURES (every family, calls
that trap, fuel and budgets that end inside a superinstruction, a module
past the instance cap lowered to 256), kernel against plain, every plane
and row after every launch.  Prints the card's name and power limit; the
last line is a JSON object of everything.  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

LANES = 4096
STEPS = 1 << 20
FIB_KNOBS = dict(value_stack_depth=256, call_stack_depth=256)
FIXTURES = ("fib_divergent", "fib_fuel", "traps_grow_memory", "guard_mix",
            "loop_sum", "coremark_fuel", "call_stack_exhausted",
            "call_both_limits", "call_block_fuel_4", "heads_over_cap",
            "opt_fib_3_11", "opt_call_sites", "opt_trap_zoo")


def hid_variant(tables):
    """`tables` with the source generated without instance cases."""
    from wasmedge_tpu_torch.batch import fusegen

    src = fusegen.cuda_source(
        tables.hid.cpu().tolist(), (), tables.has_bulk, tables.has_simd,
        tables.mem_window, tables.optimistic, tables.stack_split,
        tables.t0k is not None, a3=tables.a3)
    return dataclasses.replace(tables, fused_source=src)


def super_jobs():
    """chip_smoke.py's super jobs of FIXTURES."""
    jobs = [j for j in cs.fused_jobs() + cs.opt_jobs()
            if j[0] == "kernel_vs_plain" and j[1][7] == "super"
            and j[1][0] in FIXTURES]
    if {j[1][0] for j in jobs} != set(FIXTURES):
        cs.fail(f"missing fixtures: {set(FIXTURES) - {j[1][0] for j in jobs}}")
    return jobs


def job_tables(jobs) -> list:
    """The builds the jobs run: both B3 modes and memory modes."""
    out = []
    for _, (name, data, func, args, chunk, fuel, knobs, fusion, *_), _ in \
            jobs:
        kn = dict(knobs)
        for opt in (None, False):
            for _, (eng, _) in cs.memory_modes(lambda m: cs.make_engine(
                    data, 2, device="cpu", fusion=fusion, mem_hbm=m,
                    optimistic=opt, **kn)):
                out.append(eng.tables)
    return out


def build_row(tables) -> dict:
    from wasmedge_tpu_torch.batch import interp

    info = interp.BUILD_INFO["fused"][interp.fused_kernel_key(tables)]
    ptx = next((v for k, v in cs.parse_ptxas(info["ptxas"]).items()
                if k.startswith("interp_kernel")), {})
    code = next(iter(cs.sass_stats(cs.sass_of(info["path"])).values()), {})
    return dict(nvcc_s=info["seconds"], **ptx, **code)


def main() -> int:
    if not torch.cuda.is_available():
        print("super_probe: no CUDA device", flush=True)
        return 2
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.batch.optimistic import WarpState
    from wasmedge_tpu_torch.models import build_fib

    card = cs.gpu_name_and_power()
    print(f"card: {card}", flush=True)
    engs, variants = {}, {}
    for opt in (None, False):
        lab = "kOpt" if opt is None else "careful"
        eng = cs.make_engine(build_fib(), LANES, fusion="super",
                             optimistic=opt, steps_per_launch=STEPS,
                             **FIB_KNOBS)[0]
        engs[lab] = eng
        variants[lab] = {"pc": eng.tables, "hid": hid_variant(eng.tables)}
    jobs = super_jobs()
    todo = [t for v in variants.values() for t in v.values()] + \
        job_tables(jobs)
    t0 = time.perf_counter()
    interp.build_kernels(todo, per_op=())
    print(f"builds: {len(todo)} tables in {time.perf_counter() - t0:.1f} s, "
          f"all at once", flush=True)
    builds = {}
    for lab, vs in variants.items():
        for v, tb in vs.items():
            builds[f"fib {v} {lab}"] = dict(
                instance_cases=cs.instance_cases(tb) if v == "pc" else 0,
                **build_row(tb))
            print(f"  build fib super {v} {lab}: {builds[f'fib {v} {lab}']}",
                  flush=True)

    launch, runs = {}, {}
    for lab, eng in engs.items():
        st0 = eng.initial_state(eng.inst.exports["fib"][1],
                                [np.full(LANES, 30)])
        ms = {"pc": [], "hid": []}
        for v in ("pc", "hid", "hid", "pc"):
            tb = variants[lab][v]
            wt = cs.new_warps(eng)
            ms[v].append(cs.time_launch(
                lambda s: interp.run_chunk(tb, s, cs.TIMED_STEPS, False, wt),
                st0, 21)[0])
        launch[lab] = ms
        print(f"  fib(30) 256-step launch {lab}: pc "
              f"{' / '.join(f'{x:.4f}' for x in ms['pc'])} ms, hid "
              f"{' / '.join(f'{x:.4f}' for x in ms['hid'])} ms", flush=True)
        for n in (30, 27):
            ms = {"pc": [], "hid": []}
            want = None
            for v in ("pc", "hid", "hid", "pc"):
                eng.tables = variants[lab][v]
                if eng.tables.optimistic:
                    eng.warps = WarpState.new(eng.lanes, eng.device)
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                res = eng.run("fib", [np.full(LANES, n)], max_steps=10**9)
                e1.record()
                torch.cuda.synchronize()
                got = (np.asarray(res.results[0]).tobytes(),
                       np.asarray(res.retired).tobytes())
                if want is None:
                    want = got
                    if not ((np.asarray(res.results[0]) & 0xFFFFFFFF)
                            == cs.fib_py(n)).all():
                        cs.fail(f"fib({n}) {lab} {v}: wrong results")
                elif got != want:
                    cs.fail(f"fib({n}) {lab} {v}: results or retired "
                            f"differ from the first run")
                ms[v].append(e0.elapsed_time(e1))
            runs[f"fib({n}) {lab}"] = dict(
                ms, retired=int(np.frombuffer(want[1], np.int32)
                                .astype(np.int64).sum()))
            print(f"  fib({n}) x {LANES} {lab}: pc "
                  f"{' / '.join(f'{x:.1f}' for x in ms['pc'])} ms, hid "
                  f"{' / '.join(f'{x:.1f}' for x in ms['hid'])} ms",
                  flush=True)
        eng.tables = variants[lab]["pc"]

    t0 = time.perf_counter()
    worst = cs.run_jobs({"super": jobs})["super"]
    print(f"super jobs: {len(jobs)} kernel == plain, max abs err {worst}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps(dict(card=card, builds=builds, launch_ms=launch,
                          run_ms=runs, jobs=len(jobs), max_abs_err=worst)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
