"""Side-by-side variants of the port's B2 blocks kernels on one GPU.

Run from the root of a checkout:  python3 tools/fused_variants.py

Builds, all nvcc processes at once, the fused kernel of each workload
below, optimistic (B3, the default) and careful, as the repository
generates it ("instances": one case per block head, dispatched by pc,
terminals in the case) and as variants of the same module:

  shapes  one case per block shape, dispatched by the hid plane with its
          terminal left to the per-op code: the dispatch B2 had before
          its instance cases (its v128 ops inlined by sub all the same)

and the module with more block heads than the instance cap
(`models.fixtures.build_many_heads`) at the cap and at a quarter of it,
for what a build's size costs.  Prints each build's nvcc seconds,
registers and spills (ptxas), SASS bytes and indirect branches (BRX,
`cuobjdump -sass`).  Then times main-path runs at 4096 lanes and 2^20
steps per launch (fib(30), vloop(1,000,000), BASELINE config 2's
mem_checksum(8192) x 64 passes with the windows), each variant's device
time over the whole run (CUDA events), in turns A B .. B A, every run's
results and retired counts equal to the repository build's.  The card's
name and power limit go beside the numbers; the last line is a JSON
object of everything.  Exits non-zero without a CUDA device.
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


def variant(tables, name: str):
    """`tables` with the fused source of variant `name`."""
    from wasmedge_tpu_torch.batch import fusegen

    if name == "instances":
        return tables
    assert name == "shapes"
    src = fusegen.cuda_source(
        tables.hid.cpu().tolist(), tables.shapes, tables.has_bulk,
        tables.has_simd, tables.mem_window, tables.optimistic,
        tables.stack_split)
    return dataclasses.replace(tables, fused_source=src)


def heads_tables(cap: int, opt):
    """The many-heads module's blocks tables with the instance cap `cap`."""
    from wasmedge_tpu_torch.batch import fusegen
    from wasmedge_tpu_torch.models.fixtures import build_many_heads

    old = fusegen.MAX_INSTANCE_CASES
    fusegen.MAX_INSTANCE_CASES = cap
    try:
        return cs.make_engine(build_many_heads(old + 40), 2, device="cpu",
                              fusion="blocks", optimistic=opt,
                              value_stack_depth=64, call_stack_depth=16
                              )[0].tables
    finally:
        fusegen.MAX_INSTANCE_CASES = old


def workloads():
    """(name, module, export, args, knobs, variants, check)."""
    from wasmedge_tpu_torch.models import (
        build_fib, build_memory_workload, build_simd_loop)
    from wasmedge_tpu_torch.models.programs import simd_loop_model

    return [
        ("fib(30)", build_fib(), "fib", [np.full(LANES, 30)],
         dict(value_stack_depth=256, call_stack_depth=256),
         ("instances", "shapes"),
         lambda r: ((r & 0xFFFFFFFF) == cs.fib_py(30)).all()),
        (f"vloop({cs.SIMD_N})", build_simd_loop(), "vloop",
         [np.full(LANES, cs.SIMD_N)],
         dict(value_stack_depth=64, call_stack_depth=16,
              memory_pages_per_lane=1), ("instances", "shapes"),
         lambda r: ((r & 0xFFFFFFFF) == simd_loop_model(cs.SIMD_N)).all()),
        (f"mem_checksum({cs.MEM_N}) x {cs.MEM_PASSES}",
         build_memory_workload(passes=cs.MEM_PASSES), "mem_checksum",
         [np.full(LANES, cs.MEM_N)], cs.MEM_STACKS, ("instances", "shapes"),
         None),
    ]


def timed_run(eng, tables, func, args):
    """One whole run of `eng` through `tables`: device ms (CUDA events)
    and its result."""
    from wasmedge_tpu_torch.batch.optimistic import WarpState

    eng.tables = tables
    if tables.optimistic:  # every run from a fresh per-warp state
        eng.warps = WarpState.new(eng.lanes, eng.device)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = eng.run(func, args, max_steps=10**12)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), res


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_variants: no CUDA device", flush=True)
        return 2
    from wasmedge_tpu_torch.batch import interp

    card = cs.gpu_name_and_power()
    print(f"card: {card}", flush=True)
    runs = {}
    for name, data, func, args, knobs, names, check in workloads():
        for opt in (None, False):
            eng = cs.make_engine(data, LANES, fusion="blocks", optimistic=opt,
                                 steps_per_launch=STEPS, **knobs)[0]
            runs[(name, opt)] = (eng, func, args, check,
                                 {v: variant(eng.tables, v) for v in names})
    heads = {(cap, opt): heads_tables(cap, opt)
             for cap in (256, 1024) for opt in (None, False)}
    todo = [t for *_, vs in runs.values() for t in vs.values()] + \
        list(heads.values())
    t0 = time.perf_counter()
    interp.build_kernels(todo, per_op=())
    print(f"builds: {len(todo)} in {time.perf_counter() - t0:.1f} s, all "
          f"at once", flush=True)
    builds = {}

    def report(label, tables):
        key = interp.fused_kernel_key(tables)
        info = interp.BUILD_INFO["fused"][key]
        ptx = next((v for k, v in cs.parse_ptxas(info["ptxas"]).items()
                    if k.startswith("interp_kernel")), {})
        code = next(iter(cs.sass_stats(cs.sass_of(info["path"])).values()),
                    {})
        rec = dict(key=key, instance_cases=cs.instance_cases(tables),
                   nvcc_s=info["seconds"], **ptx, **code)
        builds[label] = rec
        print(f"  build {label}: {rec}", flush=True)

    for (name, opt), (_, _, _, _, vs) in runs.items():
        for v, tb in vs.items():
            report(f"{name} {v} {'kOpt' if opt is None else 'careful'}", tb)
    for (cap, opt), tb in heads.items():
        report(f"heads_over_cap, cap {cap} "
               f"{'kOpt' if opt is None else 'careful'}", tb)

    times = {}
    for (name, opt), (eng, func, args, check, vs) in runs.items():
        order = list(vs) + list(reversed(vs))
        ms = {v: [] for v in vs}
        want = None
        for v in order:
            t, res = timed_run(eng, vs[v], func, args)
            got = (res.results[0].tolist(), res.retired.tolist(),
                   res.trap.tolist())
            if want is None:
                want = got
                if check is not None and not check(res.results[0]):
                    cs.fail(f"{name}: wrong results")
            elif got != want:
                cs.fail(f"{name} {v}: results differ from the first run")
            ms[v].append(t)
        label = f"{name} {'kOpt' if opt is None else 'careful'}"
        times[label] = ms
        print(f"  time {label}: " + ", ".join(
            f"{v} {' / '.join(f'{x:.1f}' for x in ms[v])} ms" for v in ms)
            + f" (turns {' '.join(order)}); retired "
            f"{int(np.asarray(want[1], np.int64).sum())}", flush=True)
    print(json.dumps(dict(card=card, lanes=LANES, steps_per_launch=STEPS,
                          builds=builds, run_ms=times)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
