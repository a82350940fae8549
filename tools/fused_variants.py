"""Side-by-side variants of the port's kernels on one GPU.

Run from the root of a checkout:

    python3 tools/fused_variants.py
    python3 tools/fused_variants.py --parent DIR [--only NAME,...]

Without --parent: builds, all nvcc processes at once, the fused kernel of
each workload below, optimistic (B3, the default) and careful, as the
repository generates it ("instances": one case per block head,
dispatched by pc, terminals in the case) and as variants of the same
module:

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
results and retired counts equal to the repository build's.

With --parent: this tree against DIR, another checkout (for instance
`git archive` of the parent commit unpacked under a gitignored
directory).  Each tree's kernels are built first, both trees at once;
then the workloads of PARENT_WORKLOADS (--only: some of them) run at 4096
lanes and 2^20 steps per launch through `BatchEngine.run`, optimistic and
careful, one process per tree and turn, in the order parent, this tree,
this tree, parent, each run's device time taken with CUDA events around
the whole run (its launches and the host's gaps between them); fib(30)'s
blocks builds also time one launch of 256 steps from the initial state as
chip_smoke.py times it (CUDA events around the wrapper, median of 21).
Every run's results and retired counts must equal the first turn's.
Prints, per build, nvcc seconds, registers, spills (ptxas), and per
function of its SASS the bytes and SHFL / WARPSYNC counts.

The card's name and power limit go beside the numbers; the last line is
a JSON object of everything.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a --parent child runs in the tree it is given (--tree): that tree's
# package and chip_smoke.py first on the path
TREE = os.path.abspath(sys.argv[sys.argv.index("--tree") + 1]) \
    if "--tree" in sys.argv else HERE
sys.path.insert(0, TREE)

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


def variants_main(card: str) -> int:
    from wasmedge_tpu_torch.batch import interp

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


# --parent: name -> (module builder, export, lane args, knobs, encoding)
def parent_workloads():
    from wasmedge_tpu_torch.models import (
        build_coremark_kernel, build_fib, build_memory_workload,
        build_simd_loop)

    fib_kn = dict(value_stack_depth=256, call_stack_depth=256)
    simd_kn = dict(value_stack_depth=64, call_stack_depth=16,
                   memory_pages_per_lane=1)
    mem = build_memory_workload(passes=cs.MEM_PASSES)
    return {
        "fib30": (build_fib(), "fib", [np.full(LANES, 30)], fib_kn,
                  "blocks"),
        "fib_mix": (build_fib(), "fib", [20 + np.arange(LANES) % 11],
                    fib_kn, "blocks"),
        "vloop": (build_simd_loop(), "vloop", [np.full(LANES, cs.SIMD_N)],
                  simd_kn, "blocks"),
        "mem_checksum_windows": (mem, "mem_checksum",
                                 [np.full(LANES, cs.MEM_N)],
                                 dict(cs.MEM_STACKS, mem_hbm=True),
                                 "blocks"),
        "mem_checksum_direct": (mem, "mem_checksum",
                                [np.full(LANES, cs.MEM_N)],
                                dict(cs.MEM_STACKS, mem_hbm=False),
                                "blocks"),
        "coremark65536": (build_coremark_kernel(), "coremark",
                          [np.full(LANES, cs.MEM_COREMARK_N)],
                          dict(cs.MEM_STACKS), "blocks"),
        "fib30_per_op": (build_fib(), "fib", [np.full(LANES, 30)], fib_kn,
                         "none"),
        "fib30_super": (build_fib(), "fib", [np.full(LANES, 30)], fib_kn,
                        "super"),
    }


def parent_engines(only) -> dict:
    """(workload, "kopt" / "careful") -> engine of the tree on sys.path."""
    return {(name, "kopt" if opt is None else "careful"): cs.make_engine(
                data, LANES, fusion=fusion, steps_per_launch=STEPS,
                optimistic=opt, **kn)[0]
            for name, (data, _, _, kn, fusion) in parent_workloads().items()
            if not only or name in only
            for opt in (None, False)}


def child_build(only) -> dict:
    """Build every engine's kernel; per build its library, nvcc seconds
    and ptxas rows."""
    from wasmedge_tpu_torch.batch import interp

    engs = parent_engines(only)
    interp.build_kernels([e.tables for e in engs.values()])
    out = {}
    for (name, label), eng in engs.items():
        tb = eng.tables
        if tb.fusion != "none":
            info = interp.BUILD_INFO["fused"].get(
                interp.fused_kernel_key(tb), {})
        else:
            info = interp.BUILD_INFO["per_op"].get(interp.per_op_label(
                tb.mem_window, tb.optimistic, tb.stack_split), {})
        rows = cs.parse_ptxas(info.get("ptxas", ""))
        out[f"{name} {label}"] = dict(
            path=info.get("path"), seconds=info.get("seconds"),
            ptxas={k: v for k, v in rows.items() if "interp_kernel" in k})
    return out


def child_run(only) -> dict:
    """Each engine's whole run once: device ms (CUDA events), a digest of
    its results and retired counts; fib(30)'s blocks builds also one
    256-step launch (median ms of 21)."""
    from wasmedge_tpu_torch.batch import interp

    wl = parent_workloads()
    out = {}
    for (name, label), eng in parent_engines(only).items():
        _, func, args, _, _ = wl[name]
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = eng.run(func, list(args), max_steps=10**9)
        e1.record()
        torch.cuda.synchronize()
        if not (np.asarray(res.trap) == -1).all():
            raise RuntimeError(f"{name} {label}: lanes did not finish")
        digest = hashlib.sha256(np.asarray(res.results[0]).tobytes() +
                                np.asarray(res.retired).tobytes()).hexdigest()
        out[f"{name} {label}"] = dict(ms=e0.elapsed_time(e1), digest=digest)
        print(f"  {name} {label}: {out[f'{name} {label}']['ms']:.1f} ms",
              flush=True)
        if name == "fib30":
            st0 = eng.initial_state(eng.inst.exports[func][1], list(args))
            wt = cs.new_warps(eng)
            ms = cs.time_launch(
                lambda s: interp.run_chunk(eng.tables, s, cs.TIMED_STEPS,
                                           False, wt), st0, 21)[0]
            out[f"{name} {label} launch{cs.TIMED_STEPS}"] = dict(ms=ms)
    return out


def spawn(tree: str, mode: str, only):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", mode,
         "--tree", tree, "--only", ",".join(only)],
        stdout=subprocess.PIPE, text=True, cwd=tree)


def collect(proc, what: str) -> dict:
    out, _ = proc.communicate()
    lines = out.splitlines()
    for line in lines:
        if not line.startswith("RESULT "):
            print(line, flush=True)
    if proc.returncode != 0:
        cs.fail(f"{what} failed ({proc.returncode})")
    return json.loads([ln for ln in lines if ln.startswith("RESULT ")][-1][7:])


def parent_main(card: str, parent: str, only) -> int:
    trees = {"this": HERE, "parent": os.path.abspath(parent)}
    t0 = time.perf_counter()
    procs = {k: spawn(t, "build", only) for k, t in trees.items()}
    builds = {k: collect(p, f"build {k}") for k, p in procs.items()}
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)
    for k, b in builds.items():
        for label, rec in b.items():
            rec["sass"] = cs.sass_stats(cs.sass_of(rec["path"]), every=True) \
                if rec["path"] else {}
            for fn, r in rec["ptxas"].items():
                print(f"  build [{k}] {label}: nvcc {rec['seconds'] or 0:.1f}"
                      f" s, {fn}: {r.get('registers')} registers, "
                      f"{r.get('spill_stores', 0)} B spill stores", flush=True)
            for fn, r in rec["sass"].items():
                short = fn if len(fn) < 60 else "..." + fn[-57:]
                print(f"    SASS {short}: {r['sass_bytes']} B, {r['shfl']} "
                      f"SHFL, {r['warpsync']} WARPSYNC", flush=True)
    turns = []
    for k in ("parent", "this", "this", "parent"):
        print(f"turn {len(turns) + 1}: {k}", flush=True)
        turns.append((k, collect(spawn(trees[k], "run", only), f"run {k}")))
    first = turns[0][1]
    for k, runs in turns:
        for label, r in runs.items():
            if r.get("digest", first[label].get("digest")) != \
                    first[label].get("digest"):
                cs.fail(f"{k} {label}: results or retired counts differ "
                        f"from the first turn's")
    table = {lb: {k: [r[lb]["ms"] for kk, r in turns if kk == k]
                  for k in trees} for lb in sorted(first)}
    for lb, v in table.items():
        fmt = "{:.4f}" if "launch" in lb else "{:.1f}"
        print(f"{lb}: " + ", ".join(
            f"{k} {' / '.join(fmt.format(x) for x in ms)} ms"
            for k, ms in v.items()), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "builds": builds, "ms": table}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--only", default="")
    ap.add_argument("--child", default=None, choices=("build", "run"))
    ap.add_argument("--tree", default=HERE)
    args = ap.parse_args()
    only = [w for w in args.only.split(",") if w]
    if args.child:
        out = (child_build if args.child == "build" else child_run)(only)
        print("RESULT " + json.dumps(out), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("fused_variants: no CUDA device", flush=True)
        return 2
    card = cs.gpu_name_and_power()
    print(f"card: {card}", flush=True)
    if args.parent:
        return parent_main(card, args.parent, only)
    return variants_main(card)


if __name__ == "__main__":
    sys.exit(main())
