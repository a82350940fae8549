"""How many lanes run each turn of the dispatch loop, on one GPU.

Run from the root of a checkout:

    python3 tools/tail_probe.py [--only NAME,...]

For each workload (the tail dispatch, `models.fixtures.build_tail_dispatch`,
converged at TAIL_DISPATCH_N steps and divergent at an eighth of them, as
chip_smoke.py runs them; the linked program; fib(30), the converged
control) generations of its B2 build, the default path (windows,
optimistic): "after" as the repository generates it, and "before" with
the in-case terminals of the earlier generator (br, brnz, return and
the direct call: no call_indirect, tail call or div / rem terminal in
the case, and no chained call).
Both are built at once, also as the counting build
(WASM_TURN_COUNTS, csrc/interp.cu: at the top of the dispatch loop each
lane counts its turn and the lowest lane of those that run it together
counts one turn of the warp).  Every run goes through `BatchEngine.run`
at 4096 lanes and 2^20 steps a launch, its results equal to the
workload's numpy model.  Reported per workload and generation:

  lanes_per_turn   lane turns / warp turns (the mean of
                   __popc(__activemask()) at the loop's top)
  turns_per_instr  lane turns / retired instructions (dispatches a lane
                   makes for each instruction, rolled-back work included)
  ms               device time of the whole run (CUDA events) of the
                   build as it is, in turns before, after, after, before,
                   and of the counting build once

The card's name and power limit go beside the numbers; the last line is
a JSON object of everything.
Exits non-zero without a CUDA device or when a result is off its model.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

LANES = 4096
STEPS = 1 << 20


@contextlib.contextmanager
def before_terminals():
    """The generator with the earlier generation's in-case terminals."""
    from wasmedge_tpu_torch.batch import fusegen
    from wasmedge_tpu_torch.batch.interp import H_BR, H_BRNZ, H_CALL, H_RETURN

    old = fusegen._IN_CASE_TERMINALS
    fusegen._IN_CASE_TERMINALS = frozenset((H_BR, H_BRNZ, H_RETURN, H_CALL))
    try:
        yield
    finally:
        fusegen._IN_CASE_TERMINALS = old


GENERATIONS = ("before", "after")


def counting(tables):
    """`tables` with the counting build's source."""
    src = tables.fused_source
    head = "#define WASM_FUSED_BUILD 1\n"
    assert head in src
    return dataclasses.replace(tables, fused_source=src.replace(
        head, head + "#define WASM_TURN_COUNTS 1\n", 1))


def workloads():
    """(name, module, export, args, make_engine knobs, model of results)."""
    from wasmedge_tpu_torch.models import build_fib
    from wasmedge_tpu_torch.models.fixtures import (
        TAIL_DISPATCH_N, build_linked_program, build_tail_dispatch,
        linked_args, linked_program_model, tail_dispatch_args,
        tail_dispatch_model)

    out = []
    for mode, n in (("converged", TAIL_DISPATCH_N),
                    ("divergent", TAIL_DISPATCH_N // cs.TAIL_DIVERGENT_CUT)):
        args = tail_dispatch_args(LANES, mode, n)
        out.append((f"tail_{mode}", build_tail_dispatch(), "run", args, {},
                    tail_dispatch_model(args[0], n)))
    prov, cons = build_linked_program()
    args = linked_args(LANES)
    out.append(("linked", cons, "run", args,
                dict(registered=(("prov", prov),)),
                linked_program_model(*args)))
    out.append(("fib30", build_fib(), "fib", [np.full(LANES, 30)],
                dict(value_stack_depth=256, call_stack_depth=256),
                np.full(LANES, cs.fib_py(30))))
    return out


def timed(eng, tables, func, args, want):
    """One whole run through `tables`: (device ms, retired)."""
    from wasmedge_tpu_torch.batch.optimistic import WarpState

    eng.tables = tables
    eng.warps = WarpState.new(eng.lanes, eng.device) \
        if tables.optimistic else None
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = eng.run(func, args, max_steps=10**12)
    e1.record()
    torch.cuda.synchronize()
    got = res.results[0].astype(np.int64) & 0xFFFFFFFF
    if not (res.trap == -1).all() or not (got == want).all():
        cs.fail(f"{func}: {int((got != want).sum())} lanes off the model, "
                f"traps {sorted(set(res.trap.tolist()))}")
    return e0.elapsed_time(e1), int(res.retired.astype(np.int64).sum())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from wasmedge_tpu_torch.batch import fusegen, interp

    card = cs.gpu_name_and_power()
    print(card, flush=True)
    only = [w for w in opts.only.split(",") if w]
    runs = {}
    for name, data, func, args, knobs, want in workloads():
        if only and name not in only:
            continue
        gens = {}
        for gen in ("before", "after"):
            ctx = before_terminals() if gen == "before" \
                else contextlib.nullcontext()
            with ctx:
                eng = cs.make_engine(data, LANES, fusion="blocks",
                                     steps_per_launch=STEPS, **knobs)[0]
            gens[gen] = (eng.tables, counting(eng.tables))
        runs[name] = (eng, func, args, want, gens)
    todo = [t for *_, gens in runs.values() for pair in gens.values()
            for t in pair]
    t0 = time.perf_counter()
    interp.build_kernels(todo, per_op=())
    print(f"builds: {len({interp.fused_kernel_key(t) for t in todo})} in "
          f"{time.perf_counter() - t0:.1f} s, all at once", flush=True)
    out = {"card": card, "lanes": LANES, "steps_per_launch": STEPS,
           "workloads": {}}
    for name, (eng, func, args, want, gens) in runs.items():
        rec = {}
        for gen in GENERATIONS + GENERATIONS[::-1]:
            ms, retired = timed(eng, gens[gen][0], func, args, want)
            r = rec.setdefault(gen, {"ms": [], "retired": retired})
            r["ms"].append(ms)
            if r["retired"] != retired:
                cs.fail(f"{name} {gen}: retired {retired}, then "
                        f"{r['retired']}")
        for gen in GENERATIONS:
            r, tb = rec[gen], gens[gen][1]
            interp.turn_counts(tb, clear=True)
            ms, retired = timed(eng, tb, func, args, want)
            c = interp.turn_counts(tb, clear=True)
            if retired != r["retired"]:
                cs.fail(f"{name} {gen}: the counting build retired "
                        f"{retired}, the build {r['retired']}")
            r.update(c, counting_ms=ms,
                     lanes_per_turn=c["lane_turns"] / max(c["warp_turns"], 1),
                     turns_per_instr=c["lane_turns"] / max(retired, 1),
                     terminals=fusegen.terminal_counts(
                         gens[gen][0].fused_source))
            print(f"  {name} {gen}: ms {[round(x, 3) for x in r['ms']]}, "
                  f"counting {ms:.3f}, retired {retired}, lane turns "
                  f"{c['lane_turns']}, warp turns {c['warp_turns']}, lanes "
                  f"a turn {r['lanes_per_turn']:.3f}, turns an instruction "
                  f"{r['turns_per_instr']:.4f}; in-case terminals "
                  f"{r['terminals']}", flush=True)
        out["workloads"][name] = rec
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
