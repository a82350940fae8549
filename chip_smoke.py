"""Chip smoke test of the PyTorch/CUDA port (`wasmedge_tpu_torch`) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases:
  1. build   - compile every kernel the script runs, one nvcc process per
               source, all started together: the per-op warp-interpreter
               (csrc/interp.cu, four instantiations, a library each with
               direct memory access and with the B4 window cache,
               csrc/memwin.cuh, with and without B3 optimistic
               convergence, csrc/optimistic.cuh) and, per module,
               encoding, memory mode, optimistic or careful and stack
               split or not (WASM_STACK_SPLIT: deeper stacks than the
               rows on chip), the fused kernel (csrc/interp.cu +
               csrc/fused.cuh + the dispatch batch/fusegen.py generates
               for its B2 block heads, one instance case each, or B6
               superinstructions), the spec corpus's modules included;
               print each build's instance cases, seconds, shapes, mean
               shape length, SASS bytes and indirect branches (BRX;
               the main path's fib(30) and vloop builds against the same
               modules with no block case: what the pc switch compiled
               to), registers and spills, and what the CUDA runtime
               reports of
               the per-op instantiations and config 2's fused builds
               (registers, local bytes, shared memory per block, blocks
               per SM);
  2. kernel  - one geometry line per main-path instantiation (threads
               per block, shared bytes per block, blocks per SM, the
               stack rows on chip, registers and spills), held against
               batch/interp.py's block_geometry; then every kernel-
               against-plain comparison below as a job on WORKERS worker
               processes, the plain version on a CPU copy of the kernel
               side's inputs.  Every fixture with a memory runs twice,
               through the window cache (mem_hbm True) and with direct
               access (False), and with optimistic convergence on (the
               default) each side keeps its own per-warp state, compared
               too, while the careful kernel runs beside them (planes
               equal below sp); the fixtures:
               the per-op kernel ("none" encoding) on the fixture modules
               (ALU edge values, traps, divergent fib, memory ops, fuel,
               memory.fill / memory.copy edge cases, a small bulk
               workload) at 256 lanes against its plain PyTorch version,
               every state plane after every launch (tolerance 0); the
               host-call fixtures (env.double, env.poke, a host trap, a
               host memory.grow, WASI echo and WASI hello, three parks
               with live stack rows), each side with its own serve round
               after every launch, planes compared before and after it
               and the two stdout files byte for byte; the v128 fixtures
               (every batchable v128 op in sweep modules with random and
               corner-byte operands, vmix, vloop, the v128 memory zoo, the
               v128 control module, fuel on a v128 op and on a
               v128.store), all four stack planes; the fused kernels,
               "blocks" on fib (256 and 13 steps per launch, fuel), fac,
               loop_sum, mem_checksum, coremark (and with fuel), the trap
               zoo, the guard and OOB modules, the small bulk workload,
               vmix (and with fuel), vloop, env.double and WASI echo, the
               B2 instance-case fixtures (each terminal run in its case,
               a brnz with a kept value, return at depth 0 with and
               without a value, calls that trap E_CALL_STACK and
               E_STACK_OVERFLOW and one that runs out of both stacks at
               once, step and fuel budgets one short of, at and one past
               a block that ends in a call, more block heads than an
               instance cap lowered to 256) and blocks holding every v2 and v1
               sub (random and corner-byte operands), and
               "super" on the ones without v128 ops, every plane and
               every stack row after every launch (the window fixtures: a
               stride walk across windows, a ping-pong that makes the
               overlap rule evict a dirty way, a store before a host-call
               park); B3's fixtures (converged fib, fib(3 + lane % 11),
               the trap zoo, divergent addresses, nonzero-but-different
               br_if conditions, the window ping-pong converged and not,
               vmix, a function entered from two call sites at one stack
               height, a rollback over local rows below sp; rollbacks
               required where lanes diverge and none where they agree)
               per-op, in blocks and super, with the store before a park
               and WASI echo; B5's warp pass on memory.fill / memory.copy
               (converged with byte shifts 0-3 forward and backward,
               lane-dependent with one and two deltas in a warp, a lane
               out of bounds and n == 0 lanes; at 256, 100 and 99 lanes;
               warp passes required) and a recursion whose stack crosses
               the 512 on-chip rows of a 1024-row stack.  Then, in this
               process, one 256-step launch of fib(30) x 4096 in each
               encoding, one converged memory.fill + memory.copy launch
               (also as PyTorch tensor calls, its warp passes counted),
               one 256-step vloop launch x 4096 (blocks, the main path,
               and per-op) and one 256-step per-op
               launch of config 2's mem_checksum x 4096 from the first
               store (windows and direct), each through the optimistic
               kernel the main path runs and through the careful one,
               against the optimistic plain version on the card, and (but
               the bulk pair) once more with no warp entering, each with
               its bound;
  3. main    - at full size: fib(30) x 4096 through VM.execute_batch in the
               default encoding (B2 blocks), then per-op ("none") and with
               block_fusion False (B6), each once more under
               torch.profiler; a divergent fib mix x 4096; CoreMark(200)
               and CoreMark(4096) x 4096 with one 64 KiB page per lane
               (CoreMark(4096) in blocks and per-op, profiled); WASI echo x
               4096 (32,768 fd_write calls, output checked byte for byte,
               serve rounds and serve time against kernel time under
               torch.profiler), WASI hello x 4096 (proc_exit codes), the
               bulk-memory workload x 4096 (checked against a bytearray
               model, its warp passes counted); the SIMD spec corpus
               (tests/spec/simd.wast) through run_corpus_batched on the
               card, strict, every launch in B2 blocks; vloop(1,000,000) x
               4096 (bench_simd.py's shape) in blocks and with
               block_fusion False (per-op), every lane's result and retired
               count checked, each profiled; BASELINE config 2
               (bench_memory.py's shape): mem_checksum(8192) with 64 passes
               and coremark(65536) x 4096, stacks 128 / 64, one page, in
               blocks and per-op, windows on (the default) and off, every
               lane against its oracle, each profiled.  Every memory
               workload runs with the windows (the default) and once more
               with mem_hbm False.  Everything runs optimistic (B3, the
               default); fib(30) and the mix, config 2's mem_checksum in
               blocks (both memory modes) and vloop in blocks run once
               more with optimistic False, profiled.  The 22 non-SIMD
               spec corpus files run on the card with the reference test's
               depths, strict (7,068 / 0 / 432).  Every run sets the
               launch counts to 0 before it and fails unless its kernels
               launched (with a memory, every launch ran the window cache
               or none did; every launch optimistic where the knob is on,
               none where it is off);
  4. report  - phase times, kernel times (CUDA events), retired
               instructions and instructions per second, registers and
               spills of each build, the card's name and power limit, one
               JSON line of kernel records (with "mem_window", B4, and
               "optimistic", B3), and last the device JSON line.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 20261016
KERNEL_LANES = 256
HEADS_CAP = 256  # the B2 instance cap of the over-cap fixture's build
MAIN_LANES = 4096
TIMED_STEPS = 256  # steps of the one launch timed against the plain version
COREMARK_N = 4096  # bench.py's CoreMark size (bench.py:1231)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
L2_BYTES = 50e6  # H100 SXM L2, published
# peak rate outside the tensor cores (the published float32 rate; the
# interpreter's work is 32-bit integer and float operations)
OPS_PER_S = 67e12
OPS_PER_INSTR = 1
ECHO_ITERS = 4  # bench_echo.py's ITERS: 8 fd_write calls per lane
BULK_ITERS = 16
WASI_ARGS = ["alpha", "be"]
SMALL_BULK = dict(fill_bytes=700, copy_bytes=300, fold_words=300)
SIMD_N = 1_000_000  # bench_simd.py's N_ITERS
# BASELINE config 2 (bench_memory.py:19-27, :80-92): mem_checksum(N_WORDS)
# with PASSES passes and coremark(COREMARK_N), stacks 128 / 64, one page
MEM_N, MEM_PASSES, MEM_COREMARK_N = 8192, 64, 65536
MEM_STACKS = dict(value_stack_depth=128, call_stack_depth=64,
                  memory_pages_per_lane=1)
SPEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "spec")
SIMD_WAST = os.path.join(SPEC_DIR, "simd.wast")
# the non-SIMD batchable corpus with the reference test's depths
# (tests/test_spec.py:77-82): passed, failed, skipped
CORPUS_COUNTS = (7068, 0, 432)
CORPUS_DEPTHS = dict(call_stack_depth=2048, value_stack_depth=8192)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed ({out.returncode})"


def make_engine(data: bytes, lanes: int, device="cuda", imports=(),
                fusion=None, instance_cap=None, **knobs):
    """A BatchEngine for `data`; `fusion` ("none", "blocks", "super")
    replaces the encoding the engine chose from `block_fusion` (the memory
    mode stays the one it chose from `mem_hbm`), generated with at most
    `instance_cap` B2 instance cases where it is given (the package's cap
    otherwise)."""
    from wasmedge_tpu_torch.batch import fusegen
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.batch.interp import device_tables
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.executor.instantiate import (
        instantiate, register_import_object)
    from wasmedge_tpu_torch.loader import Loader
    from wasmedge_tpu_torch.runtime.store import StoreManager
    from wasmedge_tpu_torch.validator import Validator

    conf = Configure()
    for k, v in knobs.items():
        setattr(conf.batch, k, v)
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    store = StoreManager()
    for imp in imports:
        register_import_object(store, imp)
    inst = instantiate(store, mod, conf)
    eng = BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                      device=device)
    if fusion is not None:
        cap = fusegen.MAX_INSTANCE_CASES
        if instance_cap is not None:
            fusegen.MAX_INSTANCE_CASES = instance_cap
        try:
            eng.fusion = fusion
            eng.tables = device_tables(eng.img, eng.device, fusion,
                                       mem_window=eng.mem_window,
                                       optimistic=eng.optimistic,
                                       stack_depth=eng.cfg.value_stack_depth)
        finally:
            fusegen.MAX_INSTANCE_CASES = cap
    return eng, inst


def new_warps(eng):
    """A fresh per-warp state (B3) for `eng`'s tables on its device, None
    when they are careful."""
    from wasmedge_tpu_torch.batch.optimistic import WarpState

    return WarpState.new(eng.lanes, eng.device) if eng.tables.optimistic \
        else None


def warp_err(wa, wb) -> int:
    """Largest difference over the per-warp counters (snap, rollbacks,
    entered, commits) of two WarpStates (0 when both are None)."""
    if wa is None or wb is None:
        return 0 if wa is wb else 1 << 30
    return max(int((x.cpu().to(torch.int64) - y.cpu().to(torch.int64))
                   .abs().max())
               for x, y in zip(wa.counters().values(),
                               wb.counters().values()))


def on_cpu(st):
    """A copy of the state `st` on the CPU: the plain side of a
    comparison starts from the kernel side's inputs."""
    from wasmedge_tpu_torch.batch.engine import BatchState

    return BatchState(**{f: t.to("cpu", copy=True)
                         for f, t in st.planes().items()})


def cpu_tables(eng):
    """`eng`'s tables (encoding, memory mode, B3 mode) on the CPU."""
    from wasmedge_tpu_torch.batch.interp import device_tables

    tb = eng.tables
    return device_tables(eng.img, "cpu", tb.fusion,
                         mem_window=tb.mem_window, optimistic=tb.optimistic,
                         stack_depth=eng.cfg.value_stack_depth)


def cpu_warps(eng):
    """A fresh per-warp state on the CPU for `eng`'s tables (None when
    they are careful)."""
    from wasmedge_tpu_torch.batch.optimistic import WarpState

    return WarpState.new(eng.lanes, "cpu") if eng.tables.optimistic \
        else None


def live_err(a, b) -> int:
    """max_abs_err of two states of the same launch with the stack planes
    compared in the rows below sp (sp itself equal first): optimistic
    against careful, whose rows at or above sp may differ."""
    if not torch.equal(a.sp, b.sp):
        return int((a.sp.to(torch.int64) - b.sp.to(torch.int64)).abs().max())
    live = torch.arange(a.stack_lo.shape[0], device=a.sp.device)[:, None] \
        < a.sp[None, :]
    err = 0
    for f, pa in a.planes().items():
        pb = b.planes()[f]
        d = (pa.to(torch.int64) - pb.to(torch.int64)).abs()
        if f.startswith("stack_"):
            d = d[live]
        if d.numel():
            err = max(err, int(d.max()))
    return err


def max_abs_err(a, b) -> int:
    """Largest difference over every plane of two states (stack_e2 and
    stack_e3 included where the image has v128 ops)."""
    pa, pb = a.planes(), b.planes()
    if pa.keys() != pb.keys():
        fail(f"states with different planes: {sorted(pa)} / {sorted(pb)}")
    err = 0
    for f in pa:
        d = pa[f].cpu().to(torch.int64) - pb[f].cpu().to(torch.int64)
        err = max(err, int(d.abs().max().item()))
    return err


# The worst max abs err of the window-cache kernels (B4) against their
# plain versions, over every comparison that ran them.
WINDOW_WORST = [0]
# B3: the worst max abs err of the optimistic kernels against their plain
# versions (every plane and row and the per-warp state), and of the
# optimistic kernel against the careful one (rows below sp); per fixture
# and mode, the per-warp counts of the kernel side.
OPT_WORST = {"plain": 0, "careful": 0}
OPT_FIXTURES = {}
# B5's warp pass: the bulk-op counts of the kernel side per fixture and
# mode (warp passes, their lanes, lane walks)
BULK_FIXTURES = {}


def memory_modes(eng_of) -> list:
    """(mem_hbm, engine) pairs to compare: for a module with a memory the
    window cache (mem_hbm True) and direct access (False); one run
    otherwise.  `eng_of(mem_hbm)` makes the engine."""
    win = eng_of(True)
    if not win[0].mem_window:
        return [(None, win)]
    return [(True, win), (False, eng_of(False))]


def mode_tag(fusion, mem_hbm) -> str:
    parts = ([] if fusion == "none" else [fusion]) + (
        [] if mem_hbm is None else ["windows" if mem_hbm else "direct"])
    return f" [{', '.join(parts)}]" if parts else ""


def kernel_vs_plain(name, data, func, args, chunk, fuel, knobs,
                    fusion="none", rollbacks=None, lanes=KERNEL_LANES,
                    bulk=None) -> int:
    """One fixture at `lanes` lanes in the encoding `fusion`, for a
    module with a memory through the window cache and with direct access:
    kernel and plain version from the same CUDA state, launch by launch,
    every plane (every stack row, every memory row) equal; the plain side
    runs on a CPU copy of the same inputs.  With
    optimistic convergence on (the default, B3) each side keeps its own
    per-warp state, which must be equal too, and the careful kernel
    (`optimistic` False) runs beside them from the same state: every
    plane equal to the optimistic kernel's, the stack planes below sp.
    `rollbacks` True: some warp must roll back; False: none may.  `bulk`
    "warp": the kernel's bulk ops must include warp passes (and, with
    optimistic convergence off as on, no lane walks where every warp is
    whole). Returns the max abs err."""
    from wasmedge_tpu_torch.batch import interp, interp_ref

    worst = 0
    for mem_hbm, (eng, inst) in memory_modes(lambda m: make_engine(
            data, lanes, fuel_per_launch=fuel, fusion=fusion,
            mem_hbm=m, **knobs)):
        t0 = time.perf_counter()
        tag = mode_tag(fusion, mem_hbm)
        st = eng.initial_state(inst.exports[func][1], args)
        ref, tp = on_cpu(st), cpu_tables(eng)
        wk, wp = new_warps(eng), cpu_warps(eng)
        careful = None
        if eng.tables.optimistic:
            ceng = make_engine(data, lanes, fuel_per_launch=fuel,
                               fusion=fusion, mem_hbm=mem_hbm,
                               optimistic=False, **knobs)[0]
            careful = st.clone()
        launches = 0
        before = dict(interp.LAUNCHES)
        torch.cuda.synchronize()
        interp.clear_bulk_counts()
        while True:
            interp.run_chunk(eng.tables, st, chunk, fuel is not None, wk)
            interp_ref.run_chunk(tp, ref, chunk, fuel is not None, wp)
            if careful is not None:
                interp.run_chunk(ceng.tables, careful, chunk,
                                 fuel is not None)
            torch.cuda.synchronize()
            launches += 1
            err = max(max_abs_err(st, ref), warp_err(wk, wp))
            worst = max(worst, err)
            if mem_hbm:
                WINDOW_WORST[0] = max(WINDOW_WORST[0], err)
            if err != 0:
                fail(f"kernel != plain on {name}{tag} after launch "
                     f"{launches}: max abs err {err}")
            if careful is not None:
                OPT_WORST["plain"] = max(OPT_WORST["plain"], err)
                cerr = live_err(st, careful)
                OPT_WORST["careful"] = max(OPT_WORST["careful"], cerr)
                if cerr != 0:
                    fail(f"optimistic != careful on {name}{tag} after "
                         f"launch {launches}: max abs err {cerr} (rows "
                         f"below sp)")
            if not bool((st.trap == 0).any()):
                break
            if launches == 200:
                fail(f"{name}: lanes still running after {launches} "
                     f"launches")
        ran = {k: interp.LAUNCHES[k] - before[k] for k in before}
        kernels = launches * (1 if careful is None else 2)
        if ran["interp"] != kernels or \
                ran["window"] != (kernels if mem_hbm else 0):
            fail(f"{name}{tag}: {ran['window']} of {ran['interp']} "
                 f"launches ran the window cache")
        if ran["optimistic"] != (0 if careful is None else launches):
            fail(f"{name}{tag}: {ran['optimistic']} of {ran['interp']} "
                 f"launches ran optimistic convergence")
        stats = wk.stats() if wk is not None else {}
        ops = interp.bulk_counts(eng.tables) if eng.tables.has_bulk else {}
        if bulk == "warp":
            BULK_FIXTURES[f"{name}{tag}"] = ops
            if not ops["warp_passes"]:
                fail(f"{name}{tag}: no bulk op took the warp pass ({ops})")
        if careful is not None:
            OPT_FIXTURES[f"{name}{tag}"] = stats
            if rollbacks is not None and \
                    (stats["rollbacks"] > 0) != rollbacks:
                fail(f"{name}{tag}: {stats['rollbacks']} rollbacks, "
                     f"expected {'some' if rollbacks else 'none'}")
        traps = sorted(set(st.trap.cpu().tolist()))
        print(f"kernel_vs_plain {name}{tag}: {launches} launches equal"
              f"{', equal to careful below sp' if careful is not None else ''}"
              f", traps {traps}, retired {int(st.retired.sum())}, warps "
              f"{stats}{f', bulk ops {ops}' if ops else ''}, "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    return worst


def scalar_jobs() -> list:
    """The per-op kernel's fixtures at KERNEL_LANES lanes (kernel_vs_plain
    jobs): kernel and plain version from the same state, launch by
    launch, all planes equal."""
    from wasmedge_tpu_torch.models import (
        build_bulk_workload, build_coremark_kernel, build_fib,
        build_memory_workload)
    from wasmedge_tpu_torch.models.fixtures import (
        alu_args, build_alu_edge, build_bulk_zoo, build_oob_mix,
        build_trap_zoo, build_window_walk, bulk_zoo_args, oob_args,
        zoo_args)

    L = KERNEL_LANES
    knobs = dict(value_stack_depth=64, call_stack_depth=32,
                 memory_pages_per_lane=3)
    fixtures = [
        ("alu", build_alu_edge(), "alu", alu_args(L, SEED), 256, None),
        ("alu_traps", build_alu_edge(), "alu_traps", alu_args(L, SEED + 1),
         256, None),
        ("traps_grow_memory", build_trap_zoo(), "zoo", zoo_args(L, SEED),
         64, None),
        ("fib_divergent", build_fib(), "fib", [np.arange(L) % 9 + 3], 256,
         None),
        ("fib_fuel", build_fib(), "fib", [np.arange(L) % 9 + 3], 256, 700),
        ("coremark", build_coremark_kernel(), "coremark",
         [np.arange(L) % 20 + 1], 256, None),
        ("coremark_fuel", build_coremark_kernel(), "coremark",
         [np.arange(L) % 20 + 1], 13, 501),
        ("oob_mix", build_oob_mix(), "oob", oob_args(L, SEED), 13, None),
        ("mem_checksum", build_memory_workload(), "mem_checksum",
         [np.arange(L) % 30 + 1], 256, None),
        ("window_walk", build_window_walk(), "edgewalk",
         [np.arange(L) % 120 + 3], 64, None),
        ("bulk_fill", build_bulk_zoo(), "fill",
         bulk_zoo_args(L, "fill", SEED), 64, None),
        ("bulk_copy", build_bulk_zoo(), "copy",
         bulk_zoo_args(L, "copy", SEED + 1), 64, None),
        # the bulk op is each lane's 4th instruction: fuel runs out on it
        ("bulk_copy_fuel", build_bulk_zoo(), "copy",
         bulk_zoo_args(L, "copy", SEED + 2), 64, 4),
        ("bulk_workload", build_bulk_workload(**SMALL_BULK), "bulk",
         [np.arange(L) * 37 + 5, 3], 256, None),
    ]
    return [("kernel_vs_plain", (*f, knobs), {}) for f in fixtures]


def fused_fixtures(L: int):
    """(name, module, export, args, steps per launch, fuel, knobs, simd)
    of the fused kernels' fixtures at L lanes."""
    from wasmedge_tpu_torch.models import (
        build_bulk_workload, build_coremark_kernel, build_fac, build_fib,
        build_loop_sum, build_memory_workload, build_simd_loop)
    from wasmedge_tpu_torch.models.fixtures import (
        build_block_terminals, build_call_traps, build_guard_mix,
        build_many_heads, build_oob_mix, build_trap_zoo, build_vmix,
        build_vsub_blocks, build_window_pingpong, build_window_walk,
        oob_args, simd_sweep_args, window_pingpong_args, zoo_args)

    kn = dict(value_stack_depth=64, call_stack_depth=32,
              memory_pages_per_lane=3)
    kv = dict(value_stack_depth=64, call_stack_depth=16,
              memory_pages_per_lane=1)
    terms, traps = build_block_terminals(), build_call_traps()
    # B2 instance cases: each terminal run in its case, calls that trap
    # (both stacks run out on one call at depths 84 / 16: E_STACK_OVERFLOW
    # wins, as in the per-op step), the budget and fuel edges of entry's
    # first block (4 instructions, its call included), more block heads
    # than the cap (lowered to HEADS_CAP in this build: what falls back
    # does not depend on the cap's size, and a build at the package's
    # 1,024 cases takes minutes of nvcc); B7 inlined per sub: blocks
    # holding every v2 and v1 sub
    instances = [
        ("block_terminals", terms, "terms", [np.arange(L) * 5 + 1], 13,
         None, kv, False),
        ("block_terminals_256", terms, "terms", [np.arange(L) * 5 + 1],
         256, None, kv, False),
        ("void_return_depth_0", terms, "void_top", [np.arange(L) * 3], 7,
         None, kv, False)]
    instances += [(f"call_block_steps_{n}", terms, "entry",
                   [np.arange(L) * 5 + 1], n, None, kv, False)
                  for n in (3, 4, 5)]
    instances += [(f"call_block_fuel_{n}", terms, "entry",
                   [np.arange(L) * 5 + 1], 64, n, kv, False)
                  for n in (3, 4, 5)]
    instances += [
        ("call_stack_exhausted", traps, "deep", [np.arange(L) % 24], 64,
         None, dict(kv, value_stack_depth=256), False),
        ("stack_overflow", traps, "deep", [np.arange(L) % 24], 64, None,
         dict(kv, call_stack_depth=64), False),
        ("call_both_limits", traps, "deep", [np.arange(L) % 24], 64, None,
         dict(kv, value_stack_depth=84), False),
        ("heads_over_cap", build_many_heads(HEADS_CAP + 40), "heads",
         [np.arange(L) * 7919 + 1], 4096, None,
         dict(kv, instance_cap=HEADS_CAP), False),
        ("vsub_blocks", build_vsub_blocks(), "f", simd_sweep_args(L, SEED),
         97, None, kv, True),
        ("vsub_blocks_corners", build_vsub_blocks(), "f",
         simd_sweep_args(L, SEED, corners=True), 97, None, kv, True)]
    return instances + [
        ("fib_divergent", build_fib(), "fib", [np.arange(L) % 9 + 3], 256,
         None, kn, False),
        ("fib_mix_13", build_fib(), "fib", [np.arange(L) % 7 + 2], 13, None,
         kn, False),
        ("fib_fuel", build_fib(), "fib", [np.arange(L) % 9 + 3], 256, 700,
         kn, False),
        ("fac", build_fac(), "fac", [np.arange(L) * 3], 13, None, kn, False),
        ("loop_sum", build_loop_sum(), "loop_sum", [np.arange(L) % 50 * 7],
         256, None, kn, False),
        ("mem_checksum", build_memory_workload(), "mem_checksum",
         [np.arange(L) % 30 + 1], 256, None, kn, False),
        ("coremark", build_coremark_kernel(), "coremark",
         [np.arange(L) % 20 + 1], 256, None, kn, False),
        ("coremark_fuel", build_coremark_kernel(), "coremark",
         [np.arange(L) % 20 + 1], 13, 501, kn, False),
        ("traps_grow_memory", build_trap_zoo(), "zoo", zoo_args(L, SEED),
         64, None, kn, False),
        ("guard_mix", build_guard_mix(), "guard",
         [np.arange(L) * 5 - 3, np.arange(L) % 7 + 1], 13, None, kn, False),
        ("oob_mix", build_oob_mix(), "oob", oob_args(L, SEED), 13, None, kn,
         False),
        ("bulk_workload", build_bulk_workload(**SMALL_BULK), "bulk",
         [np.arange(L) * 37 + 5, 3], 256, None, kn, False),
        ("vmix", build_vmix(), "vmix", [np.arange(L) % 13 + 3], 64, None, kv,
         True),
        ("vmix_fuel", build_vmix(), "vmix", [np.arange(L) % 13 + 3], 13, 40,
         kv, True),
        ("vloop", build_simd_loop(), "vloop", [np.arange(L) % 40], 256, None,
         kv, True),
        ("window_walk", build_window_walk(), "edgewalk",
         [np.arange(L) % 120 + 3], 64, None, kn, False),
        ("window_pingpong", build_window_pingpong(), "pingpong",
         window_pingpong_args(L, SEED), 64, None, kv, True),
    ]


def fused_jobs() -> list:
    """The B2 ("blocks") and B6 ("super", modules without v128 ops) fused
    kernels against their plain versions at KERNEL_LANES lanes, every
    launch, every plane and every stack row; WASI echo with its serve
    rounds in both encodings (jobs)."""
    jobs = []
    for name, data, func, args, chunk, fuel, knobs, simd in \
            fused_fixtures(KERNEL_LANES):
        for fusion in ("blocks",) if simd else ("blocks", "super"):
            jobs.append(("kernel_vs_plain", (name, data, func, args, chunk,
                                             fuel, knobs, fusion), {}))
    for fusion in ("blocks", "super"):
        jobs += host_jobs(fusion, ("env.double", "wasi_echo", "window_host"))
    return jobs


def opt_fixtures(L: int):
    """(name, module, export, args, steps per launch, knobs, simd,
    rollbacks) of optimistic convergence's fixtures at L lanes:
    rollbacks True where a warp must roll back, False where none may."""
    from wasmedge_tpu_torch.models import build_fib
    from wasmedge_tpu_torch.models.fixtures import (
        build_call_sites, build_divergent_addresses,
        build_nonzero_conditions, build_rollback_rows, build_trap_zoo,
        build_vmix, build_window_pingpong, window_pingpong_args, zoo_args)

    kn = dict(value_stack_depth=64, call_stack_depth=32,
              memory_pages_per_lane=3)
    kv = dict(value_stack_depth=64, call_stack_depth=16,
              memory_pages_per_lane=1)
    pp = window_pingpong_args(L, SEED)
    return [
        ("opt_fib_converged", build_fib(), "fib", [np.full(L, 10)], 600,
         kn, False, False),
        ("opt_fib_3_11", build_fib(), "fib", [np.arange(L) % 11 + 3], 256,
         kn, False, True),
        ("opt_trap_zoo", build_trap_zoo(), "zoo", zoo_args(L, SEED), 64, kn,
         False, True),
        ("opt_divergent_addresses", build_divergent_addresses(), "f",
         [np.arange(L) * 516 % 65000], 64, kn, False, True),
        ("opt_nonzero_conditions", build_nonzero_conditions(), "f",
         [np.arange(L) * 7919 + 3], 64, kn, False, False),
        # warps that start launches converged inside a function each lane
        # entered from its own call site: the return is a decision
        ("opt_call_sites", build_call_sites(), "f", [np.arange(L)], 64, kn,
         False, True),
        ("opt_window_pingpong", build_window_pingpong(), "pingpong", pp, 64,
         kv, True, True),
        ("opt_window_pingpong_converged", build_window_pingpong(),
         "pingpong", [np.full(L, int(a[min(5, L - 1)])) for a in pp], 64,
         kv, True, False),
        ("opt_vmix", build_vmix(), "vmix", [np.arange(L) % 13 + 3], 64, kv,
         True, True),
        # lanes that follow lane 0's arm write wrong values into the
        # (on-chip) rows of two locals below sp until the rollback
        ("opt_rollback_rows", build_rollback_rows(), "f",
         [np.random.default_rng(SEED).integers(0, 1 << 31, L)], 64, kn,
         False, True),
    ]


def opt_jobs() -> list:
    """B3: optimistic convergence's fixtures at KERNEL_LANES lanes in
    every encoding (superinstructions for modules without v128 ops) and,
    with a memory, both memory modes: kernel against plain version and
    careful kernel (kernel_vs_plain), rollbacks where the lanes diverge
    and none where they agree (jobs)."""
    jobs = []
    for name, data, func, args, chunk, knobs, simd, rolls in \
            opt_fixtures(KERNEL_LANES):
        for fusion in ("none", "blocks") + (() if simd else ("super",)):
            jobs.append(("kernel_vs_plain", (name, data, func, args, chunk,
                                             None, knobs, fusion, rolls), {}))
    return jobs


def rows_jobs() -> list:
    """B5's warp pass and the on-chip stack rows against their plain
    versions (kernel_vs_plain jobs: both memory modes, optimistic and
    careful, every plane and row after every launch): build_bulk_warp's
    fill and copy in every case of BULK_WARP_CASES at KERNEL_LANES lanes
    (converged with byte shifts 0-3 forward and backward, lane-dependent
    with one and with two deltas in a warp, a lane out of bounds and n == 0
    lanes in a converged warp), some of them at 100 lanes (a partial last
    warp) and 99 (rows not 16-byte aligned), every one required to take
    warp passes; two in blocks; and first a recursion whose stack crosses
    the 512 on-chip rows of a 1024-row stack, in blocks (the build with
    the stack split; its terminals run the per-op code).  The
    host-call park with live rows (host_rows) and the rollback over rows
    below sp (opt_rollback_rows) are among host_jobs and opt_jobs."""
    from wasmedge_tpu_torch.models.fixtures import (
        BULK_WARP_CASES, build_bulk_warp, build_deep_recursion,
        bulk_warp_case)

    kb = dict(value_stack_depth=64, call_stack_depth=16,
              memory_pages_per_lane=1)
    data = build_bulk_warp()
    partial = ("fill_lanes", "copy_fwd_shift3", "copy_bwd_shift1",
               "copy_two_deltas", "copy_oob_and_empty")
    deep = dict(value_stack_depth=1024, call_stack_depth=128)
    jobs = [("kernel_vs_plain", (
        "deep_recursion_d1024", build_deep_recursion(), "deep",
        [np.arange(KERNEL_LANES) % 40 + 48], 97, None, deep, "blocks"), {})]
    for L in (KERNEL_LANES, 100, 99):
        for case in BULK_WARP_CASES:
            if L != KERNEL_LANES and case not in partial:
                continue
            func, args = bulk_warp_case(L, case)
            jobs.append(("kernel_vs_plain", (
                f"bulk_warp_{case}_x{L}", data, func, args, 8, None, kb),
                dict(lanes=L, bulk="warp")))
    for case in ("copy_two_deltas", "fill_oob_and_empty"):
        func, args = bulk_warp_case(KERNEL_LANES, case)
        jobs.append(("kernel_vs_plain", (
            f"bulk_warp_{case}", data, func, args, 8, None, kb),
            dict(fusion="blocks", bulk="warp")))
    return jobs


# worker processes of the kernel phase: its comparisons are independent,
# and each one's plain side runs on the CPU
WORKERS = 6


def run_job(job):
    """One kernel phase job in a worker process: (group, worst, the
    worker's records, None), or (group, None, None, what failed)."""
    group, name, args, kwargs = job
    torch.set_num_threads(1)
    WINDOW_WORST[0] = 0
    OPT_WORST.update(plain=0, careful=0)
    OPT_FIXTURES.clear()
    BULK_FIXTURES.clear()
    try:
        worst = globals()[name](*args, **kwargs)
    except SystemExit:
        return group, None, None, f"{name} {args[0] if args else ''}"
    return group, worst, dict(window=WINDOW_WORST[0], opt=dict(OPT_WORST),
                              opt_fixtures=dict(OPT_FIXTURES),
                              bulk=dict(BULK_FIXTURES)), None


def run_jobs(groups: dict) -> dict:
    """Every job of `groups` (group name -> jobs) on WORKERS worker
    processes (spawned; each builds nothing: the libraries exist); the
    records merged into this process's.  Returns group -> worst max abs
    err; fails if any job failed."""
    import concurrent.futures
    import multiprocessing

    jobs = [(g,) + j for g, js in groups.items() for j in js]
    worst = {g: 0 for g in groups}
    bad = []
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(WORKERS,
                                                mp_context=ctx) as ex:
        for group, w, rec, err in ex.map(run_job, jobs):
            if err is not None:
                bad.append(err)
                continue
            worst[group] = max(worst[group], w)
            WINDOW_WORST[0] = max(WINDOW_WORST[0], rec["window"])
            for k in OPT_WORST:
                OPT_WORST[k] = max(OPT_WORST[k], rec["opt"][k])
            OPT_FIXTURES.update(rec["opt_fixtures"])
            BULK_FIXTURES.update(rec["bulk"])
    if bad:
        fail(f"{len(bad)} kernel phase jobs failed: {bad[:5]}")
    return worst


def first_step_at(data, func, args, hid, knobs) -> int:
    """Steps before lane 0 first sits at handler `hid` (plain version,
    careful)."""
    from wasmedge_tpu_torch.batch import interp_ref

    eng, inst = make_engine(data, len(args[0]), device="cpu", fusion="none",
                            optimistic=False, **knobs)
    st = eng.initial_state(inst.exports[func][1], args)
    for step in range(10_000):
        if int(eng.tables.hid[int(st.pc[0])]) == hid:
            return step
        interp_ref.run_chunk(eng.tables, st, 1, False)
    fail(f"{func}: handler {hid} never reached")


def simd_jobs() -> list:
    """The v128 fixtures at KERNEL_LANES lanes through the kernel's kSimd
    instantiations and the plain version, every plane (stack_e2 and
    stack_e3 included) equal after every launch (jobs)."""
    from wasmedge_tpu_torch.batch.interp import H_VSTORE
    from wasmedge_tpu_torch.models import build_simd_loop
    from wasmedge_tpu_torch.models.fixtures import (
        build_simd_sweep, build_v128_control, build_v128_mem_zoo, build_vmix,
        build_window_pingpong, simd_sweep_args, simd_sweeps, v128_zoo_args,
        window_pingpong_args)

    L = KERNEL_LANES
    knobs = dict(value_stack_depth=64, call_stack_depth=16,
                 memory_pages_per_lane=1)
    fixtures = []
    for i, (k, bodies) in enumerate(simd_sweeps().items()):
        for corners in (False, True):
            fixtures.append((f"sweep_{k}{'_corners' if corners else ''}",
                             build_simd_sweep(bodies), "f",
                             simd_sweep_args(L, SEED + i, corners), 64, None))
    zoo = v128_zoo_args(L, SEED)
    store_fuel = first_step_at(build_v128_mem_zoo(), "rw", zoo, H_VSTORE,
                               knobs) + 1
    fixtures += [
        ("vmix", build_vmix(), "vmix", [np.arange(L) % 13 + 3], 64, None),
        ("vloop", build_simd_loop(), "vloop", [np.arange(L) % 40], 256,
         None),
        ("v128_mem_zoo", build_v128_mem_zoo(), "rw", zoo, 64, None),
        ("v128_mem_carry", build_v128_mem_zoo(), "wrap",
         [np.resize(np.array([0, 4, 7, 8, 9, 16, 0x20, -16]), L),
          np.arange(L)], 64, None),
        ("v128_control", build_v128_control(), "ctl",
         [np.arange(L, dtype=np.int64) * 0x123456789 - 7,
          np.arange(L) * 5 + 3], 64, None),
        # fuel runs out on the first instruction (v128.const) and on the
        # zoo's first v128.store
        ("vmix_fuel_v128_const", build_vmix(), "vmix",
         [np.arange(L) % 13 + 3], 64, 1),
        ("v128_zoo_fuel_store", build_v128_mem_zoo(), "rw", zoo, 64,
         store_fuel),
        ("window_pingpong", build_window_pingpong(), "pingpong",
         window_pingpong_args(L, SEED), 64, None),
    ]
    return [("kernel_vs_plain", (*f, knobs), {}) for f in fixtures]


def env_import():
    """The "env" host module of models.fixtures.host_env_funcs."""
    from wasmedge_tpu_torch.common.errors import ErrCode, trap
    from wasmedge_tpu_torch.models.fixtures import HOST_MODULE, host_env_funcs
    from wasmedge_tpu_torch.runtime.hostfunc import (
        ImportObject, PyHostFunction)

    imp = ImportObject(HOST_MODULE)
    funcs = host_env_funcs(lambda: trap(ErrCode.ExecutionFailed))
    for name, (fn, params, results) in funcs.items():
        imp.add_func(name, PyHostFunction(fn, params, results))
    return imp


def wasi_import(fd: int):
    """A WASI host module whose stdout is the file descriptor `fd`."""
    from wasmedge_tpu_torch.host.wasi import WasiModule

    wasi = WasiModule()
    wasi.init_wasi(args=list(WASI_ARGS))
    wasi.env.fds[1].os_fd = fd
    return wasi


def hello_output(codes) -> bytes:
    from wasmedge_tpu_torch.models.programs import wasi_hello_output

    return b"".join(wasi_hello_output(["wasm"] + WASI_ARGS, int(c))
                    for c in codes)


# the host-call fixtures of phase_hostcalls_kernel_vs_plain
HOST_FIXTURES = ("env.double", "env.poke", "env.id_or_trap", "env.grow",
                 "env.double_v128", "wasi_echo", "wasi_hello", "window_host",
                 "host_rows")


def host_jobs(fusion="none", names=HOST_FIXTURES) -> list:
    """phase_hostcalls_kernel_vs_plain in the encoding `fusion`, one job
    per fixture."""
    return [("phase_hostcalls_kernel_vs_plain", (fusion,),
             dict(only=(name,))) for name in names]


def phase_hostcalls_kernel_vs_plain(fusion="none", only=None) -> int:
    """The host-call fixtures (those named in `only`, or all) at
    KERNEL_LANES lanes in the encoding `fusion`, with a memory through
    the window cache and with direct access: kernel and plain version
    from the same CUDA state, each state with its own engine, host
    modules and serve round after every launch; every plane equal before
    and after each serve round, and the kernel side's stdout file
    byte-identical to the plain side's."""
    from wasmedge_tpu_torch.models import build_echo, build_wasi_hello
    from wasmedge_tpu_torch.models.fixtures import (
        build_host_double, build_host_grow, build_host_poke,
        build_host_rows, build_host_trap, build_simd_host, build_window_host)
    from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE

    L = KERNEL_LANES
    knobs = dict(value_stack_depth=64, call_stack_depth=16,
                 memory_pages_per_lane=3)
    hello_codes = np.arange(L) % 3
    fixtures = [
        ("env.double", build_host_double(), "f", [np.arange(L) * 10 - 7],
         None),
        ("env.poke", build_host_poke(), "f", [np.arange(L) * 3 + 100], None),
        ("env.id_or_trap", build_host_trap(), "f", [np.arange(L) % 8], None),
        ("env.grow", build_host_grow(), "f", [np.arange(L) % 5], None),
        # v128 words in the rows under env.double's frame (kSimd)
        ("env.double_v128", build_simd_host(), "f", [np.arange(L) * 9 - 20],
         None),
        ("wasi_echo", build_echo(), "echo", [np.full(L, 2)],
         ECHO_MESSAGE * (4 * L)),
        ("wasi_hello", build_wasi_hello(), "hello", [hello_codes],
         hello_output(hello_codes)),
        # a store, then a park in the same window: the serve round and the
        # next launch read the plane
        ("window_host", build_window_host(), "f", [np.arange(L) * 7 - 300],
         None),
        # three parks with live (on-chip) rows under each call
        ("host_rows", build_host_rows(), "f", [np.arange(L) * 13 - 40], None),
    ]
    worst = 0
    for name, data, func, args, want_out in fixtures:
        if only is not None and name not in only:
            continue
        imports = (lambda fd: [wasi_import(fd) if want_out is not None
                               else env_import()])
        for mem_hbm, _ in memory_modes(lambda m: make_engine(
                data, L, imports=imports(1), fusion=fusion, mem_hbm=m,
                **knobs)):
            worst = max(worst, host_fixture_vs_plain(
                name, data, func, args, want_out, fusion, mem_hbm, knobs,
                imports))
            if name == "window_host" and mem_hbm is None:
                fail("window_host: the module runs without the window cache")
    return worst


def host_fixture_vs_plain(name, data, func, args, want_out, fusion, mem_hbm,
                          knobs, imports) -> int:
    """One host-call fixture of phase_hostcalls_kernel_vs_plain in one
    encoding and memory mode."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.batch.hostcall import serve_batch_state
    from wasmedge_tpu_torch.common.errors import ErrCode

    L = KERNEL_LANES
    hello_codes = np.arange(L) % 3
    worst = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        paths = [os.path.join(td, k) for k in ("kernel", "plain")]
        fds = [os.open(p, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
               for p in paths]
        try:
            engs = [make_engine(data, L, device=dev, imports=imports(fd),
                                fusion=fusion, mem_hbm=mem_hbm,
                                **knobs)[0]
                    for fd, dev in zip(fds, ("cuda", "cpu"))]
            inst = engs[0].inst
            st = engs[0].initial_state(inst.exports[func][1], args)
            ref = on_cpu(st)
            wk, wp = new_warps(engs[0]), cpu_warps(engs[1])
            launches = rounds = 0
            while True:
                interp.run_chunk(engs[0].tables, st, 64, False, wk)
                interp_ref.run_chunk(engs[1].tables, ref, 64, False, wp)
                torch.cuda.synchronize()
                launches += 1
                err = max(max_abs_err(st, ref), warp_err(wk, wp))
                if wk is not None:
                    OPT_WORST["plain"] = max(OPT_WORST["plain"], err)
                served = serve_batch_state(engs[0], st)
                if serve_batch_state(engs[1], ref) != served:
                    fail(f"{name}: the two serve rounds served "
                         f"different lanes")
                rounds += served > 0
                err = max(err, max_abs_err(st, ref))
                worst = max(worst, err)
                if mem_hbm:
                    WINDOW_WORST[0] = max(WINDOW_WORST[0], err)
                if err != 0:
                    fail(f"kernel != plain on {name}"
                         f"{mode_tag(fusion, mem_hbm)} around serve "
                         f"round after launch {launches}: max abs err "
                         f"{err}")
                if not bool((st.trap == 0).any()):
                    break
                if launches == 200:
                    fail(f"{name}: lanes still running after "
                         f"{launches} launches")
        finally:
            for fd in fds:
                os.close(fd)
        outs = [open(p, "rb").read() for p in paths]
    if outs[0] != outs[1]:
        fail(f"{name}: kernel stdout ({len(outs[0])} B) != plain "
             f"stdout ({len(outs[1])} B)")
    if want_out is not None and outs[0] != want_out:
        fail(f"{name}: stdout is not the expected {len(want_out)} B")
    trap = st.trap.cpu().numpy()
    if name == "wasi_hello":
        codes = st.stack_lo.cpu().numpy()[st.fp.cpu().numpy(),
                                          np.arange(L)]
        if not (trap == int(ErrCode.Terminated)).all() or \
                not (codes == hello_codes).all():
            fail("wasi_hello: lanes did not exit with their codes")
    if name == "window_host":
        x = np.asarray(args[0], np.int64)
        got = st.stack_lo.cpu().numpy()[0].view(np.uint32)
        if not (trap == -1).all() or \
                not (got == ((5 * x + 1) & 0xFFFFFFFF)).all():
            fail("window_host: results are not 5x + 1")
    stats = wk.stats() if wk is not None else {}
    if wk is not None:
        OPT_FIXTURES[f"{name}{mode_tag(fusion, mem_hbm)}"] = stats
    print(f"kernel_vs_plain {name}{mode_tag(fusion, mem_hbm)}: "
          f"{launches} launches and {rounds} serve rounds equal, traps "
          f"{sorted(set(trap.tolist()))}, stdout {len(outs[0])} B "
          f"identical, warps {stats}, {time.perf_counter() - t0:.2f} s",
          flush=True)
    return worst


def time_launch(fn, state, reps: int):
    """Median, 25th and 75th percentile ms of fn(state_copy) over reps
    (CUDA events, a fresh copy of the state each time)."""
    times = []
    for _ in range(reps):
        s = state.clone()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(s)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    q25, med, q75 = np.percentile(times, [25, 50, 75])
    return float(med), float(q25), float(q75), s


def handler_bytes(h: int, b: int) -> int:
    """State-plane bytes that the kernel's handler `h` (interp.cu) reads
    and writes for one instruction whose `b` operand is `b`: 8 per (lo, hi)
    stack or global cell, 4 per frame or memory word.  A conditional
    branch counts as not taken, so this is the least the handler moves."""
    from wasmedge_tpu_torch.batch import interp as I

    if I.H_ALU2_BASE <= h < I.H_ALU1_BASE:
        return 24  # two operand cells read, one result written
    if I.H_ALU1_BASE <= h < I.H_ALU1_BASE + I.NUM_ALU1:
        return 16
    return {
        I.H_NOP: 0, I.H_DROP: 0, I.H_TRAP: 0, I.H_CONST: 8, I.H_MEMSIZE: 8,
        I.H_LOCAL_GET: 16, I.H_LOCAL_SET: 16, I.H_LOCAL_TEE: 16,
        I.H_GLOBAL_GET: 16, I.H_GLOBAL_SET: 16, I.H_MEMGROW: 16,
        I.H_SELECT: 32, I.H_BR: 16 * b, I.H_BRZ: 8, I.H_BRNZ: 8,
        I.H_BR_TABLE: 8,
        I.H_RETURN: 12 + 16 * b,  # frame row read, result cell moved
        I.H_CALL: 12, I.H_CALL_INDIRECT: 20,  # frame row written
        # address cell, the three memory words read, result cell
        I.H_LOAD: 28, I.H_LOAD_W: 28, I.H_LOAD_D: 28,
        # address and value cells, three words read, one or two written
        I.H_STORE: 32, I.H_STORE_W: 32, I.H_STORE_D: 36,
    }[h]


def launch_mix(tables, st0, steps: int):
    """Step the plain version one instruction at a time through the launch
    that is timed: how often each pc was retired, and the deepest stack
    row and call depth the launch reaches."""
    from wasmedge_tpu_torch.batch import interp_ref

    s = st0.clone()
    n = tables.hid.shape[0]
    counts = torch.zeros(n, dtype=torch.int64, device=s.pc.device)
    max_sp, max_cd = s.sp.max(), s.call_depth.max()
    for _ in range(steps):
        pcs = s.pc[s.trap == 0].clamp(0, n - 1).long()
        counts += torch.bincount(pcs, minlength=n)
        interp_ref.run_chunk(tables, s, 1, False)
        max_sp = torch.maximum(max_sp, s.sp.max())
        max_cd = torch.maximum(max_cd, s.call_depth.max())
    return counts.cpu().numpy(), int(max_sp), int(max_cd)


def time_opt_and_careful(eng, ceng, st0, chunk: int, what: str,
                         refused: bool = True):
    """One launch of `chunk` steps from st0 through the kernel the main
    path runs, optimistic convergence on (B3, the default: `eng`), and
    through the careful kernel of the same module, encoding and memory
    mode (`ceng`, `optimistic` False), 21 runs each, in the order
    optimistic, careful, careful, optimistic; the optimistic plain version
    on the same inputs (3 runs, a fresh per-warp state each).  The kernel
    must equal its plain version on every plane and row and in the
    per-warp counts, and the careful kernel below sp.  With `refused`, the
    same launch with lane 0 of every warp stopped, so that no warp enters:
    the optimistic build runs its careful loop only, against the careful
    build on that state (every plane equal).  Returns the record and the
    optimistic kernel's output."""
    from wasmedge_tpu_torch.batch import interp, interp_ref

    L = st0.pc.shape[0]
    wt = new_warps(eng)
    kernel = lambda s: interp.run_chunk(eng.tables, s, chunk, False, wt)
    careful = lambda s: interp.run_chunk(ceng.tables, s, chunk, False)
    kernel(st0.clone())  # warm-up, and the shadow planes allocated
    careful(st0.clone())
    torch.cuda.synchronize()
    ms, k25, k75, out_k = time_launch(kernel, st0, 21)
    c_ms, c25, c75, out_c = time_launch(careful, st0, 21)
    c_ms2, _, _, _ = time_launch(careful, st0, 21)
    ms2, _, _, _ = time_launch(kernel, st0, 21)
    held = {}

    def plain(s):
        held["w"] = new_warps(eng)
        interp_ref.run_chunk(eng.tables, s, chunk, False, held["w"])

    plain_ms, p25, p75, out_p = time_launch(plain, st0, 3)
    wk = new_warps(eng)
    one = st0.clone()
    interp.run_chunk(eng.tables, one, chunk, False, wk)
    torch.cuda.synchronize()
    err = max(max_abs_err(out_k, out_p), max_abs_err(one, out_p),
              warp_err(wk, held["w"]))
    cerr = live_err(out_k, out_c)
    if err != 0 or cerr != 0:
        fail(f"{what}: optimistic kernel != plain (max abs err {err}) or "
             f"!= careful below sp ({cerr})")
    OPT_WORST["plain"] = max(OPT_WORST["plain"], err)
    OPT_WORST["careful"] = max(OPT_WORST["careful"], cerr)
    stats = wk.stats()
    if stats["rollbacks"] or stats["entered"] != (L + 31) // 32:
        fail(f"{what}: a converged launch's warps {stats}")
    out = dict(ms=ms, q25=k25, q75=k75, ms_again=ms2, careful_ms=c_ms,
               careful_q25=c25, careful_q75=c75, careful_ms_again=c_ms2,
               plain_ms=plain_ms, plain_q25=p25, plain_q75=p75,
               max_abs_err=err, careful_err=cerr, warps=stats)
    line = (f"one launch of {chunk} steps x {L} lanes ({what}): optimistic "
            f"kernel median {ms:.4f} ms (q25 {k25:.4f}, q75 {k75:.4f}; "
            f"again {ms2:.4f}), careful kernel {c_ms:.4f} ms (q25 "
            f"{c25:.4f}, q75 {c75:.4f}; again {c_ms2:.4f}), 21 runs each; "
            f"optimistic plain median {plain_ms:.2f} ms (q25 {p25:.2f}, "
            f"q75 {p75:.2f}, 3 runs); warps {stats}")
    if refused:
        st_r = st0.clone()
        st_r.trap[0::32] = -1  # lane 0 of each warp done: no warp enters
        wr = new_warps(eng)
        r_ms, _, _, out_r = time_launch(
            lambda s: interp.run_chunk(eng.tables, s, chunk, False, wr),
            st_r, 21)
        rc_ms, _, _, out_rc = time_launch(careful, st_r, 21)
        rerr = max_abs_err(out_r, out_rc)
        if rerr != 0 or wr.stats()["entered"] != 0:
            fail(f"{what}: with entry refused the optimistic build != the "
                 f"careful one (max abs err {rerr}; warps {wr.stats()})")
        out.update(refused_ms=r_ms, refused_careful_ms=rc_ms)
        line += (f"; entry refused (lane 0 of each warp stopped): "
                 f"optimistic build {r_ms:.4f} ms, careful build "
                 f"{rc_ms:.4f} ms, equal")
    print(line, flush=True)
    return out, out_k


def snapshot_bytes(st0, stats, max_cd: int, planes: int,
                   mem_direct: bool) -> int:
    """The least bytes optimistic convergence adds to a launch from st0
    whose warps all ran on without a rollback (opt_save, opt_save_frame
    and the counters of optimistic.cuh / interp.cu): the entry snapshot
    (each lane's rows below its sp in `planes` stack planes, its frame
    rows below its depth, the globals and, with `mem_direct`, its memory
    column) read once and written once; the frame rows from the entry
    depth to the deepest `max_cd` saved on their first write; each later
    snapshot's globals and memory column (its stack and frame rows not
    counted); and the four per-warp counters read and written."""
    L = st0.pc.shape[0]
    NG = st0.glob_lo.shape[0]
    W = st0.mem.shape[0] if mem_direct and st0.mem.shape[0] > 1 else 0
    per_snap = 2 * NG + W
    entry = planes * int(st0.sp.sum()) + \
        3 * int(st0.call_depth.sum()) + L * per_snap
    frames = 3 * int((max_cd - st0.call_depth).clamp(min=0).sum())
    later = max(stats["commits"] - stats["entered"], 0) * 32 * per_snap
    counters = 4 * ((L + 31) // 32)
    return 2 * 4 * (entry + frames + later + counters)


def phase_time_one_launch(fusion="none"):
    """One launch of TIMED_STEPS steps from the flagship's initial state
    (fib(30) x 4096) in the encoding `fusion`: the optimistic kernel the
    main path runs, the careful one and the plain version
    (time_opt_and_careful), and its bound from the state that launch
    touches, its instruction mix (the same for every encoding: the launch
    retires the same instructions) and what optimistic convergence
    copies."""
    from wasmedge_tpu_torch.batch.engine import CONTROL_FIELDS
    from wasmedge_tpu_torch.models import build_fib

    chunk, L = TIMED_STEPS, MAIN_LANES
    eng, ceng = (make_engine(build_fib(), L, value_stack_depth=256,
                             call_stack_depth=256, fusion=fusion,
                             optimistic=opt)[0] for opt in (None, False))
    tb = ceng.tables
    st0 = eng.initial_state(eng.inst.exports["fib"][1], [np.full(L, 30)])
    t, out_k = time_opt_and_careful(eng, ceng, st0, chunk,
                                    f"fib(30), {fusion}")
    retired = int(out_k.retired.sum())

    # one step at a time: a fused dispatch never fits, so the plain
    # version retires each op on its own and counts it at its pc
    counts, max_sp, max_cd = launch_mix(tb, st0, chunk)
    if int(counts.sum()) != retired:
        fail(f"instruction mix counts {int(counts.sum())} instructions, "
             f"the kernel retired {retired}")
    # Least bytes: each state row the launch touches read once and written
    # once (stack rows below the deepest sp, frame rows below the deepest
    # call depth, the control planes), the code tables read once, and what
    # optimistic convergence copies (snapshot_bytes)
    touched = 4 * L * (2 * max_sp + 3 * max_cd + len(CONTROL_FIELDS))
    table_bytes = sum(4 * t_.numel() for t_ in vars(tb).values()
                      if isinstance(t_, torch.Tensor))
    careful_bytes = 2 * touched + table_bytes
    snap = snapshot_bytes(st0, t["warps"], max_cd, 2, False)
    bytes_ = careful_bytes + snap
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = retired * OPS_PER_INSTR / OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    careful_bound_ms = max(careful_bytes / HBM_BYTES_PER_S * 1e3,
                           bound_ops_ms)
    # the most a snapshot of this workload copies: stack rows below the
    # deepest sp, frame rows below the deepest depth, the globals
    NG = st0.glob_lo.shape[0]
    per_commit = 2 * 4 * L * (2 * max_sp + 3 * max_cd + 2 * NG)
    # What this kernel's handlers move through the state planes for the
    # same instructions (a stack cell is read and written again and again)
    hid0 = tb.hid if tb.hid0 is None else tb.hid0
    hid, b = hid0.cpu().numpy(), tb.b.cpu().numpy()
    traffic = sum(int(c) * handler_bytes(int(hid[pc]), int(b[pc]))
                  for pc, c in enumerate(counts) if c)
    by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    print(f"  retired {retired}; bound {bound_ms:.6f} ms by {by}: bytes "
          f"{bytes_} B (stack rows {max_sp}, frame rows {max_cd}, code "
          f"tables {table_bytes} B; snapshots {snap} B) / "
          f"{HBM_BYTES_PER_S:.3g} B/s = {bound_bytes_ms:.6f} ms, careful "
          f"{careful_bound_ms:.6f} ms; operations {retired} x "
          f"{OPS_PER_INSTR} / {OPS_PER_S:.3g} /s = {bound_ops_ms:.6f} ms; "
          f"a snapshot at this workload's deepest point copies "
          f"{per_commit} B", flush=True)
    print(f"  per-op handler traffic {traffic} B ({traffic / retired:.2f} "
          f"B per instruction), {traffic / HBM_BYTES_PER_S * 1e3:.6f} ms at "
          f"the HBM rate; touched state {touched} B, "
          f"{'within' if touched <= L2_BYTES else 'beyond'} the "
          f"{L2_BYTES:.3g} B L2", flush=True)
    return dict(t, bound_ms=bound_ms, careful_bound_ms=careful_bound_ms,
                bound_by=by, retired=retired, bound_bytes=bytes_,
                snapshot_bytes=snap, bytes_per_commit=per_commit,
                handler_traffic_bytes=traffic, touched_state_bytes=touched)


def phase_time_simd_launch(fusion="blocks"):
    """One launch of TIMED_STEPS steps of vloop(SIMD_N) x MAIN_LANES from
    its initial state in the encoding `fusion` (the main path's B2 blocks,
    or per-op): optimistic kernel, careful kernel and plain version on the
    same inputs (time_opt_and_careful), and its bound from the rows that
    launch touches."""
    from wasmedge_tpu_torch.batch.engine import CONTROL_FIELDS
    from wasmedge_tpu_torch.batch import interp as I
    from wasmedge_tpu_torch.models import build_simd_loop

    chunk, L = TIMED_STEPS, MAIN_LANES
    eng, ceng = (make_engine(build_simd_loop(), L, value_stack_depth=64,
                             call_stack_depth=16, memory_pages_per_lane=1,
                             fusion=fusion, optimistic=opt)[0]
                 for opt in (None, False))
    tb = ceng.tables
    st0 = eng.initial_state(eng.inst.exports["vloop"][1],
                            [np.full(L, SIMD_N)])
    t, out_k = time_opt_and_careful(eng, ceng, st0, chunk,
                                    f"vloop({SIMD_N}), {fusion}")
    retired = int(out_k.retired.sum())
    counts, max_sp, max_cd = launch_mix(tb, st0, chunk)
    hid = (tb.hid if tb.hid0 is None else tb.hid0).cpu().numpy()
    mem_hids = {I.H_LOAD, I.H_STORE, I.H_LOAD_W, I.H_LOAD_D, I.H_STORE_W,
                I.H_STORE_D, I.H_MEMFILL, I.H_MEMCOPY, I.H_VLOAD,
                I.H_VSTORE}
    mem_ops = sum(int(c) for pc, c in enumerate(counts)
                  if hid[pc] in mem_hids)
    if mem_ops:
        fail(f"the timed vloop launch ran {mem_ops} memory instructions; "
             f"its bound counts no memory rows")
    # Least bytes: the four stack planes' rows below the deepest sp, the
    # frame rows below the deepest call depth and the control planes,
    # each read once and written once (the launch reads or writes no
    # memory row: checked above), the code tables read once, and what
    # optimistic convergence copies (the windows are on: no memory rows)
    touched = 4 * L * (4 * max_sp + 3 * max_cd + len(CONTROL_FIELDS))
    table_bytes = sum(4 * t_.numel() for t_ in vars(tb).values()
                      if isinstance(t_, torch.Tensor))
    careful_bytes = 2 * touched + table_bytes
    if not eng.tables.mem_window:
        fail("vloop's timed launch runs without the windows")
    snap = snapshot_bytes(st0, t["warps"], max_cd, 4, False)
    bytes_ = careful_bytes + snap
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    # operations: one per scalar instruction, one per 32-bit word of a
    # v128 instruction
    ops = sum(int(c) * (4 if hid[pc] >= I.H_VCONST else 1)
              for pc, c in enumerate(counts))
    bound_ops_ms = ops / OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    careful_bound_ms = max(careful_bytes / HBM_BYTES_PER_S * 1e3,
                           bound_ops_ms)
    v128_share = sum(int(c) for pc, c in enumerate(counts)
                     if hid[pc] >= I.H_VCONST) / retired
    by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    print(f"  retired {retired}, v128 share {v128_share:.3f}; bound "
          f"{bound_ms:.6f} ms by {by}: bytes {bytes_} B (4 stack planes x "
          f"{max_sp} rows, frame rows {max_cd}, code tables {table_bytes} "
          f"B; snapshots {snap} B) / {HBM_BYTES_PER_S:.3g} B/s = "
          f"{bound_bytes_ms:.6f} ms, careful {careful_bound_ms:.6f} ms; "
          f"operations {ops} / {OPS_PER_S:.3g} /s = {bound_ops_ms:.6f} ms",
          flush=True)
    return dict(t, bound_ms=bound_ms, careful_bound_ms=careful_bound_ms,
                bound_by=by, retired=retired, bound_bytes=bytes_,
                snapshot_bytes=snap, bound_ops=ops, v128_share=v128_share)


def fib_py(n: int) -> int:
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


def run_vm(vm, func, args, fusion=None):
    """VM.execute_batch (fusion None: the encoding the VM's engine picks
    from block_fusion), or the same engine with its encoding replaced by
    `fusion` (BatchEngine and device_tables, the layer below).  Returns
    (result, engine)."""
    if fusion is None:
        return vm.execute_batch(func, args, max_steps=10**9), vm.last_engine
    from wasmedge_tpu_torch.batch.interp import device_tables
    from wasmedge_tpu_torch.vm.vm import make_engine as vm_engine

    eng = vm_engine(vm._active, vm.store, vm.conf, device="cuda")
    eng.fusion = fusion
    eng.tables = device_tables(eng.img, eng.device, fusion,
                               mem_window=eng.mem_window,
                               optimistic=eng.optimistic,
                               stack_depth=eng.cfg.value_stack_depth)
    return eng.run(func, list(args), max_steps=10**9), eng


def fused_build(tables) -> dict:
    """Shapes, mean shape length and build seconds of the fused kernel of
    `tables` (empty for the per-op encoding)."""
    from wasmedge_tpu_torch.batch import interp

    if tables.fusion == "none":
        return {}
    info = interp.BUILD_INFO["fused"].get(interp.fused_kernel_key(tables), {})
    return {k: info.get(k) for k in ("fusion", "shapes", "mean_len",
                                     "seconds")}


def run_main(vm, func, args, steps_per_launch, need=("interp",),
             fusion=None):
    """One run (run_vm) with every launch count set to 0 before and read
    after; fails unless the kinds of launch in `need` happened.  Returns
    (result, launches, wall s, event ms, counts)."""
    from wasmedge_tpu_torch.batch import interp

    vm.conf.batch.steps_per_launch = steps_per_launch
    torch.cuda.synchronize()
    for k in interp.LAUNCHES:
        interp.LAUNCHES[k] = 0
    interp.clear_bulk_counts()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    res, eng = run_vm(vm, func, args, fusion)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(interp.LAUNCHES)
    counts["op"] = counts["interp"] - counts["block"] - counts["super"]
    for k in need:
        if counts[k] == 0:
            fail(f"main path {func} never launched the CUDA kernel "
                 f"({k} launches: 0)")
    if eng.tables.mem_window != (counts["window"] == counts["interp"]):
        fail(f"main path {func}: {counts['window']} of {counts['interp']} "
             f"launches ran the window cache (mem_window "
             f"{eng.tables.mem_window})")
    # B3: every launch optimistic where the knob is on, none where off
    if vm.conf.batch.optimistic is False:
        if counts["optimistic"] != 0 or eng.tables.optimistic:
            fail(f"main path {func} with optimistic False ran "
                 f"{counts['optimistic']} optimistic launches")
    elif counts["optimistic"] == 0 or \
            counts["optimistic"] != counts["interp"]:
        fail(f"main path {func}: {counts['optimistic']} of "
             f"{counts['interp']} launches ran optimistic convergence")
    counts["encoding"] = eng.tables.fusion
    counts["mem_window"] = eng.tables.mem_window
    counts["optimistic_on"] = eng.tables.optimistic
    counts["warps"] = eng.optimistic_stats
    counts["build"] = fused_build(eng.tables)
    counts["bulk_ops"] = interp.bulk_counts(eng.tables) \
        if eng.tables.has_bulk else {}
    return res, counts["interp"], wall, e0.elapsed_time(e1), counts


def report_main(label, res_launches_wall_ev_counts, retired) -> dict:
    """Print one main-path run and return its record."""
    _, launches, wall, ev_ms, counts = res_launches_wall_ev_counts
    build = counts["build"]
    shape = (f", {build['shapes']} block shapes of mean length "
             f"{build['mean_len']:.2f}" if build.get("shapes") else "")
    if build:
        shape += f", built in {build['seconds'] or 0:.1f} s"
    mem = " windows" if counts["mem_window"] else ""
    opt = " optimistic" if counts["optimistic_on"] else " careful"
    print(f"main {label} [{counts['encoding']}{mem}{opt}]: {launches} "
          f"launches (block {counts['block']}, super {counts['super']}, "
          f"per-op {counts['op']}, window {counts['window']}, optimistic "
          f"{counts['optimistic']}), wall {wall:.3f} s, "
          f"{retired / wall:.4g} wasm instr/s over wall, events "
          f"{ev_ms:.1f} ms, retired {retired}{shape}; warps "
          f"{counts['warps']}", flush=True)
    return dict(encoding=counts["encoding"], launches=launches,
                block_launches=counts["block"],
                super_launches=counts["super"], op_launches=counts["op"],
                window_launches=counts["window"],
                optimistic_launches=counts["optimistic"],
                optimistic=counts["optimistic_on"], warps=counts["warps"],
                mem_window=counts["mem_window"],
                wall_s=wall, event_ms=ev_ms, retired=retired,
                instr_per_s_wall=retired / wall, build=build)


def direct_run(vm, func, args, steps_per_launch, need, check,
               fusion=None) -> dict:
    """The same run once more with mem_hbm False (every access on the
    plane in global memory), checked by `check(result)`; its record."""
    old = vm.conf.batch.mem_hbm
    vm.conf.batch.mem_hbm = False
    try:
        run = run_main(vm, func, args, steps_per_launch, need, fusion)
    finally:
        vm.conf.batch.mem_hbm = old
    if run[4]["window"]:
        fail(f"{func} with mem_hbm False ran the window cache")
    check(run[0])
    return report_main(f"{func}, mem_hbm False", run,
                       int(run[0].retired.astype(np.int64).sum()))


def careful_run(vm, func, args, steps_per_launch, need, check, label,
                fusion=None) -> dict:
    """The same run once more with `optimistic` False (the careful
    kernel, B3's yardstick), checked by `check(result)`, then profiled;
    its record."""
    old = vm.conf.batch.optimistic
    vm.conf.batch.optimistic = False
    try:
        run = run_main(vm, func, args, steps_per_launch, need, fusion)
        check(run[0])
        retired = int(run[0].retired.astype(np.int64).sum())
        rec = report_main(f"{label}, optimistic False", run, retired)
        rec["profile"] = profile_run(vm, func, args, retired, fusion)
    finally:
        vm.conf.batch.optimistic = old
    return rec


# The encodings a main-path workload runs in: (record suffix, fusion
# replacing the engine's choice or None, block_fusion, launch kinds that
# must happen).  The first is the VM's default.
ENCODINGS = (("", None, None, ("interp", "block")),
             ("_none", "none", None, ("interp", "op")),
             ("_super", None, False, ("interp", "super")))


def phase_main():
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.models import build_coremark_kernel, build_fib
    from wasmedge_tpu_torch.vm.vm import VM

    L = MAIN_LANES
    out = {}
    conf = Configure()
    conf.batch.lanes = L
    conf.batch.value_stack_depth = 256
    conf.batch.call_stack_depth = 256
    vm = VM(conf)
    vm.load_wasm(build_fib())
    vm.validate()
    vm.instantiate()

    # fib(30): B2 blocks (the default), the per-op kernel, B6
    for suffix, fusion, bf, need in ENCODINGS:
        vm.conf.batch.block_fusion = bf
        run = run_main(vm, "fib", [np.full(L, 30)], 1 << 20, need, fusion)
        res, counts = run[0], run[4]
        if counts["simd"] or counts["bulk"]:
            fail(f"fib(30) ran a kernel instantiation with bulk or v128 "
                 f"cases: {counts}")
        if not (res.trap == -1).all() or \
                not (res.results[0] == 832040).all():
            fail(f"fib(30) x {L} [{counts['encoding']}]: traps "
                 f"{np.unique(res.trap)}, results "
                 f"{np.unique(res.results[0])[:5]}")
        retired = int(res.retired.astype(np.int64).sum())
        key = "fib30" + suffix
        out[key] = report_main(f"fib(30) x {L}, all 832040", run, retired)
        out[key]["profile"] = profile_run(vm, "fib", [np.full(L, 30)],
                                          retired, fusion)
    vm.conf.batch.block_fusion = None

    def fib30_check(res):
        if not (res.trap == -1).all() or \
                not (res.results[0] == 832040).all():
            fail("fib(30), optimistic False: a lane is not 832040")

    out["fib30_careful"] = careful_run(
        vm, "fib", [np.full(L, 30)], 1 << 20, ("interp", "block"),
        fib30_check, f"fib(30) x {L}, all 832040")

    ns = 20 + np.arange(L) % 11
    want = np.array([fib_py(int(n)) for n in ns])

    def mix_check(res):
        if not (res.trap == -1).all() or not (res.results[0] == want).all():
            fail("divergent fib mix disagrees with the Python fib table")

    run = run_main(vm, "fib", [ns], 1 << 20, ("interp", "block"))
    mix_check(run[0])
    retired = int(run[0].retired.astype(np.int64).sum())
    out["fib_mix"] = report_main(f"fib(20 + lane % 11) x {L}, matches", run,
                                 retired)
    if not out["fib_mix"]["warps"]["rollbacks"]:
        fail("the divergent fib mix rolled no warp back")
    out["fib_mix"]["profile"] = profile_run(vm, "fib", [ns], retired)
    out["fib_mix_careful"] = careful_run(
        vm, "fib", [ns], 1 << 20, ("interp", "block"), mix_check,
        f"fib(20 + lane % 11) x {L}, matches")

    conf_cm = Configure()
    conf_cm.batch.lanes = L
    conf_cm.batch.value_stack_depth = 256
    conf_cm.batch.call_stack_depth = 256
    conf_cm.batch.memory_pages_per_lane = 1
    vm_cm = VM(conf_cm)
    vm_cm.load_wasm(build_coremark_kernel())
    vm_cm.validate()
    vm_cm.instantiate()
    run = run_main(vm_cm, "coremark", [np.full(L, 200)], 1 << 20,
                   ("interp", "block", "window"))
    res = run[0]
    # the reference: the plain interpreter on the CPU for 32 lanes
    cpu = BatchEngine(vm_cm._active, store=vm_cm.store, conf=conf_cm,
                      lanes=32, device="cpu").run("coremark",
                                                  [np.full(32, 200)])
    if not (cpu.trap == -1).all() or len(set(cpu.results[0].tolist())) != 1:
        fail("CoreMark CPU reference did not complete uniformly")
    if not (res.trap == -1).all() or \
            not (res.results[0] == cpu.results[0][0]).all():
        fail("CoreMark x 4096 disagrees with the CPU plain interpreter")
    out["coremark200"] = report_main(
        f"coremark(200) x {L}, all {int(cpu.results[0][0])} (1 page/lane, "
        f"256 MiB plane; mostly set-up)", run,
        int(res.retired.astype(np.int64).sum()))

    want = coremark_py(COREMARK_N)

    def check(res):
        if not (res.trap == -1).all() or \
                not ((res.results[0] & 0xFFFFFFFF) == want).all():
            fail(f"coremark({COREMARK_N}) x {L} disagrees with the Python "
                 f"reference {want}")

    args = [np.full(L, COREMARK_N)]
    for suffix, fusion, bf, need in ENCODINGS[:2]:
        run = run_main(vm_cm, "coremark", args, 1 << 20, need + ("window",),
                       fusion)
        check(run[0])
        retired = int(run[0].retired.astype(np.int64).sum())
        key = "coremark" + suffix
        out[key] = report_main(f"coremark({COREMARK_N}) x {L}, all {want}",
                               run, retired)
        out[key]["profile"] = profile_run(vm_cm, "coremark", args, retired,
                                          fusion)
        out[key]["direct"] = direct_run(vm_cm, "coremark", args, 1 << 20,
                                        need, check, fusion)
    return out


def coremark_py(n: int) -> int:
    """What models.programs.build_coremark_kernel's export returns."""
    acc = 0
    for i in range(n):
        acc = (acc + (i * 3) * (i + 7)) & 0xFFFFFFFF
    data, crc = acc & 0xFF, 0xFFFF
    for _ in range(8):
        crc = ((crc >> 1) ^ 0xA001) if (crc ^ data) & 1 else crc >> 1
        data >>= 1
    return crc ^ acc


def profile_run(vm, func, args, retired: int, fusion=None):
    """One more run (run_vm) under torch.profiler: the kernel's device
    time and launches, the set-up and host time around them (wall minus
    kernel) and, of that, the host time in serve rounds, the card's idle
    share, and instr/s over the kernel time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, eng = run_vm(vm, func, args, fusion)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if "interp_kernel" in e.key]
    dev_us = sum(getattr(e, "device_time_total", 0) or
                 getattr(e, "cuda_time_total", 0) for e in kern)
    if not kern or dev_us <= 0:
        fail(f"profile {func}: the trace shows no interpreter kernel time")
    count = sum(e.count for e in kern)
    kernel_s = dev_us / 1e6
    # host <-> device copies (the serve rounds' memory chunks and stack
    # rows, set-up's planes): device time of the Memcpy entries
    copy_s = sum(getattr(e, "device_time_total", 0) or
                 getattr(e, "cuda_time_total", 0)
                 for e in prof.key_averages() if "Memcpy" in e.key) / 1e6
    stats = eng.hostcall_stats
    serve_s = stats["serve_s"]
    print(f"profile {func} x {MAIN_LANES} [{eng.tables.fusion}]: kernel "
          f"device time "
          f"{kernel_s * 1e3:.3f} ms over {count} launches "
          f"({kernel_s * 1e3 / count:.3f} ms per launch), wall "
          f"{wall * 1e3:.3f} ms, set-up and host {(wall - kernel_s) * 1e3:.3f}"
          f" ms (of which {stats['serve_rounds']} serve rounds "
          f"{serve_s * 1e3:.3f} ms; host<->device copies "
          f"{copy_s * 1e3:.3f} ms of device time), device idle share "
          f"{1.0 - kernel_s / wall:.4f}, "
          f"{retired / kernel_s:.4g} wasm instr/s over kernel time",
          flush=True)
    return dict(encoding=eng.tables.fusion, kernel_ms=kernel_s * 1e3,
                launches=count, wall_s=wall,
                setup_host_ms=(wall - kernel_s) * 1e3,
                serve_rounds=stats["serve_rounds"], serve_ms=serve_s * 1e3,
                copy_ms=copy_s * 1e3, idle_share=1.0 - kernel_s / wall,
                instr_per_s_kernel=retired / kernel_s)


def wasi_vm(data: bytes, fd: int, pages: int = 1):
    """A VM at MAIN_LANES lanes with bench_echo's stack shape, the WASI
    host module registered (stdout to `fd`) and `data` instantiated."""
    from wasmedge_tpu_torch.common.configure import (
        Configure, HostRegistration)
    from wasmedge_tpu_torch.vm.vm import VM

    conf = Configure()
    conf.host_registrations.add(HostRegistration.Wasi)
    conf.batch.lanes = MAIN_LANES
    conf.batch.value_stack_depth = 64
    conf.batch.call_stack_depth = 16
    conf.batch.memory_pages_per_lane = pages
    vm = VM(conf)
    vm.wasi_module.init_wasi(args=list(WASI_ARGS))
    vm.wasi_module.env.fds[1].os_fd = fd
    vm.load_wasm(data)
    vm.validate()
    vm.instantiate()
    return vm


def phase_main_wasi():
    """WASI echo (bench_echo's shape) and WASI hello through
    VM.execute_batch at MAIN_LANES lanes, stdout to temporary files."""
    from wasmedge_tpu_torch.common.errors import ErrCode
    from wasmedge_tpu_torch.models import build_echo, build_wasi_hello
    from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE

    L = MAIN_LANES
    out = {}
    calls = 2 * ECHO_ITERS * L
    want = ECHO_MESSAGE * calls
    def check(res):
        if not (res.trap == -1).all() or not (res.results[0] == 0).all():
            fail(f"echo x {L}: traps {np.unique(res.trap)}, results "
                 f"{np.unique(res.results[0])[:5]}")

    kinds = ("run", "profile", "mem_hbm False")
    with tempfile.TemporaryDirectory() as td:
        paths = [os.path.join(td, str(i)) for i in range(len(kinds))]
        fds = [os.open(p, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
               for p in paths]
        try:
            vm = wasi_vm(build_echo(), fds[0])
            res, launches, wall, ev_ms, counts = run_main(
                vm, "echo", [ECHO_ITERS], 1 << 20,
                need=("interp", "hostcall", "block", "window"))
            stats = dict(vm.last_engine.hostcall_stats)
            retired = int(res.retired.astype(np.int64).sum())
            prof = profile_run(wasi_vm(build_echo(), fds[1]), "echo",
                               [ECHO_ITERS], retired)
            direct = direct_run(wasi_vm(build_echo(), fds[2]), "echo",
                                [ECHO_ITERS], 1 << 20,
                                ("interp", "hostcall", "block"), check)
        finally:
            for fd in fds:
                os.close(fd)
        runs = [open(p, "rb").read() for p in paths]
    for k, got in zip(kinds, runs):
        if got != want:
            fail(f"echo x {L} ({k}): stdout is {len(got)} B, expected "
                 f"{len(want)} B of the message")
    check(res)
    if stats["tier1_calls"] != calls:
        fail(f"echo x {L}: {stats['tier1_calls']} host calls served, "
             f"expected {calls}")
    out["echo"] = dict(launches=launches, hostcall_launches=counts[
        "hostcall"], wall_s=wall, event_ms=ev_ms, retired=retired,
        host_calls=calls, host_calls_per_s=calls / wall,
        stdout_bytes=len(want), profile=prof, direct=direct, **stats)
    print(f"main wasi echo x {L} (ITERS {ECHO_ITERS}): {calls} fd_write "
          f"calls, stdout {len(want)} B exact, all lanes done with 0, "
          f"{launches} launches, {stats['serve_rounds']} serve rounds "
          f"({stats['tier1_vectorized']} calls vectorized) "
          f"{stats['serve_s'] * 1e3:.3f} ms, wall {wall:.3f} s, "
          f"{calls / wall:.4g} host calls/s", flush=True)
    # The least bytes one serve round moves per parked lane: fd_write's 4
    # argument cells (8 B each), the iovec (8 B) and the 16-byte message
    # read; nwritten (4 B) and the result cell (8 B) written.
    round_bytes = L * (4 * 8 + 8 + 16 + 4 + 8)
    out["echo"]["serve_round_bound_ms"] = round_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  serve round bound {out['echo']['serve_round_bound_ms']:.6f} ms "
          f"by bytes: {round_bytes} B / {HBM_BYTES_PER_S:.3g} B/s; mean "
          f"round {stats['serve_s'] * 1e3 / stats['serve_rounds']:.3f} ms",
          flush=True)

    codes = np.arange(L) % 3
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "hello")
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
        try:
            vm = wasi_vm(build_wasi_hello(), fd)
            res, launches, wall, ev_ms, counts = run_main(
                vm, "hello", [codes], 1 << 20,
                need=("interp", "hostcall", "block", "window"))
            eng = vm.last_engine
            rounds = eng.hostcall_stats["serve_rounds"]
            # the exit codes: proc_exit's argument in each parked frame
            st = eng.initial_state(vm._active.exports["hello"][1], [codes])
            st, _ = eng.run_from_state(st, 0, 10**9)
            exit_codes = st.stack_lo.cpu().numpy()[st.fp.cpu().numpy(),
                                                   np.arange(L)]
        finally:
            os.close(fd)
        got = open(path, "rb").read()
    want = hello_output(codes)
    if got != want + want:
        fail(f"hello x {L}: stdout is {len(got)} B, expected "
             f"{2 * len(want)} B (two runs)")
    if not (res.trap == int(ErrCode.Terminated)).all() or \
            not (exit_codes == codes).all():
        fail(f"hello x {L}: traps {np.unique(res.trap)}, exit codes "
             f"{np.unique(exit_codes)}")
    out["hello"] = dict(launches=launches, wall_s=wall, event_ms=ev_ms,
                        serve_rounds=rounds)
    print(f"main wasi hello x {L}: every lane Terminated with exit code "
          f"lane % 3, stdout {len(want)} B exact, {launches} launches, "
          f"wall {wall:.3f} s", flush=True)
    return out


def phase_main_bulk():
    """The bulk-memory workload through VM.execute_batch at MAIN_LANES
    lanes x one page (a 256 MiB plane), checked lane by lane against its
    bytearray model; then once more under torch.profiler."""
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.models import build_bulk_workload
    from wasmedge_tpu_torch.models.programs import (
        BULK_COPY_BYTES, BULK_FILL_BYTES, bulk_workload_model)
    from wasmedge_tpu_torch.vm.vm import VM

    L = MAIN_LANES
    conf = Configure()
    conf.batch.lanes = L
    conf.batch.value_stack_depth = 64
    conf.batch.call_stack_depth = 16
    conf.batch.memory_pages_per_lane = 1
    vm = VM(conf)
    vm.load_wasm(build_bulk_workload())
    vm.validate()
    vm.instantiate()
    seeds = (np.random.default_rng(SEED).integers(0, 1 << 31, L))
    args = [seeds, BULK_ITERS]
    res, launches, wall, ev_ms, counts = run_main(
        vm, "bulk", args, 1 << 20, need=("interp", "bulk", "block", "window"))
    t0 = time.perf_counter()
    want, _ = bulk_workload_model(seeds, BULK_ITERS)
    t_model = time.perf_counter() - t0

    def check(res):
        if not (res.trap == -1).all() or \
                not ((res.results[0] & 0xFFFFFFFF) == want).all():
            bad = int(((res.results[0] & 0xFFFFFFFF) != want).sum())
            fail(f"bulk x {L}: {bad} lanes disagree with the bytearray "
                 f"model, traps {np.unique(res.trap)}")

    check(res)
    ops = counts["bulk_ops"]
    if not ops.get("warp_passes"):
        fail(f"bulk x {L}: no bulk op took the warp pass ({ops})")
    retired = int(res.retired.astype(np.int64).sum())
    F, C = BULK_FILL_BYTES, BULK_COPY_BYTES
    # the least bytes the bulk ops move (each filled byte written once,
    # each copied byte read and written once; lengths at their least)
    bulk_bytes = L * BULK_ITERS * (F + F // 4 + 2 * 2 * C)
    out = dict(launches=launches, bulk_launches=counts["bulk"], wall_s=wall,
               event_ms=ev_ms, retired=retired, model_s=t_model, bulk_ops=ops,
               min_bulk_bytes=bulk_bytes,
               bulk_bound_ms=bulk_bytes / HBM_BYTES_PER_S * 1e3)
    print(f"main bulk x {L} (1 page/lane, {BULK_ITERS} iterations of fills "
          f">= {F} B and overlapping copies >= {C} B): every lane equals "
          f"the bytearray model, {launches} launches, wall {wall:.3f} s, "
          f"events {ev_ms:.1f} ms, retired {retired}; the bulk ops' bytes "
          f">= {bulk_bytes} B, {out['bulk_bound_ms']:.4f} ms at "
          f"{HBM_BYTES_PER_S:.3g} B/s; bulk ops {ops}", flush=True)
    out["profile"] = profile_run(vm, "bulk", args, retired)
    out["direct"] = direct_run(vm, "bulk", args, 1 << 20,
                               ("interp", "bulk", "block"), check)
    return out


def phase_simd_corpus():
    """BASELINE config 3: tests/spec/simd.wast through the port's batched
    corpus runner on the card, strict matching, every assertion a lane."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.spec import run_corpus_batched

    torch.cuda.synchronize()
    for k in interp.LAUNCHES:
        interp.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    rep = run_corpus_batched([SIMD_WAST], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(interp.LAUNCHES)
    for f in rep.failures[:10]:
        print(f"  {f}", flush=True)
    if rep.failed or not rep.passed:
        fail(f"simd.wast on the card: {rep.passed} passed, {rep.failed} "
             f"failed, {rep.skipped} skipped")
    if counts["simd"] == 0:
        fail("simd.wast never launched the kernel's v128 instantiation")
    if counts["block"] != counts["interp"]:
        fail(f"simd.wast ran {counts['block']} of {counts['interp']} "
             f"launches through B2 blocks")
    if counts["optimistic"] == 0 or counts["optimistic"] != counts["interp"]:
        fail(f"simd.wast ran {counts['optimistic']} of {counts['interp']} "
             f"launches optimistically")
    print(f"spec simd.wast on the card (strict): {rep.passed} passed, "
          f"{rep.failed} failed, {rep.skipped} skipped, {counts['simd']} "
          f"v128 launches, all through B2 blocks, wall {wall:.3f} s",
          flush=True)
    return dict(passed=rep.passed, failed=rep.failed, skipped=rep.skipped,
                launches=counts["simd"], wall_s=wall)


def corpus_files() -> list:
    return sorted(os.path.join(SPEC_DIR, f) for f in os.listdir(SPEC_DIR)
                  if f.endswith(".wast") and f != "simd.wast")


def corpus_conf():
    from wasmedge_tpu_torch.common.configure import Configure

    conf = Configure()
    for k, v in CORPUS_DEPTHS.items():
        setattr(conf.batch, k, v)
    return conf


def phase_spec_corpus():
    """The 22 batchable non-SIMD .wast files of tests/spec through the
    port's batched corpus runner on the card, with the reference test's
    depths (2048 frames, 8192 value slots) and optimistic convergence on
    (one assertion per lane: every warp diverges), strict matching."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.spec import run_corpus_batched

    files = corpus_files()
    torch.cuda.synchronize()
    for k in interp.LAUNCHES:
        interp.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    rep = run_corpus_batched(files, device="cuda", conf=corpus_conf())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(interp.LAUNCHES)
    for f in rep.failures[:10]:
        print(f"  {f}", flush=True)
    got = (rep.passed, rep.failed, rep.skipped)
    if got != CORPUS_COUNTS:
        fail(f"the non-SIMD corpus on the card: {got} (passed, failed, "
             f"skipped), expected {CORPUS_COUNTS}")
    if counts["optimistic"] == 0 or counts["optimistic"] != counts["interp"]:
        fail(f"the corpus ran {counts['optimistic']} of {counts['interp']} "
             f"launches optimistically")
    print(f"spec corpus ({len(files)} non-SIMD files) on the card (strict, "
          f"frames {CORPUS_DEPTHS['call_stack_depth']}, value slots "
          f"{CORPUS_DEPTHS['value_stack_depth']}): {rep.passed} passed, "
          f"{rep.failed} failed, {rep.skipped} skipped, {counts['interp']} "
          f"launches, all optimistic, wall {wall:.3f} s", flush=True)
    return dict(files=len(files), passed=rep.passed, failed=rep.failed,
                skipped=rep.skipped, launches=counts["interp"],
                optimistic_launches=counts["optimistic"], wall_s=wall)


def retired_model(vm, func="vloop", n_small=(1, 2)):
    """Instructions func(n) retires per lane, base + per * n, from small
    runs of the plain version on the CPU."""
    counts = []
    for n in (0,) + tuple(n_small):
        res = vm.execute_batch(func, [np.full(1, n)], lanes=1,
                               max_steps=10**7, device="cpu")
        counts.append(int(res.retired[0]))
    base, per = counts[0], counts[1] - counts[0]
    if counts[2] - counts[1] != per:
        fail(f"{func}'s retired count is not linear in n: {counts}")
    return base, per


def phase_main_simd():
    """BASELINE config 3's workload through VM.execute_batch at full size:
    vloop(SIMD_N) x MAIN_LANES (bench_simd.py's shape), every lane's
    result against the Python model and its retired count against the
    plain version's linear count; then once more under torch.profiler."""
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.models import build_simd_loop
    from wasmedge_tpu_torch.models.programs import simd_loop_model
    from wasmedge_tpu_torch.vm.vm import VM

    L = MAIN_LANES
    conf = Configure()
    conf.batch.lanes = L
    conf.batch.value_stack_depth = 64
    conf.batch.call_stack_depth = 16
    conf.batch.memory_pages_per_lane = 1
    vm = VM(conf)
    vm.load_wasm(build_simd_loop())
    vm.validate()
    vm.instantiate()
    base, per = retired_model(vm)
    want_retired = base + per * SIMD_N
    want = simd_loop_model(SIMD_N)
    out = dict(n=SIMD_N, retired_per_lane=want_retired, per_iteration=per)
    # B2 blocks (the default) and, with block_fusion False, the per-op
    # kernel (a module with v128 ops runs no superinstructions)
    def check(res):
        if not (res.trap == -1).all() or \
                not ((res.results[0] & 0xFFFFFFFF) == want).all():
            fail(f"vloop({SIMD_N}) x {L}: traps {np.unique(res.trap)}, "
                 f"results {np.unique(res.results[0])[:5]}, model {want}")
        if not (res.retired.astype(np.int64) == want_retired).all():
            fail(f"vloop({SIMD_N}) x {L}: retired "
                 f"{np.unique(res.retired)[:5]}, expected {want_retired} "
                 f"per lane")

    for suffix, bf, need in (("", None, ("interp", "simd", "block")),
                             ("_none", False, ("interp", "simd", "op"))):
        vm.conf.batch.block_fusion = bf
        run = run_main(vm, "vloop", [np.full(L, SIMD_N)], 1 << 20,
                       need + ("window",))
        res, counts = run[0], run[4]
        check(res)
        retired = int(res.retired.astype(np.int64).sum())
        rec = report_main(
            f"vloop({SIMD_N}) x {L}, every lane {want} (the model), retired "
            f"{want_retired} per lane ({base} + {per} per iteration)", run,
            retired)
        rec["simd_launches"] = counts["simd"]
        rec["profile"] = profile_run(vm, "vloop", [np.full(L, SIMD_N)],
                                     retired)
        if not suffix:
            # the default encoding once more on the plane directly, and
            # with the careful kernel
            rec["direct"] = direct_run(vm, "vloop", [np.full(L, SIMD_N)],
                                       1 << 20, need, check)
            rec["careful"] = careful_run(
                vm, "vloop", [np.full(L, SIMD_N)], 1 << 20, need, check,
                f"vloop({SIMD_N}) x {L}")
        out["none" if suffix else "blocks"] = rec
    vm.conf.batch.block_fusion = None
    return out


def config2_vm(data: bytes):
    """A VM at MAIN_LANES lanes with BASELINE config 2's geometry and
    `data` instantiated."""
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.vm.vm import VM

    conf = Configure()
    conf.batch.lanes = MAIN_LANES
    for k, v in MEM_STACKS.items():
        setattr(conf.batch, k, v)
    vm = VM(conf)
    vm.load_wasm(data)
    vm.validate()
    vm.instantiate()
    return vm


def phase_main_memory():
    """BASELINE config 2 through VM.execute_batch at full width
    (bench_memory.py's shape): mem_checksum(MEM_N) with MEM_PASSES passes
    and coremark(MEM_COREMARK_N), x MAIN_LANES lanes, stacks 128 / 64,
    one page per lane; with the window cache (mem_hbm None, the default)
    and with direct access (False), in B2 blocks (the default) and per-op;
    every lane complete and equal to its oracle (mem_checksum's retired
    count too: its checksum is 0 for an even number of passes over an
    even number of words); each run once more under torch.profiler."""
    from wasmedge_tpu_torch.models import (
        build_coremark_kernel, build_memory_workload)
    from wasmedge_tpu_torch.models.programs import memory_workload_model

    L = MAIN_LANES
    out = {}
    for name, data, n, want in (
            ("mem_checksum", build_memory_workload(passes=MEM_PASSES), MEM_N,
             memory_workload_model(MEM_N, MEM_PASSES)),
            ("coremark", build_coremark_kernel(), MEM_COREMARK_N,
             coremark_py(MEM_COREMARK_N))):
        vm = config2_vm(data)
        args = [np.full(L, n)]
        base, per = retired_model(vm, name) \
            if name == "mem_checksum" else (None, None)
        for suffix, fusion, _, need in ENCODINGS[:2]:
            for mem_hbm in (None, False):
                vm.conf.batch.mem_hbm = mem_hbm
                tag = mode_tag(fusion or "blocks", mem_hbm is None)

                def check(res):
                    if not (res.trap == -1).all() or not (
                            (res.results[0] & 0xFFFFFFFF) == want).all():
                        bad = int(((res.results[0] & 0xFFFFFFFF)
                                   != want).sum())
                        fail(f"config 2 {name}({n}) x {L}{tag}: {bad} lanes"
                             f" differ from {want}, traps "
                             f"{np.unique(res.trap)}")
                    if per is not None and \
                            not (res.retired == base + per * n).all():
                        fail(f"config 2 {name}({n}) x {L}: retired "
                             f"{np.unique(res.retired)[:5]}, expected "
                             f"{base + per * n} per lane")

                run = run_main(vm, name, args, 1 << 20, need + (
                    ("window",) if mem_hbm is None else ()), fusion)
                res = run[0]
                if mem_hbm is False and run[4]["window"]:
                    fail(f"config 2 {name} with mem_hbm False ran the "
                         f"window cache")
                check(res)
                retired = int(res.retired.astype(np.int64).sum())
                key = name + suffix + ("" if mem_hbm is None else "_direct")
                label = (f"config 2 {name}({n}) x {L}, every lane {want}"
                         f"{'' if mem_hbm is None else ', mem_hbm False'}")
                out[key] = report_main(label, run, retired)
                out[key]["profile"] = profile_run(vm, name, args, retired,
                                                  fusion)
                if name == "mem_checksum" and not suffix:
                    out[key]["careful"] = careful_run(
                        vm, name, args, 1 << 20, need, check, label)
        vm.conf.batch.mem_hbm = None
    return out


def phase_time_mem_launch():
    """One per-op launch of TIMED_STEPS steps of mem_checksum(MEM_N) with
    MEM_PASSES passes x MAIN_LANES (config 2's geometry) from the lanes'
    first store, through the window cache and with direct access: the
    optimistic kernel, the careful kernel and the plain version on the
    same inputs (time_opt_and_careful), both modes equal, and the launch's
    bound in each mode."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.batch import interp as I
    from wasmedge_tpu_torch.batch.engine import CONTROL_FIELDS
    from wasmedge_tpu_torch.models import build_memory_workload

    chunk, L = TIMED_STEPS, MAIN_LANES
    data = build_memory_workload(passes=MEM_PASSES)
    first = first_step_at(data, "mem_checksum", [np.full(1, MEM_N)],
                          I.H_STORE_W, MEM_STACKS)
    engs = {(m, opt): make_engine(data, L, fusion="none", mem_hbm=m,
                                  optimistic=opt, **MEM_STACKS)[0]
            for m in (True, False) for opt in (None, False)}
    if not engs[True, None].tables.mem_window or \
            engs[False, None].tables.mem_window:
        fail("mem_checksum's memory modes are not windows / direct")
    start = engs[False, False]
    st0 = start.initial_state(start.inst.exports["mem_checksum"][1],
                              [np.full(L, MEM_N)])
    interp.run_chunk(start.tables, st0, first, False)  # to the store
    torch.cuda.synchronize()
    out, outs = {}, {}
    for m in (True, False):
        mode = "windows" if m else "direct"
        t, out_k = time_opt_and_careful(
            engs[m, None], engs[m, False], st0, chunk,
            f"mem_checksum({MEM_N}), {MEM_PASSES} passes, from step "
            f"{first}, {mode}")
        if m:
            WINDOW_WORST[0] = max(WINDOW_WORST[0], t["max_abs_err"])
        outs[m] = out_k
        out[mode] = t
    if max_abs_err(outs[True], outs[False]) != 0:
        fail("the mem_checksum launch leaves other planes with the windows "
             "than without")
    retired = int(outs[True].retired.sum() - st0.retired.sum())
    tb = engs[False, False].tables
    counts, max_sp, max_cd = launch_mix(tb, st0, chunk)
    if int(counts.sum()) != retired:
        fail(f"instruction mix counts {int(counts.sum())} instructions, "
             f"the kernel retired {retired}")
    hid = tb.hid.cpu().numpy()
    loads = sum(int(c) for pc, c in enumerate(counts)
                if hid[pc] in (I.H_LOAD, I.H_LOAD_W, I.H_LOAD_D))
    # Least bytes: the stack rows below the deepest sp, the frame rows
    # below the deepest call depth and the control planes read once and
    # written once, each memory word the launch changes written once,
    # each word a load reads read once, the code tables read once, and
    # what optimistic convergence copies (without the windows, each
    # snapshot copies the lane's memory column)
    changed = int((outs[True].mem != st0.mem).sum())
    touched = 4 * L * (2 * max_sp + 3 * max_cd + len(CONTROL_FIELDS))
    table_bytes = sum(4 * t_.numel() for t_ in vars(tb).values()
                      if isinstance(t_, torch.Tensor))
    careful_bytes = 2 * touched + 4 * changed + 4 * loads + table_bytes
    bound_ops_ms = retired * OPS_PER_INSTR / OPS_PER_S * 1e3
    careful_bound_ms = max(careful_bytes / HBM_BYTES_PER_S * 1e3,
                           bound_ops_ms)
    for m in (True, False):
        mode = "windows" if m else "direct"
        snap = snapshot_bytes(st0, out[mode]["warps"], max_cd, 2, not m)
        bytes_ = careful_bytes + snap
        bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
        out[mode].update(bound_ms=max(bound_bytes_ms, bound_ops_ms),
                         bound_by=by, bound_bytes=bytes_, snapshot_bytes=snap)
        print(f"  {mode}: bound {out[mode]['bound_ms']:.6f} ms by {by}: "
              f"bytes {bytes_} B (stack rows {max_sp}, frame rows {max_cd}, "
              f"{changed} memory words written, {loads} loaded, code tables "
              f"{table_bytes} B; snapshots {snap} B) / {HBM_BYTES_PER_S:.3g}"
              f" B/s = {bound_bytes_ms:.6f} ms", flush=True)
    print(f"  retired {retired}; careful bound {careful_bound_ms:.6f} ms; "
          f"operations {retired} / {OPS_PER_S:.3g} /s = "
          f"{bound_ops_ms:.6f} ms", flush=True)
    w, d = out["windows"], out["direct"]
    return dict(out, ms=w["ms"], careful_ms=w["careful_ms"],
                refused_ms=w["refused_ms"],
                refused_careful_ms=w["refused_careful_ms"],
                plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                careful_bound_ms=careful_bound_ms, bound_by=w["bound_by"],
                max_abs_err=max(w["max_abs_err"], d["max_abs_err"]),
                retired=retired, first_step=first, words_written=changed,
                words_loaded=loads)


def phase_time_bulk():
    """One launch of the converged bulk pair at MAIN_LANES lanes: every
    lane fills 32 KiB at 0 and copies 16 KiB from 0 to 32 KiB, word
    aligned.  The optimistic kernel (its warps commit at the fill and run
    the rest per lane), the careful kernel and the plain version
    (time_opt_and_careful), and the same fill and copy as PyTorch tensor
    calls on the memory plane, CUDA events; and an unaligned variant
    (fill at 1, copy 3 bytes back from 32769)."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.models.fixtures import build_bulk_pair

    L = MAIN_LANES
    fill_n, copy_n, val = 32768, 16384, 0x5A
    eng, ceng = (make_engine(build_bulk_pair(), L, value_stack_depth=64,
                             call_stack_depth=16, memory_pages_per_lane=1,
                             fusion="none", optimistic=opt)[0]
                 for opt in (None, False))
    pair = eng.inst.exports["pair"][1]
    chunk = 8  # 3 operands + fill, 3 operands + copy: 8 instructions
    out = {}
    for name, args in (
            ("aligned", [0, val, fill_n, fill_n, 0, copy_n]),
            ("unaligned", [1, val, fill_n, fill_n + 1, fill_n - 2, copy_n])):
        st0 = eng.initial_state(pair, args)
        st0.mem.copy_(torch.randint(-2**31, 2**31 - 1, st0.mem.shape,
                                    dtype=torch.int32, device=st0.mem.device,
                                    generator=torch.Generator(
                                        device=st0.mem.device).manual_seed(
                                        SEED)))
        torch.cuda.synchronize()
        interp.clear_bulk_counts()
        t, out_k = time_opt_and_careful(eng, ceng, st0, chunk,
                                        f"bulk pair {name}", refused=False)
        if not bool((out_k.pc == st0.pc + chunk).all()):
            fail(f"bulk pair ({name}): the launch stopped early")
        torch.cuda.synchronize()
        # per launch: the fill and the copy of every warp, one pass each
        ops = {k: interp.bulk_counts(tb) for k, tb in
               (("optimistic", eng.tables), ("careful", ceng.tables))}
        t["bulk_ops"] = ops
        print(f"  bulk ops over the pair's launches ({name}): {ops}",
              flush=True)
        if not ops["optimistic"]["warp_passes"] or \
                not ops["careful"]["warp_passes"] or \
                ops["optimistic"]["lane_walks"] or ops["careful"]["lane_walks"]:
            fail(f"bulk pair ({name}): the converged pair did not run as "
                 f"warp passes alone: {ops}")
        out[name] = t
        if name == "aligned":
            st_aligned, mem_k = st0, out_k.mem
            snap = snapshot_bytes(st0, t["warps"], 0, 2,
                                  not eng.tables.mem_window)

    # the library yardstick: the aligned pair as tensor calls
    word = val * 0x01010101
    fw, cw = fill_n // 4, copy_n // 4

    def library(s):
        s.mem[0:fw].fill_(word)
        s.mem[fw:fw + cw].copy_(s.mem[0:cw].clone())

    library(st_aligned.clone())
    lib_ms, l25, l75, out_l = time_launch(library, st_aligned, 21)
    if not torch.equal(out_l.mem, mem_k):
        fail("bulk pair: the tensor-call yardstick left another memory "
             "plane than the kernel")
    # the least bytes: each byte filled written once, each byte copied
    # read once and written once (the work is data movement, with no
    # arithmetic to bound it), and the entry snapshot of optimistic
    # convergence
    nbytes = L * (fill_n + 2 * copy_n)
    bound_ms = (nbytes + snap) / HBM_BYTES_PER_S * 1e3
    careful_bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    a = out["aligned"]
    print(f"  library fill_ + copy_(clone) median {lib_ms:.4f} ms (q25 "
          f"{l25:.4f}, q75 {l75:.4f}, 21 runs); bound {bound_ms:.6f} ms by "
          f"bytes: {L} lanes x ({fill_n} B filled + 2 x {copy_n} B copied) "
          f"= {nbytes} B, snapshot {snap} B / {HBM_BYTES_PER_S:.3g} B/s "
          f"(careful {careful_bound_ms:.6f} ms); optimistic kernel at "
          f"{bound_ms / a['ms']:.3f} of the bound", flush=True)
    return dict(out, library_ms=lib_ms, bound_ms=bound_ms,
                careful_bound_ms=careful_bound_ms, bound_bytes=nbytes + snap,
                snapshot_bytes=snap)


def parse_ptxas(text: str) -> dict:
    """Registers, stack frame and spills of each kernel instantiation and
    out-of-line device function in `ptxas -v` output."""
    rows, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:entry function|Function properties for) "
                      r"'?([\w$.]+)", line)
        if m:
            mangled = m.group(1)
            inst = re.search(
                r"interp_kernelILb(\d)ELb(\d)E.*?Lb(\d)ELb(\d)EE", mangled)
            fn = re.search(r"(v[12]_op|alu[12]\w*|bulk_fill_copy|win_move|"
                           r"opt_copy)", mangled)
            fused = "5Fused" in mangled
            cur = (f"interp_kernel<kBulk={inst.group(1)}, "
                   f"kSimd={inst.group(2)}{', Fused' if fused else ''}"
                   f"{', kWin' if inst.group(3) == '1' else ''}"
                   f"{', kOpt' if inst.group(4) == '1' else ''}>"
                   if inst else fn.group(1) if fn else mangled)
            rows.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            rows[cur].update(stack_bytes=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            rows[cur]["registers"] = int(m.group(1))
    return rows


def kernel_registers(win: bool = False, opt: bool = False,
                     split: bool = False) -> dict:
    """parse_ptxas of the per-op build (with the window cache when `win`,
    with optimistic convergence when `opt`, with the stack split when
    `split`)."""
    from wasmedge_tpu_torch.batch import interp

    info = interp.BUILD_INFO["per_op"].get(
        interp.per_op_label(win, opt, split), {})
    return parse_ptxas(info.get("ptxas", ""))


def window_attributes() -> dict:
    """The CUDA runtime's report (registers, local bytes, shared memory,
    blocks per SM, stack rows on chip) of the per-op instantiations with
    and without the window cache (at fib's depth, 256) and of config 2's
    fused builds (at its depth, 128), printed."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.models import (
        build_coremark_kernel, build_memory_workload)

    out = {}
    for opt in (False, True):
        for win in (False, True):
            for inst, a in interp.per_op_attributes(win, opt).items():
                out[f"per-op <{inst}{', kWin' if win else ''}"
                    f"{', kOpt' if opt else ''}>"] = a
    for name, data in (("mem_checksum",
                        build_memory_workload(passes=MEM_PASSES)),
                       ("coremark", build_coremark_kernel())):
        for m in (True, False):
            for opt in (None, False):
                eng, _ = make_engine(data, 2, fusion="blocks", mem_hbm=m,
                                     optimistic=opt, **MEM_STACKS)
                out[f"{name} blocks{' kWin' if m else ''}"
                    f"{' kOpt' if opt is None else ''}"] = \
                    interp.kernel_attributes(
                        eng.tables, MEM_STACKS["value_stack_depth"])
    for name, a in out.items():
        print(f"  attributes {name}: {a['registers']} registers, "
              f"{a['local_bytes']} B local, {a['static_smem_bytes']} B "
              f"static + {a['launch_smem_bytes']} B dynamic shared memory "
              f"per block (limit {a['max_dynamic_smem_bytes']} B), "
              f"{a['blocks_per_sm']} blocks of {a['threads_per_block']} "
              f"threads per SM, {a['stack_rows']} stack rows on chip",
              flush=True)
    return out


def kernel_row(tables) -> dict:
    """ptxas's registers and spills of the interp_kernel instantiation
    that runs `tables`."""
    from wasmedge_tpu_torch.batch import interp

    if tables.fusion == "none":
        rows = kernel_registers(tables.mem_window, tables.optimistic,
                                tables.stack_split)
        want = (f"interp_kernel<kBulk={int(tables.has_bulk)}, "
                f"kSimd={int(tables.has_simd)}")
        rows = {k: v for k, v in rows.items() if k.startswith(want + ">")
                or k.startswith(want + ",")}
    else:
        info = interp.BUILD_INFO["fused"].get(
            interp.fused_kernel_key(tables), {})
        rows = parse_ptxas(info.get("ptxas", ""))
    for k, v in rows.items():
        if k.startswith("interp_kernel"):
            return v
    return {}


def phase_geometry() -> dict:
    """One geometry line per main-path instantiation: threads per block,
    dynamic shared bytes per block, blocks per SM (CUDA runtime), the
    stack rows on chip of its depth, registers and spills (ptxas); the
    host helper `interp.block_geometry` must give the kernel's threads,
    rows and bytes."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.models import (
        build_bulk_workload, build_fib, build_memory_workload,
        build_simd_loop)
    from wasmedge_tpu_torch.models.fixtures import build_deep_recursion

    runs = [("fib(30)", build_fib(), dict(value_stack_depth=256,
                                          call_stack_depth=256), "blocks"),
            ("fib(30)", build_fib(), dict(value_stack_depth=256,
                                          call_stack_depth=256), "none"),
            ("fib(30)", build_fib(), dict(value_stack_depth=256,
                                          call_stack_depth=256), "super"),
            ("vloop", build_simd_loop(), dict(
                value_stack_depth=64, call_stack_depth=16,
                memory_pages_per_lane=1), "blocks"),
            ("config 2 mem_checksum", build_memory_workload(
                passes=MEM_PASSES), MEM_STACKS, "blocks"),
            ("bulk", build_bulk_workload(), dict(
                value_stack_depth=64, call_stack_depth=16,
                memory_pages_per_lane=1), "blocks"),
            ("deep recursion", build_deep_recursion(), dict(
                value_stack_depth=1024, call_stack_depth=128), "blocks")]
    out = {}
    for name, data, knobs, fusion in runs:
        for opt in (None, False):
            eng, _ = make_engine(data, 2, fusion=fusion, optimistic=opt,
                                 **knobs)
            tb = eng.tables
            D = knobs["value_stack_depth"]
            a = interp.kernel_attributes(tb, D)
            g = interp.block_geometry(D, tb.has_simd, tb.mem_window)
            if (a["threads_per_block"], a["stack_rows"],
                    a["launch_smem_bytes"]) != (g["threads_per_block"],
                                                g["stack_rows"],
                                                g["smem_bytes"]):
                fail(f"geometry {name}: the kernel's {a} != the host "
                     f"helper's {g}")
            r = kernel_row(tb)
            key = (f"{name} [{fusion}{', windows' if tb.mem_window else ''}"
                   f"{', optimistic' if tb.optimistic else ', careful'}]")
            out[key] = dict(a, depth=D, spill_stores=r.get("spill_stores"),
                            spill_loads=r.get("spill_loads"))
            if a["stack_split"] != tb.stack_split:
                fail(f"geometry {name}: the build's stack split "
                     f"{a['stack_split']} != the tables' {tb.stack_split}")
            print(f"geometry {key}: {a['threads_per_block']} threads per "
                  f"block, {a['launch_smem_bytes']} B dynamic shared memory "
                  f"per block, {a['blocks_per_sm']} blocks per SM, R "
                  f"{a['stack_rows']} of {D} stack rows on chip"
                  f"{' (split stack build)' if tb.stack_split else ''}, "
                  f"{a['registers']} registers, {r.get('spill_stores', 0)} B "
                  f"spill stores, {r.get('spill_loads', 0)} B spill loads; "
                  f"{-(-MAIN_LANES // a['threads_per_block'])} blocks at "
                  f"{MAIN_LANES} lanes", flush=True)
    return out


def print_registers(label: str, rows: dict) -> None:
    for name, r in rows.items():
        print(f"  ptxas {label}: {name}: {r.get('registers', '-')} registers, "
              f"{r.get('stack_bytes', 0)} B stack frame, "
              f"{r.get('spill_stores', 0)} B spill stores, "
              f"{r.get('spill_loads', 0)} B spill loads", flush=True)


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "cuobjdump")
    return path if os.path.exists(path) else "cuobjdump"


def sass_of(so: str) -> str:
    return subprocess.run([cuobjdump(), "-sass", so], capture_output=True,
                          text=True, check=True).stdout


def sass_stats(text: str) -> dict:
    """Per interp_kernel instantiation in `cuobjdump -sass` output: its
    machine code bytes and its indirect branches (BRX: a jump table
    each)."""
    rows, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if "interp_kernel" in m.group(1) else None
            if cur:
                rows[cur] = {"sass_bytes": 0, "brx": 0}
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if m and cur:
            rows[cur]["sass_bytes"] = int(m.group(1), 16) + 16
            rows[cur]["brx"] += bool(re.search(r"\bBRX\b", m.group(2)))
    return rows


def without_cases(tables, img):
    """Blocks `tables` whose fused source has no block case (every pc
    through the hid plane, a block head as its own op): the baseline of a
    build's indirect branches."""
    import dataclasses

    from wasmedge_tpu_torch.batch import fusegen

    hid0 = tables.hid0.cpu().tolist()
    return dataclasses.replace(tables, fused_source=fusegen.cuda_source(
        hid0, (), tables.has_bulk, tables.has_simd, tables.mem_window,
        tables.optimistic, tables.stack_split, img=img, hid0=hid0))


def instance_cases(tables) -> int:
    """The B2 instance cases of the fused build of `tables` (its generated
    source's count)."""
    return int(re.search(r"\((\d+) block instance cases",
                         tables.fused_source).group(1))


def prebuild() -> dict:
    """Build every kernel the script runs, all nvcc processes at once:
    the per-op kernel (direct access and window cache, a library each)
    and the fused kernel of each module, encoding and memory mode (the
    fused fixtures, the main-path modules, the SIMD corpus module).  The
    generated source depends only on the module, the encoding and the
    memory mode, so tables made on the CPU name the same builds as the
    card's."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.models import (
        build_bulk_workload, build_coremark_kernel, build_echo, build_fib,
        build_memory_workload, build_simd_loop, build_wasi_hello)
    from wasmedge_tpu_torch.models.fixtures import (
        build_bulk_warp, build_deep_recursion, build_host_double,
        build_window_host)
    from wasmedge_tpu_torch.spec import corpus_tables

    # (module, v128 ops, imports, encodings, value-stack depth[, instance
    # cap]): the builds each comparison and main-path run of the script
    # uses (a depth whose rows all fit on chip names the build without the
    # stack split)
    def encs(simd):
        return ("blocks",) if simd else ("blocks", "super")

    mods = [(data, simd, (), encs(simd), kn["value_stack_depth"],
             kn.get("instance_cap"))
            for _, data, _, _, _, _, kn, simd in fused_fixtures(2)]
    mods += [(data, simd, (), encs(simd), kn["value_stack_depth"], None)
             for _, data, _, _, _, kn, simd, _ in opt_fixtures(2)]
    env, wasi = (env_import,), (lambda: wasi_import(1),)
    mods += [(build_fib(), False, (), encs(False), 256),
             (build_coremark_kernel(), False, (), ("blocks",), 256),
             (build_simd_loop(), True, (), ("blocks",), 64),
             (build_bulk_workload(), False, (), ("blocks",), 64),
             (build_memory_workload(passes=MEM_PASSES), False, (),
              ("blocks",), MEM_STACKS["value_stack_depth"]),
             (build_host_double(), False, env, encs(False), 64),
             (build_window_host(), False, env, encs(False), 64),
             (build_bulk_warp(), False, (), ("blocks",), 64),
             (build_deep_recursion(), False, (), ("blocks",), 1024),
             (build_echo(), False, wasi, encs(False), 64),
             (build_wasi_hello(), False, wasi, ("blocks",), 64)]
    tables = []
    for data, simd, imports, fusions, depth, *cap in mods:
        for fusion in fusions:
            for opt in (None, False):
                for _, (eng, _) in memory_modes(lambda m: make_engine(
                        data, 2, device="cpu", imports=[f() for f in imports],
                        fusion=fusion, mem_hbm=m, optimistic=opt,
                        value_stack_depth=depth,
                        instance_cap=(cap or [None])[0])):
                    tables.append(eng.tables)
    tables += corpus_tables([SIMD_WAST])
    tables += corpus_tables(corpus_files(), corpus_conf())
    # the main path's fib(30) and vloop blocks builds, kOpt and careful,
    # and each module once more with no block case (every pc through the
    # hid plane): the difference in BRX says what the pc switch compiled
    # to
    mains = {}
    for name, data, depth in (("fib", build_fib(), 256),
                              ("vloop", build_simd_loop(), 64)):
        for opt in (None, False):
            eng = make_engine(data, 2, device="cpu", fusion="blocks",
                              optimistic=opt, value_stack_depth=depth,
                              call_stack_depth=16,
                              memory_pages_per_lane=1)[0]
            base = without_cases(eng.tables, eng.img)
            mains[f"{name}_blocks_{'kopt' if opt is None else 'careful'}"] \
                = (eng.tables, base)
            tables.append(base)
    t0 = time.perf_counter()
    # the per-op build for every memory and B3 mode (every per-op run of
    # the script has a depth whose rows all fit on chip)
    interp.build_kernels(tables, per_op=[
        (w, o, False) for w in (False, True) for o in (False, True)])
    wall = time.perf_counter() - t0
    cases = {interp.fused_kernel_key(t): instance_cases(t) for t in tables
             if t.fusion != "none"}
    infos = interp.BUILD_INFO["fused"]
    with ThreadPoolExecutor(8) as pool:
        sass = dict(zip(infos, pool.map(lambda i: sass_of(i["path"]),
                                        infos.values())))
    # the main path's pc switches: a jump table adds one BRX per dispatch
    # loop over the same module with no block case, a compare tree none
    switches = {}
    for label, (tb, base) in mains.items():
        key, bkey = (interp.fused_kernel_key(t) for t in (tb, base))
        brx, bbrx = (next(iter(sass_stats(sass[k]).values()))["brx"]
                     for k in (key, bkey))
        loops = 2 if tb.optimistic else 1
        what = {loops: "a jump table", 0: "compare trees"}.get(
            brx - bbrx, f"{brx - bbrx} jump tables over {loops} loops")
        switches[label] = dict(key=key, brx=brx, brx_without_cases=bbrx,
                               pc_switch=what)
        print(f"  pc switch of {label} ({key}): {what} ({brx} BRX, {bbrx} "
              f"with no block case)", flush=True)
    builds = {}
    for key, info in infos.items():
        rows = parse_ptxas(info.get("ptxas", ""))
        ss = sass_stats(sass[key])
        code = next(iter(ss.values()), {})
        builds[key] = dict(fusion=info.get("fusion"),
                           shapes=info.get("shapes"),
                           mean_len=info.get("mean_len"),
                           mem_window=info.get("mem_window"),
                           optimistic=info.get("optimistic"),
                           instance_cases=cases.get(key),
                           seconds=info.get("seconds"), ptxas=rows,
                           sass_bytes=code.get("sass_bytes"),
                           brx=code.get("brx"))
        print(f"  fused build {key} [{info.get('fusion')}"
              f"{', windows' if info.get('mem_window') else ''}"
              f"{', optimistic' if info.get('optimistic') else ''}]: "
              f"{cases.get(key)} instance cases, {info.get('shapes')} block "
              f"shapes, mean length {info.get('mean_len') or 0:.2f}, nvcc "
              f"{info.get('seconds') or 0:.1f} s, SASS "
              f"{code.get('sass_bytes')} B, {code.get('brx')} BRX",
              flush=True)
        print_registers(key, rows)
    return dict(wall_s=wall, n_fused=len(builds), fused=builds,
                pc_switches=switches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", flush=True)
        return 2
    from wasmedge_tpu_torch.batch import interp

    card = gpu_name_and_power()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, card: {card}", flush=True)

    t0 = time.perf_counter()
    builds = prebuild()
    t_build = time.perf_counter() - t0
    per_op_s = {k: round(v.get("seconds", 0), 2)
                for k, v in interp.BUILD_INFO["per_op"].items()}
    print(f"phase build: {t_build:.2f} s (per-op nvcc {per_op_s}, "
          f"{builds['n_fused']} fused builds, all at once)", flush=True)
    per_op_regs = {interp.per_op_label(w, o): kernel_registers(w, o)
                   for o in (False, True) for w in (False, True)}
    for label, rows in per_op_regs.items():
        print_registers(f"per-op, {label}", rows)
    regs = per_op_regs[interp.per_op_label(False, False)]
    win_regs = per_op_regs[interp.per_op_label(True, False)]
    attrs = window_attributes()
    geometry = phase_geometry()

    t0 = time.perf_counter()
    w = run_jobs({"rows": rows_jobs(),
                  "scalar": scalar_jobs() + host_jobs(),
                  "simd": simd_jobs(), "fused": fused_jobs(),
                  "opt": opt_jobs() + host_jobs(
                      "none", ("wasi_echo", "window_host"))})
    worst, simd_worst, fused_worst, opt_worst, rows_worst = (
        w["scalar"], w["simd"], w["fused"], w["opt"], w["rows"])
    t_jobs = time.perf_counter() - t0
    timing = {f: phase_time_one_launch(f) for f in ("none", "blocks", "super")}
    bulk_timing = phase_time_bulk()
    simd_timing = phase_time_simd_launch("blocks")
    simd_op_timing = phase_time_simd_launch("none")
    mem_timing = phase_time_mem_launch()
    t_kernel = time.perf_counter() - t0
    print(f"phase kernel_vs_plain: {t_kernel:.2f} s (comparisons "
          f"{t_jobs:.2f} s on {WORKERS} workers), max abs err "
          f"{max(worst, simd_worst, fused_worst, opt_worst, rows_worst)} "
          f"(warp bulk pass and stack rows {rows_worst}; window cache "
          f"{WINDOW_WORST[0]}; optimistic against plain "
          f"{OPT_WORST['plain']}, against careful below sp "
          f"{OPT_WORST['careful']})", flush=True)
    print(f"optimistic warps per fixture: {json.dumps(OPT_FIXTURES)}",
          flush=True)
    print(f"bulk ops per warp-pass fixture: {json.dumps(BULK_FIXTURES)}",
          flush=True)

    t0 = time.perf_counter()
    main_out = phase_main()
    scalar = regs.get("interp_kernel<kBulk=0, kSimd=0>", {})
    print(f"fib(30) x {MAIN_LANES} per-op ran interp_kernel<kBulk=0, "
          f"kSimd=0> ({scalar.get('registers')} registers, "
          f"{scalar.get('spill_stores', 0)} B spill stores): wall "
          f"{main_out['fib30_none']['wall_s']:.3f} s; blocks "
          f"{main_out['fib30']['wall_s']:.3f} s, super "
          f"{main_out['fib30_super']['wall_s']:.3f} s", flush=True)
    main_out.update(phase_main_wasi())
    main_out["bulk"] = phase_main_bulk()
    main_out["simd_corpus"] = phase_simd_corpus()
    main_out["spec_corpus"] = phase_spec_corpus()
    main_out["vloop"] = phase_main_simd()
    main_out["config2"] = phase_main_memory()
    t_main = time.perf_counter() - t0
    print(f"phase main: {t_main:.2f} s", flush=True)

    def per_launch(prof):
        return prof["kernel_ms"] / prof["launches"]

    def launch_record(name, source, replaces, launches, t, worst_err,
                      prof, **extra):
        # "ms", "plain_ms" and "bound_ms" are for one launch of
        # TIMED_STEPS steps (the plain version cannot run a main-path
        # launch in the time limit) through the instantiation the main
        # path runs, optimistic convergence on (the default), its bound
        # counting the snapshots; "careful_ms" and "careful_bound_ms" are
        # the same launch through the careful instantiation, and
        # "refused_ms" / "refused_careful_ms" the optimistic and careful
        # builds on the same state with no warp entering;
        # "main_ms_per_launch" is the kernel's device time per launch of
        # the main-path run whose launches "launches" counts.
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(worst_err, t["max_abs_err"]),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None, "careful_ms": t["careful_ms"],
                "careful_bound_ms": t["careful_bound_ms"],
                **{k: t[k] for k in ("refused_ms", "refused_careful_ms")
                   if k in t},
                **extra, "main_ms_per_launch": per_launch(prof)}

    fib_launch = {"workload": "fib(30)", "lanes": MAIN_LANES,
                  "steps": TIMED_STEPS}
    record = launch_record(
        "wasm_interp", "wasmedge_tpu_torch/csrc/interp.cu",
        "wasmedge_tpu/batch/pallas_engine.py:3825",
        main_out["fib30_none"]["op_launches"], timing["none"],
        max(worst, rows_worst), main_out["fib30_none"]["profile"],
        timed_launch=dict(fib_launch, retired=timing["none"]["retired"]))
    # B2 and B6: the fused kernel of fib's module, its launches in the
    # main path's fib(30) run with block_fusion None (blocks) and False
    # (superinstructions)
    # B2's other main-path runs in blocks (the default): vloop and config
    # 2's mem_checksum, their launches and kernel ms per launch, kOpt and
    # careful
    vb, c2 = main_out["vloop"]["blocks"], main_out["config2"]
    block_record = launch_record(
        "block", "wasmedge_tpu_torch/csrc/fused.cuh",
        "wasmedge_tpu/batch/pallas_engine.py:2758",
        main_out["fib30"]["block_launches"], timing["blocks"], fused_worst,
        main_out["fib30"]["profile"],
        careful_main_ms_per_launch=per_launch(
            main_out["fib30_careful"]["profile"]),
        timed_launch=dict(fib_launch, retired=timing["blocks"]["retired"]),
        generator="wasmedge_tpu_torch/batch/fusegen.py",
        vloop_launches=vb["block_launches"],
        vloop_main_ms_per_launch=per_launch(vb["profile"]),
        vloop_careful_main_ms_per_launch=per_launch(
            vb["careful"]["profile"]),
        mem_checksum_launches=c2["mem_checksum"]["block_launches"],
        mem_checksum_main_ms_per_launch=per_launch(
            c2["mem_checksum"]["profile"]),
        mem_checksum_careful_main_ms_per_launch=per_launch(
            c2["mem_checksum"]["careful"]["profile"]))
    super_record = launch_record(
        "super", "wasmedge_tpu_torch/csrc/fused.cuh",
        "wasmedge_tpu/batch/pallas_engine.py:2472",
        main_out["fib30_super"]["super_launches"], timing["super"],
        fused_worst, main_out["fib30_super"]["profile"],
        timed_launch=dict(fib_launch, retired=timing["super"]["retired"]),
        generator="wasmedge_tpu_torch/batch/fusegen.py")
    # h_memfill / h_memcopy are cases of the same kernel: "ms",
    # "plain_ms", "bound_ms" and "library_ms" are for one launch of the
    # converged bulk pair (fill 32 KiB, copy 16 KiB, every lane);
    # "launches" counts the main path's bulk-workload launches, whose
    # code holds the two cases.
    bulk_record = {
        "name": "h_memfill_memcopy",
        "route": "cuda",
        "source": "wasmedge_tpu_torch/csrc/interp.cu",
        "replaces": "wasmedge_tpu/batch/pallas_engine.py:1389",
        "launches": main_out["bulk"]["bulk_launches"],
        "max_abs_err": max(worst, rows_worst,
                           bulk_timing["aligned"]["max_abs_err"],
                           bulk_timing["unaligned"]["max_abs_err"]),
        "ms": bulk_timing["aligned"]["ms"],
        "plain_ms": bulk_timing["aligned"]["plain_ms"],
        "bound_ms": bulk_timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": bulk_timing["library_ms"],
        "careful_ms": bulk_timing["aligned"]["careful_ms"],
        "careful_bound_ms": bulk_timing["careful_bound_ms"],
        "unaligned_ms": bulk_timing["unaligned"]["ms"],
        "unaligned_careful_ms": bulk_timing["unaligned"]["careful_ms"],
        # B5's warp pass: bulk ops over the timed pair's launches and the
        # main bulk workload's run
        "pair_bulk_ops": bulk_timing["aligned"]["bulk_ops"],
        "main_bulk_ops": main_out["bulk"]["bulk_ops"],
        "main_kernel_ms": main_out["bulk"]["profile"]["kernel_ms"],
        "main_bound_ms": main_out["bulk"]["bulk_bound_ms"],
    }
    # B7, the v128 ops: one launch of TIMED_STEPS steps of vloop(SIMD_N)
    # x MAIN_LANES in B2 blocks, the main path (block_fusion None: each
    # v128 op inlined by its sub in its block's case); "launches" counts
    # the main path's vloop launches in blocks.  "per_op_*": the same
    # launch and run with block_fusion False (the per-op kernel's
    # simd_step, the sub known at run time)
    vn = main_out["vloop"]["none"]
    simd_record = launch_record(
        "v128", "wasmedge_tpu_torch/csrc/interp.cu",
        "wasmedge_tpu/batch/pallas_engine.py:3203",
        vb["simd_launches"], simd_timing, max(simd_worst, fused_worst),
        vb["profile"],
        careful_main_ms_per_launch=per_launch(vb["careful"]["profile"]),
        timed_launch={"workload": f"vloop({SIMD_N})", "lanes": MAIN_LANES,
                      "steps": TIMED_STEPS, "encoding": "blocks",
                      "retired": simd_timing["retired"]},
        per_op_ms=simd_op_timing["ms"],
        per_op_careful_ms=simd_op_timing["careful_ms"],
        per_op_plain_ms=simd_op_timing["plain_ms"],
        per_op_bound_ms=simd_op_timing["bound_ms"],
        per_op_launches=vn["simd_launches"],
        per_op_main_ms_per_launch=per_launch(vn["profile"]))
    # B4, the window cache: "ms", "plain_ms" and "bound_ms" are for one
    # per-op launch of TIMED_STEPS steps of config 2's mem_checksum from
    # the lanes' first store, windowed ("direct_*": the same launch with
    # mem_hbm False); "launches" counts the window-cache launches of
    # config 2's main path, mem_checksum in the default encoding (B2
    # blocks, windows on by default)
    window_record = launch_record(
        "mem_window", "wasmedge_tpu_torch/csrc/memwin.cuh",
        "wasmedge_tpu/batch/pallas_engine.py:1752",
        c2["mem_checksum"]["window_launches"], mem_timing, WINDOW_WORST[0],
        c2["mem_checksum"]["profile"],
        direct_ms=mem_timing["direct"]["ms"],
        direct_careful_ms=mem_timing["direct"]["careful_ms"],
        direct_plain_ms=mem_timing["direct"]["plain_ms"],
        direct_bound_ms=mem_timing["direct"]["bound_ms"],
        careful_main_ms_per_launch=per_launch(
            c2["mem_checksum"]["careful"]["profile"]),
        per_op_window_launches=c2["mem_checksum_none"]["window_launches"],
        timed_launch={"workload": f"mem_checksum({MEM_N}), {MEM_PASSES} "
                      f"passes", "lanes": MAIN_LANES, "steps": TIMED_STEPS,
                      "from_step": mem_timing["first_step"],
                      "retired": mem_timing["retired"]})
    # B3, optimistic convergence: the B2 blocks launch of fib(30) above
    # (the instantiation of the main path's default fib(30) run, whose
    # optimistic launches "launches" counts, whose profile gives
    # "main_ms_per_launch" and whose warps give the commits and
    # rollbacks), its bound the launch's bytes plus the snapshots'
    fib30 = main_out["fib30"]
    opt_record = launch_record(
        "optimistic", "wasmedge_tpu_torch/csrc/optimistic.cuh",
        "wasmedge_tpu/batch/pallas_engine.py:958",
        fib30["optimistic_launches"], timing["blocks"],
        max(opt_worst, OPT_WORST["plain"]), fib30["profile"],
        careful_main_ms_per_launch=per_launch(
            main_out["fib30_careful"]["profile"]),
        commits=fib30["warps"]["commits"],
        rollbacks=fib30["warps"]["rollbacks"],
        snapshot_bytes=timing["blocks"]["snapshot_bytes"],
        bytes_per_commit=timing["blocks"]["bytes_per_commit"],
        careful_max_abs_err=OPT_WORST["careful"],
        timed_launch=dict(fib_launch, encoding="blocks",
                          retired=timing["blocks"]["retired"]))
    print(json.dumps({"phases_s": {"build": t_build, "kernel": t_kernel,
                                   "main": t_main},
                      "registers": per_op_regs, "attributes": attrs,
                      "geometry": geometry, "bulk_fixtures": BULK_FIXTURES,
                      "builds": builds, "one_launch": timing,
                      "opt_fixtures": OPT_FIXTURES,
                      "bulk_pair": bulk_timing, "simd_launch": simd_timing,
                      "simd_launch_per_op": simd_op_timing,
                      "mem_launch": mem_timing, "main": main_out}),
          flush=True)
    print(json.dumps({"kernels": [record, block_record, super_record,
                                  bulk_record, simd_record, window_record,
                                  opt_record]}),
          flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
