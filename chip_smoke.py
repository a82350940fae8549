"""Chip smoke test of the PyTorch/CUDA port (`wasmedge_tpu_torch`) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases:
  1. build   - compile every kernel the script runs, one nvcc process per
               source: those of the main phase (3) all started together,
               the rest queued to run in the background, seven at a time
               at the lowest CPU priority, while the main phase runs,
               and every one still queued when it ends started together
               then: the per-op warp-interpreter
               (csrc/interp.cu, four instantiations, a library each with
               direct memory access and with the B4 window cache,
               csrc/memwin.cuh, with and without B3 optimistic
               convergence, csrc/optimistic.cuh; and the same four with
               the tier-0 handlers, WASM_TIER0, and with the table,
               segment and tail-call handlers, WASM_TABLES, one
               instantiation each)
               and, per module (WASI modules with tier 0 on and off),
               encoding, memory mode, optimistic or careful and stack
               split or not (WASM_STACK_SPLIT: deeper stacks than the
               rows on chip), the fused kernel (csrc/interp.cu +
               csrc/fused.cuh + the dispatch batch/fusegen.py generates
               for its B2 block heads, one instance case each, or B6
               superinstructions), the spec corpus's modules and config
               5's concatenated image included;
               print each build's instance cases, seconds, shapes, mean
               shape length, registers and spills, the SASS bytes and
               indirect branches (BRX) of the main path's fib(30) and
               vloop builds against the same modules with no block case
               (what the pc switch compiled to), and what the CUDA
               runtime reports of
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
               the 512 on-chip rows of a 1024-row stack; tier 0 (the
               host-call fixtures above run with it off): the tier-0 zoo
               (clock ids served, parked and refused, random_get lengths
               and offsets, sched_yield, proc_exit on some lanes, an
               unaligned lane-dependent fd_write to fds 1, 2 and 3, the
               shapes that park or fault, a 16-word stdout buffer that
               fills, a uniform warp's random_get: every warp uniform, no
               rollback, per-lane bytes), a module whose fd_close keeps
               fd_write on the host, WASI echo and hello, per-op, in
               blocks and super (hello: per-op and blocks), optimistic and
               careful, both memory modes, with the same time base on
               both sides at every launch, the host's cputime clocks and
               urandom fixed, a serve round and a stdout flush after
               every launch, every plane (t0_ctr, so_buf, so_off) and the
               per-warp counts equal and stdout byte for byte; tables,
               segments, tail calls and weighted gas (table_fixtures):
               every case of the table zoo (every table, segment,
               tail-call and ref.func class, every trap they raise, a
               grow past the capacity, segments used after a drop, lanes
               of one warp calling one index of tables that differ, which
               must roll back) per-op and in blocks (its super encoding
               cut for the script's time), and the
               tail-dispatch workload at 12 steps in both modes (per-op
               and blocks; converged: every warp uniform) and with
               weighted gas and a budget that runs out inside a block,
               every plane (tab, tsize, edrop, ddrop) and the per-warp
               counts after every launch; the linked program (a consumer
               whose start function fills the memory, table and global it
               imports from a registered provider, then loops over loads
               and call_indirect: models.fixtures.build_linked_program) at
               small n, in blocks, with and without a fuel budget that
               runs out on some lanes (warps roll back, none uniform);
               the concatenated images (mix_jobs): config 5's four
               modules at 256 lanes (61 / 67 / 59 / 69: warps hold two
               modules) with small lane-dependent arguments, in blocks and
               per op; with the plain version on the card, the C10 pair
               (two memory.grow tenants whose memories declare max 1 and
               max 4, four pages a lane) per op and one launch from a
               serving state just after an install round (four modules,
               idle TRAP_DONE lanes beside the installed ones), and
               another over the gateway's generation 2 (the five modules
               through its registry, echo lanes parked at fd_write by
               the launch); lane
               compaction (compact_jobs, the plain side on the card):
               narrowed launches of fib(10 + lane % 11) x 4096 at widths
               64 and 1024 (every lane live: the lanes beyond the width
               must stay bit-unchanged on both sides) per op and in
               blocks, optimistic and careful, and a launch of the
               CoreMark-style kernel x 4096 right after a permutation, in
               both memory modes.
               Then, in a spawned process of their own (what the main
               phase left in this process slowed them), one 256-step
               launch of fib(30) x 4096 in each
               encoding, one converged memory.fill + memory.copy launch
               (also as PyTorch tensor calls, its warp passes counted),
               one 256-step vloop launch x 4096 (blocks, the main path,
               and per-op) and one 256-step per-op
               launch of config 2's mem_checksum x 4096 from the first
               store (windows and direct), each through the optimistic
               kernel the main path runs and through the careful one,
               against the optimistic plain version on the card, and (but
               the bulk pair) once more with no warp entering, each with
               its bound; one 256-step launch of the converged tail
               dispatch x 4096 from its start the same way, and with
               weighted gas and flat fuel (the gas kernel against its
               plain version, the fuel it spent against its
               instructions' weights);
  3. main    - (run after the main phase's builds and before the kernel
               phase, each part's seconds printed) at full size: the
               linked program x 4096 through
               VM.register_module -> load_wasm -> validate -> instantiate
               (its start function on the host's scalar engine, timed)
               -> execute_batch, run(n, k) with k = lane and n = 160,000 +
               (lane % 8) 20,000 (about 8e6 instructions a lane), every
               lane equal to the numpy model, 8 lanes at small n equal on
               VM.execute (the host) and the card, profiled and once more
               careful, and with statistics.cost_measuring and a cost
               limit of lane group 3's instructions (groups 0-3 finish,
               4-7 trap CostLimitExceeded at the limit + 1); the 23 spec
               files through the port's scalar harness on the host
               (10,135 / 0 / 0, each file to its count); the tail-dispatch workload x 4096
               (run(seed, 700,000), about 3e7 instructions a lane;
               divergent run(seed, 87,500)) in
               both modes through VM.execute_batch, every lane equal to
               the numpy model, the call depth 0 after every launch,
               every converged warp entry uniform and no divergent one,
               each careful too, and the converged run with flat fuel and
               with weighted gas; fib(30) x 4096 through VM.execute_batch in the
               default encoding (B2 blocks), then fib(27) per-op ("none")
               and with block_fusion False (B6), each once more under
               torch.profiler; a divergent fib mix x 4096; CoreMark(200)
               and CoreMark(4096) x 4096 with one 64 KiB page per lane
               (CoreMark(4096) in blocks and per-op, profiled); WASI echo x
               4096 (32,768 fd_write calls, output checked byte for byte)
               with tier 0 (every call retired in the kernel, no serve
               round, one stdout flush) and with it off (every call
               served between launches), each profiled; the tier-0 echo
               launch timed against its careful twin, the plain version
               and the tier-0-off launch, with its flush; WASI hello x
               4096 (proc_exit codes, proc_exit in the kernel), the
               bulk-memory workload x 4096 (checked against a bytearray
               model, its warp passes counted); the SIMD spec corpus
               (tests/spec/simd.wast) through run_corpus_batched on the
               card, strict, every launch in B2 blocks; vloop(1,000,000) x
               4096 (bench_simd.py's shape) in blocks and, at 250,000,
               with block_fusion False (per-op), every lane's result and retired
               count checked, each profiled; BASELINE config 2
               (bench_memory.py's shape): mem_checksum(8192) with 64 passes
               and coremark(65536) x 4096, stacks 128 / 64, one page, in
               blocks and per-op (mem_checksum per op at 2048 words),
               windows on (the default) and off, every
               lane against its oracle, each profiled.  Every memory
               workload runs with the windows (the default) and once more
               with mem_hbm False.  Everything runs optimistic (B3, the
               default); fib(30) and the mix, config 2's mem_checksum in
               blocks (both memory modes) and vloop in blocks run once
               more with optimistic False, profiled.  The 22 non-SIMD
               spec corpus files run on the card with the reference test's
               depths, strict (7,155 / 0 / 345), the five table and
               tail-call files each to its own counts.  Every run sets the
               launch counts to 0 before it and fails unless its kernels
               launched (with a memory, every launch ran the window cache
               or none did; every launch optimistic where the knob is on,
               none where it is off).  BASELINE config 5
               (bench_multi.py:27-47, stacks 256 / 256): fib(30),
               fac(20), loop_sum(16,000,000) and coremark(262,144), 1024
               lanes each, each alone on its own BatchEngine (equal to its
               numpy model, profiled), then the four as one concatenated
               image (MultiTenantBatchEngine.run_tenants), every tenant's
               results, traps and retired equal to its solo run,
               profiled, and again with optimistic False; the same with
               1021 / 1029 / 1011 / 1035 lanes at fib(25), fac(20),
               loop_sum(1,000,000), coremark(16,384) (three warps hold two
               modules); B3 entries by tenant and for the mixed warps.
               Serving: BatchServer(engine=MultiModuleBatchEngine(the four
               modules, 4096 lanes)), 65,536 steps a launch, 16,384
               seeded requests over four tenants (weights 1 / 1 / 2 / 4,
               a quota on one), run_until_idle: every future equal to its
               model, rounds, recycled lanes, requests/s, latency p50 and
               p99, instr/s, and (profiled once more) the kernel's share
               of the wall.  Lane compaction (conf.batch.compact, the
               default knobs): the divergent fib mix through
               VM.execute_batch with it on and once more with
               compact_narrow False, the straddling config-5 mix through
               run_mixed and the serving run, each equal to the same
               call's uncompacted run (results, traps, retired; serving:
               every future its model), profiled, with the compactor's
               fires, moved lanes, launch widths, dispatch slots, the
               gathers' ms and the boundaries' host ms; checkpoint round
               trips (batch/checkpoint.py): the compacted fib mix saved
               after a boundary that permuted its lanes (lane_src) and
               config 2's coremark(65536) after its first launch, each
               loaded into a fresh engine and finished equal to the
               uninterrupted run, the file's bytes and the save and load
               seconds printed.  Tier 0's stdout flush runs through its
               kernel (csrc/stdout_flush.cu) on the card: every flush
               of the script's CUDA tensors (the tier-0 jobs, echo and
               hello, the stdout cursor's round trips, compacted and
               not) is recorded with a copy of its inputs and held
               against the plain version, `_records`: the bytes on each
               fd and each lane's payload count (the cursor's advance);
               the tier-0 jobs and the round trips compare the cursors
               too.  The B6 builds ("super") are instance cases by pc,
               as B2's: each super job holds them against the plain
               version at every launch.  Supervision (phase_supervise,
               batch/supervisor.py and the server's recovery): the fib
               mix under BatchSupervisor with a checkpoint every 4
               launches and one injected launch fault after the second
               checkpoint; coremark(4096) x 4096 with windows, a
               checkpoint every 4 launches of 8192 steps and a launch
               fault that corrupts the newest member first (the lineage
               falls back); the fib mix with max_retries + 1 faults in a
               row (demoted to the per-op "none" tables, finishing from
               the lineage); lanes 0 and 11 poisoned (terminated: under
               an engine on the card the supervisor runs nothing on the
               host); VM.execute_batch(supervised=True,
               resume=True) adopting the first run's lineage; the
               compacted serving run with a checkpoint every 32 rounds
               and one launch fault: each equal to its unsupervised run
               (results, traps, retired; serving: every future), each
               run's wall, every checkpoint's save and load ms and bytes,
               the replay, and the demoted rung's time against the
               blocks rung's over the same steps.  The HTTP gateway
               (phase_gateway, gateway/ and imagestore/): a
               GatewayService on the card over config 5's four modules
               at 4096 lanes (its fused build phase_serve's), real HTTP
               on 127.0.0.1 from 64 client threads, 4096 seeded
               requests sync and async with polling; under that traffic
               a POST of the WASI echo module faulted at its generation
               build (503 with Retry-After, generation 1 serving on) and
               its re-POST, which lowers nothing and swaps in generation
               2 (the five modules; its kernel, queued first in the
               background builds, taken in the timed build) while
               generation 1 drains; 1024 requests more over all five
               modules; every result its model's, requests/s, p50 / p99
               through HTTP, the swap's build and drain seconds, the
               launches by kind; then a durable gateway at 512 lanes
               killed with async requests in flight and resumed from its
               state_dir, every id its model's value, /healthz healthy;
  4. report  - phase times, kernel times (CUDA events), retired
               instructions and instructions per second, registers and
               spills of each build, the card's name and power limit, one
               JSON line of kernel records (with "mem_window", B4,
               "optimistic", B3, "tier0", "stdout_flush" (its device
               time on echo's records, the whole flush, the plain path's
               parts, torch.masked_select as its yardstick) and
               "tables"; the mix's, the
               straddling mix's and the serving run's launches beside
               K/B1, B2, B3 and B4; the summary line before it has the
               "linked" record and the main path's "mix" and "serve"),
               and last the device JSON line.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import shutil
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
# the main path's runs that are not its default path (the per-op kernel,
# B6) run at a smaller depth: fib(PER_OP_FIB_N), and a PER_OP_CUT-th of
# vloop's iterations and of mem_checksum's words
PER_OP_FIB_N = 27
PER_OP_CUT = 4
MEM_STACKS = dict(value_stack_depth=128, call_stack_depth=64,
                  memory_pages_per_lane=1)
SPEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "spec")
SIMD_WAST = os.path.join(SPEC_DIR, "simd.wast")
# the non-SIMD batchable corpus with the reference test's depths
# (tests/test_spec.py:77-82): passed, failed, skipped
CORPUS_COUNTS = (7155, 0, 345)
# the table and tail-call files of the corpus, (passed, failed, skipped)
# each: the JAX package's batched runner's counts (its rule skips
# table.wast and ref_types.wast: they mutate tables outside *_batch.wast)
TABLE_CORPUS_COUNTS = {"table_batch.wast": (52, 0, 0),
                       "tail_call_batch.wast": (20, 0, 0),
                       "tail_call.wast": (15, 0, 1), "table.wast": (0, 0, 62),
                       "ref_types.wast": (0, 0, 18)}
CORPUS_DEPTHS = dict(call_stack_depth=2048, value_stack_depth=8192)


def fail(msg: str) -> None:
    # on both streams: a caller that keeps only one of them sees why
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed ({out.returncode})"


def make_engine(data: bytes, lanes: int, device="cuda", imports=(),
                fusion=None, instance_cap=None, registered=(), **knobs):
    """A BatchEngine for `data`; `fusion` ("none", "blocks", "super")
    replaces the encoding the engine chose from `block_fusion` (the memory
    mode stays the one it chose from `mem_hbm`), generated with at most
    `instance_cap` B2 instance cases where it is given (the package's cap
    otherwise).  `imports`: host modules registered first; `registered`:
    (name, module bytes) registered (instantiated, start functions run)
    before `data` is instantiated."""
    from wasmedge_tpu_torch.batch import fusegen
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.common.configure import Configure, Proposal
    from wasmedge_tpu_torch.executor import Executor
    from wasmedge_tpu_torch.loader import Loader
    from wasmedge_tpu_torch.runtime.store import StoreManager
    from wasmedge_tpu_torch.validator import Validator

    conf = Configure()
    conf.add_proposal(Proposal.TailCall)  # the tables fixtures' tail calls
    for k, v in knobs.items():
        setattr(conf.batch, k, v)

    def parse(b):
        return Validator(conf).validate(Loader(conf).parse_module(b))

    store, ex = StoreManager(), Executor(conf)
    for imp in imports:
        ex.register_import_object(store, imp)
    for name, b in registered:
        ex.register_module(store, parse(b), name)
    inst = ex.instantiate(store, parse(data))
    eng = BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                      device=device)
    if fusion is not None:
        cap = fusegen.MAX_INSTANCE_CASES
        if instance_cap is not None:
            fusegen.MAX_INSTANCE_CASES = instance_cap
        try:
            eng.set_encoding(fusion)
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
    entered, commits, uniform) of two WarpStates (0 when both are
    None)."""
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
                         stack_depth=eng.cfg.value_stack_depth,
                         t0kinds=eng.t0kinds, t0=tb.t0, cost=eng.cost)


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
# B4: per fixture and mode with the windows, the kernel side's window
# counts over its launches (hits, misses, ways written back, the rows they
# stored, rows filled; misses and ways written back equal to the plain
# version's after every launch)
WINDOW_FIXTURES = {}
# B3: per fixture and mode, the kernel side's uniform entries against its
# entries
UNIFORM_FIXTURES = {}


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


def probe_prep(eng, st, case: str) -> None:
    """The uniform probe's state for entry-rule case `case` (in place on
    the card): one careful launch of 40 steps from `st` (plain version),
    then lane 5's planes changed as tests/test_torch_uniform_warps.py
    changes them."""
    from wasmedge_tpu_torch.batch import interp_ref
    from wasmedge_tpu_torch.batch.interp import device_tables

    cpu = on_cpu(st)
    interp_ref.run_chunk(device_tables(eng.img, "cpu", "none"), cpu, 40,
                         False)
    D, CD = cpu.stack_lo.shape[0], cpu.fr_ret_pc.shape[0]
    sp, cd = int(cpu.sp[5]), int(cpu.call_depth[5])
    bumps = {"equal": (), "at_or_above_sp": (("stack_lo", sp),
                                             ("stack_hi", D - 1)),
             "at_or_above_depth": (("fr_ret_pc", cd), ("fr_fp", CD - 1)),
             "beyond_pages": (("mem", 16384), ("mem", cpu.mem.shape[0] - 1)),
             "stack_row_below_sp": (("stack_lo", sp - 1),),
             "frame_row": (("fr_opbase", 0),), "global": (("glob_lo", 0),),
             "last_live_word": (("mem", 16383),)}[case]
    for f, row in bumps:
        getattr(cpu, f)[row, 5] += 1
    for f, t in cpu.planes().items():
        st.planes()[f].copy_(t)


def kernel_vs_plain(name, data, func, args, chunk, fuel, knobs,
                    fusion="none", rollbacks=None, lanes=KERNEL_LANES,
                    bulk=None, prep=None, uniform=None,
                    plain_on_card=False) -> int:
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
    whole).  With the windows, the kernel's misses and ways written back
    equal the plain version's after every launch (B4's counts).  `prep`:
    an entry-rule case of the uniform probe (probe_prep) applied to the
    initial state; `uniform` "all": every entry of the kernel's warps
    uniform (B3's entry rule), "none": none, "some": fewer than its
    entries.  `data` a list of (module bytes, export, args, lanes): the
    concatenated image of those tenants (mix_engine; `func`, `args` and
    `lanes` unused).  `plain_on_card`: the plain side runs on a copy on
    the card instead.  Returns the max abs err."""
    from wasmedge_tpu_torch.batch import interp, interp_ref, memwin

    def engine(mem_hbm, **kw):
        """(engine, its initial state's maker)."""
        if isinstance(data, list):
            eng = mix_engine(data, fusion=fusion, mem_hbm=mem_hbm,
                             fuel_per_launch=fuel, **knobs, **kw)
            return eng, eng.initial_state
        eng, inst = make_engine(data, lanes, fuel_per_launch=fuel,
                                fusion=fusion, mem_hbm=mem_hbm, **knobs,
                                **kw)
        return eng, lambda: eng.initial_state(inst.exports[func][1], args)

    worst = 0
    for mem_hbm, (eng, initial) in memory_modes(engine):
        t0 = time.perf_counter()
        tag = mode_tag(fusion, mem_hbm)
        st = initial()
        if prep is not None:
            probe_prep(eng, st, prep)
        ref, tp = (st.clone(), eng.tables) if plain_on_card else \
            (on_cpu(st), cpu_tables(eng))
        wk, wp = new_warps(eng), (new_warps(eng) if plain_on_card
                                  else cpu_warps(eng))
        careful = None
        if eng.tables.optimistic:
            ceng = engine(mem_hbm, optimistic=False)[0]
            careful = st.clone()
        launches = 0
        before = dict(interp.LAUNCHES)
        torch.cuda.synchronize()
        interp.clear_counts()
        memwin.clear_counts()
        wsum = dict.fromkeys(interp.WINDOW_COUNTS, 0)
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
            if eng.tables.mem_window:
                wc = interp.window_counts(eng.tables, clear=True)
                if (wc["misses"], wc["ways_written_back"]) != (
                        memwin.COUNTS["misses"],
                        memwin.COUNTS["ways_written_back"]):
                    fail(f"window counts of {name}{tag} after launch "
                         f"{launches}: kernel {wc}, plain {memwin.COUNTS}")
                wsum = {k: wsum[k] + wc[k] for k in wsum}
            memwin.clear_counts()
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
        # the builds with the table handlers and weighted gas, every launch
        if ran["tables"] != (kernels if eng.tables.a3 else 0) or \
                ran["gas"] != (kernels if eng.tables.gcum is not None and
                               fuel is not None else 0):
            fail(f"{name}{tag}: {ran['tables']} table and {ran['gas']} gas "
                 f"launches of {ran['interp']}")
        stats = wk.stats() if wk is not None else {}
        ops = interp.bulk_counts(eng.tables) if eng.tables.has_bulk else {}
        if bulk == "warp":
            BULK_FIXTURES[f"{name}{tag}"] = ops
            if not ops["warp_passes"]:
                fail(f"{name}{tag}: no bulk op took the warp pass ({ops})")
        if eng.tables.mem_window:
            WINDOW_FIXTURES[f"{name}{tag}"] = wsum
        if careful is not None:
            OPT_FIXTURES[f"{name}{tag}"] = stats
            if rollbacks is not None and \
                    (stats["rollbacks"] > 0) != rollbacks:
                fail(f"{name}{tag}: {stats['rollbacks']} rollbacks, "
                     f"expected {'some' if rollbacks else 'none'}")
            uni = int(wk.uniform.sum())
            UNIFORM_FIXTURES[f"{name}{tag}"] = dict(
                uniform=uni, entered=stats["entered"])
            if uniform is not None and not {
                    "all": uni == stats["entered"], "none": uni == 0,
                    "some": uni < stats["entered"]}[uniform]:
                fail(f"{name}{tag}: {uni} uniform entries of "
                     f"{stats['entered']}, expected {uniform}")
        traps = sorted(set(st.trap.cpu().tolist()))
        print(f"kernel_vs_plain {name}{tag}: {launches} launches equal"
              f"{', equal to careful below sp' if careful is not None else ''}"
              f", traps {traps}, retired {int(st.retired.sum())}, warps "
              f"{stats}"
              f"{f', uniform {int(wk.uniform.sum())}' if wk is not None else ''}"
              f"{f', bulk ops {ops}' if ops else ''}"
              f"{f', windows {wsum}' if eng.tables.mem_window else ''}, "
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
         [np.arange(L) % 10 + 1], 13, 501),
        ("oob_mix", build_oob_mix(), "oob", oob_args(L, SEED), 13, None),
        ("mem_checksum", build_memory_workload(), "mem_checksum",
         [np.arange(L) % 30 + 1], 256, None),
        ("window_walk", build_window_walk(), "edgewalk",
         [np.arange(L) % 60 + 3], 64, None),
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
         [np.arange(L) % 10 + 1], 13, 501, kn, False),
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
         [np.arange(L) % 60 + 3], 64, None, kn, False),
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


# the uniform probe's and the window-row fixtures' stacks and memory
PROBE_KNOBS = dict(value_stack_depth=64, call_stack_depth=32,
                   memory_pages_per_lane=3)
PROBE_CASES = (("equal", "all"), ("at_or_above_sp", "all"),
               ("at_or_above_depth", "all"), ("beyond_pages", "all"),
               ("stack_row_below_sp", "some"), ("frame_row", "some"),
               ("global", "some"), ("last_live_word", "some"))


def win_rows_args(L: int, func: str) -> list:
    """Lane inputs of build_win_rows' exports (as in
    tests/test_torch_win_rows.py, lane % 32 for the addresses)."""
    a = np.arange(L) % 32
    x = np.random.default_rng(SEED).integers(-2**31, 2**31, L)
    return {"sweep": [np.zeros(L), np.full(L, 160)],
            "partial": [a * 4 + 1 + 2 * (a % 2), x],
            "store_load": [a * 8, x],
            "commit_rows": [np.full(L, 96), np.full(L, 12345),
                            np.full(L, 200)]}[func]


# build_win_rows' exports: (steps per launch, per lane in one careful
# launch to the end through the windows: misses, ways written back, rows
# they stored, rows filled; the same in one optimistic launch of a uniform
# warp, None where the lanes differ)
WIN_ROWS = {"sweep": (300, (2, 2, 160, 0), (2, 3, 160, 0)),
            "partial": (9, (1, 1, 7, 125), None),
            "store_load": (5, (1, 1, 4, 124), None),
            "commit_rows": (500, (1, 1, 2, 126), (1, 2, 3, 126))}


def uniform_jobs() -> list:
    """B3's entry rule and B4's row bits against their plain versions
    (kernel_vs_plain jobs: both memory modes, every plane and row, the
    per-warp state and the window counts after every launch), per-op and
    in B2 blocks (whose generated cases run the row bits through
    fused_load / fused_store): the uniform probe at KERNEL_LANES lanes in
    each entry-rule case (probe_prep; the warps where lane 5 differs below
    sp, the depth or the pages are not uniform at entry, the others are)
    and at 40 lanes (a partial warp); build_win_rows' four exports,
    optimistic (the default) and careful (optimistic False), and their
    row counts by hand (win_rows_hand, per-op)."""
    from wasmedge_tpu_torch.models.fixtures import (
        build_uniform_probe, build_win_rows)

    probe, rows = build_uniform_probe(), build_win_rows()
    L = KERNEL_LANES
    jobs = []
    for fusion in ("none", "blocks"):
        jobs += [("kernel_vs_plain", (
            f"uniform_{case}", probe, "rec", [np.full(L, 12), np.full(L, 5)],
            40, None, PROBE_KNOBS, fusion), dict(prep=case, uniform=want))
            for case, want in PROBE_CASES]
        jobs.append(("kernel_vs_plain", (
            "uniform_partial_warp_x40", probe, "rec",
            [np.full(40, 12), np.full(40, 5)], 40, None, PROBE_KNOBS,
            fusion), dict(lanes=40, uniform="some")))
        for func, (chunk, _, _) in WIN_ROWS.items():
            for opt in (None, False):
                jobs.append(("kernel_vs_plain", (
                    f"win_rows_{func}{'' if opt is None else '_careful'}",
                    rows, func, win_rows_args(L, func), chunk, None,
                    PROBE_KNOBS if opt is None else
                    dict(PROBE_KNOBS, optimistic=False), fusion), {}))
    jobs.append(("win_rows_hand", (), {}))
    return jobs


def win_rows_hand() -> int:
    """build_win_rows' exports, one per-op launch to the end through the
    windows at KERNEL_LANES lanes, careful and (where every lane holds one
    state) optimistic: the kernel's misses, ways written back, rows stored
    and rows filled as WIN_ROWS gives them per lane, its planes equal to
    the plain version's."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.models.fixtures import build_win_rows

    L = KERNEL_LANES
    for func, (_, careful, uniform) in WIN_ROWS.items():
        for opt, want in ((False, careful), (None, uniform)):
            if want is None:
                continue
            eng, inst = make_engine(build_win_rows(), L, fusion="none",
                                    mem_hbm=True, optimistic=opt,
                                    **PROBE_KNOBS)
            st = eng.initial_state(inst.exports[func][1],
                                   win_rows_args(L, func))
            ref = on_cpu(st)
            wk, wp = new_warps(eng), cpu_warps(eng)
            interp.clear_counts()
            interp.run_chunk(eng.tables, st, 100_000, False, wk)
            interp_ref.run_chunk(cpu_tables(eng), ref, 100_000, False, wp)
            torch.cuda.synchronize()
            err = max(max_abs_err(st, ref), warp_err(wk, wp))
            wc = interp.window_counts(eng.tables)
            got = tuple(wc[k] for k in interp.WINDOW_COUNTS[1:])
            if err or got != tuple(L * w for w in want) or \
                    not (st.trap == -1).all():
                fail(f"win_rows {func} (optimistic {opt is None}): max abs "
                     f"err {err}, counts {wc}, expected {want} per lane")
            if wk is not None and int(wk.uniform.sum()) != \
                    int(wk.entered.sum()):
                fail(f"win_rows {func}: warps not uniform ({wk.stats()})")
            WINDOW_FIXTURES[f"win_rows_hand_{func}"
                            f"{'' if opt is None else '_careful'}"] = wc
            print(f"win_rows_hand {func} (optimistic {opt is None}): "
                  f"{wc}, {want} per lane as expected", flush=True)
    return 0


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
WORKERS = 8


def run_job(job):
    """One kernel phase job in a worker process: (group, worst, the
    worker's records, None), or (group, None, None, what failed)."""
    group, name, args, kwargs = job
    torch.set_num_threads(1)
    WINDOW_WORST[0] = 0
    OPT_WORST.update(plain=0, careful=0)
    OPT_FIXTURES.clear()
    BULK_FIXTURES.clear()
    WINDOW_FIXTURES.clear()
    UNIFORM_FIXTURES.clear()
    TIER0_FIXTURES.clear()
    MIX_RECORDS.clear()
    install_flush_check()
    FLUSH.update(checked=0, bytes=0)
    try:
        worst = globals()[name](*args, **kwargs)
        check_flushes(f"{name} {args[0] if args else ''}")
    except SystemExit:
        return group, None, None, f"{name} {args[0] if args else ''}" \
            f"{kwargs.get('only') or ''}"
    return group, worst, dict(window=WINDOW_WORST[0], opt=dict(OPT_WORST),
                              flushes=FLUSH["checked"],
                              flush_bytes=FLUSH["bytes"],
                              opt_fixtures=dict(OPT_FIXTURES),
                              bulk=dict(BULK_FIXTURES),
                              windows=dict(WINDOW_FIXTURES),
                              uniform=dict(UNIFORM_FIXTURES),
                              tier0=dict(TIER0_FIXTURES),
                              mix=dict(MIX_RECORDS)), None


def timed_launch_phases():
    """The one-launch timings (each kernel and its plain version on one
    launch of TIMED_STEPS steps), and this process's window and
    optimistic worst errors."""
    out = ({f: phase_time_one_launch(f) for f in ("none", "blocks", "super")},
           phase_time_bulk(), phase_time_simd_launch("blocks"),
           phase_time_simd_launch("none"), phase_time_mem_launch(),
           phase_time_tier0(), phase_time_tables())
    return out, WINDOW_WORST[0], dict(OPT_WORST)


def timed_launches() -> tuple:
    """`timed_launch_phases` in a spawned process of its own, so that
    what the main phase left in this process (its profiler sessions,
    engines and caches) does not time with them: run here after the main
    phase, the plain versions took about twice as long and the short
    launches up to 65 % longer.  Its worst errors are merged into this
    process's."""
    import concurrent.futures
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as ex:
        out, window, opt = ex.submit(timed_launch_phases).result()
    WINDOW_WORST[0] = max(WINDOW_WORST[0], window)
    for k in OPT_WORST:
        OPT_WORST[k] = max(OPT_WORST[k], opt[k])
    return out


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
            WINDOW_FIXTURES.update(rec["windows"])
            UNIFORM_FIXTURES.update(rec["uniform"])
            TIER0_FIXTURES.update(rec["tier0"])
            MIX_RECORDS.update(rec["mix"])
            FLUSH["checked"] += rec["flushes"]
            FLUSH["bytes"] += rec["flush_bytes"]
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
    """A WASI host module whose stdout and stderr are the file descriptor
    `fd`."""
    from wasmedge_tpu_torch.host.wasi import WasiModule

    wasi = WasiModule()
    wasi.init_wasi(args=list(WASI_ARGS))
    wasi.env.fds[1].os_fd = wasi.env.fds[2].os_fd = fd
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
    # every call parks and is served between launches (tier 0 off;
    # phase_tier0_kernel_vs_plain runs it on)
    knobs = dict(value_stack_depth=64, call_stack_depth=16,
                 memory_pages_per_lane=3, tier0_hostcalls=False)
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
                          knobs, imports, chunk=64, check=None) -> int:
    """One host-call fixture of phase_hostcalls_kernel_vs_plain (or of
    phase_tier0_kernel_vs_plain) in one encoding and memory mode: with
    tier 0 both sides get the same time base at every launch, and each
    side's stdout buffer is flushed after every launch and serve round;
    `check(state, warps, engine)` returns what is wrong at the end, or
    None."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.batch.engine import t0_time_planes
    from wasmedge_tpu_torch.batch.hostcall import (
        _stdout_cursor, flush_stdout_buffers, serve_batch_state)
    from wasmedge_tpu_torch.common.errors import ErrCode

    L = len(np.asarray(args[0]))
    hello_codes = np.arange(L) % 3
    flushes = 0  # flushes of the card's side held against the plain one
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
            tier0 = st.t0_ctr is not None
            while True:
                tt = t0_time_planes() if tier0 else None
                interp.run_chunk(engs[0].tables, st, chunk, False, wk, tt)
                interp_ref.run_chunk(engs[1].tables, ref, chunk, False, wp,
                                     tt)
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
                if flush_stdout_buffers(engs[0], st) != \
                        flush_stdout_buffers(engs[1], ref):
                    fail(f"{name}: the two flushes wrote different bytes")
                if tier0 and any(not np.array_equal(a, b) for a, b in zip(
                        _stdout_cursor(engs[0], L),
                        _stdout_cursor(engs[1], L))):
                    fail(f"{name}: the stdout cursors differ after the "
                         f"flush of launch {launches}")
                flushes += tier0 and check_flushes(name) > 0
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
    if name.endswith("wasi_hello"):
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
    tag = mode_tag(fusion, mem_hbm) + ("" if wk is not None or not tier0
                                       else " careful")
    if wk is not None:
        OPT_FIXTURES[f"{name}{tag}"] = stats
        UNIFORM_FIXTURES[f"{name}{tag}"] = dict(
            uniform=int(wk.uniform.sum()), entered=stats["entered"])
    if check is not None:
        bad = check(st, wk, engs[0])
        if bad:
            fail(f"{name}{tag}: {bad}")
    calls = st.t0_ctr.sum(1).tolist() if tier0 else None
    if tier0:
        TIER0_FIXTURES[f"{name}{tag}"] = dict(
            t0_ctr=calls, serve_rounds=rounds,
            stdout_bytes=engs[0].hostcall_stats["stdout_bytes"],
            kernel_flushes_checked=int(flushes))
    print(f"kernel_vs_plain {name}{tag}: "
          f"{launches} launches and {rounds} serve rounds equal, traps "
          f"{sorted(set(trap.tolist()))}, stdout {len(outs[0])} B "
          f"identical, warps {stats}"
          f"{f', uniform {int(wk.uniform.sum())}' if wk is not None else ''}"
          f"{f', tier-0 calls {calls}' if tier0 else ''}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return worst


def tier0_fixtures(L: int) -> list:
    """The tier-0 fixtures at L lanes: (name, module, export, args,
    expected stdout or None, steps per launch, knobs, check): the cases of
    models.fixtures.tier0_cases, the full stdout buffer (16 words), a
    whole warp's random_get (every warp must enter uniform, none roll
    back, and the lanes' bytes differ), fd_write made unsafe by fd_close,
    and WASI echo and hello."""
    from wasmedge_tpu_torch.common.errors import ErrCode
    from wasmedge_tpu_torch.models import build_echo, build_wasi_hello
    from wasmedge_tpu_torch.models.fixtures import (
        build_tier0_unsafe, build_tier0_zoo, tier0_cases)
    from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE

    zoo = build_tier0_zoo()

    def uniform(st, wk, eng):
        res = np.unique(st.stack_lo[0].cpu().numpy())
        if res.size < L // 2:
            return f"{res.size} distinct results of {L} lanes"
        if wk is not None and (int(wk.uniform.sum()) < (L // 32) or
                               int(wk.rollbacks.sum()) != 0):
            return f"warps {wk.stats()}, uniform {int(wk.uniform.sum())}"
        if int(st.t0_ctr[1].sum()) != L:
            return f"{int(st.t0_ctr[1].sum())} random_get calls served"
        return None

    def parks(row, want):
        def check(st, wk, eng):
            got = int(st.t0_ctr[row].sum())
            if want(got, eng.hostcall_stats):
                return None
            return (f"tier-0 count {row} is {got}, serve stats "
                    f"{eng.hostcall_stats}")
        return check

    def exits(st, wk, eng):
        x = np.arange(L) + 1
        want = np.where(x % 3 == 0, int(ErrCode.Terminated), -1)
        if not (st.trap.cpu().numpy() == want).all():
            return "lanes did not stop where x % 3 == 0"
        return None

    cases = tier0_cases(L, SEED)
    writes = int(cases["digit"][1][1].sum())
    checks = {"exit": exits,
              "digit": parks(2, lambda n, s: n == writes
                             and s["serve_rounds"] == 0)}
    out = [(f"tier0.{case}", zoo, func, args, None, 64, {}, checks.get(case))
           for case, (func, args) in cases.items() if case != "uniform"]
    hello_codes = np.arange(L) % 3
    out += [
        ("tier0.digit_full", zoo, "digit",
         [np.arange(L), np.full(L, 8), np.ones(L, np.int64)], None, 256,
         dict(stdout_buffer_words=16),
         parks(2, lambda n, s: s["serve_rounds"] > 0 and n > 0)),
        ("tier0.uniform", zoo, "uniform", [np.full(L, 700)], None, 64, {},
         uniform),
        ("tier0.unsafe", build_tier0_unsafe(), "f", [np.arange(L)], None,
         64, {}, parks(0, lambda n, s: n == L and s["tier1_calls"] == L)),
        ("tier0.wasi_echo", build_echo(), "echo", [np.full(L, 2)],
         ECHO_MESSAGE * (4 * L), 64, {},
         parks(2, lambda n, s: n == 4 * L and s["serve_rounds"] == 0)),
        ("tier0.wasi_hello", build_wasi_hello(), "hello", [hello_codes],
         hello_output(hello_codes), 64, {},
         parks(3, lambda n, s: n == L and s["tier1_calls"] == 3 * L)),
    ]
    return out


# tier-0 counts per fixture and mode of the kernel side (t0_ctr summed by
# row, serve rounds, stdout bytes)
TIER0_FIXTURES = {}
# the encodings each tier-0 fixture runs in (per-op, blocks, super)
TIER0_ENCODINGS = {"tier0.wasi_hello": ("none", "blocks"),
                   "tier0.unsafe": ("none",)}

# The stdout flush kernel held against its plain version: every flush on
# the card's tensors (hostcall.stdout_records) is recorded with a copy of
# its inputs and checked by `check_flushes`; "checked" flushes and
# "bytes" compared, "overhead_s" the host seconds the recording added to
# the flushes it watched, "pending" the flushes not checked yet.
FLUSH = {"checked": 0, "bytes": 0, "overhead_s": 0.0, "pending": []}


def install_flush_check() -> None:
    """Record every flush of CUDA tensors through the flush kernel: its
    inputs (a copy on the card) and its bytes and lens."""
    from wasmedge_tpu_torch.batch import hostcall

    real = hostcall.stdout_records
    if getattr(real, "checked", False):
        return

    def checked(so_buf, so_off, skip):
        out = real(so_buf, so_off, skip)
        if so_buf.device.type == "cuda":
            t0 = time.perf_counter()
            FLUSH["pending"].append((
                so_buf.clone(), so_off.clone(), np.array(skip, np.int64),
                None if out is None else (
                    {fd: bytes(b) for fd, b in out[0].items() if len(b)},
                    out[1].copy())))
            FLUSH["overhead_s"] += time.perf_counter() - t0
        return out

    checked.checked = True
    hostcall.stdout_records = checked


def check_flushes(what: str) -> int:
    """Hold each recorded flush against `_records` on a CPU copy of its
    inputs: the bytes on each fd and each lane's payload count (the
    cursor's advance) equal.  Returns the flushes checked."""
    from wasmedge_tpu_torch.batch.hostcall import _records

    n = 0
    for so_buf, so_off, skip, got in FLUSH["pending"]:
        off = so_off.cpu().numpy()
        rows = int(off.max(initial=0))
        if rows == 0:
            if got is not None:
                fail(f"{what}: the flush kernel found records in an empty "
                     f"buffer")
        else:
            want, lens = _records(so_buf[:rows].cpu().numpy(), off, skip)
            want = {fd: b for fd, b in want.items() if b}
            if got is None or got[0] != want or \
                    not np.array_equal(got[1], lens):
                fail(f"{what}: the flush kernel's bytes or lens differ from "
                     f"the plain version's (kernel "
                     f"{None if got is None else {k: len(v) for k, v in got[0].items()}}"
                     f", plain {({k: len(v) for k, v in want.items()})})")
            FLUSH["bytes"] += sum(len(b) for b in want.values())
        n += 1
    FLUSH["checked"] += n
    FLUSH["pending"].clear()
    return n


def flush_plain_split(eng, st, skip) -> dict:
    """The plain flush path on the card's planes, as flush_stdout_buffers
    ran before the flush kernel, seconds per part: the so_off download,
    the download of the so_buf rows below the largest fill, `_records`,
    the fd writes."""
    from wasmedge_tpu_torch.batch.hostcall import _records, wasi_env_of
    from wasmedge_tpu_torch.host.wasi.vectorized import _write_all

    env = wasi_env_of(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off = st.so_off.cpu().numpy()
    t1 = time.perf_counter()
    buf = st.so_buf[:int(off.max())].cpu().numpy()
    t2 = time.perf_counter()
    per_fd, _ = _records(buf, off, skip)
    t3 = time.perf_counter()
    for fd in sorted(per_fd):
        _write_all(env.fds[fd], per_fd[fd])
    t4 = time.perf_counter()
    return dict(so_off_download=t1 - t0, so_buf_download=t2 - t1,
                records=t3 - t2, writes=t4 - t3, whole=t4 - t0,
                rows=int(off.max()),
                bytes=sum(len(v) for v in per_fd.values()))


def flush_kernel_split(eng, st, skip) -> dict:
    """The kernel flush path's parts, seconds each: the launch (host),
    the counts' read-back (the wait for the kernel in it), the copy of
    the bytes into pinned memory, the fd writes; and CUDA events around
    the launch (on an idle card these take in the host's enqueue)."""
    from wasmedge_tpu_torch.batch import stdout_flush
    from wasmedge_tpu_torch.batch.hostcall import wasi_env_of
    from wasmedge_tpu_torch.host.wasi.vectorized import _write_all

    env = wasi_env_of(eng)
    sk = torch.from_numpy(np.asarray(skip, np.int32)).cuda()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    meta, out = stdout_flush.launch(st.so_buf, st.so_off, sk)
    e1.record()
    t1 = time.perf_counter()
    m = meta.cpu().numpy()
    t2 = time.perf_counter()
    n = int(m[0]) + int(m[1])
    host = stdout_flush._host_buffer(n)
    host[:n].copy_(out[:n])
    t3 = time.perf_counter()
    view = memoryview(host.numpy())
    for fd, a, b in ((1, 0, int(m[0])), (2, int(m[0]), n)):
        if b > a:
            _write_all(env.fds[fd], view[a:b])
    t4 = time.perf_counter()
    return dict(events_ms=e0.elapsed_time(e1), launch=t1 - t0,
                counts_readback=t2 - t1, bytes_copy=t3 - t2, writes=t4 - t3,
                parts_whole=t4 - t0, bytes=n)


def flush_device_ms(st, skip, reps: int = 21) -> float:
    """The flush kernel's device time (median ms of `reps`): CUDA events
    around one launch queued behind a spin of the card
    (`torch.cuda._sleep`, about 1 ms), so that they time its kernels and
    not the host's enqueue, which events around an idle card's launch
    take in (`flush_kernel_split`'s "events_ms")."""
    from wasmedge_tpu_torch.batch import stdout_flush

    sk = torch.from_numpy(np.asarray(skip, np.int32)).cuda()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1 << 21)
        e0.record()
        stdout_flush.launch(st.so_buf, st.so_off, sk)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def flush_library_ms(st, reps: int = 21) -> dict:
    """The library yardstick of the flush: torch.masked_select over a
    uint8 view of the transposed planes with a mask of the payload bytes
    (the stream of a batch whose lanes hold one layout), ms, and the
    transpose before it; its stream must be the records' (one fd)."""
    from wasmedge_tpu_torch.batch.hostcall import _records

    off = st.so_off.cpu().numpy()
    rows = int(off.max())
    if not (off == rows).all():
        fail("the flush's library yardstick needs one layout in every lane")
    col = st.so_buf[:rows, 0].cpu().numpy()
    keep = np.zeros(rows * 4, bool)
    r = 0
    while r < rows:
        ln = int(np.uint32(col[r])) & 0x0FFFFFFF
        keep[4 * (r + 1):4 * (r + 1) + ln] = True
        r += 1 + (ln + 3) // 4
    L = st.so_buf.shape[1]
    mask = torch.from_numpy(np.broadcast_to(keep, (L, rows * 4)).copy()) \
        .cuda()

    def transpose():
        return st.so_buf[:rows].t().contiguous().view(torch.uint8)

    planes = transpose()
    out = {}
    for name, fn in (("masked_select", lambda: torch.masked_select(planes,
                                                                   mask)),
                     ("transpose", transpose)):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        out[name] = float(np.median(times))
        if name == "masked_select":
            want = _records(st.so_buf[:rows].cpu().numpy(), off)[0]
            if len(want) != 1 or \
                    res.cpu().numpy().tobytes() != next(iter(want.values())):
                fail("masked_select's stream differs from the records'")
            out["stream_bytes"] = int(res.numel())
    return out


def flush_bound(st, nbytes: int) -> tuple:
    """(bound ms, bytes) of one flush of `st`'s records: the rows below
    each lane's fill, the fills and skips read, the stream and each
    lane's count written, at the HBM rate."""
    L = st.so_off.shape[0]
    nb = int(st.so_off.sum()) * 4 + 2 * 4 * L + nbytes + 4 * L
    return nb / HBM_BYTES_PER_S * 1e3, nb


def tier0_jobs(fusion="none") -> list:
    """phase_tier0_kernel_vs_plain in the encoding `fusion`, one job per
    fixture that runs in it."""
    return [("phase_tier0_kernel_vs_plain", (fusion,), dict(only=(name,)))
            for name, *_ in tier0_fixtures(2)
            if fusion in TIER0_ENCODINGS.get(name, ("none", "blocks",
                                                    "super"))]


def phase_tier0_kernel_vs_plain(fusion="none", only=None) -> int:
    """The tier-0 fixtures (those named in `only`, or all) at KERNEL_LANES
    lanes in the encoding `fusion`, optimistic and careful, through the
    window cache and with direct access: kernel and plain version from
    the same CUDA state with the same time base at every launch, each
    with its own engine, WASI module, serve round and stdout flush after
    every launch; every plane (t0_ctr, so_buf and so_off included) and
    the per-warp counts equal, and the two stdout files byte-identical."""
    L = KERNEL_LANES
    worst = 0
    # the calls that park read the host (the cputime clocks, random_get
    # above tier0_random_max): one fixed reading and byte stream for both
    # sides' serve rounds
    saved = (time.process_time_ns, time.thread_time_ns, os.urandom)
    time.process_time_ns = lambda: 0x1234_5678_9ABC
    time.thread_time_ns = lambda: 0x0FED_CBA9_8765
    os.urandom = lambda n: bytes((37 * i + 11) & 0xFF for i in range(n))
    try:
        for name, data, func, args, want_out, chunk, kn, check in \
                tier0_fixtures(L):
            if only is not None and name not in only:
                continue
            knobs = dict(value_stack_depth=64, call_stack_depth=16,
                         memory_pages_per_lane=1, rng_seed=SEED, **kn)
            for opt in (None, False):
                knobs["optimistic"] = opt
                imports = (lambda fd: [wasi_import(fd)])
                for mem_hbm, _ in memory_modes(lambda m: make_engine(
                        data, 2, device="cpu", imports=imports(1),
                        fusion=fusion, mem_hbm=m, **knobs)):
                    worst = max(worst, host_fixture_vs_plain(
                        name, data, func, args, want_out, fusion, mem_hbm,
                        knobs, imports, chunk=chunk, check=check))
    finally:
        time.process_time_ns, time.thread_time_ns, os.urandom = saved
    return worst


# Tables, segments, tail calls and weighted gas: the tail-dispatch jobs'
# steps (12: a few launches of 64 steps) and fuel budget (runs out inside
# a handler's block with tail_cost_table's weights)
# the main path's divergent tail dispatch (ten times slower a step than
# the converged one) runs a quarter of TAIL_DISPATCH_N steps, to keep the
# script's time
TAIL_DIVERGENT_CUT = 8
TAIL_SMALL_N = 12
TAIL_FUEL = 412


def table_fixtures(L: int) -> list:
    """The table, segment, tail-call and weighted-gas fixtures at L lanes:
    (name, module, export, args, steps per launch, fuel, knobs,
    rollbacks, uniform, encodings).  Every case of
    models.fixtures.table_cases on the table zoo (per-op and blocks: its
    super encoding was cut to keep the script's time, PERF.md;
    `agree` must roll back: lanes that call one index of tables that
    differ), every case of table_terminal_cases (blocks: B2 instance
    cases that run call_indirect, return_call(_indirect) and div / rem
    terminals chained to a call, with every trap of each, a literal-zero
    rem_u and div_s of INT_MIN by -1), and the tail-dispatch workload at
    TAIL_SMALL_N steps in both modes (per-op and blocks; "converged"
    every warp uniform and no rollback, "divergent" none uniform), and
    with weighted gas and a budget that runs out (blocks)."""
    from wasmedge_tpu_torch.models.fixtures import (
        TABLE_ZOO_CAP, build_table_zoo, build_tail_dispatch, table_cases,
        table_terminal_cases, tail_cost_table, tail_dispatch_args)

    zoo = build_table_zoo()
    knobs = dict(value_stack_depth=64, call_stack_depth=16,
                 memory_pages_per_lane=1)
    out = [(f"tables.{case}", zoo, func, args, 64, None,
            dict(knobs, table_elems_per_lane=TABLE_ZOO_CAP),
            True if case == "agree" else None, None, ("none", "blocks"))
           for case, (func, args) in table_cases(L, SEED).items()]
    out += [(f"tables.term_{case}", zoo, func, args, 64, None,
             dict(knobs, table_elems_per_lane=TABLE_ZOO_CAP), None, None,
             ("blocks",))
            for case, (func, args) in table_terminal_cases(L, SEED).items()]
    tail = build_tail_dispatch()
    for mode in ("converged", "divergent"):
        args = tail_dispatch_args(L, mode, TAIL_SMALL_N)
        uni = "all" if mode == "converged" else "none"
        out.append((f"tables.tail_{mode}", tail, "run", args, 64, None, knobs,
                    False if mode == "converged" else None, uni,
                    ("none", "blocks")))
        out.append((f"tables.tail_gas_{mode}", tail, "run", args, 64,
                    TAIL_FUEL, dict(knobs, cost_table=tail_cost_table()),
                    False if mode == "converged" else None, uni,
                    ("blocks",)))
    return out


def table_builds() -> list:
    """The tables (CPU) of the table, segment, tail-call and weighted-gas
    builds the kernel phase's table jobs run: the zoo's and the
    tail-dispatch jobs' (each encoding, B3 mode and memory mode)."""
    out = []
    for name, data, _, _, _, fuel, kn, _, _, fusions in table_fixtures(2):
        for fusion in fusions:
            for opt in (None, False):
                for _, (eng, _) in memory_modes(lambda m: make_engine(
                        data, 2, device="cpu", fusion=fusion, mem_hbm=m,
                        optimistic=opt, fuel_per_launch=fuel, **kn)):
                    out.append(eng.tables)
    return out


def tail_builds() -> list:
    """The tables (CPU) of the main path's tail dispatch: blocks, the
    default depths, optimistic and careful, and with weighted gas."""
    from wasmedge_tpu_torch.models.fixtures import tail_cost_table

    return [e.tables for e in tail_engines(2, device="cpu")] + [
        tail_engines(2, device="cpu", fuel_per_launch=1,
                     cost_table=tail_cost_table())[0].tables]


def table_jobs() -> list:
    """kernel_vs_plain jobs of the table fixtures, one per fixture and
    encoding: every plane (tab, tsize, edrop, ddrop included), the window
    counts and the per-warp counts after every launch, both memory modes,
    optimistic with the careful kernel beside it."""
    return [("kernel_vs_plain", (name, data, func, args, chunk, fuel, knobs),
             dict(fusion=enc, rollbacks=rb, uniform=uni))
            for name, data, func, args, chunk, fuel, knobs, rb, uni, encs
            in table_fixtures(KERNEL_LANES) for enc in encs]


# the linked program's kernel-against-plain size: n = 20 + (lane % 8) 8,
# at most 2,668 instructions a lane, and its steps per launch (two
# launches), and the fuel of its gas job (runs out inside the loop on
# the lanes past about n = 40)
LINKED_SMALL = (20, 8)
LINKED_CHUNK = 1500
LINKED_FUEL = 1420
# the lanes VM.execute runs on the host, beside the card's run at small n
LINKED_SAMPLE = 8


def linked_knobs() -> dict:
    """The linked program's engine knobs: the default depths (the main
    path's), the provider registered before the consumer."""
    from wasmedge_tpu_torch.models.fixtures import build_linked_program

    return dict(registered=(("prov", build_linked_program()[0]),))


def linked_builds() -> list:
    """The tables (CPU) of the linked program's builds: B2 blocks at the
    default depths, optimistic and careful, windows and direct (the main
    path's; the kernel jobs and the gas run use the same: flat fuel needs
    no gas build)."""
    from wasmedge_tpu_torch.models.fixtures import build_linked_program

    cons = build_linked_program()[1]
    return [eng.tables for opt in (None, False)
            for _, (eng, _) in memory_modes(lambda m: make_engine(
                cons, 2, device="cpu", fusion="blocks", mem_hbm=m,
                optimistic=opt, **linked_knobs()))]


def linked_jobs() -> list:
    """kernel_vs_plain jobs of the linked program at KERNEL_LANES lanes
    and small n, in blocks, both memory modes, optimistic with the careful
    kernel beside it: lanes of every warp call different functions through
    the imported table and leave the loop at different trips, so warps
    roll back and none is uniform; once more with a fuel budget that runs
    out on some lanes."""
    from wasmedge_tpu_torch.models.fixtures import (
        build_linked_program, linked_args)

    cons = build_linked_program()[1]
    args = linked_args(KERNEL_LANES, *LINKED_SMALL)
    return [("kernel_vs_plain", (name, cons, "run", args, LINKED_CHUNK, fuel,
                                 linked_knobs()),
             dict(fusion="blocks", rollbacks=True, uniform="none"))
            for name, fuel in (("linked", None), ("linked_fuel",
                                                  LINKED_FUEL))]


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
                         refused: bool = True, uniform: bool = True):
    """One launch of `chunk` steps from st0 through the kernel the main
    path runs, optimistic convergence on (B3, the default: `eng`), and
    through the careful kernel of the same module, encoding and memory
    mode (`ceng`, `optimistic` False), 21 runs each, in the order
    optimistic, careful, careful, optimistic; the optimistic plain version
    on the same inputs (3 runs, a fresh per-warp state each).  The kernel
    must equal its plain version on every plane and row and in the
    per-warp counts, and the careful kernel below sp; every warp enters
    uniform (B3's entry rule) where `uniform`, else none does; that
    launch's entry compares and window counts are read, and the entry
    compare's device time is a one-step launch of each build (21 runs
    each).  With `refused`, the
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
    torch.cuda.synchronize()
    interp.entry_counts(eng.tables, clear=True)
    if eng.tables.mem_window:
        interp.window_counts(eng.tables, clear=True)
    interp.run_chunk(eng.tables, one, chunk, False, wk)
    torch.cuda.synchronize()
    entry = interp.entry_counts(eng.tables)
    win = interp.window_counts(eng.tables) if eng.tables.mem_window else {}
    # the entry compare's device time: a one-step launch of the
    # optimistic build (entry rule, compare) against the careful build's
    w1 = new_warps(eng)
    e_ms, _, _, _ = time_launch(
        lambda s: interp.run_chunk(eng.tables, s, 1, False, w1), st0, 21)
    ec_ms, _, _, _ = time_launch(
        lambda s: interp.run_chunk(ceng.tables, s, 1, False), st0, 21)
    err = max(max_abs_err(out_k, out_p), max_abs_err(one, out_p),
              warp_err(wk, held["w"]))
    cerr = live_err(out_k, out_c)
    if err != 0 or cerr != 0:
        fail(f"{what}: optimistic kernel != plain (max abs err {err}) or "
             f"!= careful below sp ({cerr})")
    OPT_WORST["plain"] = max(OPT_WORST["plain"], err)
    OPT_WORST["careful"] = max(OPT_WORST["careful"], cerr)
    stats = wk.stats()
    n_uniform = int(wk.uniform.sum())
    if stats["rollbacks"] or stats["entered"] != (L + 31) // 32 or \
            n_uniform != (stats["entered"] if uniform else 0):
        fail(f"{what}: a converged launch's warps {stats}, uniform "
             f"{n_uniform}")
    cycles = entry["cycles"] / max(entry["compares"], 1)
    out = dict(ms=ms, q25=k25, q75=k75, ms_again=ms2, careful_ms=c_ms,
               careful_q25=c25, careful_q75=c75, careful_ms_again=c_ms2,
               plain_ms=plain_ms, plain_q25=p25, plain_q75=p75,
               max_abs_err=err, careful_err=cerr, warps=stats,
               uniform=n_uniform, entry=entry,
               entry_compare_cycles_per_warp=cycles,
               one_step_ms=e_ms, one_step_careful_ms=ec_ms,
               entry_compare_ms=e_ms - ec_ms, window_counts=win)
    line = (f"one launch of {chunk} steps x {L} lanes ({what}): optimistic "
            f"kernel median {ms:.4f} ms (q25 {k25:.4f}, q75 {k75:.4f}; "
            f"again {ms2:.4f}), careful kernel {c_ms:.4f} ms (q25 "
            f"{c25:.4f}, q75 {c75:.4f}; again {c_ms2:.4f}), 21 runs each; "
            f"optimistic plain median {plain_ms:.2f} ms (q25 {p25:.2f}, "
            f"q75 {p75:.2f}, 3 runs); warps {stats}, uniform {n_uniform}; "
            f"entry compare {cycles:.0f} cycles a warp, a one-step launch "
            f"{e_ms:.4f} ms optimistic against {ec_ms:.4f} ms careful"
            f"{f'; windows {win}' if win else ''}")
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
                   mem_direct: bool, uniform: int = 0) -> int:
    """The least bytes optimistic convergence adds to a launch from st0
    whose warps all ran on without a rollback (opt_save, opt_save_frame,
    warp_uniform and the counters of optimistic.cuh / interp.cu), of
    which `uniform` entered uniform: a uniform warp takes no snapshot, and
    its entry compare reads each lane's rows below its sp in `planes`
    stack planes, its frame rows below its depth, the globals and its
    live memory rows once; every other warp's entry snapshot (the same
    rows, the whole memory column with `mem_direct` and none without) is
    read once and written once, its frame rows from the entry depth to
    the deepest `max_cd` saved on their first write, and each later
    snapshot's globals and memory column (its stack and frame rows not
    counted); and the five per-warp counters read and written."""
    L = st0.pc.shape[0]
    nw = (L + 31) // 32
    share = (stats["entered"] - uniform) / max(stats["entered"], 1)
    NG = st0.glob_lo.shape[0]
    W = st0.mem.shape[0] if mem_direct and st0.mem.shape[0] > 1 else 0
    per_snap = 2 * NG + W
    rows = planes * int(st0.sp.sum()) + 3 * int(st0.call_depth.sum())
    frames = 3 * int((max_cd - st0.call_depth).clamp(min=0).sum())
    later = max(stats["commits"] - stats["entered"], 0) * 32 * per_snap
    snaps = 2 * (rows + L * per_snap + frames + later) * share
    return int(4 * (snaps + 2 * 5 * nw)) + \
        entry_compare_bytes(st0, planes, uniform)


def entry_compare_bytes(st0, planes: int, uniform: int) -> int:
    """The bytes the entry compare (warp_uniform) reads in a launch from
    st0 whose `uniform` warps entered uniform: each lane's rows below its
    sp in `planes` stack planes, its frame rows below its depth, the
    globals and its live memory rows, once."""
    L = st0.pc.shape[0]
    nw = (L + 31) // 32
    rows = planes * int(st0.sp.sum()) + 3 * int(st0.call_depth.sum())
    live = int(torch.clamp(st0.mem_pages.to(torch.int64) * 16384,
                           max=st0.mem.shape[0]).sum()) \
        if st0.mem.shape[0] > 1 else 0
    return int(4 * (rows + L * 2 * st0.glob_lo.shape[0] + live) *
               (uniform / nw))


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
    snap = snapshot_bytes(st0, t["warps"], max_cd, 2, False, t["uniform"])
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
                entry_compare_bytes=entry_compare_bytes(st0, 2,
                                                        t["uniform"]),
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
    snap = snapshot_bytes(st0, t["warps"], max_cd, 4, False, t["uniform"])
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
    from wasmedge_tpu_torch.vm.vm import make_engine as vm_engine

    eng = vm_engine(vm._active, vm.store, vm.conf, device="cuda")
    eng.set_encoding(fusion)
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


def counted(label: str, fn, need=("interp",)):
    """fn() with every launch count set to 0 before and read after, timed
    by wall clock and CUDA events; fails unless the launches in `need`
    happened.  Returns (fn(), counts, wall s, event ms)."""
    from wasmedge_tpu_torch.batch import interp

    torch.cuda.synchronize()
    for k in interp.LAUNCHES:
        interp.LAUNCHES[k] = 0
    interp.clear_counts()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(interp.LAUNCHES)
    for k in need:
        if counts[k] == 0:
            fail(f"{label}: no {k} launch of the CUDA kernel")
    return out, counts, wall, e0.elapsed_time(e1)


def terminal_counts(tables) -> dict:
    """The terminals that the B2 instance cases of `tables`' generated
    source run in the case, by kind, and the calls chained after a div
    or rem (batch/fusegen.py `terminal_counts`); empty for another
    encoding."""
    from wasmedge_tpu_torch.batch import fusegen

    if tables.fusion != "blocks":
        return {}
    return {k: v for k, v in fusegen.terminal_counts(
        tables.fused_source).items() if v}


def run_main(vm, func, args, steps_per_launch, need=("interp",),
             fusion=None):
    """One run (run_vm) with every launch count set to 0 before and read
    after; fails unless the kinds of launch in `need` happened.  Returns
    (result, launches, wall s, event ms, counts)."""
    from wasmedge_tpu_torch.batch import interp

    vm.conf.batch.steps_per_launch = steps_per_launch
    (res, eng), counts, wall, ev_ms = counted(
        f"main path {func}", lambda: run_vm(vm, func, args, fusion), ())
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
    counts["uniform"] = 0 if eng.warps is None else int(eng.warps.uniform.sum())
    counts["window_counts"] = interp.window_counts(eng.tables) \
        if eng.tables.mem_window else {}
    counts["entry"] = interp.entry_counts(eng.tables) \
        if eng.tables.optimistic else {}
    counts["build"] = fused_build(eng.tables)
    counts["bulk_ops"] = interp.bulk_counts(eng.tables) \
        if eng.tables.has_bulk else {}
    counts["terminals"] = terminal_counts(eng.tables)
    return res, counts["interp"], wall, ev_ms, counts


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
          f"{counts['warps']}, uniform {counts['uniform']}"
          f"{'; entry ' + str(counts['entry']) if counts['entry'] else ''}"
          f"{'; windows ' + str(counts['window_counts']) if counts['window_counts'] else ''}"
          f"{'; in-case terminals ' + str(counts['terminals']) if counts['terminals'] else ''}",
          flush=True)
    return dict(encoding=counts["encoding"], launches=launches,
                tables_launches=counts["tables"], gas_launches=counts["gas"],
                block_launches=counts["block"],
                super_launches=counts["super"], op_launches=counts["op"],
                window_launches=counts["window"],
                optimistic_launches=counts["optimistic"],
                optimistic=counts["optimistic_on"], warps=counts["warps"],
                uniform=counts["uniform"], entry=counts["entry"],
                window_counts=counts["window_counts"],
                mem_window=counts["mem_window"],
                wall_s=wall, event_ms=ev_ms, retired=retired,
                instr_per_s_wall=retired / wall, build=build,
                in_case_terminals=counts["terminals"])


def check_uniform(rec: dict, label: str, every: bool) -> None:
    """B3's entry rule on a main-path run: every warp entry uniform (a
    flagship workload: every lane one call with one argument, memories
    from the same data) or, with `every` False, none (the fib mix)."""
    entered = rec["warps"]["entered"]
    if entered == 0 or rec["uniform"] != (entered if every else 0):
        fail(f"{label}: {rec['uniform']} uniform entries of {entered}, "
             f"expected {'all' if every else 'none'}")


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

    # fib(30): B2 blocks (the default); the per-op kernel and B6 (not the
    # default path) at fib(PER_OP_FIB_N)
    for suffix, fusion, bf, need in ENCODINGS:
        vm.conf.batch.block_fusion = bf
        n = PER_OP_FIB_N if suffix else 30
        run = run_main(vm, "fib", [np.full(L, n)], 1 << 20, need, fusion)
        res, counts = run[0], run[4]
        if counts["simd"] or counts["bulk"]:
            fail(f"fib({n}) ran a kernel instantiation with bulk or v128 "
                 f"cases: {counts}")
        if not (res.trap == -1).all() or \
                not (res.results[0] == fib_py(n)).all():
            fail(f"fib({n}) x {L} [{counts['encoding']}]: traps "
                 f"{np.unique(res.trap)}, results "
                 f"{np.unique(res.results[0])[:5]}")
        retired = int(res.retired.astype(np.int64).sum())
        key = ("fib30" if n == 30 else "fib") + suffix
        out[key] = report_main(f"fib({n}) x {L}, all {fib_py(n)}", run,
                               retired)
        out[key]["n"] = n
        check_uniform(out[key], f"fib({n}) [{counts['encoding']}]", True)
        out[key]["profile"] = profile_run(vm, "fib", [np.full(L, n)],
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
    UNCOMPACTED["fib_mix"] = [run[0]]
    retired = int(run[0].retired.astype(np.int64).sum())
    out["fib_mix"] = report_main(f"fib(20 + lane % 11) x {L}, matches", run,
                                 retired)
    if not out["fib_mix"]["warps"]["rollbacks"]:
        fail("the divergent fib mix rolled no warp back")
    check_uniform(out["fib_mix"], "the divergent fib mix", False)
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
        check_uniform(out[key], f"coremark({COREMARK_N}){suffix}", True)
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


def profile_fn(label: str, fn, retired):
    """fn() once more under torch.profiler: the interpreter kernel's
    device time and launches, the wall, the host<->device copies' device
    time, the card's idle share and (`retired` given) instr/s over the
    kernel time.  CUDA events also bracket every kernel launch of the
    run (the engine's run_chunk): the trace can drop device events, so
    when it holds fewer interpreter kernels than there were launches,
    the kernel's time is the events' ("kernel_from" says which;
    "event_kernel_ms" is theirs in any case).  Returns (fn(), record)."""
    from torch.profiler import ProfilerActivity, profile
    from wasmedge_tpu_torch.batch import engine as engine_mod

    launch, marks = engine_mod.run_chunk, []

    def timed(*args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = launch(*args, **kwargs)
        ev[1].record()
        marks.append(ev)
        return out

    torch.cuda.synchronize()
    engine_mod.run_chunk = timed
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        engine_mod.run_chunk = launch
    kern = [e for e in prof.key_averages() if "interp_kernel" in e.key]
    dev_us = sum(getattr(e, "device_time_total", 0) or
                 getattr(e, "cuda_time_total", 0) for e in kern)
    if not marks:
        fail(f"profile {label}: the run launched no interpreter kernel")
    event_s = sum(a.elapsed_time(b) for a, b in marks) / 1e3
    traced = sum(e.count for e in kern)
    if traced == len(marks) and dev_us > 0:
        kernel_s, source = dev_us / 1e6, "profiler"
    else:
        kernel_s, source = event_s, "events"
        print(f"profile {label}: the trace holds {traced} of the "
              f"{len(marks)} interpreter kernel launches "
              f"({dev_us / 1e3:.3f} ms); the kernel's time is from the "
              f"CUDA events around them", flush=True)
    # host <-> device copies (the serve rounds' memory chunks and stack
    # rows, set-up's planes): device time of the Memcpy entries
    copy_s = sum(getattr(e, "device_time_total", 0) or
                 getattr(e, "cuda_time_total", 0)
                 for e in prof.key_averages() if "Memcpy" in e.key) / 1e6
    return out, dict(kernel_ms=kernel_s * 1e3, kernel_from=source,
                     event_kernel_ms=event_s * 1e3, launches=len(marks),
                     wall_s=wall,
                     setup_host_ms=(wall - kernel_s) * 1e3,
                     copy_ms=copy_s * 1e3, idle_share=1.0 - kernel_s / wall,
                     instr_per_s_kernel=None if retired is None
                     else retired / kernel_s)


def profile_run(vm, func, args, retired: int, fusion=None):
    """One more run (run_vm) under torch.profiler (profile_fn), with the
    host time in serve rounds and stdout flushes."""
    (_, eng), rec = profile_fn(func, lambda: run_vm(vm, func, args, fusion),
                               retired)
    stats = eng.hostcall_stats
    serve_s = stats["serve_s"]
    kernel_s, wall, count = rec["kernel_ms"] / 1e3, rec["wall_s"], \
        rec["launches"]
    print(f"profile {func} x {MAIN_LANES} [{eng.tables.fusion}"
          f"{', tier 0' if eng.tables.t0k is not None else ''}]: kernel "
          f"device time "
          f"{kernel_s * 1e3:.3f} ms over {count} launches "
          f"({kernel_s * 1e3 / count:.3f} ms per launch), wall "
          f"{wall * 1e3:.3f} ms, set-up and host {(wall - kernel_s) * 1e3:.3f}"
          f" ms (of which {stats['serve_rounds']} serve rounds "
          f"{serve_s * 1e3:.3f} ms, {stats['stdout_flushes']} stdout "
          f"flushes {stats['flush_s'] * 1e3:.3f} ms; host<->device copies "
          f"{rec['copy_ms']:.3f} ms of device time), device idle share "
          f"{rec['idle_share']:.4f}, "
          f"{retired / kernel_s:.4g} wasm instr/s over kernel time",
          flush=True)
    return dict(encoding=eng.tables.fusion, kernel_ms=rec["kernel_ms"],
                kernel_from=rec["kernel_from"], launches=count, wall_s=wall,
                setup_host_ms=rec["setup_host_ms"],
                serve_rounds=stats["serve_rounds"], serve_ms=serve_s * 1e3,
                stdout_flushes=stats["stdout_flushes"],
                flush_ms=stats["flush_s"] * 1e3,
                copy_ms=rec["copy_ms"], idle_share=rec["idle_share"],
                instr_per_s_kernel=rec["instr_per_s_kernel"])


def wasi_vm(data: bytes, fd: int, pages: int = 1, tier0: bool = True):
    """A VM at MAIN_LANES lanes with bench_echo's stack shape, the WASI
    host module registered (stdout to `fd`), tier 0 on (the default) or
    off, and `data` instantiated."""
    from wasmedge_tpu_torch.common.configure import (
        Configure, HostRegistration)
    from wasmedge_tpu_torch.vm.vm import VM

    conf = Configure()
    conf.host_registrations.add(HostRegistration.Wasi)
    conf.batch.lanes = MAIN_LANES
    conf.batch.value_stack_depth = 64
    conf.batch.call_stack_depth = 16
    conf.batch.memory_pages_per_lane = pages
    conf.batch.tier0_hostcalls = tier0
    vm = VM(conf)
    vm.wasi_module.init_wasi(args=list(WASI_ARGS))
    vm.wasi_module.env.fds[1].os_fd = fd
    vm.load_wasm(data)
    vm.validate()
    vm.instantiate()
    return vm


def phase_main_wasi():
    """WASI echo (bench_echo's shape) through VM.execute_batch at
    MAIN_LANES lanes with tier 0 on (the default: every fd_write retired
    in the kernel, one stdout flush) and off (every call served between
    launches), each once more under torch.profiler, and WASI hello
    (proc_exit in the kernel, its other calls served); stdout to
    temporary files, checked byte for byte."""
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

    kinds = ("run", "profile", "mem_hbm False", "tier 0 off",
             "tier 0 off, profile")
    with tempfile.TemporaryDirectory() as td:
        paths = [os.path.join(td, str(i)) for i in range(len(kinds))]
        fds = [os.open(p, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
               for p in paths]
        try:
            vm = wasi_vm(build_echo(), fds[0])
            overhead = FLUSH["overhead_s"]
            res, launches, wall, ev_ms, counts = run_main(
                vm, "echo", [ECHO_ITERS], 1 << 20,
                need=("interp", "hostcall", "block", "window", "tier0",
                      "stdout_flush"))
            stats = dict(vm.last_engine.hostcall_stats)
            check_ms = (FLUSH["overhead_s"] - overhead) * 1e3
            retired = int(res.retired.astype(np.int64).sum())
            prof = profile_run(wasi_vm(build_echo(), fds[1]), "echo",
                               [ECHO_ITERS], retired)
            direct = direct_run(wasi_vm(build_echo(), fds[2]), "echo",
                                [ECHO_ITERS], 1 << 20,
                                ("interp", "hostcall", "block", "tier0",
                                 "stdout_flush"), check)
            off = wasi_vm(build_echo(), fds[3], tier0=False)
            res_off, launches_off, wall_off, ev_off, counts_off = run_main(
                off, "echo", [ECHO_ITERS], 1 << 20,
                need=("interp", "hostcall", "block", "window"))
            stats_off = dict(off.last_engine.hostcall_stats)
            prof_off = profile_run(wasi_vm(build_echo(), fds[4], tier0=False),
                                   "echo", [ECHO_ITERS], retired)
        finally:
            for fd in fds:
                os.close(fd)
        runs = [open(p, "rb").read() for p in paths]
    for k, got in zip(kinds, runs):
        if got != want:
            fail(f"echo x {L} ({k}): stdout is {len(got)} B, expected "
                 f"{len(want)} B of the message")
    n_checked = check_flushes("main echo")
    check(res)
    check(res_off)
    if stats["serve_rounds"] != 0 or stats["tier1_calls"] != 0 or \
            stats["tier0_fd_write"] != calls or \
            stats["stdout_flushes"] != 1 or \
            stats["stdout_bytes"] != len(want):
        fail(f"echo x {L} with tier 0: {stats}, expected {calls} fd_write "
             f"calls in the kernel, no serve round and one flush of "
             f"{len(want)} B")
    if counts_off["tier0"] != 0 or stats_off["tier1_calls"] != calls or \
            stats_off["tier0_calls"] != 0:
        fail(f"echo x {L} with tier 0 off: {stats_off['tier1_calls']} host "
             f"calls served, expected {calls}")
    out["echo"] = dict(launches=launches, hostcall_launches=counts[
        "hostcall"], tier0_launches=counts["tier0"],
        stdout_flush_launches=counts["stdout_flush"],
        flushes_checked=n_checked, flush_check_ms=check_ms, wall_s=wall,
        event_ms=ev_ms, retired=retired, host_calls=calls,
        host_calls_per_s=calls / wall, stdout_bytes=len(want),
        flush_ms=stats["flush_s"] * 1e3, profile=prof, direct=direct,
        **{k: v for k, v in stats.items() if k != "stdout_bytes"})
    out["echo"]["tier0_off"] = dict(
        launches=launches_off, wall_s=wall_off, event_ms=ev_off,
        host_calls_per_s=calls / wall_off, profile=prof_off, **stats_off)
    print(f"main wasi echo x {L} (ITERS {ECHO_ITERS}), tier 0: {calls} "
          f"fd_write calls retired in the kernel "
          f"({stats['tier0_fd_write']}), {stats['serve_rounds']} serve "
          f"rounds, {stats['stdout_flushes']} flush of "
          f"{stats['stdout_bytes']} B in {stats['flush_s'] * 1e3:.3f} ms "
          f"(the flush kernel, {counts['stdout_flush']} launches; its "
          f"check's copies {check_ms:.3f} ms of it; {n_checked} flushes of "
          f"the echo runs held against the plain version), "
          f"stdout exact, all lanes done with 0, {launches} launches, wall "
          f"{wall:.3f} s, {calls / wall:.4g} host calls/s; tier 0 off: "
          f"{launches_off} launches, {stats_off['serve_rounds']} serve "
          f"rounds ({stats_off['tier1_vectorized']} calls vectorized) "
          f"{stats_off['serve_s'] * 1e3:.3f} ms, wall {wall_off:.3f} s, "
          f"{calls / wall_off:.4g} host calls/s", flush=True)
    # The least bytes one serve round moves per parked lane: fd_write's 4
    # argument cells (8 B each), the iovec (8 B) and the 16-byte message
    # read; nwritten (4 B) and the result cell (8 B) written.
    round_bytes = L * (4 * 8 + 8 + 16 + 4 + 8)
    out["echo"]["serve_round_bound_ms"] = round_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  serve round bound (tier 0 off) "
          f"{out['echo']['serve_round_bound_ms']:.6f} ms by bytes: "
          f"{round_bytes} B / {HBM_BYTES_PER_S:.3g} B/s; mean round "
          f"{stats_off['serve_s'] * 1e3 / stats_off['serve_rounds']:.3f} ms",
          flush=True)

    codes = np.arange(L) % 3
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "hello")
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
        try:
            vm = wasi_vm(build_wasi_hello(), fd)
            res, launches, wall, ev_ms, counts = run_main(
                vm, "hello", [codes], 1 << 20,
                need=("interp", "hostcall", "block", "window", "tier0",
                      "stdout_flush"))
            eng = vm.last_engine
            hstats = dict(eng.hostcall_stats)
            # the exit codes: proc_exit's argument in each stopped frame
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
    # args_sizes_get, args_get and an fd_write of three iovecs are served
    # between launches; proc_exit retires in the kernel
    if hstats["tier0_sys"] != L or hstats["tier1_calls"] != 3 * L:
        fail(f"hello x {L}: {hstats['tier0_sys']} proc_exit calls in the "
             f"kernel (expected {L}), {hstats['tier1_calls']} served "
             f"(expected {3 * L})")
    out["hello"] = dict(launches=launches, wall_s=wall, event_ms=ev_ms,
                        stdout_flush_launches=counts["stdout_flush"],
                        flushes_checked=check_flushes("main hello"),
                        serve_rounds=hstats["serve_rounds"],
                        tier1_calls=hstats["tier1_calls"],
                        tier0_sys=hstats["tier0_sys"])
    print(f"main wasi hello x {L}: every lane Terminated with exit code "
          f"lane % 3 (proc_exit in the kernel: {hstats['tier0_sys']}), "
          f"{hstats['tier1_calls']} calls in {hstats['serve_rounds']} "
          f"serve rounds, stdout {len(want)} B exact, {launches} launches, "
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
    rest = [f for f in files if os.path.basename(f) not in TABLE_CORPUS_COUNTS]
    rep = run_corpus_batched(rest, device="cuda", conf=corpus_conf())
    tables_launches = interp.LAUNCHES["tables"]
    # the table and tail-call files one by one: each its own counts
    per_file = {}
    for f in files:
        name = os.path.basename(f)
        if name not in TABLE_CORPUS_COUNTS:
            continue
        r = run_corpus_batched([f], device="cuda", conf=corpus_conf())
        per_file[name] = (r.passed, r.failed, r.skipped)
        print(f"  {name} on the card: {r.passed} passed, {r.failed} failed, "
              f"{r.skipped} skipped", flush=True)
        if per_file[name] != TABLE_CORPUS_COUNTS[name]:
            for x in r.failures[:10]:
                print(f"  {x}", flush=True)
            fail(f"{name} on the card: {per_file[name]}, expected "
                 f"{TABLE_CORPUS_COUNTS[name]}")
        rep.passed += r.passed
        rep.failed += r.failed
        rep.skipped += r.skipped
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(interp.LAUNCHES)
    if counts["tables"] == tables_launches:
        fail("the table and tail-call corpus files never launched a build "
             "with the table handlers")
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
                optimistic_launches=counts["optimistic"],
                tables_launches=counts["tables"], table_files=per_file,
                wall_s=wall)


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
    n = SIMD_N
    # B2 blocks (the default) and, with block_fusion False, the per-op
    # kernel (a module with v128 ops runs no superinstructions)
    def check(res):
        if not (res.trap == -1).all() or \
                not ((res.results[0] & 0xFFFFFFFF) == want).all():
            fail(f"vloop({n}) x {L}: traps {np.unique(res.trap)}, "
                 f"results {np.unique(res.results[0])[:5]}, model {want}")
        if not (res.retired.astype(np.int64) == want_retired).all():
            fail(f"vloop({n}) x {L}: retired "
                 f"{np.unique(res.retired)[:5]}, expected {want_retired} "
                 f"per lane")

    for suffix, bf, need in (("", None, ("interp", "simd", "block")),
                             ("_none", False, ("interp", "simd", "op"))):
        vm.conf.batch.block_fusion = bf
        # the per-op kernel (not the default path) at a PER_OP_CUT-th
        n = SIMD_N // PER_OP_CUT if suffix else SIMD_N
        want, want_retired = simd_loop_model(n), base + per * n
        run = run_main(vm, "vloop", [np.full(L, n)], 1 << 20,
                       need + ("window",))
        res, counts = run[0], run[4]
        check(res)
        retired = int(res.retired.astype(np.int64).sum())
        rec = report_main(
            f"vloop({n}) x {L}, every lane {want} (the model), retired "
            f"{want_retired} per lane ({base} + {per} per iteration)", run,
            retired)
        rec["n"] = n
        check_uniform(rec, f"vloop({n}){suffix}", True)
        rec["simd_launches"] = counts["simd"]
        rec["profile"] = profile_run(vm, "vloop", [np.full(L, n)], retired)
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
        base, per = retired_model(vm, name) \
            if name == "mem_checksum" else (None, None)
        n_full = n
        for suffix, fusion, _, need in ENCODINGS[:2]:
            # mem_checksum per op (not the default path) at a
            # PER_OP_CUT-th of its words
            n = n_full // PER_OP_CUT if suffix and per is not None \
                else n_full
            if per is not None:
                want = memory_workload_model(n, MEM_PASSES)
            args = [np.full(L, n)]
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
                out[key]["n"] = n
                check_uniform(out[key], f"config 2 {name}{tag}", True)
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
    same inputs (time_opt_and_careful), both modes equal, and B4's bound
    in each mode (B3's snapshot and entry-compare bytes apart)."""
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
    # each word a load reads read once, the code tables read once
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
        # B3's bytes (snapshots, the entry compare) go to B3's record; B4's
        # bound counts B4's work: with the windows the rows they moved
        # (each row filled or stored is 4 bytes read or written in the
        # plane, in place of the words the launch changes and loads),
        # without them each changed word written and each loaded word read
        snap = snapshot_bytes(st0, out[mode]["warps"], max_cd, 2, not m,
                              out[mode]["uniform"])
        if m:
            wc = out[mode]["window_counts"]
            moved = 4 * (wc["rows_filled"] + wc["rows_written_back"])
            bytes_ = 2 * touched + table_bytes + moved
            out[mode].update(window_row_bytes=moved,
                             window_rows_bound_ms=bytes_ / HBM_BYTES_PER_S *
                             1e3)
        else:
            bytes_ = careful_bytes
        bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
        out[mode].update(bound_ms=max(bound_bytes_ms, bound_ops_ms),
                         bound_by=by, bound_bytes=bytes_, snapshot_bytes=snap,
                         entry_compare_bytes=entry_compare_bytes(
                             st0, 2, out[mode]["uniform"]))
        print(f"  {mode}: bound {out[mode]['bound_ms']:.6f} ms by {by}: "
              f"bytes {bytes_} B (stack rows {max_sp}, frame rows {max_cd}, "
              f"code tables {table_bytes} B, "
              + (f"window rows moved {out[mode]['window_row_bytes']} B"
                 if m else f"{changed} memory words written, {loads} "
                 f"loaded") +
              f") / {HBM_BYTES_PER_S:.3g} B/s = {bound_bytes_ms:.6f} ms; "
              f"B3's snapshots and entry compare (not in it) {snap} B",
              flush=True)
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


def phase_time_tier0() -> dict:
    """The tier-0 record: echo(ECHO_ITERS) x MAIN_LANES from its initial
    state in one launch of the main path's build (B2 blocks, windows,
    optimistic, tier 0: every lane runs to its end, 2 x ECHO_ITERS
    fd_write calls retired in place), its careful twin and the plain
    version on the card with the same time base (every plane equal),
    against the same launch with tier 0 off (it ends at the first park),
    and one flush of the buffered stdout.  The bound is the tier-0
    calls' bytes: per call the iovec (8 B), the payload (16 B), nwritten
    (4 B) and the record (20 B); per launch its argument cells."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.batch.engine import t0_time_planes
    from wasmedge_tpu_torch.models import build_echo

    L, chunk = MAIN_LANES, 1 << 20
    knobs = dict(value_stack_depth=64, call_stack_depth=16,
                 memory_pages_per_lane=1)
    with tempfile.TemporaryDirectory() as td:
        fd = os.open(os.path.join(td, "out"), os.O_RDWR | os.O_CREAT)
        try:
            engs = {k: make_engine(build_echo(), L, imports=[wasi_import(fd)],
                                   optimistic=opt, tier0_hostcalls=t0,
                                   **knobs)[0]
                    for k, opt, t0 in (("kopt", None, True),
                                       ("careful", False, True),
                                       ("off", None, False))}
            eng = engs["kopt"]
            st0 = eng.initial_state(eng.inst.exports["echo"][1],
                                    [np.full(L, ECHO_ITERS)])
            off0 = engs["off"].initial_state(eng.inst.exports["echo"][1],
                                             [np.full(L, ECHO_ITERS)])
            tt = t0_time_planes()

            def timed(k, st, reps=7):
                e = engs[k]
                times, out = [], None
                for _ in range(reps):
                    s = st.clone()
                    w = new_warps(e)
                    if w is not None:
                        w.shadows_for(s, e.tables.mem_window)
                    torch.cuda.synchronize()
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    interp.run_chunk(e.tables, s, chunk, False, w,
                                     tt if k != "off" else None)
                    e1.record()
                    torch.cuda.synchronize()
                    times.append(e0.elapsed_time(e1))
                    out = (s, w)
                return float(np.median(times)), out

            ms, (out_k, w_k) = timed("kopt", st0)
            careful_ms, (out_c, _) = timed("careful", st0)
            off_ms, (out_off, _) = timed("off", off0)
            plain = st0.clone()
            wp = new_warps(eng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            interp_ref.run_chunk(eng.tables, plain, chunk, False, wp, tt)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max(max_abs_err(out_k, plain), warp_err(w_k, wp),
                      live_err(out_k, out_c))
            if err != 0:
                fail(f"tier-0 echo launch: kernel != plain, max abs err "
                     f"{err}")
            calls = int(out_k.t0_ctr[2].sum())
            if calls != 2 * ECHO_ITERS * L or \
                    not bool((out_k.trap == -1).all()):
                fail(f"tier-0 echo launch: {calls} fd_write calls in the "
                     f"kernel, traps {sorted(set(out_k.trap.tolist()))}")
            parked = int((out_off.trap == -2).sum())
            if parked != L:
                fail(f"tier-0-off echo launch: {parked} lanes parked")
            flush = phase_time_flush(eng, out_k)
        finally:
            os.close(fd)
    flush_ms, nbytes = flush["flush_ms"], flush["flush_bytes"]
    n_args = (len(interp._TABLE_FIELDS) + len(interp._STATE_FIELDS)
              + len(interp._FUSED_FIELDS) + interp._N_OPT
              + interp._N_T0_PTRS) * 8 + \
        (interp._N_INTS + interp._N_T0_INTS) * 4
    bound_bytes = calls * (8 + 16 + 4 + 20) + n_args
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    print(f"timed tier-0 echo launch x {L}: {calls} fd_write calls in the "
          f"kernel, kOpt {ms:.4f} ms, careful {careful_ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms, max abs err {err}; tier 0 off (to the "
          f"first park) {off_ms:.4f} ms; flush {nbytes} B in "
          f"{flush_ms:.3f} ms; bound {bound_ms:.6f} ms by bytes "
          f"({bound_bytes} B)", flush=True)
    return dict(ms=ms, careful_ms=careful_ms, plain_ms=plain_ms,
                tier0_off_ms=off_ms, calls=calls, bound_ms=bound_ms,
                bound_bytes=bound_bytes, bound_by="bytes", max_abs_err=err,
                warps=w_k.stats(), uniform=int(w_k.uniform.sum()),
                flush=flush, **{k: flush[k] for k in ("flush_ms",
                                                      "flush_bytes")})


# the flush's timed repetitions (medians)
FLUSH_REPS = 3


def phase_time_flush(eng, st) -> dict:
    """Tier 0's stdout flush of `st` (echo's records after its one
    launch), FLUSH_REPS times each (medians): `flush_stdout_buffers`
    whole (the flush kernel, the counts' read-back, one copy of the
    bytes, the writes; on a copy of the fills, the cursor reset), its
    parts (`flush_kernel_split`: the kernel's device ms by CUDA events),
    and the plain path as the flush ran before the kernel
    (`flush_plain_split`: the so_off and so_buf downloads, `_records`, the
    writes); the kernel's device time (`flush_device_ms`);
    `torch.masked_select` over the transposed planes (the
    library yardstick); the kernel's bytes and lens against `_records`;
    the bound (bytes at the HBM rate)."""
    from wasmedge_tpu_torch.batch import stdout_flush
    from wasmedge_tpu_torch.batch.hostcall import (
        _records, flush_stdout_buffers, stdout_cursor_reset)

    L = st.so_off.shape[0]
    skip = np.zeros(L, np.int64)
    whole = []
    for _ in range(FLUSH_REPS + 1):
        stdout_cursor_reset(eng)
        s = st.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = flush_stdout_buffers(eng, s)
        whole.append((time.perf_counter() - t0) * 1e3)
    kern = [flush_kernel_split(eng, st, skip) for _ in range(FLUSH_REPS)]
    plain = [flush_plain_split(eng, st, skip) for _ in range(FLUSH_REPS)]

    def med(rows, k, scale=1e3):
        return float(np.median([r[k] for r in rows])) * scale

    ksplit = {k: med(kern, k) for k in ("launch", "counts_readback",
                                        "bytes_copy", "writes",
                                        "parts_whole")}
    ksplit["events_ms"] = med(kern, "events_ms", 1)
    kernel_ms = flush_device_ms(st, skip)
    psplit = {k: med(plain, k) for k in ("so_off_download",
                                         "so_buf_download", "records",
                                         "writes", "whole")}
    lib = flush_library_ms(st)
    got = stdout_flush.records(st.so_buf, st.so_off, skip)
    off = st.so_off.cpu().numpy()
    want, lens = _records(st.so_buf[:int(off.max())].cpu().numpy(), off)
    if {fd: bytes(b) for fd, b in got[0].items() if len(b)} != \
            {fd: b for fd, b in want.items() if b} or \
            not np.array_equal(got[1], lens) or nbytes != plain[0]["bytes"]:
        fail("tier-0 echo flush: the flush kernel differs from the plain "
             "version")
    bound_ms, bound_bytes = flush_bound(st, nbytes)
    out = dict(flush_ms=float(np.median(whole[1:])), flush_bytes=nbytes,
               kernel_ms=kernel_ms, kernel_split_ms=ksplit,
               plain_ms=psplit["records"], plain_split_ms=psplit,
               plain_flush_ms=psplit["whole"], library_ms=lib["masked_select"],
               library=lib, bound_ms=bound_ms, bound_bytes=bound_bytes,
               rows=plain[0]["rows"], max_abs_err=0)
    print(f"timed tier-0 echo flush x {L} ({nbytes} B, {plain[0]['rows']} "
          f"rows): flush_stdout_buffers {out['flush_ms']:.4f} ms (the flush "
          f"kernel {kernel_ms:.4f} ms of device time; parts "
          f"{json.dumps({k: round(v, 4) for k, v in ksplit.items()})} ms); "
          f"the plain path {psplit['whole']:.4f} ms (parts "
          f"{json.dumps({k: round(v, 4) for k, v in psplit.items()})} ms); "
          f"masked_select {lib['masked_select']:.4f} ms (transpose "
          f"{lib['transpose']:.4f}); bound {bound_ms:.6f} ms by bytes "
          f"({bound_bytes} B); kernel == plain", flush=True)
    return out


def tail_engines(L: int, **knobs):
    """The main path's tail-dispatch engines at L lanes (B2 blocks,
    windows, the default depths): optimistic and careful."""
    from wasmedge_tpu_torch.models.fixtures import build_tail_dispatch

    return tuple(make_engine(build_tail_dispatch(), L, optimistic=opt,
                             **knobs)[0] for opt in (None, False))


def phase_time_tables() -> dict:
    """The tables record: one launch of TIMED_STEPS steps of the converged
    tail dispatch x MAIN_LANES from its initial state (run's set-up:
    memory.init, data.drop, table.init, elem.drop, table.set, table.grow;
    then handler steps, each a return_call_indirect through the lane's
    table) through the main path's build, its careful twin and the plain
    version (time_opt_and_careful: every plane and the per-warp counts
    equal, every warp uniform); the same launch with weighted gas
    (tail_cost_table, a budget that never runs out) and with flat fuel,
    the gas kernel against its plain version.  The bound is the bytes the
    launch must move: the control planes and stack rows below the deepest
    sp read and written once, per lane the 256 program bytes memory.init
    writes, the table rows and size it writes and the two dropped flags,
    and once the segments it reads and the code tables."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.batch.engine import CONTROL_FIELDS
    from wasmedge_tpu_torch.models.fixtures import (
        tail_cost_table, tail_dispatch_args)

    L, chunk = MAIN_LANES, TIMED_STEPS
    eng, ceng = tail_engines(L)
    args = tail_dispatch_args(L, "converged")
    st0 = eng.initial_state(eng.inst.exports["run"][1], args)
    t, out_k = time_opt_and_careful(eng, ceng, st0, chunk,
                                    "tail dispatch, converged")
    retired = int(out_k.retired.sum())
    counts, max_sp, max_cd = launch_mix(ceng.tables, st0, chunk)
    if int(counts.sum()) != retired or max_cd != 0:
        fail(f"tail dispatch launch mix: {int(counts.sum())} instructions "
             f"against {retired} retired, deepest call depth {max_cd}")
    tb = ceng.tables
    touched = 4 * L * (2 * max_sp + len(CONTROL_FIELDS))
    per_lane = 256 + 4 * 9 + 4 + 4 + 4  # program, 9 rows, tsize, 2 flags
    segments = 4 * (tb.efl.numel() + tb.dwords.numel())
    table_bytes = sum(4 * t_.numel() for t_ in vars(tb).values()
                      if isinstance(t_, torch.Tensor))
    bytes_ = 2 * touched + L * per_lane + segments + table_bytes
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = retired * OPS_PER_INSTR / OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    # weighted gas and flat fuel, the same launch
    big = (1 << 31) - 1
    geng = tail_engines(L, fuel_per_launch=big,
                        cost_table=tail_cost_table())[0]
    feng = tail_engines(L, fuel_per_launch=big)[0]
    sg = geng.initial_state(geng.inst.exports["run"][1], args)
    gas = {}
    for k, e in (("gas", geng), ("fuel", feng)):
        w = new_warps(e)
        e_ms, _, _, out = time_launch(
            lambda s: interp.run_chunk(e.tables, s, chunk, True, w), sg, 21)
        gas[k] = (e_ms, out)
    plain = sg.clone()
    wp = new_warps(geng)
    interp_ref.run_chunk(geng.tables, plain, chunk, True, wp)
    wg = new_warps(geng)
    one = sg.clone()
    interp.run_chunk(geng.tables, one, chunk, True, wg)
    torch.cuda.synchronize()
    gerr = max(max_abs_err(one, plain), warp_err(wg, wp))
    spent = int((sg.fuel.to(torch.int64) - one.fuel.to(torch.int64)).sum())
    # the launch's instructions (the budget never runs out) at their
    # weights
    want = int((counts * geng.cost.astype(np.int64)).sum())
    if gerr != 0 or spent != want or spent <= retired:
        fail(f"weighted-gas tail dispatch launch: kernel != plain (max abs "
             f"err {gerr}) or fuel spent {spent}, not the {want} its "
             f"{retired} instructions weigh")
    terms = terminal_counts(eng.tables)
    print(f"  tail dispatch launch: in-case terminals {terms}, retired "
          f"{retired}, bound {bound_ms:.6f} "
          f"ms by {by} ({bytes_} B: stack rows {max_sp}, code tables "
          f"{table_bytes} B, segments {segments} B; operations "
          f"{bound_ops_ms:.6f} ms); weighted gas {gas['gas'][0]:.4f} ms, "
          f"flat fuel {gas['fuel'][0]:.4f} ms, no fuel {t['ms']:.4f} ms; "
          f"gas kernel equal to plain, {spent} fuel units for "
          f"{int(one.retired.sum())} instructions", flush=True)
    return dict(t, bound_ms=bound_ms, careful_bound_ms=bound_ms,
                bound_by=by, retired=retired, bound_bytes=bytes_,
                in_case_terminals=terms,
                gas_ms=gas["gas"][0], fuel_ms=gas["fuel"][0],
                gas_max_abs_err=gerr, gas_fuel_spent=spent,
                max_abs_err=max(t["max_abs_err"], gerr))


def phase_main_tables() -> dict:
    """The tail-dispatch workload through VM.execute_batch at full size:
    run(seed, TAIL_DISPATCH_N) x MAIN_LANES (about 3e7 instructions a
    lane; divergent a TAIL_DIVERGENT_CUT-th of the steps) with the defaults (B2 blocks,
    windows, optimistic) in both modes, every lane equal to the numpy model, the call depth 0 after
    every launch (tail calls push no frame), every converged warp entry
    uniform and no divergent one; each profiled and once more careful
    (profiled too for the converged run; the divergent careful run's
    CUDA events over its launches, to keep the script's time);
    the converged run once more with a fuel budget that never runs out,
    flat and with weighted gas (tail_cost_table), equal to the model."""
    from wasmedge_tpu_torch.batch import engine as engine_mod
    from wasmedge_tpu_torch.common.configure import Configure, Proposal
    from wasmedge_tpu_torch.models.fixtures import (
        TAIL_DISPATCH_N, build_tail_dispatch, tail_cost_table,
        tail_dispatch_args, tail_dispatch_model)
    from wasmedge_tpu_torch.vm.vm import VM

    L = MAIN_LANES
    out = {}
    depth = [0]
    orig = engine_mod.run_chunk

    def probe(tables, st, *a, **k):
        orig(tables, st, *a, **k)
        depth[0] = max(depth[0], int(st.call_depth.max()))

    def vm_of(**knobs):
        conf = Configure()
        conf.add_proposal(Proposal.TailCall)
        conf.batch.lanes = L
        for k, v in knobs.items():
            setattr(conf.batch, k, v)
        vm = VM(conf)
        vm.load_wasm(build_tail_dispatch())
        vm.validate()
        vm.instantiate()
        return vm

    vm = vm_of()
    for mode in ("converged", "divergent"):
        n = TAIL_DISPATCH_N // (1 if mode == "converged"
                                else TAIL_DIVERGENT_CUT)
        args = tail_dispatch_args(L, mode, n)
        want = tail_dispatch_model(args[0], n)

        def check(res, mode=mode, want=want):
            got = res.results[0].astype(np.int64) & 0xFFFFFFFF
            if not (res.trap == -1).all() or not (got == want).all():
                fail(f"tail dispatch {mode} x {L}: traps "
                     f"{sorted(set(res.trap.tolist()))}, "
                     f"{int((got != want).sum())} lanes off the model")

        need = ("interp", "block", "tables", "window")
        depth[0] = 0
        engine_mod.run_chunk = probe
        try:
            run = run_main(vm, "run", args, 1 << 20, need)
        finally:
            engine_mod.run_chunk = orig
        check(run[0])
        if depth[0] != 0:
            fail(f"tail dispatch {mode}: call depth {depth[0]} after a "
                 f"launch (a tail call pushes no frame)")
        retired = int(run[0].retired.astype(np.int64).sum())
        label = f"tail dispatch {mode} x {L}, n {n}"
        rec = report_main(f"{label}, equal to the numpy model, "
                          f"{retired / L:.4g} instr a lane", run, retired)
        check_uniform(rec, f"tail dispatch {mode}", mode == "converged")
        rec["profile"] = profile_run(vm, "run", args, retired)
        if mode == "converged":
            rec["careful"] = careful_run(vm, "run", args, 1 << 20, need,
                                         check, label)
        else:
            vm.conf.batch.optimistic = False
            try:
                run = run_main(vm, "run", args, 1 << 20, need)
            finally:
                vm.conf.batch.optimistic = None
            check(run[0])
            rec["careful"] = report_main(f"{label}, optimistic False", run,
                                         retired)
        out[mode] = rec
    args = tail_dispatch_args(L, "converged")
    want = tail_dispatch_model(args[0], TAIL_DISPATCH_N)
    for key, knobs in (("fuel", {}), ("gas", dict(
            cost_table=tail_cost_table()))):
        vmg = vm_of(fuel_per_launch=(1 << 31) - 1, **knobs)
        run = run_main(vmg, "run", args, 1 << 20,
                       ("interp", "block", "tables") + (
                           ("gas",) if key == "gas" else ()))
        got = run[0].results[0].astype(np.int64) & 0xFFFFFFFF
        if not (run[0].trap == -1).all() or not (got == want).all():
            fail(f"tail dispatch with {key}: a lane is off the model")
        retired = int(run[0].retired.astype(np.int64).sum())
        rec = report_main(f"tail dispatch converged x {L} with "
                          f"{'weighted gas' if key == 'gas' else 'flat fuel'}"
                          f", equal to the model", run, retired)
        rec["profile"] = profile_run(vmg, "run", args, retired)
        out[key] = rec
    return out


def linked_vm(**stats):
    """A VM at MAIN_LANES lanes (the default knobs: B2 blocks, windows,
    optimistic) with the linked program's provider registered as "prov"
    (VM.register_module) and the consumer loaded, validated and
    instantiated, its start function run on the host's scalar engine
    (`stats`: StatisticsConfigure fields, timers on).  Returns (vm,
    instantiate wall s, the start function's host s from the VM's
    Statistics)."""
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.models.fixtures import build_linked_program
    from wasmedge_tpu_torch.vm.vm import VM

    prov, cons = build_linked_program()
    conf = Configure()
    conf.batch.lanes = MAIN_LANES
    conf.statistics.time_measuring = True
    for k, v in stats.items():
        setattr(conf.statistics, k, v)
    vm = VM(conf)
    vm.register_module("prov", prov)
    vm.load_wasm(cons)
    vm.validate()
    vm.statistics().reset()
    t0 = time.perf_counter()
    vm.instantiate()
    return vm, time.perf_counter() - t0, vm.statistics().wasm_ns / 1e9


def phase_main_linked() -> dict:
    """The linked program at full size through the user's entry points:
    VM.register_module("prov", ...) -> load_wasm -> validate ->
    instantiate (the start function fills the imported memory and sets a
    global on the host) -> execute_batch, run(n, k) x MAIN_LANES with k =
    lane and n = LINKED_N0 + (lane % 8) LINKED_N1 (about 8e6
    instructions a lane; trip counts and call_indirect targets differ in
    every warp), the defaults (B2 blocks, windows, optimistic): every lane
    equal to the numpy model and retiring 8 + 35 n, no warp entry
    uniform; LINKED_SAMPLE lanes at small n through VM.execute on the
    host's scalar engine equal to the card's execute_batch and the model;
    profiled, and once more careful (profiled).  Then gas: a VM with
    `statistics.cost_measuring`, flat weights and `cost_limit` the exact
    retired count of lane group 3 (the start function's cost, charged at
    instantiation, below it): groups 0-3 finish equal to the model (group
    3 exactly on the budget), groups 4-7 trap CostLimitExceeded with
    retired = the limit + 1."""
    from wasmedge_tpu_torch.common.errors import ErrCode
    from wasmedge_tpu_torch.models.fixtures import (
        LINKED_N0, LINKED_N1, linked_args, linked_program_model)

    L = MAIN_LANES
    vm, inst_s, start_s = linked_vm()
    args = linked_args(L)
    t0 = time.perf_counter()
    want = linked_program_model(*args)
    model_s = time.perf_counter() - t0
    steps = 8 + 35 * args[0]

    def check(res):
        got = res.results[0].astype(np.int64) & 0xFFFFFFFF
        if not (res.trap == -1).all() or not (got == want).all() or \
                not (res.retired == steps).all():
            fail(f"linked x {L}: traps {sorted(set(res.trap.tolist()))}, "
                 f"{int((got != want).sum())} lanes off the model, "
                 f"{int((res.retired != steps).sum())} off 8 + 35 n retired")

    # a few lanes at small n on the host's scalar engine, against the
    # card at the same (n, k) and the model
    small = [np.arange(LINKED_SAMPLE) * 7 + 30,
             np.arange(LINKED_SAMPLE) * 513]
    host = [int(vm.execute("run", [int(small[0][i]), int(small[1][i])])[0])
            & 0xFFFFFFFF for i in range(LINKED_SAMPLE)]
    card = vm.execute_batch("run", small, lanes=LINKED_SAMPLE,
                            max_steps=10**9)
    if host != (card.results[0].astype(np.int64) & 0xFFFFFFFF).tolist() or \
            host != linked_program_model(*small).tolist():
        fail(f"linked at small n: VM.execute {host}, execute_batch "
             f"{card.results[0].tolist()}")
    need = ("interp", "block", "window")
    run = run_main(vm, "run", args, 1 << 20, need)
    check(run[0])
    retired = int(run[0].retired.astype(np.int64).sum())
    label = (f"linked program x {L}, n {LINKED_N0} + (lane % 8) "
             f"{LINKED_N1}")
    rec = report_main(f"{label}, equal to the numpy model, "
                      f"{retired / L:.4g} instr a lane", run, retired)
    check_uniform(rec, "linked program", False)
    rec["profile"] = profile_run(vm, "run", args, retired)
    rec["careful"] = careful_run(vm, "run", args, 1 << 20, need, check,
                                 label)
    rec.update(instantiate_s=inst_s, start_s=start_s, model_s=model_s,
               sample_lanes=LINKED_SAMPLE)
    # gas: the budget of lane group 3, exactly
    limit = int(steps[3])
    vmg, ginst_s, gstart_s = linked_vm(cost_measuring=True,
                                       cost_limit=limit)
    start_cost = vmg.statistics().total_cost
    if not 0 < start_cost < limit:
        fail(f"linked gas: the start function cost {start_cost}, the "
             f"limit {limit}")
    grun = run_main(vmg, "run", args, 1 << 20, need)
    res = grun[0]
    group = np.arange(L) % 8
    got = res.results[0].astype(np.int64) & 0xFFFFFFFF
    done, out = group <= 3, group >= 4
    cost_trap = int(ErrCode.CostLimitExceeded)
    if not ((res.trap[done] == -1).all() and (got[done] == want[done]).all()
            and (res.retired[group == 3] == limit).all()
            and (res.trap[out] == cost_trap).all()
            and (res.retired[out] == limit + 1).all()):
        fail(f"linked gas (limit {limit}): traps by group "
             f"{[sorted(set(res.trap[group == g].tolist())) for g in range(8)]}"
             f", retired by group "
             f"{[sorted(set(res.retired[group == g].tolist())) for g in range(8)]}")
    gretired = int(res.retired.astype(np.int64).sum())
    grec = report_main(f"linked program x {L} with gas, cost_limit {limit} "
                       f"(group 3's instructions): groups 0-3 finish, 4-7 "
                       f"trap CostLimitExceeded at limit + 1", grun,
                       gretired)
    grec.update(cost_limit=limit, start_cost=start_cost,
                instantiate_s=ginst_s, start_s=gstart_s,
                finished=int((res.trap == -1).sum()),
                cost_limit_traps=int((res.trap == cost_trap).sum()))
    rec["gas"] = grec
    print(f"  linked: instantiate {inst_s:.4f} s (start function "
          f"{start_s:.4f} s on the host), numpy model {model_s:.2f} s, "
          f"{LINKED_SAMPLE} lanes at small n equal on host and card; gas: "
          f"start function cost {start_cost}, {grec['finished']} lanes "
          f"finished, {grec['cost_limit_traps']} CostLimitExceeded",
          flush=True)
    return rec


def phase_scalar_corpus() -> dict:
    """The 23 files of tests/spec through the port's scalar harness
    (spec.run_corpus: the scalar engine on this machine's host, every
    command kind, the stateful files included), one file at a time, each
    to its count in SCALAR_CORPUS_COUNTS with 0 failed and 0 skipped."""
    from wasmedge_tpu_torch.spec import SCALAR_CORPUS_COUNTS, run_corpus

    t0 = time.perf_counter()
    per_file = {}
    for name in sorted(SCALAR_CORPUS_COUNTS):
        rep = run_corpus([os.path.join(SPEC_DIR, name)])
        per_file[name] = (rep.passed, rep.failed, rep.skipped)
        if per_file[name] != (SCALAR_CORPUS_COUNTS[name], 0, 0):
            for f in rep.failures[:10]:
                print(f"  {f}", flush=True)
            fail(f"{name} on the scalar harness: {per_file[name]}, "
                 f"expected ({SCALAR_CORPUS_COUNTS[name]}, 0, 0)")
    wall = time.perf_counter() - t0
    total = sum(v[0] for v in per_file.values())
    print(f"spec corpus (23 files) on the host's scalar engine: {total} "
          f"passed, 0 failed, 0 skipped, wall {wall:.3f} s", flush=True)
    return dict(passed=total, failed=0, skipped=0, files=len(per_file),
                wall_s=wall)


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
        interp.clear_counts()
        # each lane's memory its own random words: no warp is uniform
        t, out_k = time_opt_and_careful(eng, ceng, st0, chunk,
                                        f"bulk pair {name}", refused=False,
                                        uniform=False)
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


# ---------------------------------------------------------------------------
# Multi-tenant images and serving (BASELINE config 5)
# ---------------------------------------------------------------------------
# bench_multi.py:27-47: four tenants of MIX_LANES lanes, stacks 256 / 256
MIX_KNOBS = dict(value_stack_depth=256, call_stack_depth=256,
                 steps_per_launch=1 << 20)
MIX_LANES = {"fib": 1024, "fac": 1024, "loop_sum": 1024, "coremark": 1024}
MIX_N = {"fib": 30, "fac": 20, "loop_sum": 16_000_000, "coremark": 262_144}
# the straddling variant: lane counts off the warp size, so that three
# warps hold lanes of two modules, at a smaller depth
STRADDLE_LANES = {"fib": 1021, "fac": 1029, "loop_sum": 1011,
                  "coremark": 1035}
STRADDLE_N = {"fib": 25, "fac": 20, "loop_sum": 1_000_000,
              "coremark": 16_384}
# the serving run: a MultiModuleBatchEngine over the four modules at
# MAIN_LANES lanes, SERVE_REQUESTS seeded requests over four tenants
SERVE_REQUESTS = 16_384
SERVE_CHUNK = 65_536
SERVE_WEIGHTS = {"t0": 1, "t1": 1, "t2": 2, "t3": 4}
SERVE_QUOTAS = {"t0": 512}
# the kernel jobs' mix: small arguments, lane counts off the warp size
MIX_JOB_LANES = {"fib": 61, "fac": 67, "loop_sum": 59, "coremark": 69}
MIX_JOB_CHUNK = 997
MIX_RECORDS = {}  # kernel job records of the concatenated image


def mix_module(name: str) -> bytes:
    from wasmedge_tpu_torch import models

    return getattr(models, {"coremark": "build_coremark_kernel"}.get(
        name, f"build_{name}"))()


def mix_conf(**knobs):
    from wasmedge_tpu_torch.common.configure import Configure, Proposal

    conf = Configure()
    conf.add_proposal(Proposal.TailCall)
    for k, v in dict(MIX_KNOBS, **knobs).items():
        setattr(conf.batch, k, v)
    return conf


def mix_instance(data: bytes, conf):
    """(instance, store) of module bytes under `conf`."""
    from wasmedge_tpu_torch.executor import Executor
    from wasmedge_tpu_torch.loader import Loader
    from wasmedge_tpu_torch.runtime.store import StoreManager
    from wasmedge_tpu_torch.validator import Validator

    store = StoreManager()
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    return Executor(conf).instantiate(store, mod), store


def mix_tenants(conf, specs, device="cuda") -> list:
    """Tenants (each its own BatchEngine) of `specs`: [(module bytes,
    export, args, lanes)]."""
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.batch.multitenant import Tenant

    out = []
    for data, func, args, lanes in specs:
        inst, store = mix_instance(data, conf)
        out.append(Tenant(BatchEngine(inst, store=store, conf=conf,
                                      lanes=lanes, device=device),
                          func, list(args), lanes))
    return out


def config5_specs(lanes: dict, ns: dict) -> list:
    """The config-5 tenants' specs: every lane of a tenant one call with
    its argument."""
    from wasmedge_tpu_torch.models.fixtures import CONFIG5

    return [(mix_module(name), func, [np.full(lanes[name], ns[name],
                                              np.int64)], lanes[name])
            for name, func, _ in CONFIG5]


def mix_engine(specs, device="cuda", fusion=None, **knobs):
    """A MultiTenantBatchEngine over `specs` ([(module bytes, export,
    args, lanes)]) with the knobs set, its encoding replaced by `fusion`
    where it is given (make_engine's counterpart)."""
    from wasmedge_tpu_torch.batch.interp import device_tables
    from wasmedge_tpu_torch.batch.multitenant import MultiTenantBatchEngine

    conf = mix_conf(**knobs)
    eng = MultiTenantBatchEngine(mix_tenants(conf, specs, device), conf=conf,
                                 device=device)
    if fusion is not None:
        eng.fusion = fusion
        eng.tables = device_tables(eng.img, eng.device, fusion,
                                   mem_window=eng.mem_window,
                                   optimistic=eng.optimistic,
                                   stack_depth=eng.cfg.value_stack_depth)
    return eng


def model_cells(model, res, args) -> bool:
    """Whether a config-5 result equals its numpy model (fac's i64 cell
    whole, the others' i32 cells as unsigned words)."""
    from wasmedge_tpu_torch.models.fixtures import fac_model

    got = np.asarray(res, np.int64)
    if model is not fac_model:
        got = got & 0xFFFFFFFF
    return bool((got == model(args)).all())


def warp_deltas(warps, before) -> dict:
    """Per-warp counters of a run: `warps` now minus `before` (a copy
    taken before the run)."""
    return {k: (v - before[k]).cpu().numpy().astype(np.int64)
            for k, v in warps.counters().items() if k != "snap"}


def warp_counters(warps) -> dict:
    return {k: v.clone() for k, v in warps.counters().items()}


def b3_by_tenant(d: dict, lanes: dict) -> dict:
    """B3 entries by tenant (the warps wholly inside its lanes; `lanes`
    maps each tenant's name to its lane count, in lane order) and of the
    warps that hold lanes of two tenants ("mixed"): warps, uniform
    entries, all entries and rollbacks."""
    names = list(lanes)
    bounds = np.cumsum([0] + list(lanes.values()))
    owner = []
    for w in range(d["entered"].shape[0]):
        first, last = (int(np.searchsorted(bounds, x, "right")) - 1
                       for x in (32 * w, min(32 * w + 32, bounds[-1]) - 1))
        owner.append(names[first] if first == last else "mixed")
    out = {}
    for key in names + ["mixed"]:
        sel = np.array([o == key for o in owner])
        if sel.any():
            out[key] = dict(warps=int(sel.sum()),
                            uniform=int(d["uniform"][sel].sum()),
                            entered=int(d["entered"][sel].sum()),
                            rollbacks=int(d["rollbacks"][sel].sum()))
    return out


def mix_case(label: str, lanes: dict, ns: dict, in_image: bool = False
             ) -> dict:
    """One config-5 mix through the user's entry points: each tenant
    alone on its own BatchEngine (its lanes, run(), the defaults: B2
    blocks, windows where it has a memory, optimistic), equal to the numpy
    model; then the four as one concatenated image through `run_mixed`
    with the defaults, each tenant's results, trap and retired equal to
    its solo run (its wall includes run_mixed's engine set-up); the mix
    again with `optimistic` False.  Each is profiled on a
    MultiTenantBatchEngine built by hand over the solo tenants (the same
    image and build), whose per-warp B3 counters give the entries by
    tenant.  `in_image`: each tenant once more alone through the
    concatenated image (the others at 0 lanes), timed by events."""
    from wasmedge_tpu_torch.batch.multitenant import (
        MultiTenantBatchEngine, Tenant, run_mixed)
    from wasmedge_tpu_torch.models.fixtures import CONFIG5

    conf = mix_conf()
    specs = config5_specs(lanes, ns)
    tenants = mix_tenants(conf, specs)
    solo, rec = {}, {"lanes": dict(lanes), "n": dict(ns)}
    for t, (name, func, model) in zip(tenants, CONFIG5):
        def run(t=t, func=func):
            return t.engine.run(func, t.args_lanes, max_steps=10**9)

        w0 = warp_counters(t.engine.warps)
        res, counts, wall, ev_ms = counted(f"{label} {name} alone", run,
                                           ("interp", "block"))
        d = warp_deltas(t.engine.warps, w0)
        if not (res.trap == -1).all() or \
                not model_cells(model, res.results[0], t.args_lanes[0]):
            fail(f"{label} {name}({ns[name]}) alone: traps "
                 f"{sorted(set(res.trap.tolist()))}, not the model")
        retired = int(res.retired.astype(np.int64).sum())
        prof = profile_fn(f"{label} {name} alone", run, retired)[1]
        solo[name] = res
        UNCOMPACTED.setdefault(label, []).append(res)
        rec[name] = dict(retired=retired, launches=counts["interp"],
                         wall_s=wall, event_ms=ev_ms,
                         kernel_ms=prof["kernel_ms"],
                         instr_per_s_wall=retired / wall,
                         instr_per_s_kernel=prof["instr_per_s_kernel"],
                         uniform=int(d["uniform"].sum()),
                         entered=int(d["entered"].sum()),
                         rollbacks=int(d["rollbacks"].sum()))
        print(f"  {label} {name}({ns[name]}) x {lanes[name]} alone: retired "
              f"{retired}, {counts['interp']} launches, kernel "
              f"{prof['kernel_ms']:.1f} ms, wall {wall:.3f} s, "
              f"{retired / wall:.4g} instr/s over wall, "
              f"{prof['instr_per_s_kernel']:.4g} over kernel; B3 entries "
              f"{rec[name]['uniform']} uniform of {rec[name]['entered']}, "
              f"{rec[name]['rollbacks']} rollbacks", flush=True)
    if in_image:
        # each tenant alone through the concatenated image's build (the
        # others at 0 lanes): the build's cost, apart from sharing it
        for k, (name, _, _) in enumerate(CONFIG5):
            only = [t if i == k else Tenant(t.engine, t.func_name,
                                            [np.zeros(0, np.int64)], 0)
                    for i, t in enumerate(tenants)]
            mt = MultiTenantBatchEngine(only, conf=conf, device="cuda")
            res, counts, wall, ev_ms = counted(
                f"{label} {name} alone in the image",
                lambda mt=mt: mt.run_tenants(max_steps=10**9),
                ("interp", "block"))
            if not np.array_equal(res[k].results[0], solo[name].results[0]):
                fail(f"{label} {name} alone in the image: not its solo run")
            rec[name].update(in_image_launches=counts["interp"],
                             in_image_event_ms=ev_ms, in_image_wall_s=wall)
            print(f"  {label} {name} alone in the concatenated image: "
                  f"{counts['interp']} launches, events {ev_ms:.1f} ms "
                  f"(alone on its own build: {rec[name]['event_ms']:.1f})",
                  flush=True)
    for opt in (None, False):
        mconf = mix_conf(optimistic=opt)
        rspecs = [(*mix_instance(data, mconf), func, args, n)
                  for data, func, args, n in specs]
        need = ("interp", "block", "window") + \
            (("optimistic",) if opt is None else ())

        def same_as_solo(res, how):
            for r, (name, _, _) in zip(res, CONFIG5):
                s = solo[name]
                if not (np.array_equal(r.trap, s.trap)
                        and np.array_equal(r.retired, s.retired)
                        and np.array_equal(r.results[0], s.results[0])):
                    fail(f"{label}, optimistic {opt}, {how}: tenant {name} "
                         f"differs from its solo run")

        res, counts, wall, ev_ms = counted(
            label, lambda: run_mixed(rspecs, mconf, 10**9, device="cuda"),
            need)
        if counts["window"] != counts["interp"] or \
                counts["optimistic"] != (counts["interp"] if opt is None
                                         else 0):
            fail(f"{label}: {counts['window']} window and "
                 f"{counts['optimistic']} optimistic launches of "
                 f"{counts['interp']}")
        same_as_solo(res, "run_mixed")
        retired = int(sum(r.retired.astype(np.int64).sum() for r in res))
        mt = MultiTenantBatchEngine(tenants, conf=mconf, device="cuda")
        w0 = warp_counters(mt.warps) if mt.warps is not None else None
        pres, prof = profile_fn(
            label, lambda: mt.run_tenants(max_steps=10**9), retired)
        same_as_solo(pres, "profiled")
        key = "mix" if opt is None else "mix_careful"
        rec[key] = dict(retired=retired, launches=counts["interp"],
                        block_launches=counts["block"],
                        window_launches=counts["window"],
                        optimistic_launches=counts["optimistic"],
                        wall_s=wall, event_ms=ev_ms,
                        kernel_ms=prof["kernel_ms"],
                        idle_share=prof["idle_share"],
                        profiled_wall_s=prof["wall_s"],
                        profiled_launches=prof["launches"],
                        instr_per_s_wall=retired / wall,
                        instr_per_s_kernel=prof["instr_per_s_kernel"],
                        build=fused_build(mt.tables))
        if w0 is not None:
            rec[key]["b3"] = b3_by_tenant(warp_deltas(mt.warps, w0), lanes)
        print(f"  {label} x {sum(lanes.values())}, one concatenated image "
              f"through run_mixed [{mt.tables.fusion}, windows, "
              f"{'optimistic' if opt is None else 'careful'}]: every tenant "
              f"equal to its solo run; retired {retired}, "
              f"{counts['interp']} launches, wall {wall:.3f} s, "
              f"{retired / wall:.4g} instr/s over wall; profiled: kernel "
              f"{prof['kernel_ms']:.1f} ms, "
              f"{prof['instr_per_s_kernel']:.4g} instr/s over kernel, idle "
              f"share {prof['idle_share']:.4f} of {prof['wall_s']:.3f} s; "
              f"build "
              f"{rec[key]['build']}; B3 by tenant {rec[key].get('b3')}",
              flush=True)
    return rec


def phase_main_mix() -> dict:
    """BASELINE config 5 at MAIN_LANES lanes (each tenant also alone in
    the concatenated image) and its straddling variant (mix_case each)."""
    return {"config5": mix_case("config 5", MIX_LANES, MIX_N, True),
            "straddle": mix_case("straddling mix", STRADDLE_LANES,
                                 STRADDLE_N)}


SERVED = {}  # the futures' results of serving runs, by key


def serve_once(profile: bool, compact: bool = False, key=None,
               faults=None, ckdir=None, every_rounds=None) -> dict:
    """One serving run: BatchServer(engine=MultiModuleBatchEngine(the four
    config-5 modules, MAIN_LANES lanes)), SERVE_CHUNK steps a launch,
    SERVE_REQUESTS seeded requests (serve_load) over four tenants with
    SERVE_WEIGHTS and SERVE_QUOTAS, all submitted, then run_until_idle.
    Every future equal to its model, every request completed.  With
    `profile`, under torch.profiler (the kernel's device time); with
    `compact`, lane compaction on (the server's boundary pass, the default
    knobs), its figures and its rounds' host ms in the record.  `key`
    keeps the futures' results in SERVED; `faults`, `ckdir` and
    `every_rounds` give the server a FaultInjector, a checkpoint
    directory and a cadence (the record then has its retries, failures
    and seam counts)."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.batch.multitenant import MultiModuleBatchEngine
    from wasmedge_tpu_torch.models.fixtures import (
        CONFIG5, serve_load, serve_model)
    from wasmedge_tpu_torch.serve import BatchServer

    conf = mix_conf(steps_per_launch=SERVE_CHUNK, compact=compact)
    conf.serve.checkpoint_every_rounds = every_rounds
    conf.serve.backoff_base_s = 0.0
    modules = [(name, *mix_instance(mix_module(name), conf))
               for name, _, _ in CONFIG5]
    eng = MultiModuleBatchEngine(modules, conf=conf, lanes=MAIN_LANES)
    srv = BatchServer(engine=eng, weights=SERVE_WEIGHTS, quotas=SERVE_QUOTAS,
                      faults=faults, checkpoint_dir=ckdir)
    if compact != (srv._compactor is not None):
        fail(f"serving: compact {compact}, compactor {srv._compactor}")
    load = serve_load(SERVE_REQUESTS, SEED)

    def drive():
        t_sub, futs = [], []
        for tenant, func, n in load:
            t_sub.append(time.monotonic())
            futs.append(srv.submit(func, [n], tenant=tenant))
        return futs, t_sub, srv.run_until_idle()

    if profile:
        prof = profile_fn("serving", drive, None)[1]
        return dict(kernel_ms=prof["kernel_ms"], wall_s=prof["wall_s"],
                    launches=prof["launches"])
    (futs, t_sub, rounds), counts, wall, ev_ms = counted(
        "serving", drive, ("interp", "block", "window", "optimistic"))
    c = srv.counters
    if c["completed"] != SERVE_REQUESTS or c["killed"] or c["trapped"]:
        fail(f"serving: counters {c}")
    got = np.array([f.result(0)[0] for f in futs], np.int64)
    if key is not None:
        SERVED[key] = got
    funcs = np.array([f for _, f, _ in load])
    ns = np.array([n for _, _, n in load], np.int64)
    for name, func, model in CONFIG5:
        sel = funcs == f"{name}:{func}"
        if not model_cells(model, got[sel], ns[sel]):
            fail(f"serving: {int(sel.sum())} {name} requests, some off "
                 f"the model")
    lat = np.array([f.t_done - t for f, t in zip(futs, t_sub)])
    stats = eng.warps.stats()
    rec = dict(requests=SERVE_REQUESTS, rounds=rounds,
               fused_key=interp.fused_kernel_key(eng.tables),
               recycled_lanes=c["recycled_lanes"],
               retired=c["retired_instructions"], wall_s=wall,
               event_ms=ev_ms, launches=counts["interp"],
               block_launches=counts["block"],
               window_launches=counts["window"],
               optimistic_launches=counts["optimistic"],
               requests_per_s=SERVE_REQUESTS / wall,
               latency_p50_ms=float(np.percentile(lat, 50)) * 1e3,
               latency_p99_ms=float(np.percentile(lat, 99)) * 1e3,
               instr_per_s_wall=c["retired_instructions"] / wall,
               uniform=int(eng.warps.uniform.sum()), **stats,
               admitted_by_tenant={t: sum(1 for _, tt, _ in srv.admissions
                                          if tt == t)
                                   for t in SERVE_WEIGHTS},
               counters=dict(c))
    if faults is not None:
        rec.update(retries=srv.retries,
                   failures=[f.fault_class for f in srv.failures],
                   seams=dict(faults.counts),
                   lineage=[m.steps for m in srv._lineage.members])
    if compact:
        if not srv._compactor.stats["fires"]:
            fail("serving with compaction: no permutation fired")
        rec.update(compact=compact_numbers(srv._compactor),
                   compact_round_ms=srv.compact_s * 1e3)
    return rec


def phase_serve() -> dict:
    """The serving run (serve_once), then the same run profiled: the
    kernel's share of that run's wall (1 - its idle share)."""
    rec = serve_once(False)
    prof = serve_once(True)
    rec.update(kernel_ms=prof["kernel_ms"], profiled_wall_s=prof["wall_s"],
               kernel_share=prof["kernel_ms"] / 1e3 / prof["wall_s"])
    print(f"  serving x {MAIN_LANES} lanes, {SERVE_REQUESTS} requests over "
          f"4 modules and 4 tenants (weights {SERVE_WEIGHTS}, quotas "
          f"{SERVE_QUOTAS}), {SERVE_CHUNK} steps a launch: every future "
          f"equal to its model; {rec['rounds']} rounds, "
          f"{rec['launches']} launches, {rec['recycled_lanes']} recycled "
          f"lanes, wall {rec['wall_s']:.3f} s, "
          f"{rec['requests_per_s']:.1f} requests/s, latency p50 "
          f"{rec['latency_p50_ms']:.1f} ms, p99 {rec['latency_p99_ms']:.1f}"
          f" ms, {rec['instr_per_s_wall']:.4g} retired instr/s over wall, "
          f"kernel {rec['kernel_ms']:.1f} ms ({rec['kernel_share']:.3f} of "
          f"the profiled run's wall, {rec['profiled_wall_s']:.3f} s), B3 "
          f"entries {rec['uniform']} uniform of "
          f"{rec['entered']}, {rec['rollbacks']} rollbacks; admitted by "
          f"tenant {rec['admitted_by_tenant']}", flush=True)
    return rec


def mix_job_specs(name: str) -> list:
    """The kernel jobs' concatenated images: "config5" the four modules at
    MIX_JOB_LANES lanes and small lane-dependent arguments; "c10" two
    memory.grow tenants whose memories declare max 1 and max 4."""
    from wasmedge_tpu_torch.models.fixtures import (
        C10_MAX_PAGES, CONFIG5, build_grow_tenant)

    if name == "c10":
        d = np.arange(40, dtype=np.int64) % 6
        return [(build_grow_tenant(m), "g", [d], 40) for m in C10_MAX_PAGES]
    top = {"fib": 11, "fac": 21, "loop_sum": 120, "coremark": 24}
    return [(mix_module(n), f, [np.arange(MIX_JOB_LANES[n], dtype=np.int64)
                                % top[n]], MIX_JOB_LANES[n])
            for n, f, _ in CONFIG5]


def mix_job_knobs(name: str) -> dict:
    from wasmedge_tpu_torch.models.fixtures import C10_PAGES_PER_LANE

    kn = dict(MIX_KNOBS, steps_per_launch=MIX_JOB_CHUNK)
    if name == "c10":
        kn["memory_pages_per_lane"] = C10_PAGES_PER_LANE
    return kn


def serve_state_vs_plain(name: str, echo: bool = False) -> int:
    """A serving state just after an install round, kernel against plain:
    a BatchServer over the four config-5 modules at KERNEL_LANES lanes
    (small arguments) fills every lane and steps three rounds, then
    installs a few more requests into the lowest freed lanes (idle
    TRAP_DONE lanes beside them); one launch from that state through the
    kernel and through the plain version (a copy on the card), every
    plane equal, and the kernel's windows written back at the last
    launch's exit (the install wrote the plane).  With `echo`, the
    gateway's generation 2 at the gateway phase's shape: its five modules
    through the gateway's registry under the gateway's conf (echo's
    stdout sunk, every fifth request echo's) at MAIN_LANES lanes, so the
    fused build is the gateway phase's (`main` holds the keys
    equal); the rounds before the install run the gateway's
    SERVE_CHUNK-step launches, the compared launch MIX_JOB_CHUNK steps
    (the plain version's time grows with the steps).  Returns the max
    abs err."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.batch.multitenant import MultiModuleBatchEngine
    from wasmedge_tpu_torch.batch.optimistic import WarpState
    from wasmedge_tpu_torch.models.fixtures import CONFIG5, serve_load
    from wasmedge_tpu_torch.serve import BatchServer

    if echo:
        lanes, conf = MAIN_LANES, gateway_conf()
        reg = gateway_registry(True, conf)
        eng = reg.build_engine(conf, lanes)
    else:
        lanes, conf = KERNEL_LANES, mix_conf(steps_per_launch=MIX_JOB_CHUNK)
        modules = [(n, *mix_instance(mix_module(n), conf))
                   for n, _, _ in CONFIG5]
        eng = MultiModuleBatchEngine(modules, conf=conf, lanes=lanes)
    srv = BatchServer(engine=eng)
    load = serve_load(lanes + lanes // 8, SEED, ranges={
        "fib": (3, 14), "fac": (1, 20), "loop_sum": (1, 400),
        "coremark": (1, 40)})
    if echo:
        load = [("t0", "echo:echo", k % 6) if k % GW_ECHO_EVERY == 0
                else r for k, r in enumerate(load)]
    # every lane busy, three rounds (lanes retire and park), then the
    # last eighth of the requests into the lowest freed lanes
    for t, f, n in load[:lanes]:
        srv.submit(f, [n], tenant=t)
    for _ in range(3):
        srv.step()
    for t, f, n in load[lanes:]:
        srv.submit(f, [n], tenant=t)
    with srv._lock:
        installed = srv._admit(time.monotonic())
    st = srv.state
    idle = int((st.trap == -1).sum())
    ref = st.clone()
    interp.run_chunk(eng.tables, st, MIX_JOB_CHUNK, False,
                     WarpState.new(eng.lanes, eng.device))
    interp_ref.run_chunk(eng.tables, ref, MIX_JOB_CHUNK, False,
                         WarpState.new(eng.lanes, eng.device))
    torch.cuda.synchronize()
    err = max_abs_err(st, ref)
    if err or not installed or not idle:
        fail(f"{name}: after an install round of {installed} lanes beside "
             f"{idle} idle ones, kernel != plain: max abs err {err}")
    MIX_RECORDS[name] = dict(lanes=lanes, installed=installed, idle=idle,
                             err=err)
    if echo:
        MIX_RECORDS[name].update(
            key=interp.fused_kernel_key(eng.tables),
            hostcall_lanes=int((st.trap == -2).sum()))
        if not MIX_RECORDS[name]["hostcall_lanes"]:
            fail(f"{name}: no echo lane parked at its host call")
    print(f"kernel_vs_plain {name}: {installed} lanes installed beside "
          f"{idle} idle TRAP_DONE lanes, one launch equal", flush=True)
    return err


def mix_jobs() -> list:
    """The concatenated image's kernel jobs, each with the plain version
    on the card: config 5's four modules at small size and the C10 pair,
    each in blocks and per op (kernel_vs_plain: both memory modes,
    optimistic with the careful kernel beside it), and a launch from a
    serving state after an install round.  The config-5 jobs are the
    longest of the kernel phase, so run_jobs starts them first."""
    jobs = [("kernel_vs_plain", (f"mix.{n}", mix_job_specs(n), None, None,
                                 MIX_JOB_CHUNK, None, mix_job_knobs(n)),
             dict(fusion=f, lanes=None, plain_on_card=True))
            for n in ("config5", "c10") for f in ("none", "blocks")]
    return jobs + [("serve_state_vs_plain", ("mix.serve_state",), {}),
                   ("serve_state_vs_plain", ("mix.gateway_generation2",),
                    dict(echo=True))]


def mix_builds() -> list:
    """The tables (CPU) of the concatenated image's builds: config 5's
    (the main path, the straddling variant, the serving engine and the
    kernel jobs) and the C10 pair's (its kernel jobs), each in B2 blocks,
    optimistic and careful, windows and direct; and the solo tenants'
    (blocks, optimistic, their memory mode)."""
    out = [mix_engine(mix_job_specs(n), device="cpu", fusion="blocks",
                      optimistic=opt, mem_hbm=m, **mix_job_knobs(n)).tables
           for n in ("config5", "c10") for opt in (None, False)
           for m in (None, False)]
    conf = mix_conf()
    out += [t.engine.tables for t in mix_tenants(
        conf, config5_specs(dict.fromkeys(MIX_N, 2), MIX_N), "cpu")]
    return out


# Lane compaction (batch/compact.py) on the card.  UNCOMPACTED holds the
# uncompacted runs of the main path the compacted ones are held to: the
# divergent fib mix (phase_main) and each config-5 mix's solo tenants
# (mix_case), by label.
UNCOMPACTED = {}
NARROW_WIDTHS = (64, 1024)  # the narrowed kernel jobs' launch widths
NARROW_STEPS = 128


def compact_numbers(comp) -> dict:
    """A compactor's figures: its stats, the width of each launch (runs
    of equal widths as [width, launches]), its narrowed launches, the
    gathers' ms and the boundaries' host ms."""
    runs = []
    for w in comp.widths:
        if runs and runs[-1][0] == w:
            runs[-1][1] += 1
        else:
            runs.append([w, 1])
    return dict(comp.stats, widths=runs,
                narrowed=sum(1 for w in comp.widths if w < comp.lanes),
                permute_ms=comp.permute_ms, boundary_host_ms=comp.host_s * 1e3)


def narrow_vs_plain(name, fusion, optimistic, width) -> int:
    """A narrowed launch, kernel against plain: fib(10 + lane % 11) x
    MAIN_LANES (stacks 256, fib's main-path builds), two launches of
    NARROW_STEPS steps over the first `width` lanes, the plain side on a
    copy on the card with its own per-warp state.  Every lane is live, so
    the lanes at and beyond `width` would run if launched: both sides
    must leave them bit-unchanged.  Every plane and the per-warp state
    equal after each launch.  Returns the max abs err."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.models import build_fib

    L = MAIN_LANES
    eng, inst = make_engine(build_fib(), L, fusion=fusion,
                            optimistic=optimistic, value_stack_depth=256,
                            call_stack_depth=256)
    st = eng.initial_state(inst.exports["fib"][1],
                           [10 + np.arange(L) % 11])
    st0, ref = st.clone(), st.clone()
    wk, wp = new_warps(eng), new_warps(eng)
    before = dict(interp.LAUNCHES)
    worst = 0
    for launch in range(2):
        interp.run_chunk(eng.tables, st, NARROW_STEPS, False, wk,
                         width=width)
        interp_ref.run_chunk(eng.tables, ref, NARROW_STEPS, False, wp,
                             width=width)
        torch.cuda.synchronize()
        err = max(max_abs_err(st, ref), warp_err(wk, wp))
        beyond = max(int((a[..., width:].to(torch.int64)
                          - b[..., width:].to(torch.int64)).abs().max())
                     for a, b in zip(st.planes().values(),
                                     st0.planes().values()))
        worst = max(worst, err, beyond)
        if err or beyond:
            fail(f"{name} launch {launch}: kernel != plain (max abs err "
                 f"{err}) or a lane at or beyond width {width} changed "
                 f"({beyond})")
    moved = int((st.retired[:width] != 0).sum())
    ran = {k: interp.LAUNCHES[k] - before[k] for k in before}
    if moved != width or ran["narrow"] != 2 or ran["interp"] != 2 or \
            ran["optimistic"] != (2 if eng.tables.optimistic else 0):
        fail(f"{name}: {moved} of {width} lanes ran, launches {ran}")
    print(f"kernel_vs_plain {name}: 2 launches of width {width} of {L} "
          f"equal, the {L - width} lanes beyond untouched, warps "
          f"{wk.stats() if wk is not None else {}}", flush=True)
    return worst


def permuted_vs_plain(name, fusion, optimistic, mem_hbm) -> int:
    """A launch right after a permutation, kernel against plain: the
    CoreMark-style kernel x MAIN_LANES at lane-dependent sizes (stacks
    256, one page a lane), launches through the kernel until a boundary
    of a compactor with the policy held open fires (its permutation
    moving lanes whose windows were written back at the last launch's
    exit), then one
    launch through the kernel and through the plain version (a copy on
    the card; the per-warp state copied too): every plane, the per-warp
    state and, with the windows, the misses and ways written back equal.
    Returns the max abs err."""
    from wasmedge_tpu_torch.batch import interp, interp_ref, memwin
    from wasmedge_tpu_torch.batch.compact import LaneCompactor
    from wasmedge_tpu_torch.batch.optimistic import WarpState
    from wasmedge_tpu_torch.models import build_coremark_kernel
    from wasmedge_tpu_torch.models.fixtures import COMPACT_FORCED

    L = MAIN_LANES
    eng, inst = make_engine(build_coremark_kernel(), L, fusion=fusion,
                            optimistic=optimistic, mem_hbm=mem_hbm,
                            value_stack_depth=256, call_stack_depth=256,
                            **COMPACT_FORCED)
    if eng.tables.mem_window != bool(mem_hbm):
        fail(f"{name}: mem_window {eng.tables.mem_window}")
    st = eng.initial_state(inst.exports["coremark"][1],
                           [1 + (np.arange(L) * 7919) % 13])
    wk = new_warps(eng)
    comp = LaneCompactor(eng)
    plan = None
    for _ in range(8):   # kernel launches until the lanes part ways
        interp.run_chunk(eng.tables, st, NARROW_STEPS, False, wk)
        plan = comp.plan_boundary(eng, st)
        if plan is not None:
            break
    if plan is None:
        fail(f"{name}: no boundary fired")
    comp.permute_state(st, plan[1])
    moved = comp.stats["moved_lanes"]
    ref = st.clone()
    wp = None if wk is None else WarpState(
        **{f: getattr(wk, f).clone() for f in WarpState.COUNTERS},
        snap_max=wk.snap_max)
    torch.cuda.synchronize()
    interp.clear_counts()
    memwin.clear_counts()
    interp.run_chunk(eng.tables, st, NARROW_STEPS, False, wk)
    interp_ref.run_chunk(eng.tables, ref, NARROW_STEPS, False, wp)
    torch.cuda.synchronize()
    err = max(max_abs_err(st, ref), warp_err(wk, wp))
    if eng.tables.mem_window:
        wc = interp.window_counts(eng.tables, clear=True)
        if (wc["misses"], wc["ways_written_back"]) != (
                memwin.COUNTS["misses"], memwin.COUNTS["ways_written_back"]):
            fail(f"{name}: window counts kernel {wc}, plain "
                 f"{memwin.COUNTS}")
        WINDOW_WORST[0] = max(WINDOW_WORST[0], err)
    if err or not moved:
        fail(f"{name}: after a permutation of {moved} lanes, kernel != "
             f"plain: max abs err {err}")
    print(f"kernel_vs_plain {name}: a launch after a permutation of {moved} "
          f"of {L} lanes equal, traps "
          f"{sorted(set(st.trap.cpu().tolist()))}", flush=True)
    return err


def compact_jobs() -> list:
    """The compaction kernel jobs: narrowed launches (widths 64 and 1024
    of MAIN_LANES) per op and in B2, optimistic and careful; a launch
    right after a permutation in both memory modes (B2 optimistic, per
    op careful)."""
    jobs = [("narrow_vs_plain",
             (f"narrow.fib{mode_tag(f, None)}, {'kOpt' if o is None else 'careful'}, width {w}",
              f, o, w), {})
            for f in ("none", "blocks") for o in (None, False)
            for w in NARROW_WIDTHS]
    jobs += [("permuted_vs_plain",
              (f"permuted.coremark{mode_tag(f, m)}, "
               f"{'kOpt' if o is None else 'careful'}", f, o, m), {})
             for f, o in (("blocks", None), ("none", False))
             for m in (True, False)]
    return jobs


def phase_compact_fib_mix() -> dict:
    """The divergent fib mix fib(20 + lane % 11) x MAIN_LANES (stacks 256,
    2^20 steps a launch, B2 blocks, optimistic) through VM.execute_batch
    with compaction on (the default knobs) and once more with
    compact_narrow False; results, trap and retired equal to phase_main's
    uncompacted run of the same call and to the Python fib table; each
    profiled."""
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.models import build_fib
    from wasmedge_tpu_torch.vm.vm import VM

    L = MAIN_LANES
    conf = Configure()
    conf.batch.lanes = L
    conf.batch.value_stack_depth = 256
    conf.batch.call_stack_depth = 256
    conf.batch.compact = True
    vm = VM(conf)
    vm.load_wasm(build_fib())
    vm.validate()
    vm.instantiate()
    ns = 20 + np.arange(L) % 11
    off = UNCOMPACTED["fib_mix"][0]
    out = {}
    for narrow in (True, False):
        vm.conf.batch.compact_narrow = narrow
        run = run_main(vm, "fib", [ns], 1 << 20, ("interp", "block"))
        res = run[0]
        if not (np.array_equal(res.results[0], off.results[0])
                and np.array_equal(res.trap, off.trap)
                and np.array_equal(res.retired, off.retired)):
            fail(f"compacted fib mix (narrow {narrow}) differs from the "
                 f"uncompacted run")
        comp = vm.last_engine.compactor
        if comp is None or not comp.stats["fires"]:
            fail(f"compacted fib mix (narrow {narrow}): no permutation")
        if (run[4]["narrow"] > 0) != narrow or \
                run[4]["narrow"] != sum(w < L for w in comp.widths):
            fail(f"compacted fib mix (narrow {narrow}): "
                 f"{run[4]['narrow']} narrowed launches, widths "
                 f"{comp.widths}")
        retired = int(res.retired.astype(np.int64).sum())
        key = "on" if narrow else "on_no_narrow"
        rec = report_main(f"fib(20 + lane % 11) x {L}, compaction on, "
                          f"compact_narrow {narrow}, equal to the "
                          f"uncompacted run", run, retired)
        rec["compact"] = compact_numbers(comp)
        rec["narrow_launches"] = run[4]["narrow"]
        rec["profile"] = profile_run(vm, "fib", [ns], retired)
        print(f"  compaction: {json.dumps(rec['compact'])}", flush=True)
        out[key] = rec
    return out


def phase_compact_straddle() -> dict:
    """The straddling config-5 mix through run_mixed with compaction on
    (the default knobs): each tenant's results, trap and retired equal to
    its solo run of mix_case (to which the uncompacted mix was held);
    profiled on a MultiTenantBatchEngine built by hand over the same
    tenants, whose compactor and per-warp counters give the figures."""
    from wasmedge_tpu_torch.batch.multitenant import (
        MultiTenantBatchEngine, run_mixed)
    from wasmedge_tpu_torch.models.fixtures import CONFIG5

    label = "straddling mix"
    mconf = mix_conf(compact=True)
    specs = config5_specs(STRADDLE_LANES, STRADDLE_N)
    rspecs = [(*mix_instance(data, mconf), func, args, n)
              for data, func, args, n in specs]
    solo = UNCOMPACTED[label]

    def same(res, how):
        for r, s, (name, _, _) in zip(res, solo, CONFIG5):
            if not (np.array_equal(r.trap, s.trap)
                    and np.array_equal(r.retired, s.retired)
                    and np.array_equal(r.results[0], s.results[0])):
                fail(f"{label} compacted, {how}: tenant {name} differs "
                     f"from its uncompacted run")

    res, counts, wall, ev_ms = counted(
        f"{label}, compacted",
        lambda: run_mixed(rspecs, mconf, 10**9, device="cuda"),
        ("interp", "block", "window", "optimistic"))
    same(res, "run_mixed")
    retired = int(sum(r.retired.astype(np.int64).sum() for r in res))
    mt = MultiTenantBatchEngine(mix_tenants(mconf, specs), conf=mconf,
                                device="cuda")
    w0 = warp_counters(mt.warps)
    pres, prof = profile_fn(f"{label}, compacted",
                            lambda: mt.run_tenants(max_steps=10**9), retired)
    same(pres, "profiled")
    d = warp_deltas(mt.warps, w0)
    rec = dict(retired=retired, launches=counts["interp"],
               block_launches=counts["block"],
               narrow_launches=counts["narrow"], wall_s=wall,
               event_ms=ev_ms, kernel_ms=prof["kernel_ms"],
               idle_share=prof["idle_share"],
               profiled_wall_s=prof["wall_s"],
               instr_per_s_wall=retired / wall,
               instr_per_s_kernel=prof["instr_per_s_kernel"],
               uniform=int(d["uniform"].sum()),
               entered=int(d["entered"].sum()),
               rollbacks=int(d["rollbacks"].sum()),
               compact=compact_numbers(mt.compactor))
    print(f"  {label} x {sum(STRADDLE_LANES.values())} compacted through "
          f"run_mixed: every tenant equal to its uncompacted run; "
          f"{counts['interp']} launches ({counts['narrow']} narrowed), wall "
          f"{wall:.3f} s, {retired / wall:.4g} instr/s over wall; "
          f"profiled: kernel {prof['kernel_ms']:.1f} ms, "
          f"{prof['instr_per_s_kernel']:.4g} instr/s over kernel; B3 "
          f"entries {rec['uniform']} uniform of {rec['entered']}, "
          f"{rec['rollbacks']} rollbacks; compaction "
          f"{json.dumps(rec['compact'])}", flush=True)
    return rec


def phase_compact_checkpoint() -> dict:
    """Checkpoint round trips (batch/checkpoint.py) on the card: the
    compacted fib mix driven launch by launch until a boundary has
    permuted the lanes (lane_src not the identity), saved, loaded into a
    fresh engine with compaction on, finished, its results (in lane
    order) equal to the uncompacted run's; config 2's coremark(65536)
    saved after its first launch, loaded into a fresh engine, finished,
    every lane equal to the Python reference.  The files go to a
    temporary directory; their bytes and the save and load seconds are
    printed."""
    from wasmedge_tpu_torch.batch import checkpoint
    from wasmedge_tpu_torch.batch.compact import arm
    from wasmedge_tpu_torch.models import build_coremark_kernel, build_fib

    L = MAIN_LANES
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as d:
        def round_trip(key, engine_of, func, args, until, want):
            eng = engine_of()
            comp = arm(eng)
            st, total = eng.initial_state(eng.export_func_idx(func),
                                          args), 0
            while not until(eng, st):
                st, total = eng.run_from_state(st, total, total + 1)
            path = os.path.join(d, f"{key}.npz")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save(path, eng, st, total)
            save_s = time.perf_counter() - t0
            eng2 = engine_of()
            arm(eng2)
            t0 = time.perf_counter()
            st2, total2 = checkpoint.load(path, eng2)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            if total2 != total or (comp is not None and not np.array_equal(
                    eng2.compactor.src, comp.src)):
                fail(f"checkpoint {key}: total or lane_src not restored")
            st2, total2 = eng2.run_from_state(st2, total2, 10**9)
            lo = st2.stack_lo[0].cpu().numpy()
            order = None if eng2.compactor is None \
                else eng2.compactor.restore_order()
            got = lo if order is None else lo[order]
            if not (st2.trap == -1).all() or \
                    not np.array_equal(got.astype(np.int64) & 0xFFFFFFFF,
                                       np.asarray(want) & 0xFFFFFFFF):
                fail(f"checkpoint {key}: the resumed run differs")
            out[key] = dict(bytes=os.path.getsize(path), save_s=save_s,
                            load_s=load_s, total_at_save=total,
                            lane_src=comp is not None and not comp.identity)
            print(f"  checkpoint {key}: saved at step {total} "
                  f"({'lane_src journaled' if out[key]['lane_src'] else 'no lane_src'}), "
                  f"{out[key]['bytes']} B, save {save_s:.3f} s, load "
                  f"{load_s:.3f} s; the resumed run equals the "
                  f"uninterrupted one", flush=True)

        def fib_engine():
            return make_engine(build_fib(), L, value_stack_depth=256,
                               call_stack_depth=256,
                               steps_per_launch=1 << 20, compact=True)[0]

        off = UNCOMPACTED["fib_mix"][0]
        round_trip("fib_mix", fib_engine, "fib", [20 + np.arange(L) % 11],
                   lambda e, st: not e.compactor.identity,
                   off.results[0])

        def coremark_engine():
            return make_engine(build_coremark_kernel(), L,
                               steps_per_launch=1 << 20, **MEM_STACKS)[0]

        round_trip("coremark", coremark_engine, "coremark",
                   [np.full(L, MEM_COREMARK_N)],
                   lambda e, st: bool((st.retired != 0).any()),
                   np.full(L, coremark_py(MEM_COREMARK_N)))
        out["stdout_cursor"] = stdout_cursor_round_trip(d)
    return out


# the stdout cursor's round trip: lanes, steps per launch, and the step
# counts at which it saves and at which it restores
CURSOR_LANES = 64
CURSOR_CHUNK = 40
CURSOR_STEPS = (40, 120)


def stdout_cursor_round_trip(d) -> dict:
    """The exactly-once stdout cursor (ROADMAP C11) on the card: a tier-0
    echo batch (echo's main-path build: blocks, windows, optimistic; 3-6
    iterations a lane, CURSOR_LANES lanes) run to a launch boundary (its
    records flushed), saved, run on (more records flushed), restored from
    the checkpoint and finished; the same on the plain version; and both
    again with lane compaction forced on (COMPACT_FORCED: the cursor moves
    with the lanes, after the restore too).  Each record is printed once
    (the bytes are every lane's messages, the uninterrupted count), the
    card's bytes, journaled `stdout_pos` and final planes equal the plain
    version's, and the restore replayed flushed records (the high-water
    mark above the restored position)."""
    from wasmedge_tpu_torch.batch import checkpoint
    from wasmedge_tpu_torch.batch.compact import arm
    from wasmedge_tpu_torch.batch.hostcall import _stdout_cursor
    from wasmedge_tpu_torch.models import build_echo
    from wasmedge_tpu_torch.models.fixtures import COMPACT_FORCED
    from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE
    from wasmedge_tpu_torch.vm.vm import make_engine as vm_engine

    L = CURSOR_LANES
    iters = 3 + np.arange(L) % 4
    calls = int(2 * iters.sum())

    def run(dev, compact):
        tag = f"{dev}_{'compact' if compact else 'plain'}"
        path = os.path.join(d, f"echo_{tag}.out")
        ck = os.path.join(d, f"echo_{tag}.npz")
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
        try:
            vm = wasi_vm(build_echo(), fd)
            vm.conf.batch.lanes = L
            vm.conf.batch.steps_per_launch = CURSOR_CHUNK
            for k, v in (COMPACT_FORCED if compact else {}).items():
                setattr(vm.conf.batch, k, v)
            eng = vm_engine(vm._active, vm.store, vm.conf, device=dev)
            comp = arm(eng)
            st = eng.initial_state(eng.export_func_idx("echo"), [iters])
            st, total = eng.run_from_state(st, 0, CURSOR_STEPS[0])
            checkpoint.save(ck, eng, st, total)
            st, total = eng.run_from_state(st, total, CURSOR_STEPS[1])
            st, total = checkpoint.load(ck, eng)
            pos, hw = _stdout_cursor(eng, L)
            replay = int((hw - pos).sum())
            st, total = eng.run_from_state(st, total, 10**9)
            cur = np.concatenate(_stdout_cursor(eng, L))
        finally:
            os.close(fd)
        with np.load(ck) as z:
            spos = np.asarray(z["stdout_pos"])
        with open(path, "rb") as f:
            moved = 0 if comp is None else comp.stats["moved_lanes"]
            return f.read(), replay, spos, on_cpu(st), moved, cur

    out = {}
    for compact in (False, True):
        kind = "compacted" if compact else "uncompacted"
        (got, replay, spos, st, moved, cur) = run("cuda", compact)
        flushes = check_flushes(f"stdout cursor, {kind}")
        (want, _, wpos, wst, _, wcur) = run("cpu", compact)
        err = max_abs_err(st, wst)
        if got != want or len(got) != calls * len(ECHO_MESSAGE) or \
                got.count(ECHO_MESSAGE) != calls or replay <= 0 or \
                not np.array_equal(spos, wpos) or err != 0 or \
                not np.array_equal(cur, wcur) or flushes == 0 or \
                (compact and moved == 0):
            fail(f"stdout cursor, {kind}: card {len(got)} B, plain "
                 f"{len(want)} B, {calls} records of {len(ECHO_MESSAGE)} B "
                 f"expected, replayed {replay} B, stdout_pos equal "
                 f"{np.array_equal(spos, wpos)}, max abs err {err}, "
                 f"{moved} lanes moved")
        print(f"  checkpoint stdout cursor, {kind}: echo x {L} saved at "
              f"step {CURSOR_STEPS[0]}, restored after step "
              f"{CURSOR_STEPS[1]}: {replay} B replayed below the high-water "
              f"mark and skipped, {len(got)} B printed ({calls} records "
              f"once), {moved} lane moves, equal to the plain version; "
              f"{flushes} flushes of the flush kernel held against the "
              f"plain version, the cursor after the run equal", flush=True)
        out[kind] = dict(bytes=len(got), records=calls,
                         replayed_bytes=replay, moved_lanes=moved,
                         max_abs_err=err, flushes_checked=flushes)
    return out


def phase_compact(main_out: dict) -> dict:
    """Lane compaction on the main path: the divergent fib mix, the
    straddling config-5 mix and serving with compaction on, beside the
    same call's uncompacted runs, and the checkpoint round trips."""
    out = {"fib_mix": phase_compact_fib_mix(),
           "straddle": phase_compact_straddle()}
    srv = serve_once(False, compact=True, key="compacted")
    prof = serve_once(True, compact=True)
    srv.update(kernel_ms=prof["kernel_ms"], profiled_wall_s=prof["wall_s"],
               kernel_share=prof["kernel_ms"] / 1e3 / prof["wall_s"])
    base = main_out["serve"]
    print(f"  serving compacted: {srv['rounds']} rounds, "
          f"{srv['recycled_lanes']} recycled lanes, wall "
          f"{srv['wall_s']:.3f} s, {srv['requests_per_s']:.1f} requests/s, "
          f"latency p50 {srv['latency_p50_ms']:.1f} ms, p99 "
          f"{srv['latency_p99_ms']:.1f} ms, kernel {srv['kernel_ms']:.1f} "
          f"ms ({srv['kernel_share']:.3f} of {srv['profiled_wall_s']:.3f} "
          f"s), B3 entries {srv['uniform']} uniform of {srv['entered']}, "
          f"{srv['rollbacks']} rollbacks; compaction "
          f"{json.dumps(srv['compact'])}, its rounds "
          f"{srv['compact_round_ms']:.1f} ms of host time | uncompacted "
          f"(phase serve): {base['rounds']} rounds, wall "
          f"{base['wall_s']:.3f} s, {base['requests_per_s']:.1f} "
          f"requests/s, p50 {base['latency_p50_ms']:.1f} ms, p99 "
          f"{base['latency_p99_ms']:.1f} ms, kernel {base['kernel_ms']:.1f} "
          f"ms, B3 {base['uniform']} / {base['entered']}, "
          f"{base['rollbacks']} rollbacks", flush=True)
    out["serve"] = srv
    out["checkpoint"] = phase_compact_checkpoint()
    return out


# ---------------------------------------------------------------------------
# Supervision (batch/supervisor.py, serve/server.py) on the card
# ---------------------------------------------------------------------------
# the fib mix: a checkpoint every SUP_CADENCE steps (4 launches of 1 << 20),
# the fault at launch SUP_FAULT_AT (after the checkpoints at 4 and 8
# launches), the demotion's max_retries + 1 faults from launch
# SUP_DEMOTE_AT (right after the checkpoint at 20 launches), the poisoned
# lanes' two faults from launch SUP_POISON_AT
SUP_FIB_BASE = 20           # the mix: fib(SUP_FIB_BASE + lane % 11)
SUP_FIB_CHUNK = 1 << 20     # its steps a launch, as phase_main runs it
SUP_CADENCE = 4 * SUP_FIB_CHUNK
SUP_FAULT_AT = 10
SUP_DEMOTE_AT = 20
SUP_POISON_AT = 12
SUP_POISON_LANES = (0, 11)
# CoreMark: 8192 steps a launch, a checkpoint every four (each save of
# its page plane took about 2 s on the card), the fault at launch 8 (after
# the checkpoints at 32,768 and 65,536 steps)
SUP_CM_CHUNK = 8192
SUP_CM_CADENCE = 4 * SUP_CM_CHUNK
SUP_CM_FAULT_AT = 8
# serving: a checkpoint every 32 rounds, the fault at launch 40
SUP_SERVE_ROUNDS = 32
SUP_SERVE_FAULT_AT = 40


class CheckpointTimes:
    """Wraps batch/checkpoint.py's save and load (the supervisor and the
    server call them through the module) while active: each call's kind,
    file, steps, milliseconds (the device synchronized before and
    after), bytes and end time (perf_counter)."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        from wasmedge_tpu_torch.batch import checkpoint

        self._mod = checkpoint
        self._save, self._load = checkpoint.save, checkpoint.load

        def timed(kind, fn):
            def call(path, *a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                ok = False
                try:
                    out = fn(path, *a, **k)
                    torch.cuda.synchronize()
                    ok = True
                    return out
                finally:
                    end = time.perf_counter()
                    m = re.search(r"(\d+)\.npz$", os.fspath(path))
                    self.rows.append(dict(
                        kind=kind, file=os.path.basename(path), ok=ok,
                        steps=int(m.group(1)) if m else None,
                        ms=(end - t) * 1e3, end=end,
                        bytes=os.path.getsize(path)
                        if os.path.exists(path) else 0))
            return call

        checkpoint.save = timed("save", self._save)
        checkpoint.load = timed("load", self._load)
        return self

    def __exit__(self, *exc):
        self._mod.save, self._mod.load = self._save, self._load

    def summary(self) -> dict:
        out = {}
        for kind in ("save", "load"):
            rows = [r for r in self.rows if r["kind"] == kind and r["ok"]]
            out[kind] = dict(n=len(rows),
                             ms=[round(r["ms"], 3) for r in rows],
                             bytes=[r["bytes"] for r in rows])
        out["refused"] = [r["file"] for r in self.rows if not r["ok"]]
        return out


def sup_fault(point, at, times=1, lanes=(), before=None, log=None):
    """A Fault whose exception is made by a factory that notes the
    arrival's context (the step total) and time in `log`."""
    from wasmedge_tpu_torch.testing.faults import Fault, InjectedFault

    def exc(ctx):
        if log is not None:
            log.append(dict(total=ctx.get("total"), t=time.perf_counter()))
        return InjectedFault(ctx["point"], ctx["index"], lanes=lanes)
    return Fault(point=point, at=at, times=times, lanes=lanes,
                 before=before, exc=exc)


def member_steps(path) -> int:
    return int(re.search(r"(\d+)\.npz$", path).group(1))


def same_result(label, res, want):
    """Fail unless `res` equals `want` in results, traps and retired."""
    if not all(np.array_equal(a, b) for a, b in
               zip(res.results, want.results)) or \
            not np.array_equal(res.trap, want.trap) or \
            not np.array_equal(res.retired, want.retired):
        fail(f"{label}: differs from the unsupervised run (traps "
             f"{np.unique(res.trap)}, results differ on "
             f"{int((res.results[0] != want.results[0]).sum())} lanes)")


def phase_supervise(main_out: dict) -> dict:
    """Supervised runs at MAIN_LANES lanes (module docstring, phase 3),
    each against its unsupervised counterpart of this call."""
    from wasmedge_tpu_torch.batch.supervisor import BatchSupervisor
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.common.errors import ErrCode
    from wasmedge_tpu_torch.models import build_coremark_kernel, build_fib
    from wasmedge_tpu_torch.testing.faults import (
        FaultInjector, corrupt_checkpoint)
    from wasmedge_tpu_torch.vm.vm import VM, make_engine as vm_engine

    L = MAIN_LANES
    out = {}
    ns = (SUP_FIB_BASE + np.arange(L) % 11).astype(np.int64)
    want = UNCOMPACTED["fib_mix"][0]
    base = main_out["fib_mix"]
    conf = Configure()
    conf.batch.lanes = L
    conf.batch.value_stack_depth = 256
    conf.batch.call_stack_depth = 256
    conf.batch.steps_per_launch = SUP_FIB_CHUNK
    conf.supervisor.checkpoint_every_steps = SUP_CADENCE
    conf.supervisor.backoff_base_s = 0.0
    vm = VM(conf)
    vm.load_wasm(build_fib())
    vm.validate()
    vm.instantiate()
    root = tempfile.mkdtemp(prefix="chip-smoke-sup-")

    def supervised(label, faults, ckdir, need=("interp", "block"), **knobs):
        """One supervised fib mix run on a fresh engine of the VM's
        instance: (supervisor, result, wall s, counts, checkpoint
        times)."""
        old = {k: getattr(vm.conf.supervisor, k) for k in knobs}
        for k, v in knobs.items():
            setattr(vm.conf.supervisor, k, v)
        try:
            eng = vm_engine(vm._active, vm.store, vm.conf)
            sup = BatchSupervisor(eng, stats=vm.statistics(),
                                  faults=FaultInjector(faults),
                                  checkpoint_dir=ckdir)
            with CheckpointTimes() as ck:
                res, counts, wall, _ = counted(
                    label, lambda: sup.run("fib", [ns], max_steps=10**9),
                    need)
        finally:
            for k, v in old.items():
                setattr(vm.conf.supervisor, k, v)
        print(f"  {label}: wall {wall:.3f} s ({base['wall_s']:.3f} s "
              f"unsupervised), {counts['interp']} launches, incidents "
              f"{[(f.fault_class, f.lanes) for f in sup.failures]}, "
              f"checkpoints {json.dumps(ck.summary())}", flush=True)
        return sup, res, wall, counts, ck

    # 1. one launch fault after the second checkpoint
    log = []
    d1 = os.path.join(root, "fib")
    sup, res, wall, counts, ck = supervised(
        f"supervised fib({SUP_FIB_BASE} + lane % 11) x {L}, one launch "
        f"fault",
        [sup_fault("launch", SUP_FAULT_AT, log=log)], d1)
    same_result("the supervised fib mix", res, want)
    restored = member_steps(sup._restored_from)
    if [f.fault_class for f in sup.failures] != ["launch"] or \
            restored != 2 * SUP_CADENCE:
        fail(f"supervised fib mix: incidents {sup.failures}, restored from "
             f"{sup._restored_from}")
    out["fib_mix"] = dict(
        wall_s=wall, unsupervised_wall_s=base["wall_s"],
        launches=counts["interp"], unsupervised_launches=base["launches"],
        fault_at_steps=log[0]["total"], restored_steps=restored,
        replayed_steps=log[0]["total"] - restored,
        checkpoints=ck.summary())
    saves1 = {r["steps"]: r["end"] for r in ck.rows if r["kind"] == "save"}
    end1 = time.perf_counter()

    # 2. max_retries + 1 faults in a row: the per-op rung finishes from
    # the newest member
    retries = vm.conf.supervisor.max_retries
    sup, res, wall, counts, ck = supervised(
        f"supervised fib mix x {L}, {retries + 1} faults in a row "
        f"(demoted)", [sup_fault("launch", SUP_DEMOTE_AT, retries + 1)],
        os.path.join(root, "demote"))
    mono_end = time.monotonic()
    same_result("the demoted fib mix", res, want)
    demote = [f for f in sup.failures if f.fault_class == "demote"]
    adopted = member_steps(sup._restored_from)
    op_launches = counts["interp"] - counts["block"] - counts["super"]
    if sup.tier != "cuda_unfused" or len(demote) != 1 or \
            sup.engine.tables.fusion != "none" or not op_launches:
        fail(f"demoted fib mix: rung {sup.tier}, incidents "
             f"{[f.fault_class for f in sup.failures]}")
    # the per-op rung's time (from the demotion's record, its adoption of
    # the newest member included, to the end) against run 1's time in
    # blocks over the same steps (from its save at `adopted` to its end)
    unfused_s = mono_end - demote[0].mono_s
    out["demote"] = dict(
        wall_s=wall, launches=counts["interp"],
        op_launches=op_launches,
        block_launches=counts["block"], adopted_steps=adopted,
        final_steps=int(res.steps), unfused_span_s=unfused_s,
        blocks_span_s=end1 - saves1[adopted] if adopted in saves1 else None,
        checkpoints=ck.summary())

    # 3. lanes 0 and 11 poisoned: terminated, since under an engine on
    # the card no lane is re-run on the host; every other lane equal
    sup, res, wall, counts, ck = supervised(
        f"supervised fib mix x {L}, lanes {SUP_POISON_LANES} poisoned",
        [sup_fault("launch", SUP_POISON_AT, 2, SUP_POISON_LANES)],
        os.path.join(root, "poison"), poison_lane_retries=2)
    others = np.setdiff1d(np.arange(L), SUP_POISON_LANES)
    poisoned = np.asarray(SUP_POISON_LANES)
    if not all(np.array_equal(a[others], b[others])
               for a, b in zip(res.results, want.results)) or \
            not np.array_equal(res.trap[others], want.trap[others]) or \
            not np.array_equal(res.retired[others], want.retired[others]):
        fail("the fib mix with poisoned lanes: the other lanes differ "
             "from the unsupervised run")
    if not (res.trap[poisoned] == int(ErrCode.Terminated)).all():
        fail(f"poisoned lanes: traps {res.trap[poisoned]}, expected "
             f"Terminated")
    poison = [f for f in sup.failures if f.fault_class == "poison_lane"]
    if len(poison) != 1 or poison[0].lanes != SUP_POISON_LANES or \
            poison[0].tier != "cuda":
        fail(f"poisoned lanes: incidents {sup.failures}")
    out["poison"] = dict(wall_s=wall, launches=counts["interp"],
                         checkpoints=ck.summary())

    # 4. another process's supervisor: VM.execute_batch resumes run 1's
    # lineage
    with CheckpointTimes() as ck:
        res, counts, wall, _ = counted(
            "resumed fib mix", lambda: vm.execute_batch(
                "fib", [ns], max_steps=10**9, supervised=True, resume=True,
                checkpoint_dir=d1), ("interp", "block"))
    same_result("the resumed fib mix", res, want)
    loads = [r for r in ck.rows if r["kind"] == "load"]
    if len(loads) != 1 or not loads[0]["ok"]:
        fail(f"resume: loads {loads}")
    out["resume"] = dict(wall_s=wall, launches=counts["interp"],
                         adopted_steps=loads[0]["steps"],
                         checkpoints=ck.summary())
    print(f"  resumed fib mix (VM.execute_batch(supervised=True, "
          f"resume=True)): from step {loads[0]['steps']}, "
          f"{counts['interp']} launches, wall {wall:.3f} s, equal",
          flush=True)

    # 5. coremark(COREMARK_N) with windows: the newest member corrupted
    # before the fault, the lineage falls back
    conf_cm = Configure()
    conf_cm.batch.lanes = L
    conf_cm.batch.value_stack_depth = 256
    conf_cm.batch.call_stack_depth = 256
    conf_cm.batch.memory_pages_per_lane = 1
    conf_cm.batch.steps_per_launch = SUP_CM_CHUNK
    conf_cm.supervisor.checkpoint_every_steps = SUP_CM_CADENCE
    conf_cm.supervisor.backoff_base_s = 0.0
    vm_cm = VM(conf_cm)
    vm_cm.load_wasm(build_coremark_kernel())
    vm_cm.validate()
    vm_cm.instantiate()
    args = [np.full(L, COREMARK_N)]
    need = ("interp", "block", "window")
    cm_want, counts0, wall0, _ = counted(
        "coremark, unsupervised", lambda: vm_cm.execute_batch(
            "coremark", args, max_steps=10**9), need)
    if not (cm_want.trap == -1).all() or not (
            (cm_want.results[0] & 0xFFFFFFFF) == coremark_py(COREMARK_N)
    ).all():
        fail(f"coremark({COREMARK_N}) x {L}: off the Python reference")
    d_cm = os.path.join(root, "coremark")

    def corrupt_newest():
        newest = sorted(f for f in os.listdir(d_cm) if f.endswith(".npz"))
        if len(newest) < 2:
            fail("coremark: the fault fired before two checkpoints")
        corrupt_checkpoint(os.path.join(d_cm, newest[-1]), mode="truncate")

    eng = vm_engine(vm_cm._active, vm_cm.store, vm_cm.conf)
    sup = BatchSupervisor(eng, faults=FaultInjector([sup_fault(
        "launch", SUP_CM_FAULT_AT, before=corrupt_newest)]),
        checkpoint_dir=d_cm)
    with CheckpointTimes() as ck:
        res, counts, wall, _ = counted(
            "supervised coremark", lambda: sup.run(
                "coremark", args, max_steps=10**9), need)
    same_result("the supervised coremark", res, cm_want)
    classes = [f.fault_class for f in sup.failures]
    if classes != ["launch", "checkpoint"] or \
            member_steps(sup._restored_from) != SUP_CM_CADENCE:
        fail(f"supervised coremark: incidents {classes}, restored from "
             f"{sup._restored_from}")
    out["coremark"] = dict(wall_s=wall, unsupervised_wall_s=wall0,
                           launches=counts["interp"],
                           unsupervised_launches=counts0["interp"],
                           restored_steps=SUP_CM_CADENCE,
                           checkpoints=ck.summary())
    print(f"  supervised coremark({COREMARK_N}) x {L} [windows], "
          f"{SUP_CM_CHUNK} steps a launch, the newest member corrupted: "
          f"wall {wall:.3f} s ({wall0:.3f} s unsupervised), "
          f"{counts['interp']} launches ({counts0['interp']}), incidents "
          f"{classes}, restored from step {SUP_CM_CADENCE}; checkpoints "
          f"{json.dumps(ck.summary())}", flush=True)

    # 6. the compacted serving run with a cadence and one launch fault
    with CheckpointTimes() as ck:
        inj = FaultInjector([sup_fault("launch", SUP_SERVE_FAULT_AT)])
        rec = serve_once(False, compact=True, key="supervised", faults=inj,
                         ckdir=os.path.join(root, "serve"),
                         every_rounds=SUP_SERVE_ROUNDS)
    if not np.array_equal(SERVED["supervised"], SERVED["compacted"]):
        fail("supervised serving: futures differ from the unfaulted run's")
    if rec["failures"] != ["launch"] or rec["seams"].get(
            "checkpoint_load") != 1:
        fail(f"supervised serving: {rec['failures']}, seams {rec['seams']}")
    base_srv = main_out["compact"]["serve"]
    out["serve"] = dict(wall_s=rec["wall_s"],
                        unsupervised_wall_s=base_srv["wall_s"],
                        rounds=rec["rounds"],
                        unsupervised_rounds=base_srv["rounds"],
                        launches=rec["launches"], retries=rec["retries"],
                        lineage=rec["lineage"], checkpoints=ck.summary())
    print(f"  supervised serving x {L} (compacted), a checkpoint every "
          f"{SUP_SERVE_ROUNDS} rounds, one launch fault: every future equal "
          f"to the unfaulted run's; wall {rec['wall_s']:.3f} s "
          f"({base_srv['wall_s']:.3f} s), {rec['rounds']} rounds "
          f"({base_srv['rounds']}), checkpoints "
          f"{json.dumps(ck.summary())}", flush=True)
    d = out["demote"]
    print(f"  supervision: fib mix replayed {out['fib_mix']['replayed_steps']}"
          f" steps after its fault; demoted rung {d['unfused_span_s']:.3f} s "
          f"for steps [{d['adopted_steps']}, {d['final_steps']}] per op "
          f"against {d['blocks_span_s'] or 0:.3f} s in blocks (run 1)",
          flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return out


# The HTTP gateway (gateway/) on the card: generation 1 is config 5's four
# modules at MAIN_LANES lanes under the serving run's knobs (its fused build
# is phase_serve's), generation 2 the same four and the WASI echo module
# (its build queued first in the background by prebuild)
GW_REQUESTS = 4096      # config-5 requests before and across the swap
GW_AFTER = 1024         # requests over all five modules after the swap
GW_ECHO_EVERY = 5       # every fifth request after the swap is echo's
GW_CLIENTS = 64         # client threads
GW_SWAP_AT = GW_REQUESTS // 4   # requests sent when the echo POST starts
GW_KILL_LANES = 512
GW_KILL_REQUESTS = 512
GW_KILL_CADENCE = 4     # the kill gateway's serve checkpoint every N rounds


def gateway_conf(**serve):
    """The gateway's template: the serving run's Configure."""
    conf = mix_conf(steps_per_launch=SERVE_CHUNK)
    for k, v in serve.items():
        setattr(conf.serve, k, v)
    return conf


def gateway_modules(echo: bool) -> list:
    """(name, bytes) of generation 1 (config 5, in CONFIG5 order) or 2
    (and echo)."""
    from wasmedge_tpu_torch.models import build_echo
    from wasmedge_tpu_torch.models.fixtures import CONFIG5

    out = [(name, mix_module(name)) for name, _, _ in CONFIG5]
    return out + [("echo", build_echo())] if echo else out


def gateway_registry(echo: bool, conf, device="cuda"):
    """A ModuleRegistry holding a generation's modules (stdout sunk)."""
    from wasmedge_tpu_torch.gateway.registry import ModuleRegistry

    reg = ModuleRegistry(conf=conf, device=device)
    for name, data in gateway_modules(echo):
        reg.add_wasm(name, data, source="boot")
    return reg


def gateway_builds() -> list:
    """The tables (CPU) of generation 2's build: the same source as the
    gateway's, since the generated source depends on the modules and the
    knobs only."""
    reg = gateway_registry(True, gateway_conf(), device="cpu")
    tables = reg.build_engine(gateway_conf(), 2).tables
    reg.close()
    return [tables]


def gateway_load(n: int, seed: int, echo: bool) -> list:
    """[(tenant, module, func, n, async)]: serve_load's seeded stream, every
    GW_ECHO_EVERY-th request echo's with `echo`, every other one async."""
    from wasmedge_tpu_torch.models.fixtures import serve_load

    out = []
    for k, (tenant, qual, arg) in enumerate(serve_load(n, seed)):
        module, _, func = qual.partition(":")
        if echo and k % GW_ECHO_EVERY == 0:
            module, func, arg = "echo", "echo", k % 8
        out.append((tenant, module, func, arg, k % 2 == 1))
    return out


def gateway_model(module: str, func: str, args) -> np.ndarray:
    """Each request's expected result cell (echo: its last errno, 0)."""
    from wasmedge_tpu_torch.models.fixtures import serve_model

    if module == "echo":
        return np.zeros(len(args), np.int64)
    want = serve_model(f"{module}:{func}", np.asarray(args, np.int64))
    return np.asarray(want, np.int64)


def http_call(host, port, method, path, body=None, headers=None,
              timeout=300.0):
    """(status, JSON body, headers) of one HTTP call."""
    from http.client import HTTPConnection

    c = HTTPConnection(host, port, timeout=timeout)
    try:
        data = json.dumps(body).encode() if isinstance(body, dict) else body
        c.request(method, path, body=data, headers=headers or {})
        r = c.getresponse()
        raw = r.read()
        hdrs = dict(r.getheaders())
    finally:
        c.close()
    try:
        return r.status, json.loads(raw), hdrs
    except ValueError:
        return r.status, raw, hdrs


class GatewayClient:
    """Sends requests to a gateway (from a pool of threads) and gives, per
    request, a record of its send and answer times (`time.monotonic`, the
    clock of the gateway's own stamps), the status and the body (an async
    request's body is its poll's final answer).  `one` polls its own
    async id right after the 202 and adds `gateway_s`, the gateway's span
    of the request: from `GatewayService.submit` to the future's
    resolution (the rest of the client's time is the HTTP layer's, the
    client's and, for an async id, the poll's)."""

    def __init__(self, gw):
        self.gw = gw

    def send(self, req):
        tenant, module, func, arg, is_async = req
        health = self.gw.service.health(fresh=False)
        if health["status"] == "unhealthy":
            fail(f"gateway unhealthy: {health['checks']}")
        t0 = time.monotonic()
        st, doc, _ = http_call(self.gw.host, self.gw.port, "POST",
                               "/v1/invoke", {"module": module, "func": func,
                                              "args": [arg], "tenant": tenant,
                                              "async": is_async})
        t1 = time.monotonic()
        return dict(req=req, t_sent=t0, t_answer=t1, status=st, body=doc)

    def one(self, req):
        rec = self.send(req)
        if rec["status"] == 202:
            self.poll(rec)
        rid = rec["body"].get("request_id") \
            if isinstance(rec["body"], dict) else None
        r = self.gw.service._requests.get(rid)
        if r is not None and r.future.t_done is not None:
            rec["gateway_s"] = r.future.t_done - r.t_recv
        return rec

    def poll(self, rec, timeout_s=300.0):
        """Poll an accepted async request to its end; fails at once when
        the gateway says it is unhealthy (a serving thread died)."""
        rid = rec["body"]["request_id"]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            health = self.gw.service.health(fresh=False)
            if health["status"] == "unhealthy":
                fail(f"gateway unhealthy while request {rid} is pending: "
                     f"{health['checks']}")
            st, doc, _ = http_call(self.gw.host, self.gw.port, "GET",
                                   f"/v1/requests/{rid}")
            if not (isinstance(doc, dict) and doc.get("status") == "pending"):
                rec.update(status=st, body=doc, t_done=time.monotonic())
                return rec
            time.sleep(0.01)
        fail(f"gateway: request {rid} still pending after {timeout_s} s")


def check_gateway_results(label: str, records) -> int:
    """Every request answered 200 and equal to its model; returns the
    count."""
    bad = [r for r in records if r["status"] != 200
           or not r["body"].get("ok")]
    if bad:
        fail(f"{label}: {len(bad)} requests not answered 200 ok, e.g. "
             f"{bad[0]['status']} {bad[0]['body']}")
    by = {}
    for r in records:
        _, module, func, arg, _ = r["req"]
        by.setdefault((module, func), []).append(
            (arg, r["body"]["result"][0]))
    for (module, func), rows in by.items():
        args = np.array([a for a, _ in rows], np.int64)
        got = np.array([g for _, g in rows], np.int64)
        want = gateway_model(module, func, args)
        if module != "fac":
            got, want = got & 0xFFFFFFFF, want & 0xFFFFFFFF
        if not (got == want).all():
            fail(f"{label}: {int((got != want).sum())} {module} requests "
                 f"off the model")
    return len(records)


def phase_gateway_kill_resume(root: str) -> dict:
    """A durable gateway (generation 1's modules at GW_KILL_LANES lanes, a
    serve checkpoint every GW_KILL_CADENCE rounds) takes GW_KILL_REQUESTS
    async requests over HTTP and is killed with requests in flight; a
    GatewayService(resume=True) over its state_dir answers every id with
    its model's value, and /healthz says healthy."""
    from wasmedge_tpu_torch.gateway import Gateway, GatewayService

    d = os.path.join(root, "state")
    conf = gateway_conf(checkpoint_every_rounds=GW_KILL_CADENCE)
    svc = GatewayService(conf=conf, lanes=GW_KILL_LANES, state_dir=d)
    svc.preload(gateway_modules(False))
    gw = Gateway(svc, port=0).start()
    client = GatewayClient(gw)
    load = [(t, m, f, n, True) for t, m, f, n, _ in
            gateway_load(GW_KILL_REQUESTS, SEED + 1, False)]
    with ThreadPoolExecutor(GW_CLIENTS) as pool:
        recs = list(pool.map(client.send, load))
    if any(r["status"] != 202 for r in recs):
        fail("gateway kill: an async request was not accepted")
    # in flight at the kill: wait for a checkpoint, not for the end
    srv = svc.current.server
    deadline = time.monotonic() + 120.0
    while not srv._lineage.members and time.monotonic() < deadline:
        time.sleep(0.01)
    before = dict(srv.counters)
    t0 = time.perf_counter()
    gw.kill()
    kill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc2 = GatewayService(conf=conf, lanes=GW_KILL_LANES, state_dir=d,
                          resume=True)
    resume_s = time.perf_counter() - t0
    gw2 = Gateway(svc2, port=0).start()
    try:
        client2 = GatewayClient(gw2)
        for r in recs:
            client2.poll(r)
        n = check_gateway_results("gateway kill and resume", recs)
        st, health, _ = http_call(gw2.host, gw2.port, "GET", "/healthz")
        if st != 200 or health["status"] != "healthy":
            fail(f"gateway after resume: /healthz {st} {health}")
        c2 = dict(svc2.counters)
        adopted = len(svc2.current.server.adopted)
    finally:
        gw2.shutdown()
    return dict(requests=n, completed_before_kill=before["completed"],
                resumed=c2["resumed"], adopted_in_flight=adopted,
                restarts=c2["restarts"], kill_s=kill_s, resume_s=resume_s,
                health=health["status"])


def phase_gateway(main_out: dict) -> dict:
    """The HTTP gateway on the card (gateway/, imagestore/): generation 1
    (config 5 at MAIN_LANES lanes, its fused key phase_serve's) serves
    GW_REQUESTS seeded requests through real HTTP on 127.0.0.1 from
    GW_CLIENTS client threads, sync and async with polling; after
    GW_SWAP_AT of them a POST of the echo module draws 503 with
    Retry-After (a generation_build fault: the rollback, generation 1
    serving on), the re-POST lowers nothing and swaps in generation 2
    (its kernel built in the timed build) while requests are in flight;
    requests answered before the swap ran on generation 1, which drains
    and shuts down; then GW_AFTER requests over all five modules.  Every
    result equal to its model; the launch counts of the whole traffic.
    Then kill and resume (phase_gateway_kill_resume)."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.gateway import Gateway, GatewayService
    from wasmedge_tpu_torch.testing.faults import Fault, FaultInjector

    card = gpu_name_and_power()
    root = tempfile.mkdtemp(prefix="chip-smoke-gateway-")
    inj = FaultInjector([Fault(point="generation_build", at=1)])
    t0 = time.perf_counter()
    svc = GatewayService(conf=gateway_conf(), lanes=MAIN_LANES, faults=inj)
    svc.preload(gateway_modules(False))
    boot_s = time.perf_counter() - t0
    gen1 = svc.current
    key1 = interp.fused_kernel_key(gen1.engine.tables)
    serve_key = main_out["serve"]["fused_key"]
    print(f"  gateway: generation 1 fused key {key1}, phase_serve's "
          f"{serve_key}", flush=True)
    if key1 != serve_key:
        fail(f"gateway: generation 1's build {key1} is not phase_serve's "
             f"{serve_key}")
    gw = Gateway(svc, port=0).start()
    client = GatewayClient(gw)
    load = gateway_load(GW_REQUESTS, SEED, False)
    after = gateway_load(GW_AFTER, SEED + 2, True)
    echo_bytes = gateway_modules(True)[-1][1]
    swap = {}

    def register():
        # the faulted POST, then the re-POST, while requests are in flight
        lowered = svc.registry.lowered_count
        swap["t_start"] = time.monotonic()
        st, doc, hdrs = http_call(
            gw.host, gw.port, "POST", "/v1/modules?name=echo", echo_bytes,
            {"Content-Type": "application/wasm"})
        if st != 503 or hdrs.get("Retry-After") is None \
                or not doc["err"]["retryable"]:
            fail(f"gateway: the faulted registration answered {st} {doc}")
        swap["rollback"] = dict(status=st, retry_after=hdrs["Retry-After"],
                                generation=svc.generation,
                                lowered=svc.registry.lowered_count - lowered)
        lowered = svc.registry.lowered_count
        t = time.monotonic()
        st, doc, _ = http_call(
            gw.host, gw.port, "POST", "/v1/modules?name=echo", echo_bytes,
            {"Content-Type": "application/wasm"})
        swap["t_done"] = time.monotonic()
        swap["post_s"] = swap["t_done"] - t
        if st != 201 or doc["generation"] != 2:
            fail(f"gateway: the re-POST answered {st} {doc}")
        if svc.registry.lowered_count != lowered:
            fail("gateway: the re-POST lowered the module again")

    for k in interp.LAUNCHES:
        interp.LAUNCHES[k] = 0
    # the traffic's seconds are its two send windows, each from its first
    # send to its last answer (async ids polled by their own clients);
    # the wait for the registration and the drain between them is not
    # traffic
    t0 = time.monotonic()
    with ThreadPoolExecutor(GW_CLIENTS) as pool:
        first = list(pool.map(client.one, load[:GW_SWAP_AT]))
        fut = pool.submit(register)
        rest = list(pool.map(client.one, load[GW_SWAP_AT:]))
        t_rest = time.monotonic()
        fut.result()
        gen2 = svc.current
        # generation 1 drains and shuts down
        deadline = time.monotonic() + 300.0
        while svc.status()["draining_generations"] \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        t_drain = dict(svc.drains).get(1)
        if t_drain is None or gen1.server._thread is not None:
            fail(f"gateway: generation 1 did not drain ({svc.drains})")
        t_late = time.monotonic()
        late = list(pool.map(client.one, after))
        t_end = time.monotonic()
    wall = t_end - t0
    traffic_s = (t_rest - t0) + (t_end - t_late)
    counts = dict(interp.LAUNCHES)
    n = check_gateway_results("gateway", first + rest + late)
    # requests answered before the swap began ran on generation 1, those
    # sent after it on generation 2
    pre = [r for r in first + rest if r["t_answer"] < swap["t_start"]]
    post = [r for r in first + rest + late if r["t_sent"] > swap["t_done"]]
    if any(r["body"]["generation"] != 1 for r in pre) \
            or any(r["body"]["generation"] != 2 for r in post) \
            or not post:
        fail("gateway: a request ran on the wrong generation")
    for k in ("interp", "block", "window", "optimistic", "hostcall"):
        if counts[k] == 0:
            fail(f"gateway: no {k} launch of the CUDA kernel")
    key2 = interp.fused_kernel_key(gen2.engine.tables)
    st, health, _ = http_call(gw.host, gw.port, "GET", "/healthz")
    status = svc.status()
    gw.shutdown()
    every = first + rest + late
    sync = np.array([r["t_answer"] - r["t_sent"]
                     for r in every if not r["req"][4]])
    async_ = np.array([r["t_done"] - r["t_sent"]
                       for r in every if r["req"][4]])
    # the client's time against the gateway's span of the same request:
    # what is left is the HTTP layer's (and the client's, and the poll's)
    spans = [(r.get("t_done", r["t_answer"]) - r["t_sent"], r["gateway_s"],
              r["req"][4]) for r in every if "gateway_s" in r]
    if len(spans) < n // 2:
        fail(f"gateway: only {len(spans)} of {n} requests still in the "
             f"gateway's stash after their answer")

    def split(is_async):
        c = np.array([a for a, _, k in spans if k == is_async])
        g = np.array([b for _, b, k in spans if k == is_async])
        return dict(n=len(c),
                    gateway_p50_ms=float(np.percentile(g, 50)) * 1e3,
                    gateway_p99_ms=float(np.percentile(g, 99)) * 1e3,
                    outside_p50_ms=float(np.percentile(c - g, 50)) * 1e3,
                    outside_share=float((c - g).sum() / c.sum()))

    rec = dict(requests=n, wall_s=wall, traffic_s=traffic_s,
               requests_per_s=n / traffic_s,
               sync_p50_ms=float(np.percentile(sync, 50)) * 1e3,
               sync_p99_ms=float(np.percentile(sync, 99)) * 1e3,
               async_p50_ms=float(np.percentile(async_, 50)) * 1e3,
               async_p99_ms=float(np.percentile(async_, 99)) * 1e3,
               split_sync=split(False), split_async=split(True),
               generation1_key=key1, generation2_key=key2,
               boot_s=boot_s, boot_build_s=gen1.build_s,
               boot_kernel_s=gen1.kernel_s, swap_post_s=swap["post_s"],
               swap_build_s=gen2.build_s, swap_kernel_s=gen2.kernel_s,
               drain_s=t_drain, rollback=swap["rollback"],
               before_swap=len(pre), after_swap=len(post),
               launches=counts["interp"], block_launches=counts["block"],
               window_launches=counts["window"],
               optimistic_launches=counts["optimistic"],
               hostcall_launches=counts["hostcall"],
               health=health["status"], http=status["http"],
               gateway=status["gateway"], card=card)
    if st != 200 or health["status"] != "healthy":
        fail(f"gateway: /healthz {st} {health}")
    ss, sa = rec["split_sync"], rec["split_async"]
    print(f"  gateway x {MAIN_LANES} lanes, {n} HTTP requests from "
          f"{GW_CLIENTS} closed-loop clients (half async, each polled by its "
          f"client) over config 5, then echo too: every result equal to its "
          f"model; {rec['requests_per_s']:.1f} requests/s over the "
          f"{traffic_s:.3f} s of the two send windows ({wall:.3f} s with "
          f"the registration's and the drain's wait), sync "
          f"p50 {rec['sync_p50_ms']:.1f} ms, p99 {rec['sync_p99_ms']:.1f} "
          f"ms, async (to the poll's answer) p50 {rec['async_p50_ms']:.1f} "
          f"ms, p99 {rec['async_p99_ms']:.1f} ms; inside the gateway (submit "
          f"to resolution) sync p50 {ss['gateway_p50_ms']:.1f} / p99 "
          f"{ss['gateway_p99_ms']:.1f} ms, async p50 "
          f"{sa['gateway_p50_ms']:.1f} / p99 {sa['gateway_p99_ms']:.1f} ms; "
          f"outside it (HTTP, client, poll) p50 {ss['outside_p50_ms']:.2f} "
          f"ms sync, {sa['outside_p50_ms']:.2f} ms async, "
          f"{ss['outside_share']:.4f} / {sa['outside_share']:.4f} of the "
          f"clients' time ({ss['n']} + {sa['n']} requests); "
          f"boot {boot_s:.3f} s "
          f"(kernel build {gen1.kernel_s:.3f} s); the faulted POST 503 "
          f"Retry-After {swap['rollback']['retry_after']}, the re-POST "
          f"{swap['post_s']:.3f} s (build {gen2.build_s:.3f} s, of it the "
          f"kernel {gen2.kernel_s:.3f} s), generation 1 drained "
          f"{t_drain:.3f} s after the swap; {len(pre)} requests answered "
          f"before the swap on generation 1, {len(post)} sent after it on "
          f"generation 2; {counts['interp']} launches ({counts['block']} "
          f"B2, {counts['window']} windowed, {counts['optimistic']} "
          f"optimistic, {counts['hostcall']} with the host-call handler); "
          f"{card}", flush=True)
    rec["kill_resume"] = kr = phase_gateway_kill_resume(root)
    print(f"  gateway kill and resume x {GW_KILL_LANES} lanes: "
          f"{kr['requests']} async ids, {kr['completed_before_kill']} "
          f"completed before the kill, {kr['adopted_in_flight']} adopted in "
          f"flight from the checkpoint, {kr['resumed']} resumed, each equal "
          f"to its model; kill {kr['kill_s']:.3f} s, resume "
          f"{kr['resume_s']:.3f} s; /healthz {kr['health']}; {card}",
          flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return rec


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
            fn = re.search(r"(v[12]_op|alu[12]\w*|bulk_fill_copy|bulk_rows|"
                           r"win_back|win_evict|win_fill|rows_differ|"
                           r"copy_rows)", mangled)
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


def sass_stats(text: str, every: bool = False) -> dict:
    """Per interp_kernel instantiation (with `every`, per function: the
    device functions left out of line too) in `cuobjdump -sass` output:
    its machine code bytes, its indirect branches (BRX: a jump table
    each), its shuffles (SHFL), warp syncs (WARPSYNC) and calls (CALL)."""
    rows, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if every or "interp_kernel" in m.group(1) \
                else None
            if cur:
                rows[cur] = {"sass_bytes": 0, "brx": 0, "shfl": 0,
                             "warpsync": 0, "call": 0}
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if m and cur:
            rows[cur]["sass_bytes"] = int(m.group(1), 16) + 16
            rows[cur]["brx"] += bool(re.search(r"\bBRX\b", m.group(2)))
            rows[cur]["shfl"] += bool(re.search(r"\bSHFL\.", m.group(2)))
            rows[cur]["warpsync"] += bool(
                re.search(r"\bWARPSYNC\b", m.group(2)))
            rows[cur]["call"] += bool(re.search(r"\bCALL\.", m.group(2)))
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
    """The instance cases (B2 block heads or B6 superinstructions) of the
    fused build of `tables` (its generated source's count)."""
    return int(re.search(r"\((\d+) instance cases",
                         tables.fused_source).group(1))


# nvcc processes that build, in the background, the kernels only the
# kernel phase runs while the main phase runs (one core left for it)
BACKGROUND_BUILDS = 7


def prebuild() -> dict:
    """Start every build the script runs and finish those of the main
    phase: the per-op kernel (direct access and window cache, a library
    each) and the fused kernel of each module, encoding and memory mode
    (the fused fixtures, the main-path modules, the SIMD corpus module).
    The main phase's builds (the per-op libraries, the main-path modules,
    the tail dispatch, the linked program, the concatenated images and
    the corpora) run all at once in the foreground; the rest, which only
    the kernel phase and the pc-switch lines use, are queued to run in
    the background, BACKGROUND_BUILDS at a time at the lowest CPU
    priority, while the main phase runs (`finish_builds` takes them).
    The generated source depends only on the module, the encoding and
    the memory mode, so tables made on the CPU name the same builds as
    the card's."""
    from wasmedge_tpu_torch.batch import interp, stdout_flush
    from wasmedge_tpu_torch.models import (
        build_bulk_workload, build_coremark_kernel, build_echo, build_fib,
        build_memory_workload, build_simd_loop, build_wasi_hello)
    from wasmedge_tpu_torch.models.fixtures import (
        build_bulk_warp, build_deep_recursion, build_host_double,
        build_tier0_unsafe, build_tier0_zoo, build_uniform_probe,
        build_win_rows, build_window_host)
    from wasmedge_tpu_torch.spec import corpus_tables

    # (module, v128 ops, imports, encodings, value-stack depth[, instance
    # cap]): the builds each comparison and main-path run of the script
    # uses (a depth whose rows all fit on chip names the build without the
    # stack split)
    def encs(simd):
        return ("blocks",) if simd else ("blocks", "super")

    env, wasi = (env_import,), (lambda: wasi_import(1),)
    main_mods = [(build_fib(), False, (), encs(False), 256),
                 (build_coremark_kernel(), False, (), ("blocks",), 256),
                 (build_simd_loop(), True, (), ("blocks",), 64),
                 (build_bulk_workload(), False, (), ("blocks",), 64),
                 (build_memory_workload(passes=MEM_PASSES), False, (),
                  ("blocks",), MEM_STACKS["value_stack_depth"])]
    mods = [(data, simd, (), encs(simd), kn["value_stack_depth"],
             kn.get("instance_cap"))
            for _, data, _, _, _, _, kn, simd in fused_fixtures(2)]
    mods += [(data, simd, (), encs(simd), kn["value_stack_depth"], None)
             for _, data, _, _, _, kn, simd, _ in opt_fixtures(2)]
    mods += [(build_host_double(), False, env, encs(False), 64),
             (build_window_host(), False, env, encs(False), 64),
             (build_bulk_warp(), False, (), ("blocks",), 64),
             (build_uniform_probe(), False, (), ("blocks",),
              PROBE_KNOBS["value_stack_depth"]),
             (build_win_rows(), False, (), ("blocks",),
              PROBE_KNOBS["value_stack_depth"]),
             (build_deep_recursion(), False, (), ("blocks",), 1024)]
    # the WASI modules with tier 0 on (the default) and off, and the
    # tier-0 fixtures (per-op: the per-op libraries with the tier-0
    # handlers)
    main_t0mods = [(build_echo(), encs(False), (True, False)),
                   (build_wasi_hello(), ("blocks",), (True, False))]
    t0mods = [(build_tier0_zoo(), ("none",) + encs(False), (True,)),
              (build_tier0_unsafe(), ("none",), (True,))]

    def of(mods, t0mods):
        out = []
        for data, simd, imports, fusions, depth, *cap in mods:
            for fusion in fusions:
                for opt in (None, False):
                    for _, (eng, _) in memory_modes(lambda m: make_engine(
                            data, 2, device="cpu",
                            imports=[f() for f in imports], fusion=fusion,
                            mem_hbm=m, optimistic=opt,
                            value_stack_depth=depth,
                            instance_cap=(cap or [None])[0])):
                        out.append(eng.tables)
        for data, fusions, t0s in t0mods:
            for fusion in fusions:
                for opt in (None, False):
                    for t0 in t0s:
                        for _, (eng, _) in memory_modes(
                                lambda m: make_engine(
                                    data, 2, device="cpu",
                                    imports=[wasi[0]()], fusion=fusion,
                                    mem_hbm=m, optimistic=opt,
                                    value_stack_depth=64,
                                    tier0_hostcalls=t0)):
                            out.append(eng.tables)
        return out

    main = of(main_mods, main_t0mods) + tail_builds() + linked_builds() \
        + mix_builds() + corpus_tables([SIMD_WAST]) \
        + corpus_tables(corpus_files(), corpus_conf())
    rest = of(mods, t0mods) + table_builds()
    # the main path's fib(30) and vloop blocks builds, kOpt and careful,
    # and each module once more with no block case (every pc through the
    # hid plane): the difference in BRX says what the pc switch compiled
    # to
    mains = {}
    for name, data, depth, fusion in (
            ("fib", build_fib(), 256, "blocks"),
            ("vloop", build_simd_loop(), 64, "blocks"),
            ("fib", build_fib(), 256, "super")):
        for opt in (None, False):
            eng = make_engine(data, 2, device="cpu", fusion=fusion,
                              optimistic=opt, value_stack_depth=depth,
                              call_stack_depth=16,
                              memory_pages_per_lane=1)[0]
            base = without_cases(eng.tables, eng.img)
            mains[f"{name}_{fusion}_{'kopt' if opt is None else 'careful'}"] \
                = (eng.tables, base)
            rest.append(base)
    # the per-op build for every memory and B3 mode (every per-op run of
    # the script has a depth whose rows all fit on chip)
    per_op = [(w, o, False) for w in (False, True) for o in (False, True)]
    in_main = {interp.fused_kernel_key(t) for t in main
               if t.fusion != "none"}
    # the gateway's generation 2 first in the background queue: the
    # gateway phase's timed build then finds it built
    gateway = gateway_builds()
    queued = interp.start_builds(gateway, at_once=BACKGROUND_BUILDS)
    rest += gateway
    queued += interp.start_builds(
        [t for t in rest if t.fusion == "none"
         or interp.fused_kernel_key(t) not in in_main],
        at_once=BACKGROUND_BUILDS)
    t0 = time.perf_counter()
    # the stdout flush kernel (one small source) beside them
    with ThreadPoolExecutor(1) as ex:
        flush = ex.submit(stdout_flush.build)
        interp.build_kernels(main, per_op=per_op)
        flush.result()
    print(f"  stdout flush kernel: nvcc "
          f"{stdout_flush.BUILD_INFO['seconds']:.1f} s; ptxas "
          f"{' | '.join(stdout_flush.BUILD_INFO['ptxas'].split(chr(10)))}",
          flush=True)
    return dict(wall_s=time.perf_counter() - t0, queued=queued,
                tables=main + rest, per_op=per_op, mains=mains)


def finish_builds(pre: dict) -> dict:
    """Wait for (and start what is still queued of) every build
    `prebuild` started, then print each fused build's instance cases,
    seconds, shapes, mean shape length, registers and spills, and the
    SASS bytes and indirect branches of the main path's fib(30) (blocks
    and super) and vloop builds against the same modules with no case
    (what the pc switch compiled to)."""
    from wasmedge_tpu_torch.batch import interp

    t0 = time.perf_counter()
    interp.build_kernels(pre["tables"], per_op=pre["per_op"])
    wall = time.perf_counter() - t0
    tables, mains = pre["tables"], pre["mains"]
    cases = {interp.fused_kernel_key(t): instance_cases(t) for t in tables
             if t.fusion != "none"}
    infos = interp.BUILD_INFO["fused"]
    dumped = [interp.fused_kernel_key(t) for pair in mains.values()
              for t in pair]
    with ThreadPoolExecutor(8) as pool:
        sass = dict(zip(dumped, pool.map(
            lambda k: sass_of(infos[k]["path"]), dumped)))
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
        code = next(iter(sass_stats(sass[key]).values()), {}) \
            if key in sass else {}
        builds[key] = dict(fusion=info.get("fusion"),
                           shapes=info.get("shapes"),
                           mean_len=info.get("mean_len"),
                           mem_window=info.get("mem_window"),
                           optimistic=info.get("optimistic"),
                           instance_cases=cases.get(key),
                           seconds=info.get("seconds"),
                           background=info.get("background"), ptxas=rows,
                           sass_bytes=code.get("sass_bytes"),
                           brx=code.get("brx"), shfl=code.get("shfl"),
                           warpsync=code.get("warpsync"))
        sass_line = (f", SASS {code.get('sass_bytes')} B, {code.get('brx')} "
                     f"BRX, {code.get('shfl')} SHFL, {code.get('warpsync')} "
                     f"WARPSYNC") if code else ""
        print(f"  fused build {key} [{info.get('fusion')}"
              f"{', windows' if info.get('mem_window') else ''}"
              f"{', optimistic' if info.get('optimistic') else ''}]: "
              f"{cases.get(key)} instance cases, {info.get('shapes')} block "
              f"shapes, mean length {info.get('mean_len') or 0:.2f}, nvcc "
              f"{info.get('seconds') or 0:.1f} s"
              f"{' (background)' if info.get('background') else ''}"
              f"{sass_line}", flush=True)
        print_registers(key, rows)
    return dict(wall_s=wall, n_fused=len(builds), fused=builds,
                background=sum(bool(b["background"])
                               for b in builds.values()),
                waited_s=dict(interp.BUILD_INFO["waited"]),
                pc_switches=switches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", flush=True)
        return 2
    from wasmedge_tpu_torch.batch import interp

    install_flush_check()
    card = gpu_name_and_power()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, card: {card}", flush=True)

    t0 = time.perf_counter()
    pre = prebuild()
    t_build = time.perf_counter() - t0
    per_op_s = {k: round(v.get("seconds", 0), 2)
                for k, v in interp.BUILD_INFO["per_op"].items()}
    print(f"phase build: {t_build:.2f} s (per-op nvcc {per_op_s}, the main "
          f"phase's {len(interp.BUILD_INFO['fused'])} fused builds, all at "
          f"once; {pre['queued']} builds queued for the background)",
          flush=True)
    per_op_regs = {interp.per_op_label(w, o): kernel_registers(w, o)
                   for o in (False, True) for w in (False, True)}
    for label, rows in per_op_regs.items():
        print_registers(f"per-op, {label}", rows)
    regs = per_op_regs[interp.per_op_label(False, False)]
    win_regs = per_op_regs[interp.per_op_label(True, False)]

    # the main phase, while the kernel phase's builds run in the
    # background; each part's seconds
    main_s = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        main_s[name] = round(time.perf_counter() - t, 2)
        return out

    t0 = time.perf_counter()
    main_out = part("main", phase_main)
    scalar = regs.get("interp_kernel<kBulk=0, kSimd=0>", {})
    print(f"fib({PER_OP_FIB_N}) x {MAIN_LANES} per-op ran interp_kernel<kBulk=0, "
          f"kSimd=0> ({scalar.get('registers')} registers, "
          f"{scalar.get('spill_stores', 0)} B spill stores): wall "
          f"{main_out['fib_none']['wall_s']:.3f} s; fib(30) in blocks "
          f"{main_out['fib30']['wall_s']:.3f} s, fib({PER_OP_FIB_N}) in super "
          f"{main_out['fib_super']['wall_s']:.3f} s", flush=True)
    main_out["tables"] = part("tables", phase_main_tables)
    main_out["linked"] = part("linked", phase_main_linked)
    main_out["scalar_corpus"] = part("scalar_corpus", phase_scalar_corpus)
    main_out.update(part("wasi", phase_main_wasi))
    main_out["bulk"] = part("bulk", phase_main_bulk)
    main_out["simd_corpus"] = part("simd_corpus", phase_simd_corpus)
    main_out["spec_corpus"] = part("spec_corpus", phase_spec_corpus)
    main_out["vloop"] = part("vloop", phase_main_simd)
    main_out["config2"] = part("config2", phase_main_memory)
    main_out["mix"] = part("mix", phase_main_mix)
    main_out["serve"] = part("serve", phase_serve)
    main_out["compact"] = part("compact", phase_compact, main_out)
    main_out["supervise"] = part("supervise", phase_supervise, main_out)
    main_out["gateway"] = part("gateway", phase_gateway, main_out)
    check_flushes("the main phase")
    t_main = time.perf_counter() - t0
    print(f"phase main: {t_main:.2f} s ({json.dumps(main_s)}; background "
          f"builds running beside it)", flush=True)

    t0 = time.perf_counter()
    builds = finish_builds(pre)
    t_build_rest = time.perf_counter() - t0
    print(f"phase build, the rest: {t_build_rest:.2f} s after the main "
          f"phase ({builds['n_fused']} fused builds in all, "
          f"{builds['background']} of them started in the background; the "
          f"main phase waited for {len(builds['waited_s'])} background "
          f"builds, {sum(builds['waited_s'].values()):.1f} s)", flush=True)
    attrs = window_attributes()
    geometry = phase_geometry()

    t0 = time.perf_counter()
    w = run_jobs({"mix": mix_jobs(), "linked": linked_jobs(),
                  "rows": rows_jobs() + uniform_jobs(),
                  "scalar": scalar_jobs() + host_jobs(),
                  "simd": simd_jobs(), "fused": fused_jobs(),
                  "opt": opt_jobs() + host_jobs(
                      "none", ("wasi_echo", "window_host")),
                  "tier0": tier0_jobs("none") + tier0_jobs("blocks")
                  + tier0_jobs("super"), "tables": table_jobs(),
                  "compact": compact_jobs()})
    worst, simd_worst, fused_worst, opt_worst, rows_worst, t0_worst = (
        w["scalar"], w["simd"], w["fused"], w["opt"], w["rows"], w["tier0"])
    tables_worst, linked_worst, mix_worst = w["tables"], w["linked"], \
        w["mix"]
    compact_worst = w["compact"]
    t_jobs = time.perf_counter() - t0
    (timing, bulk_timing, simd_timing, simd_op_timing, mem_timing,
     t0_timing, tables_timing) = timed_launches()
    t_kernel = time.perf_counter() - t0
    print(f"phase kernel_vs_plain: {t_kernel:.2f} s (comparisons "
          f"{t_jobs:.2f} s on {WORKERS} workers), max abs err "
          f"{max(worst, simd_worst, fused_worst, opt_worst, rows_worst, t0_worst, tables_worst, linked_worst, mix_worst, compact_worst)}"
          f" (tier 0 {t0_worst}; tables {tables_worst}; narrowed and "
          f"permuted launches {compact_worst}; linked program "
          f"{linked_worst}; concatenated images {mix_worst}; "
          f"warp bulk pass and stack rows {rows_worst}; window cache "
          f"{WINDOW_WORST[0]}; optimistic against plain "
          f"{OPT_WORST['plain']}, against careful below sp "
          f"{OPT_WORST['careful']})", flush=True)
    print(f"optimistic warps per fixture: {json.dumps(OPT_FIXTURES)}",
          flush=True)
    print(f"bulk ops per warp-pass fixture: {json.dumps(BULK_FIXTURES)}",
          flush=True)
    print(f"window counts per fixture: {json.dumps(WINDOW_FIXTURES)}",
          flush=True)
    print(f"uniform entries per fixture: {json.dumps(UNIFORM_FIXTURES)}",
          flush=True)
    print(f"tier-0 calls per fixture: {json.dumps(TIER0_FIXTURES)}",
          flush=True)
    print(f"concatenated-image jobs: {json.dumps(MIX_RECORDS)}", flush=True)
    gw_job_key = MIX_RECORDS["mix.gateway_generation2"]["key"]
    if gw_job_key != main_out["gateway"]["generation2_key"]:
        fail(f"the gateway's generation-2 kernel job ran build {gw_job_key}, "
             f"the gateway phase {main_out['gateway']['generation2_key']}")


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
    # the linked program's main-path run (B2 blocks, windows, optimistic;
    # its call_indirect through the imported table runs per op inside the
    # fused kernel): its launches beside each part's record
    lk = main_out["linked"]
    linked = dict(
        launches=lk["launches"], block_launches=lk["block_launches"],
        window_launches=lk["window_launches"],
        optimistic_launches=lk["optimistic_launches"],
        tables_launches=lk["tables_launches"],
        kernel_ms=lk["profile"]["kernel_ms"],
        main_ms_per_launch=per_launch(lk["profile"]),
        careful_kernel_ms=lk["careful"]["profile"]["kernel_ms"],
        retired=lk["retired"],
        instr_per_s_kernel=lk["profile"]["instr_per_s_kernel"],
        careful_instr_per_s_kernel=lk["careful"]["profile"][
            "instr_per_s_kernel"],
        idle_share=lk["profile"]["idle_share"],
        uniform=lk["uniform"], entered=lk["warps"]["entered"],
        rollbacks=lk["warps"]["rollbacks"],
        in_case_terminals=lk["in_case_terminals"],
        instantiate_s=lk["instantiate_s"], start_s=lk["start_s"],
        model_s=lk["model_s"], gas_cost_limit=lk["gas"]["cost_limit"],
        gas_start_cost=lk["gas"]["start_cost"],
        gas_finished=lk["gas"]["finished"],
        gas_cost_limit_traps=lk["gas"]["cost_limit_traps"],
        gas_event_ms=lk["gas"]["event_ms"],
        scalar_corpus=main_out["scalar_corpus"])
    # the config-5 mix (one concatenated image), its straddling variant
    # and the serving run: B2 blocks, windows, optimistic (the defaults)
    mx = {k: main_out["mix"][k]["mix"] for k in ("config5", "straddle")}
    sv = main_out["serve"]
    # the HTTP gateway's traffic (phase_gateway): generations 1 and 2 of
    # the concatenated image, B2 blocks, windows, optimistic; echo's host
    # calls park through K/B1's host-call handler inside those launches
    gwy = main_out["gateway"]
    # lane compaction's runs (B2 blocks, windows where a memory is,
    # optimistic; the launch width an argument of both launch entries):
    # their launches, narrowed launches and kernel ms beside the same
    # call's uncompacted runs
    cp = main_out["compact"]
    fm = cp["fib_mix"]
    compacted = dict(
        fib_mix_launches=fm["on"]["block_launches"],
        fib_mix_narrowed_launches=fm["on"]["narrow_launches"],
        fib_mix_kernel_ms=fm["on"]["profile"]["kernel_ms"],
        fib_mix_no_narrow_launches=fm["on_no_narrow"]["block_launches"],
        fib_mix_no_narrow_kernel_ms=fm["on_no_narrow"]["profile"][
            "kernel_ms"],
        fib_mix_uncompacted_kernel_ms=main_out["fib_mix"]["profile"][
            "kernel_ms"],
        straddle_launches=cp["straddle"]["block_launches"],
        straddle_narrowed_launches=cp["straddle"]["narrow_launches"],
        straddle_kernel_ms=cp["straddle"]["kernel_ms"],
        serve_launches=cp["serve"]["block_launches"],
        serve_kernel_ms=cp["serve"]["kernel_ms"],
        narrowed_and_permuted_jobs_max_abs_err=compact_worst)
    record = launch_record(
        "wasm_interp", "wasmedge_tpu_torch/csrc/interp.cu",
        "wasmedge_tpu/batch/pallas_engine.py:3825",
        main_out["fib_none"]["op_launches"], timing["none"],
        max(worst, rows_worst, mix_worst, compact_worst),
        main_out["fib_none"]["profile"],
        # memory.grow reads its page ceiling from its instruction's b (a
        # tenant's own in a concatenated image)
        memgrow_ceiling="b",
        # the lanes launched are an argument (lane compaction narrows it);
        # the jobs held launches of width 64 and 1024 of MAIN_LANES
        launch_width="argument", narrowed_widths=list(NARROW_WIDTHS),
        timed_launch=dict(fib_launch, retired=timing["none"]["retired"]),
        # the linked program's per-op launches (0: its run is B2 blocks),
        # and the B2 launches whose call_indirect runs this kernel's
        # per-op handler inside the fused kernel
        linked_op_launches=lk["op_launches"],
        linked_block_launches_with_per_op_call=linked["block_launches"],
        gateway_hostcall_launches=gwy["hostcall_launches"])
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
        main_out["fib30"]["block_launches"], timing["blocks"],
        max(fused_worst, linked_worst, compact_worst),
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
            c2["mem_checksum"]["careful"]["profile"]),
        linked_launches=linked["block_launches"],
        linked_main_ms_per_launch=linked["main_ms_per_launch"],
        mix_launches=mx["config5"]["block_launches"],
        mix_main_ms_per_launch=mx["config5"]["kernel_ms"]
        / mx["config5"]["profiled_launches"],
        straddle_launches=mx["straddle"]["block_launches"],
        serve_launches=sv["block_launches"], compacted=compacted,
        gateway_launches=gwy["block_launches"])
    super_record = launch_record(
        "super", "wasmedge_tpu_torch/csrc/fused.cuh",
        "wasmedge_tpu/batch/pallas_engine.py:2472",
        main_out["fib_super"]["super_launches"], timing["super"],
        fused_worst, main_out["fib_super"]["profile"],
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
        # B4's counts: the timed launch's, with the rows it moved as bytes
        # and the bound those give, and the main path's config 2 runs'
        # (blocks, windows)
        window_counts=mem_timing["windows"]["window_counts"],
        window_row_bytes=mem_timing["windows"]["window_row_bytes"],
        window_rows_bound_ms=mem_timing["windows"]["window_rows_bound_ms"],
        main_window_counts={k: c2[k]["window_counts"]
                            for k in ("mem_checksum", "coremark")},
        linked_launches=linked["window_launches"],
        linked_window_counts=lk["window_counts"],
        mix_launches=mx["config5"]["window_launches"],
        straddle_launches=mx["straddle"]["window_launches"],
        serve_launches=sv["window_launches"],
        gateway_launches=gwy["window_launches"],
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
        # the entry rule: uniform entries against entries per main-path
        # run, the entry compare (cycles a warp, and the one-step launch
        # against the careful build's) of the timed fib and config 2
        # launches, and the bytes a launch's snapshots and compares move
        uniform_entries={k: dict(uniform=r["uniform"],
                                 entered=r["warps"]["entered"])
                         for k, r in (("fib30", fib30),
                                      ("fib_none", main_out["fib_none"]),
                                      ("fib_super",
                                       main_out["fib_super"]),
                                      ("fib_mix", main_out["fib_mix"]),
                                      ("vloop", vb),
                                      ("mem_checksum", c2["mem_checksum"]),
                                      ("coremark", c2["coremark"]),
                                      ("linked", lk))},
        linked_launches=linked["optimistic_launches"],
        linked_rollbacks=linked["rollbacks"],
        mix_launches=mx["config5"]["optimistic_launches"],
        straddle_launches=mx["straddle"]["optimistic_launches"],
        mix_entries={k: mx[k]["b3"] for k in mx},
        serve_launches=sv["optimistic_launches"],
        gateway_launches=gwy["optimistic_launches"],
        serve_entries=dict(uniform=sv["uniform"], entered=sv["entered"],
                           rollbacks=sv["rollbacks"]),
        entry_compare={k: dict(cycles_per_warp=t["entry_compare_cycles_per_warp"],
                               ms=t["entry_compare_ms"],
                               bytes=t["entry_compare_bytes"],
                               one_step_ms=t["one_step_ms"],
                               one_step_careful_ms=t["one_step_careful_ms"])
                       for k, t in (("fib30_blocks", timing["blocks"]),
                                    ("mem_checksum_windows",
                                     mem_timing["windows"]),
                                    ("mem_checksum_direct",
                                     mem_timing["direct"]))},
        mem_checksum_snapshot_bytes={
            m: mem_timing[m]["snapshot_bytes"] for m in ("windows",
                                                          "direct")},
        snapshot_bytes=timing["blocks"]["snapshot_bytes"],
        bytes_per_commit=timing["blocks"]["bytes_per_commit"],
        careful_max_abs_err=OPT_WORST["careful"],
        timed_launch=dict(fib_launch, encoding="blocks",
                          retired=timing["blocks"]["retired"]))
    # Tier 0: the handlers at the stubs (tier0_call) of the main path's
    # echo build; "ms", "careful_ms" and "plain_ms" are one echo(ITERS) x
    # MAIN_LANES launch to every lane's end with tier 0 (the timed launch
    # of phase_time_tier0), "tier0_off_ms" the same launch with tier 0 off
    # (to the first park), "flush_ms" its stdout flush; "launches" counts
    # the main path's tier-0 launches of echo, "main_ms_per_launch" their
    # kernel device time and "tier0_off_main_kernel_ms" the tier-0-off
    # run's whole kernel device time, with its serve rounds
    eo = main_out["echo"]
    t0_record = {
        "name": "tier0",
        "route": "cuda",
        "source": "wasmedge_tpu_torch/csrc/interp.cu",
        "replaces": "wasmedge_tpu/batch/pallas_engine.py:1520",
        "launches": eo["tier0_launches"],
        "max_abs_err": max(t0_worst, t0_timing["max_abs_err"]),
        "ms": t0_timing["ms"], "plain_ms": t0_timing["plain_ms"],
        "bound_ms": t0_timing["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "careful_ms": t0_timing["careful_ms"],
        "tier0_off_ms": t0_timing["tier0_off_ms"],
        "flush_ms": t0_timing["flush_ms"],
        "flush_bytes": t0_timing["flush_bytes"],
        "calls": t0_timing["calls"],
        "main_ms_per_launch": per_launch(eo["profile"]),
        "main_kernel_ms": eo["profile"]["kernel_ms"],
        "main_flush_ms": eo["flush_ms"],
        "tier0_off_main_kernel_ms": eo["tier0_off"]["profile"]["kernel_ms"],
        "tier0_off_serve_rounds": eo["tier0_off"]["serve_rounds"],
        "tier0_off_serve_ms": eo["tier0_off"]["serve_s"] * 1e3,
        "timed_launch": {"workload": f"echo({ECHO_ITERS})",
                         "lanes": MAIN_LANES, "encoding": "blocks"},
    }
    # Tier 0's stdout flush kernel (csrc/stdout_flush.cu): "ms" its device
    # time on echo's records after the timed launch (MAIN_LANES lanes,
    # 2 x ECHO_ITERS records each), "plain_ms" `_records` on the same
    # records on the host ("plain_flush_ms" the whole plain path: the
    # downloads, `_records`, the writes, as the flush ran before the
    # kernel), "flush_ms" flush_stdout_buffers whole, "library_ms"
    # torch.masked_select over the transposed planes (the uniform layout's
    # stream); "launches" counts the main path's echo run's flushes, and
    # every flush on the card in the script was held against the plain
    # version ("flushes_checked")
    tf = t0_timing["flush"]
    flush_record = {
        "name": "stdout_flush",
        "route": "cuda",
        "source": "wasmedge_tpu_torch/csrc/stdout_flush.cu",
        "replaces": "wasmedge_tpu/batch/pallas_engine.py:1520 (h_hostcall; "
                    "the tier-0 flush, its host half, is "
                    "wasmedge_tpu/batch/hostcall.py:214)",
        "launches": eo["stdout_flush_launches"],
        "max_abs_err": tf["max_abs_err"],
        "ms": tf["kernel_ms"], "plain_ms": tf["plain_ms"],
        "bound_ms": tf["bound_ms"], "bound_by": "bytes",
        "library_ms": tf["library_ms"],
        "flush_ms": tf["flush_ms"], "plain_flush_ms": tf["plain_flush_ms"],
        "kernel_split_ms": tf["kernel_split_ms"],
        "plain_split_ms": tf["plain_split_ms"],
        "flush_bytes": tf["flush_bytes"], "bound_bytes": tf["bound_bytes"],
        "flushes_checked": FLUSH["checked"], "bytes_checked": FLUSH["bytes"],
        "main_flush_ms": eo["flush_ms"],
        "main_flush_check_ms": eo["flush_check_ms"],
    }
    # Tables, segments, tail calls and weighted gas: the handlers of the
    # main path's tail-dispatch build (a3_step, the tail calls and
    # call_indirect through the lane's table); "ms", "careful_ms",
    # "plain_ms" and "bound_ms" are one TIMED_STEPS-step launch of the
    # converged workload x MAIN_LANES from its start, "gas_ms" / "fuel_ms"
    # the same launch with weighted gas / flat fuel; "launches" counts the
    # main path's converged run's launches of the build with the table
    # handlers, "main_ms_per_launch" their kernel device time, and the
    # divergent, careful and gas runs' beside it, "main_bound_ms" the
    # bound of one of its launches
    tt = main_out["tables"]
    # the main path's launch's bound: the timed launch's bytes (the same
    # rows, program bytes, tables and segments) and its own instructions
    main_ops_ms = (tt["converged"]["retired"] / tt["converged"]["launches"]
                   * OPS_PER_INSTR / OPS_PER_S * 1e3)
    main_bytes_ms = tables_timing["bound_bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"  tail dispatch main-path launch bound: "
          f"{max(main_ops_ms, main_bytes_ms):.6f} ms (operations "
          f"{main_ops_ms:.6f} ms, bytes {main_bytes_ms:.6f} ms)", flush=True)
    tables_record = launch_record(
        "tables", "wasmedge_tpu_torch/csrc/interp.cu",
        "wasmedge_tpu/batch/engine.py:1156-1307 and :1464-1505 (the JAX "
        "SIMT engine's table, segment and tail-call handlers; the Pallas "
        "kernel has no counterpart: pallas_engine.py:578-595 sends such "
        "images to the SIMT engine)",
        tt["converged"]["tables_launches"], tables_timing, tables_worst,
        tt["converged"]["profile"],
        careful_main_ms_per_launch=per_launch(
            tt["converged"]["careful"]["profile"]),
        divergent_launches=tt["divergent"]["tables_launches"],
        divergent_main_ms_per_launch=per_launch(tt["divergent"]["profile"]),
        divergent_careful_main_ms_per_launch=(
            tt["divergent"]["careful"]["event_ms"]
            / tt["divergent"]["careful"]["launches"]),
        uniform_entries={k: dict(uniform=tt[k]["uniform"],
                                 entered=tt[k]["warps"]["entered"])
                         for k in ("converged", "divergent")},
        gas_ms=tables_timing["gas_ms"], fuel_ms=tables_timing["fuel_ms"],
        gas_launches=tt["gas"]["gas_launches"],
        gas_main_ms_per_launch=per_launch(tt["gas"]["profile"]),
        fuel_main_ms_per_launch=per_launch(tt["fuel"]["profile"]),
        in_case_terminals=tt["converged"]["in_case_terminals"],
        main_bound_ms=max(main_ops_ms, main_bytes_ms),
        main_bound_by="operations" if main_ops_ms >= main_bytes_ms
        else "bytes",
        timed_launch={"workload": "tail dispatch, converged",
                      "lanes": MAIN_LANES, "steps": TIMED_STEPS,
                      "encoding": "blocks",
                      "retired": tables_timing["retired"]})
    print(json.dumps({"phases_s": {"build": t_build, "main": t_main,
                                   "build_rest": t_build_rest,
                                   "kernel": t_kernel},
                      "main_parts_s": main_s,
                      "tier0_fixtures": TIER0_FIXTURES,
                      "tier0_launch": t0_timing,
                      "tables_launch": tables_timing,
                      "linked": linked,
                      "registers": per_op_regs, "attributes": attrs,
                      "geometry": geometry, "bulk_fixtures": BULK_FIXTURES,
                      "window_fixtures": WINDOW_FIXTURES,
                      "uniform_fixtures": UNIFORM_FIXTURES,
                      "builds": builds, "one_launch": timing,
                      "opt_fixtures": OPT_FIXTURES,
                      "bulk_pair": bulk_timing, "simd_launch": simd_timing,
                      "simd_launch_per_op": simd_op_timing,
                      "mem_launch": mem_timing, "main": main_out}),
          flush=True)
    print(json.dumps({"kernels": [record, block_record, super_record,
                                  bulk_record, simd_record, window_record,
                                  opt_record, t0_record, flush_record,
                                  tables_record]}),
          flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
