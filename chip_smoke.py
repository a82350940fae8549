"""Chip smoke test of the PyTorch/CUDA port (`wasmedge_tpu_torch`) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases:
  1. build   - compile the CUDA warp-interpreter (csrc/interp.cu) with nvcc;
  2. kernel  - run the fixture modules (ALU edge values, traps, divergent
               fib, memory ops, fuel, memory.fill / memory.copy edge cases
               and a small bulk workload) at 256 lanes through the kernel
               and through its plain PyTorch version on the same CUDA
               tensors, comparing every state plane after every launch
               (tolerance 0); then the host-call fixtures (env.double,
               env.poke, a host trap, a host memory.grow, WASI echo and
               WASI hello), kernel state and plain state each with its own
               serve round after every launch, planes compared before and
               after it and the two stdout files byte for byte; then time
               one launch of both at the flagship shape and one converged
               memory.fill + memory.copy launch (kernel, plain version and
               the same fill and copy as PyTorch tensor calls), each with
               its bound;
     Then the v128 fixtures (every batchable v128 op in sweep modules
               with random and corner-byte operands, vmix, vloop, the v128
               memory zoo, the v128 control module, fuel running out on a
               v128 op and on a v128.store) kernel against plain version
               after every launch, all four stack planes included, a host
               import under v128 words with the host-call fixtures, and
               one timed 256-step vloop launch x 4096 with its bound;
  3. main    - VM.execute_batch at full size: fib(30) x 4096 lanes, a
               divergent fib mix x 4096, CoreMark(200) and CoreMark(4096)
               x 4096 with one 64 KiB page per lane, each checked against
               its reference; fib(30) and CoreMark(4096) once more under
               torch.profiler, splitting kernel time from set-up; then
               WASI echo x 4096 (32,768 fd_write calls, output checked byte
               for byte, serve rounds and serve time against kernel time
               under torch.profiler), WASI hello x 4096 (proc_exit codes)
               and the bulk-memory workload x 4096 (checked against a
               bytearray model, instr/s over kernel time); the SIMD spec
               corpus (tests/spec/simd.wast, BASELINE config 3) through
               run_corpus_batched on the card, strict; vloop(1,000,000) x
               4096 (bench_simd.py's shape), every lane's result and
               retired count checked, once more under torch.profiler;
  4. report  - phase times, kernel times (CUDA events), retired
               instructions and instructions per second, registers and
               spills of each kernel instantiation, the card's name and
               power limit, one JSON line of kernel records, and last the
               device JSON line.

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

import numpy as np
import torch

SEED = 20261016
KERNEL_LANES = 256
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
SIMD_WAST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "spec", "simd.wast")


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
                **knobs):
    from wasmedge_tpu_torch.batch.engine import BatchEngine
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
    return BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                       device=device), inst


def max_abs_err(a, b) -> int:
    """Largest difference over every plane of two states (stack_e2 and
    stack_e3 included where the image has v128 ops)."""
    pa, pb = a.planes(), b.planes()
    if pa.keys() != pb.keys():
        fail(f"states with different planes: {sorted(pa)} / {sorted(pb)}")
    err = 0
    for f in pa:
        d = pa[f].to(torch.int64) - pb[f].to(torch.int64)
        err = max(err, int(d.abs().max().item()))
    return err


def kernel_vs_plain(name, data, func, args, chunk, fuel, knobs) -> int:
    """One fixture at KERNEL_LANES lanes: kernel and plain version from
    the same CUDA state, launch by launch, every plane equal.  Returns the
    max abs err."""
    from wasmedge_tpu_torch.batch import interp, interp_ref

    t0 = time.perf_counter()
    eng, inst = make_engine(data, KERNEL_LANES, fuel_per_launch=fuel,
                            **knobs)
    st = eng.initial_state(inst.exports[func][1], args)
    ref = st.clone()
    launches = worst = 0
    while True:
        interp.run_chunk(eng.tables, st, chunk, fuel is not None)
        interp_ref.run_chunk(eng.tables, ref, chunk, fuel is not None)
        torch.cuda.synchronize()
        launches += 1
        err = max_abs_err(st, ref)
        worst = max(worst, err)
        if err != 0:
            fail(f"kernel != plain on {name} after launch {launches}: "
                 f"max abs err {err}")
        if not bool((st.trap == 0).any()):
            break
        if launches == 200:
            fail(f"{name}: lanes still running after {launches} launches")
    traps = sorted(set(st.trap.cpu().tolist()))
    print(f"kernel_vs_plain {name}: {launches} launches equal, "
          f"traps {traps}, retired {int(st.retired.sum())}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return worst


def phase_kernel_vs_plain() -> int:
    """Every fixture at KERNEL_LANES lanes: kernel and plain version from
    the same CUDA state, launch by launch, all planes equal."""
    from wasmedge_tpu_torch.models import (
        build_bulk_workload, build_coremark_kernel, build_fib,
        build_memory_workload)
    from wasmedge_tpu_torch.models.fixtures import (
        alu_args, build_alu_edge, build_bulk_zoo, build_trap_zoo,
        bulk_zoo_args, zoo_args)

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
        ("mem_checksum", build_memory_workload(), "mem_checksum",
         [np.arange(L) % 30 + 1], 256, None),
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
    return max(kernel_vs_plain(name, data, func, args, chunk, fuel, knobs)
               for name, data, func, args, chunk, fuel in fixtures)


def first_step_at(data, func, args, hid, knobs) -> int:
    """Steps before lane 0 first sits at handler `hid` (plain version)."""
    from wasmedge_tpu_torch.batch import interp_ref

    eng, inst = make_engine(data, len(args[0]), **knobs)
    st = eng.initial_state(inst.exports[func][1], args)
    for step in range(10_000):
        if int(eng.tables.hid[int(st.pc[0])]) == hid:
            return step
        interp_ref.run_chunk(eng.tables, st, 1, False)
    fail(f"{func}: handler {hid} never reached")


def phase_simd_kernel_vs_plain() -> int:
    """The v128 fixtures at KERNEL_LANES lanes through the kernel's kSimd
    instantiations and the plain version, every plane (stack_e2 and
    stack_e3 included) equal after every launch."""
    from wasmedge_tpu_torch.batch.interp import H_VSTORE
    from wasmedge_tpu_torch.models import build_simd_loop
    from wasmedge_tpu_torch.models.fixtures import (
        build_simd_sweep, build_v128_control, build_v128_mem_zoo, build_vmix,
        simd_sweep_args, simd_sweeps, v128_zoo_args)

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
    ]
    return max(kernel_vs_plain(name, data, func, args, chunk, fuel, knobs)
               for name, data, func, args, chunk, fuel in fixtures)


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


def phase_hostcalls_kernel_vs_plain() -> int:
    """The host-call fixtures at KERNEL_LANES lanes: kernel and plain
    version from the same CUDA state, each state with its own engine,
    host modules and serve round after every launch; every plane equal
    before and after each serve round, and the kernel side's stdout file
    byte-identical to the plain side's."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.batch.hostcall import serve_batch_state
    from wasmedge_tpu_torch.common.errors import ErrCode
    from wasmedge_tpu_torch.models import build_echo, build_wasi_hello
    from wasmedge_tpu_torch.models.fixtures import (
        build_host_double, build_host_grow, build_host_poke,
        build_host_trap, build_simd_host)
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
    ]
    worst = 0
    for name, data, func, args, want_out in fixtures:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            paths = [os.path.join(td, k) for k in ("kernel", "plain")]
            fds = [os.open(p, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
                   for p in paths]
            try:
                engs = [make_engine(data, L, imports=[
                    wasi_import(fd) if want_out is not None
                    else env_import()], **knobs)[0] for fd in fds]
                inst = engs[0].inst
                st = engs[0].initial_state(inst.exports[func][1], args)
                ref = st.clone()
                launches = rounds = 0
                while True:
                    interp.run_chunk(engs[0].tables, st, 64, False)
                    interp_ref.run_chunk(engs[0].tables, ref, 64, False)
                    torch.cuda.synchronize()
                    launches += 1
                    err = max_abs_err(st, ref)
                    served = serve_batch_state(engs[0], st)
                    if serve_batch_state(engs[1], ref) != served:
                        fail(f"{name}: the two serve rounds served "
                             f"different lanes")
                    rounds += served > 0
                    err = max(err, max_abs_err(st, ref))
                    worst = max(worst, err)
                    if err != 0:
                        fail(f"kernel != plain on {name} around serve round "
                             f"after launch {launches}: max abs err {err}")
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
        print(f"kernel_vs_plain {name}: {launches} launches and {rounds} "
              f"serve rounds equal, traps {sorted(set(trap.tolist()))}, "
              f"stdout {len(outs[0])} B identical, "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
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


def phase_time_one_launch():
    """One launch of TIMED_STEPS steps from the flagship's initial state
    (fib(30) x 4096), kernel and plain version, same inputs, and its
    bound from the state that launch touches and its instruction mix."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.batch.engine import CONTROL_FIELDS
    from wasmedge_tpu_torch.models import build_fib

    chunk, L = TIMED_STEPS, MAIN_LANES
    eng, inst = make_engine(build_fib(), L, value_stack_depth=256,
                            call_stack_depth=256)
    tb = eng.tables
    st0 = eng.initial_state(inst.exports["fib"][1], [np.full(L, 30)])
    kernel = lambda s: interp.run_chunk(tb, s, chunk, False)
    plain = lambda s: interp_ref.run_chunk(tb, s, chunk, False)
    kernel(st0.clone())  # warm-up
    torch.cuda.synchronize()
    ms, k25, k75, out_k = time_launch(kernel, st0, 21)
    plain_ms, p25, p75, out_p = time_launch(plain, st0, 3)
    err = max_abs_err(out_k, out_p)
    if err != 0:
        fail(f"kernel != plain at the flagship shape: max abs err {err}")
    retired = int(out_k.retired.sum())

    counts, max_sp, max_cd = launch_mix(tb, st0, chunk)
    if int(counts.sum()) != retired:
        fail(f"instruction mix counts {int(counts.sum())} instructions, "
             f"the kernel retired {retired}")
    # Least bytes: each state row the launch touches read once and written
    # once (stack rows below the deepest sp, frame rows below the deepest
    # call depth, the control planes), and the code tables read once.
    touched = 4 * L * (2 * max_sp + 3 * max_cd + len(CONTROL_FIELDS))
    table_bytes = sum(4 * t.numel() for t in vars(tb).values()
                      if isinstance(t, torch.Tensor))
    bytes_ = 2 * touched + table_bytes
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = retired * OPS_PER_INSTR / OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    # What this kernel's handlers move through the state planes for the
    # same instructions (a stack cell is read and written again and again)
    hid, b = tb.hid.cpu().numpy(), tb.b.cpu().numpy()
    traffic = sum(int(c) * handler_bytes(int(hid[pc]), int(b[pc]))
                  for pc, c in enumerate(counts) if c)
    print(f"one launch of {chunk} steps x {L} lanes (fib(30)): kernel "
          f"median {ms:.4f} ms (q25 {k25:.4f}, q75 {k75:.4f}, 21 runs), "
          f"plain median {plain_ms:.2f} ms (q25 {p25:.2f}, q75 {p75:.2f}, "
          f"3 runs), retired {retired}", flush=True)
    print(f"  bound {bound_ms:.6f} ms by "
          f"{'bytes' if bound_bytes_ms >= bound_ops_ms else 'operations'}: "
          f"bytes {bytes_} B (stack rows {max_sp}, frame rows {max_cd}, "
          f"code tables {table_bytes} B) / {HBM_BYTES_PER_S:.3g} B/s = "
          f"{bound_bytes_ms:.6f} ms; operations {retired} x "
          f"{OPS_PER_INSTR} / {OPS_PER_S:.3g} /s = {bound_ops_ms:.6f} ms",
          flush=True)
    print(f"  handler traffic {traffic} B ({traffic / retired:.2f} B per "
          f"instruction), {traffic / HBM_BYTES_PER_S * 1e3:.6f} ms at the "
          f"HBM rate; touched state {touched} B, "
          f"{'within' if touched <= L2_BYTES else 'beyond'} the "
          f"{L2_BYTES:.3g} B L2", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations", max_abs_err=err, retired=retired,
                bound_bytes=bytes_, handler_traffic_bytes=traffic,
                touched_state_bytes=touched)


def phase_time_simd_launch():
    """One launch of TIMED_STEPS steps of vloop(SIMD_N) x MAIN_LANES from
    its initial state, kernel and plain version, same inputs, and its
    bound from the rows that launch touches."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.batch.engine import CONTROL_FIELDS
    from wasmedge_tpu_torch.batch import interp as I
    from wasmedge_tpu_torch.models import build_simd_loop

    chunk, L = TIMED_STEPS, MAIN_LANES
    eng, inst = make_engine(build_simd_loop(), L, value_stack_depth=64,
                            call_stack_depth=16, memory_pages_per_lane=1)
    tb = eng.tables
    st0 = eng.initial_state(inst.exports["vloop"][1], [np.full(L, SIMD_N)])
    kernel = lambda s: interp.run_chunk(tb, s, chunk, False)
    plain = lambda s: interp_ref.run_chunk(tb, s, chunk, False)
    kernel(st0.clone())  # warm-up
    torch.cuda.synchronize()
    ms, k25, k75, out_k = time_launch(kernel, st0, 21)
    plain_ms, p25, p75, out_p = time_launch(plain, st0, 3)
    err = max_abs_err(out_k, out_p)
    if err != 0:
        fail(f"kernel != plain on the vloop launch: max abs err {err}")
    retired = int(out_k.retired.sum())
    counts, max_sp, max_cd = launch_mix(tb, st0, chunk)
    hid = tb.hid.cpu().numpy()
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
    # memory row: checked above), and the code tables read once.
    touched = 4 * L * (4 * max_sp + 3 * max_cd + len(CONTROL_FIELDS))
    table_bytes = sum(4 * t.numel() for t in vars(tb).values()
                      if isinstance(t, torch.Tensor))
    bytes_ = 2 * touched + table_bytes
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    # operations: one per scalar instruction, one per 32-bit word of a
    # v128 instruction
    ops = sum(int(c) * (4 if hid[pc] >= I.H_VCONST else 1)
              for pc, c in enumerate(counts))
    bound_ops_ms = ops / OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    v128_share = sum(int(c) for pc, c in enumerate(counts)
                     if hid[pc] >= I.H_VCONST) / retired
    print(f"one launch of {chunk} steps x {L} lanes (vloop({SIMD_N})): "
          f"kernel median {ms:.4f} ms (q25 {k25:.4f}, q75 {k75:.4f}, 21 "
          f"runs), plain median {plain_ms:.2f} ms (q25 {p25:.2f}, q75 "
          f"{p75:.2f}, 3 runs), retired {retired}, v128 share "
          f"{v128_share:.3f}", flush=True)
    print(f"  bound {bound_ms:.6f} ms by "
          f"{'bytes' if bound_bytes_ms >= bound_ops_ms else 'operations'}: "
          f"bytes {bytes_} B (4 stack planes x {max_sp} rows, frame rows "
          f"{max_cd}, code tables {table_bytes} B) / {HBM_BYTES_PER_S:.3g} "
          f"B/s = {bound_bytes_ms:.6f} ms; operations {ops} / "
          f"{OPS_PER_S:.3g} /s = {bound_ops_ms:.6f} ms", flush=True)
    return dict(ms=ms, q25=k25, q75=k75, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations", max_abs_err=err, retired=retired,
                bound_bytes=bytes_, bound_ops=ops, v128_share=v128_share)


def fib_py(n: int) -> int:
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


def run_main(vm, func, args, steps_per_launch, need=("interp",)):
    """One execute_batch through the VM with every launch count set to 0
    before and read after; fails unless the kinds of launch in `need`
    happened.  Returns (result, launches, wall s, event ms, counts)."""
    from wasmedge_tpu_torch.batch import interp

    vm.conf.batch.steps_per_launch = steps_per_launch
    torch.cuda.synchronize()
    for k in interp.LAUNCHES:
        interp.LAUNCHES[k] = 0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    res = vm.execute_batch(func, args, max_steps=10**9)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(interp.LAUNCHES)
    for k in need:
        if counts[k] == 0:
            fail(f"main path {func} never launched the CUDA kernel "
                 f"({k} launches: 0)")
    return res, counts["interp"], wall, e0.elapsed_time(e1), counts


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

    res, launches, wall, ev_ms, counts = run_main(
        vm, "fib", [np.full(L, 30)], 1 << 20)
    if counts["simd"] or counts["bulk"]:
        fail(f"fib(30) ran a kernel instantiation with bulk or v128 cases: "
             f"{counts}")
    if not (res.trap == -1).all() or not (res.results[0] == 832040).all():
        fail(f"fib(30) x {L}: traps {np.unique(res.trap)}, results "
             f"{np.unique(res.results[0])[:5]}")
    retired = int(res.retired.astype(np.int64).sum())
    out["fib30"] = dict(launches=launches, wall_s=wall, event_ms=ev_ms,
                        retired=retired)
    print(f"main fib(30) x {L}: all 832040, {launches} launches, "
          f"wall {wall:.3f} s, kernel (events) {ev_ms:.1f} ms, retired "
          f"{retired}, {retired / (ev_ms / 1e3):.4g} wasm instr/s",
          flush=True)

    ns = 20 + np.arange(L) % 11
    res, launches, wall, ev_ms, _ = run_main(vm, "fib", [ns], 1 << 20)
    want = np.array([fib_py(int(n)) for n in ns])
    if not (res.trap == -1).all() or not (res.results[0] == want).all():
        fail("divergent fib mix disagrees with the Python fib table")
    retired = int(res.retired.astype(np.int64).sum())
    out["fib_mix"] = dict(launches=launches, wall_s=wall, event_ms=ev_ms,
                          retired=retired)
    print(f"main fib(20 + lane % 11) x {L}: matches, {launches} launches, "
          f"wall {wall:.3f} s, kernel (events) {ev_ms:.1f} ms, retired "
          f"{retired}, {retired / (ev_ms / 1e3):.4g} wasm instr/s",
          flush=True)

    conf_cm = Configure()
    conf_cm.batch.lanes = L
    conf_cm.batch.value_stack_depth = 256
    conf_cm.batch.call_stack_depth = 256
    conf_cm.batch.memory_pages_per_lane = 1
    vm_cm = VM(conf_cm)
    vm_cm.load_wasm(build_coremark_kernel())
    vm_cm.validate()
    vm_cm.instantiate()
    res, launches, wall, ev_ms, _ = run_main(vm_cm, "coremark",
                                          [np.full(L, 200)], 1 << 20)
    # the reference: the plain interpreter on the CPU for 32 lanes
    cpu = BatchEngine(vm_cm._active, store=vm_cm.store, conf=conf_cm,
                      lanes=32, device="cpu").run("coremark",
                                                  [np.full(32, 200)])
    if not (cpu.trap == -1).all() or len(set(cpu.results[0].tolist())) != 1:
        fail("CoreMark CPU reference did not complete uniformly")
    if not (res.trap == -1).all() or \
            not (res.results[0] == cpu.results[0][0]).all():
        fail("CoreMark x 4096 disagrees with the CPU plain interpreter")
    retired = int(res.retired.astype(np.int64).sum())
    out["coremark200"] = dict(launches=launches, wall_s=wall, event_ms=ev_ms,
                              retired=retired)
    print(f"main coremark(200) x {L} (1 page/lane, 256 MiB memory plane): "
          f"all {int(cpu.results[0][0])}, {launches} launches, wall "
          f"{wall:.3f} s, events around execute_batch {ev_ms:.1f} ms "
          f"(mostly set-up), retired {retired}", flush=True)

    res, launches, wall, ev_ms, _ = run_main(vm_cm, "coremark",
                                          [np.full(L, COREMARK_N)], 1 << 20)
    want = coremark_py(COREMARK_N)
    if not (res.trap == -1).all() or \
            not ((res.results[0] & 0xFFFFFFFF) == want).all():
        fail(f"coremark({COREMARK_N}) x {L} disagrees with the Python "
             f"reference {want}")
    retired = int(res.retired.astype(np.int64).sum())
    out["coremark"] = dict(launches=launches, wall_s=wall, event_ms=ev_ms,
                           retired=retired)
    print(f"main coremark({COREMARK_N}) x {L}: all {want}, {launches} "
          f"launches, wall {wall:.3f} s, events around execute_batch "
          f"{ev_ms:.1f} ms, retired {retired}", flush=True)

    out["fib30"]["profile"] = profile_run(vm, "fib", [np.full(L, 30)],
                                          out["fib30"]["retired"])
    out["coremark"]["profile"] = profile_run(
        vm_cm, "coremark", [np.full(L, COREMARK_N)],
        out["coremark"]["retired"])
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


def profile_run(vm, func, args, retired: int):
    """One more execute_batch under torch.profiler: the kernel's device
    time and launches, the set-up and host time around them (wall minus
    kernel) and, of that, the host time in serve rounds, the card's idle
    share, and instr/s over the kernel time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vm.execute_batch(func, args, max_steps=10**9)
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
    stats = vm.last_engine.hostcall_stats
    serve_s = stats["serve_s"]
    print(f"profile {func} x {MAIN_LANES}: kernel device time "
          f"{kernel_s * 1e3:.3f} ms over {count} launches "
          f"({kernel_s * 1e3 / count:.3f} ms per launch), wall "
          f"{wall * 1e3:.3f} ms, set-up and host {(wall - kernel_s) * 1e3:.3f}"
          f" ms (of which {stats['serve_rounds']} serve rounds "
          f"{serve_s * 1e3:.3f} ms; host<->device copies "
          f"{copy_s * 1e3:.3f} ms of device time), device idle share "
          f"{1.0 - kernel_s / wall:.4f}, "
          f"{retired / kernel_s:.4g} wasm instr/s over kernel time",
          flush=True)
    return dict(kernel_ms=kernel_s * 1e3, launches=count, wall_s=wall,
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
    with tempfile.TemporaryDirectory() as td:
        paths = [os.path.join(td, k) for k in ("run", "profile")]
        fds = [os.open(p, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
               for p in paths]
        try:
            vm = wasi_vm(build_echo(), fds[0])
            res, launches, wall, ev_ms, counts = run_main(
                vm, "echo", [ECHO_ITERS], 1 << 20, need=("interp", "hostcall"))
            stats = dict(vm.last_engine.hostcall_stats)
            retired = int(res.retired.astype(np.int64).sum())
            prof = profile_run(wasi_vm(build_echo(), fds[1]), "echo",
                               [ECHO_ITERS], retired)
        finally:
            for fd in fds:
                os.close(fd)
        runs = [open(p, "rb").read() for p in paths]
    for k, got in zip(("run", "profile"), runs):
        if got != want:
            fail(f"echo x {L} ({k}): stdout is {len(got)} B, expected "
                 f"{len(want)} B of the message")
    if not (res.trap == -1).all() or not (res.results[0] == 0).all():
        fail(f"echo x {L}: traps {np.unique(res.trap)}, results "
             f"{np.unique(res.results[0])[:5]}")
    if stats["tier1_calls"] != calls:
        fail(f"echo x {L}: {stats['tier1_calls']} host calls served, "
             f"expected {calls}")
    out["echo"] = dict(launches=launches, hostcall_launches=counts[
        "hostcall"], wall_s=wall, event_ms=ev_ms, retired=retired,
        host_calls=calls, host_calls_per_s=calls / wall,
        stdout_bytes=len(want), profile=prof, **stats)
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
                vm, "hello", [codes], 1 << 20, need=("interp", "hostcall"))
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
        vm, "bulk", args, 1 << 20, need=("interp", "bulk"))
    t0 = time.perf_counter()
    want, _ = bulk_workload_model(seeds, BULK_ITERS)
    t_model = time.perf_counter() - t0
    if not (res.trap == -1).all() or \
            not ((res.results[0] & 0xFFFFFFFF) == want).all():
        bad = int(((res.results[0] & 0xFFFFFFFF) != want).sum())
        fail(f"bulk x {L}: {bad} lanes disagree with the bytearray model, "
             f"traps {np.unique(res.trap)}")
    retired = int(res.retired.astype(np.int64).sum())
    F, C = BULK_FILL_BYTES, BULK_COPY_BYTES
    # the least bytes the bulk ops move (each filled byte written once,
    # each copied byte read and written once; lengths at their least)
    bulk_bytes = L * BULK_ITERS * (F + F // 4 + 2 * 2 * C)
    out = dict(launches=launches, bulk_launches=counts["bulk"], wall_s=wall,
               event_ms=ev_ms, retired=retired, model_s=t_model,
               min_bulk_bytes=bulk_bytes,
               bulk_bound_ms=bulk_bytes / HBM_BYTES_PER_S * 1e3)
    print(f"main bulk x {L} (1 page/lane, {BULK_ITERS} iterations of fills "
          f">= {F} B and overlapping copies >= {C} B): every lane equals "
          f"the bytearray model, {launches} launches, wall {wall:.3f} s, "
          f"events {ev_ms:.1f} ms, retired {retired}; the bulk ops' bytes "
          f">= {bulk_bytes} B, {out['bulk_bound_ms']:.4f} ms at "
          f"{HBM_BYTES_PER_S:.3g} B/s", flush=True)
    out["profile"] = profile_run(vm, "bulk", args, retired)
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
    print(f"spec simd.wast on the card (strict): {rep.passed} passed, "
          f"{rep.failed} failed, {rep.skipped} skipped, {counts['simd']} "
          f"v128 launches, wall {wall:.3f} s", flush=True)
    return dict(passed=rep.passed, failed=rep.failed, skipped=rep.skipped,
                launches=counts["simd"], wall_s=wall)


def simd_retired_model(vm, n_small=(1, 2)):
    """Instructions vloop(n) retires per lane, base + per * n, from two
    small runs of the plain version on the CPU."""
    counts = []
    for n in (0,) + tuple(n_small):
        res = vm.execute_batch("vloop", [np.full(1, n)], lanes=1,
                               max_steps=10**6, device="cpu")
        counts.append(int(res.retired[0]))
    base, per = counts[0], counts[1] - counts[0]
    if counts[2] - counts[1] != per:
        fail(f"vloop's retired count is not linear in n: {counts}")
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
    base, per = simd_retired_model(vm)
    want_retired = base + per * SIMD_N
    want = simd_loop_model(SIMD_N)
    res, launches, wall, ev_ms, counts = run_main(
        vm, "vloop", [np.full(L, SIMD_N)], 1 << 20, need=("interp", "simd"))
    if not (res.trap == -1).all() or \
            not ((res.results[0] & 0xFFFFFFFF) == want).all():
        fail(f"vloop({SIMD_N}) x {L}: traps {np.unique(res.trap)}, results "
             f"{np.unique(res.results[0])[:5]}, model {want}")
    if not (res.retired.astype(np.int64) == want_retired).all():
        fail(f"vloop({SIMD_N}) x {L}: retired {np.unique(res.retired)[:5]}, "
             f"expected {want_retired} per lane")
    retired = int(res.retired.astype(np.int64).sum())
    out = dict(n=SIMD_N, launches=launches, simd_launches=counts["simd"],
               wall_s=wall, event_ms=ev_ms, retired=retired,
               instr_per_s_wall=retired / wall,
               retired_per_lane=want_retired, per_iteration=per)
    print(f"main vloop({SIMD_N}) x {L}: every lane {want} (the model), "
          f"retired {want_retired} per lane ({base} + {per} per "
          f"iteration), {launches} launches, wall {wall:.3f} s, kernel "
          f"(events) {ev_ms:.1f} ms, {retired / wall:.4g} wasm instr/s over "
          f"wall", flush=True)
    out["profile"] = profile_run(vm, "vloop", [np.full(L, SIMD_N)], retired)
    return out


def phase_time_bulk():
    """One launch of the converged bulk pair at MAIN_LANES lanes: every
    lane fills 32 KiB at 0 and copies 16 KiB from 0 to 32 KiB, word
    aligned.  Kernel, plain version and the same fill and copy as PyTorch
    tensor calls on the memory plane, CUDA events; and an unaligned
    variant (fill at 1, copy 3 bytes back from 32769) on the kernel."""
    from wasmedge_tpu_torch.batch import interp, interp_ref
    from wasmedge_tpu_torch.models.fixtures import build_bulk_pair

    L = MAIN_LANES
    fill_n, copy_n, val = 32768, 16384, 0x5A
    eng, inst = make_engine(build_bulk_pair(), L, value_stack_depth=64,
                            call_stack_depth=16, memory_pages_per_lane=1)
    tb = eng.tables
    pair = inst.exports["pair"][1]
    chunk = 8  # 3 operands + fill, 3 operands + copy: 8 instructions
    kernel = lambda s: interp.run_chunk(tb, s, chunk, False)
    plain = lambda s: interp_ref.run_chunk(tb, s, chunk, False)
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
        kernel(st0.clone())  # warm-up
        torch.cuda.synchronize()
        ms, k25, k75, out_k = time_launch(kernel, st0, 21)
        plain_ms, p25, p75, out_p = time_launch(plain, st0, 3)
        err = max_abs_err(out_k, out_p)
        if err != 0 or not bool((out_k.pc == st0.pc + chunk).all()):
            fail(f"bulk pair ({name}): kernel != plain, max abs err {err}")
        out[name] = dict(ms=ms, q25=k25, q75=k75, plain_ms=plain_ms,
                         max_abs_err=err)
        if name == "aligned":
            st_aligned, mem_k = st0, out_k.mem
        print(f"bulk pair {name} x {L}: kernel median {ms:.4f} ms (q25 "
              f"{k25:.4f}, q75 {k75:.4f}, 21 runs), plain median "
              f"{plain_ms:.2f} ms (q25 {p25:.2f}, q75 {p75:.2f}, 3 runs), "
              f"equal", flush=True)

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
    # read once and written once; the work is data movement, with no
    # arithmetic to bound it
    nbytes = L * (fill_n + 2 * copy_n)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    a = out["aligned"]
    print(f"  library fill_ + copy_(clone) median {lib_ms:.4f} ms (q25 "
          f"{l25:.4f}, q75 {l75:.4f}, 21 runs); bound {bound_ms:.6f} ms by "
          f"bytes: {L} lanes x ({fill_n} B filled + 2 x {copy_n} B copied) "
          f"= {nbytes} B / {HBM_BYTES_PER_S:.3g} B/s; kernel at "
          f"{bound_ms / a['ms']:.3f} of the bound", flush=True)
    return dict(out, library_ms=lib_ms, bound_ms=bound_ms, bound_bytes=nbytes)


def kernel_registers() -> dict:
    """Registers, stack frame and spills of each compiled kernel
    instantiation and out-of-line device function, from ptxas -v."""
    from wasmedge_tpu_torch.batch import interp

    rows, cur = {}, None
    for line in interp.BUILD_INFO.get("ptxas", "").splitlines():
        m = re.search(r"(?:entry function|Function properties for) "
                      r"'?([\w$.]+)", line)
        if m:
            mangled = m.group(1)
            inst = re.search(r"interp_kernelILb(\d)ELb(\d)E", mangled)
            fn = re.search(r"(v[12]_op|alu[12]\w*|bulk_fill_copy)", mangled)
            cur = (f"interp_kernel<kBulk={inst.group(1)}, "
                   f"kSimd={inst.group(2)}>" if inst
                   else fn.group(1) if fn else mangled)
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
    interp.build_kernel()
    t_build = time.perf_counter() - t0
    print(f"phase build: {t_build:.2f} s (nvcc {interp.BUILD_INFO.get('seconds', 0):.2f} s)",
          flush=True)
    regs = kernel_registers()
    for name, r in regs.items():
        print(f"  ptxas: {name}: {r.get('registers', '-')} registers, "
              f"{r.get('stack_bytes', 0)} B stack frame, "
              f"{r.get('spill_stores', 0)} B spill stores, "
              f"{r.get('spill_loads', 0)} B spill loads", flush=True)

    t0 = time.perf_counter()
    worst = max(phase_kernel_vs_plain(), phase_hostcalls_kernel_vs_plain())
    simd_worst = phase_simd_kernel_vs_plain()
    timing = phase_time_one_launch()
    bulk_timing = phase_time_bulk()
    simd_timing = phase_time_simd_launch()
    t_kernel = time.perf_counter() - t0
    print(f"phase kernel_vs_plain: {t_kernel:.2f} s, max abs err "
          f"{max(worst, simd_worst)}", flush=True)

    t0 = time.perf_counter()
    main_out = phase_main()
    scalar = regs.get("interp_kernel<kBulk=0, kSimd=0>", {})
    print(f"fib(30) x {MAIN_LANES} ran interp_kernel<kBulk=0, kSimd=0> "
          f"({scalar.get('registers')} registers, "
          f"{scalar.get('spill_stores', 0)} B spill stores): wall "
          f"{main_out['fib30']['wall_s']:.3f} s", flush=True)
    main_out.update(phase_main_wasi())
    main_out["bulk"] = phase_main_bulk()
    main_out["simd_corpus"] = phase_simd_corpus()
    main_out["vloop"] = phase_main_simd()
    t_main = time.perf_counter() - t0
    print(f"phase main: {t_main:.2f} s", flush=True)

    fib_prof = main_out["fib30"]["profile"]
    # "ms", "plain_ms" and "bound_ms" are for one launch of TIMED_STEPS
    # steps (the plain version cannot run a main-path launch in the time
    # limit); "main_ms_per_launch" is the kernel's device time per launch
    # of the main path's fib(30) run, whose launches "launches" counts.
    record = {
        "name": "wasm_interp",
        "route": "cuda",
        "source": "wasmedge_tpu_torch/csrc/interp.cu",
        "replaces": "wasmedge_tpu/batch/pallas_engine.py:3825",
        "launches": main_out["fib30"]["launches"],
        "max_abs_err": max(worst, timing["max_abs_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "timed_launch": {"workload": "fib(30)", "lanes": MAIN_LANES,
                         "steps": TIMED_STEPS,
                         "retired": timing["retired"]},
        "main_ms_per_launch": fib_prof["kernel_ms"] / fib_prof["launches"],
    }
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
        "max_abs_err": max(worst, bulk_timing["aligned"]["max_abs_err"],
                           bulk_timing["unaligned"]["max_abs_err"]),
        "ms": bulk_timing["aligned"]["ms"],
        "plain_ms": bulk_timing["aligned"]["plain_ms"],
        "bound_ms": bulk_timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": bulk_timing["library_ms"],
        "unaligned_ms": bulk_timing["unaligned"]["ms"],
    }
    # the B7 cases of the same kernel (its kSimd instantiations): "ms",
    # "plain_ms" and "bound_ms" are for one launch of TIMED_STEPS steps of
    # vloop(SIMD_N) x MAIN_LANES; "launches" counts the main path's
    # vloop launches, "main_ms_per_launch" is their device time per launch
    vloop_prof = main_out["vloop"]["profile"]
    simd_record = {
        "name": "v128",
        "route": "cuda",
        "source": "wasmedge_tpu_torch/csrc/interp.cu",
        "replaces": "wasmedge_tpu/batch/pallas_engine.py:3203",
        "launches": main_out["vloop"]["simd_launches"],
        "max_abs_err": max(simd_worst, simd_timing["max_abs_err"]),
        "ms": simd_timing["ms"],
        "plain_ms": simd_timing["plain_ms"],
        "bound_ms": simd_timing["bound_ms"],
        "bound_by": simd_timing["bound_by"],
        "library_ms": None,
        "timed_launch": {"workload": f"vloop({SIMD_N})",
                         "lanes": MAIN_LANES, "steps": TIMED_STEPS,
                         "retired": simd_timing["retired"]},
        "main_ms_per_launch": vloop_prof["kernel_ms"] / vloop_prof["launches"],
    }
    print(json.dumps({"phases_s": {"build": t_build, "kernel": t_kernel,
                                   "main": t_main},
                      "registers": regs, "bulk_pair": bulk_timing,
                      "simd_launch": simd_timing, "main": main_out}),
          flush=True)
    print(json.dumps({"kernels": [record, bulk_record, simd_record]}),
          flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
