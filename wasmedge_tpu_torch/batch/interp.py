"""The warp-interpreter: handler ids, code tables and the CUDA kernel's wrapper.

Counterpart of `wasmedge_tpu/batch/pallas_engine.py`, whose one
`pl.pallas_call` (`_build_kernel`, :637; the call at :3825) runs up to
`chunk` Wasm instructions for every lane block inside one launch.  The
Pallas kernel keeps one scalar pc per lane block (the TPU runs one
instruction stream per VMEM block) and bails out to a block scheduler and
a SIMT engine when the lanes of a block disagree.  An H100 runs one pc
per thread natively, so the CUDA kernel (`csrc/interp.cu`) gives every
lane its own pc, sp, fp, operand base, call depth, page count, fuel and
retired count in registers, and the per-lane results equal what the
Pallas kernel, the block scheduler and the SIMT residue give together.

The code tables come in three encodings (`device_tables`): one op per
dispatch ("none"), B2 fused basic blocks ("blocks") and B6 peephole
superinstructions ("super"), planned by `batch/fusion.py` as the Pallas
kernel plans them.  The per-op encoding runs the shared kernel build; a
fused encoding runs a kernel built for its module, `csrc/interp.cu` with
the dispatch that `batch/fusegen.py` generates for its blocks or
superinstructions.  With `mem_window` (B4) every memory access goes
through each lane's window cache in shared memory (`csrc/memwin.cuh`;
plain version `batch/memwin.py`) instead of the plane in global memory.  Every launch
runs one-warp blocks, each lane's low stack rows in its block's shared
memory (`block_geometry`).  With
`optimistic` (B3) each warp that starts a launch converged runs its lane
0's decisions, with a canary, snapshots and rollbacks
(`csrc/optimistic.cuh`; plain version `batch/optimistic.py`), and its
per-warp state (`WarpState`) goes with the launch.

`run_chunk()` is the one entry: on CUDA tensors it launches the kernel
(built from the repository's sources on first use), on CPU tensors it
runs the plain PyTorch interpreter of `batch/interp_ref.py`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np
import torch

from wasmedge_tpu_torch.batch.image import (
    CLS_ALU1, CLS_ALU2, CLS_BR, CLS_BR_TABLE, CLS_BRNZ, CLS_BRZ, CLS_CALL,
    CLS_CALL_INDIRECT, CLS_CONST, CLS_DROP, CLS_GLOBAL_GET, CLS_GLOBAL_SET,
    CLS_HOSTCALL, CLS_LOAD, CLS_LOCAL_GET, CLS_LOCAL_SET, CLS_LOCAL_TEE,
    CLS_MEMCOPY, CLS_MEMFILL, CLS_MEMGROW, CLS_MEMSIZE, CLS_NOP, CLS_RETURN,
    CLS_SELECT, CLS_STORE, CLS_TRAP, CLS_V1, CLS_V2, CLS_VBITSEL,
    CLS_VCONST, CLS_VEXTRACT, CLS_VLOAD, CLS_VREPLACE, CLS_VSHIFT,
    CLS_VSHUFFLE, CLS_VSPLAT, CLS_VSTORE, CLS_VTEST, NUM_ALU1, NUM_ALU2,
    DeviceImage, TRAP_DONE, TRAP_HOSTCALL)
from wasmedge_tpu_torch.batch.memwin import HBM_WINDOW_ROWS
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.batch.simdops import (
    V1_NAMES, V2_NAMES, VEXTRACT_NAMES, VREPLACE_NAMES, VSHIFT_NAMES,
    VSPLAT_NAMES, VTEST_NAMES)

# ---------------------------------------------------------------------------
# Flat handler-id space (numbering shared with pallas_engine.py :103-185)
# ---------------------------------------------------------------------------
H_NOP = 0
H_CONST = 1
H_LOCAL_GET = 2
H_LOCAL_SET = 3
H_LOCAL_TEE = 4
H_GLOBAL_GET = 5
H_GLOBAL_SET = 6
H_DROP = 7
H_SELECT = 8
H_BR = 9
H_BRZ = 10
H_BRNZ = 11
H_BR_TABLE = 12
H_RETURN = 13
H_CALL = 14
H_CALL_INDIRECT = 15
H_MEMSIZE = 16
H_MEMGROW = 17
H_TRAP = 18
H_LOAD = 19
H_STORE = 20
H_HOSTCALL = 21
H_MEMFILL = 22
H_MEMCOPY = 23
H_ALU2_BASE = 24                      # + ALU2 sub id
H_ALU1_BASE = H_ALU2_BASE + NUM_ALU2  # + ALU1 sub id
# Peephole superinstructions (B6, pallas_engine.py :129-152; planner
# batch/fusion.py fuse_image), each family one id per ALU2 sub:
#   GCA:   local.get a; const imm; alu2            -> pc += 3
#   GCB:   local.get a; const imm; alu2; brz b     -> pc += 4
#   A2R:   alu2; return (one result)               -> pc += 2
#   GCC:   local.get a; const imm; alu2; call b    -> pc += 4
#   GCS:   local.get a; const imm; alu2; local.set b
#   GGA:   local.get a; local.get c; alu2          -> pc += 3
#   GGS:   local.get a; local.get c; alu2; local.set b
#   GGBZ:  local.get ilo; local.get ihi; alu2; brz a
#   GGBNZ: local.get ilo; local.get ihi; alu2; brnz a, b, c
#   GBR:   local.get ilo; br a, b, c               -> pc += 2
H_FUSE_GCA_BASE = H_ALU1_BASE + NUM_ALU1
H_FUSE_GCB_BASE = H_FUSE_GCA_BASE + NUM_ALU2
H_FUSE_A2R_BASE = H_FUSE_GCB_BASE + NUM_ALU2
H_FUSE_GCC_BASE = H_FUSE_A2R_BASE + NUM_ALU2
H_FUSE_GCS_BASE = H_FUSE_GCC_BASE + NUM_ALU2
H_FUSE_GGA_BASE = H_FUSE_GCS_BASE + NUM_ALU2
H_FUSE_GGS_BASE = H_FUSE_GGA_BASE + NUM_ALU2
H_FUSE_GGBZ_BASE = H_FUSE_GGS_BASE + NUM_ALU2
H_FUSE_GGBNZ_BASE = H_FUSE_GGBZ_BASE + NUM_ALU2
H_FUSE_GBR = H_FUSE_GGBNZ_BASE + NUM_ALU2
H_LOAD_W = H_FUSE_GBR + 1    # i32.load / f32.load / i64.load32_u
H_LOAD_D = H_FUSE_GBR + 2    # i64.load / f64.load
H_STORE_W = H_FUSE_GBR + 3   # i32.store / f32.store / i64.store32
H_STORE_D = H_FUSE_GBR + 4   # i64.store / f64.store
# v128 (pallas_engine.py :160-185): cells are four int32 planes (lo, hi,
# e2, e3); the sub-indexed families get one id per op, numbered densely
H_VCONST = H_STORE_D + 1
H_VSHUFFLE = H_VCONST + 1
H_VBITSEL = H_VSHUFFLE + 1
H_VLOAD = H_VBITSEL + 1
H_VSTORE = H_VLOAD + 1
H_V2_BASE = H_VSTORE + 1
H_V1_BASE = H_V2_BASE + len(V2_NAMES)
H_VTEST_BASE = H_V1_BASE + len(V1_NAMES)
H_VSHIFT_BASE = H_VTEST_BASE + len(VTEST_NAMES)
H_VSPLAT_BASE = H_VSHIFT_BASE + len(VSHIFT_NAMES)
H_VEXTRACT_BASE = H_VSPLAT_BASE + len(VSPLAT_NAMES)
H_VREPLACE_BASE = H_VEXTRACT_BASE + len(VEXTRACT_NAMES)
NUM_HANDLERS = H_VREPLACE_BASE + len(VREPLACE_NAMES)

_CLS_TO_HID = {
    CLS_NOP: H_NOP, CLS_CONST: H_CONST, CLS_LOCAL_GET: H_LOCAL_GET,
    CLS_LOCAL_SET: H_LOCAL_SET, CLS_LOCAL_TEE: H_LOCAL_TEE,
    CLS_GLOBAL_GET: H_GLOBAL_GET, CLS_GLOBAL_SET: H_GLOBAL_SET,
    CLS_DROP: H_DROP, CLS_SELECT: H_SELECT, CLS_BR: H_BR, CLS_BRZ: H_BRZ,
    CLS_BRNZ: H_BRNZ, CLS_BR_TABLE: H_BR_TABLE, CLS_RETURN: H_RETURN,
    CLS_CALL: H_CALL, CLS_CALL_INDIRECT: H_CALL_INDIRECT,
    CLS_MEMSIZE: H_MEMSIZE, CLS_MEMGROW: H_MEMGROW, CLS_TRAP: H_TRAP,
    CLS_LOAD: H_LOAD, CLS_STORE: H_STORE, CLS_HOSTCALL: H_HOSTCALL,
    CLS_MEMFILL: H_MEMFILL, CLS_MEMCOPY: H_MEMCOPY,
    CLS_VCONST: H_VCONST, CLS_VSHUFFLE: H_VSHUFFLE,
    CLS_VBITSEL: H_VBITSEL, CLS_VLOAD: H_VLOAD, CLS_VSTORE: H_VSTORE,
}

# sub-indexed v128 classes -> handler base id
_VCLS_TO_BASE = {
    CLS_V2: H_V2_BASE, CLS_V1: H_V1_BASE, CLS_VTEST: H_VTEST_BASE,
    CLS_VSHIFT: H_VSHIFT_BASE, CLS_VSPLAT: H_VSPLAT_BASE,
    CLS_VEXTRACT: H_VEXTRACT_BASE, CLS_VREPLACE: H_VREPLACE_BASE,
}

# The reference kernel reports per lane block through the ST_* status of
# its ctrl row (pallas_engine.py :209-224).  The per-lane CUDA kernel
# reports through the trap plane alone: a lane is running (0), done
# (TRAP_DONE), parked at a host call (TRAP_HOSTCALL) or trapped (its
# ErrCode); ST_DIVERGED, ST_REGROW and ST_RECHECK have no counterpart.


def hid_plane(img: DeviceImage) -> np.ndarray:
    """Per-pc flat handler id from the (class, sub) encoding
    (pallas_engine.py :598)."""
    hid = np.zeros(img.code_len, np.int32)
    for pc in range(img.code_len):
        c = int(img.cls[pc])
        if c == CLS_ALU2:
            hid[pc] = H_ALU2_BASE + int(img.sub[pc])
        elif c == CLS_ALU1:
            hid[pc] = H_ALU1_BASE + int(img.sub[pc])
        elif c in _VCLS_TO_BASE:
            hid[pc] = _VCLS_TO_BASE[c] + int(img.sub[pc])
        elif c == CLS_LOAD and int(img.b[pc]) == 4 \
                and int(img.c[pc]) in (0, 2):
            hid[pc] = H_LOAD_W
        elif c == CLS_LOAD and int(img.b[pc]) == 8:
            hid[pc] = H_LOAD_D
        elif c == CLS_STORE and int(img.b[pc]) == 4:
            hid[pc] = H_STORE_W
        elif c == CLS_STORE and int(img.b[pc]) == 8:
            hid[pc] = H_STORE_D
        else:
            hid[pc] = _CLS_TO_HID[c]
    return hid


FUSIONS = ("none", "blocks", "super")


@dataclasses.dataclass
class Tables:
    """Read-only int32 code tables on one device, plus the geometry the
    interpreter needs.

    `a`, `b`, `c`, `ilo` and `ihi` are the planes every op read one at a
    time uses.  With a fused encoding (`fusion` "blocks" or "super") `hid`
    holds the fused ids at the head slots, `hid0` the original hid plane
    (a head slot whose fused dispatch does not fit the lane's budget runs
    its original op), `flen` the instructions a fused dispatch retires in
    full (0 at other slots), `shapes` the block shapes, and, for "super",
    `fa` ... `fihi` the rewritten operand planes that the superinstruction
    handlers read at their head slots.  `mem_window`: memory accesses go
    through each lane's window cache (B4; `batch/engine.py`
    `mem_window_of` chooses it).  `optimistic`: warps that start a launch
    converged run optimistic convergence (B3; `batch/engine.py`
    `optimistic_of` chooses it).  `stack_split`: the build whose stack
    rows at or above the rows on chip stay in global memory (the depth
    the tables run at does not fit on chip, `stack_split()`)."""

    hid: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    ilo: torch.Tensor
    ihi: torch.Tensor
    fent: torch.Tensor
    fnpar: torch.Tensor
    fnloc: torch.Tensor
    ftop: torch.Tensor
    ftyp: torch.Tensor
    brt: torch.Tensor      # flat [3 * n_entries]: (target, keep, pop)
    tbl: torch.Tensor      # table 0: funcidx + 1, 0 = null
    v128: torch.Tensor     # flat [4 * n]: v128.const values, shuffle masks
    max_local_zeros: int
    mem_pages_max: int
    has_bulk: bool = False      # the code holds memory.fill / memory.copy
    has_hostcall: bool = False  # the code holds HOSTCALL stubs
    has_simd: bool = False      # the code holds v128 ops (4-word cells)
    fusion: str = "none"
    hid0: Optional[torch.Tensor] = None
    flen: Optional[torch.Tensor] = None
    fa: Optional[torch.Tensor] = None
    fb: Optional[torch.Tensor] = None
    fc: Optional[torch.Tensor] = None
    filo: Optional[torch.Tensor] = None
    fihi: Optional[torch.Tensor] = None
    shapes: tuple = ()
    fused_source: str = ""  # the generated CUDA of the fused dispatch
    mem_window: bool = False
    optimistic: bool = False
    stack_split: bool = True


def device_tables(img: DeviceImage, device, fusion: str = "none",
                  mem_window: bool = False, optimistic: bool = False,
                  stack_depth: Optional[int] = None) -> Tables:
    """The image's code tables on `device` in the encoding `fusion`:
    "none" (one op per dispatch), "blocks" (B2 fused basic blocks) or
    "super" (B6 superinstructions; images without v128 ops only); with
    `mem_window`, memory through the window cache (an image with a
    memory); with `optimistic`, the kernel with optimistic convergence;
    `stack_depth`, the value-stack depth the tables run at (the build
    without the stack split when every row fits on chip, `stack_split`;
    None: any depth)."""
    from wasmedge_tpu_torch.batch import fusegen
    from wasmedge_tpu_torch.batch.fusion import (
        fuse_blocks, fuse_image, fused_lengths)

    if fusion not in FUSIONS:
        raise ValueError(f"unknown fusion {fusion!r}; one of {FUSIONS}")
    if mem_window and not img.has_memory:
        raise ValueError("the window cache needs an image with a memory")

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32).ravel(),
                               device=device)

    hid = hid_plane(img)
    tables = Tables(
        hid=t(hid), a=t(img.a), b=t(img.b), c=t(img.c),
        ilo=t(img.imm_lo), ihi=t(img.imm_hi), fent=t(img.f_entry),
        fnpar=t(img.f_nparams), fnloc=t(img.f_nlocals),
        ftop=t(img.f_frame_top), ftyp=t(img.f_type), brt=t(img.br_table),
        tbl=t(img.table0), v128=t(img.v128),
        max_local_zeros=int(img.max_local_zeros),
        mem_pages_max=int(img.mem_pages_max),
        has_bulk=bool(np.isin(hid, (H_MEMFILL, H_MEMCOPY)).any()),
        has_hostcall=bool((hid == H_HOSTCALL).any()),
        has_simd=bool(img.has_simd), fusion=fusion,
        mem_window=bool(mem_window), optimistic=bool(optimistic),
        stack_split=stack_split(stack_depth, bool(img.has_simd),
                                bool(mem_window)))
    if fusion == "none":
        return tables
    if fusion == "blocks":
        fhid, shapes = fuse_blocks(hid, img)
    else:
        if img.has_simd:
            raise ValueError("superinstructions move two-word cells: an "
                             "image with v128 ops runs 'blocks' or 'none'")
        fhid, fa, fb, fc, filo, fihi = fuse_image(
            hid, img.a, img.b, img.c, img.imm_lo, img.imm_hi, img)
        shapes = ()
        tables.fa, tables.fb, tables.fc = t(fa), t(fb), t(fc)
        tables.filo, tables.fihi = t(filo), t(fihi)
    tables.hid0 = tables.hid
    tables.hid = t(fhid)
    tables.flen = t(fused_lengths(fhid, shapes))
    tables.shapes = shapes
    tables.fused_source = fusegen.cuda_source(
        fhid, shapes, tables.has_bulk, tables.has_simd, tables.mem_window,
        tables.optimistic, tables.stack_split,
        **(dict(img=img, hid0=hid) if fusion == "blocks" else {}))
    return tables


# ---------------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_SRC = os.path.join(_CSRC, "interp.cu")
_FUSED_HDR = os.path.join(_CSRC, "fused.cuh")
_WIN_HDR = os.path.join(_CSRC, "memwin.cuh")
_OPT_HDR = os.path.join(_CSRC, "optimistic.cuh")
_BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-shared", "-Xcompiler", "-fPIC")

# Launches of the CUDA kernels since the counts were last set to 0 (the
# plain version never counts): all of them, those whose code holds the
# bulk-memory cases (h_memfill / h_memcopy), those whose code holds
# host-call stubs (h_hostcall), those whose code holds v128 ops (the B7
# handlers), those of the fused kernels: B2 basic blocks ("block") and
# B6 superinstructions ("super"), those whose memory accesses went
# through the window cache (B4, "window") and those of the kernels with
# optimistic convergence (B3, "optimistic").
LAUNCHES = {"interp": 0, "bulk": 0, "hostcall": 0, "simd": 0, "block": 0,
            "super": 0, "window": 0, "optimistic": 0}

_libs = {}  # build key -> loaded ctypes library
_lib_lock = threading.Lock()
# "per_op" maps each per-op build (`per_op_label`) to its "path",
# "seconds" and "ptxas" (its -v output); "fused" maps each fused build's
# key to the same three and "fusion", "shapes", "mean_len", "mem_window"
# and "optimistic".
BUILD_INFO = {"fused": {}, "per_op": {}}


def per_op_label(win: bool, opt: bool, split: bool = False) -> str:
    """The name of the per-op build with or without the window cache,
    optimistic convergence and the stack split."""
    return ("window" if win else "direct") + (
        ", optimistic" if opt else "") + (", split stack" if split else "")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# generated source, or the per-op kernel's (window, optimistic) flags ->
# _job's result
_jobs = {}


def _defines(win: bool, opt: bool, split: bool) -> tuple:
    """The per-op build's extra nvcc flags: its window, optimistic and
    stack-split instantiations."""
    return (f"-DWASM_MEM_WINDOW={int(win)}", f"-DWASM_OPTIMISTIC={int(opt)}",
            f"-DWASM_STACK_SPLIT={int(split)}")


def _job(tables: Optional[Tables], win: bool = False, opt: bool = False,
         split: bool = False):
    """(key, shared library path, source path) of the kernel that runs
    `tables`: the per-op build (tables None or of the "none" encoding;
    with the window cache when `win` or `tables.mem_window`, with
    optimistic convergence when `opt` or `tables.optimistic`, with the
    stack split when `split` or `tables.stack_split`) or the fused build
    of `tables` (its generated source goes under _build/ when it is
    built)."""
    if tables is not None and tables.fusion == "none":
        tables, win, opt, split = (None, tables.mem_window,
                                   tables.optimistic, tables.stack_split)
    text = (bool(win), bool(opt), bool(split)) if tables is None \
        else tables.fused_source
    if text not in _jobs:
        _jobs[text] = _new_job(tables, win, opt, split)
    return _jobs[text]


def _new_job(tables: Optional[Tables], win: bool, opt: bool, split: bool):
    flags = " ".join(NVCC_FLAGS).encode()
    srcs = _read(_SRC) + _read(_WIN_HDR) + _read(_OPT_HDR)
    if tables is None:
        key = hashlib.sha256(
            srcs + flags + " ".join(_defines(win, opt, split)).encode()) \
            .hexdigest()[:16]
        return key, os.path.join(_BUILD_DIR, f"libinterp_{key}.so"), _SRC
    src = tables.fused_source.encode()
    key = hashlib.sha256(srcs + _read(_FUSED_HDR) + src + flags) \
        .hexdigest()[:16]
    cu = os.path.join(_BUILD_DIR, f"fused_{key}.cu")
    return key, os.path.join(_BUILD_DIR, f"libfused_{key}.so"), cu


def build_kernels(tables_list=(), per_op=((False, False, False),)) -> dict:
    """Build, all nvcc processes at once, the per-op kernel
    (`csrc/interp.cu`, four instantiations, a library for each (window,
    optimistic, stack split) triple in `per_op` and for each per-op
    `Tables` given) and
    the fused kernel of each fused `Tables` given (`csrc/interp.cu` with
    `csrc/fused.cuh` and the generated dispatch of its blocks or
    superinstructions, one instantiation), each into a shared library
    under `_build/` keyed by the hash of its sources and flags, and load
    them.  Returns {key: library}; `BUILD_INFO` records paths, build
    seconds and ptxas output.  Raises if any build fails."""
    with _lib_lock:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        jobs = {}
        triples = {(bool(w), bool(o), bool(x)) for w, o, x in per_op}
        for tb in tables_list:
            if tb.fusion == "none":
                triples.add((tb.mem_window, tb.optimistic, tb.stack_split))
        for win, opt, split in sorted(triples):
            key, so, src = _job(None, win, opt, split)
            jobs[key] = (so, src, None, (win, opt, split))
        for tb in tables_list:
            if tb.fusion == "none":
                continue  # one of the per-op builds above
            key, so, src = _job(tb)
            jobs.setdefault(key, (so, src, tb, (tb.mem_window, tb.optimistic,
                                                tb.stack_split)))
        procs = {}
        for key, (so, src, tb, flags) in jobs.items():
            if key in _libs or os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            if tb is not None:
                with open(f"{src}.{os.getpid()}.tmp", "w") as f:
                    f.write(tb.fused_source)
                os.replace(f"{src}.{os.getpid()}.tmp", src)
            defines = _defines(*flags) if tb is None else ()
            cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-Xptxas", "-v", "-I",
                   _CSRC, "-o", tmp, src]
            # nvcc's output goes to a file: a full pipe would stall it
            log = open(f"{tmp}.log", "w+")
            procs[key] = (subprocess.Popen(cmd, stdout=log, stderr=log),
                          tmp, time.perf_counter(), log)
        # each build's own seconds: poll until every nvcc has ended
        ended, logs = {}, {}
        try:
            while len(ended) < len(procs):
                for key, (proc, _, t0, _) in procs.items():
                    if key not in ended and proc.poll() is not None:
                        ended[key] = time.perf_counter() - t0
                time.sleep(0.05)
        finally:
            for key, (proc, _, _, log) in procs.items():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.seek(0)
                logs[key] = log.read()
                log.close()
                os.remove(log.name)
        for key, (proc, tmp, _, _) in procs.items():
            so, src, tb, flags = jobs[key]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{src}:\n{logs[key]}")
            os.replace(tmp, so)
            info = {"path": so, "seconds": ended[key], "ptxas": logs[key]}
            if tb is not None:
                BUILD_INFO["fused"][key] = info
            else:
                BUILD_INFO["per_op"][per_op_label(*flags)] = info
        for key, (so, _, tb, flags) in jobs.items():
            if key in _libs:
                continue
            lib = ctypes.CDLL(so)
            extra = 0
            fn = lib.wasm_interp_launch if tb is None \
                else lib.wasm_fused_launch
            if tb is not None:
                extra = len(_FUSED_FIELDS)
                n_ops = [len(s) for s in tb.shapes]
                BUILD_INFO["fused"].setdefault(key, {"path": so}).update(
                    fusion=tb.fusion, shapes=len(tb.shapes),
                    mean_len=float(np.mean(n_ops)) if n_ops else 0.0,
                    mem_window=bool(flags[0]), optimistic=bool(flags[1]),
                    stack_split=bool(flags[2]))
            else:
                BUILD_INFO["per_op"].setdefault(
                    per_op_label(*flags), {}).setdefault("path", so)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * (_N_PTRS + extra + _N_OPT) + \
                [ctypes.c_int] * _N_INTS + [ctypes.c_void_p]
            _libs[key] = lib
        return {key: _libs[key] for key in jobs}


# The launch geometry (csrc/interp.cu): threads per block (one warp), the
# shared memory a block may use on an H100 (opt-in), what is kept for
# static shared memory, the most stack rows kept on chip, and the window
# cache's bytes per block (csrc/memwin.cuh: two ways of HBM_WINDOW_ROWS
# words per thread).
BLOCK_THREADS = 32
SMEM_BLOCK_MAX = 232448
SMEM_STATIC = 1024
STACK_ROWS_MAX = 512
WIN_SMEM_BYTES = 2 * HBM_WINDOW_ROWS * BLOCK_THREADS * 4


def stack_split(depth: Optional[int], simd: bool, win: bool) -> bool:
    """Whether a launch at value-stack depth `depth` needs the build that
    splits the stack between shared and global memory (csrc/interp.cu
    WASM_STACK_SPLIT): its rows do not all fit on chip (None: any
    depth)."""
    return depth is None or \
        block_geometry(depth, simd, win)["stack_rows"] < depth


def block_geometry(depth: int, simd: bool, win: bool) -> dict:
    """What a launch at value-stack depth `depth` asks for (csrc/interp.cu
    `stack_rows` / `block_smem`, the same rule): threads per block, the
    stack rows each lane keeps in shared memory ("stack_rows": the lowest
    rows of its 2 stack planes, 4 with v128 cells, up to what the budget
    left after the windows holds, in whole 32-row steps, and at most
    STACK_ROWS_MAX), and the dynamic shared bytes per block (windows, then
    stack rows)."""
    planes = 4 if simd else 2
    win_bytes = WIN_SMEM_BYTES if win else 0
    budget = SMEM_BLOCK_MAX - SMEM_STATIC - win_bytes
    rows = min((budget // (planes * 4 * BLOCK_THREADS)) & ~31, STACK_ROWS_MAX)
    rows = min(max(int(depth), 0), rows)
    return {"threads_per_block": BLOCK_THREADS, "stack_rows": rows,
            "smem_bytes": win_bytes + rows * planes * 4 * BLOCK_THREADS}


KERNEL_ATTRS = ("registers", "local_bytes", "static_smem_bytes",
                "max_dynamic_smem_bytes", "launch_smem_bytes",
                "blocks_per_sm", "threads_per_block", "stack_rows",
                "stack_split")


def _attrs(fn, *args) -> dict:
    out = (ctypes.c_int * len(KERNEL_ATTRS))()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"kernel attributes: CUDA error {err}")
    return dict(zip(KERNEL_ATTRS, list(out)))


def kernel_attributes(tables: Tables, depth: int) -> dict:
    """What the CUDA runtime reports of the instantiation that runs
    `tables` (built if need be), with the shared memory of its launch at
    value-stack depth `depth`: `KERNEL_ATTRS` (blocks per SM: of one warp;
    the last three from the kernel's own geometry and build)."""
    key = _job(tables)[0]
    lib = _libs.get(key) or build_kernels([tables])[key]
    if tables.fusion != "none":
        return _attrs(lib.wasm_fused_attrs, int(depth))
    return _attrs(lib.wasm_interp_attrs, int(tables.has_bulk),
                  int(tables.has_simd), int(depth))


def per_op_attributes(win: bool, opt: bool = False, depth: int = 256,
                      split: bool = False) -> dict:
    """`kernel_attributes` of the four instantiations of the per-op build
    (with the window cache when `win`, with optimistic convergence when
    `opt`, with the stack split when `split`) at value-stack depth
    `depth`, keyed "kBulk=b, kSimd=s"."""
    key = _job(None, win, opt, split)[0]
    lib = _libs.get(key) or build_kernels(per_op=((win, opt, split),))[key]
    return {f"kBulk={b}, kSimd={s}": _attrs(lib.wasm_interp_attrs, b, s,
                                            int(depth))
            for b in (0, 1) for s in (0, 1)}


def _bulk_counts(lib, clear: bool) -> list:
    out = (ctypes.c_ulonglong * 3)()
    fn = lib.wasm_bulk_counts
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    err = fn(out, int(clear))
    if err != 0:
        raise RuntimeError(f"bulk counts: CUDA error {err}")
    return list(out)


def bulk_counts(tables: Tables, clear: bool = False) -> dict:
    """The bulk-op counts of the library that runs `tables` (built if need
    be) since they were last cleared: "warp_passes" (memory.fill /
    memory.copy groups that the warp-cooperative row pass ran),
    "warp_lanes" (the lanes in them) and "lane_walks" (lanes that walked
    their own column: alone in their group, or in a warp with fewer than
    8 threads at the op); set to 0 after the read when `clear`."""
    key = _job(tables)[0]
    lib = _libs.get(key) or build_kernels([tables])[key]
    return dict(zip(("warp_passes", "warp_lanes", "lane_walks"),
                    _bulk_counts(lib, clear)))


def clear_bulk_counts() -> None:
    """Set the bulk-op counts of every loaded library to 0."""
    for lib in _libs.values():
        _bulk_counts(lib, True)


def fused_kernel_key(tables: Tables) -> str:
    """The build key of the fused kernel of `tables` (BUILD_INFO["fused"]
    is keyed by it)."""
    return _job(tables)[0]


# Pointer arguments, in the order of wasm_interp_launch's signature;
# wasm_fused_launch has the fused tables after the state planes; then
# both take the per-warp tensors and shadow planes of optimistic
# convergence (null for a careful launch).
_TABLE_FIELDS = ("hid", "a", "b", "c", "ilo", "ihi", "fent", "fnpar",
                 "fnloc", "ftop", "ftyp", "brt", "tbl", "v128")
_STATE_FIELDS = ("pc", "sp", "fp", "opbase", "call_depth", "trap", "retired",
                 "fuel", "mem_pages", "stack_lo", "stack_hi", "stack_e2",
                 "stack_e3", "fr_ret_pc", "fr_fp", "fr_opbase", "glob_lo",
                 "glob_hi", "mem")
_FUSED_FIELDS = ("hid0", "flen", "fa", "fb", "fc", "filo", "fihi")
_OPT_FIELDS = WarpState.COUNTERS + (
    "sh_lo", "sh_hi", "sh_e2", "sh_e3", "sh_fr_ret_pc", "sh_fr_fp",
    "sh_fr_opbase", "sh_glo", "sh_ghi", "sh_mem")
_N_PTRS = len(_TABLE_FIELDS) + len(_STATE_FIELDS)
_N_OPT = len(_OPT_FIELDS)
# code_len, nf, n_brt, tsize, nv (v128 table rows), L, D, CD, NG, W,
# chunk, fuel_on, max_local_zeros, mem_pages_max, bulk, simd, win and opt
# (the kernel instantiations with the memory.fill / memory.copy cases,
# with the v128 handlers, with the window cache and with optimistic
# convergence), snap_max (the ceiling of a warp's interval)
_N_INTS = 19


def _check(name, t, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.int32")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def run_chunk(tables: Tables, st, chunk: int, fuel_on: bool,
              warps: Optional[WarpState] = None) -> None:
    """Run every live lane for up to `chunk` instructions, in place on
    the state `st` (a `batch.engine.BatchState`).  CUDA tensors launch
    the kernel of the tables' encoding (and memory mode: with
    `mem_window` the window-cache instantiation, or an error; with
    `optimistic` the instantiation with optimistic convergence, which
    updates `warps`, a fresh `WarpState` when None); CPU tensors run the
    plain interpreter."""
    device = st.pc.device
    if device.type == "cpu":
        from wasmedge_tpu_torch.batch import interp_ref

        interp_ref.run_chunk(tables, st, chunk, fuel_on, warps)
        return
    if device.type != "cuda":
        raise ValueError(f"no interpreter for device {device}")
    if tables.optimistic and warps is None:
        warps = WarpState.new(st.pc.shape[0], device)
    _check_launch(tables, st, warps, device)
    key = _job(tables)[0]
    lib = _libs.get(key) or build_kernels([tables])[key]
    launch = lib.wasm_fused_launch if tables.fusion != "none" \
        else lib.wasm_interp_launch
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs, ints = launch_args(tables, st, chunk, fuel_on, warps)
    with torch.cuda.device(device):
        err = launch(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"interpreter kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["interp"] += 1
    LAUNCHES["bulk"] += tables.has_bulk
    LAUNCHES["hostcall"] += tables.has_hostcall
    LAUNCHES["simd"] += tables.has_simd
    LAUNCHES["block"] += tables.fusion == "blocks"
    LAUNCHES["super"] += tables.fusion == "super"
    LAUNCHES["window"] += tables.mem_window
    LAUNCHES["optimistic"] += tables.optimistic


def _check_launch(tables: Tables, st, warps, device) -> None:
    """Raise unless the tables, the state and the per-warp state are the
    kernel's: int32, contiguous, on `device`, of the state's geometry."""
    L = st.pc.shape[0]
    D = st.stack_lo.shape[0]
    CD = st.fr_ret_pc.shape[0]
    NG = st.glob_lo.shape[0]
    W = st.mem.shape[0]
    n = tables.hid.shape[0]
    fused = tables.fusion != "none"
    for f in _TABLE_FIELDS + (("hid0", "flen") if fused else ()):
        _check(f, getattr(tables, f), device, None)
    for f in ("a", "b", "c", "ilo", "ihi") + (
            _FUSED_FIELDS if tables.fusion == "super" else
            ("hid0", "flen") if fused else ()):
        _check(f, getattr(tables, f), device, (n,))
    simd = tables.has_simd
    if (st.stack_e2 is not None) != simd or (st.stack_e3 is not None) != simd:
        raise ValueError("stack_e2 / stack_e3 must be given exactly when the "
                         "code holds v128 ops")
    for f in _STATE_FIELDS:
        p = getattr(st, f)
        if p is None:
            continue
        rows = {"stack_lo": D, "stack_hi": D, "stack_e2": D, "stack_e3": D,
                "fr_ret_pc": CD, "fr_fp": CD, "fr_opbase": CD, "glob_lo": NG,
                "glob_hi": NG, "mem": W}.get(f)
        _check(f, p, device, (L,) if rows is None else (rows, L))
    if tables.mem_window and W < 2 * HBM_WINDOW_ROWS:
        raise ValueError(f"a memory of {W} words per lane is too small for "
                         f"the window cache")
    if tables.optimistic:
        for f in WarpState.COUNTERS:
            _check(f, getattr(warps, f), device, ((L + 31) // 32,))


def launch_args(tables: Tables, st, chunk: int, fuel_on: bool,
                warps: Optional[WarpState]):
    """The pointer and int arguments of `wasm_interp_launch` (or, for a
    fused encoding, `wasm_fused_launch`) before the stream, in their
    order (the shadow planes allocated here on the first optimistic
    launch)."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    L = st.pc.shape[0]
    ptrs = [ptr(getattr(tables, f)) for f in _TABLE_FIELDS] + \
        [ptr(getattr(st, f)) for f in _STATE_FIELDS]
    if tables.fusion != "none":
        ptrs += [ptr(getattr(tables, f)) for f in _FUSED_FIELDS]
    if tables.optimistic:
        opt = dict(warps.counters(),
                   **warps.shadows_for(st, tables.mem_window))
        ptrs += [ptr(opt.get(f)) for f in _OPT_FIELDS]
    else:
        ptrs += [None] * _N_OPT
    ints = [tables.hid.shape[0], tables.fent.shape[0],
            tables.brt.shape[0] // 3, tables.tbl.shape[0],
            tables.v128.shape[0] // 4, L, st.stack_lo.shape[0],
            st.fr_ret_pc.shape[0], st.glob_lo.shape[0], st.mem.shape[0],
            int(chunk), int(fuel_on), tables.max_local_zeros,
            tables.mem_pages_max, int(tables.has_bulk),
            int(tables.has_simd), int(tables.mem_window),
            int(tables.optimistic),
            warps.snap_max if tables.optimistic else 0]
    return ptrs, ints
