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
# The reference reserves the next nine ranges of NUM_ALU2 ids (its
# peephole superinstruction families) and one id for GBR; the port has
# no peephole fusion yet, but keeps the numbering so handler ids agree.
H_FUSE_GBR = H_ALU1_BASE + NUM_ALU1 + 9 * NUM_ALU2
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


@dataclasses.dataclass
class Tables:
    """Read-only int32 code tables on one device, plus the geometry the
    interpreter needs."""

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


def device_tables(img: DeviceImage, device) -> Tables:
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32).ravel(),
                               device=device)

    hid = hid_plane(img)
    return Tables(
        hid=t(hid), a=t(img.a), b=t(img.b), c=t(img.c),
        ilo=t(img.imm_lo), ihi=t(img.imm_hi), fent=t(img.f_entry),
        fnpar=t(img.f_nparams), fnloc=t(img.f_nlocals),
        ftop=t(img.f_frame_top), ftyp=t(img.f_type), brt=t(img.br_table),
        tbl=t(img.table0), v128=t(img.v128),
        max_local_zeros=int(img.max_local_zeros),
        mem_pages_max=int(img.mem_pages_max),
        has_bulk=bool(np.isin(hid, (H_MEMFILL, H_MEMCOPY)).any()),
        has_hostcall=bool((hid == H_HOSTCALL).any()),
        has_simd=bool(img.has_simd))


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "interp.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-shared", "-Xcompiler", "-fPIC")

# Launches of the CUDA kernel since the count was last set to 0 (the
# plain version never counts): all of them, those whose code holds the
# bulk-memory cases (h_memfill / h_memcopy), those whose code holds
# host-call stubs (h_hostcall) and those whose code holds v128 ops (the
# B7 handlers).
LAUNCHES = {"interp": 0, "bulk": 0, "hostcall": 0, "simd": 0}

_lib = None
_lib_lock = threading.Lock()
BUILD_INFO = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build_kernel():
    """Compile `csrc/interp.cu` with nvcc into a shared library under
    `_build/` (keyed by the source and flags) and load it.  Returns the
    ctypes library; `BUILD_INFO` records the path and build seconds."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            src = f.read()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
            .hexdigest()[:16]
        os.makedirs(_BUILD_DIR, exist_ok=True)
        so = os.path.join(_BUILD_DIR, f"libinterp_{key}.so")
        t0 = time.perf_counter()
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, _SRC]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
            BUILD_INFO["ptxas"] = proc.stderr
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        BUILD_INFO["path"] = so
        lib = ctypes.CDLL(so)
        fn = lib.wasm_interp_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * _N_PTRS + [ctypes.c_int] * _N_INTS \
            + [ctypes.c_void_p]
        _lib = lib
        return lib


# Pointer arguments, in the order of wasm_interp_launch's signature.
_TABLE_FIELDS = ("hid", "a", "b", "c", "ilo", "ihi", "fent", "fnpar",
                 "fnloc", "ftop", "ftyp", "brt", "tbl", "v128")
_STATE_FIELDS = ("pc", "sp", "fp", "opbase", "call_depth", "trap", "retired",
                 "fuel", "mem_pages", "stack_lo", "stack_hi", "stack_e2",
                 "stack_e3", "fr_ret_pc", "fr_fp", "fr_opbase", "glob_lo",
                 "glob_hi", "mem")
_N_PTRS = len(_TABLE_FIELDS) + len(_STATE_FIELDS)
# code_len, nf, n_brt, tsize, nv (v128 table rows), L, D, CD, NG, W,
# chunk, fuel_on, max_local_zeros, mem_pages_max, bulk and simd (the kernel
# instantiations with the memory.fill / memory.copy cases and with the
# v128 handlers)
_N_INTS = 16


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


def run_chunk(tables: Tables, st, chunk: int, fuel_on: bool) -> None:
    """Run every live lane for up to `chunk` instructions, in place on
    the state `st` (a `batch.engine.BatchState`).  CUDA tensors launch
    the kernel; CPU tensors run the plain interpreter."""
    device = st.pc.device
    if device.type == "cpu":
        from wasmedge_tpu_torch.batch import interp_ref

        interp_ref.run_chunk(tables, st, chunk, fuel_on)
        return
    if device.type != "cuda":
        raise ValueError(f"no interpreter for device {device}")
    L = st.pc.shape[0]
    D = st.stack_lo.shape[0]
    CD = st.fr_ret_pc.shape[0]
    NG = st.glob_lo.shape[0]
    W = st.mem.shape[0]
    n = tables.hid.shape[0]
    for f in _TABLE_FIELDS:
        _check(f, getattr(tables, f), device, None)
    for f in ("a", "b", "c", "ilo", "ihi"):
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
    lib = build_kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = [getattr(tables, f).data_ptr() for f in _TABLE_FIELDS] + \
        [None if getattr(st, f) is None else getattr(st, f).data_ptr()
         for f in _STATE_FIELDS]
    ints = [n, tables.fent.shape[0], tables.brt.shape[0] // 3,
            tables.tbl.shape[0], tables.v128.shape[0] // 4, L, D, CD, NG, W,
            int(chunk), int(fuel_on),
            tables.max_local_zeros, tables.mem_pages_max,
            int(tables.has_bulk), int(simd)]
    with torch.cuda.device(device):
        err = lib.wasm_interp_launch(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"interpreter kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["interp"] += 1
    LAUNCHES["bulk"] += tables.has_bulk
    LAUNCHES["hostcall"] += tables.has_hostcall
    LAUNCHES["simd"] += simd
