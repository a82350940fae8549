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
per-warp state (`WarpState`) goes with the launch.  With tier 0 (`t0k`,
the engine's `t0_effective_kinds`) the kernel retires pure WASI calls at
their stubs (`csrc/interp.cu` `tier0_call`; plain version
`batch/interp_ref.py` `_Group.hostcall` over `batch/tier0.py`), from a
build that has the handlers compiled in (`WASM_TIER0`): every launch then
takes the time base read on the host before it.  An image with tables,
element and data segments, tail calls or ref.func (classes TABLE_GET ...
REFFUNC: `a3`) runs a build with their handlers (`WASM_TABLES`; the
reference SIMT step's engine.py:1156-1307 and :1464-1516, which no Pallas
code runs), over the per-lane table and dropped-flag planes of the state
and the image's segment snapshots; weighted gas (`gas`, the engine's
`cost_plane`) a build that charges each instruction its weight
(`WASM_GAS`).  Builds without them keep their code.

`run_chunk()` is the one entry: on CUDA tensors it launches the kernel
(built from the repository's sources on first use), on CPU tensors it
runs the plain PyTorch interpreter of `batch/interp_ref.py`.
"""

from __future__ import annotations

import atexit
import ctypes
import dataclasses
import hashlib
import os
import shutil
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
    CLS_DATA_DROP, CLS_ELEM_DROP, CLS_MEMCOPY, CLS_MEMFILL, CLS_MEMGROW,
    CLS_MEMINIT, CLS_MEMSIZE, CLS_NOP, CLS_REFFUNC, CLS_RETCALL,
    CLS_RETCALL_INDIRECT, CLS_RETURN, CLS_SELECT, CLS_STORE, CLS_TABLE_COPY,
    CLS_TABLE_FILL, CLS_TABLE_GET, CLS_TABLE_GROW, CLS_TABLE_INIT,
    CLS_TABLE_SET, CLS_TABLE_SIZE, CLS_TRAP, CLS_V1, CLS_V2, CLS_VBITSEL,
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
# Tables, segments, tail calls and ref.func (no Pallas handler: the
# reference SIMT step's, engine.py:1156-1307 and :1464-1516).  Negative,
# so that the shared numbering above and the B2 block ids from
# NUM_HANDLERS on stay as they are; compiled only into WASM_TABLES builds.
H_A3_BASE = -64
H_TABLE_GET = H_A3_BASE
H_TABLE_SET = H_A3_BASE + 1
H_TABLE_SIZE = H_A3_BASE + 2
H_TABLE_GROW = H_A3_BASE + 3
H_TABLE_FILL = H_A3_BASE + 4
H_TABLE_COPY = H_A3_BASE + 5
H_TABLE_INIT = H_A3_BASE + 6
H_ELEM_DROP = H_A3_BASE + 7
H_MEMINIT = H_A3_BASE + 8
H_DATA_DROP = H_A3_BASE + 9
H_RETCALL = H_A3_BASE + 10
H_RETCALL_INDIRECT = H_A3_BASE + 11
H_REFFUNC = H_A3_BASE + 12
# the ones that write the table, its size, a dropped flag or memory from a
# data segment: a warp-leader (B3) commits and is off before them
A3_WRITES = (H_TABLE_SET, H_TABLE_GROW, H_TABLE_FILL, H_TABLE_COPY,
             H_TABLE_INIT, H_ELEM_DROP, H_MEMINIT, H_DATA_DROP)

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
    CLS_TABLE_GET: H_TABLE_GET, CLS_TABLE_SET: H_TABLE_SET,
    CLS_TABLE_SIZE: H_TABLE_SIZE, CLS_TABLE_GROW: H_TABLE_GROW,
    CLS_TABLE_FILL: H_TABLE_FILL, CLS_TABLE_COPY: H_TABLE_COPY,
    CLS_TABLE_INIT: H_TABLE_INIT, CLS_ELEM_DROP: H_ELEM_DROP,
    CLS_MEMINIT: H_MEMINIT, CLS_DATA_DROP: H_DATA_DROP,
    CLS_RETCALL: H_RETCALL, CLS_RETCALL_INDIRECT: H_RETCALL_INDIRECT,
    CLS_REFFUNC: H_REFFUNC,
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
    full (0 at other slots; a block whose case also runs the lone call
    after its div or rem terminal counts it, `fusegen.chains`), `shapes`
    the block shapes, and, for "super",
    `fa` ... `fihi` the rewritten operand planes that the superinstruction
    handlers read at their head slots.  `mem_window`: memory accesses go
    through each lane's window cache (B4; `batch/engine.py`
    `mem_window_of` chooses it).  `optimistic`: warps that start a launch
    converged run optimistic convergence (B3; `batch/engine.py`
    `optimistic_of` chooses it).  `stack_split`: the build whose stack
    rows at or above the rows on chip stay in global memory (the depth
    the tables run at does not fit on chip, `stack_split()`).

    `a3`: the code holds a table, segment, tail-call or ref.func class
    (the build with their handlers); `tmut`: it mutates its table (the
    state then has the per-lane `tab` [tcap, L] and `tsize`, and
    call_indirect reads them); `efl`/`eoff`/`elen` and
    `dwords`/`doff`/`dlen`: the image's element and data segment
    snapshots (a3 only).  `cost` and `gcum`: weighted gas, each pc's
    weight and their running sum ([code_len + 1], int32 wrapping: a
    fused dispatch of n ops at pc costs gcum[pc + n] - gcum[pc]); None
    for flat gas."""

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
    # tier 0: the kind each stub pc serves in the kernel (batch/image.py
    # T0_*, 0 elsewhere), None when tier 0 is off; and batch/tier0.py's
    # t0_statics (the PRNG seed, the longest random_get and fd_write
    # payloads in words)
    t0k: Optional[torch.Tensor] = None
    t0: Optional[dict] = None
    a3: bool = False
    tmut: bool = False
    tcap: int = 1
    efl: Optional[torch.Tensor] = None
    eoff: Optional[torch.Tensor] = None
    elen: Optional[torch.Tensor] = None
    dwords: Optional[torch.Tensor] = None
    doff: Optional[torch.Tensor] = None
    dlen: Optional[torch.Tensor] = None
    cost: Optional[torch.Tensor] = None
    gcum: Optional[torch.Tensor] = None


def gas_planes(cost: np.ndarray):
    """(cost, gcum) int32 planes of per-pc weights: gcum[k] is the sum
    of cost[:k] wrapped to int32, so a run of n ops at pc costs
    gcum[pc + n] - gcum[pc] (mod 2**32)."""
    cost = np.asarray(cost, np.int64)
    cum = np.concatenate([[0], np.cumsum(cost)]) & 0xFFFFFFFF
    return cost.astype(np.int32), cum.astype(np.uint32).view(np.int32)


def device_tables(img: DeviceImage, device, fusion: str = "none",
                  mem_window: bool = False, optimistic: bool = False,
                  stack_depth: Optional[int] = None,
                  t0kinds: Optional[np.ndarray] = None,
                  t0: Optional[dict] = None,
                  cost: Optional[np.ndarray] = None) -> Tables:
    """The image's code tables on `device` in the encoding `fusion`:
    "none" (one op per dispatch), "blocks" (B2 fused basic blocks) or
    "super" (B6 superinstructions; images without v128 ops only); with
    `mem_window`, memory through the window cache (an image with a
    memory); with `optimistic`, the kernel with optimistic convergence;
    `stack_depth`, the value-stack depth the tables run at (the build
    without the stack split when every row fits on chip, `stack_split`;
    None: any depth); with `t0kinds` (the engine's `t0_effective_kinds`,
    and `t0` its `t0_statics`), the build that serves those tier-0 calls
    in the kernel; with `cost` (the engine's `cost_plane`), weighted
    gas.  An image with a table, segment, tail-call or ref.func class
    runs the build with those handlers."""
    from wasmedge_tpu_torch.batch import fusegen
    from wasmedge_tpu_torch.batch.fusion import (
        fuse_blocks, fuse_image, fused_lengths)

    if fusion not in FUSIONS:
        raise ValueError(f"unknown fusion {fusion!r}; one of {FUSIONS}")
    if mem_window and not img.has_memory:
        raise ValueError("the window cache needs an image with a memory")
    if (t0kinds is None) != (t0 is None):
        raise ValueError("tier-0 kinds and t0_statics go together")

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
        has_bulk=bool(np.isin(hid, (H_MEMFILL, H_MEMCOPY)).any()),
        has_hostcall=bool((hid == H_HOSTCALL).any()),
        has_simd=bool(img.has_simd), fusion=fusion,
        mem_window=bool(mem_window), optimistic=bool(optimistic),
        stack_split=stack_split(stack_depth, bool(img.has_simd),
                                bool(mem_window)),
        t0k=None if t0kinds is None else t(t0kinds),
        t0=None if t0 is None else dict(t0))
    if (hid < 0).any():
        tables.a3 = True
        tables.tmut = bool(img.has_table_mut)
        tables.tcap = max(int(img.table_cap or img.table0.shape[0]), 1)
        tables.efl, tables.eoff, tables.elen = (
            t(img.elem_flat), t(img.elem_off), t(img.elem_len))
        tables.dwords, tables.doff, tables.dlen = (
            t(img.data_words), t(img.data_off), t(img.data_len))
    if cost is not None:
        tables.cost, tables.gcum = (t(x) for x in gas_planes(cost))
    if fusion == "none":
        return tables
    sops = None  # the superinstructions' rewritten operand planes
    if fusion == "blocks":
        fhid, shapes = fuse_blocks(hid, img)
    else:
        if img.has_simd:
            raise ValueError("superinstructions move two-word cells: an "
                             "image with v128 ops runs 'blocks' or 'none'")
        fhid, fa, fb, fc, filo, fihi = fuse_image(
            hid, img.a, img.b, img.c, img.imm_lo, img.imm_hi, img)
        shapes = ()
        sops = (fa, fb, fc, filo, fihi)
        tables.fa, tables.fb, tables.fc = t(fa), t(fb), t(fc)
        tables.filo, tables.fihi = t(filo), t(fihi)
    tables.hid0 = tables.hid
    tables.hid = t(fhid)
    flen = fused_lengths(fhid, shapes)
    if fusion == "blocks":
        # a case that runs its div or rem terminal and the lone call
        # after it retires the call too (fusegen.chains)
        for pc in fusegen.chains(fhid, hid, shapes):
            flen[pc] += 1
    tables.flen = t(flen)
    tables.shapes = shapes
    tables.fused_source = fusegen.cuda_source(
        fhid, shapes, tables.has_bulk, tables.has_simd, tables.mem_window,
        tables.optimistic, tables.stack_split, tables.t0k is not None,
        a3=tables.a3, cost=cost, img=img, hid0=hid,
        sops=sops)
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
# through the window cache (B4, "window"), those of the kernels with
# optimistic convergence (B3, "optimistic"), those of the builds that
# serve tier-0 host calls in the kernel ("tier0"), those of the builds
# with the table, segment, tail-call and ref.func handlers ("tables"),
# those that charged weighted gas ("gas") and those launched over fewer
# lanes than the state's (lane compaction's narrowing, "narrow"); and the
# launches of tier 0's stdout flush kernel ("stdout_flush",
# batch/stdout_flush.py), which are not the interpreter's.
LAUNCHES = {"interp": 0, "bulk": 0, "hostcall": 0, "simd": 0, "block": 0,
            "super": 0, "window": 0, "optimistic": 0, "tier0": 0,
            "tables": 0, "gas": 0, "narrow": 0, "stdout_flush": 0}
LAUNCHES_LOCK = threading.Lock()

_libs = {}  # build key -> loaded ctypes library
_lib_lock = threading.Lock()
# "per_op" maps each per-op build (`per_op_label`) to its "path",
# "seconds", "ptxas" (its -v output) and "background" (started by
# `start_builds`' queue); "fused" maps each fused build's key to the same
# four and "fusion", "shapes", "mean_len", "mem_window", "optimistic",
# "tier0", "tables" and "gas"; "waited" maps the key of each background
# build that `build_kernels` had to wait for to the seconds it waited.
BUILD_INFO = {"fused": {}, "per_op": {}, "waited": {}}


class KernelBuildError(RuntimeError):
    """A kernel that did not build or load (nvcc failed or is missing, or
    its library would not load): a fault of the installation that no
    retry of a launch mends, so the supervisor and the server let it
    through instead of retrying it."""


def per_op_label(win: bool, opt: bool, split: bool = False,
                 one: Optional[tuple] = None) -> str:
    """The name of the per-op build with or without the window cache,
    optimistic convergence and the stack split; `one`: None, or the
    `one_key` (bulk, simd, tier 0, tables, gas) of a build with handlers
    compiled in on request (such a library holds that one (bulk, simd)
    instantiation)."""
    out = ("window" if win else "direct") + (
        ", optimistic" if opt else "") + (", split stack" if split else "")
    if one is None:
        return out
    bulk, simd, t0, a3, gas = one
    extra = [n for n, on in (("tier 0", t0), ("tables", a3), ("gas", gas))
             if on]
    return out + f", {', '.join(extra)} (kBulk={int(bulk)}, " \
        f"kSimd={int(simd)})"


def _per_op_flags(flags) -> tuple:
    """(win, opt, split, one) of a per-op build given as a triple or as
    that quadruple (one None or a `one_key`)."""
    win, opt, split, *one = flags
    one = one[0] if one else None
    return (bool(win), bool(opt), bool(split),
            None if one is None else tuple(bool(x) for x in one))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# generated source, or the per-op kernel's (window, optimistic, split,
# one) flags -> _job's result
_jobs = {}


def _defines(win: bool, opt: bool, split: bool, one=None) -> tuple:
    """The per-op build's extra nvcc flags: its window, optimistic and
    stack-split instantiations and, for a build with handlers compiled in
    on request (`one_key`), their defines (WASM_TIER0, WASM_TABLES,
    WASM_GAS) and the one (bulk, simd) instantiation it holds.  A build
    without them has none of these defines, so its code is the one
    before those handlers."""
    out = (f"-DWASM_MEM_WINDOW={int(win)}", f"-DWASM_OPTIMISTIC={int(opt)}",
           f"-DWASM_STACK_SPLIT={int(split)}")
    if one is not None:
        bulk, simd, t0, a3, gas = one
        out += tuple(f"-D{d}=1" for d, on in (
            ("WASM_TIER0", t0), ("WASM_TABLES", a3), ("WASM_GAS", gas))
            if on)
        out += (f"-DWASM_ONE_BULK={int(bulk)}",
                f"-DWASM_ONE_SIMD={int(simd)}")
    return out


def one_key(tables: Tables) -> Optional[tuple]:
    """(bulk, simd, tier 0, tables, gas) of the per-op build with handlers
    compiled in on request that runs `tables` (the tier-0 calls, the
    table, segment and tail-call classes, weighted gas), or None when it
    needs none of them."""
    t0, a3, gas = tables.t0k is not None, tables.a3, tables.gcum is not None
    if not (t0 or a3 or gas):
        return None
    return (bool(tables.has_bulk), bool(tables.has_simd), t0, a3, gas)


def _job(tables: Optional[Tables], win: bool = False, opt: bool = False,
         split: bool = False, one=None):
    """(key, shared library path, source path) of the kernel that runs
    `tables`: the per-op build (tables None or of the "none" encoding;
    with the window cache when `win` or `tables.mem_window`, with
    optimistic convergence when `opt` or `tables.optimistic`, with the
    stack split when `split` or `tables.stack_split`, with the handlers
    of `one` (a `one_key`, or the tables') in one (bulk, simd)
    instantiation) or the fused build of `tables` (its generated source
    goes under _build/ when it is built)."""
    if tables is not None and tables.fusion == "none":
        tables, win, opt, split, one = (
            None, tables.mem_window, tables.optimistic, tables.stack_split,
            one_key(tables))
    flags = _per_op_flags((win, opt, split, one))
    text = flags if tables is None else tables.fused_source
    if text not in _jobs:
        _jobs[text] = _new_job(tables, *flags)
    return _jobs[text]


def _new_job(tables: Optional[Tables], win: bool, opt: bool, split: bool,
             one=None):
    flags = " ".join(NVCC_FLAGS).encode()
    srcs = _read(_SRC) + _read(_WIN_HDR) + _read(_OPT_HDR)
    if tables is None:
        key = hashlib.sha256(
            srcs + flags + " ".join(_defines(win, opt, split, one)).encode()) \
            .hexdigest()[:16]
        return key, os.path.join(_BUILD_DIR, f"libinterp_{key}.so"), _SRC
    src = tables.fused_source.encode()
    key = hashlib.sha256(srcs + _read(_FUSED_HDR) + src + flags) \
        .hexdigest()[:16]
    cu = os.path.join(_BUILD_DIR, f"fused_{key}.cu")
    return key, os.path.join(_BUILD_DIR, f"libfused_{key}.so"), cu


def _plan(tables_list, per_op) -> dict:
    """key -> (library path, source path, fused Tables or None, per-op
    flags) of the per-op builds `per_op`, of the per-op builds that run
    the "none" tables of `tables_list` and of the fused build of each
    other tables."""
    jobs = {}
    builds = {_per_op_flags(f) for f in per_op}
    for tb in tables_list:
        if tb.fusion == "none":
            builds.add((tb.mem_window, tb.optimistic, tb.stack_split,
                        one_key(tb)))
    for flags in sorted(builds, key=str):
        key, so, src = _job(None, *flags)
        jobs[key] = (so, src, None, flags)
    for tb in tables_list:
        if tb.fusion == "none":
            continue  # one of the per-op builds above
        key, so, src = _job(tb)
        jobs.setdefault(key, (so, src, tb, (
            tb.mem_window, tb.optimistic, tb.stack_split, one_key(tb))))
    return jobs


@dataclasses.dataclass
class _Nvcc:
    """One nvcc process: its output library while it builds, its start
    and (stamped by the reaper) end, its log file, and whether it was
    started in the background."""
    proc: subprocess.Popen
    tmp: str
    t0: float
    log: object
    background: bool
    end: Optional[float] = None


# nvcc processes that `build_kernels` has not taken yet (key -> _Nvcc),
# the builds `start_builds` queued (key -> _plan's job), how many of
# those may run at once, and the thread that stamps each process's end
# and starts queued builds
_running = {}
_queued = {}
_at_once = [1]
_reaper = [None]
_run_lock = threading.Lock()


def _spawn(key, job, background: bool) -> None:
    """Start nvcc on `job` (the caller holds _run_lock); a background
    build runs at the lowest CPU priority where `nice` exists."""
    so, src, tb, flags = job
    tmp = f"{so}.{os.getpid()}.tmp"
    if tb is not None:
        with open(f"{src}.{os.getpid()}.tmp", "w") as f:
            f.write(tb.fused_source)
        os.replace(f"{src}.{os.getpid()}.tmp", src)
    defines = _defines(*flags) if tb is None else ()
    nice = shutil.which("nice") if background else None
    cmd = [*([nice, "-n", "19"] if nice else []), _nvcc(), *NVCC_FLAGS,
           *defines, "-Xptxas", "-v", "-I", _CSRC, "-o", tmp, src]
    # nvcc's output goes to a file: a full pipe would stall it
    log = open(f"{tmp}.log", "w+")
    _running[key] = _Nvcc(subprocess.Popen(cmd, stdout=log, stderr=log),
                          tmp, time.perf_counter(), log, background)


def _reap() -> None:
    """Stamp each nvcc's end and start queued builds while fewer than
    `_at_once[0]` background builds run; return when nothing runs or
    waits."""
    while True:
        with _run_lock:
            now = time.perf_counter()
            for r in _running.values():
                if r.end is None and r.proc.poll() is not None:
                    r.end = now
            busy = sum(r.background and r.end is None
                       for r in _running.values())
            while _queued and busy < _at_once[0]:
                key = next(iter(_queued))
                _spawn(key, _queued.pop(key), True)
                busy += 1
            if not _queued and all(r.end is not None
                                   for r in _running.values()):
                _reaper[0] = None
                return
        time.sleep(0.05)


def _ensure_reaper() -> None:
    """Start the reaper unless it runs (the caller holds _run_lock)."""
    if _reaper[0] is None:
        _reaper[0] = threading.Thread(target=_reap, daemon=True)
        _reaper[0].start()


def _stop_builds() -> None:
    """Drop the queue and kill every nvcc still running (at exit, and
    when a wait for builds is interrupted)."""
    with _run_lock:
        _queued.clear()
        for r in _running.values():
            if r.proc.poll() is None:
                r.proc.kill()
                r.proc.wait()


atexit.register(_stop_builds)


def start_builds(tables_list=(), per_op=(), at_once: int = 1) -> int:
    """Queue the builds of `tables_list` and `per_op` (as `build_kernels`
    names them) that are neither built, running nor queued, to run in the
    background: at most `at_once` nvcc processes at a time, each at the
    lowest CPU priority, so that the caller's own work keeps its cores
    meanwhile.  `build_kernels` starts a queued build at once when it
    needs it, and waits for a running one.  Returns the builds queued."""
    with _run_lock:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        _at_once[0] = max(1, at_once)
        n = 0
        for key, job in _plan(tables_list, per_op).items():
            if key in _libs or key in _running or key in _queued or \
                    os.path.exists(job[0]):
                continue
            _queued[key] = job
            n += 1
        if n:
            _ensure_reaper()
    return n


def build_kernels(tables_list=(), per_op=((False, False, False),)) -> dict:
    """Build, all nvcc processes at once, the per-op kernel
    (`csrc/interp.cu`, four instantiations, a library for each (window,
    optimistic, stack split) triple in `per_op` and for each per-op
    `Tables` given; a quadruple whose last item is a `one_key`, or
    per-op tables with tier 0, tables or weighted gas, name a library
    with those handlers and that one instantiation) and
    the fused kernel of each fused `Tables` given (`csrc/interp.cu` with
    `csrc/fused.cuh` and the generated dispatch of its blocks or
    superinstructions, one instantiation), each into a shared library
    under `_build/` keyed by the hash of its sources and flags, and load
    them.  A build that `start_builds` queued starts now with the others;
    one it started is waited for (BUILD_INFO["waited"]: key -> seconds
    waited for a background build still running).  Returns {key:
    library}; `BUILD_INFO` records paths, build seconds and ptxas
    output.  Raises KernelBuildError if any build fails."""
    try:
        return _build_kernels(tables_list, per_op)
    except KernelBuildError:
        raise
    except Exception as e:
        raise KernelBuildError(f"kernel build failed: {e!r}") from e


def _build_kernels(tables_list, per_op) -> dict:
    with _lib_lock:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        jobs = _plan(tables_list, per_op)
        with _run_lock:
            for key, job in jobs.items():
                if key in _libs or key in _running or \
                        os.path.exists(job[0]):
                    continue
                _queued.pop(key, None)
                _spawn(key, job, False)
            mine = {k: _running[k] for k in jobs if k in _running}
            late = [k for k, r in mine.items()
                    if r.background and r.end is None]
            if mine:
                _ensure_reaper()
        # each build's own seconds: the reaper stamps every nvcc's end
        t0 = time.perf_counter()
        try:
            while any(r.end is None for r in mine.values()):
                time.sleep(0.05)
        except BaseException:
            _stop_builds()
            raise
        for key in late:
            BUILD_INFO["waited"][key] = mine[key].end - t0
        with _run_lock:
            for key in mine:
                del _running[key]
        logs = {}
        for key, r in mine.items():
            r.log.seek(0)
            logs[key] = r.log.read()
            r.log.close()
            os.remove(r.log.name)
        for key, r in mine.items():
            so, src, tb, flags = jobs[key]
            if r.proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({r.proc.returncode}) on {src}:\n"
                    f"{logs[key]}")
            os.replace(r.tmp, so)
            info = {"path": so, "seconds": r.end - r.t0,
                    "ptxas": logs[key], "background": r.background}
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
                one = flags[3] or (False,) * 5
                BUILD_INFO["fused"].setdefault(key, {"path": so}).update(
                    fusion=tb.fusion, shapes=len(tb.shapes),
                    mean_len=float(np.mean(n_ops)) if n_ops else 0.0,
                    mem_window=bool(flags[0]), optimistic=bool(flags[1]),
                    stack_split=bool(flags[2]), tier0=one[2],
                    tables=one[3], gas=one[4])
            else:
                BUILD_INFO["per_op"].setdefault(
                    per_op_label(*flags), {}).setdefault("path", so)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * (
                _N_PTRS + extra + _N_OPT + _N_T0_PTRS + _N_A3_PTRS) + \
                [ctypes.c_int] * (_N_INTS + _N_T0_INTS + _N_A3_INTS + 1) + \
                [ctypes.c_void_p]
            _libs[key] = lib
        return {key: _libs[key] for key in jobs}


# The launch geometry (csrc/interp.cu): threads per block (one warp), the
# shared memory a block may use on an H100 (opt-in), what is kept for
# static shared memory (bulk_op's table and the windows' row bits), the most stack rows kept on chip, and the window
# cache's bytes per block (csrc/memwin.cuh: two ways of HBM_WINDOW_ROWS
# words per thread).
BLOCK_THREADS = 32
SMEM_BLOCK_MAX = 232448
SMEM_STATIC = 3072
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


# The device counters of each library (csrc/interp.cu wasm_*_counts):
# C entry -> the names of its counts
BULK_COUNTS = ("warp_passes", "warp_lanes", "lane_walks")
WINDOW_COUNTS = ("hits", "misses", "ways_written_back", "rows_written_back",
                 "rows_filled")
ENTRY_COUNTS = ("compares", "cycles")
TURN_COUNTS = ("lane_turns", "warp_turns")
_COUNTERS = {"wasm_bulk_counts": BULK_COUNTS,
             "wasm_win_counts": WINDOW_COUNTS,
             "wasm_entry_counts": ENTRY_COUNTS,
             "wasm_turn_counts": TURN_COUNTS}


def _lib_counts(lib, fn: str, clear: bool) -> dict:
    names = _COUNTERS[fn]
    out = (ctypes.c_ulonglong * len(names))()
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p, ctypes.c_int]
    err = f(out, int(clear))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")
    return dict(zip(names, list(out)))


def _device_counts(tables: Tables, fn: str, clear: bool) -> dict:
    key = _job(tables)[0]
    lib = _libs.get(key) or build_kernels([tables])[key]
    return _lib_counts(lib, fn, clear)


def bulk_counts(tables: Tables, clear: bool = False) -> dict:
    """The bulk-op counts of the library that runs `tables` (built if need
    be) since they were last cleared: "warp_passes" (memory.fill /
    memory.copy groups that the warp-cooperative row pass ran),
    "warp_lanes" (the lanes in them) and "lane_walks" (lanes that walked
    their own column: alone in their group, or in a warp with fewer than
    8 threads at the op); set to 0 after the read when `clear`."""
    return _device_counts(tables, "wasm_bulk_counts", clear)


def window_counts(tables: Tables, clear: bool = False) -> dict:
    """The window cache's counts (B4, csrc/memwin.cuh) of the library
    that runs `tables` since they were last cleared: `WINDOW_COUNTS`
    (selects that hit, misses, dirty ways written back, the rows those
    stored, rows filled); set to 0 after the read when `clear`.  Misses
    and ways written back are `memwin.COUNTS`'s, by the same rule."""
    return _device_counts(tables, "wasm_win_counts", clear)


def entry_counts(tables: Tables, clear: bool = False) -> dict:
    """B3's entry compares (csrc/optimistic.cuh `warp_uniform`) of the
    library that runs `tables` since they were last cleared: compares run
    (whole warps that were on) and their clock cycles summed over warps
    (the warps found uniform: `WarpState.uniform`); set to 0 after the
    read when `clear`."""
    return _device_counts(tables, "wasm_entry_counts", clear)


def turn_counts(tables: Tables, clear: bool = False) -> dict:
    """The dispatch loop's turns in the counting build that runs `tables`
    (a fused source with WASM_TURN_COUNTS defined, `tools/tail_probe.py`)
    since they were last cleared: "lane_turns" (each lane's turns,
    summed: the sum of `__popc(__activemask())` over the warps' turns)
    and "warp_turns" (the turns that lanes ran together, counted once);
    set to 0 after the read when `clear`."""
    return _device_counts(tables, "wasm_turn_counts", clear)


def clear_counts() -> None:
    """Set the bulk, window, entry and (in counting builds) turn counts
    of every loaded library to 0."""
    for lib in _libs.values():
        for fn in _COUNTERS:
            if hasattr(lib, fn):
                _lib_counts(lib, fn, True)


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
# chunk, fuel_on, max_local_zeros, bulk, simd, win and opt (the kernel
# instantiations with the memory.fill / memory.copy cases, with the v128
# handlers, with the window cache and with optimistic convergence),
# snap_max (the ceiling of a warp's interval)
_N_INTS = 18
# Tier 0's pointers come after the optimistic ones (null when it is off):
# the kinds by pc, the per-lane call counts, the stdout record buffer and
# its fills; its ints after snap_max: on, the buffer's rows (SW), the PRNG
# seed, the longest random_get and fd_write payloads in words, and the
# launch's time base (realtime lo, hi, monotonic lo, hi)
_T0_PTRS = ("t0k", "t0_ctr", "so_buf", "so_off")
_N_T0_PTRS = len(_T0_PTRS)
_N_T0_INTS = 9
# The tables' and weighted gas's pointers come after tier 0's (null where
# unused): the per-lane table, its size and the segments' dropped flags
# (state), the element and data segment snapshots and the gas planes
# (tables); their ints after tier 0's: on (a build with the table
# handlers), the table plane's rows, the element segments, the data
# segments, the flat element and data word counts, and gas on.  The last
# int, before the stream, is the launch width: the lanes launched, at most
# L (L stays every plane's pitch)
_A3_PTRS = ("tab", "tsize", "edrop", "ddrop", "efl", "eoff", "elen",
            "dwords", "doff", "dlen", "cost", "gcum")
_N_A3_PTRS = len(_A3_PTRS)
_N_A3_INTS = 7


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
              warps: Optional[WarpState] = None, t0_time=None,
              width: Optional[int] = None) -> None:
    """Run every live lane below `width` (the state's lanes when None)
    for up to `chunk` instructions, in place on the state `st` (a
    `batch.engine.BatchState`); lanes at or beyond `width` are not
    touched (lane compaction's narrowed launches).  CUDA tensors launch
    the kernel of the tables' encoding (and memory mode: with
    `mem_window` the window-cache instantiation, or an error; with
    `optimistic` the instantiation with optimistic convergence, which
    updates `warps`, a fresh `WarpState` when None; with tier 0 the build
    with its handlers, `t0_time` the launch's time base, [2, 2] int32 as
    `engine.t0_time_planes` reads it); CPU tensors run the plain
    interpreter."""
    device = st.pc.device
    L = st.pc.shape[0]
    width = L if width is None else int(width)
    if not 0 < width <= L:
        raise ValueError(f"launch width {width} is not in [1, {L}]")
    if (tables.t0k is None) != (st.t0_ctr is None):
        raise ValueError("tier-0 tables need a state with the tier-0 "
                         "planes, and only they do")
    if tables.t0k is not None:
        if t0_time is None:
            raise ValueError("a launch with tier 0 needs its time base")
        t0_time = np.asarray(t0_time, np.int32).reshape(2, 2)
    if device.type == "cpu":
        from wasmedge_tpu_torch.batch import interp_ref

        interp_ref.run_chunk(tables, st, chunk, fuel_on, warps, t0_time,
                             width)
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
    ptrs, ints = launch_args(tables, st, chunk, fuel_on, warps, t0_time,
                             width)
    with torch.cuda.device(device):
        err = launch(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"interpreter kernel launch failed: CUDA error "
                           f"{err}")
    # under a lock: two servers' threads launch at once while a gateway's
    # old generation drains beside its new one
    with LAUNCHES_LOCK:
        LAUNCHES["interp"] += 1
        LAUNCHES["bulk"] += tables.has_bulk
        LAUNCHES["hostcall"] += tables.has_hostcall
        LAUNCHES["simd"] += tables.has_simd
        LAUNCHES["block"] += tables.fusion == "blocks"
        LAUNCHES["super"] += tables.fusion == "super"
        LAUNCHES["window"] += tables.mem_window
        LAUNCHES["optimistic"] += tables.optimistic
        LAUNCHES["tier0"] += tables.t0k is not None
        LAUNCHES["tables"] += tables.a3
        LAUNCHES["gas"] += tables.gcum is not None and bool(fuel_on)
        LAUNCHES["narrow"] += width < L


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
    if tables.t0k is not None:
        _check("t0k", tables.t0k, device, (n,))
        _check("t0_ctr", st.t0_ctr, device, (4, L))
        if st.so_buf is not None:
            _check("so_buf", st.so_buf, device, (st.so_buf.shape[0], L))
            _check("so_off", st.so_off, device, (L,))
    _check_a3(tables, st, device)


def _check_a3(tables: Tables, st, device) -> None:
    """Raise unless the state has the table and segment planes the
    tables need, of their geometry, and none that they do not use."""
    L = st.pc.shape[0]
    want = {"tab": (tables.tcap, L) if tables.tmut else None,
            "tsize": (L,) if tables.tmut else None,
            "edrop": None if not tables.a3 else (tables.elen.shape[0], L),
            "ddrop": None if not tables.a3 else (tables.dlen.shape[0], L)}
    for f, shape in want.items():
        p = getattr(st, f)
        if p is None:
            if shape is not None and f in ("tab", "tsize"):
                raise ValueError(f"tables that mutate their table need the "
                                 f"state's {f}")
            continue
        if shape is None:
            raise ValueError(f"the state has {f}, which these tables do "
                             f"not use")
        _check(f, p, device, shape)
    for f in _A3_PTRS[4:10] if tables.a3 else ():
        _check(f, getattr(tables, f), device, None)
    if tables.gcum is not None:
        _check("cost", tables.cost, device, (tables.hid.shape[0],))
        _check("gcum", tables.gcum, device, (tables.hid.shape[0] + 1,))


def launch_args(tables: Tables, st, chunk: int, fuel_on: bool,
                warps: Optional[WarpState], t0_time=None,
                width: Optional[int] = None):
    """The pointer and int arguments of `wasm_interp_launch` (or, for a
    fused encoding, `wasm_fused_launch`) before the stream, in their
    order (the shadow planes allocated here on the first optimistic
    launch; `t0_time` the launch's tier-0 time base, [2, 2] int32;
    `width` the lanes launched, the state's lanes when None)."""
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
            int(tables.has_bulk),
            int(tables.has_simd), int(tables.mem_window),
            int(tables.optimistic),
            warps.snap_max if tables.optimistic else 0]
    t0 = tables.t0
    if t0 is None:
        ptrs += [None] * _N_T0_PTRS
        ints += [0] * _N_T0_INTS
    else:
        tt = np.asarray(t0_time, np.int32).reshape(4).tolist()
        ptrs += [ptr(tables.t0k), ptr(st.t0_ctr), ptr(st.so_buf),
                 ptr(st.so_off)]
        ints += [1, 0 if st.so_buf is None else st.so_buf.shape[0],
                 int(t0["RNG_SEED"]), int(t0["RMAX_W"]), int(t0["WMAX_W"]),
                 *tt]
    ptrs += [ptr(getattr(st, f)) for f in _A3_PTRS[:4]] + \
        [ptr(getattr(tables, f)) for f in _A3_PTRS[4:]]
    ints += [int(tables.a3), tables.tcap,
             0 if st.edrop is None else st.edrop.shape[0],
             0 if st.ddrop is None else st.ddrop.shape[0],
             0 if tables.efl is None else tables.efl.shape[0],
             0 if tables.dwords is None else tables.dwords.shape[0],
             int(tables.gcum is not None)]
    ints.append(L if width is None else int(width))
    return ptrs, ints
