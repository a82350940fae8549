"""DeviceImage: lowered module + instance snapshot -> the interpreter's tables.

A trimmed copy of `wasmedge_tpu/batch/image.py`.  Every instruction is
re-encoded as (class, sub, a, b, c, imm_lo, imm_hi): `class` picks a
handler of the warp-interpreter and `sub` an ALU operation.  The class
and sub numbering is the reference's, bit for bit, so the two packages
build identical planes from the same module (tests/test_torch_front_end.py).

Every imported function gets a two-instruction stub after the module
code, HOSTCALL (`a` = function index) then RETURN (`b` = nresults), and
`f_entry` points the import at its stub: a lane that calls it parks at
the HOSTCALL with its frame pushed, the host serves it
(batch/hostcall.py) and re-arms it at the RETURN.

v128 instructions (classes VCONST..VSTORE, op tables in
`batch/simdops.py`) keep 128-bit constants and shuffle masks in the
`v128` table `[n, 4]`, indexed by `a`; `has_simd` says whether the code
holds any, and the engine gives such images two more stack planes.

`batchability()` is the module-level gate; `slice_refusal()` is the
port's own gate over a built image: classes that later slices of the
port bring (tables, segments, tail calls) are refused up front with an
error that names the class.  The reference's tier-0 `t0kind`
plane is not built: this port parks every host call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.common.opcodes import NAME_TO_ID, Op, name_of
from wasmedge_tpu_torch.validator.image import (
    LOP_BR, LOP_BRNZ, LOP_BRZ, LoweredModule)

# -- opcode classes (numbering shared with the reference) -------------------
CLS_NOP = 0
CLS_CONST = 1
CLS_LOCAL_GET = 2
CLS_LOCAL_SET = 3
CLS_LOCAL_TEE = 4
CLS_GLOBAL_GET = 5
CLS_GLOBAL_SET = 6
CLS_ALU1 = 7
CLS_ALU2 = 8
CLS_SELECT = 9
CLS_DROP = 10
CLS_BR = 11
CLS_BRZ = 12
CLS_BRNZ = 13
CLS_BR_TABLE = 14
CLS_RETURN = 15
CLS_CALL = 16
CLS_CALL_INDIRECT = 17
CLS_LOAD = 18
CLS_STORE = 19
CLS_MEMSIZE = 20
CLS_MEMGROW = 21
CLS_TRAP = 22
CLS_HOSTCALL = 23
CLS_MEMFILL = 24
CLS_MEMCOPY = 25
# v128 (4x int32 planes per cell; op tables in batch/simdops.py)
CLS_VCONST = 26    # a = v128 table idx -> push
CLS_V2 = 27        # sub = V2_SUB id: pop2 push1
CLS_V1 = 28        # sub = V1_SUB id: pop1 push1
CLS_VTEST = 29     # sub = VTEST_SUB id: pop v128 push i32
CLS_VSHIFT = 30    # sub = VSHIFT_SUB id: pop (v128, i32) push v128
CLS_VSPLAT = 31    # sub = VSPLAT_SUB id: pop scalar push v128
CLS_VEXTRACT = 32  # sub = VEXTRACT_SUB id, a = lane: pop v128 push scalar
CLS_VREPLACE = 33  # sub = VREPLACE_SUB id, a = lane: pop2 push v128
CLS_VSHUFFLE = 34  # a = v128 table idx (16-byte mask): pop2 push1
CLS_VBITSEL = 35   # pop3 push1
CLS_VLOAD = 36     # a = offset: pop addr push v128
CLS_VSTORE = 37    # a = offset: pop (addr, v128)
CLS_TABLE_GET = 38
CLS_TABLE_SET = 39
CLS_TABLE_SIZE = 40
CLS_TABLE_GROW = 41
CLS_TABLE_FILL = 42
CLS_TABLE_COPY = 43
CLS_TABLE_INIT = 44
CLS_ELEM_DROP = 45
CLS_MEMINIT = 46
CLS_DATA_DROP = 47
CLS_RETCALL = 48
CLS_RETCALL_INDIRECT = 49
CLS_REFFUNC = 50

CLASS_NAMES = {
    CLS_TABLE_GET: "TABLE_GET", CLS_TABLE_SET: "TABLE_SET",
    CLS_TABLE_SIZE: "TABLE_SIZE", CLS_TABLE_GROW: "TABLE_GROW",
    CLS_TABLE_FILL: "TABLE_FILL", CLS_TABLE_COPY: "TABLE_COPY",
    CLS_TABLE_INIT: "TABLE_INIT", CLS_ELEM_DROP: "ELEM_DROP",
    CLS_MEMINIT: "MEMINIT", CLS_DATA_DROP: "DATA_DROP",
    CLS_RETCALL: "RETCALL", CLS_RETCALL_INDIRECT: "RETCALL_INDIRECT",
    CLS_REFFUNC: "REFFUNC",
}

# Classes the CUDA warp-interpreter executes: NOP..VSTORE (which
# includes ALU1/ALU2, CALL_INDIRECT, LOAD/STORE, MEMSIZE/MEMGROW, TRAP,
# HOSTCALL, MEMFILL/MEMCOPY and the v128 classes).
SLICE_MAX_CLASS = CLS_VSTORE

# -- ALU2 sub-ops (binary: pop2 push1) --------------------------------------
_I32_BIN = ["add", "sub", "mul", "div_s", "div_u", "rem_s", "rem_u", "and",
            "or", "xor", "shl", "shr_s", "shr_u", "rotl", "rotr",
            "eq", "ne", "lt_s", "lt_u", "gt_s", "gt_u", "le_s", "le_u",
            "ge_s", "ge_u"]
_F32_BIN = ["add", "sub", "mul", "div", "min", "max", "copysign",
            "eq", "ne", "lt", "gt", "le", "ge"]
_F64_BIN = list(_F32_BIN)

ALU2_I32_BASE = 0
ALU2_I64_BASE = len(_I32_BIN)           # 25
ALU2_F32_BASE = 2 * len(_I32_BIN)       # 50
ALU2_F64_BASE = ALU2_F32_BASE + len(_F32_BIN)  # 63
NUM_ALU2 = ALU2_F64_BASE + len(_F64_BIN)  # 76

# -- ALU1 sub-ops (unary: pop1 push1) ---------------------------------------
_ALU1 = [
    "i32.clz", "i32.ctz", "i32.popcnt", "i32.eqz",
    "i32.extend8_s", "i32.extend16_s",
    "i64.clz", "i64.ctz", "i64.popcnt", "i64.eqz",
    "i64.extend8_s", "i64.extend16_s", "i64.extend32_s",
    "f32.abs", "f32.neg", "f32.ceil", "f32.floor", "f32.trunc",
    "f32.nearest", "f32.sqrt",
    "i32.wrap_i64", "i64.extend_i32_s", "i64.extend_i32_u",
    "i32.trunc_f32_s", "i32.trunc_f32_u",
    "i32.trunc_sat_f32_s", "i32.trunc_sat_f32_u",
    "f32.convert_i32_s", "f32.convert_i32_u",
    "i32.reinterpret_f32", "f32.reinterpret_i32",
    "ref.is_null",
    "f64.abs", "f64.neg", "f64.ceil", "f64.floor", "f64.trunc",
    "f64.nearest", "f64.sqrt",
    "f32.demote_f64", "f64.promote_f32",
    "i64.reinterpret_f64", "f64.reinterpret_i64",
    "f64.convert_i32_s", "f64.convert_i32_u",
    "f64.convert_i64_s", "f64.convert_i64_u",
    "f32.convert_i64_s", "f32.convert_i64_u",
    "i32.trunc_f64_s", "i32.trunc_f64_u",
    "i64.trunc_f32_s", "i64.trunc_f32_u",
    "i64.trunc_f64_s", "i64.trunc_f64_u",
    "i32.trunc_sat_f64_s", "i32.trunc_sat_f64_u",
    "i64.trunc_sat_f32_s", "i64.trunc_sat_f32_u",
    "i64.trunc_sat_f64_s", "i64.trunc_sat_f64_u",
]
ALU1_SUB = {n: i for i, n in enumerate(_ALU1)}
NUM_ALU1 = len(_ALU1)

# -- loads/stores: nbytes, signed, is64 ---------------------------------------
_LOADS = {
    "i32.load": (4, 0, 0), "i64.load": (8, 0, 1), "f32.load": (4, 0, 0),
    "f64.load": (8, 0, 1),
    "i32.load8_s": (1, 1, 0), "i32.load8_u": (1, 0, 0),
    "i32.load16_s": (2, 1, 0), "i32.load16_u": (2, 0, 0),
    "i64.load8_s": (1, 1, 1), "i64.load8_u": (1, 0, 1),
    "i64.load16_s": (2, 1, 1), "i64.load16_u": (2, 0, 1),
    "i64.load32_s": (4, 1, 1), "i64.load32_u": (4, 0, 1),
}
_STORES = {
    "i32.store": 4, "i64.store": 8, "f32.store": 4, "f64.store": 8,
    "i32.store8": 1, "i32.store16": 2,
    "i64.store8": 1, "i64.store16": 2, "i64.store32": 4,
}

_V128_PREFIXES = ("v128.", "i8x16.", "i16x8.", "i32x4.", "i64x2.",
                  "f32x4.", "f64x2.")
_TABLE0_OPS = {"table.get", "table.set", "table.size", "table.grow",
               "table.fill"}

TRAP_DONE = -1  # lane finished normally (trap plane sentinel)
TRAP_HOSTCALL = -2  # lane parked at a HOSTCALL stub, waiting on the host


def _i32(v: int) -> np.int32:
    """Wrap an unsigned value into int32 two's complement."""
    v &= 0xFFFFFFFF
    return np.int32(v - (1 << 32) if v >= (1 << 31) else v)


def batchability(image: LoweredModule, host_imports: Optional[set] = None,
                 n_memories: int = 1) -> Optional[str]:
    """None if the lowered module can run on the batch engine, else why.

    The reference's gate (`wasmedge_tpu/batch/image.py`): v128 ops
    outside `simdops.SUPPORTED_V128` (the load-extend, load-splat,
    load-zero and lane load/store forms) are refused by name.
    host_imports: function indices backed by host functions the engine
    can serve; any other import is unbatchable."""
    if n_memories > 1:
        return "multiple memories"
    for idx, fn in enumerate(image.funcs):
        if fn.is_import and (host_imports is None
                             or idx not in host_imports):
            return (f"unservable imported function "
                    f"{fn.import_module}.{fn.import_name}")
        if fn.nresults > 1:
            return "multi-value results"
    for pc in range(image.code_len):
        op = image.op[pc]
        if op in (LOP_BR, LOP_BRZ, LOP_BRNZ):
            if image.b[pc] > 1:
                return "multi-value branch arity"
            continue
        name = name_of(op)
        if name == "br_table":
            base, n = image.a[pc], image.b[pc]
            for e in range(n + 1):
                if image.br_table[(base + e) * 3 + 1] > 1:
                    return "multi-value branch arity"
            continue
        if name == "return" and image.b[pc] > 1:
            return "multi-value results"
        if name.startswith(_V128_PREFIXES):
            from wasmedge_tpu_torch.batch.simdops import SUPPORTED_V128

            if name not in SUPPORTED_V128:
                return f"unsupported op {name}"
        if name in _TABLE0_OPS and image.a[pc] != 0:
            return f"{name} on table != 0"
        if name == "table.copy" and (image.a[pc] != 0 or image.b[pc] != 0):
            return "table.copy on table != 0"
        if name == "table.init" and image.b[pc] != 0:
            return "table.init on table != 0"
        if name in ("call_indirect", "return_call_indirect") \
                and image.b[pc] != 0:
            return f"{name} on table != 0"
    return None


def slice_refusal(img: "DeviceImage") -> Optional[str]:
    """None if every class in the image runs on this slice's
    interpreter, else a message naming the first class it lacks."""
    bad = sorted(set(np.unique(img.cls).tolist()) - set(
        range(SLICE_MAX_CLASS + 1)))
    if bad:
        names = ", ".join(f"CLS_{CLASS_NAMES.get(c, c)} ({c})" for c in bad)
        return (f"image uses classes this slice of the port does not run: "
                f"{names}")
    return None


@dataclasses.dataclass
class DeviceImage:
    """Numpy-side image; the engine moves the planes to the device once."""

    # per-pc planes [code_len]
    cls: np.ndarray
    sub: np.ndarray
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray
    imm_lo: np.ndarray
    imm_hi: np.ndarray
    br_table: np.ndarray  # [n_entries, 3]: (target, keep, pop)
    # per-function planes [n_funcs]
    f_entry: np.ndarray
    f_nparams: np.ndarray
    f_nlocals: np.ndarray
    f_nresults: np.ndarray
    f_frame_top: np.ndarray  # nlocals + max_height: stack room a frame needs
    f_type: np.ndarray  # dense functype id for call_indirect checks
    # instance snapshot
    table0: np.ndarray  # [table_size] funcidx+1, 0=null
    globals_lo: np.ndarray
    globals_hi: np.ndarray
    mem_init: np.ndarray  # [mem_words] int32 initial memory content
    op_id: np.ndarray  # original opcode id per pc
    mem_pages_init: int
    mem_pages_max: int
    has_memory: bool
    max_local_zeros: int  # max (nlocals - nparams) over funcs
    code_len: int
    v128: np.ndarray  # [n, 4] int32: v128.const values and shuffle masks
    has_simd: bool  # the code holds a v128 class

    NUMPY_FIELDS = ("cls", "sub", "a", "b", "c", "imm_lo", "imm_hi",
                    "br_table", "f_entry", "f_nparams", "f_nlocals",
                    "f_nresults", "f_frame_top", "f_type", "table0",
                    "globals_lo", "globals_hi", "mem_init", "op_id", "v128")
    SCALAR_FIELDS = ("mem_pages_init", "mem_pages_max", "has_memory",
                     "max_local_zeros", "code_len", "has_simd")


def build_device_image(image: LoweredModule, memories=None, globals_=None,
                       table0=None, mod=None) -> DeviceImage:
    imports = [i for i, fn in enumerate(image.funcs) if fn.is_import]
    n = image.code_len + 2 * len(imports)
    cls = np.zeros(n, np.int32)
    sub = np.zeros(n, np.int32)
    a = np.zeros(n, np.int32)
    b = np.zeros(n, np.int32)
    c = np.zeros(n, np.int32)
    imm_lo = np.zeros(n, np.int32)
    imm_hi = np.zeros(n, np.int32)

    # Dense structural functype ids, shared by the function table and
    # call_indirect immediates (the type check is id equality on device).
    type_ids = {}

    def _dense_type(type_idx: int) -> int:
        key = type_idx
        if mod is not None:
            ft = mod.types[type_idx]
            key = (ft.params, ft.results)
        return type_ids.setdefault(key, len(type_ids))

    if table0 is None:
        table0 = np.zeros(1, np.int32)
    else:
        table0 = np.asarray(table0, np.int32)
    # call_indirect's bounds check uses the instruction's `b` (true
    # size); the plane is padded so an empty table still gathers
    table_size = len(table0)
    if table_size == 0:
        table0 = np.zeros(1, np.int32)

    i32_bin = {NAME_TO_ID[f"i32.{s}"]: ALU2_I32_BASE + i
               for i, s in enumerate(_I32_BIN)}
    i64_bin = {NAME_TO_ID[f"i64.{s}"]: ALU2_I64_BASE + i
               for i, s in enumerate(_I32_BIN)}
    f32_bin = {NAME_TO_ID[f"f32.{s}"]: ALU2_F32_BASE + i
               for i, s in enumerate(_F32_BIN)}
    f64_bin = {NAME_TO_ID[f"f64.{s}"]: ALU2_F64_BASE + i
               for i, s in enumerate(_F64_BIN)}
    alu1 = {NAME_TO_ID[nm]: s for nm, s in ALU1_SUB.items()}
    from wasmedge_tpu_torch.batch.simdops import (
        V1_SUB, V2_SUB, VEXTRACT_SUB, VREPLACE_SUB, VSHIFT_SUB, VSPLAT_SUB,
        VTEST_SUB)

    # sub-indexed v128 classes: opcode id -> (class, sub, takes lane imm)
    vsubs = {}
    for vcls, table, lane in (
            (CLS_V2, V2_SUB, False), (CLS_V1, V1_SUB, False),
            (CLS_VTEST, VTEST_SUB, False), (CLS_VSHIFT, VSHIFT_SUB, False),
            (CLS_VSPLAT, VSPLAT_SUB, False),
            (CLS_VEXTRACT, VEXTRACT_SUB, True),
            (CLS_VREPLACE, VREPLACE_SUB, True)):
        for nm, sid in table.items():
            vsubs[NAME_TO_ID[nm]] = (vcls, sid, lane)
    # v128 table index (a), or the memarg offset (imm)
    vplain = {NAME_TO_ID["v128.const"]: (CLS_VCONST, False),
              NAME_TO_ID["i8x16.shuffle"]: (CLS_VSHUFFLE, False),
              NAME_TO_ID["v128.bitselect"]: (CLS_VBITSEL, False),
              NAME_TO_ID["v128.load"]: (CLS_VLOAD, True),
              NAME_TO_ID["v128.store"]: (CLS_VSTORE, True)}
    loads = {NAME_TO_ID[nm]: v for nm, v in _LOADS.items()}
    stores = {NAME_TO_ID[nm]: v for nm, v in _STORES.items()}
    consts = {Op.i32_const, Op.i64_const, Op.f32_const, Op.f64_const}
    op_return = NAME_TO_ID["return"]
    table_cls = {Op.table_get: CLS_TABLE_GET, Op.table_set: CLS_TABLE_SET,
                 Op.table_size: CLS_TABLE_SIZE, Op.table_grow: CLS_TABLE_GROW,
                 Op.table_fill: CLS_TABLE_FILL, Op.table_copy: CLS_TABLE_COPY}

    op_id = np.full(n, int(Op.nop), np.int32)
    op_id[:image.code_len] = np.asarray(image.op[:image.code_len], np.int32)

    stub_pc = {}
    for si, k in enumerate(imports):
        at = image.code_len + 2 * si
        stub_pc[k] = at
        cls[at], a[at] = CLS_HOSTCALL, k
        cls[at + 1], b[at + 1] = CLS_RETURN, image.funcs[k].nresults

    for pc in range(image.code_len):
        op = image.op[pc]
        ia, ib, ic, imm = image.a[pc], image.b[pc], image.c[pc], image.imm[pc]
        if op == LOP_BR:
            cls[pc], a[pc], b[pc], c[pc] = CLS_BR, ia, ib, ic
        elif op == LOP_BRZ:
            cls[pc], a[pc] = CLS_BRZ, ia
        elif op == LOP_BRNZ:
            cls[pc], a[pc], b[pc], c[pc] = CLS_BRNZ, ia, ib, ic
        elif op == Op.br_table:
            cls[pc], a[pc], b[pc] = CLS_BR_TABLE, ia, ib
        elif op == op_return:
            cls[pc], b[pc] = CLS_RETURN, ib
        elif op == Op.call:
            cls[pc], a[pc] = CLS_CALL, ia
        elif op == Op.call_indirect:
            # a = dense type id, b = table size, c = table base offset
            cls[pc], a[pc] = CLS_CALL_INDIRECT, _dense_type(ia)
            b[pc] = table_size
        elif op in consts:
            cls[pc] = CLS_CONST
            imm_lo[pc] = _i32(imm)
            imm_hi[pc] = _i32(imm >> 32)
        elif op == Op.ref_null:
            cls[pc] = CLS_CONST
        elif op == Op.local_get:
            cls[pc], a[pc] = CLS_LOCAL_GET, ia
        elif op == Op.local_set:
            cls[pc], a[pc] = CLS_LOCAL_SET, ia
        elif op == Op.local_tee:
            cls[pc], a[pc] = CLS_LOCAL_TEE, ia
        elif op == Op.global_get:
            cls[pc], a[pc] = CLS_GLOBAL_GET, ia
        elif op == Op.global_set:
            cls[pc], a[pc] = CLS_GLOBAL_SET, ia
        elif op in i32_bin:
            cls[pc], sub[pc] = CLS_ALU2, i32_bin[op]
        elif op in i64_bin:
            cls[pc], sub[pc] = CLS_ALU2, i64_bin[op]
        elif op in f32_bin:
            cls[pc], sub[pc] = CLS_ALU2, f32_bin[op]
        elif op in f64_bin:
            cls[pc], sub[pc] = CLS_ALU2, f64_bin[op]
        elif op in alu1:
            cls[pc], sub[pc] = CLS_ALU1, alu1[op]
        elif op in loads:
            nbytes, signed, is64 = loads[op]
            cls[pc] = CLS_LOAD
            a[pc] = _i32(imm)  # static offset
            b[pc] = nbytes
            c[pc] = signed | (is64 << 1)
        elif op in stores:
            cls[pc] = CLS_STORE
            a[pc] = _i32(imm)
            b[pc] = stores[op]
        elif op in vplain:
            vcls, is_mem = vplain[op]
            cls[pc], a[pc] = vcls, _i32(imm) if is_mem else ia
        elif op in vsubs:
            vcls, sid, lane = vsubs[op]
            cls[pc], sub[pc] = vcls, sid
            if lane:
                a[pc] = ia
        elif op == Op.memory_fill:
            cls[pc] = CLS_MEMFILL
        elif op == Op.memory_copy:
            cls[pc] = CLS_MEMCOPY
        elif op in table_cls:
            cls[pc], b[pc] = table_cls[op], table_size
        elif op == Op.table_init:
            cls[pc], a[pc], b[pc] = CLS_TABLE_INIT, ia, table_size
        elif op == Op.elem_drop:
            cls[pc], a[pc] = CLS_ELEM_DROP, ia
        elif op == Op.memory_init:
            cls[pc], a[pc] = CLS_MEMINIT, ia
        elif op == Op.data_drop:
            cls[pc], a[pc] = CLS_DATA_DROP, ia
        elif op == Op.ref_func:
            cls[pc], a[pc] = CLS_REFFUNC, ia
        elif op == Op.return_call:
            cls[pc], a[pc] = CLS_RETCALL, ia
        elif op == Op.return_call_indirect:
            cls[pc], a[pc] = CLS_RETCALL_INDIRECT, _dense_type(ia)
            b[pc] = table_size
        elif op == Op.memory_size:
            cls[pc] = CLS_MEMSIZE
        elif op == Op.memory_grow:
            cls[pc] = CLS_MEMGROW
        elif op == Op.select:
            cls[pc] = CLS_SELECT
        elif op == Op.drop:
            cls[pc] = CLS_DROP
        elif op == Op.nop:
            cls[pc] = CLS_NOP
        elif op == Op.unreachable:
            cls[pc], a[pc] = CLS_TRAP, int(ErrCode.Unreachable)
        else:
            # batchability() should have refused; a trap is the backstop
            cls[pc], a[pc] = CLS_TRAP, int(ErrCode.ExecutionFailed)

    nf = len(image.funcs)
    f_entry = np.zeros(nf, np.int32)
    f_nparams = np.zeros(nf, np.int32)
    f_nlocals = np.zeros(nf, np.int32)
    f_nresults = np.zeros(nf, np.int32)
    f_frame_top = np.zeros(nf, np.int32)
    f_type = np.zeros(nf, np.int32)
    max_zeros = 0
    for i, fn in enumerate(image.funcs):
        if fn.is_import:
            f_entry[i] = stub_pc[i]
            f_nparams[i] = fn.nparams
            f_nlocals[i] = fn.nparams
            f_nresults[i] = fn.nresults
            f_frame_top[i] = fn.nparams + max(fn.nresults, 1)
            f_type[i] = _dense_type(fn.type_idx)
            continue
        f_entry[i] = fn.entry_pc
        f_nparams[i] = fn.nparams
        f_nlocals[i] = fn.nlocals
        f_nresults[i] = fn.nresults
        f_frame_top[i] = fn.nlocals + fn.max_height
        f_type[i] = _dense_type(fn.type_idx)
        max_zeros = max(max_zeros, fn.nlocals - fn.nparams)

    ng = len(globals_) if globals_ else 0
    g_lo = np.zeros(max(ng, 1), np.int32)
    g_hi = np.zeros(max(ng, 1), np.int32)
    for i in range(ng):
        v = globals_[i].value
        g_lo[i] = _i32(v)
        g_hi[i] = _i32(v >> 32)

    if memories:
        m = memories[0]
        raw = np.frombuffer(bytes(m.data), dtype=np.uint8)
        pad = (-len(raw)) % 4
        if pad:
            raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
        mem_init = raw.view(np.int32).astype(np.int32)
        pages_init = m.pages
        pages_max = m.max if m.max is not None else 0  # 0 = no declared max
    else:
        mem_init = np.zeros(1, np.int32)
        pages_init = 0
        pages_max = 0

    v_lo, v_hi = image.arrays["v128_lo"], image.arrays["v128_hi"]
    v128 = np.zeros((max(len(v_lo), 1), 4), np.int32)
    for i in range(len(v_lo)):
        lo, hi = int(v_lo[i]), int(v_hi[i])
        v128[i] = (_i32(lo), _i32(lo >> 32), _i32(hi), _i32(hi >> 32))

    return DeviceImage(
        cls=cls, sub=sub, a=a, b=b, c=c, imm_lo=imm_lo, imm_hi=imm_hi,
        br_table=np.asarray(image.arrays["br_table"], np.int32),
        f_entry=f_entry, f_nparams=f_nparams, f_nlocals=f_nlocals,
        f_nresults=f_nresults, f_frame_top=f_frame_top, f_type=f_type,
        table0=table0, globals_lo=g_lo, globals_hi=g_hi, mem_init=mem_init,
        op_id=op_id, mem_pages_init=pages_init, mem_pages_max=pages_max,
        has_memory=bool(memories), max_local_zeros=max_zeros, code_len=n,
        v128=v128,
        has_simd=bool(((cls >= CLS_VCONST) & (cls <= CLS_VSTORE)).any()))
