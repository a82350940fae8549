"""Modules that drive every handler of the warp-interpreter.

`build_trap_zoo` dispatches on a per-lane selector to each trap the
interpreter raises, to memory.grow up to and past the page ceiling, to a
memory/global/branch mix, and to call_indirect; `build_alu_edge` folds
every ALU2 and ALU1 operation of the batch encoding into one i64
accumulator (`alu`), with the trapping ones in a second export
(`alu_traps`).  `build_bulk_zoo` runs one memory.fill or memory.copy per
lane over a patterned page with per-lane operands (unaligned, overlapping
both ways, zero-length at and past the end, out of bounds) and
`build_bulk_pair` one fill and one copy; the `build_host_*` modules
import the host functions of `host_env_funcs`.  The v128 fixtures:
`build_simd_sweep` chains op bodies over v128 locals and folds each
result into an i64 (`simd_sweeps` covers every batchable v128 op),
`build_vmix` mixes i32x4 math, a shuffle, an unaligned store and load and
bitselect, `build_v128_mem_zoo` loads and stores at every alignment, at
the end of memory, out of bounds and with a carry in addr + offset,
`build_v128_control` moves v128 values through select, branches with a
kept value, return, calls with v128 parameters and zeroed v128 locals
and local.tee, and `build_simd_host` leaves v128 words where a host
call's result lands.  The window-cache fixtures (B4): `build_window_walk`
crosses a 512-byte window with an unaligned i64 store and load on every
iteration, `build_window_pingpong` writes two regions more than a window
apart in turn and then makes unaligned i64 and v128 accesses straddle
window edges (the overlap rule evicts a dirty way), and
`build_window_host` stores and then parks at a host call in the same
window.  The tests and `chip_smoke.py` use them with lane inputs made
from a seed.
"""

from __future__ import annotations

import numpy as np

from wasmedge_tpu_torch.batch.image import ALU1_SUB, _F32_BIN, _I32_BIN
from wasmedge_tpu_torch.batch.simdops import (
    V1_NAMES, V2_NAMES, VEXTRACT_NAMES, VSHIFT_NAMES, VSPLAT_NAMES,
    VTEST_NAMES)
from wasmedge_tpu_torch.utils.builder import ModuleBuilder
from wasmedge_tpu_torch.utils.wat import parse_wat

ZOO_CASES = 13  # selector k = 0..11 picks a case, anything else the default
ZOO_MEM_PAGES = (1, 3)  # the zoo's memory: min and declared max pages


def build_trap_zoo() -> bytes:
    b = ModuleBuilder()
    b.add_memory(*ZOO_MEM_PAGES)
    b.add_active_data(0, [("i32.const", 16)],
                      bytes([1, 2, 3, 4, 5, 6, 7, 8, 0xFF, 0xFE, 0x80, 0x7F]))
    b.add_global("i32", True, [("i32.const", 5)])
    b.add_global("i64", True, [("i64.const", 0x1_0000_0007)])
    add10 = b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("i32.const", 10), "i32.add"])
    mul3 = b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("i32.const", 3), "i32.mul"])
    ti_i = b.add_type(["i32"], ["i32"])
    ti_ii = b.add_type(["i32", "i32"], ["i32"])
    b.add_table("funcref", 3)
    b.add_active_elem(0, [("i32.const", 0)], [add10, mul3])
    selfloop = 2
    b.add_function([], ["i32"], [], [("call", selfloop)])
    bigframe = 3
    b.add_function(["i32"], ["i32"], ["i64"] * 12, [
        ("local.get", 0), ("i32.const", 1), "i32.add", ("call", bigframe)])
    # grow one page at a time until memory.grow fails
    grow_all = b.add_function([], ["i32"], ["i32"], [
        ("block", None), ("loop", None),
        ("i32.const", 1), "memory.grow", ("i32.const", -1), "i32.eq",
        ("br_if", 1),
        ("local.get", 0), ("i32.const", 1), "i32.add", ("local.set", 0),
        ("br", 0),
        "end", "end",
        ("local.get", 0), ("i32.const", 100), "i32.mul", "memory.size",
        "i32.add"])
    compute = b.add_function(["i32"], ["i32"], ["i64", "i32"], [
        # unaligned and sub-word stores
        ("i32.const", 33), ("local.get", 0), ("i32.store", 0, 0),
        ("i32.const", 41), ("local.get", 0), "i64.extend_i32_s",
        ("i64.const", 0x0102030405060708), "i64.mul", ("i64.store", 0, 0),
        ("i32.const", 50), ("local.get", 0), ("i32.store8", 0, 0),
        ("i32.const", 45), ("local.get", 0), ("i32.store16", 0, 6),
        ("i32.const", 60), ("local.get", 0), "i64.extend_i32_u",
        ("i64.store32", 0, 1),
        # loads spanning words, sign/zero extension, the data segment
        ("i32.const", 37), ("i64.load", 0, 0),
        ("i32.const", 33), ("i64.load8_s", 0, 0), "i64.add",
        ("i32.const", 34), ("i64.load16_s", 0, 0), "i64.xor",
        ("i32.const", 35), ("i64.load32_s", 0, 0), "i64.add",
        ("i32.const", 16), ("i64.load32_u", 0, 8), "i64.add",
        ("i32.const", 50), ("i32.load16_u", 0, 1), "i64.extend_i32_u",
        "i64.add",
        ("i32.const", 48), ("i32.load8_s", 0, 3), "i64.extend_i32_s",
        "i64.xor",
        ("i32.const", 24), ("i64.load16_u", 0, 2), "i64.add",
        ("local.set", 1),
        # globals
        ("global.get", 1), ("local.get", 1), "i64.add", ("global.set", 1),
        ("global.get", 0), ("local.get", 0), "i32.xor", ("global.set", 0),
        # a counted loop of i64 work, (x & 7) trips
        ("block", None), ("loop", None),
        ("local.get", 2), ("local.get", 0), ("i32.const", 7), "i32.and",
        "i32.ge_u", ("br_if", 1),
        ("local.get", 1), ("i64.const", 13), "i64.rotl",
        ("local.get", 2), "i64.extend_i32_u", "i64.mul",
        ("local.get", 1), "i64.xor", ("local.set", 1),
        ("local.get", 2), ("i32.const", 1), "i32.add", ("local.set", 2),
        ("br", 0),
        "end", "end",
        # floats
        ("local.get", 0), "f64.convert_i32_s", ("f64.const", 0.1),
        "f64.mul", "f64.sqrt", "i64.reinterpret_f64", ("local.get", 1),
        "i64.xor", ("local.set", 1),
        ("local.get", 0), "f32.convert_i32_u", ("f32.const", 3.0),
        "f32.div", "i32.trunc_sat_f32_u", "i64.extend_i32_u",
        ("local.get", 1), "i64.add", ("local.set", 1),
        # select and memory.size
        ("local.get", 1), "i32.wrap_i64", "memory.size",
        ("local.get", 0), ("i32.const", 1), "i32.and", "select",
        ("global.get", 0), "i32.add",
        ("local.get", 1), ("i64.const", 32), "i64.shr_u", "i32.wrap_i64",
        "i32.xor",
        ("global.get", 1), "i32.wrap_i64", "i32.add"])
    cases = [
        [("local.get", 1), ("i32.const", 0), "i32.div_s"],
        [("i32.const", -2**31), ("i32.const", -1), "i32.div_s"],
        [("i32.const", 65535), ("i32.load", 0, 4)],
        [("call", selfloop)],
        ["unreachable"],
        [("local.get", 1), ("local.get", 1), ("i32.const", 0),
         ("call_indirect", ti_ii, 0)],
        [("local.get", 1), ("i32.const", 7), ("call_indirect", ti_i, 0)],
        [("local.get", 1), ("i32.const", 2), ("call_indirect", ti_i, 0)],
        [("call", grow_all)],
        [("local.get", 1), ("call", compute)],
        [("local.get", 1), "f32.reinterpret_i32", "i32.trunc_f32_s"],
        [("local.get", 1), ("call", bigframe)],
    ]
    body = [("block", None)] * (len(cases) + 1)
    body += [("local.get", 0), ("br_table", list(range(len(cases))),
                                len(cases)), "end"]
    for case in cases:
        body += case + ["return", "end"]
    body += [("local.get", 1), ("i32.const", 1), ("call_indirect", ti_i, 0),
             ("global.get", 0), "i32.add"]
    b.add_function(["i32", "i32"], ["i32"], [], body, export="zoo")
    return b.build()


def zoo_args(lanes: int, seed: int = 0):
    """Selector k = lane % ZOO_CASES and a seeded x per lane (some x are
    NaN/huge float bit patterns for the truncation case)."""
    rng = np.random.default_rng(seed)
    k = np.arange(lanes, dtype=np.int64) % ZOO_CASES
    x = rng.integers(-1000, 1000, lanes).astype(np.int64)
    trunc = k == 10
    bits = np.array([0x7FC00000, 0x4F000000, 0xCF000001, 0x40490FDB,
                     0xFF800000, 0x3F000000], np.int64)
    x[trunc] = bits[np.arange(int(trunc.sum())) % len(bits)]
    return [k, x]


# -- ALU edge module ----------------------------------------------------------

def _ty(name):
    return name.split(".")[0]


def _load_as(ty, which):
    """Push operand `which` (local 0 or 1, an i64) as type ty."""
    out = [("local.get", which)]
    if ty == "i32":
        out.append("i32.wrap_i64")
    elif ty == "f32":
        out += ["i32.wrap_i64", "f32.reinterpret_i32"]
    elif ty == "f64":
        out.append("f64.reinterpret_i64")
    return out


def _to_i64(ty):
    """Convert a result of type ty on the stack to an i64 cell."""
    return {"i32": ["i64.extend_i32_u"], "i64": [],
            "f32": ["i32.reinterpret_f32", "i64.extend_i32_u"],
            "f64": ["i64.reinterpret_f64"]}[ty]


def _fold():
    return [("local.get", 2), ("i64.const", 5), "i64.rotl", "i64.xor",
            ("local.set", 2)]


_CMP = {"eq", "ne", "lt", "gt", "le", "ge", "lt_s", "lt_u", "gt_s", "gt_u",
        "le_s", "le_u", "ge_s", "ge_u"}
_DIVS = {"div_s", "div_u", "rem_s", "rem_u"}


def _alu2_ops(trapping: bool):
    for ty in ("i32", "i64"):
        for op in _I32_BIN:
            if (op in _DIVS) == trapping:
                yield ty, op
    if not trapping:
        for ty in ("f32", "f64"):
            for op in _F32_BIN:
                yield ty, op


def _alu1_src(name):
    if name == "ref.is_null":
        return None
    for src in ("f32", "f64", "i32", "i64"):
        if name.endswith("_" + src) or f"_{src}_" in name:
            return src
    return _ty(name)


def _alu1_dst(name):
    if name in ("i32.eqz", "i64.eqz") or name.startswith("i32."):
        return "i32"
    return _ty(name)


def _alu1_traps(name):
    return "trunc_f" in name and "sat" not in name


def build_alu_edge() -> bytes:
    """Exports alu(x: i64, y: i64) -> i64 over every non-trapping ALU op
    and alu_traps(x, y) over the trapping ones (div/rem, then the
    non-saturating float->int truncations of x)."""
    b = ModuleBuilder()
    for trapping in (False, True):
        body = []
        for ty, op in _alu2_ops(trapping):
            body += _load_as(ty, 0) + _load_as(ty, 1) + [f"{ty}.{op}"]
            body += _to_i64("i32" if op in _CMP else ty) + _fold()
        for name in ALU1_SUB:
            src = _alu1_src(name)
            if src is None or _alu1_traps(name) != trapping:
                continue
            body += _load_as(src, 0) + [name] + _to_i64(_alu1_dst(name))
            body += _fold()
        body += [("local.get", 2)]
        b.add_function(["i64", "i64"], ["i64"], ["i64"], body,
                       export="alu_traps" if trapping else "alu")
    return b.build()


# Operand bit patterns for build_alu_edge: integer edges, float edges of
# both widths (low 32 bits carry the f32 operand), seeded random bits.
ALU_EDGE_BITS = [
    0, 1, -1, 2, 31, 32, 33, 63, 64, 0x7F, 0x80, 0xFFFF, 2**31 - 1, -2**31,
    2**32 - 1, 2**32, 2**63 - 1, -2**63, 0x0123456789ABCDEF,
    0x7FC00000, 0xFF800000, 0x7F800000, 0x80000000, 0x3F800000, 0xBF000000,
    0x4F000000, 0xCF000001, 0x5F000000, 0x3EAAAAAB, 0x40490FDB,
    0x7FF8000000000000, 0xFFF0000000000000, 0x3FF0000000000000,
    0xBFE0000000000000, 0x41E0000000000000, 0xC3E0000000000001,
    0x43F0000000000000, 0x4004000000000000, 0x3FE0000000000001,
    0x400921FB54442D18,
]
ALU_SUBNORMAL_BITS = [0x00000001, 0x807FFFFF, 0x00400000,
                      0x0000000000000001, 0x800FFFFFFFFFFFFF]


def alu_args(lanes: int, seed: int = 0, subnormals: bool = True):
    """Seeded (x, y) i64 lane operands drawn from the edge patterns and
    random bits."""
    rng = np.random.default_rng(seed)
    pool = list(ALU_EDGE_BITS) + (ALU_SUBNORMAL_BITS if subnormals else [])
    pool = np.array([((v + 2**63) % 2**64) - 2**63 for v in pool], np.int64)
    out = []
    for _ in range(2):
        pick = rng.integers(0, len(pool) + 4, lanes)
        rnd = rng.integers(-2**63, 2**63 - 1, lanes, dtype=np.int64,
                           endpoint=True)
        out.append(np.where(pick < len(pool),
                            pool[np.minimum(pick, len(pool) - 1)], rnd))
    return out


# -- host-function modules -----------------------------------------------------

HOST_MODULE = "env"


def host_env_funcs(raise_trap):
    """name -> (callable, params, results) of the "env" host module the
    build_host_* modules import.  `raise_trap()` raises the host package's
    trap (ExecutionFailed), so one set of bodies serves both packages'
    PyHostFunction."""

    def double(mem, x):
        return x * 2

    def poke(mem, addr, val):
        mem.store(addr, 4, val & 0xFFFFFFFF)
        return val + 1

    def id_or_trap(mem, x):
        if x == 3:
            raise_trap()
        return x

    def grow(mem, delta):
        return mem.grow(delta)

    return {"double": (double, ["i32"], ["i32"]),
            "poke": (poke, ["i32", "i32"], ["i32"]),
            "id_or_trap": (id_or_trap, ["i32"], ["i32"]),
            "grow": (grow, ["i32"], ["i32"])}


def build_host_double() -> bytes:
    """f(x) = env.double(x) + 1."""
    b = ModuleBuilder()
    b.import_func(HOST_MODULE, "double", ["i32"], ["i32"])
    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("call", 0), ("i32.const", 1), "i32.add",
    ], export="f")
    return b.build()


def build_host_poke() -> bytes:
    """f(v): env.poke stores v at 64 and returns v + 1; f returns that
    plus the word loaded back from 64 (2v + 1)."""
    b = ModuleBuilder()
    b.import_func(HOST_MODULE, "poke", ["i32", "i32"], ["i32"])
    b.add_memory(1, 1)
    b.add_function(["i32"], ["i32"], [], [
        ("i32.const", 64), ("local.get", 0), ("call", 0),
        ("i32.const", 64), ("i32.load", 2, 0), "i32.add",
    ], export="f")
    return b.build()


def build_host_trap() -> bytes:
    """f(x) = env.id_or_trap(x), which traps for x == 3."""
    b = ModuleBuilder()
    b.import_func(HOST_MODULE, "id_or_trap", ["i32"], ["i32"])
    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("call", 0),
    ], export="f")
    return b.build()


def build_host_grow() -> bytes:
    """f(delta): env.grow grows memory by delta pages (declared max 4)
    and returns the old size or -1; f then stores 0x5A5A at byte 12 of
    the last page and returns old * 1000 + pages * 10 + (the word loaded
    back == 0x5A5A)."""
    b = ModuleBuilder()
    b.import_func(HOST_MODULE, "grow", ["i32"], ["i32"])
    b.add_memory(1, 4)

    def last_page_word():
        return ["memory.size", ("i32.const", 1), "i32.sub",
                ("i32.const", 65536), "i32.mul", ("i32.const", 12), "i32.add"]

    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("call", 0), ("i32.const", 1000), "i32.mul",
        "memory.size", ("i32.const", 10), "i32.mul", "i32.add",
        *last_page_word(), ("i32.const", 0x5A5A), ("i32.store", 2, 0),
        *last_page_word(), ("i32.load", 2, 0), ("i32.const", 0x5A5A),
        "i32.eq", "i32.add",
    ], export="f")
    return b.build()


# -- bulk memory ---------------------------------------------------------------

BULK_PATTERN_BYTES = 1024  # patterned bytes at the start of the page
BULK_TAIL = 65520  # 16 patterned bytes at the page's end


def _bulk_pattern(n: int, salt: int) -> bytes:
    return bytes(((k * 73 + salt) ^ (k >> 3)) & 0xFF for k in range(n))


def _bulk_op(op: str):
    """fill or copy (dst, b, n), then an i64 checksum of the first
    BULK_PATTERN_BYTES bytes and of the 16 bytes at the page's end."""
    fold = [
        ("block", None), ("loop", None),
        ("local.get", 3), ("i32.const", BULK_PATTERN_BYTES), "i32.ge_u",
        ("br_if", 1),
        ("local.get", 4), ("i64.const", 5), "i64.rotl",
        ("local.get", 3), ("i64.load", 3, 0), "i64.xor", ("local.set", 4),
        ("local.get", 3), ("i32.const", 8), "i32.add", ("local.set", 3),
        ("br", 0), "end", "end",
        ("local.get", 4),
        ("i32.const", BULK_TAIL), ("i64.load", 3, 0), "i64.xor",
        ("i32.const", BULK_TAIL), ("i64.load", 3, 8), "i64.add",
    ]
    return [("local.get", 0), ("local.get", 1), ("local.get", 2), op] + fold


def build_bulk_zoo() -> bytes:
    """Exports fill(dst, val, n) and copy(dst, src, n) over a page whose
    first BULK_PATTERN_BYTES bytes and last 16 bytes carry a byte pattern
    (data segments); each returns the i64 checksum of _bulk_op."""
    b = ModuleBuilder()
    b.add_memory(1, 1)
    b.add_active_data(0, [("i32.const", 0)],
                      _bulk_pattern(BULK_PATTERN_BYTES, 0x3C))
    b.add_active_data(0, [("i32.const", BULK_TAIL)], _bulk_pattern(16, 0x88))
    for op, name in (("memory.fill", "fill"), ("memory.copy", "copy")):
        b.add_function(["i32", "i32", "i32"], ["i64"], ["i32", "i64"],
                       _bulk_op(op), export=name)
    return b.build()


def build_bulk_pair() -> bytes:
    """pair(fdst, fval, fn, cdst, csrc, cn): one memory.fill, then one
    memory.copy, on one 64 KiB page; the launch chip_smoke.py times."""
    b = ModuleBuilder()
    b.add_memory(1, 1)
    b.add_function(["i32"] * 6, [], [], [
        ("local.get", 0), ("local.get", 1), ("local.get", 2), "memory.fill",
        ("local.get", 3), ("local.get", 4), ("local.get", 5), "memory.copy",
    ], export="pair")
    return b.build()


# (dst, n) edge cases every bulk zoo run includes: aligned and unaligned,
# n == 0 at the end and past it, out of bounds at the end, wrapping
_BULK_EDGES = [(0, 64), (64, 7), (1, 300), (3, 1), (65536, 0), (65537, 0),
               (65530, 10), (65520, 16), (0xFFFFFFF0, 32), (130, 0)]
# copy src - dst: backward overlap (-5, -1), forward overlap (1, 3, 6),
# aligned moves and far sources
_BULK_DELTAS = [-5, -1, 1, 3, 6, 0, 4, -8, 200, -200]


def bulk_zoo_args(lanes: int, op: str, seed: int = 0):
    """Per-lane (dst, val-or-src, n) for build_bulk_zoo's `op` export:
    the edge cases first, then seeded lane-dependent offsets and lengths
    (copy sources at the deltas above, some source ranges out of
    bounds)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, 900, lanes).astype(np.int64)
    n = rng.integers(1, 120, lanes).astype(np.int64)
    k = min(lanes, len(_BULK_EDGES))
    dst[:k] = [d for d, _ in _BULK_EDGES[:k]]
    n[:k] = [m for _, m in _BULK_EDGES[:k]]
    if op == "fill":
        val = rng.integers(0, 1 << 16, lanes).astype(np.int64)
        return [dst, val, n]
    delta = np.array(_BULK_DELTAS, np.int64)[np.arange(lanes) % len(
        _BULK_DELTAS)]
    src = dst + delta
    src[src < 0] = 0
    # a few copies whose source range ends past the page
    far = np.arange(lanes) % 11 == 7
    src[far] = 65536 - n[far] + 3
    return [dst & 0xFFFFFFFF, src & 0xFFFFFFFF, n]


# -- v128 ---------------------------------------------------------------------

def _simd_fold(acc_local, body):
    """acc ^= e0 ^ (e1 * 3) of the v128 that `body` leaves on the stack."""
    return body + [
        ("local.tee", 3),
        ("i64x2.extract_lane", 0),
        ("local.get", acc_local), "i64.xor",
        ("local.get", 3), ("i64x2.extract_lane", 1),
        ("i64.const", 3), "i64.mul", "i64.xor",
        ("local.set", acc_local),
    ]


def build_simd_sweep(op_bodies) -> bytes:
    """f(x: i64, y: i64) -> i64 chaining per-op bodies over v128 locals
    (the reference's tests/test_batch_simd.py build_sweep).

    locals: 2 = a (v128 from x), 3 = scratch v128, 4 = acc (i64),
    5 = b (v128 from y)"""
    b = ModuleBuilder()
    body = [
        ("local.get", 0), "i64x2.splat",
        ("local.get", 0), ("i64.const", 0x9E3779B97F4A7C15 - 2**64),
        "i64.mul", ("i64x2.replace_lane", 1),
        ("local.set", 2),
        ("local.get", 1), "i64x2.splat",
        ("local.get", 1), ("i64.const", 0xC2B2AE3D27D4EB4F - 2**64),
        "i64.xor", ("i64x2.replace_lane", 1),
        ("local.set", 5),
    ]
    for op_body in op_bodies:
        body += _simd_fold(4, op_body)
    body += [("local.get", 4)]
    b.add_function(["i64", "i64"], ["i64"], ["v128", "v128", "i64", "v128"],
                   body, export="f")
    return b.build()


SWEEP_CHUNK = 20  # ops per sweep module


def _lane_bodies():
    """Shuffle, swizzle, bitselect, const, and extract / replace of every
    shape at several lanes."""
    k1 = int.from_bytes(bytes(range(16)), "little")
    shuf = [0, 17, 2, 19, 4, 21, 6, 23, 8, 25, 10, 27, 12, 29, 14, 31]
    rev = list(range(31, 15, -1))
    out = [
        [("local.get", 2), ("local.get", 5), ("v128.const", k1),
         "v128.bitselect"],
        [("local.get", 2), ("local.get", 5), ("i8x16.shuffle", shuf)],
        [("local.get", 5), ("local.get", 2), ("i8x16.shuffle", rev)],
        [("local.get", 2), ("local.get", 5), "i8x16.swizzle"],
        [("local.get", 2), ("v128.const", k1 ^ 0x0F1E2D3C4B5A6978),
         "i8x16.swizzle"],
        [("v128.const", k1)],
    ]
    to_scalar = {"i8x16": [], "i16x8": [], "i32x4": [],
                 "i64x2": ["i32.wrap_i64"],
                 "f32x4": ["i32.reinterpret_f32"],
                 "f64x2": ["i64.reinterpret_f64", "i32.wrap_i64"]}
    from_i32 = {"i8x16": [], "i16x8": [], "i32x4": [],
                "i64x2": ["i64.extend_i32_s"],
                "f32x4": ["f32.reinterpret_i32"],
                "f64x2": ["i64.extend_i32_u", ("i64.const", 0x3FF0 << 48),
                          "i64.or", "f64.reinterpret_i64"]}
    lanes = {"i8x16": 16, "i16x8": 8, "i32x4": 4, "i64x2": 2, "f32x4": 4,
             "f64x2": 2}
    for i, ex in enumerate(VEXTRACT_NAMES):
        shape = ex.split(".")[0]
        rp = f"{shape}.replace_lane"
        for lane in sorted({0, lanes[shape] - 1, (i * 5) % lanes[shape]}):
            # extract a lane of b, replace a lane of a with it
            out.append([("local.get", 2), ("local.get", 5), (ex, lane)]
                       + to_scalar[shape] + [("i32.const", i + 1), "i32.add"]
                       + from_i32[shape]
                       + [(rp, (lane * 3 + 1) % lanes[shape])])
    return out


def simd_sweeps() -> dict:
    """name -> op bodies of one sweep module; together they run every
    batchable v128 op (v128.load / v128.store: build_v128_mem_zoo)."""
    sweeps = {}

    def add(prefix, bodies):
        for i in range(0, len(bodies), SWEEP_CHUNK):
            sweeps[f"{prefix}_{i // SWEEP_CHUNK}"] = bodies[i:i + SWEEP_CHUNK]

    add("v2", [[("local.get", 2), ("local.get", 5), op] for op in V2_NAMES])
    add("v1", [[("local.get", 2), op] for op in V1_NAMES])
    # tests give an i32: splat it back into a v128 for the fold
    sweeps["vtest"] = [[("local.get", w), op, "i32x4.splat"]
                       for w in (2, 5) for op in VTEST_NAMES]
    shift_splat = []
    for i, op in enumerate(VSHIFT_NAMES):
        shift_splat.append([("local.get", 2), ("local.get", 1),
                            "i32.wrap_i64", ("i32.const", i), "i32.add", op])
    for op in VSPLAT_NAMES:
        conv = {"i64x2": [], "f64x2": ["f64.reinterpret_i64"],
                "f32x4": ["i32.wrap_i64", "f32.reinterpret_i32"]}.get(
                    op.split(".")[0], ["i32.wrap_i64"])
        shift_splat.append([("local.get", 0)] + conv + [op])
    sweeps["shift_splat"] = shift_splat
    add("lanes", _lane_bodies())
    return sweeps


def simd_sweep_args(lanes: int, seed: int = 0, corners: bool = False):
    """Seeded (x, y) i64 lane operands: random bits, or (corners) words
    built from the bytes 0x00, 0x01, 0x7F, 0x80, 0xFE and 0xFF."""
    rng = np.random.default_rng(seed)
    if not corners:
        return [rng.integers(-2**63, 2**63 - 1, lanes, np.int64,
                             endpoint=True) for _ in range(2)]
    pick = np.array([0x00, 0x01, 0x7F, 0x80, 0xFE, 0xFF], np.uint8)
    raw = pick[rng.integers(0, len(pick), (2, lanes, 8))]
    return [raw[k].view(np.int64)[:, 0].copy() for k in range(2)]


VMIX_WAT = """
(module
  (memory 1)
  (func (export "vmix") (param i32) (result i32)
    (local $acc v128)
    (local $i i32)
    (local.set $acc (v128.const i32x4 1 2 3 4))
    (block (loop
      (br_if 1 (i32.ge_u (local.get $i) (local.get 0)))
      (local.set $acc
        (i32x4.add (local.get $acc) (i32x4.splat (local.get $i))))
      (local.set $acc
        (v128.xor (local.get $acc)
                  (i8x16.shuffle 4 5 6 7 0 1 2 3 12 13 14 15 8 9 10 11
                                 (local.get $acc) (local.get $acc))))
      (local.set $i (i32.add (local.get $i) (i32.const 1)))
      (br 0)))
    ;; unaligned v128 store + load round-trip
    (v128.store offset=3 (i32.const 64) (local.get $acc))
    (local.set $acc (v128.load offset=3 (i32.const 64)))
    (i32.add
      (i32x4.extract_lane 1 (local.get $acc))
      (i32.add
        (i32x4.extract_lane 2
          (v128.bitselect (local.get $acc)
                          (v128.const i32x4 -1 -1 -1 -1)
                          (v128.const i32x4 0xFF00FF00 0x00FF00FF
                                            0xF0F0F0F0 0x0F0F0F0F)))
        (i32x4.extract_lane 3 (local.get $acc))))))
"""


def build_vmix() -> bytes:
    """vmix(n): the reference's v128 Pallas fixture
    (tests/test_pallas_engine.py _simd_wat_module)."""
    return parse_wat(VMIX_WAT)


_PATTERN = "".join(f"\\{(i * 37 + 11) & 0xFF:02x}" for i in range(64))
_TAIL = "".join(f"\\{(i * 91 + 5) & 0xFF:02x}" for i in range(16))

V128_MEM_ZOO_WAT = f"""
(module
  (memory 1 1)
  (data (i32.const 0) "{_PATTERN}")
  (data (i32.const 65520) "{_TAIL}")
  (func $mk (param $x i64) (result v128)
    (i64x2.replace_lane 1 (i64x2.splat (local.get $x))
      (i64.mul (local.get $x) (i64.const 0x9E3779B97F4A7C15))))
  (func $fold (param $v v128) (result i64)
    (i64.xor (i64x2.extract_lane 0 (local.get $v))
             (i64.mul (i64x2.extract_lane 1 (local.get $v)) (i64.const 3))))
  ;; loads see the data, two overlapping stores at other alignments, a
  ;; load across both, and the words around them read back as i64
  (func (export "rw") (param $a i32) (param $x i64) (result i64)
    (local $v v128)
    (local.set $v (v128.xor (call $mk (local.get $x))
                            (v128.load offset=3 (local.get $a))))
    (v128.store offset=1 (local.get $a) (local.get $v))
    (v128.store offset=6 (local.get $a) (v128.not (local.get $v)))
    (local.set $v (i8x16.add (local.get $v) (v128.load (local.get $a))))
    (i64.add (call $fold (local.get $v))
      (i64.xor (i64.load (local.get $a))
               (i64.load offset=8 (local.get $a)))))
  ;; offsets near 2^32: addr + offset carries, or the end wraps
  (func (export "wrap") (param $a i32) (param $x i64) (result i64)
    (v128.store offset=0xFFFFFFF8 (local.get $a) (call $mk (local.get $x)))
    (call $fold (v128.load offset=0xFFFFFFF0 (local.get $a))))
)
"""

# addresses for rw: every addr & 3 at the start, in the middle and at the
# end of the page (65514 is the last address whose accesses all fit),
# then out of bounds on the second store, on the first load, and with a
# carry in addr + offset
V128_ZOO_ADDRS = [0, 1, 2, 3, 17, 102, 1023, 4093, 65496, 65501, 65510,
                  65514, 65515, 65520, 65530, 65533, -1, -8]


def build_v128_mem_zoo() -> bytes:
    return parse_wat(V128_MEM_ZOO_WAT)


def v128_zoo_args(lanes: int, seed: int = 0):
    """(a, x) lane operands for the memory zoo: the addresses above in
    turn and seeded x."""
    rng = np.random.default_rng(seed)
    addrs = np.resize(np.array(V128_ZOO_ADDRS, np.int64), lanes)
    return [addrs, rng.integers(-2**63, 2**63 - 1, lanes, np.int64,
                                endpoint=True)]


V128_CONTROL_WAT = """
(module
  (func $mix (param $a v128) (param $b v128) (param $k i32) (result v128)
    (local $t v128) (local $z v128)
    ;; $z is a zeroed v128 local
    (local.set $t (i32x4.add (local.get $a) (local.get $z)))
    (if (i32.eqz (i32.and (local.get $k) (i32.const 7)))
      (then (return (v128.xor (local.get $t) (local.get $b)))))
    (block $out (result v128)
      (block $two (result v128)
        (block $one (result v128)
          (br_table $one $two $out
            (local.tee $t (i8x16.sub (local.get $t) (local.get $b)))
            (i32.rem_u (local.get $k) (i32.const 4))))
        (local.set $t)
        (br $out (i16x8.add (local.get $t) (local.get $a))))
      (local.set $t)
      (drop (br_if $out (v128.not (local.get $t))
                        (i32.and (local.get $k) (i32.const 8))))
      (i64x2.add (local.get $t) (local.get $b))))
  (func (export "ctl") (param $x i64) (param $k i32) (result i64)
    (local $v v128) (local $w v128)
    (local.set $v (i64x2.replace_lane 1 (i64x2.splat (local.get $x))
                    (i64.rotl (local.get $x) (i64.const 17))))
    (local.set $w (select (local.get $v) (v128.not (local.get $v))
                          (i32.and (local.get $k) (i32.const 16))))
    (local.set $v (call $mix (local.get $v) (local.get $w) (local.get $k)))
    (i64.xor (i64x2.extract_lane 0 (local.get $v))
             (i64.mul (i64x2.extract_lane 1 (local.get $v)) (i64.const 5))))
)
"""


def build_v128_control() -> bytes:
    return parse_wat(V128_CONTROL_WAT)


V128_HOST_WAT = """
(module
  (import "env" "double" (func $double (param i32) (result i32)))
  ;; two v128 values pushed and dropped leave their words in the rows
  ;; where the call's argument and its result land: the host writes the
  ;; result's low words only, and return moves all four
  (func (export "f") (param $x i32) (result i64)
    (local $r i32)
    (drop (i32x4.splat (i32.add (local.get $x) (i32.const 7))))
    (drop (i32x4.splat (i32.mul (local.get $x) (i32.const 3))))
    (local.set $r (call $double (local.get $x)))
    (i64x2.extract_lane 1
      (i64x2.add (i64x2.splat (i64.extend_i32_u (local.get $r)))
                 (i32x4.splat (local.get $x)))))
)
"""


def build_simd_host() -> bytes:
    """f(x): v128 residue under env.double(x)'s frame, then v128 math on
    the result."""
    return parse_wat(V128_HOST_WAT)


# -- fusion fixtures (B2 blocks, B6 superinstructions) -------------------------

GUARD_WAT = """
(module
  (memory 1)
  (global $g (mut i32) (i32.const 3))
  (global $h (mut i64) (i64.const 5))
  (func (export "guard") (param $x i32) (param $n i32) (result i32)
    (local $acc i32) (local $i i32) (local $w i64)
    (loop $top
      (block $skip
        ;; local and global traffic, then a forward br_if mid-block
        ;; (guardnz): taken when (x + i) & 3 != 0
        local.get $acc
        local.get $i
        i32.add
        local.tee $acc
        global.get $g
        i32.xor
        global.set $g
        local.get $x
        local.get $i
        i32.add
        i32.const 3
        i32.and
        br_if $skip
        global.get $g
        i32.const 7
        i32.mul
        global.set $g
        global.get $g
        local.get $acc
        local.get $i
        i32.const 1
        i32.and
        select
        local.set $acc
        memory.size
        local.get $acc
        i32.add
        drop
        local.get $w
        global.get $h
        i64.add
        global.set $h)
      ;; an if without else mid-block (guardz): taken when i is even
      (if (i32.and (local.get $i) (i32.const 1))
        (then
          local.get $acc
          i32.const 11
          i32.add
          local.set $acc))
      ;; an if on two locals (local.get, local.get, compare, brz)
      (if (i32.gt_u (local.get $acc) (local.get $x))
        (then
          local.get $acc
          i32.const 3
          i32.shr_u
          local.set $acc))
      local.get $w
      local.get $acc
      i64.extend_i32_u
      i64.add
      local.set $w
      local.get $i
      i32.const 1
      i32.add
      local.tee $i
      local.get $n
      i32.lt_s
      br_if $top)
    local.get $acc
    global.get $g
    i32.add
    local.get $w
    global.get $h
    i64.xor
    i32.wrap_i64
    i32.xor))
"""


def build_guard_mix() -> bytes:
    """guard(x, n): a loop whose blocks hold a forward br_if (taken or not
    per lane and iteration), an if without else, local.tee, select,
    memory.size, drop and global writes read back in the same block."""
    return parse_wat(GUARD_WAT)


OOB_WAT = """
(module
  (memory 1)
  (data (i32.const 0) "\\01\\82\\03\\f4\\05\\96\\07\\a8\\09\\ba")
  (func (export "oob") (param $a i32) (param $v i32) (result i32)
    (local $s i32)
    local.get $v
    i32.const 3
    i32.mul
    local.set $s
    ;; a store, then loads of three widths, each out of bounds for some
    ;; lanes, in one block with live cells under them
    local.get $s
    local.get $a
    local.get $s
    i32.store offset=4
    local.get $a
    i64.load16_s offset=2
    i32.wrap_i64
    local.get $a
    i32.load8_u offset=65530
    i32.add
    local.get $a
    i64.load offset=1
    i32.wrap_i64
    i32.xor
    i32.add
    local.get $a
    local.get $s
    i64.extend_i32_s
    i64.store16 offset=65530
    local.get $a
    i32.load offset=3
    i32.add))
"""

# lane addresses for oob: in bounds for every access (0-4), then out of
# bounds first on the i64.store16 (5), on the i32.load8_u (6, 65528), on
# the i32.store (65529, 65535) and with a carry in addr + offset (-1, -4)
OOB_ADDRS = [0, 1, 2, 3, 4, 5, 6, 65528, 65529, 65535, 4, 3, -1, -4]


def build_oob_mix() -> bytes:
    return parse_wat(OOB_WAT)


def oob_args(lanes: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [np.resize(np.array(OOB_ADDRS, np.int64), lanes),
            rng.integers(-2**31, 2**31, lanes)]


def build_straight_line(n: int = 40) -> bytes:
    """line(x): one function of 1 + 3 n straight-line ops (more than a
    block's 24, so the planner cuts it into full blocks)."""
    b = ModuleBuilder()
    body = [("local.get", 0)]
    for k in range(n):
        body += [("i32.const", k * 7 + 1),
                 ("i32.add", "i32.xor", "i32.mul", "i32.rotl")[k % 4],
                 ("local.tee", 1) if k % 3 == 0 else "nop"]
    b.add_function(["i32"], ["i32"], ["i32"], body, export="line")
    return b.build()


def build_many_shapes(n: int = 128) -> bytes:
    """n functions, function k of shape local.get, then for each bit of k
    an i32.const and an add or sub, then return: n distinct block shapes
    (more than the planner's 96 when n > 96); `f` calls each in turn."""
    b = ModuleBuilder()
    funcs = []
    for k in range(n):
        body = [("local.get", 0)]
        for bit in range(max(n - 1, 1).bit_length()):
            body += [("i32.const", bit + 1),
                     "i32.add" if (k >> bit) & 1 else "i32.sub"]
        funcs.append(b.add_function(["i32"], ["i32"], [], body))
    top = [("local.get", 0)]
    for f in funcs:
        top += [("call", f)]
    b.add_function(["i32"], ["i32"], [], top, export="f")
    return b.build()


# -- the memory window cache (B4) --------------------------------------------


def build_window_walk() -> bytes:
    """edgewalk(n) -> i64: for i < n an i64 store of i ^ 0x0123456789ABCDEF
    at i * 520 + 6 (unaligned, three words) and its load back, folded by
    xor; each iteration crosses the 512-byte (128-word) window, so the two
    ways alternate (the JAX package's tests/test_pallas_hbm.py stride
    walk).  n <= 126 stays in the one page."""
    b = ModuleBuilder()
    b.add_memory(1, 2)
    b.add_function(["i32"], ["i64"], ["i32", "i64"], [
        ("block", None),
        ("loop", None),
        ("local.get", 1), ("local.get", 0), "i32.ge_u", ("br_if", 1),
        ("local.get", 1), ("i32.const", 520), "i32.mul",
        ("local.get", 1), "i64.extend_i32_u",
        ("i64.const", 0x0123456789ABCDEF), "i64.xor",
        ("i64.store", 3, 6),
        ("local.get", 2),
        ("local.get", 1), ("i32.const", 520), "i32.mul",
        ("i64.load", 3, 6),
        "i64.xor", ("local.set", 2),
        ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
        ("br", 0),
        "end",
        "end",
        ("local.get", 2),
    ], export="edgewalk")
    return b.build()


WINDOW_PINGPONG_WAT = """
(module
  (memory 1 1)
  ;; pingpong(x, o, n): region A at o and region B at o + 8192 (2048 words
  ;; apart, more than a window) are written and read in turn, A last; then
  ;; an unaligned i64 store at o + 506 straddles the edge of A's first
  ;; window (its window overlaps the dirty way that holds A: the overlap
  ;; rule writes that way back and invalidates it), a load goes back to
  ;; A's start, a v128 load across the same edge reads the i64 back, and a
  ;; v128 store across the edge of B's window is read back as an i64
  (func (export "pingpong") (param $x i32) (param $o i32) (param $n i32)
                            (result i64)
    (local $i i32) (local $a i32) (local $acc i64) (local $v v128)
    (block (loop
      (br_if 1 (i32.ge_u (local.get $i) (local.get $n)))
      (local.set $a (i32.add (local.get $o)
                             (i32.shl (local.get $i) (i32.const 2))))
      (i32.store (local.get $a) (i32.xor (local.get $x) (local.get $i)))
      (i32.store offset=8192 (local.get $a)
                 (i32.add (local.get $x) (local.get $i)))
      (local.set $acc
        (i64.add (local.get $acc)
                 (i64.extend_i32_u (i32.load offset=8192 (local.get $a)))))
      (local.set $acc
        (i64.xor (i64.rotl (local.get $acc) (i64.const 5))
                 (i64.extend_i32_u (i32.load (local.get $a)))))
      (local.set $i (i32.add (local.get $i) (i32.const 1)))
      (br 0)))
    (i64.store offset=506 (local.get $o) (local.get $acc))
    (local.set $acc
      (i64.add (local.get $acc) (i64.load offset=10 (local.get $o))))
    (local.set $v (v128.load offset=500 (local.get $o)))
    (v128.store offset=8702 (local.get $o)
                (v128.xor (local.get $v) (i32x4.splat (local.get $x))))
    (i64.xor
      (i64.add (local.get $acc) (i64x2.extract_lane 0 (local.get $v)))
      (i64.add (i64x2.extract_lane 1 (local.get $v))
               (i64.load offset=8706 (local.get $o)))))
)
"""


def build_window_pingpong() -> bytes:
    return parse_wat(WINDOW_PINGPONG_WAT)


def window_pingpong_args(lanes: int, seed: int = 0):
    """(x, o, n): seeded x, every byte offset o in 0..63 in turn (the
    straddling accesses land on both sides of the window edges) and
    n in 1..24 iterations."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-2**31, 2**31, lanes), np.arange(lanes) % 64,
            np.arange(lanes) % 24 + 1]


def build_window_host() -> bytes:
    """f(x): stores x at 64, parks at env.double in the same window (the
    park must write the window back), loads 64 again, lets env.poke store
    x at 68 (the serve round writes the plane) and loads that back:
    returns 2x + x + (x + 1) + x = 5x + 1."""
    b = ModuleBuilder()
    b.import_func(HOST_MODULE, "double", ["i32"], ["i32"])
    b.import_func(HOST_MODULE, "poke", ["i32", "i32"], ["i32"])
    b.add_memory(1, 1)
    b.add_function(["i32"], ["i32"], [], [
        ("i32.const", 64), ("local.get", 0), ("i32.store", 2, 0),
        ("local.get", 0), ("call", 0),
        ("i32.const", 64), ("i32.load", 2, 0), "i32.add",
        ("i32.const", 68), ("local.get", 0), ("call", 1), "i32.add",
        ("i32.const", 68), ("i32.load", 2, 0), "i32.add",
    ], export="f")
    return b.build()


# -- optimistic convergence (B3) ------------------------------------------------

def build_divergent_addresses() -> bytes:
    """f(a): stores a at address a and loads it back (the divergent-address
    fixture of the JAX package's tests/test_optimistic.py): per-lane
    addresses make a warp's lanes disagree on every access."""
    b = ModuleBuilder()
    b.add_memory(1, 1)
    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("local.get", 0), ("i32.store", 2, 0),
        ("local.get", 0), ("i32.load", 2, 0),
    ], export="f")
    return b.build()


def build_nonzero_conditions() -> bytes:
    """f(x): a loop of 50 rounds whose `br_if` condition is
    (i < 50) * (x | 1): nonzero and different per lane on every round but
    the last, zero on every lane there, so the lanes agree on every
    branch though its values differ.  Returns 50."""
    b = ModuleBuilder()
    b.add_function(["i32"], ["i32"], ["i32"], [
        ("block", None),
        ("loop", None),
        ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
        ("local.get", 1), ("i32.const", 50), "i32.lt_u",
        ("local.get", 0), ("i32.const", 1), "i32.or", "i32.mul",
        ("br_if", 0),
        "end",
        "end",
        ("local.get", 1),
    ], export="f")
    return b.build()


def build_call_sites() -> bytes:
    """f(x): calls g() from one of two call sites at the same stack height,
    the `then` arm for odd x and the `else` arm for even x, and adds 1 or 2
    to its result (g returns 100 after a loop of 40 rounds).  The lanes of
    a warp that took different arms enter g at the same step and run it
    in lock-step, with the same pc, sp, fp and call depth: a launch that
    starts inside g finds them converged, though each returns through its
    own frame row to its own call site."""
    b = ModuleBuilder()
    g = b.add_function([], ["i32"], ["i32"], [
        ("block", None),
        ("loop", None),
        ("local.get", 0), ("i32.const", 1), "i32.add", ("local.tee", 0),
        ("i32.const", 40), "i32.lt_u", ("br_if", 0),
        "end",
        "end",
        ("i32.const", 100),
    ])
    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("i32.const", 1), "i32.and",
        ("if", "i32"),
        ("call", g), ("i32.const", 1), "i32.add",
        "else",
        ("call", g), ("i32.const", 2), "i32.add",
        "end",
    ], export="f")
    return b.build()


# -- the warp bulk pass and the on-chip stack rows ------------------------------

def build_bulk_warp() -> bytes:
    """fill(dst, val, n) / copy(dst, src, n): one memory.fill or
    memory.copy on one 64 KiB page, then the word at dst xor the word at
    dst + n - 4 (a few instructions around the op, so a comparison's
    cost is the op's)."""
    b = ModuleBuilder()
    b.add_memory(1, 1)
    b.add_active_data(0, [("i32.const", 0)], _bulk_pattern(8192, 0x5D))
    for op, name in (("memory.fill", "fill"), ("memory.copy", "copy")):
        b.add_function(["i32", "i32", "i32"], ["i32"], [], [
            ("local.get", 0), ("local.get", 1), ("local.get", 2), op,
            ("local.get", 0), ("i32.load", 0, 0),
            ("local.get", 0), ("local.get", 2), "i32.add", ("i32.const", 4),
            "i32.sub", ("i32.load", 0, 0), "i32.xor",
        ], export=name)
    return b.build()


# build_bulk_warp's fill / copy shaped for the warp-cooperative row pass:
# every lane of a warp at the op together, ranges of thousands of bytes
BULK_WARP_CASES = (
    "fill_shift0", "fill_shift1", "fill_shift2", "fill_shift3",
    "copy_fwd_shift0", "copy_fwd_shift1", "copy_fwd_shift2",
    "copy_fwd_shift3", "copy_bwd_shift0", "copy_bwd_shift1",
    "copy_bwd_shift2", "copy_bwd_shift3", "fill_lanes", "copy_one_delta",
    "copy_two_deltas", "fill_oob_and_empty", "copy_oob_and_empty")


def bulk_warp_case(lanes: int, case: str):
    """(export, per-lane args) of build_bulk_warp for one case of
    BULK_WARP_CASES.  fill_shift{s}: every lane fills 6000 + s bytes at
    256 + s.  copy_{fwd,bwd}_shift{s}: every lane copies 5000 bytes at
    1000 + s from 12 + s bytes above (fwd: src > dst, the walk goes up)
    or below (bwd: dst > src, the walk goes down), overlapping.
    fill_lanes: lane-dependent dst, byte and length.  copy_one_delta:
    lane-dependent dst and n, src = dst - 6 on every lane (one group);
    copy_two_deltas: src - dst is -6 on even lanes and +7 on odd lanes (two
    groups in every warp).  *_oob_and_empty: a converged op whose lane 3 of
    each warp is out of bounds and whose lanes 5 and 9 have n == 0."""
    lane = np.arange(lanes, dtype=np.int64)
    if case.startswith("fill_shift"):
        s = int(case[-1])
        return "fill", [np.full(lanes, 256 + s), np.full(lanes, 0xA5),
                        np.full(lanes, 6000 + s)]
    if case.startswith("copy_") and "_shift" in case:
        s = int(case[-1])
        dst = np.full(lanes, 1000 + s)
        delta = (12 + s) * (1 if "_fwd_" in case else -1)
        return "copy", [dst, dst + delta, np.full(lanes, 5000)]
    if case == "fill_lanes":
        return "fill", [lane * 7 % 900, lane * 29 + 3, 4000 + lane * 11 % 300]
    if case in ("copy_one_delta", "copy_two_deltas"):
        dst = 300 + lane * 37 % 1024
        delta = np.full(lanes, -6)
        if case == "copy_two_deltas":
            delta[1::2] = 7
        return "copy", [dst, dst + delta, 3000 + lane * 13 % 500]
    assert case in ("fill_oob_and_empty", "copy_oob_and_empty"), case
    dst = np.full(lanes, 4000)
    n = np.full(lanes, 6000)
    dst[lane % 32 == 3] = 65500
    n[(lane % 32 == 5) | (lane % 32 == 9)] = 0
    if case == "fill_oob_and_empty":
        return "fill", [dst, np.full(lanes, 0x3C), n]
    return "copy", [dst, dst + 9, n]


def build_deep_recursion() -> bytes:
    """deep(n): a recursion n deep whose frames hold eight i64 locals (11
    stack rows a frame with the operands under its call), each mixed from
    n and folded with the callee's result on the way back; deep(0) is 7.
    With n from 48 up, the stack crosses row 512 of a 1024-row stack (the
    on-chip rows of a launch at that depth) and comes back."""
    b = ModuleBuilder()
    locs = list(range(1, 9))  # a..h
    body = [("local.get", 0), "i32.eqz", ("if", "i64"), ("i64.const", 7),
            "else",
            ("local.get", 0), "i64.extend_i32_u",
            ("i64.const", 0x9E3779B97F4A7C15 - (1 << 64)), "i64.mul",
            ("local.set", locs[0])]
    for k in range(1, 8):
        body += [("local.get", locs[k - 1]), ("i64.const", 5 + 4 * k),
                 "i64.rotl", ("local.get", 0), "i64.extend_i32_u", "i64.xor",
                 ("local.set", locs[k])]
    # a + (b ^ deep(n - 1)), then every local folded in
    body += [("local.get", locs[0]), ("local.get", locs[1]),
             ("local.get", 0), ("i32.const", 1), "i32.sub", ("call", 0),
             "i64.xor", "i64.add"]
    for k in range(2, 8):
        body += [("i64.const", 31), "i64.mul", ("local.get", locs[k]),
                 "i64.add"]
    body += ["end"]
    b.add_function(["i32"], ["i64"], ["i64"] * 8, body, export="deep")
    return b.build()


def build_host_rows() -> bytes:
    """f(x): parks at env.double three times with live rows under the
    call (x * 3 and x ^ 0x55, then the running value and a local), and
    folds them after each return: the rows a launch keeps on chip cross
    every park and serve round."""
    b = ModuleBuilder()
    b.import_func(HOST_MODULE, "double", ["i32"], ["i32"])
    body = [("local.get", 0), ("i32.const", 3), "i32.mul",
            ("local.get", 0), ("i32.const", 0x55), "i32.xor",
            ("local.get", 0), ("call", 0), "i32.add", "i32.add",
            ("local.set", 1)]
    for k in range(2):
        body += [("local.get", 1), ("i32.const", 5 + k), "i32.mul",
                 ("local.get", 0), ("local.get", 1), ("i32.const", k),
                 "i32.add", ("call", 0), "i32.sub", "i32.xor",
                 ("local.set", 1)]
    body += [("local.get", 1)]
    b.add_function(["i32"], ["i32"], ["i32"], body, export="f")
    return b.build()


def build_rollback_rows() -> bytes:
    """f(x): 30 rounds, each adding to local a or multiplying into local b
    by bit i of x, then a * 31 + b.  The lanes of a warp take different
    arms, so a warp that starts a launch converged follows lane 0's arm and
    its other lanes write wrong values into the rows of a and b below sp
    until the rollback restores them."""
    b = ModuleBuilder()
    i, a, c = 1, 2, 3
    b.add_function(["i32"], ["i32"], ["i32", "i32", "i32"], [
        ("block", None), ("loop", None),
        ("local.get", i), ("i32.const", 30), "i32.ge_u", ("br_if", 1),
        ("local.get", 0), ("local.get", i), "i32.shr_u", ("i32.const", 1),
        "i32.and",
        ("if", None),
        ("local.get", a), ("local.get", 0), "i32.add", ("local.get", i),
        "i32.xor", ("local.set", a),
        "else",
        ("local.get", c), ("i32.const", 7), "i32.mul", ("local.get", i),
        "i32.add", ("local.set", c),
        "end",
        ("local.get", i), ("i32.const", 1), "i32.add", ("local.set", i),
        ("br", 0), "end", "end",
        ("local.get", a), ("i32.const", 31), "i32.mul", ("local.get", c),
        "i32.add",
    ], export="f")
    return b.build()


# -- B2 instance cases and B7 ops inlined per sub -----------------------------

BLOCK_TERMS_WAT = """
(module
  (memory 1)
  (func $inc (param i32) (result i32) (local i64 i32 i32)
    (local.set 2 (i32.add (local.get 2) (local.get 0)))
    (return (i32.add (local.get 2) (i32.const 3))))
  (func $void (param i32)
    (drop (i32.mul (local.get 0) (i32.const 5))))
  (func (export "terms") (param i32) (result i32) (local i32 i32)
    (local.set 1
      (block (result i32) (br 0 (i32.add (local.get 0) (i32.const 7)))))
    (local.set 1 (i32.add (local.get 1)
      (block (result i32)
        (drop (br_if 0 (i32.mul (local.get 0) (i32.const 3))
                       (i32.and (local.get 0) (i32.const 1))))
        (i32.const 5))))
    (loop
      (local.set 2 (i32.add (local.get 2) (i32.const 1)))
      (local.set 1 (call $inc (i32.xor (local.get 1) (local.get 2))))
      (br_if 0 (i32.lt_u (local.get 2) (i32.and (local.get 0) (i32.const 7)))))
    (block (loop
      (br_if 1 (i32.ge_u (local.get 2) (i32.const 12)))
      (call $void (i32.add (local.get 1) (local.get 2)))
      (local.set 2 (i32.add (local.get 2) (i32.const 1)))
      (br 0)))
    (i32.add (local.get 1) (local.get 2)))
  (func (export "void_top") (param i32)
    (call $void (i32.add (local.get 0) (i32.const 1)))
    (drop (i32.add (local.get 0) (i32.const 2))))
  (func (export "entry") (param i32) (result i32)
    (call $inc (i32.add (local.get 0) (i32.const 1)))))
"""


def build_block_terminals() -> bytes:
    """Blocks that end in each terminal an instance case runs itself:
    `terms(x)` a br with a kept value, a br_if with a kept value (taken on
    odd x), a loop closed by a backward br_if and one by a br, direct calls
    to a callee with locals to zero that returns from depth 1, and the
    return at depth 0; `void_top(x)` returns no value at depth 0 after a
    call of a void function; `entry(x)`'s first block ends in its call (4
    instructions with it).  It declares a memory it does not use, so that
    it runs in both memory modes."""
    return parse_wat(BLOCK_TERMS_WAT)


CALL_TRAPS_WAT = """
(module
  (memory 1)
  (func $deep (export "deep") (param i32) (result i32) (local i64 i64 i64 i64)
    (if (result i32) (i32.eqz (local.get 0))
      (then (i32.const 1))
      (else (i32.add (call $deep (i32.sub (local.get 0) (i32.const 1)))
                     (local.get 0))))))
"""


def build_call_traps() -> bytes:
    """deep(n): a recursion n deep (frames of one parameter, four i64
    locals and the operands under the call), its call the terminal of a
    block; sum 1 + n (n + 1) / 2.  With few frames (call stack depth 16)
    it traps E_CALL_STACK from n = 15; with a short value stack (64 rows)
    and many frames, E_STACK_OVERFLOW.  Declares an unused memory, as
    build_block_terminals does."""
    return parse_wat(CALL_TRAPS_WAT)


def build_many_heads(n: int) -> bytes:
    """heads(x): n blocks of one shape, each x += k, a forward br_if out of
    it when x passes a bound, x = x * 3, then the next block (a branch
    target): n block heads of one shape, with literals that differ."""
    b = ModuleBuilder()
    body = []
    for k in range(n):
        body += [("block", None), ("local.get", 0),
                 ("i32.const", (k * 40503 + 11) & 0xFFFF), "i32.add",
                 ("local.tee", 0), ("i32.const", 1 << 30), "i32.gt_u",
                 ("br_if", 0), ("local.get", 0), ("i32.const", 3),
                 "i32.mul", ("local.set", 0), "end"]
    body += [("local.get", 0)]
    b.add_function(["i32"], ["i32"], [], body, export="heads")
    return b.build()


def build_vsub_blocks() -> bytes:
    """f(x, y): build_simd_sweep over every v2 op (of a and b) and every
    v1 op (of a): straight-line code that the planner cuts into full
    blocks, every v2 and v1 sub of the batch encoding inside one."""
    return build_simd_sweep(
        [[("local.get", 2), ("local.get", 5), op] for op in V2_NAMES]
        + [[("local.get", 2), op] for op in V1_NAMES])


def vsub_args(lanes: int, seed: int = 0):
    """(x, y) lane operands of build_vsub_blocks with which no f32x4 op
    of the module sees or makes a binary32 subnormal, which the reference
    on XLA:CPU flushes (ROADMAP C5).  build_simd_sweep derives the v128
    a from x (its second lane x times a multiplier) and b from y (y xor
    a constant); read as binary32, a's words get exponents in [100, 150]
    and b's in [28, 224], so a + b, a - b, a * b and a / b stay normal
    (or overflow)."""
    rng = np.random.default_rng(seed)

    def ok(v, lo, hi):
        e = (v.view(np.uint32).reshape(-1, 2) >> 23) & 0xFF
        return ((e >= lo) & (e <= hi)).all(axis=1)

    out = []
    for mix, lo, hi in ((lambda v: v * np.uint64(0x9E3779B97F4A7C15), 100,
                         150),
                        (lambda v: v ^ np.uint64(0xC2B2AE3D27D4EB4F), 28,
                         224)):
        got = np.zeros(0, np.uint64)
        while got.size < lanes:
            v = rng.integers(0, 2**64, 1 << 16, np.uint64, endpoint=False)
            got = np.concatenate([got, v[ok(v, lo, hi) & ok(mix(v), lo,
                                                             hi)]])
        out.append(got[:lanes].view(np.int64))
    return out
