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
window, and `build_win_rows` drives the per-row valid and dirty bits
(a store-only sweep, partial stores into rows not valid, loads after
stores, a commit with some rows dirty).  `build_uniform_probe` keeps
stack rows, frames, a global and memory live across launches (B3's
entry rule).  `build_linked_program` is a provider and a consumer linked
through a registered module: the consumer imports the provider's memory,
table and global, fills them with its element segment and start
function, and loops over loads and call_indirect (`linked_program_model`
is its numpy model).  The tests and `chip_smoke.py` use them with lane
inputs made from a seed.
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


_ALNUM = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
WIN_ROWS_DATA = "".join(_ALNUM[i * 7 % 62] for i in range(256))

WIN_ROWS_WAT = """
(module
  (memory 1 1)
  (data (i32.const 0) "DATA")
  ;; sweep(a, n): whole-word stores of i * 0x9E3779B1 ^ a at a + 4i for
  ;; i < n, nothing loaded (from a = 0, n = 160: rows 0..159, across the
  ;; first way's end at row 128)
  (func (export "sweep") (param $a i32) (param $n i32) (result i32)
    (local $i i32)
    (block (loop
      (br_if 1 (i32.ge_u (local.get $i) (local.get $n)))
      (i32.store (i32.add (local.get $a) (i32.shl (local.get $i) (i32.const 2)))
                 (i32.xor (i32.mul (local.get $i) (i32.const 0x9E3779B1))
                          (local.get $a)))
      (local.set $i (i32.add (local.get $i) (i32.const 1)))
      (br 0)))
    (local.get $n))
  ;; partial(a, x): a store8 at a, a store16 at a + 21 and an unaligned
  ;; v128 store at a + 42 (when a % 4 != 2) into rows nothing made valid,
  ;; then i64 loads over all three and one at a + 300
  (func (export "partial") (param $a i32) (param $x i32) (result i64)
    (i32.store8 (local.get $a) (local.get $x))
    (i32.store16 offset=21 (local.get $a) (local.get $x))
    (v128.store offset=42 (local.get $a)
                (i32x4.splat (i32.mul (local.get $x) (i32.const 0x01000193))))
    (i64.add (i64.load offset=40 (local.get $a))
      (i64.xor (i64.load (local.get $a))
        (i64.add (i64.load offset=20 (local.get $a))
                 (i64.add (i64.load offset=50 (local.get $a))
                          (i64.load offset=300 (local.get $a)))))))
  ;; store_load(a, x): whole-word stores at a, a + 4, a + 8 and a + 12
  ;; (a % 4 == 0: valid and dirty, no fill), a load of a + 4 (valid) and
  ;; one of a + 200 (not valid: the rest of the way is filled)
  (func (export "store_load") (param $a i32) (param $x i32) (result i32)
    (i32.store (local.get $a) (local.get $x))
    (i32.store offset=4 (local.get $a) (i32.add (local.get $x) (i32.const 1)))
    (i32.store offset=8 (local.get $a) (i32.add (local.get $x) (i32.const 2)))
    (i32.store offset=12 (local.get $a) (i32.add (local.get $x) (i32.const 3)))
    (i32.add (i32.load offset=4 (local.get $a))
             (i32.load offset=200 (local.get $a))))
  ;; commit_rows(a, x, spin): whole-word stores at a and a + 8 (two dirty
  ;; rows of a way no load filled), spin loop iterations without a memory
  ;; access (a warp that is on commits on the way with those rows dirty),
  ;; then a load of a + 64 (fills), a store at a + 8 and loads of a + 8
  ;; and a + 4
  (func (export "commit_rows") (param $a i32) (param $x i32) (param $spin i32)
                               (result i32)
    (local $i i32) (local $acc i32)
    (i32.store (local.get $a) (local.get $x))
    (i32.store offset=8 (local.get $a) (i32.mul (local.get $x) (i32.const 3)))
    (block (loop
      (br_if 1 (i32.ge_u (local.get $i) (local.get $spin)))
      (local.set $acc (i32.add (i32.rotl (local.get $acc) (i32.const 3))
                               (local.get $i)))
      (local.set $i (i32.add (local.get $i) (i32.const 1)))
      (br 0)))
    (local.set $acc (i32.add (local.get $acc)
                             (i32.load offset=64 (local.get $a))))
    (i32.store offset=8 (local.get $a) (local.get $acc))
    (i32.add (i32.load offset=8 (local.get $a))
             (i32.load offset=4 (local.get $a))))
)
""".replace("DATA", WIN_ROWS_DATA)


def build_win_rows() -> bytes:
    """B4's per-row valid and dirty bits: a store-only sweep across a way
    boundary (`sweep`), partial stores into rows that are not valid
    (`partial`), loads after whole-word stores (`store_load`) and a B3
    commit with some rows dirty (`commit_rows`), over a data segment of
    256 patterned bytes."""
    return parse_wat(WIN_ROWS_WAT)


UNIFORM_PROBE_WAT = """
(module
  (memory 1 2)
  (global $g (mut i32) (i32.const 7))
  (data (i32.const 0) "DATA")
  ;; rec(n, x): n levels of calls, each adding memory word n and the
  ;; global (which it bumps) into x; the innermost reads the last word of
  ;; the first page
  (func $rec (export "rec") (param $n i32) (param $x i32) (result i32)
    (if (result i32) (i32.eqz (local.get $n))
      (then (i32.add (local.get $x)
                     (i32.add (global.get $g) (i32.load (i32.const 65532)))))
      (else
        (global.set $g (i32.add (global.get $g) (local.get $n)))
        (i32.add
          (call $rec (i32.sub (local.get $n) (i32.const 1))
                     (i32.add (local.get $x)
                              (i32.load (i32.shl (local.get $n) (i32.const 2)))))
          (local.get $n)))))
)
""".replace("DATA", WIN_ROWS_DATA)


def build_uniform_probe() -> bytes:
    """B3's entry rule: `rec(n, x)` keeps stack rows, frames, a global and
    memory words (the first page's last one included) live across launch
    boundaries, so a lane that differs from its warp's lane 0 in any of
    them reads the difference; a second page, never grown into, lies
    beyond the live memory."""
    return parse_wat(UNIFORM_PROBE_WAT)


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


# -- tier-0 host calls -----------------------------------------------------------

TIER0_ZOO_WAT = """
(module
  (import "wasi_snapshot_preview1" "clock_time_get"
    (func $clock (param i32 i64 i32) (result i32)))
  (import "wasi_snapshot_preview1" "random_get"
    (func $random (param i32 i32) (result i32)))
  (import "wasi_snapshot_preview1" "sched_yield" (func $yield (result i32)))
  (import "wasi_snapshot_preview1" "proc_exit" (func $exit (param i32)))
  (import "wasi_snapshot_preview1" "fd_write"
    (func $write (param i32 i32 i32 i32) (result i32)))
  (memory 1 1)
  (data (i32.const 320) "ab\\n")
  ;; clock(id, ptr): two reads of clock id at ptr and ptr + 8; both errnos
  (func (export "clock") (param $id i32) (param $p i32) (result i32)
    (i32.add
      (i32.mul (call $clock (local.get $id) (i64.const 1000) (local.get $p))
               (i32.const 100))
      (call $clock (local.get $id) (i64.const 0)
                   (i32.add (local.get $p) (i32.const 8)))))
  ;; random(ptr, len): len bytes at ptr, then at ptr + 100; both errnos
  (func (export "random") (param $p i32) (param $n i32) (result i32)
    (i32.add
      (i32.mul (call $random (local.get $p) (local.get $n)) (i32.const 100))
      (call $random (i32.add (local.get $p) (i32.const 100)) (local.get $n))))
  ;; yield(n): n sched_yield calls; n plus their errnos
  (func (export "yield") (param $n i32) (result i32) (local $i i32) (local $s i32)
    (block $out (loop $top
      (br_if $out (i32.ge_u (local.get $i) (local.get $n)))
      (local.set $s (i32.add (local.get $s) (call $yield)))
      (local.set $i (i32.add (local.get $i) (i32.const 1)))
      (br $top)))
    (i32.add (local.get $s) (local.get $n)))
  ;; exit(x): proc_exit(x) on lanes with x % 3 == 0, else 2 x
  (func (export "exit") (param $x i32) (result i32)
    (if (i32.eqz (i32.rem_u (local.get $x) (i32.const 3)))
      (then (call $exit (local.get $x))))
    (i32.mul (local.get $x) (i32.const 2)))
  ;; digit(x, n, fd): "lane " (the digit x % 10) "\\n" from the unaligned
  ;; address 301, n times to fd; the last errno
  (func (export "digit") (param $x i32) (param $n i32) (param $fd i32)
        (result i32) (local $i i32) (local $e i32)
    (i32.store (i32.const 64) (i32.const 301))
    (i32.store (i32.const 68) (i32.const 7))
    (i32.store8 (i32.const 301) (i32.const 108))
    (i32.store8 (i32.const 302) (i32.const 97))
    (i32.store8 (i32.const 303) (i32.const 110))
    (i32.store8 (i32.const 304) (i32.const 101))
    (i32.store8 (i32.const 305) (i32.const 32))
    (i32.store8 (i32.const 306)
      (i32.add (i32.const 48) (i32.rem_u (local.get $x) (i32.const 10))))
    (i32.store8 (i32.const 307) (i32.const 10))
    (block $out (loop $top
      (br_if $out (i32.ge_u (local.get $i) (local.get $n)))
      (local.set $e (call $write (local.get $fd) (i32.const 64) (i32.const 1)
                                 (i32.const 32)))
      (local.set $i (i32.add (local.get $i) (i32.const 1)))
      (br $top)))
    (i32.add (i32.mul (local.get $e) (i32.const 1000)) (i32.load (i32.const 32))))
  ;; shapes(mode) of fd_write that park or fault, after one that does not:
  ;; 0 two iovecs, 1 an unaligned iovec array, 2 a payload out of bounds
  ;; (EFAULT in place), 3 nwritten out of bounds, 4 the iovec array out of
  ;; bounds, 5 a payload above tier0_write_max
  (func (export "shapes") (param $m i32) (result i32) (local $e i32)
    (i32.store (i32.const 64) (i32.const 320))
    (i32.store (i32.const 68) (i32.const 3))
    (i32.store (i32.const 72) (i32.const 320))
    (i32.store (i32.const 76) (i32.const 2))
    (i32.store (i32.const 81) (i32.const 320))
    (i32.store (i32.const 85) (i32.const 3))
    (i32.store (i32.const 88) (i32.const 65530))
    (i32.store (i32.const 92) (i32.const 16))
    (i32.store (i32.const 96) (i32.const 320))
    (i32.store (i32.const 100) (i32.const 300))
    (local.set $e (call $write (i32.const 1) (i32.const 64) (i32.const 1)
                               (i32.const 32)))
    (local.set $e (i32.add (i32.mul (local.get $e) (i32.const 100))
      (if (result i32) (i32.eqz (local.get $m))
        (then (call $write (i32.const 1) (i32.const 64) (i32.const 2)
                           (i32.const 32)))
        (else (if (result i32) (i32.eq (local.get $m) (i32.const 1))
          (then (call $write (i32.const 1) (i32.const 81) (i32.const 1)
                             (i32.const 32)))
          (else (if (result i32) (i32.eq (local.get $m) (i32.const 2))
            (then (call $write (i32.const 1) (i32.const 88) (i32.const 1)
                               (i32.const 32)))
            (else (if (result i32) (i32.eq (local.get $m) (i32.const 3))
              (then (call $write (i32.const 1) (i32.const 64) (i32.const 1)
                                 (i32.const 65534)))
              (else (if (result i32) (i32.eq (local.get $m) (i32.const 4))
                (then (call $write (i32.const 1) (i32.const 65532)
                                   (i32.const 1) (i32.const 32)))
                (else (call $write (i32.const 1) (i32.const 96)
                                   (i32.const 1) (i32.const 32))))))))))))))
    (i32.add (i32.mul (local.get $e) (i32.const 1000)) (i32.load (i32.const 32))))
  ;; uniform(p): a clock read and an fd_write served in place, then
  ;; random_get(p, 16) and a fold of its bytes (every lane of a warp with
  ;; one argument draws its own bytes)
  (func (export "uniform") (param $p i32) (result i32)
    (drop (call $clock (i32.const 1) (i64.const 0) (i32.const 512)))
    (i32.store (i32.const 64) (i32.const 320))
    (i32.store (i32.const 68) (i32.const 3))
    (drop (call $write (i32.const 1) (i32.const 64) (i32.const 1)
                       (i32.const 32)))
    (drop (call $random (local.get $p) (i32.const 16)))
    (i32.xor (i32.xor (i32.load (local.get $p))
                      (i32.load (i32.add (local.get $p) (i32.const 4))))
             (i32.xor (i32.load (i32.add (local.get $p) (i32.const 8)))
                      (i32.load (i32.add (local.get $p) (i32.const 12))))))
)
"""

TIER0_UNSAFE_WAT = """
(module
  (import "wasi_snapshot_preview1" "clock_time_get"
    (func $clock (param i32 i64 i32) (result i32)))
  (import "wasi_snapshot_preview1" "fd_write"
    (func $write (param i32 i32 i32 i32) (result i32)))
  (import "wasi_snapshot_preview1" "fd_close" (func $close (param i32) (result i32)))
  (memory 1 1)
  (data (i32.const 320) "safe?\\n")
  ;; f(x): a clock read (served in place) and an fd_write that parks:
  ;; fd_close makes the fd table something a guest can change
  (func (export "f") (param $x i32) (result i32)
    (i32.store (i32.const 64) (i32.const 320))
    (i32.store (i32.const 68) (i32.const 6))
    (i32.add (call $clock (i32.const 0) (i64.const 0) (i32.const 8))
             (call $write (i32.const 1) (i32.const 64) (i32.const 1)
                          (i32.const 32))))
)
"""


def build_tier0_zoo() -> bytes:
    """Every tier-0 WASI call in one module, an export each:
    `clock(id, ptr)` (ids 0 and 1 served, 2 and 3 park, others EINVAL;
    EFAULT past the end), `random(ptr, len)` (lengths up to
    tier0_random_max served at any byte offset, longer ones park),
    `yield(n)`, `exit(x)` (proc_exit where x % 3 == 0), `digit(x, n, fd)`
    (a lane-dependent digit from an unaligned source, n times to fd: 1
    and 2 served, others park), `shapes(mode)` (two iovecs, an unaligned
    iovec array, faults and an oversized payload, after one served
    write) and `uniform(p)` (a clock read and a write served in place,
    then random_get, whose bytes differ by lane)."""
    return parse_wat(TIER0_ZOO_WAT)


def build_tier0_unsafe() -> bytes:
    """`f(x)`: a clock read served in place and an fd_write that parks,
    because the module also imports fd_close (`t0_fdwrite_safe` False)."""
    return parse_wat(TIER0_UNSAFE_WAT)


def tier0_cases(lanes: int, seed: int) -> dict:
    """(export, per-lane args) of build_tier0_zoo's cases at `lanes`
    lanes, from a seed: lane-dependent arguments over every outcome."""
    rng = np.random.default_rng(seed)
    lane = np.arange(lanes)

    def pick(vals):
        return np.asarray(vals, np.int64)[rng.integers(0, len(vals), lanes)]

    return {
        "clock": ("clock", [pick([0, 1, 0, 1, 2, 3, 7, -1]),
                            pick([8, 13, 1000, 65528 - 8, 65524, 65530,
                                  -4])]),
        "random": ("random", [pick([400, 401, 402, 403, 1000, 65500,
                                    -8]),
                              pick([0, 1, 63, 64, 65, 5, 16, 33])]),
        "yield": ("yield", [lane % 4]),
        "exit": ("exit", [lane + 1]),
        "digit": ("digit", [lane, 1 + lane % 3, pick([1, 1, 1, 2])]),
        "digit_fd3": ("digit", [lane, np.full(lanes, 2), pick([1, 2, 3])]),
        "shapes": ("shapes", [lane % 6]),
        "uniform": ("uniform", [np.full(lanes, 700)]),
    }


# -- tables, segments, tail calls and weighted gas ----------------------------

TABLE_ZOO_WAT = r"""(module
  (type $v (func (result i32)))
  (type $ii (func (param i32) (result i32)))
  (type $acc (func (param i32 i32) (result i32)))
  (table 4 10 funcref)
  (memory 1)
  (func $f0 (type $v) (i32.const 100))
  (func $f1 (type $v) (i32.const 101))
  (func $f2 (type $v) (i32.const 102))
  (func $g (type $ii) (i32.add (local.get 0) (i32.const 7)))
  (elem $e0 func $f0 $f1 $f2 $f0)
  (elem $e1 func $f2 $g $f1)
  (elem (i32.const 0) $f0 $f1)
  (data $d0 "\01\02\03\04\05\06\07\08\09\0a\0b\0c\0d\0e\0f\10\11\12\13")
  (data $d1 "hello, tables")
  (func $sum (result i32)
    (local $j i32) (local $acc i32)
    (block $out
      (loop $top
        (br_if $out (i32.ge_u (local.get $j) (table.size)))
        (local.set $acc (i32.add (i32.mul (local.get $acc) (i32.const 7))
          (if (result i32) (ref.is_null (table.get (local.get $j)))
            (then (i32.const 1))
            (else (call_indirect (type $v) (local.get $j))))))
        (local.set $j (i32.add (local.get $j) (i32.const 1)))
        (br $top)))
    (i32.add (i32.mul (local.get $acc) (i32.const 16)) (table.size)))
  (func (export "get") (param $i i32) (result i32)
    (if (result i32) (ref.is_null (table.get (local.get $i)))
      (then (i32.const -1))
      (else (call_indirect (type $v) (local.get $i)))))
  (func (export "calli") (param $i i32) (result i32)
    (call_indirect (type $v) (local.get $i)))
  (func (export "set") (param $i i32) (param $k i32) (result i32)
    (if (i32.eqz (local.get $k))
      (then (table.set (local.get $i) (ref.func $f2)))
      (else (if (i32.eq (local.get $k) (i32.const 1))
        (then (table.set (local.get $i) (ref.null func)))
        (else (table.set (i32.and (local.get $i) (i32.const 3))
                         (ref.func $g))))))
    (call_indirect (type $v) (local.get $i)))
  (func (export "grow") (param $d i32) (param $k i32) (result i32)
    (local $r i32)
    (local.set $r (if (result i32) (local.get $k)
      (then (table.grow (ref.null func) (local.get $d)))
      (else (table.grow (ref.func $f1) (local.get $d)))))
    (i32.add (i32.mul (local.get $r) (i32.const 100000)) (call $sum)))
  (func (export "fill") (param $i i32) (param $n i32) (param $k i32)
        (result i32)
    (drop (table.grow (ref.null func) (i32.const 2)))
    (table.fill (local.get $i) (ref.func $f2) (local.get $n))
    (i32.add (call $sum)
      (i32.mul (i32.const 1000000)
        (call_indirect (type $v) (local.get $k)))))
  (func (export "copy") (param $d i32) (param $s i32) (param $n i32)
        (result i32)
    (drop (table.grow (ref.null func) (i32.const 4)))
    (table.init $e0 (i32.const 2) (i32.const 0) (i32.const 4))
    (table.copy (local.get $d) (local.get $s) (local.get $n))
    (call $sum))
  (func (export "init") (param $mode i32) (param $s i32) (param $n i32)
        (result i32)
    (if (i32.and (local.get $mode) (i32.const 1))
      (then (elem.drop $e0)))
    (if (i32.and (local.get $mode) (i32.const 2))
      (then (elem.drop $e0) (elem.drop $e1)))
    (table.init $e0 (i32.const 0) (local.get $s) (local.get $n))
    (table.init $e1 (i32.const 1) (i32.const 0) (i32.const 0))
    (call $sum))
  (func (export "meminit") (param $dst i32) (param $s i32) (param $n i32)
        (param $drop i32) (result i32)
    (if (local.get $drop) (then (data.drop $d0)))
    (memory.init $d0 (local.get $dst) (local.get $s) (local.get $n))
    (data.drop $d1)
    (memory.init $d1 (i32.const 64) (i32.const 0) (i32.const 0))
    (i32.xor (i32.load (i32.and (local.get $dst) (i32.const 0xfff8)))
      (i32.rotl (i32.load offset=4 (i32.and (local.get $dst)
                                            (i32.const 0xfff8)))
                (i32.const 9))))
  (func $count (param $n i32) (param $acc i32) (result i32)
    (if (result i32) (i32.eqz (local.get $n))
      (then (local.get $acc))
      (else (return_call $count (i32.sub (local.get $n) (i32.const 1))
                        (i32.add (local.get $acc) (local.get $n))))))
  (func $wide (param $n i32) (param $acc i32) (result i32)
    (local i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64)
    (local i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64)
    (local i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64)
    (local i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64)
    (i32.add (local.get $n) (local.get $acc)))
  (func (export "tail") (param $n i32) (param $w i32) (result i32)
    (if (result i32) (local.get $w)
      (then (return_call $wide (local.get $n) (i32.const 1)))
      (else (return_call $count (local.get $n) (i32.const 0)))))
  (func $step (type $acc)
    (if (result i32) (i32.eqz (local.get 0))
      (then (local.get 1))
      (else (return_call_indirect (type $acc)
        (i32.sub (local.get 0) (i32.const 1))
        (i32.add (i32.mul (local.get 1) (i32.const 3)) (local.get 0))
        (i32.and (local.get 0) (i32.const 1))))))
  (func $step2 (type $acc)
    (return_call $step (local.get 0) (i32.xor (local.get 1) (i32.const 0x55))))
  (elem $e2 func $step $step2)
  (func (export "tail_ind") (param $i i32) (param $n i32) (result i32)
    (table.set (i32.const 0) (ref.func $step))
    (table.set (i32.const 1) (ref.func $step2))
    (table.set (i32.const 3) (ref.func $f0))
    (return_call_indirect (type $acc) (local.get $n) (i32.const 1)
                          (local.get $i)))
  (func (export "agree") (param $k i32) (param $n i32) (result i32)
    (local $j i32) (local $acc i32)
    (table.set (i32.const 1)
      (if (result funcref) (i32.and (local.get $k) (i32.const 1))
        (then (ref.func $f2)) (else (ref.func $f0))))
    (loop $spin
      (local.set $j (i32.add (local.get $j) (i32.const 1)))
      (br_if $spin (i32.lt_u (local.get $j) (i32.const 40))))
    (loop $calls
      (local.set $acc (i32.add (local.get $acc)
                               (call_indirect (type $v) (i32.const 1))))
      (local.set $n (i32.sub (local.get $n) (i32.const 1)))
      (br_if $calls (local.get $n)))
    (local.get $acc))
  (func (export "refs") (param $x i32) (result i32)
    (i32.add
      (i32.mul (ref.is_null (ref.func $f1)) (i32.const 10))
      (i32.add (table.size)
        (call_indirect (type $v)
          (i32.and (local.get $x) (i32.const 1))))))
  (func $big (type $ii)
    (local i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64)
    (local i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64)
    (local i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64)
    (local i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64 i64)
    (local.get 0))
  (func $rec (type $ii)
    (if (result i32) (i32.eqz (local.get 0))
      (then (i32.const 7))
      (else (i32.add (call_indirect (type $ii)
                       (i32.sub (local.get 0) (i32.const 1)) (i32.const 4))
                     (i32.const 1)))))
  (elem $e3 func $big $rec)
  (func $slots
    (drop (table.grow (ref.null func) (i32.const 4)))
    (table.set (i32.const 1) (ref.null func))
    (table.set (i32.const 2) (ref.func $g))
    (table.set (i32.const 3) (ref.func $big))
    (table.set (i32.const 4) (ref.func $rec)))
  (func (export "ci") (param $i i32) (param $x i32) (result i32)
    (call $slots)
    (call_indirect (type $ii) (i32.add (local.get $x) (i32.const 3))
      (i32.and (local.get $i) (i32.const 255))))
  (func (export "rci") (param $i i32) (param $x i32) (result i32)
    (call $slots)
    (return_call_indirect (type $ii) (i32.add (local.get $x) (i32.const 5))
      (i32.and (local.get $i) (i32.const 255))))
  (func (export "remz") (param $x i32) (result i32)
    (i32.rem_u (i32.add (local.get $x) (i32.const 1)) (i32.const 0)))
  (func (export "divm") (param $x i32) (result i32)
    (i32.div_s (i32.sub (local.get $x) (i32.const 1)) (i32.const -1)))
  (func (export "remz64") (param $x i32) (result i32)
    (i32.wrap_i64 (i64.rem_u (i64.extend_i32_s (local.get $x))
                             (i64.const 0))))
  (func (export "divm64") (param $x i32) (result i32)
    (i32.wrap_i64 (i64.shr_u
      (i64.div_s (i64.shl (i64.extend_i32_s (local.get $x)) (i64.const 32))
                 (i64.const -1))
      (i64.const 32))))
  (func (export "divw64") (param $x i32) (result i32)
    (i32.add
      (i32.wrap_i64 (i64.div_s
        (i64.shl (i64.extend_i32_s (local.get $x)) (i64.const 33))
        (i64.const 0x100000000)))
      (i32.wrap_i64 (i64.rem_u (i64.extend_i32_u (local.get $x))
                               (i64.const 0xffffffff)))))
  (func (export "chain") (param $x i32) (result i32)
    (call $slots)
    (call_indirect (type $ii) (local.get $x)
      (i32.rem_u (local.get $x) (i32.const 9))))
  (func (export "tchain") (param $x i32) (result i32)
    (call $slots)
    (return_call_indirect (type $ii) (local.get $x)
      (i32.rem_u (local.get $x) (i32.const 9))))
  (func (export "dchain") (param $x i32) (param $y i32) (result i32)
    (call $g (i32.div_u (local.get $x) (local.get $y))))
  (func (export "rchain") (param $x i32) (param $y i32) (result i32)
    (return_call $g (i32.rem_s (local.get $x) (local.get $y))))
)"""


def build_table_zoo() -> bytes:
    """Every table, segment, tail-call and ref.func class in one module, an
    export each (table 4 of declared max 10, two passive element segments
    and two passive data segments; run it with `table_elems_per_lane` 8 so
    that a grow can pass the capacity under the declared max):
    `get(i)` / `calli(i)` (table.get and call_indirect, TableOutOfBounds,
    UndefinedElement, UninitializedElement), `set(i, k)` (a set to a
    function, to null or to one of another type: IndirectCallTypeMismatch),
    `grow(d, k)` (up to, past and below the capacity, with a ref or null),
    `fill(i, n, k)`, `copy(d, s, n)` (both overlaps), `init(mode, s, n)`
    (segments used after elem.drop), `meminit(dst, s, n, drop)` (memory.init
    at any byte offset, after data.drop, out of bounds both ways),
    `tail(n, w)` (return_call deeper than the call stack, or into a function
    whose frame does not fit: StackOverflow), `tail_ind(i, n)`
    (return_call_indirect through the lane's table: every call_indirect
    trap), `agree(k, n)` (lanes of one warp calling one index of tables that
    differ, after a launch boundary: B3's handle agreement) and `refs(x)`
    (ref.func, table.size).  Each result folds the table (`$sum`) or the
    memory it touched.  `table_terminal_cases` runs its exports whose
    blocks end in a call_indirect, a return_call(_indirect) or a div or
    rem chained to the lone call after it (B2 instance cases run them in
    the case): after `$slots` grows the table to 8 (0 `$f0`, of another
    type; 2 `$g`; 3 `$big`, whose frame does not fit a 64-row stack; 4
    `$rec`, n nested call_indirects; 1 and 5-7 null; 8 and up out of
    range), `ci(i, x)` / `rci(i, x)` (call_indirect /
    return_call_indirect of slot i), `chain(x)` / `tchain(x)` (the same
    through slot x % 9 after a rem_u by 9), `remz(x)` (rem_u by a
    literal 0), `divm(x)` (div_s of x - 1 by a literal -1), their i64
    forms `remz64(x)` (rem_u by 0) and `divm64(x)` (div_s of x << 32 by
    -1: INT64_MIN at x = INT32_MIN), `divw64(x)` (i64 divisors
    0x1_0000_0000 and 0xffff_ffff, whose low or high word alone would
    read as 0 or -1: no trap), `dchain(x, y)` (a direct call after a div_u by y) and `rchain(x, y)`
    (a return_call after a rem_s by y)."""
    return parse_wat(TABLE_ZOO_WAT)


# table_elems_per_lane for the zoo: below its declared maximum of 10
TABLE_ZOO_CAP = 8


def table_cases(lanes: int, seed: int) -> dict:
    """(export, per-lane args) of build_table_zoo's cases at `lanes`
    lanes, from a seed: lane-dependent arguments over every outcome."""
    rng = np.random.default_rng(seed)
    lane = np.arange(lanes)

    def pick(vals):
        return np.asarray(vals, np.int64)[rng.integers(0, len(vals), lanes)]

    return {
        "get": ("get", [pick([0, 1, 2, 3, 4, 9, -1])]),
        "calli": ("calli", [pick([0, 1, 2, 3, 4, -5])]),
        "set": ("set", [pick([0, 1, 2, 3, 4, 7]), pick([0, 1, 2])]),
        "grow": ("grow", [pick([0, 1, 2, 4, 5, 6, -1, 1 << 30]),
                          lane % 2]),
        "fill": ("fill", [pick([0, 1, 3, 5, 6]), pick([0, 1, 2, 3, 7]),
                          pick([0, 2, 5])]),
        "copy": ("copy", [pick([0, 1, 3, 4, 6, 7]), pick([0, 2, 3, 5, 6]),
                          pick([0, 1, 2, 3, 4, 5])]),
        "init": ("init", [lane % 4, pick([0, 1, 2, 3, 4]),
                          pick([0, 1, 2, 3])]),
        "meminit": ("meminit", [pick([0, 1, 3, 6, 9, 65530, 65533, -2]),
                                pick([0, 1, 5, 15, 19, 20]),
                                pick([0, 1, 3, 4, 7]), lane % 3 == 0]),
        "tail": ("tail", [pick([0, 1, 7, 40, 90]), pick([0, 0, 0, 1])]),
        "tail_ind": ("tail_ind", [pick([0, 1, 2, 3, 4, 9]),
                                  pick([0, 1, 2, 5, 20])]),
        "agree": ("agree", [lane // 3, pick([1, 5, 30])]),
        "refs": ("refs", [lane]),
    }


def table_terminal_cases(lanes: int, seed: int) -> dict:
    """(export, per-lane args) of the table zoo's terminal cases (see
    build_table_zoo) at `lanes` lanes, from a seed: every trap of the
    call terminals (UndefinedElement, UninitializedElement,
    IndirectCallTypeMismatch, CallStackExhausted past a 16-frame call
    stack, StackOverflow; a tail call all but CallStackExhausted), a
    literal-zero rem_u, div_s of INT_MIN by -1 (i32 and i64 both), i64
    literal divisors that do not trap, and divisors of 0 before a chained
    call."""
    rng = np.random.default_rng(seed)

    def pick(vals):
        return np.asarray(vals, np.int64)[rng.integers(0, len(vals), lanes)]

    x = rng.integers(-2**31, 2**31, lanes).astype(np.int64)
    slots = [0, 1, 2, 3, 4, 5, 7, 8, 9, -1]
    return {
        "ci": ("ci", [pick(slots), x]),
        "rci": ("rci", [pick(slots), x]),
        "remz": ("remz", [x]),
        "divm": ("divm", [pick([-2**31 + 1, 0, 5, -7, 2**31 - 1])]),
        "remz64": ("remz64", [x]),
        "divm64": ("divm64", [pick([-2**31, 0, 5, -7, 2**31 - 1])]),
        "divw64": ("divw64", [x]),
        "chain": ("chain", [np.arange(lanes, dtype=np.int64) % 36]),
        "tchain": ("tchain", [np.arange(lanes, dtype=np.int64)[::-1] % 36]),
        "dchain": ("dchain", [x, pick([0, 2, 7])]),
        "rchain": ("rchain", [x, pick([0, 3, -1])]),
    }


# The threaded-code interpreter: handler k mixes the state as
# st' = (st + k * C[k]) * A[k] + (byte + 1) * B[k] (mod 2**32), then
# tail-calls table[byte % 9].  A odd, so each step is a bijection.
TAIL_A = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1,
          0xD3A2646D, 0xFD7046C5, 0xB55A4F09)
TAIL_B = (0x7FEB352D, 0x846CA68B, 0x68E31DA4, 0xB5297A4D, 0x1B56C4E9,
          0x2C1B3C6D, 0x297A2D39, 0x0C3E1F27)
TAIL_C = (0x01000193, 0x5BD1E995, 0xCC9E2D51, 0x1B873593, 0xE6546B64,
          0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
TAIL_SEED = 20261018  # the program bytes' seed
TAIL_CONVERGED_SEED = 0x2545F491  # every lane's seed in "converged" mode
# steps of the full-width run: about 3e7 instructions a lane, as fib(30)'s
# 2.8e7 (about 42.7 a step: 8 + 28 + k + 3 for handler k and 31 for run
# itself; chip_smoke.py checks the count)
TAIL_DISPATCH_N = 700_000


def tail_program() -> bytes:
    """The 256 opcode bytes of build_tail_dispatch's data segment."""
    return bytes(np.random.default_rng(TAIL_SEED).integers(
        0, 256, 256, dtype=np.uint8))


def _i32_lit(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def build_tail_dispatch() -> bytes:
    """A threaded-code interpreter, the shape Wasm builds of interpreters
    (Lua, Python, wasm3-style tail-call dispatch) take: a funcref table
    (min 8, declared max 64), a passive element segment of the 8 handler
    functions and a passive 256-byte data segment holding an opcode
    program (`tail_program`).  `run(seed, n)`: memory.init of the program
    into page 0, data.drop, table.init of slots 0..7, elem.drop,
    table.set of slot seed & 7 to handler 5's ref.func, table.grow by one
    slot holding handler 2, then `n` steps of return_call_indirect: the
    handler at step t (pc = t) mixes the state with the program byte at
    pc & 255 and its own constants (`TAIL_A` / `TAIL_B` / `TAIL_C`, and
    k extra additions in handler k) and tail-calls table[byte % 9] with
    n - 1; the first handler is table[seed % 9] and the state starts at
    the seed.  Returns the state.  Needs the tail-call proposal."""
    data = "".join(f"\\{b:02x}" for b in tail_program())
    handlers = []
    for k in range(8):
        extra = "\n".join(
            f"    (local.set 0 (i32.add (local.get 0) "
            f"(i32.const {_i32_lit(TAIL_C[k])})))" for _ in range(k))
        handlers.append(f"""  (func $h{k} (type $h) (local $b i32)
    (if (i32.eqz (local.get 1)) (then (return (local.get 0))))
    (local.set $b (i32.load8_u (i32.and (local.get 2) (i32.const 255))))
{extra}
    (return_call_indirect (type $h)
      (i32.add (i32.mul (local.get 0) (i32.const {_i32_lit(TAIL_A[k])}))
               (i32.mul (i32.add (local.get $b) (i32.const 1))
                        (i32.const {_i32_lit(TAIL_B[k])})))
      (i32.sub (local.get 1) (i32.const 1))
      (i32.add (local.get 2) (i32.const 1))
      (i32.rem_u (local.get $b) (i32.const 9))))""")
    wat = f"""(module
  (type $h (func (param i32 i32 i32) (result i32)))
  (table 8 64 funcref)
  (memory 1)
  (data $prog "{data}")
{chr(10).join(handlers)}
  (elem $hs func $h0 $h1 $h2 $h3 $h4 $h5 $h6 $h7)
  (func (export "run") (param $seed i32) (param $n i32) (result i32)
    (memory.init $prog (i32.const 0) (i32.const 0) (i32.const 256))
    (data.drop $prog)
    (table.init $hs (i32.const 0) (i32.const 0) (i32.const 8))
    (elem.drop $hs)
    (table.set (i32.and (local.get $seed) (i32.const 7)) (ref.func $h5))
    (drop (table.grow (ref.func $h2) (i32.const 1)))
    (return_call_indirect (type $h)
      (local.get $seed) (local.get $n) (i32.const 0)
      (i32.rem_u (local.get $seed) (i32.const 9)))))"""
    return parse_wat(wat)


def tail_dispatch_args(lanes: int, mode: str, n: int = TAIL_DISPATCH_N):
    """`run`'s (seed, n) at `lanes` lanes: "converged" gives every lane
    one seed (every warp should enter uniform), "divergent" seed = lane
    (lanes follow different handler chains; no warp is uniform)."""
    if mode == "converged":
        seed = np.full(lanes, TAIL_CONVERGED_SEED, np.int64)
    elif mode == "divergent":
        seed = np.arange(lanes, dtype=np.int64)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return [seed, np.full(lanes, n, np.int64)]


def tail_dispatch_model(seeds, n: int, steps: bool = False) -> np.ndarray:
    """What `run(seed, n)` returns for each seed (uint32 as int64), from a
    plain model of the machine: each lane's table (slot seed & 7 holds
    handler 5, slot 8 handler 2), the program bytes and each handler's
    mix.  Step t runs handler table[seed % 9] (t = 0) or table[prog[(t -
    1) & 255] % 9] and maps st to (st + k C[k]) A[k] + (prog[t & 255] +
    1) B[k]; every step is affine and the steps from t = 1 on repeat
    every 256, so the n steps compose into one map by squaring (with
    `steps`, step by step instead: the direct model, for small n)."""
    M = 1 << 32
    prog = tail_program()
    seeds = np.asarray(seeds, np.int64) & 0xFFFFFFFF
    out = np.zeros(seeds.shape, np.int64)

    def affine(k, t):
        byte = prog[t & 255]
        a = TAIL_A[k]
        return a, ((k * TAIL_C[k] * a) + (byte + 1) * TAIL_B[k]) % M

    def then(f, g):  # g after f
        return (g[0] * f[0]) % M, (g[0] * f[1] + g[1]) % M

    for v in range(8):
        table = list(range(8)) + [2]
        table[v] = 5
        for s9 in range(9):
            grp = ((seeds & 7) == v) & ((seeds % 9) == s9)
            if not grp.any():
                continue
            total = (1, 0)
            if n > 0:
                total = affine(table[s9], 0)
                if steps:
                    for t in range(1, n):
                        total = then(total, affine(
                            table[prog[(t - 1) & 255] % 9], t))
                else:
                    per = [affine(table[prog[(t - 1) & 255] % 9], t)
                           for t in range(1, 257)]
                    period = (1, 0)
                    for f in per:
                        period = then(period, f)
                    q, r = divmod(n - 1, 256)
                    power, base = (1, 0), period
                    while q:
                        if q & 1:
                            power = then(power, base)
                        base = then(base, base)
                        q >>= 1
                    total = then(total, power)
                    for f in per[:r]:
                        total = then(total, f)
            out[grp] = (seeds[grp] * total[0] + total[1]) % M
    return out


def tail_cost_table() -> tuple:
    """The weighted-gas table of the tail-dispatch checks, by opcode id:
    call_indirect and return_call_indirect 5, the table instructions
    (table.get / set / size / grow / fill / copy / init, elem.drop) 3,
    every other opcode 1."""
    from wasmedge_tpu_torch.common.opcodes import NAME_TO_ID

    ct = [1] * (max(NAME_TO_ID.values()) + 1)
    for name in ("call_indirect", "return_call_indirect"):
        ct[NAME_TO_ID[name]] = 5
    for name in ("table.get", "table.set", "table.size", "table.grow",
                 "table.fill", "table.copy", "table.init", "elem.drop"):
        ct[NAME_TO_ID[name]] = 3
    return tuple(ct)


# --- the linked program: a consumer that imports a provider's memory,
# table and global, fills them at instantiation, and loops over them ---
LINKED_SEED = 0x13579BDF  # the provider's immutable global `seed`
LINKED_LCG = (1664525, 1013904223)  # the start function's word generator
LINKED_WORDS = 1024  # words the start function writes
# the four table functions: f_j(h, w) = OP_j(h * LINKED_MUL[j], w), OP_j
# add, sub, xor, or (one type, a different ALU op each, the same
# instruction count each)
LINKED_MUL = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
# the full-width run's trip counts: n = LINKED_N0 + (lane % 8) LINKED_N1,
# 8 + 35 n instructions a lane (about 8e6 on average); the numpy model
# over 4096 lanes takes about 20 us an iteration, 6 s in all
LINKED_N0 = 160_000
LINKED_N1 = 20_000


def build_linked_program():
    """(provider bytes, consumer bytes) of a program linked through a
    registered module, as WasmEdge's `register` pattern and Emscripten's
    imported memory link one.  The provider (registered as "prov")
    exports a memory of 1 page (max 1), a funcref table of 4 entries and
    an immutable i32 global `seed`.  The consumer imports all three; its
    active element segment puts its four functions f0..f3 (one type,
    f_j(h, w) = OP_j(h * LINKED_MUL[j], w) with OP add, sub, xor, or) into
    the imported table; its start function writes LINKED_WORDS words of
    an LCG from `seed` into the imported memory (word i the (i + 1)th
    value) and sets its mutable global $h0 to the last.  `run(n, k)`
    starts h at $h0 and loops n times: load word (i + k) & 1023, add it
    to h, h = table[h & 3](h, w); it returns h, and the instructions a
    lane retires depend on n alone."""
    a, c = LINKED_LCG
    prov = parse_wat(f"""(module
  (memory (export "mem") 1 1)
  (table (export "tab") 4 funcref)
  (global (export "seed") i32 (i32.const {_i32_lit(LINKED_SEED)})))""")
    ops = ("i32.add", "i32.sub", "i32.xor", "i32.or")
    funcs = "\n".join(
        f"""  (func $f{j} (type $op)
    ({op} (i32.mul (local.get 0) (i32.const {_i32_lit(LINKED_MUL[j])}))
          (local.get 1)))""" for j, op in enumerate(ops))
    consumer = parse_wat(f"""(module
  (type $op (func (param i32 i32) (result i32)))
  (import "prov" "mem" (memory 1 1))
  (import "prov" "tab" (table 4 funcref))
  (import "prov" "seed" (global $seed i32))
  (global $h0 (mut i32) (i32.const 0))
{funcs}
  (elem (i32.const 0) $f0 $f1 $f2 $f3)
  (func $init (local $i i32) (local $x i32)
    (local.set $x (global.get $seed))
    (block $done
      (loop $top
        (br_if $done (i32.ge_u (local.get $i) (i32.const {LINKED_WORDS})))
        (local.set $x (i32.add (i32.mul (local.get $x)
                                        (i32.const {_i32_lit(a)}))
                               (i32.const {_i32_lit(c)})))
        (i32.store (i32.shl (local.get $i) (i32.const 2)) (local.get $x))
        (local.set $i (i32.add (local.get $i) (i32.const 1)))
        (br $top)))
    (global.set $h0 (local.get $x)))
  (start $init)
  (func (export "run") (param $n i32) (param $k i32) (result i32)
    (local $i i32) (local $h i32) (local $w i32)
    (local.set $h (global.get $h0))
    (block $done
      (loop $top
        (br_if $done (i32.ge_u (local.get $i) (local.get $n)))
        (local.set $w (i32.load (i32.shl
          (i32.and (i32.add (local.get $i) (local.get $k))
                   (i32.const {LINKED_WORDS - 1}))
          (i32.const 2))))
        (local.set $h (i32.add (local.get $h) (local.get $w)))
        (local.set $h (call_indirect (type $op)
          (local.get $h) (local.get $w)
          (i32.and (local.get $h) (i32.const 3))))
        (local.set $i (i32.add (local.get $i) (i32.const 1)))
        (br $top)))
    (local.get $h)))""")
    return prov, consumer


def linked_words() -> np.ndarray:
    """The LINKED_WORDS words the consumer's start function writes
    (uint32 as int64), and $h0 is the last."""
    a, c = LINKED_LCG
    out = np.zeros(LINKED_WORDS, np.int64)
    x = LINKED_SEED
    for i in range(LINKED_WORDS):
        x = (x * a + c) & 0xFFFFFFFF
        out[i] = x
    return out


def linked_args(lanes: int, n0: int = LINKED_N0, n1: int = LINKED_N1):
    """`run`'s (n, k) at `lanes` lanes: k = lane, n = n0 + (lane % 8) n1,
    so trip counts and the call_indirect targets differ inside every
    warp."""
    lane = np.arange(lanes, dtype=np.int64)
    return [n0 + (lane % 8) * n1, lane]


def linked_program_model(n, k) -> np.ndarray:
    """What `run(n, k)` returns for each lane (uint32 as int64), from a
    numpy model of the loop over the start function's words.  Lanes with
    equal n and k mod LINKED_WORDS compute alike, so each distinct pair
    runs once; the pairs are sorted by n, and each iteration steps the
    pairs still going, a prefix, reading their words from a table of
    every pair's word at each i mod LINKED_WORDS.  The four table
    functions are one expression, hm + S w + T (hm & w) mod 2^32 with
    hm = h * LINKED_MUL[j] (add: S 1, T 0; sub: -1, 0; xor: 1, -2; or:
    1, -1), so a step selects by gathers, not by branches."""
    n = np.asarray(n, np.int64)
    k = np.asarray(k, np.int64) % LINKED_WORDS
    pairs, inv = np.unique(np.stack([n, k], 1), axis=0, return_inverse=True)
    order = np.argsort(-pairs[:, 0], kind="stable")
    pn, pk = pairs[order, 0], pairs[order, 1]
    words = linked_words().astype(np.uint32)
    # wt[i % LINKED_WORDS, p]: the word pair p loads at iteration i
    wt = words[(np.arange(LINKED_WORDS)[:, None] + pk[None, :])
               % LINKED_WORDS]
    mul = np.asarray(LINKED_MUL, np.uint32)
    s_w = np.asarray([1, 0xFFFFFFFF, 1, 1], np.uint32)
    t_and = np.asarray([0, 0, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    three = np.full(len(pn), 3, np.uint32)
    h = np.full(len(pn), words[-1], np.uint32)
    ends = [int(v) for v in pn[::-1]]  # ascending
    live = len(pn)
    with np.errstate(over="ignore"):
        for i in range(ends[-1] if ends else 0):
            while live and ends[len(pn) - live] <= i:
                live -= 1
            hl, w = h[:live], wt[i % LINKED_WORDS, :live]
            hl += w
            sel = np.bitwise_and(hl, three[:live]).astype(np.intp)
            hm = hl * mul.take(sel)
            np.add(hm + w * s_w.take(sel), (hm & w) * t_and.take(sel),
                   out=hl)
    out = np.empty(len(pn), np.int64)
    out[order] = h
    return out[inv.reshape(-1)]


# ---------------------------------------------------------------------------
# multi-tenant images and serving (BASELINE config 5)
# ---------------------------------------------------------------------------
C10_MAX_PAGES = (1, 4)  # the C10 tenants' declared memory maxima
C10_PAGES_PER_LANE = 4  # memory_pages_per_lane of the C10 runs


def build_grow_tenant(max_pages: int) -> bytes:
    """g(d) = memory.grow(d) over a memory of (1, max `max_pages`): the
    C10 fixture is two of these, max 1 and max 4, in one batch (each
    tenant's grows keep its own ceiling)."""
    b = ModuleBuilder()
    b.add_memory(1, max_pages)
    b.add_function(["i32"], ["i32"], [],
                   [("local.get", 0), ("memory.grow", 0)], export="g")
    return b.build()


def build_clash_a() -> bytes:
    """A tenant whose index spaces clash with `build_clash_b`'s (a
    global, a memory, a table and call_indirect): go(x) stores x at
    byte 8, adds x to its global (1000) and returns table[0](x) + the
    global + the stored word: 1000 + 5x on a fresh instance."""
    b = ModuleBuilder()
    b.add_global("i32", True, [("i32.const", 1000)])
    b.add_memory(1, 1)
    f0 = b.add_function(["i32"], ["i32"], [],
                        [("local.get", 0), ("i32.const", 3), "i32.mul"])
    b.add_table("funcref", 2)
    b.add_active_elem(0, [("i32.const", 0)], [f0])
    ti = b.add_type(["i32"], ["i32"])
    b.add_function(["i32"], ["i32"], [], [
        ("i32.const", 8), ("local.get", 0), ("i32.store", 2, 0),
        ("global.get", 0), ("local.get", 0), "i32.add", ("global.set", 0),
        ("local.get", 0), ("i32.const", 0), ("call_indirect", ti, 0),
        ("global.get", 0), "i32.add",
        ("i32.const", 8), ("i32.load", 2, 0), "i32.add",
    ], export="go")
    return b.build()


def build_clash_b() -> bytes:
    """The other clashing tenant: go(x) = table[0](x) + global (x + 7 and
    -5): x + 2."""
    b = ModuleBuilder()
    b.add_global("i32", True, [("i32.const", -5)])
    f0 = b.add_function(["i32"], ["i32"], [],
                        [("local.get", 0), ("i32.const", 7), "i32.add"])
    b.add_table("funcref", 1)
    b.add_active_elem(0, [("i32.const", 0)], [f0])
    ti = b.add_type(["i32"], ["i32"])
    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("i32.const", 0), ("call_indirect", ti, 0),
        ("global.get", 0), "i32.add",
    ], export="go")
    return b.build()


def u32_cells(v) -> np.ndarray:
    """Values as the port decodes an i32 result cell (the low word,
    unsigned, in an int64)."""
    return np.asarray(v, np.int64) & 0xFFFFFFFF


def fib_model(n) -> np.ndarray:
    """fib(n) over lanes (models.build_fib, i32)."""
    n = np.asarray(n, np.int64)
    top = int(n.max(initial=0)) + 1
    f = np.zeros(max(top, 2), np.int64)
    f[1] = 1
    for i in range(2, top):
        f[i] = (f[i - 1] + f[i - 2]) & 0xFFFFFFFF
    return f[n]


def fac_model(n) -> np.ndarray:
    """fac(n) over lanes (models.build_fac, i64, wrapping)."""
    n = np.asarray(n, np.int64)
    top = int(n.max(initial=1)) + 1
    f = np.ones(top, np.uint64)
    for i in range(2, top):
        f[i] = f[i - 1] * np.uint64(i)
    return f[np.maximum(n, 1)].view(np.int64)


def loop_sum_model(n) -> np.ndarray:
    """loop_sum(n) = 0 + 1 + ... + (n - 1) over lanes (i32, wrapping)."""
    n = np.asarray(n, np.int64) & 0xFFFFFFFF
    return u32_cells((n * (n - 1) // 2) & 0xFFFFFFFF)


def coremark_model(n) -> np.ndarray:
    """What models.build_coremark_kernel's export returns, over lanes:
    acc = sum of 3i (i + 7) for i < n (mod 2^32), then a CRC-16 step over
    its low byte, xor acc."""
    n = np.asarray(n, np.int64)
    i = np.arange(int(n.max(initial=0)), dtype=np.uint64)
    acc = np.concatenate([np.zeros(1, np.uint64),
                          np.cumsum(np.uint64(3) * i * (i + np.uint64(7)))])
    acc = (acc[n] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    data, crc = acc & 0xFF, np.full(n.shape, 0xFFFF, np.int64)
    for _ in range(8):
        crc = np.where((crc ^ data) & 1, (crc >> 1) ^ 0xA001, crc >> 1)
        data = data >> 1
    return crc ^ acc


# the four modules of BASELINE config 5 (bench_multi.py): (module name,
# export, numpy model over lanes)
CONFIG5 = (("fib", "fib", fib_model), ("fac", "fac", fac_model),
           ("loop_sum", "loop_sum", loop_sum_model),
           ("coremark", "coremark", coremark_model))


def serve_load(requests: int, seed: int, tenants=("t0", "t1", "t2", "t3"),
               ranges=None):
    """A seeded request stream over the config-5 modules: [(tenant,
    "module:func", n)], each request a random module, its argument drawn
    from `ranges` (module -> (lo, hi) inclusive)."""
    ranges = ranges or {"fib": (15, 25), "fac": (1, 20),
                        "loop_sum": (1000, 100_000),
                        "coremark": (64, 4096)}
    rng = np.random.default_rng(seed)
    mods = [m for m, _, _ in CONFIG5]
    which = rng.integers(0, len(mods), requests)
    who = rng.integers(0, len(tenants), requests)
    out = []
    for k, t in zip(which.tolist(), who.tolist()):
        lo, hi = ranges[mods[k]]
        out.append((tenants[t], f"{mods[k]}:{CONFIG5[k][1]}",
                    int(rng.integers(lo, hi + 1))))
    return out


def serve_model(func: str, n) -> np.ndarray:
    """The model of a config-5 request `module:func` over arguments."""
    return {f"{m}:{f}": model for m, f, model in CONFIG5}[func](n)


# lane compaction (batch/compact.py): the knobs that hold the policy fully
# open, so that tiny test mixes fire at every boundary (the JAX tests'
# `make_conf(forced=True)`, tests/test_compact.py:56-74)
COMPACT_FORCED = {"compact": True, "compact_min_interval": 1,
                  "compact_trigger": 0.0, "compact_cost_factor": 0.0,
                  "compact_width_floor": 4}


def compact_conf(conf, **knobs):
    """`conf` with lane compaction on and its policy held open
    (COMPACT_FORCED), then the batch knobs `knobs` set; returns `conf`."""
    for k, v in dict(COMPACT_FORCED, **knobs).items():
        setattr(conf.batch, k, v)
    return conf


def div_args(lanes: int, lo: int = 4, hi: int = 11, seed: int = 3
             ) -> np.ndarray:
    """Divergent fib arguments: lo + lane % (hi - lo + 1), shuffled by a
    seeded generator (tests/test_compact.py `div_args`)."""
    ns = (lo + np.arange(lanes) % (hi - lo + 1)).astype(np.int64)
    np.random.default_rng(seed).shuffle(ns)
    return ns
