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
import the host functions of `host_env_funcs`.  The tests and `chip_smoke.py` use them with lane inputs made from a seed.
"""

from __future__ import annotations

import numpy as np

from wasmedge_tpu_torch.batch.image import ALU1_SUB, _F32_BIN, _I32_BIN
from wasmedge_tpu_torch.utils.builder import ModuleBuilder

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
