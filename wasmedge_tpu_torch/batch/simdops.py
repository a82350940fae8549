"""v128 lane ops over four int32 planes: the plain version of B7.

A copy of the op tables of `wasmedge_tpu/batch/simdops.py` (names, the
`*_SUB` maps and `SUPPORTED_V128`, numbered as there) and plain PyTorch
versions of its op makers.  A v128 cell is four int32 words per lane
(e0..e3, little-endian: e0 holds bytes 0-3; the stack keeps them in the
`stack_lo`, `stack_hi`, `stack_e2`, `stack_e3` planes).  i8x16, i16x8 and
i32x4 act on each word alone; i64x2 pairs (e0, e1) and (e2, e3).

Integer work runs on int64 element values (a byte or half unpacked signed
or unsigned as the op needs, a word as its int32 or u32 value) and is
packed back with its low bits, so no C++ overflow rule is touched.  The
f32x4 / f64x2 families are built on `batch/laneops.py` `alu2` / `alu1`,
as the reference builds them on its laneops (`_v2_float`): vector and
scalar floats share one definition, and with it IEEE binary32 subnormals
and the reference's NaN canonicalisation.

`csrc/interp.cu` holds the same functions as device code (the `kSimd`
instantiations); `batch/interp_ref.py` calls these.  Every function is
elementwise over same-shaped int32 tensors on any device.
"""

from __future__ import annotations

from typing import List

import torch

from wasmedge_tpu_torch.batch import laneops as ops
from wasmedge_tpu_torch.batch.image import (
    ALU1_SUB, ALU2_F32_BASE, ALU2_F64_BASE, _F32_BIN)

# ---------------------------------------------------------------------------
# op name tables (ids = index; shared by the image encoding and the engines)
# ---------------------------------------------------------------------------
_ICMP = ["eq", "ne", "lt_s", "lt_u", "gt_s", "gt_u", "le_s", "le_u",
         "ge_s", "ge_u"]
_ICMP_S = ["eq", "ne", "lt_s", "gt_s", "le_s", "ge_s"]  # i64x2 set

_FBIN = ["add", "sub", "mul", "div", "min", "max", "pmin", "pmax",
         "eq", "ne", "lt", "gt", "le", "ge"]
_FUN = ["abs", "neg", "sqrt", "ceil", "floor", "trunc", "nearest"]

V2_NAMES: List[str] = (
    ["v128.and", "v128.or", "v128.xor", "v128.andnot"]
    + [f"i8x16.{n}" for n in
       ["add", "sub", "add_sat_s", "add_sat_u", "sub_sat_s", "sub_sat_u",
        "min_s", "min_u", "max_s", "max_u", "avgr_u", "swizzle"] + _ICMP]
    + [f"i16x8.{n}" for n in
       ["add", "sub", "mul", "add_sat_s", "add_sat_u", "sub_sat_s",
        "sub_sat_u", "min_s", "min_u", "max_s", "max_u", "avgr_u"] + _ICMP]
    + [f"i32x4.{n}" for n in
       ["add", "sub", "mul", "min_s", "min_u", "max_s", "max_u"] + _ICMP]
    + [f"i64x2.{n}" for n in ["add", "sub", "mul"] + _ICMP_S]
    + [f"f32x4.{n}" for n in _FBIN]
    + [f"f64x2.{n}" for n in _FBIN]
    + ["i8x16.narrow_i16x8_s", "i8x16.narrow_i16x8_u",
       "i16x8.narrow_i32x4_s", "i16x8.narrow_i32x4_u",
       "i16x8.q15mulr_sat_s", "i32x4.dot_i16x8_s"]
    + [f"i16x8.extmul_{p}_i8x16_{s}"
       for p in ("low", "high") for s in ("s", "u")]
    + [f"i32x4.extmul_{p}_i16x8_{s}"
       for p in ("low", "high") for s in ("s", "u")]
    + [f"i64x2.extmul_{p}_i32x4_{s}"
       for p in ("low", "high") for s in ("s", "u")]
)
V1_NAMES: List[str] = (
    ["v128.not", "i8x16.abs", "i8x16.neg", "i8x16.popcnt",
     "i16x8.abs", "i16x8.neg", "i32x4.abs", "i32x4.neg",
     "i64x2.abs", "i64x2.neg"]
    + [f"f32x4.{n}" for n in _FUN]
    + [f"f64x2.{n}" for n in _FUN]
    + ["i32x4.trunc_sat_f32x4_s", "i32x4.trunc_sat_f32x4_u",
       "f32x4.convert_i32x4_s", "f32x4.convert_i32x4_u",
       "i32x4.trunc_sat_f64x2_s_zero", "i32x4.trunc_sat_f64x2_u_zero",
       "f64x2.convert_low_i32x4_s", "f64x2.convert_low_i32x4_u",
       "f32x4.demote_f64x2_zero", "f64x2.promote_low_f32x4"]
    + [f"i16x8.extend_{p}_i8x16_{s}"
       for p in ("low", "high") for s in ("s", "u")]
    + [f"i32x4.extend_{p}_i16x8_{s}"
       for p in ("low", "high") for s in ("s", "u")]
    + [f"i64x2.extend_{p}_i32x4_{s}"
       for p in ("low", "high") for s in ("s", "u")]
    + ["i16x8.extadd_pairwise_i8x16_s", "i16x8.extadd_pairwise_i8x16_u",
       "i32x4.extadd_pairwise_i16x8_s", "i32x4.extadd_pairwise_i16x8_u"]
)
VTEST_NAMES: List[str] = (
    ["v128.any_true"]
    + [f"{s}.all_true" for s in ("i8x16", "i16x8", "i32x4", "i64x2")]
    + [f"{s}.bitmask" for s in ("i8x16", "i16x8", "i32x4", "i64x2")]
)
VSHIFT_NAMES: List[str] = [
    f"{s}.{k}" for s in ("i8x16", "i16x8", "i32x4", "i64x2")
    for k in ("shl", "shr_s", "shr_u")]
VSPLAT_NAMES: List[str] = [f"{s}.splat" for s in
                           ("i8x16", "i16x8", "i32x4", "i64x2",
                            "f32x4", "f64x2")]
VEXTRACT_NAMES: List[str] = [
    "i8x16.extract_lane_s", "i8x16.extract_lane_u",
    "i16x8.extract_lane_s", "i16x8.extract_lane_u",
    "i32x4.extract_lane", "i64x2.extract_lane",
    "f32x4.extract_lane", "f64x2.extract_lane"]
VREPLACE_NAMES: List[str] = [f"{s}.replace_lane" for s in
                             ("i8x16", "i16x8", "i32x4", "i64x2",
                              "f32x4", "f64x2")]

V2_SUB = {n: i for i, n in enumerate(V2_NAMES)}
V1_SUB = {n: i for i, n in enumerate(V1_NAMES)}
VTEST_SUB = {n: i for i, n in enumerate(VTEST_NAMES)}
VSHIFT_SUB = {n: i for i, n in enumerate(VSHIFT_NAMES)}
VSPLAT_SUB = {n: i for i, n in enumerate(VSPLAT_NAMES)}
VEXTRACT_SUB = {n: i for i, n in enumerate(VEXTRACT_NAMES)}
VREPLACE_SUB = {n: i for i, n in enumerate(VREPLACE_NAMES)}

SUPPORTED_V128 = (set(V2_NAMES) | set(V1_NAMES) | set(VTEST_NAMES)
                  | set(VSHIFT_NAMES) | set(VSPLAT_NAMES)
                  | set(VEXTRACT_NAMES) | set(VREPLACE_NAMES)
                  | {"v128.const", "v128.load", "v128.store",
                     "i8x16.shuffle", "v128.bitselect"})

# ---------------------------------------------------------------------------
# element packing (int64 element values, int32 words)
# ---------------------------------------------------------------------------
I64 = torch.int64
_WIDTH = {"i8x16": 8, "i16x8": 16, "i32x4": 32}


def _elems(w, width, signed):
    """One int32 word -> its 32 / width elements as int64 values."""
    if width == 32:
        return [w.to(I64) if signed else ops.u32(w)]
    u, m, h = ops.u32(w), (1 << width) - 1, 1 << (width - 1)
    out = [(u >> (width * k)) & m for k in range(32 // width)]
    return [(e ^ h) - h for e in out] if signed else out


def _pack(es, width):
    """Elements (low `width` bits each) -> one int32 word."""
    if width == 32:
        return ops.wrap32(es[0])
    m = (1 << width) - 1
    v = es[0] & m
    for k in range(1, len(es)):
        v = v | ((es[k] & m) << (width * k))
    return ops.wrap32(v)


def _all_elems(x4, width, signed):
    return [e for w in x4 for e in _elems(w, width, signed)]


def _repack(es, width):
    """A flat list of 128 / width elements -> a 4-tuple of words."""
    n = 32 // width
    return tuple(_pack(es[n * k:n * k + n], width) for k in range(4))


def _mask(cond):
    """bool -> -1 / 0 element (its low bits all ones)."""
    return torch.where(cond, -1, 0).to(I64)


def _elemwise(width, signed, fn, x4, y4=None):
    ys = y4 if y4 is not None else (None,) * 4
    out = []
    for a, b in zip(x4, ys):
        xa = _elems(a, width, signed)
        yb = _elems(b, width, signed) if b is not None else [None] * len(xa)
        out.append(_pack([fn(p, q) for p, q in zip(xa, yb)], width))
    return tuple(out)


def _sat_range(width, signed):
    return (-(1 << (width - 1)), (1 << (width - 1)) - 1) if signed \
        else (0, (1 << width) - 1)


def _int_binop(op, width):
    """fn(a, b) over element values, or None."""
    if op == "add":
        return lambda a, b: a + b
    if op == "sub":
        return lambda a, b: a - b
    if op == "mul":
        return lambda a, b: a * b
    if op in ("add_sat_s", "sub_sat_s", "add_sat_u", "sub_sat_u"):
        lo, hi = _sat_range(width, op.endswith("_s"))
        if op.startswith("add"):
            return lambda a, b: (a + b).clamp(lo, hi)
        return lambda a, b: (a - b).clamp(lo, hi)
    if op in ("min_s", "min_u"):
        return torch.minimum
    if op in ("max_s", "max_u"):
        return torch.maximum
    if op == "avgr_u":
        return lambda a, b: (a + b + 1) >> 1
    cmp = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "gt": torch.gt,
           "le": torch.le, "ge": torch.ge}.get(op.split("_")[0])
    if cmp is not None:
        return lambda a, b: _mask(cmp(a, b))
    return None


def _signed(op: str) -> bool:
    return not op.endswith("_u")


def _pair(x4, k):
    return ops.pack(x4[k], x4[k + 1])


def _pairs_out(vals):
    """Two int64 values -> a 4-tuple of words."""
    r = []
    for v in vals:
        r.extend(ops.split(v))
    return tuple(r)


def _select(sel, src):
    """Byte gather: out[j] = src[sel[j]] where sel[j] < len(src), else 0.
    sel: list of int64 [lanes] selector bytes; src: list of int64 bytes."""
    table = torch.stack(src)  # [n, lanes]
    s = torch.stack(sel)
    got = table.gather(0, s.clamp(0, table.shape[0] - 1))
    got = torch.where(s < table.shape[0], got, torch.zeros_like(got))
    return list(got.unbind(0))


# ---------------------------------------------------------------------------
# binary ops: (x4, y4) -> r4 (x4 second from the top, y4 on top)
# ---------------------------------------------------------------------------
def _v2_float(px: str, op: str):
    is32 = px == "f32x4"
    base = ALU2_F32_BASE if is32 else ALU2_F64_BASE
    lt = base + _F32_BIN.index("lt")
    cmps = ("eq", "ne", "lt", "gt", "le", "ge")

    def per_elem(a, b):
        """a, b: (lo, hi) of one element -> (lo, hi) of the result."""
        if op in ("pmin", "pmax"):
            # pmin: b < a ? b : a; pmax: a < b ? b : a
            c, _ = ops.alu2(lt, *b, *a) if op == "pmin" \
                else ops.alu2(lt, *a, *b)
            return (torch.where(c != 0, b[0], a[0]),
                    torch.where(c != 0, b[1], a[1]))
        lo, hi = ops.alu2(base + _F32_BIN.index(op), *a, *b)
        if op in cmps:
            m = torch.where(lo != 0, -1, 0).to(torch.int32)
            return m, (torch.zeros_like(m) if is32 else m)
        return lo, hi

    def fn(x4, y4):
        if is32:
            z = torch.zeros_like(x4[0])
            return tuple(per_elem((a, z), (b, z))[0]
                         for a, b in zip(x4, y4))
        r = []
        for k in (0, 2):
            r.extend(per_elem((x4[k], x4[k + 1]), (y4[k], y4[k + 1])))
        return tuple(r)
    return fn


def _v2_intext(name: str):
    """Narrowing, q15 multiply, dot product and extended multiplies."""
    if ".narrow_" in name:
        src = 16 if name.startswith("i8x16") else 32
        lo, hi = _sat_range(src // 2, name.endswith("_s"))

        def nar(x4, y4):
            es = _all_elems(x4, src, True) + _all_elems(y4, src, True)
            return _repack([e.clamp(lo, hi) for e in es], src // 2)
        return nar
    if name == "i16x8.q15mulr_sat_s":
        return lambda x4, y4: _elemwise(
            16, True, lambda a, b: ((a * b + 0x4000) >> 15).clamp(
                -32768, 32767), x4, y4)
    if name == "i32x4.dot_i16x8_s":
        def dot(x4, y4):
            out = []
            for a, b in zip(x4, y4):
                ha, hb = _elems(a, 16, True), _elems(b, 16, True)
                out.append(ops.wrap32(ha[0] * hb[0] + ha[1] * hb[1]))
            return tuple(out)
        return dot
    if ".extmul_" not in name:
        return None
    px, rest = name.split(".", 1)
    parts = rest.split("_")          # extmul, low|high, <src>, s|u
    low = parts[1] == "low"
    signed = parts[-1] == "s"
    width = {"i16x8": 16, "i32x4": 32, "i64x2": 64}[px]

    def em(x4, y4):
        xs = _all_elems(x4, width // 2, signed)
        ys = _all_elems(y4, width // 2, signed)
        n = len(xs) // 2
        sel = range(0, n) if low else range(n, 2 * n)
        ps = [xs[i] * ys[i] for i in sel]
        if width == 64:
            return _pairs_out(ps)
        return _repack(ps, width)
    return em


def v2_fn(sub: int):
    """Binary v128 op: (x4, y4) -> r4 over 4-tuples of int32 planes."""
    name = V2_NAMES[sub]
    px0 = name.split(".", 1)[0]
    if px0 in ("f32x4", "f64x2"):
        return _v2_float(px0, name.split(".", 1)[1])
    ext = _v2_intext(name)
    if ext is not None:
        return ext
    if name == "v128.and":
        return lambda x4, y4: tuple(a & b for a, b in zip(x4, y4))
    if name == "v128.or":
        return lambda x4, y4: tuple(a | b for a, b in zip(x4, y4))
    if name == "v128.xor":
        return lambda x4, y4: tuple(a ^ b for a, b in zip(x4, y4))
    if name == "v128.andnot":
        return lambda x4, y4: tuple(a & ~b for a, b in zip(x4, y4))
    if name == "i8x16.swizzle":
        # dest byte j = src byte s (s = selector byte j), 0 if s >= 16
        return lambda x4, y4: _repack(
            _select(_all_elems(y4, 8, False), _all_elems(x4, 8, False)), 8)
    px, op = name.split(".", 1)
    if px == "i64x2":
        def pair(x4, y4):
            r = []
            for k in (0, 2):
                a, b = _pair(x4, k), _pair(y4, k)
                if op in ("add", "sub", "mul"):
                    v = {"add": a + b, "sub": a - b, "mul": a * b}[op]
                else:
                    v = _mask({"eq": a == b, "ne": a != b, "lt_s": a < b,
                               "gt_s": a > b, "le_s": a <= b,
                               "ge_s": a >= b}[op])
                r.append(v)
            return _pairs_out(r)
        return pair
    width = _WIDTH[px]
    fn = _int_binop(op, width)
    return lambda x4, y4: _elemwise(width, _signed(op), fn, x4, y4)


# ---------------------------------------------------------------------------
# unary ops: x4 -> r4
# ---------------------------------------------------------------------------
def _a1(name):
    return ALU1_SUB[name]


def _v1_special(name: str):
    """Float unaries, float <-> int conversions, widening and pairwise
    adds."""
    px, op = name.split(".", 1)
    if px == "f32x4" and op in _FUN:
        sub = _a1(f"f32.{op}")
        return lambda x4: tuple(ops.alu1(sub, w, torch.zeros_like(w))[0]
                                for w in x4)
    if px == "f64x2" and op in _FUN:
        sub = _a1(f"f64.{op}")

        def un64(x4):
            r = []
            for k in (0, 2):
                r.extend(ops.alu1(sub, x4[k], x4[k + 1]))
            return tuple(r)
        return un64
    per_word = {
        "i32x4.trunc_sat_f32x4_s": "i32.trunc_sat_f32_s",
        "i32x4.trunc_sat_f32x4_u": "i32.trunc_sat_f32_u",
        "f32x4.convert_i32x4_s": "f32.convert_i32_s",
        "f32x4.convert_i32x4_u": "f32.convert_i32_u",
    }
    if name in per_word:
        sub = _a1(per_word[name])
        return lambda x4: tuple(ops.alu1(sub, w, torch.zeros_like(w))[0]
                                for w in x4)
    narrow = {
        "i32x4.trunc_sat_f64x2_s_zero": "i32.trunc_sat_f64_s",
        "i32x4.trunc_sat_f64x2_u_zero": "i32.trunc_sat_f64_u",
        "f32x4.demote_f64x2_zero": "f32.demote_f64",
    }
    if name in narrow:
        sub = _a1(narrow[name])

        def nz(x4):
            r0 = ops.alu1(sub, x4[0], x4[1])[0]
            r1 = ops.alu1(sub, x4[2], x4[3])[0]
            z = torch.zeros_like(r0)
            return (r0, r1, z, z)
        return nz
    widen = {
        "f64x2.convert_low_i32x4_s": "f64.convert_i32_s",
        "f64x2.convert_low_i32x4_u": "f64.convert_i32_u",
        "f64x2.promote_low_f32x4": "f64.promote_f32",
    }
    if name in widen:
        sub = _a1(widen[name])

        def wd(x4):
            z = torch.zeros_like(x4[0])
            return (*ops.alu1(sub, x4[0], z), *ops.alu1(sub, x4[1], z))
        return wd
    if ".extend_" in name:
        parts = op.split("_")        # extend, low|high, <src>, s|u
        low = parts[1] == "low"
        signed = parts[-1] == "s"
        width = {"i16x8": 16, "i32x4": 32, "i64x2": 64}[px]

        def ex(x4):
            es = _all_elems(x4, width // 2, signed)
            n = len(es) // 2
            sel = es[:n] if low else es[n:]
            return _pairs_out(sel) if width == 64 else _repack(sel, width)
        return ex
    if ".extadd_pairwise_" in name:
        signed = name.endswith("_s")
        width = 16 if px == "i16x8" else 32

        def ea(x4):
            es = _all_elems(x4, width // 2, signed)
            return _repack([es[2 * k] + es[2 * k + 1]
                            for k in range(len(es) // 2)], width)
        return ea
    return None


def _popcnt8(b, _):
    v = b - ((b >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def v1_fn(sub: int):
    """Unary v128 op: x4 -> r4."""
    name = V1_NAMES[sub]
    if name == "v128.not":
        return lambda x4: tuple(~a for a in x4)
    special = _v1_special(name)
    if special is not None:
        return special
    if name == "i8x16.popcnt":
        return lambda x4: _elemwise(8, False, _popcnt8, x4)
    px, op = name.split(".", 1)
    if px == "i64x2":
        def pair(x4):
            vs = [_pair(x4, k) for k in (0, 2)]
            if op == "neg":
                return _pairs_out([-v for v in vs])
            return _pairs_out([torch.where(v < 0, -v, v) for v in vs])
        return pair
    fn = (lambda a, _: -a) if op == "neg" else (lambda a, _: a.abs())
    return lambda x4: _elemwise(_WIDTH[px], True, fn, x4)


# ---------------------------------------------------------------------------
# tests, shifts, splats, bitselect
# ---------------------------------------------------------------------------
def vtest_fn(sub: int):
    """v128 -> per-lane i32 scalar."""
    name = VTEST_NAMES[sub]
    if name == "v128.any_true":
        return lambda x4: ((x4[0] | x4[1] | x4[2] | x4[3]) != 0).to(
            torch.int32)
    px, op = name.split(".", 1)
    if op == "all_true":
        if px == "i64x2":
            return lambda x4: (((x4[0] | x4[1]) != 0)
                               & ((x4[2] | x4[3]) != 0)).to(torch.int32)
        width = _WIDTH[px]

        def all_true(x4):
            ok = torch.ones_like(x4[0], dtype=torch.bool)
            for e in _all_elems(x4, width, False):
                ok = ok & (e != 0)
            return ok.to(torch.int32)
        return all_true
    # bitmask: the top bit of each element, lane 0 in bit 0
    width = 64 if px == "i64x2" else _WIDTH[px]

    def bitmask(x4):
        if width == 64:
            tops = [ops.u32(x4[1]) >> 31, ops.u32(x4[3]) >> 31]
        else:
            tops = [e >> (width - 1)
                    for e in _all_elems(x4, width, False)]
        acc = torch.zeros_like(tops[0])
        for k, t in enumerate(tops):
            acc = acc | (t << k)
        return ops.wrap32(acc)
    return bitmask


def vshift_fn(sub: int):
    """(x4, n) -> r4, n the i32 shift count plane (masked to the element
    width)."""
    px, op = VSHIFT_NAMES[sub].split(".", 1)
    if px == "i64x2":
        def sh64(x4, n):
            n = n.to(I64) & 63
            r = []
            for k in (0, 2):
                v = _pair(x4, k)
                r.append({"shl": ops.shl64(v, n), "shr_s": v >> n,
                          "shr_u": ops.shr_u64(v, n)}[op])
            return _pairs_out(r)
        return sh64
    width = _WIDTH[px]
    signed = op == "shr_s"

    def sh(x4, n):
        n = n.to(I64) & (width - 1)
        fn = (lambda a, _: a << n) if op == "shl" else (lambda a, _: a >> n)
        return _elemwise(width, signed, fn, x4)
    return sh


def vsplat_fn(sub: int):
    """(lo, hi) scalar planes -> r4."""
    px = VSPLAT_NAMES[sub].split(".", 1)[0]

    def splat(lo, hi):
        if px == "i8x16":
            w = ops.wrap32((ops.u32(lo) & 0xFF) * 0x01010101)
        elif px == "i16x8":
            h = ops.u32(lo) & 0xFFFF
            w = ops.wrap32(h | (h << 16))
        elif px in ("i32x4", "f32x4"):
            w = lo
        else:
            return (lo, hi, lo, hi)  # i64x2 / f64x2
        return (w, w, w, w)
    return splat


def vbitselect(v1, v2, c):
    """Bits of v1 where c is set, of v2 elsewhere."""
    return tuple((a & m) | (b & ~m) for a, b, m in zip(v1, v2, c))


# ---------------------------------------------------------------------------
# lane indices and shuffle masks as per-lane planes (each lane of the plain
# interpreter may sit at another pc)
# ---------------------------------------------------------------------------
def vextract_dyn(sub: int):
    """(x4, lane) -> (lo, hi), lane a per-lane int32 plane."""
    name = VEXTRACT_NAMES[sub]
    px = name.split(".", 1)[0]
    signed = name.endswith("_s")

    def pick(x4, k):
        w = x4[0]
        for j in range(1, 4):
            w = torch.where(k == j, x4[j], w)
        return w

    def ex(x4, lane):
        z = torch.zeros_like(x4[0])
        if px in ("i8x16", "i16x8"):
            width = _WIDTH[px]
            per = 32 // width
            w = pick(x4, lane // per)
            e = (ops.u32(w) >> (width * (lane % per))) & ((1 << width) - 1)
            if signed:
                h = 1 << (width - 1)
                e = (e ^ h) - h
            return ops.wrap32(e), z
        if px in ("i32x4", "f32x4"):
            return pick(x4, lane), z
        first = lane == 0
        return (torch.where(first, x4[0], x4[2]),
                torch.where(first, x4[1], x4[3]))
    return ex


def vreplace_dyn(sub: int):
    """(x4, lane, lo, hi) -> r4, lane a per-lane int32 plane."""
    px = VREPLACE_NAMES[sub].split(".", 1)[0]

    def rp(x4, lane, lo, hi):
        if px in ("i8x16", "i16x8"):
            width = _WIDTH[px]
            per = 32 // width
            sh = width * (lane.to(I64) % per)
            m = ((1 << width) - 1) << sh
            v = (ops.u32(lo) << sh) & m
            return tuple(torch.where(lane // per == k,
                                     ops.wrap32((ops.u32(x4[k]) & ~m) | v), x4[k])
                         for k in range(4))
        if px in ("i32x4", "f32x4"):
            return tuple(torch.where(lane == k, lo, x4[k]) for k in range(4))
        out = []
        for k in range(2):
            out.append(torch.where(lane == k, lo, x4[2 * k]))
            out.append(torch.where(lane == k, hi, x4[2 * k + 1]))
        return tuple(out)
    return rp


def vshuffle_dyn(x4, y4, m4):
    """Each selector byte of the per-lane mask planes m4 picks one of the
    32 bytes of (x4, y4); a selector of 32 or more gives 0."""
    src = _all_elems(x4, 8, False) + _all_elems(y4, 8, False)
    return _repack(_select(_all_elems(m4, 8, False), src), 8)
