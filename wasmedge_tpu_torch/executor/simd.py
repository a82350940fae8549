"""SIMD v128 op kernels for the scalar engine.

A copy of `wasmedge_tpu/executor/simd.py`.

Mirrors the reference's v128 dispatch block (WasmEdge lib/executor/
engine/engine.cpp ~700-1610 and the SIMD arms of binary/unary_numeric.ipp):
all 236 ops of the final 128-bit SIMD proposal. A v128 value is one
128-bit Python int stack cell (little-endian lane order); lanes are
split/packed exactly, floats go through numpy for correct rounding, and
NaN outputs of arithmetic ops are canonicalized — the same policy as the
scalar numeric kernels so engine parity is bit-exact.
"""

from __future__ import annotations

import struct

import numpy as np

from wasmedge_tpu_torch.common.opcodes import NAME_TO_ID
from wasmedge_tpu_torch.common.types import (
    F32_CANONICAL_NAN,
    F64_CANONICAL_NAN,
    MASK64,
    bits_to_f32,
    bits_to_f64,
    f32_to_bits,
    f64_to_bits,
)
from wasmedge_tpu_torch.executor.numeric import HANDLERS, _canon32, _canon64, _np_err

MASK128 = (1 << 128) - 1


def _reg(name):
    def deco(fn):
        HANDLERS[NAME_TO_ID[name]] = fn
        return fn

    return deco


# -- lane packing -----------------------------------------------------------
def lanes(v: int, n: int, w: int, signed: bool = False):
    """Split a 128-bit int into n lanes of w bits (little-endian)."""
    mask = (1 << w) - 1
    top = 1 << (w - 1)
    out = []
    for k in range(n):
        x = (v >> (w * k)) & mask
        if signed and x & top:
            x -= 1 << w
        out.append(x)
    return out


def pack(vals, w: int) -> int:
    mask = (1 << w) - 1
    v = 0
    for k, x in enumerate(vals):
        v |= (x & mask) << (w * k)
    return v


def _sat(x: int, lo: int, hi: int) -> int:
    return lo if x < lo else (hi if x > hi else x)


# -- int shape families -----------------------------------------------------
# (prefix, lane count, lane bits)
_ISHAPES = [("i8x16", 16, 8), ("i16x8", 8, 16), ("i32x4", 4, 32),
            ("i64x2", 2, 64)]


def _gen_int_shape(px: str, n: int, w: int):
    smin, smax = -(1 << (w - 1)), (1 << (w - 1)) - 1
    umax = (1 << w) - 1
    full = (1 << w) - 1

    def binop(name, fn, signed_a=False, signed_b=False):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn, sa=signed_a, sb=signed_b):
            b = st.pop()
            a = st[-1]
            st[-1] = pack([fn(x, y) for x, y in
                           zip(lanes(a, n, w, sa), lanes(b, n, w, sb))], w)

    def unop(name, fn, signed=False):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn, s=signed):
            st[-1] = pack([fn(x) for x in lanes(st[-1], n, w, s)], w)

    def cmps(name, fn, signed):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn, s=signed):
            b = st.pop()
            a = st[-1]
            st[-1] = pack([full if fn(x, y) else 0 for x, y in
                           zip(lanes(a, n, w, s), lanes(b, n, w, s))], w)

    # arithmetic
    binop("add", lambda a, b: a + b)
    binop("sub", lambda a, b: a - b)
    if px != "i8x16":
        binop("mul", lambda a, b: a * b)
    unop("neg", lambda a: -a)
    unop("abs", lambda a: -a if a < 0 else a, signed=True)

    # compares (eq/ne unsigned; ordered s/u except i64x2 which is s-only)
    cmps("eq", lambda a, b: a == b, False)
    cmps("ne", lambda a, b: a != b, False)
    cmps("lt_s", lambda a, b: a < b, True)
    cmps("gt_s", lambda a, b: a > b, True)
    cmps("le_s", lambda a, b: a <= b, True)
    cmps("ge_s", lambda a, b: a >= b, True)
    if px != "i64x2":
        cmps("lt_u", lambda a, b: a < b, False)
        cmps("gt_u", lambda a, b: a > b, False)
        cmps("le_u", lambda a, b: a <= b, False)
        cmps("ge_u", lambda a, b: a >= b, False)
        binop("min_s", min, True, True)
        binop("max_s", max, True, True)
        binop("min_u", min)
        binop("max_u", max)

    # shifts: amount is a scalar i32, mod lane width
    @_reg(f"{px}.shl")
    def shl(st):
        k = st.pop() % w
        st[-1] = pack([x << k for x in lanes(st[-1], n, w)], w)

    @_reg(f"{px}.shr_u")
    def shr_u(st):
        k = st.pop() % w
        st[-1] = pack([x >> k for x in lanes(st[-1], n, w)], w)

    @_reg(f"{px}.shr_s")
    def shr_s(st):
        k = st.pop() % w
        st[-1] = pack([x >> k for x in lanes(st[-1], n, w, True)], w)

    # reductions
    @_reg(f"{px}.all_true")
    def all_true(st):
        st[-1] = 1 if all(lanes(st[-1], n, w)) else 0

    @_reg(f"{px}.bitmask")
    def bitmask(st):
        v = st[-1]
        m = 0
        for k in range(n):
            if (v >> (w * k + w - 1)) & 1:
                m |= 1 << k
        st[-1] = m

    # splat (operand type varies: i8/i16/i32 take i32, i64 takes i64)
    @_reg(f"{px}.splat")
    def splat(st):
        st[-1] = pack([st[-1]] * n, w)

    # saturating add/sub + avgr for the narrow shapes
    if w <= 16:
        binop("add_sat_s", lambda a, b: _sat(a + b, smin, smax), True, True)
        binop("sub_sat_s", lambda a, b: _sat(a - b, smin, smax), True, True)
        binop("add_sat_u", lambda a, b: _sat(a + b, 0, umax))
        binop("sub_sat_u", lambda a, b: _sat(a - b, 0, umax))
        binop("avgr_u", lambda a, b: (a + b + 1) >> 1)


for _px, _n, _w in _ISHAPES:
    _gen_int_shape(_px, _n, _w)


# -- i8x16 extras -----------------------------------------------------------
@_reg("i8x16.popcnt")
def i8x16_popcnt(st):
    st[-1] = pack([bin(x).count("1") for x in lanes(st[-1], 16, 8)], 8)


@_reg("i8x16.swizzle")
def i8x16_swizzle(st):
    s = lanes(st.pop(), 16, 8)
    a = lanes(st[-1], 16, 8)
    st[-1] = pack([a[i] if i < 16 else 0 for i in s], 8)


# (i8x16.shuffle is dispatched by the engine: it needs the mask immediate.)


# -- v128 bitwise -----------------------------------------------------------
@_reg("v128.not")
def v128_not(st):
    st[-1] = st[-1] ^ MASK128


@_reg("v128.and")
def v128_and(st):
    b = st.pop()
    st[-1] &= b


@_reg("v128.andnot")
def v128_andnot(st):
    b = st.pop()
    st[-1] &= b ^ MASK128


@_reg("v128.or")
def v128_or(st):
    b = st.pop()
    st[-1] |= b


@_reg("v128.xor")
def v128_xor(st):
    b = st.pop()
    st[-1] ^= b


@_reg("v128.bitselect")
def v128_bitselect(st):
    c = st.pop()
    b = st.pop()
    st[-1] = (st[-1] & c) | (b & ~c & MASK128)


@_reg("v128.any_true")
def v128_any_true(st):
    st[-1] = 1 if st[-1] != 0 else 0


# -- narrow / extend / extmul / pairwise ------------------------------------
def _narrow(src_w, dst_w, signed_dst):
    lo = -(1 << (dst_w - 1)) if signed_dst else 0
    hi = (1 << (dst_w - 1)) - 1 if signed_dst else (1 << dst_w) - 1

    def h(st):
        b = lanes(st.pop(), 128 // src_w, src_w, True)
        a = lanes(st[-1], 128 // src_w, src_w, True)
        st[-1] = pack([_sat(x, lo, hi) for x in a + b], dst_w)

    return h


HANDLERS[NAME_TO_ID["i8x16.narrow_i16x8_s"]] = _narrow(16, 8, True)
HANDLERS[NAME_TO_ID["i8x16.narrow_i16x8_u"]] = _narrow(16, 8, False)
HANDLERS[NAME_TO_ID["i16x8.narrow_i32x4_s"]] = _narrow(32, 16, True)
HANDLERS[NAME_TO_ID["i16x8.narrow_i32x4_u"]] = _narrow(32, 16, False)


def _extend(src_w, high, signed):
    n_src = 128 // src_w

    def h(st):
        xs = lanes(st[-1], n_src, src_w, signed)
        half = xs[n_src // 2:] if high else xs[: n_src // 2]
        st[-1] = pack(half, src_w * 2)

    return h


for _sw, _dst in ((8, "i16x8"), (16, "i32x4"), (32, "i64x2")):
    _src = {8: "i8x16", 16: "i16x8", 32: "i32x4"}[_sw]
    for _hi in (False, True):
        for _sgn in (True, False):
            _nm = (f"{_dst}.extend_{'high' if _hi else 'low'}_{_src}_"
                   f"{'s' if _sgn else 'u'}")
            HANDLERS[NAME_TO_ID[_nm]] = _extend(_sw, _hi, _sgn)


def _extmul(src_w, high, signed):
    n_src = 128 // src_w

    def h(st):
        b = lanes(st.pop(), n_src, src_w, signed)
        a = lanes(st[-1], n_src, src_w, signed)
        sl = slice(n_src // 2, None) if high else slice(None, n_src // 2)
        st[-1] = pack([x * y for x, y in zip(a[sl], b[sl])], src_w * 2)

    return h


for _sw, _dst in ((8, "i16x8"), (16, "i32x4"), (32, "i64x2")):
    _src = {8: "i8x16", 16: "i16x8", 32: "i32x4"}[_sw]
    for _hi in (False, True):
        for _sgn in (True, False):
            _nm = (f"{_dst}.extmul_{'high' if _hi else 'low'}_{_src}_"
                   f"{'s' if _sgn else 'u'}")
            HANDLERS[NAME_TO_ID[_nm]] = _extmul(_sw, _hi, _sgn)


def _extadd_pairwise(src_w, signed):
    n_src = 128 // src_w

    def h(st):
        xs = lanes(st[-1], n_src, src_w, signed)
        st[-1] = pack([xs[2 * k] + xs[2 * k + 1] for k in range(n_src // 2)],
                      src_w * 2)

    return h


HANDLERS[NAME_TO_ID["i16x8.extadd_pairwise_i8x16_s"]] = _extadd_pairwise(8, True)
HANDLERS[NAME_TO_ID["i16x8.extadd_pairwise_i8x16_u"]] = _extadd_pairwise(8, False)
HANDLERS[NAME_TO_ID["i32x4.extadd_pairwise_i16x8_s"]] = _extadd_pairwise(16, True)
HANDLERS[NAME_TO_ID["i32x4.extadd_pairwise_i16x8_u"]] = _extadd_pairwise(16, False)


@_reg("i16x8.q15mulr_sat_s")
def q15mulr(st):
    b = lanes(st.pop(), 8, 16, True)
    a = lanes(st[-1], 8, 16, True)
    st[-1] = pack([_sat((x * y + (1 << 14)) >> 15, -(1 << 15), (1 << 15) - 1)
                   for x, y in zip(a, b)], 16)


@_reg("i32x4.dot_i16x8_s")
def dot_i16x8(st):
    b = lanes(st.pop(), 8, 16, True)
    a = lanes(st[-1], 8, 16, True)
    st[-1] = pack([a[2 * k] * b[2 * k] + a[2 * k + 1] * b[2 * k + 1]
                   for k in range(4)], 32)


# -- float shapes -----------------------------------------------------------
def _gen_float_shape(px, n, w, to_f, to_bits, canon, nan_bits, sign_bit,
                     abs_mask):
    def map_bits(st_v, fn):
        return pack([fn((st_v >> (w * k)) & ((1 << w) - 1))
                     for k in range(n)], w)

    def binop(name, fn):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn):
            b = st.pop()
            a = st[-1]

            def one(k):
                x = to_f((a >> (w * k)) & ((1 << w) - 1))
                y = to_f((b >> (w * k)) & ((1 << w) - 1))
                with _np_err():
                    return canon(to_bits(fn(x, y)))

            st[-1] = pack([one(k) for k in range(n)], w)

    binop("add", lambda a, b: a + b)
    binop("sub", lambda a, b: a - b)
    binop("mul", lambda a, b: a * b)
    binop("div", lambda a, b: a / b)

    def unop(name, fn):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn):
            def one(bits):
                with _np_err():
                    return canon(to_bits(fn(to_f(bits))))

            st[-1] = map_bits(st[-1], one)

    unop("ceil", np.ceil)
    unop("floor", np.floor)
    unop("trunc", np.trunc)
    unop("nearest", np.rint)
    unop("sqrt", np.sqrt)

    @_reg(f"{px}.abs")
    def fabs(st):
        st[-1] = map_bits(st[-1], lambda bb: bb & abs_mask)

    @_reg(f"{px}.neg")
    def fneg(st):
        st[-1] = map_bits(st[-1], lambda bb: bb ^ sign_bit)

    def minmax(name, pick_min):
        @_reg(f"{px}.{name}")
        def h(st, pick_min=pick_min):
            bv = st.pop()
            av = st[-1]

            def one(k):
                ab = (av >> (w * k)) & ((1 << w) - 1)
                bb = (bv >> (w * k)) & ((1 << w) - 1)
                a, b = to_f(ab), to_f(bb)
                if np.isnan(a) or np.isnan(b):
                    return nan_bits
                if a == b:
                    sa = ab & sign_bit
                    if pick_min:
                        return ab if sa else bb
                    return ab if not sa else bb
                return ab if (a < b) == pick_min else bb

            st[-1] = pack([one(k) for k in range(n)], w)

    minmax("min", True)
    minmax("max", False)

    def pminmax(name, pick_b):
        # pmin: b < a ? b : a ; pmax: a < b ? b : a (IEEE-style, no NaN fix)
        @_reg(f"{px}.{name}")
        def h(st, pick_b=pick_b):
            bv = st.pop()
            av = st[-1]

            def one(k):
                ab = (av >> (w * k)) & ((1 << w) - 1)
                bb = (bv >> (w * k)) & ((1 << w) - 1)
                a, b = to_f(ab), to_f(bb)
                take_b = (b < a) if pick_b == "pmin" else (a < b)
                return bb if take_b else ab

            st[-1] = pack([one(k) for k in range(n)], w)

    pminmax("pmin", "pmin")
    pminmax("pmax", "pmax")

    def cmpop(name, fn):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn):
            bv = st.pop()
            av = st[-1]

            def one(k):
                a = to_f((av >> (w * k)) & ((1 << w) - 1))
                b = to_f((bv >> (w * k)) & ((1 << w) - 1))
                return (1 << w) - 1 if fn(a, b) else 0

            st[-1] = pack([one(k) for k in range(n)], w)

    cmpop("eq", lambda a, b: a == b)
    cmpop("ne", lambda a, b: a != b)
    cmpop("lt", lambda a, b: a < b)
    cmpop("gt", lambda a, b: a > b)
    cmpop("le", lambda a, b: a <= b)
    cmpop("ge", lambda a, b: a >= b)

    @_reg(f"{px}.splat")
    def splat(st):
        st[-1] = pack([st[-1]] * n, w)


_gen_float_shape("f32x4", 4, 32, bits_to_f32, f32_to_bits, _canon32,
                 F32_CANONICAL_NAN, 0x80000000, 0x7FFFFFFF)
_gen_float_shape("f64x2", 2, 64, bits_to_f64, f64_to_bits, _canon64,
                 F64_CANONICAL_NAN, 1 << 63, (1 << 63) - 1)


# -- conversions ------------------------------------------------------------
def _lane_f32(v, k):
    return bits_to_f32((v >> (32 * k)) & 0xFFFFFFFF)


def _lane_f64(v, k):
    return bits_to_f64((v >> (64 * k)) & MASK64)


def _tsat(x, lo, hi):
    if np.isnan(x):
        return 0
    if x < lo:
        return int(lo)
    if x > hi:
        return int(hi)
    return int(np.trunc(float(x)))


@_reg("i32x4.trunc_sat_f32x4_s")
def trunc_sat_f32_s(st):
    st[-1] = pack([_tsat(_lane_f32(st[-1], k), -(2**31), 2**31 - 1)
                   for k in range(4)], 32)


@_reg("i32x4.trunc_sat_f32x4_u")
def trunc_sat_f32_u(st):
    st[-1] = pack([_tsat(_lane_f32(st[-1], k), 0, 2**32 - 1)
                   for k in range(4)], 32)


@_reg("i32x4.trunc_sat_f64x2_s_zero")
def trunc_sat_f64_s_zero(st):
    st[-1] = pack([_tsat(_lane_f64(st[-1], k), -(2**31), 2**31 - 1)
                   for k in range(2)] + [0, 0], 32)


@_reg("i32x4.trunc_sat_f64x2_u_zero")
def trunc_sat_f64_u_zero(st):
    st[-1] = pack([_tsat(_lane_f64(st[-1], k), 0, 2**32 - 1)
                   for k in range(2)] + [0, 0], 32)


@_reg("f32x4.convert_i32x4_s")
def convert_i32_s(st):
    xs = lanes(st[-1], 4, 32, True)
    st[-1] = pack([f32_to_bits(np.float32(x)) for x in xs], 32)


@_reg("f32x4.convert_i32x4_u")
def convert_i32_u(st):
    xs = lanes(st[-1], 4, 32)
    st[-1] = pack([f32_to_bits(np.float32(x)) for x in xs], 32)


@_reg("f64x2.convert_low_i32x4_s")
def convert_low_s(st):
    xs = lanes(st[-1], 4, 32, True)[:2]
    st[-1] = pack([f64_to_bits(np.float64(x)) for x in xs], 64)


@_reg("f64x2.convert_low_i32x4_u")
def convert_low_u(st):
    xs = lanes(st[-1], 4, 32)[:2]
    st[-1] = pack([f64_to_bits(np.float64(x)) for x in xs], 64)


@_reg("f32x4.demote_f64x2_zero")
def demote_zero(st):
    def one(k):
        with _np_err():
            return _canon32(f32_to_bits(np.float32(_lane_f64(st[-1], k))))

    st[-1] = pack([one(0), one(1), 0, 0], 32)


@_reg("f64x2.promote_low_f32x4")
def promote_low(st):
    def one(k):
        with _np_err():
            return _canon64(f64_to_bits(np.float64(_lane_f32(st[-1], k))))

    st[-1] = pack([one(0), one(1)], 64)


# -- lane extract/replace (lane index via engine a-plane) -------------------
# These need the instruction's lane immediate, so the engine dispatches them
# with the lane; exposed here as parameterized helpers.
def extract_lane(v: int, shape: str, lane: int, signed: bool) -> int:
    """Returns the lane value as a possibly-negative Python int; the engine
    masks it to the destination cell width (i32 vs i64)."""
    n, w = {"i8x16": (16, 8), "i16x8": (8, 16), "i32x4": (4, 32),
            "i64x2": (2, 64), "f32x4": (4, 32), "f64x2": (2, 64)}[shape]
    x = (v >> (w * lane)) & ((1 << w) - 1)
    if signed and x & (1 << (w - 1)):
        x -= 1 << w
    return x


def replace_lane(v: int, shape: str, lane: int, x: int) -> int:
    w = {"i8x16": 8, "i16x8": 16, "i32x4": 32, "i64x2": 64,
         "f32x4": 32, "f64x2": 64}[shape]
    mask = ((1 << w) - 1) << (w * lane)
    return (v & ~mask & MASK128) | ((x & ((1 << w) - 1)) << (w * lane))


def shuffle(a: int, b: int, mask: int) -> int:
    al = lanes(a, 16, 8)
    bl = lanes(b, 16, 8)
    allb = al + bl
    return pack([allb[(mask >> (8 * k)) & 0xFF] for k in range(16)], 8)
