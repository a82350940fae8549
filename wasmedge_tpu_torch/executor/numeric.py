"""Exact-semantics numeric op kernels for the scalar engine.

A copy of `wasmedge_tpu/executor/numeric.py`.

Mirrors the reference's header-inline numeric templates
(WasmEdge include/executor/engine/{binary,unary,cast}_numeric.ipp):
div/rem trap checks, truncation bounds, NaN canonicalization, rounding.
Values are raw 64-bit cells on a Python list stack; floats go through numpy
scalars so f32 arithmetic is correctly rounded (no double rounding).

NaN policy (shared with the batch engine so parity is bit-exact): every
*arithmetic* float op canonicalizes NaN outputs to the positive canonical
NaN; sign-manipulation ops (abs/neg/copysign) and loads/stores/reinterprets
are bit-preserving, as the spec requires.
"""

from __future__ import annotations

import numpy as np

from wasmedge_tpu_torch.common.errors import ErrCode, trap
from wasmedge_tpu_torch.common.opcodes import NAME_TO_ID
from wasmedge_tpu_torch.common.types import (
    F32_CANONICAL_NAN,
    F64_CANONICAL_NAN,
    MASK32,
    MASK64,
    bits_to_f32,
    bits_to_f64,
    f32_to_bits,
    f64_to_bits,
    s32,
    s64,
)

def _np_err():
    return np.errstate(all="ignore")


def _canon32(bits: int) -> int:
    if (bits & 0x7F800000) == 0x7F800000 and (bits & 0x007FFFFF):
        return F32_CANONICAL_NAN
    return bits


def _canon64(bits: int) -> int:
    if (bits & 0x7FF0000000000000) == 0x7FF0000000000000 and (bits & 0x000FFFFFFFFFFFFF):
        return F64_CANONICAL_NAN
    return bits


HANDLERS = {}


def _reg(name):
    def deco(fn):
        HANDLERS[NAME_TO_ID[name]] = fn
        return fn
    return deco


# ---------------------------------------------------------------------------
# integer helpers
# ---------------------------------------------------------------------------

def _idiv_trunc(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _clz(v: int, bits: int) -> int:
    if v == 0:
        return bits
    return bits - v.bit_length()


def _ctz(v: int, bits: int) -> int:
    if v == 0:
        return bits
    return (v & -v).bit_length() - 1


def _rotl(v: int, n: int, bits: int, mask: int) -> int:
    n %= bits
    return ((v << n) | (v >> (bits - n))) & mask


# ---------------------------------------------------------------------------
# i32 / i64 binops — generated pairs
# ---------------------------------------------------------------------------

def _gen_int_ops(px: str, bits: int, mask: int, tos, imin: int):
    def binop(name, fn):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn):
            b = st.pop()
            st[-1] = fn(st[-1], b) & mask

    binop("add", lambda a, b: a + b)
    binop("sub", lambda a, b: a - b)
    binop("mul", lambda a, b: a * b)
    binop("and", lambda a, b: a & b)
    binop("or", lambda a, b: a | b)
    binop("xor", lambda a, b: a ^ b)
    binop("shl", lambda a, b: a << (b % bits))
    binop("shr_u", lambda a, b: a >> (b % bits))
    binop("shr_s", lambda a, b: tos(a) >> (b % bits))
    binop("rotl", lambda a, b: _rotl(a, b, bits, mask))
    binop("rotr", lambda a, b: _rotl(a, bits - (b % bits), bits, mask))

    @_reg(f"{px}.div_u")
    def div_u(st):
        b = st.pop()
        if b == 0:
            trap(ErrCode.DivideByZero)
        st[-1] = (st[-1] // b) & mask

    @_reg(f"{px}.rem_u")
    def rem_u(st):
        b = st.pop()
        if b == 0:
            trap(ErrCode.DivideByZero)
        st[-1] = (st[-1] % b) & mask

    @_reg(f"{px}.div_s")
    def div_s(st):
        b = tos(st.pop())
        a = tos(st[-1])
        if b == 0:
            trap(ErrCode.DivideByZero)
        if a == imin and b == -1:
            trap(ErrCode.IntegerOverflow)
        st[-1] = _idiv_trunc(a, b) & mask

    @_reg(f"{px}.rem_s")
    def rem_s(st):
        b = tos(st.pop())
        a = tos(st[-1])
        if b == 0:
            trap(ErrCode.DivideByZero)
        if a == imin and b == -1:
            st[-1] = 0
        else:
            st[-1] = (a - b * _idiv_trunc(a, b)) & mask

    @_reg(f"{px}.clz")
    def clz(st):
        st[-1] = _clz(st[-1], bits)

    @_reg(f"{px}.ctz")
    def ctz(st):
        st[-1] = _ctz(st[-1], bits)

    @_reg(f"{px}.popcnt")
    def popcnt(st):
        st[-1] = bin(st[-1]).count("1")

    @_reg(f"{px}.eqz")
    def eqz(st):
        st[-1] = 1 if st[-1] == 0 else 0

    def cmpop(name, fn):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn):
            b = st.pop()
            st[-1] = 1 if fn(st[-1], b) else 0

    cmpop("eq", lambda a, b: a == b)
    cmpop("ne", lambda a, b: a != b)
    cmpop("lt_u", lambda a, b: a < b)
    cmpop("gt_u", lambda a, b: a > b)
    cmpop("le_u", lambda a, b: a <= b)
    cmpop("ge_u", lambda a, b: a >= b)
    cmpop("lt_s", lambda a, b: tos(a) < tos(b))
    cmpop("gt_s", lambda a, b: tos(a) > tos(b))
    cmpop("le_s", lambda a, b: tos(a) <= tos(b))
    cmpop("ge_s", lambda a, b: tos(a) >= tos(b))


_gen_int_ops("i32", 32, MASK32, s32, -(2**31))
_gen_int_ops("i64", 64, MASK64, s64, -(2**63))


# ---------------------------------------------------------------------------
# float ops — generated for f32/f64
# ---------------------------------------------------------------------------

def _gen_float_ops(px: str, to_f, to_bits, canon, nan_bits: int,
                   sign_bit: int, abs_mask: int):
    def binop(name, fn):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn):
            b = to_f(st.pop())
            a = to_f(st[-1])
            with _np_err():
                r = fn(a, b)
            st[-1] = canon(to_bits(r))

    binop("add", lambda a, b: a + b)
    binop("sub", lambda a, b: a - b)
    binop("mul", lambda a, b: a * b)
    binop("div", lambda a, b: a / b)

    def _minmax(st, pick_min: bool):
        bb = st.pop()
        ab = st[-1]
        a, b = to_f(ab), to_f(bb)
        if np.isnan(a) or np.isnan(b):
            st[-1] = nan_bits
            return
        if a == b:  # handles +0/-0: min picks the sign-set one
            sa, sb = ab & sign_bit, bb & sign_bit
            if pick_min:
                st[-1] = ab if sa else bb
            else:
                st[-1] = ab if not sa else bb
            return
        take_a = (a < b) == pick_min
        st[-1] = ab if take_a else bb

    @_reg(f"{px}.min")
    def fmin(st):
        _minmax(st, True)

    @_reg(f"{px}.max")
    def fmax(st):
        _minmax(st, False)

    # bit-level sign ops: NO canonicalization
    @_reg(f"{px}.abs")
    def fabs(st):
        st[-1] = st[-1] & abs_mask

    @_reg(f"{px}.neg")
    def fneg(st):
        st[-1] = st[-1] ^ sign_bit

    @_reg(f"{px}.copysign")
    def fcopysign(st):
        b = st.pop()
        st[-1] = (st[-1] & abs_mask) | (b & sign_bit)

    def unop(name, fn):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn):
            with _np_err():
                r = fn(to_f(st[-1]))
            st[-1] = canon(to_bits(r))

    unop("ceil", np.ceil)
    unop("floor", np.floor)
    unop("trunc", np.trunc)
    unop("nearest", np.rint)  # round half to even
    unop("sqrt", np.sqrt)

    def cmpop(name, fn):
        @_reg(f"{px}.{name}")
        def h(st, fn=fn):
            b = to_f(st.pop())
            a = to_f(st[-1])
            st[-1] = 1 if fn(a, b) else 0

    cmpop("eq", lambda a, b: a == b)
    cmpop("ne", lambda a, b: a != b)
    cmpop("lt", lambda a, b: a < b)
    cmpop("gt", lambda a, b: a > b)
    cmpop("le", lambda a, b: a <= b)
    cmpop("ge", lambda a, b: a >= b)


_gen_float_ops("f32", bits_to_f32, f32_to_bits, _canon32, F32_CANONICAL_NAN,
               0x80000000, 0x7FFFFFFF)
_gen_float_ops("f64", bits_to_f64, f64_to_bits, _canon64, F64_CANONICAL_NAN,
               0x8000000000000000, 0x7FFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def _trunc_checked(v, lo: float, hi: float, mask: int):
    """Trapping float->int truncation; (lo, hi) are exclusive float bounds."""
    if np.isnan(v):
        trap(ErrCode.InvalidConvToInt)
    t = float(np.trunc(float(v)))
    if not (lo < t < hi):
        trap(ErrCode.IntegerOverflow)
    return int(t) & mask


def _trunc_sat(v, lo_res: int, hi_res: int, lo: float, hi: float, mask: int):
    if np.isnan(v):
        return 0
    t = float(np.trunc(float(v)))
    if t <= lo:
        return lo_res & mask
    if t >= hi:
        return hi_res & mask
    return int(t) & mask


# Exclusive float bounds per the spec tables. The i64_s low bound is the
# largest double strictly below -2^63, so t > lo accepts -2^63 itself.
_TRUNC_BOUNDS = {
    ("i32", "s"): (-(2.0**31) - 1, 2.0**31),
    ("i32", "u"): (-1.0, 2.0**32),
    ("i64", "s"): (-(2.0**63) * (1 + 2**-52), 2.0**63),
    ("i64", "u"): (-1.0, 2.0**64),
}

_SAT_RANGES = {
    ("i32", "s"): (-(2**31), 2**31 - 1),
    ("i32", "u"): (0, 2**32 - 1),
    ("i64", "s"): (-(2**63), 2**63 - 1),
    ("i64", "u"): (0, 2**64 - 1),
}


def _gen_truncs():
    for ity, mask in (("i32", MASK32), ("i64", MASK64)):
        for fty, to_f in (("f32", bits_to_f32), ("f64", bits_to_f64)):
            for sgn in ("s", "u"):
                lo, hi = _TRUNC_BOUNDS[(ity, sgn)]
                lo_res, hi_res = _SAT_RANGES[(ity, sgn)]

                @_reg(f"{ity}.trunc_{fty}_{sgn}")
                def h(st, to_f=to_f, lo=lo, hi=hi, mask=mask):
                    st[-1] = _trunc_checked(to_f(st[-1]), lo, hi, mask)

                @_reg(f"{ity}.trunc_sat_{fty}_{sgn}")
                def hs(st, to_f=to_f, lo=lo, hi=hi, lo_res=lo_res,
                       hi_res=hi_res, mask=mask):
                    st[-1] = _trunc_sat(to_f(st[-1]), lo_res, hi_res, lo, hi, mask)


_gen_truncs()


@_reg("i32.wrap_i64")
def _wrap(st):
    st[-1] = st[-1] & MASK32


@_reg("i64.extend_i32_s")
def _ext_s(st):
    st[-1] = s32(st[-1]) & MASK64


@_reg("i64.extend_i32_u")
def _ext_u(st):
    st[-1] = st[-1] & MASK32


def _gen_sext():
    for name, bits, mask in (
        ("i32.extend8_s", 8, MASK32), ("i32.extend16_s", 16, MASK32),
        ("i64.extend8_s", 8, MASK64), ("i64.extend16_s", 16, MASK64),
        ("i64.extend32_s", 32, MASK64),
    ):
        @_reg(name)
        def h(st, bits=bits, mask=mask):
            v = st[-1] & ((1 << bits) - 1)
            if v >= (1 << (bits - 1)):
                v -= 1 << bits
            st[-1] = v & mask


_gen_sext()


def _gen_converts():
    # int -> float: single correctly-rounded conversion via numpy C casts
    for name, fn in (
        ("f32.convert_i32_s", lambda v: np.float32(np.int64(s32(v)))),
        ("f32.convert_i32_u", lambda v: np.float32(np.int64(v & MASK32))),
        ("f32.convert_i64_s", lambda v: np.float32(np.int64(s64(v)))),
        ("f32.convert_i64_u", lambda v: np.float32(np.uint64(v & MASK64))),
        ("f64.convert_i32_s", lambda v: np.float64(s32(v))),
        ("f64.convert_i32_u", lambda v: np.float64(v & MASK32)),
        ("f64.convert_i64_s", lambda v: np.float64(np.int64(s64(v)))),
        ("f64.convert_i64_u", lambda v: np.float64(np.uint64(v & MASK64))),
    ):
        to_bits = f32_to_bits if name.startswith("f32") else f64_to_bits

        @_reg(name)
        def h(st, fn=fn, to_bits=to_bits):
            st[-1] = to_bits(fn(st[-1]))


_gen_converts()


@_reg("f32.demote_f64")
def _demote(st):
    with _np_err():
        st[-1] = _canon32(f32_to_bits(np.float32(bits_to_f64(st[-1]))))


@_reg("f64.promote_f32")
def _promote(st):
    st[-1] = _canon64(f64_to_bits(np.float64(bits_to_f32(st[-1]))))


@_reg("i32.reinterpret_f32")
def _ri32(st):
    st[-1] = st[-1] & MASK32


@_reg("i64.reinterpret_f64")
def _ri64(st):
    st[-1] = st[-1] & MASK64


@_reg("f32.reinterpret_i32")
def _rf32(st):
    st[-1] = st[-1] & MASK32


@_reg("f64.reinterpret_i64")
def _rf64(st):
    st[-1] = st[-1] & MASK64
