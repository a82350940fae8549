"""Value types and size limits (a trimmed copy of the reference's
`common/types.py`).

Values are untyped 64-bit cells once the validator has proven types:
the scalar engine holds each as a Python int with the raw little-endian
bit pattern (i32/f32 in the low 32 bits, v128 as a 128-bit int, refs as
index+1 with 0 = null); the batch engine holds each as two int32 planes
(lo, hi) per stack slot.
"""

from __future__ import annotations

import enum
import struct

import numpy as np


class ValType(enum.IntEnum):
    I32 = 0x7F
    I64 = 0x7E
    F32 = 0x7D
    F64 = 0x7C
    V128 = 0x7B
    FuncRef = 0x70
    ExternRef = 0x6F

    @property
    def is_num(self) -> bool:
        return self in (ValType.I32, ValType.I64, ValType.F32, ValType.F64)

    @property
    def is_ref(self) -> bool:
        return self in (ValType.FuncRef, ValType.ExternRef)


# Signature chars used in the opcode table <-> ValType
SIG_CHAR_TO_VALTYPE = {
    "i": ValType.I32,
    "I": ValType.I64,
    "f": ValType.F32,
    "F": ValType.F64,
    "V": ValType.V128,
    "r": ValType.FuncRef,
    "e": ValType.ExternRef,
}

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def s32(x: int) -> int:
    x &= MASK32
    return x - (1 << 32) if x >= (1 << 31) else x


def s64(x: int) -> int:
    x &= MASK64
    return x - (1 << 64) if x >= (1 << 63) else x


def f32_to_bits(v) -> int:
    return struct.unpack("<I", struct.pack("<f", float(np.float32(v))))[0]


def bits_to_f32(b: int) -> np.float32:
    return np.float32(struct.unpack("<f", struct.pack("<I", b & MASK32))[0])


def f64_to_bits(v: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", float(v)))[0]


def bits_to_f64(b: int) -> np.float64:
    return np.float64(struct.unpack("<d", struct.pack("<Q", b & MASK64))[0])


# the NaNs the scalar engine's float ops canonicalise to
F32_CANONICAL_NAN = 0x7FC00000
F64_CANONICAL_NAN = 0x7FF8000000000000


def typed_to_bits(ty: ValType, v) -> int:
    """Typed Python/numpy value -> raw cell (64-bit; v128 is 128-bit)."""
    if ty == ValType.I32:
        return int(v) & MASK32
    if ty in (ValType.I64, ValType.FuncRef, ValType.ExternRef):
        return int(v) & MASK64
    if ty == ValType.F32:
        return f32_to_bits(v)
    if ty == ValType.F64:
        return f64_to_bits(v)
    if ty == ValType.V128:
        return int(v) & ((1 << 128) - 1)
    raise ValueError(f"unsupported type {ty}")


def bits_to_typed(ty: ValType, b: int):
    """Raw cell -> typed value (ints are signed, floats numpy, v128 raw)."""
    if ty == ValType.I32:
        return s32(b)
    if ty == ValType.I64:
        return s64(b)
    if ty == ValType.F32:
        return bits_to_f32(b)
    if ty == ValType.F64:
        return bits_to_f64(b)
    if ty == ValType.V128:
        return b & ((1 << 128) - 1)
    if ty.is_ref:
        return b & MASK64
    raise ValueError(f"unsupported type {ty}")


_NAME_TO_VALTYPE = {
    "i32": ValType.I32, "i64": ValType.I64, "f32": ValType.F32,
    "f64": ValType.F64, "v128": ValType.V128,
    "funcref": ValType.FuncRef, "externref": ValType.ExternRef,
}


def to_valtype(x) -> ValType:
    """Coerce a ValType, spec name string, or raw byte to ValType."""
    if isinstance(x, ValType):
        return x
    if isinstance(x, str):
        return _NAME_TO_VALTYPE[x]
    return ValType(x)


PAGE_SIZE = 65536
MAX_MEMORY_PAGES = 65536  # 4 GiB / 64 KiB (reference: validator.h:71)
