"""Error codes and exception model.

Mirrors the reference's ErrCode enum and Expect<T> discipline
(WasmEdge include/common/enum.inc:573-749, include/common/errcode.h):
every failure carries a stable ErrCode plus a human message. In Python we
raise. Trap codes double
as the per-lane trap values the batch engine stores in device state.
"""

from __future__ import annotations

import enum


class ErrCode(enum.IntEnum):
    Success = 0x00
    Terminated = 0x01  # stopped by user / StopToken

    # Load phase
    IllegalPath = 0x20
    ReadError = 0x21
    UnexpectedEnd = 0x22
    MalformedMagic = 0x23
    MalformedVersion = 0x24
    MalformedSection = 0x25
    SectionSizeMismatch = 0x26
    LengthOutOfBounds = 0x27
    JunkSection = 0x28
    IncompatibleFuncCode = 0x29
    IncompatibleDataCount = 0x2A
    DataCountRequired = 0x2B
    MalformedImportKind = 0x2C
    MalformedExportKind = 0x2D
    ExpectedZeroByte = 0x2E
    InvalidMut = 0x2F
    TooManyLocals = 0x30
    MalformedValType = 0x31
    MalformedElemType = 0x32
    MalformedRefType = 0x33
    MalformedUTF8 = 0x34
    IntegerTooLarge = 0x35
    IntegerTooLong = 0x36
    IllegalOpCode = 0x37
    IllegalGrammar = 0x38

    # Validation phase
    InvalidAlignment = 0x40
    TypeCheckFailed = 0x41
    InvalidLabelIdx = 0x42
    InvalidLocalIdx = 0x43
    InvalidFuncTypeIdx = 0x44
    InvalidFuncIdx = 0x45
    InvalidTableIdx = 0x46
    InvalidMemoryIdx = 0x47
    InvalidGlobalIdx = 0x48
    InvalidElemIdx = 0x49
    InvalidDataIdx = 0x4A
    InvalidRefIdx = 0x4B
    ConstExprRequired = 0x4C
    DupExportName = 0x4D
    ImmutableGlobal = 0x4E
    InvalidResultArity = 0x4F
    MultiTables = 0x50
    MultiMemories = 0x51
    InvalidLimit = 0x52
    InvalidMemPages = 0x53
    InvalidStartFunc = 0x54
    InvalidLaneIdx = 0x55

    # Instantiation phase
    ModuleNameConflict = 0x60
    IncompatibleImportType = 0x61
    UnknownImport = 0x62
    DataSegDoesNotFit = 0x63
    ElemSegDoesNotFit = 0x64

    # Execution phase (trap codes — these live in device lane state too)
    WrongInstanceAddress = 0x80
    WrongInstanceIndex = 0x81
    InstrTypeMismatch = 0x82
    FuncSigMismatch = 0x83
    DivideByZero = 0x84
    IntegerOverflow = 0x85
    InvalidConvToInt = 0x86
    TableOutOfBounds = 0x87
    MemoryOutOfBounds = 0x88
    Unreachable = 0x89
    UninitializedElement = 0x8A
    UndefinedElement = 0x8B
    IndirectCallTypeMismatch = 0x8C
    HostFuncFailed = 0x8D
    RefTypeMismatch = 0x8E
    UnalignedAtomicAccess = 0x8F
    CallStackExhausted = 0x90
    StackOverflow = 0x91
    CostLimitExceeded = 0x92  # gas / fuel exhausted
    WrongVMWorkflow = 0x93
    FuncNotFound = 0x94
    ExecutionFailed = 0x95
    NotValidated = 0x96
    # Static-analysis admission: a module's static bounds exceed the
    # registering tenant's policy (wasmedge_tpu/analysis/policy.py).
    # Gateway maps it to HTTP 400 with the violation list in the body.
    StaticPolicyViolation = 0x97


# Spec-test-compatible trap messages (the conformance harness matches these,
# reference: lib/common/errinfo.cpp + test/spec/spectest.cpp:150-210).
TRAP_MESSAGES = {
    ErrCode.DivideByZero: "integer divide by zero",
    ErrCode.IntegerOverflow: "integer overflow",
    ErrCode.InvalidConvToInt: "invalid conversion to integer",
    ErrCode.TableOutOfBounds: "out of bounds table access",
    ErrCode.MemoryOutOfBounds: "out of bounds memory access",
    ErrCode.Unreachable: "unreachable",
    ErrCode.UninitializedElement: "uninitialized element",
    ErrCode.UndefinedElement: "undefined element",
    ErrCode.IndirectCallTypeMismatch: "indirect call type mismatch",
    ErrCode.CallStackExhausted: "call stack exhausted",
    ErrCode.CostLimitExceeded: "cost limit exceeded",
    ErrCode.FuncSigMismatch: "function signature mismatch",
}


class WasmError(Exception):
    """Base for all phase errors; carries an ErrCode and an ErrInfo record
    chain (reference: include/common/errinfo.h:1-299 — context records
    attached as the error unwinds).

    `retryable` is the machine-readable half of the rejection contract:
    True means the SAME request can succeed later (transient
    backpressure: QueueSaturated sets it), False means retrying verbatim
    can never help (traps, permanent admission blocks, deadline expiry).
    The gateway maps it onto HTTP 429 / 503 against a terminal status."""

    retryable: bool = False

    def __init__(self, code: ErrCode, msg: str = "", offset: int | None = None):
        self.code = ErrCode(code)
        self.offset = offset
        self.records: list = []
        text = msg or TRAP_MESSAGES.get(self.code, self.code.name)
        if offset is not None:
            text = f"{text} (at byte offset 0x{offset:x})"
            from wasmedge_tpu_torch.common.errinfo import InfoLoading

            self.records.append(InfoLoading(offset))
        super().__init__(text)

    def with_info(self, *records) -> "WasmError":
        """Append context records; returns self (usable in `raise`)."""
        self.records.extend(records)
        return self

    def formatted(self) -> str:
        from wasmedge_tpu_torch.common.errinfo import format_records

        text = str(self)
        if self.records:
            text += "\n" + format_records(self.records)
        return text


class LoadError(WasmError):
    pass


class ValidationError(WasmError):
    pass


class InstantiationError(WasmError):
    pass


class TrapError(WasmError):
    """Runtime trap: unwinds execution, maps 1:1 to a per-lane trap code."""


class EngineFailure(WasmError):
    """Supervised batch execution exhausted its retry budget and its
    engine-degradation ladder (batch/supervisor.py), or a server its
    retries (serve/server.py).  Carries the structured FailureRecord list
    of everything that was attempted, so callers can export the incident
    taxonomy."""

    def __init__(self, msg: str = "", failures=()):
        super().__init__(ErrCode.ExecutionFailed, msg or
                         "supervised execution exhausted retries")
        self.failures = list(failures)


def trap(code: ErrCode, msg: str = ""):
    raise TrapError(code, msg)


def rejection_info(exc: BaseException) -> dict:
    """Structured machine-readable view of a rejection: the stable ErrCode
    value and name, the retryable flag, an optional retry-after hint and
    sub-taxonomy `detail`, and the human message (clients must never
    parse it).  Any other exception maps to ExecutionFailed,
    non-retryable, so that every failure path yields the same shape."""
    if isinstance(exc, WasmError):
        out = {
            "code": int(exc.code),
            "name": exc.code.name,
            "retryable": bool(getattr(exc, "retryable", False)),
            "message": str(exc),
        }
        after = getattr(exc, "retry_after_s", None)
        if after is not None:
            out["retry_after_s"] = float(after)
        detail = getattr(exc, "detail", None)
        if detail:
            # a stable token inside one ErrCode (a pruned async id is
            # NotFound like an unknown one, "shed" marks load shedding)
            out["detail"] = str(detail)
        return out
    return {
        "code": int(ErrCode.ExecutionFailed),
        "name": ErrCode.ExecutionFailed.name,
        "retryable": False,
        "message": f"{type(exc).__name__}: {exc}",
    }
