"""Spec conformance on the batch engine: a wast corpus as a lane workload.

A trimmed copy of `wasmedge_tpu/spec/__init__.py`: its report types,
value matching (NaN classes `nan:canonical` / `nan:arithmetic`, per-lane
classes of float-shaped v128 results) and trap messages, and its batched
runner `run_corpus_batched` over the port's `BatchEngine`, which runs on
the card unless the caller asks for the CPU.  The scalar harness is not
copied.  Matching is strict: the port keeps IEEE binary32 subnormals, so
the reference's allowance for flushed f32 results, and its skip of the
"subnormal" corpus files, are gone.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from wasmedge_tpu_torch.common.configure import Configure, Proposal
from wasmedge_tpu_torch.common.errors import (
    ErrCode, InstantiationError, LoadError, ValidationError)
from wasmedge_tpu_torch.utils.wat import (
    WatError, compile_module_fields, parse_wast)

# ErrCode -> spec trap message (WasmEdge's ErrCodeStr strings, as the
# reference maps them)
TRAP_MESSAGES = {
    ErrCode.DivideByZero: "integer divide by zero",
    ErrCode.IntegerOverflow: "integer overflow",
    ErrCode.InvalidConvToInt: "invalid conversion to integer",
    ErrCode.MemoryOutOfBounds: "out of bounds memory access",
    ErrCode.TableOutOfBounds: "out of bounds table access",
    ErrCode.Unreachable: "unreachable",
    ErrCode.UndefinedElement: "undefined element",
    ErrCode.UninitializedElement: "uninitialized element",
    ErrCode.IndirectCallTypeMismatch: "indirect call type mismatch",
    ErrCode.CallStackExhausted: "call stack exhausted",
    ErrCode.StackOverflow: "call stack exhausted",
    ErrCode.CostLimitExceeded: "cost limit exceeded",
    ErrCode.Terminated: "terminated",
    ErrCode.ExecutionFailed: "generic runtime error",
}

F32_QUIET = 0x00400000
F64_QUIET = 0x0008000000000000


def _is_canonical_nan(bits: int, is32: bool) -> bool:
    if is32:
        return bits & 0x7FFFFFFF == 0x7FC00000
    return bits & 0x7FFFFFFFFFFFFFFF == 0x7FF8000000000000


def _is_arithmetic_nan(bits: int, is32: bool) -> bool:
    if is32:
        return (bits & 0x7F800000) == 0x7F800000 and bits & F32_QUIET
    return (bits & 0x7FF0000000000000) == 0x7FF0000000000000 and \
        bits & F64_QUIET


@dataclasses.dataclass
class SpecFailure:
    script: str
    index: int
    kind: str
    detail: str

    def __str__(self):
        return f"{self.script}[{self.index}] {self.kind}: {self.detail}"


@dataclasses.dataclass
class SpecReport:
    passed: int = 0
    failed: int = 0
    skipped: int = 0
    failures: List[SpecFailure] = dataclasses.field(default_factory=list)


def _match_value(expected, got: int) -> bool:
    """One expected (type, value) of an assert_return against a raw result
    cell, with the spec's NaN classes."""
    ty, want = expected
    if ty == "f32" and want == "nan:canonical":
        return _is_canonical_nan(got & 0xFFFFFFFF, True)
    if ty == "f32" and want == "nan:arithmetic":
        return bool(_is_arithmetic_nan(got & 0xFFFFFFFF, True))
    if ty == "f64" and want == "nan:canonical":
        return _is_canonical_nan(got, False)
    if ty == "f64" and want == "nan:arithmetic":
        return bool(_is_arithmetic_nan(got, False))
    if ty == "v128" and isinstance(want, tuple):
        # float-shape expected with per-lane NaN classes
        shape, lanes = want
        w = 32 if shape == "f32x4" else 64
        mask = (1 << w) - 1
        for k, ln in enumerate(lanes):
            lane_got = (got >> (w * k)) & mask
            if ln == "nan:canonical":
                if not _is_canonical_nan(lane_got, w == 32):
                    return False
            elif ln == "nan:arithmetic":
                if not _is_arithmetic_nan(lane_got, w == 32):
                    return False
            elif lane_got != ln:
                return False
        return True
    if ty == "v128":
        return (got & ((1 << 128) - 1)) == want
    if ty == "i32" or ty == "f32":
        return (got & 0xFFFFFFFF) == want
    return got == want


def _trap_matches(code: int, message: str) -> bool:
    msg = TRAP_MESSAGES.get(ErrCode(code), "")
    return not message or bool(msg and (
        msg.startswith(message) or message.startswith(msg.split(" ")[0])))


def run_corpus_batched(paths, device="cuda",
                       conf: Optional[Configure] = None) -> SpecReport:
    """Run the batchable subset of the corpus, one assertion per LANE:
    every module's assert_return / assert_trap commands on one export are
    stacked into a lane batch and run in one `BatchEngine.run` on
    `device`, then checked lane by lane.  Skipped: commands other than
    those two, assertions with v128 arguments or results (the entry
    cells carry 64 bits), modules that hold state across invocations
    (memories, globals, and tables that the module mutates, outside the
    `*_batch.wast` files, whose assertions are written to be independent
    of one another: the reference runner's rule,
    wasmedge_tpu/spec/__init__.py:405-424) and modules the batch engine
    does not run.  Each file runs with the reference's proposals for it
    (the tail-call proposal for the tail-call files).  `conf`: the batch
    knobs to run with, as the reference's `conf` (a copy is taken;
    `steps_per_launch` is set to 100,000; None: `Configure()`), for
    example deeper stacks for call.wast's `even(1000)`.  On the card, the
    kernels of all the modules are built at once before the first run."""
    rep = SpecReport()
    modules = list(_batch_modules(paths, device, rep, conf))
    if any(eng.device.type == "cuda" for _, eng, _, _ in modules):
        from wasmedge_tpu_torch.batch.interp import build_kernels

        build_kernels([eng.tables for _, eng, _, _ in modules])
    for path, eng, inst, by_field in modules:
        for field, items in by_field.items():
            _run_field(rep, path, eng, inst, field, items)
    return rep


def corpus_tables(paths, conf: Optional[Configure] = None) -> list:
    """The code tables (CPU) of the corpus modules `run_corpus_batched`
    runs with `conf`, for building their kernels ahead of the run."""
    return [eng.tables for _, eng, _, _ in
            _batch_modules(paths, "cpu", SpecReport(), conf)]


# ops whose modules hold table state across invocations (the reference
# runner's _TMUT)
_TABLE_MUTATORS = ("table.set", "table.grow", "table.fill", "table.copy",
                   "table.init", "elem.drop")


def conf_for_file(path) -> Configure:
    """The proposals a corpus file runs with, as the reference's
    proposal test directories run (wasmedge_tpu/spec/__init__.py
    `_conf_for_file`): tail calls for the tail-call files, multiple
    memories for the multi-memory ones."""
    import os

    conf = Configure()
    name = os.path.basename(str(path))
    if "tail_call" in name:
        conf.add_proposal(Proposal.TailCall)
    if "multi_memory" in name:
        conf.add_proposal(Proposal.MultiMemories)
    return conf


def _batch_modules(paths, device, rep, conf=None):
    """(path, engine, instance, {export: [(index, command)]}) for each
    module of the corpus with batchable assertions; skips and failures of
    parsing and set-up are counted in `rep`."""
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.executor.instantiate import instantiate
    from wasmedge_tpu_torch.loader import Loader
    from wasmedge_tpu_torch.runtime.store import StoreManager
    from wasmedge_tpu_torch.validator import Validator

    from wasmedge_tpu_torch.common.opcodes import NAME_TO_ID

    base = copy.deepcopy(conf) if conf is not None else Configure()
    base.batch.steps_per_launch = 100_000
    mutators = {NAME_TO_ID[n] for n in _TABLE_MUTATORS}
    for path in paths:
        conf = copy.deepcopy(base)
        for p in conf_for_file(path).proposals:
            conf.add_proposal(p)
        with open(path) as f:
            src = f.read()
        try:
            cmds = parse_wast(src)
        except WatError as e:
            rep.failed += 1
            rep.failures.append(SpecFailure(str(path), -1, "parse", str(e)))
            continue
        # segment commands by module
        module_cmds: List[tuple] = []   # (fields, [(idx, cmd)...])
        cur: Optional[list] = None
        for idx, cmd in enumerate(cmds):
            if cmd.kind == "module":
                cur = []
                module_cmds.append((cmd.fields, cur))
            elif cmd.kind in ("assert_return", "assert_trap") and \
                    cur is not None and cmd.action[0] == "invoke":
                cur.append((idx, cmd))
            else:
                rep.skipped += 1
        for fields, asserts in module_cmds:
            if not asserts:
                continue
            try:
                data = compile_module_fields(fields)
                mod = Validator(conf).validate(
                    Loader(conf).parse_module(data))
                store = StoreManager()
                inst = instantiate(store, mod, conf)
                ops = inst.lowered.op[:inst.lowered.code_len]
                mutates_table = any(int(o) in mutators for o in ops)
                if inst.memories or inst.globals or (
                        mutates_table
                        and not str(path).endswith("_batch.wast")):
                    rep.skipped += len(asserts)
                    continue
                by_field: Dict[str, list] = {}
                for idx, cmd in asserts:
                    if any(a[0] == "v128" for a in cmd.action[3]) or \
                            any(e[0] == "v128"
                                for e in (getattr(cmd, "expected", None)
                                          or [])):
                        rep.skipped += 1  # the 64-bit entry cells
                        continue
                    by_field.setdefault(cmd.action[2], []).append(
                        (idx, cmd))
                if not by_field:
                    continue
                lanes = max(len(v) for v in by_field.values())
                eng = BatchEngine(inst, store=store, conf=conf,
                                  lanes=lanes, device=device)
            except (ValueError, NotImplementedError, LoadError,
                    ValidationError, InstantiationError):
                # not batchable, not in this slice, or a module that
                # needs `register`ed imports
                rep.skipped += len(asserts)
                continue
            except Exception as e:  # noqa: BLE001
                rep.failed += len(asserts)
                rep.failures.append(SpecFailure(
                    str(path), asserts[0][0], "setup",
                    f"module setup raised {type(e).__name__}: {e}"))
                continue
            yield str(path), eng, inst, by_field


def _run_field(rep, path, eng, inst, field, items):
    """One export's assertions as the lanes of one run."""
    nargs = len(inst.funcs[inst.exports[field][1]].functype.params)
    args = np.zeros((max(nargs, 1), eng.lanes), np.int64)
    for li in range(eng.lanes):
        _, cmd = items[min(li, len(items) - 1)]
        for k, a in enumerate(cmd.action[3]):
            v = a[1]
            args[k, li] = v - 2**64 if v >= 2**63 else v
    try:
        res = eng.run(field, [args[k] for k in range(nargs)],
                      max_steps=2_000_000)
    except Exception as e:  # noqa: BLE001
        rep.failed += len(items)
        rep.failures.append(SpecFailure(
            path, items[0][0], "batch_run",
            f"{field}: {type(e).__name__}: {e}"))
        return
    for li, (idx, cmd) in enumerate(items):
        trap = int(res.trap[li])
        if cmd.kind == "assert_return":
            if trap != -1:
                rep.failed += 1
                rep.failures.append(SpecFailure(
                    path, idx, "assert_return",
                    f"{field} lane {li} trapped {trap}"))
                continue
            got = [int(r[li]) & (2**64 - 1) for r in res.results]
            exp = cmd.expected
            if len(got) == len(exp) and all(
                    _match_value(e, g) for e, g in zip(exp, got)):
                rep.passed += 1
            else:
                rep.failed += 1
                rep.failures.append(SpecFailure(
                    path, idx, "assert_return",
                    f"{field} lane {li} -> {[hex(g) for g in got]}, "
                    f"want {exp}"))
        elif trap > 0 and _trap_matches(trap, cmd.message):
            rep.passed += 1
        else:
            rep.failed += 1
            rep.failures.append(SpecFailure(
                path, idx, "assert_trap",
                f"{field} lane {li} ended with {trap}, want "
                f"{cmd.message!r}"))
