"""Spec conformance: a wast corpus on the host's scalar engine and the card.

A copy of `wasmedge_tpu/spec/__init__.py` (after WasmEdge's SpecTest
runner, test/spec/spectest.cpp): its report types, value matching (NaN
classes `nan:canonical` / `nan:arithmetic`, per-lane classes of
float-shaped v128 results) and trap messages, and its two runners:

- the scalar harness: `SpecTest.run_script` owns the command semantics
  (module, module_quote, register, action, assert_return, assert_trap,
  assert_exhaustion, assert_invalid, assert_malformed,
  assert_unlinkable) and hands every engine interaction to callbacks;
  `make_engine_callbacks` drives the loader, validator and `Executor`
  with the scalar engine on the host, and `run_corpus` runs files through
  it, a fresh store per file;
- `run_corpus_batched`, one assertion per lane over the port's
  `BatchEngine`, which runs on the card unless the caller asks for the
  CPU.  Its matching is strict: the port keeps IEEE binary32 subnormals,
  so the reference's allowance for flushed f32 results, and its skip of
  the "subnormal" corpus files, are gone.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from wasmedge_tpu_torch.common.configure import Configure, Proposal
from wasmedge_tpu_torch.common.errors import (
    ErrCode, InstantiationError, LoadError, TrapError, ValidationError)
from wasmedge_tpu_torch.utils.wat import (
    WatError, compile_module_fields, parse_wast, parse_wat)

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
    # instantiation and link failures the official suite asserts by message
    ErrCode.DataSegDoesNotFit: "out of bounds memory access",
    ErrCode.ElemSegDoesNotFit: "out of bounds table access",
    ErrCode.UnknownImport: "unknown import",
    ErrCode.IncompatibleImportType: "incompatible import type",
    ErrCode.ModuleNameConflict: "module name conflict",
    ErrCode.FuncSigMismatch: "indirect call type mismatch",
    ErrCode.CostLimitExceeded: "cost limit exceeded",
    ErrCode.Terminated: "terminated",
    ErrCode.ExecutionFailed: "generic runtime error",
    ErrCode.RefTypeMismatch: "reference type mismatch",
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

    def merge(self, other: "SpecReport"):
        self.passed += other.passed
        self.failed += other.failed
        self.skipped += other.skipped
        self.failures.extend(other.failures)


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


class SpecTest:
    """Callback-seam script runner (WasmEdge test/spec/spectest.h).

    Callbacks:
      on_module(name, data)   compile+instantiate binary; returns handle
      on_invoke(handle, field, raw_args) -> raw result cells
      on_register(handle, as_name)
    Raise LoadError/ValidationError/TrapError to signal phase failures.
    """

    def __init__(self, on_module: Callable, on_invoke: Callable,
                 on_register: Optional[Callable] = None):
        self.on_module = on_module
        self.on_invoke = on_invoke
        self.on_register = on_register

    def run_script(self, src: str, script_name: str = "script") -> SpecReport:
        rep = SpecReport()
        try:
            cmds = parse_wast(src)
        except WatError as e:
            rep.failed += 1
            rep.failures.append(SpecFailure(script_name, -1, "parse",
                                            str(e)))
            return rep
        current = None
        named: Dict[str, object] = {}

        def handle_of(mod):
            return named[mod] if mod else current

        for idx, cmd in enumerate(cmds):
            try:
                if cmd.kind in ("module", "module_binary", "module_quote"):
                    if cmd.kind == "module":
                        data = compile_module_fields(cmd.fields)
                    elif cmd.kind == "module_quote":
                        data = parse_wat(cmd.text)
                    else:
                        data = cmd.data
                    current = self.on_module(cmd.name, data)
                    if cmd.name:
                        named[cmd.name] = current
                    rep.passed += 1
                elif cmd.kind == "register":
                    if self.on_register is None:
                        rep.skipped += 1
                        continue
                    self.on_register(handle_of(cmd.mod), cmd.as_name)
                    rep.passed += 1
                elif cmd.kind == "action":
                    akind, mod, name, args = cmd.action
                    self.on_invoke(handle_of(mod), name,
                                   [a[1] for a in args])
                    rep.passed += 1
                elif cmd.kind == "assert_return":
                    akind, mod, name, args = cmd.action
                    got = self.on_invoke(handle_of(mod), name,
                                         [a[1] for a in args])
                    exp = cmd.expected
                    ok = len(got) == len(exp) and all(
                        _match_value(e, g) for e, g in zip(exp, got))
                    if ok:
                        rep.passed += 1
                    else:
                        rep.failed += 1
                        rep.failures.append(SpecFailure(
                            script_name, idx, "assert_return",
                            f"{name}{[a[1] for a in args]} -> "
                            f"{[hex(g) for g in got]}, want "
                            f"{[(e[0], e[1] if isinstance(e[1], str) else hex(e[1])) for e in exp]}"))
                elif cmd.kind in ("assert_trap", "assert_exhaustion"):
                    akind, mod, name, args = cmd.action
                    try:
                        self.on_invoke(handle_of(mod), name,
                                       [a[1] for a in args])
                        rep.failed += 1
                        rep.failures.append(SpecFailure(
                            script_name, idx, cmd.kind,
                            f"{name} did not trap (want {cmd.message!r})"))
                    except TrapError as te:
                        if _trap_matches(te.code, cmd.message):
                            rep.passed += 1
                        else:
                            rep.failed += 1
                            rep.failures.append(SpecFailure(
                                script_name, idx, cmd.kind,
                                f"{name} trapped {te.code!r} "
                                f"({TRAP_MESSAGES.get(te.code, '')!r}), "
                                f"want {cmd.message!r}"))
                elif cmd.kind in ("assert_invalid", "assert_malformed",
                                  "assert_unlinkable"):
                    want = {"assert_invalid": ValidationError,
                            "assert_malformed": LoadError,
                            "assert_unlinkable": Exception}[cmd.kind]
                    try:
                        if cmd.form == "binary":
                            data = cmd.data
                        elif cmd.form == "quote":
                            data = parse_wat(cmd.text)
                        else:
                            data = compile_module_fields(cmd.fields)
                        self.on_module(None, data)
                        rep.failed += 1
                        rep.failures.append(SpecFailure(
                            script_name, idx, cmd.kind,
                            f"module accepted (want {cmd.message!r})"))
                    except WatError:
                        # text-level rejection satisfies malformed/invalid
                        rep.passed += 1
                    except want:
                        rep.passed += 1
                    except (LoadError, ValidationError) as e:
                        # wrong phase
                        rep.failed += 1
                        rep.failures.append(SpecFailure(
                            script_name, idx, cmd.kind,
                            f"wrong phase: {type(e).__name__}: {e}"))
                else:
                    rep.skipped += 1
            except Exception as e:  # noqa: BLE001 — each command isolated
                rep.failed += 1
                rep.failures.append(SpecFailure(
                    script_name, idx, cmd.kind,
                    f"{type(e).__name__}: {e}"))
        return rep


def make_engine_callbacks(conf: Optional[Configure] = None) -> SpecTest:
    """A SpecTest whose callbacks stage each module through the loader,
    validator and `Executor` (start functions and imports included) into
    one store, and invoke exports on the scalar engine on the host."""
    from wasmedge_tpu_torch.executor import Executor
    from wasmedge_tpu_torch.loader import Loader
    from wasmedge_tpu_torch.runtime.store import StoreManager
    from wasmedge_tpu_torch.validator import Validator

    conf = conf or Configure()
    store = StoreManager()
    ex = Executor(conf)

    def on_module(name, data):
        mod = Validator(conf).validate(Loader(conf).parse_module(data))
        return ex.instantiate(store, mod, name=name or "")

    def on_invoke(inst, field, raw_args):
        fi = inst.find_func(field)
        if fi is None:
            raise TrapError(ErrCode.FuncNotFound, f"no export {field}")
        return ex.invoke_raw(store, fi, list(raw_args))

    def on_register(inst, as_name):
        inst.name = as_name
        store.register_named(inst)

    return SpecTest(on_module, on_invoke, on_register)


# passed per file of tests/spec on the scalar harness (`run_corpus`), with
# 0 failed and 0 skipped; the JAX package's scalar harness gives the same
SCALAR_CORPUS_COUNTS = {
    "bulk_memory.wast": 159, "call.wast": 19, "call_gen.wast": 308,
    "control.wast": 25, "control_gen.wast": 325, "conversions.wast": 57,
    "errors.wast": 19, "f32.wast": 979, "f32_subnormal.wast": 163,
    "f64.wast": 1141, "float.wast": 64, "globals.wast": 15,
    "i32.wast": 1485, "i64.wast": 1499, "memory.wast": 64,
    "numeric_conversions.wast": 1005, "official_style.wast": 26,
    "ref_types.wast": 19, "simd.wast": 2594, "table.wast": 63,
    "table_batch.wast": 68, "tail_call.wast": 17,
    "tail_call_batch.wast": 21,
}


def run_corpus(paths) -> SpecReport:
    """Run .wast files through the scalar engine on the host, each with
    its proposals (`conf_for_file`) and a fresh store; every command
    counts, nothing is skipped for being stateful."""
    total = SpecReport()
    for path in paths:
        st = make_engine_callbacks(conf_for_file(path))
        with open(path) as f:
            src = f.read()
        total.merge(st.run_script(src, script_name=str(path)))
    return total


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
    from wasmedge_tpu_torch.executor import Executor
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
                inst = Executor(conf).instantiate(store, mod)
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
