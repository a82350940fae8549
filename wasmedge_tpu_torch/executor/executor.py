"""Executor front door: instantiation + invocation.

A copy of `wasmedge_tpu/executor/executor.py` without the native C++
engine.  It mirrors WasmEdge's Executor (lib/executor/executor.cpp and
lib/executor/instantiate/*.cpp): section-by-section instantiation in spec
order (imports of all four kinds with their limits checked -> functions
-> tables -> memories -> globals (init exprs) -> exports -> element
segments -> data segments -> registration -> start function), and
`invoke` with parameter count checking on the scalar engine
(`executor/engine.py`), which runs on the host.  The card's entry point
is `VM.execute_batch`, which builds its device image from the instance
this leaves: imported memory, table and globals, and whatever the start
function wrote.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import (
    ErrCode, InstantiationError, TrapError, WasmError)
from wasmedge_tpu_torch.common.opcodes import Op
from wasmedge_tpu_torch.common.statistics import Statistics
from wasmedge_tpu_torch.common.types import bits_to_typed, typed_to_bits
from wasmedge_tpu_torch.executor import engine as scalar_engine
from wasmedge_tpu_torch.loader import ast
from wasmedge_tpu_torch.runtime.hostfunc import ImportObject
from wasmedge_tpu_torch.runtime.instance import (
    DataInstance, ElementInstance, FunctionInstance, GlobalInstance,
    MemoryInstance, ModuleInstance, TableInstance)
from wasmedge_tpu_torch.runtime.store import StoreManager


def _limits_match(provided_min, provided_max, required_min, required_max) -> bool:
    """Import limit matching per spec: provided range within required."""
    if provided_min < required_min:
        return False
    if required_max is not None:
        if provided_max is None or provided_max > required_max:
            return False
    return True


class StopToken:
    """Interruption token polled at calls and branches (WasmEdge
    include/executor/executor.h, lib/executor/helper.cpp).  Truthiness is
    the poll, so the engine's `if thread.stop_token:` works whether it
    holds a plain bool or this shared token.  One token per execution: a
    stale stop() cannot poison later runs, and cancelling one async handle
    does not terminate its siblings."""

    __slots__ = ("_flag",)

    def __init__(self):
        self._flag = False

    def stop(self):
        self._flag = True

    def __bool__(self) -> bool:
        return self._flag


class Executor:
    def __init__(self, conf: Optional[Configure] = None,
                 stat: Optional[Statistics] = None):
        self.conf = conf or Configure()
        self.stat = stat
        self._active_tokens: set = set()
        self._token_lock = threading.Lock()

    def stop(self):
        """Interrupt every execution currently in flight (WasmEdge
        Executor::stop; here fan-out because tokens are per-execution)."""
        with self._token_lock:
            for t in self._active_tokens:
                t.stop()

    # ------------------------------------------------------------------
    # Instantiation
    # ------------------------------------------------------------------
    def register_import_object(self, store: StoreManager, impobj: ImportObject):
        """Host module -> named ModuleInstance exporting its functions,
        tables, memories and globals (WasmEdge lib/vm/vm.cpp)."""
        mod = ast.Module()
        mod.validated = True
        inst = ModuleInstance(impobj.name, mod)
        for name, hf in impobj.funcs.items():
            inst.exports[name] = (0, len(inst.funcs))
            inst.funcs.append(FunctionInstance("host", hf.functype,
                                               module=inst, host=hf))
        for name, tab in impobj.tables.items():
            inst.exports[name] = (1, len(inst.tables))
            inst.tables.append(tab)
        for name, mem in impobj.memories.items():
            inst.exports[name] = (2, len(inst.memories))
            inst.memories.append(mem)
        for name, glob in impobj.globals.items():
            inst.exports[name] = (3, len(inst.globals))
            inst.globals.append(glob)
        store.register_named(inst)
        return inst

    def register_module(self, store: StoreManager, mod: ast.Module, name: str):
        if store.find_module(name) is not None:
            raise InstantiationError(ErrCode.ModuleNameConflict, name)
        inst = self.instantiate(store, mod, name)
        store.register_named(inst)
        return inst

    def instantiate(self, store: StoreManager, mod: ast.Module,
                    name: str = "") -> ModuleInstance:
        if not mod.validated or mod.lowered is None:
            raise WasmError(ErrCode.NotValidated, "module not validated")
        inst = ModuleInstance(name, mod)

        # Imports (WasmEdge lib/executor/instantiate/import.cpp).
        for im in mod.imports:
            src = store.find_module(im.module)
            if src is None:
                raise InstantiationError(ErrCode.UnknownImport,
                                         f"{im.module}.{im.name}: unknown module")
            ex = src.exports.get(im.name)
            if ex is None or ex[0] != im.kind:
                raise InstantiationError(ErrCode.UnknownImport,
                                         f"{im.module}.{im.name}")
            kind, idx = ex
            if kind == 0:
                fi = src.funcs[idx]
                want = mod.types[im.type_idx]
                if fi.functype != want:
                    raise InstantiationError(ErrCode.IncompatibleImportType,
                                             f"{im.module}.{im.name}")
                inst.funcs.append(fi)
            elif kind == 1:
                tab = src.tables[idx]
                tt = im.table_type
                if tab.ref_type != tt.ref_type or not _limits_match(
                        tab.size, tab.max, tt.limit.min, tt.limit.max):
                    raise InstantiationError(ErrCode.IncompatibleImportType,
                                             f"{im.module}.{im.name}")
                inst.tables.append(tab)
            elif kind == 2:
                mem = src.memories[idx]
                mt = im.memory_type
                if not _limits_match(mem.pages, mem.max, mt.limit.min, mt.limit.max):
                    raise InstantiationError(ErrCode.IncompatibleImportType,
                                             f"{im.module}.{im.name}")
                inst.memories.append(mem)
            else:
                glob = src.globals[idx]
                gt = im.global_type
                if glob.type.val_type != gt.val_type or glob.type.mutable != gt.mutable:
                    raise InstantiationError(ErrCode.IncompatibleImportType,
                                             f"{im.module}.{im.name}")
                inst.globals.append(glob)

        # Local functions.
        nimp = mod.num_imported_funcs
        for li in range(len(mod.functions)):
            fidx = nimp + li
            inst.funcs.append(FunctionInstance(
                "wasm", mod.func_type_of(fidx), module=inst, func_idx=fidx))

        # Tables and memories.
        for tt in mod.tables:
            inst.tables.append(TableInstance(tt))
        for mt in mod.memories:
            inst.memories.append(
                MemoryInstance(mt, self.conf.runtime.max_memory_pages))

        # Globals (init exprs may reference imported globals / funcs).
        for gseg in mod.globals:
            val = self._eval_const_expr(store, inst, gseg.init)
            inst.globals.append(GlobalInstance(gseg.type, val))

        # Exports.
        for ex in mod.exports:
            inst.exports[ex.name] = (ex.kind, ex.index)

        # Element segments (WasmEdge instantiate/elem.cpp).
        for eseg in mod.elements:
            refs = [self._eval_const_expr(store, inst, expr)
                    for expr in eseg.init_exprs]
            einst = ElementInstance(eseg.ref_type, refs)
            if eseg.mode == 0:  # active: apply then drop
                off = self._eval_const_expr(store, inst, eseg.offset) & 0xFFFFFFFF
                tab = inst.tables[eseg.table_idx]
                if off + len(refs) > tab.size:
                    raise InstantiationError(ErrCode.ElemSegDoesNotFit,
                                             "out of bounds table access")
                tab.refs[off:off + len(refs)] = refs
                einst.clear()
            elif eseg.mode == 2:  # declarative
                einst.clear()
            inst.elems.append(einst)

        # Data segments (WasmEdge instantiate/data.cpp).
        for dseg in mod.datas:
            dinst = DataInstance(dseg.data)
            if dseg.mode == 0:
                off = self._eval_const_expr(store, inst, dseg.offset) & 0xFFFFFFFF
                mem = inst.memories[dseg.memory_idx]
                if off + len(dseg.data) > len(mem.data):
                    raise InstantiationError(ErrCode.DataSegDoesNotFit,
                                             "out of bounds memory access")
                mem.data[off:off + len(dseg.data)] = dseg.data
                dinst.clear()
            inst.datas.append(dinst)

        inst.start = mod.start
        if name:
            store.register_named(inst)
        else:
            store.push_anonymous(inst)

        # The start function runs once the instance is in the store
        # (instantiate/module.cpp); a trap in it propagates from here.
        if mod.start is not None:
            self.invoke_raw(store, inst.funcs[mod.start], [])
        return inst

    def _eval_const_expr(self, store: StoreManager, inst: ModuleInstance,
                         expr: List[ast.Instruction]) -> int:
        stack: List[int] = []
        for ins in expr:
            if ins.op == Op.end:
                break
            if ins.op in (Op.i32_const, Op.i64_const, Op.f32_const, Op.f64_const):
                stack.append(ins.imm)
            elif ins.op == Op.global_get:
                stack.append(inst.globals[ins.target_idx].value)
            elif ins.op == Op.ref_null:
                stack.append(0)
            elif ins.op == Op.ref_func:
                stack.append(store.intern_ref(inst.funcs[ins.target_idx]))
            else:
                raise InstantiationError(ErrCode.ConstExprRequired)
        return stack[-1] if stack else 0

    # ------------------------------------------------------------------
    # Invocation
    # ------------------------------------------------------------------
    def invoke(self, store: StoreManager, fi: FunctionInstance,
               args: Sequence = (), stop_token: Optional[StopToken] = None) -> list:
        """Typed invoke (WasmEdge executor.cpp). Arg *count* is checked;
        values are numerically coerced to the declared param types
        (Python args are untagged, unlike WasmEdge_Value)."""
        ft = fi.functype
        if len(args) != len(ft.params):
            raise TrapError(ErrCode.FuncSigMismatch,
                            f"expected {len(ft.params)} args, got {len(args)}")
        raw = [typed_to_bits(t, v) for t, v in zip(ft.params, args)]
        out = self.invoke_raw(store, fi, raw, stop_token)
        return [bits_to_typed(t, v) for t, v in zip(ft.results, out)]

    def invoke_raw(self, store: StoreManager, fi: FunctionInstance,
                   raw_args: List[int],
                   stop_token: Optional[StopToken] = None) -> List[int]:
        if self.stat is not None:
            self.stat.start_wasm()
        token = stop_token if stop_token is not None else StopToken()
        with self._token_lock:
            self._active_tokens.add(token)
        try:
            thread = scalar_engine.Thread(store, self.conf, self.stat)
            thread.stop_token = token
            return scalar_engine.run_function(thread, fi, raw_args)
        finally:
            with self._token_lock:
                self._active_tokens.discard(token)
            if self.stat is not None:
                self.stat.stop_wasm()
