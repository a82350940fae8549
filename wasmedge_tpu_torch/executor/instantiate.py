"""Module instantiation: a validated AST -> a ModuleInstance in a store.

A trimmed copy of `wasmedge_tpu/executor/executor.py`:
`register_import_object` (a host module becomes a named instance) and
`Executor.instantiate` (function imports resolved against the store's
named modules, global init expressions, active data segments into the
memory snapshot, active element segments into table 0).  The port has no
scalar engine, so a start function is refused, and imported tables,
memories and globals are refused until the slice that carries them.
"""

from __future__ import annotations

from typing import List, Optional

from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import (
    ErrCode, InstantiationError, WasmError)
from wasmedge_tpu_torch.common.opcodes import Op
from wasmedge_tpu_torch.loader import ast
from wasmedge_tpu_torch.runtime.hostfunc import ImportObject
from wasmedge_tpu_torch.runtime.instance import (
    DataInstance, ElementInstance, FunctionInstance, GlobalInstance,
    MemoryInstance, ModuleInstance, TableInstance)
from wasmedge_tpu_torch.runtime.store import StoreManager


_IMPORT_KINDS = {1: "table", 2: "memory", 3: "global"}


def register_import_object(store: StoreManager,
                           impobj: ImportObject) -> ModuleInstance:
    """Host module -> named ModuleInstance whose exports are its host
    functions (reference: executor.py register_import_object)."""
    if impobj.tables or impobj.memories or impobj.globals:
        raise NotImplementedError(
            f"host module {impobj.name} exports tables, memories or globals: "
            "imported tables, memories and globals come with a later slice "
            "of the port")
    mod = ast.Module()
    mod.validated = True
    inst = ModuleInstance(impobj.name, mod)
    for fname, hf in impobj.funcs.items():
        inst.exports[fname] = (0, len(inst.funcs))
        inst.funcs.append(FunctionInstance("host", hf.functype,
                                           module=inst, host=hf))
    store.register_named(inst)
    return inst


def instantiate(store: StoreManager, mod: ast.Module,
                conf: Optional[Configure] = None,
                name: str = "") -> ModuleInstance:
    if not mod.validated or mod.lowered is None:
        raise WasmError(ErrCode.NotValidated, "module not validated")
    if mod.start is not None:
        raise NotImplementedError(
            "module has a start function: running code at instantiation "
            "needs the scalar engine, which a later slice of the port adds")
    conf = conf or Configure()
    inst = ModuleInstance(name, mod)

    # Function imports (reference: executor.py instantiate, import loop)
    for im in mod.imports:
        if im.kind != 0:
            raise NotImplementedError(
                f"module imports {_IMPORT_KINDS[im.kind]} "
                f"{im.module}.{im.name}: imported tables, memories and "
                "globals come with a later slice of the port")
        src = store.find_module(im.module)
        if src is None:
            raise InstantiationError(ErrCode.UnknownImport,
                                     f"{im.module}.{im.name}: unknown module")
        ex = src.exports.get(im.name)
        if ex is None or ex[0] != im.kind:
            raise InstantiationError(ErrCode.UnknownImport,
                                     f"{im.module}.{im.name}")
        fi = src.funcs[ex[1]]
        if fi.functype != mod.types[im.type_idx]:
            raise InstantiationError(ErrCode.IncompatibleImportType,
                                     f"{im.module}.{im.name}")
        inst.funcs.append(fi)

    nimp = mod.num_imported_funcs
    for li in range(len(mod.functions)):
        inst.funcs.append(FunctionInstance(
            "wasm", mod.func_type_of(nimp + li), module=inst,
            func_idx=nimp + li))
    for tt in mod.tables:
        inst.tables.append(TableInstance(tt))
    for mt in mod.memories:
        inst.memories.append(MemoryInstance(mt, conf.runtime.max_memory_pages))
    for gseg in mod.globals:
        val = _eval_const_expr(store, inst, gseg.init)
        inst.globals.append(GlobalInstance(gseg.type, val))
    for ex in mod.exports:
        inst.exports[ex.name] = (ex.kind, ex.index)

    for eseg in mod.elements:
        refs = [_eval_const_expr(store, inst, expr)
                for expr in eseg.init_exprs]
        einst = ElementInstance(eseg.ref_type, refs)
        if eseg.mode == 0:  # active: apply then drop
            off = _eval_const_expr(store, inst, eseg.offset) & 0xFFFFFFFF
            tab = inst.tables[eseg.table_idx]
            if off + len(refs) > tab.size:
                raise InstantiationError(ErrCode.ElemSegDoesNotFit,
                                         "out of bounds table access")
            tab.refs[off:off + len(refs)] = refs
            einst.clear()
        elif eseg.mode == 2:  # declarative
            einst.clear()
        inst.elems.append(einst)

    for dseg in mod.datas:
        dinst = DataInstance(dseg.data)
        if dseg.mode == 0:
            off = _eval_const_expr(store, inst, dseg.offset) & 0xFFFFFFFF
            mem = inst.memories[dseg.memory_idx]
            if off + len(dseg.data) > len(mem.data):
                raise InstantiationError(ErrCode.DataSegDoesNotFit,
                                         "out of bounds memory access")
            mem.data[off:off + len(dseg.data)] = dseg.data
            dinst.clear()
        inst.datas.append(dinst)

    if name:
        store.register_named(inst)
    else:
        store.push_anonymous(inst)
    return inst


def _eval_const_expr(store: StoreManager, inst: ModuleInstance,
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
