"""Host functions and import objects.

Mirrors the reference HostFunctionBase/HostFunction<T> CRTP marshaling
(WasmEdge include/runtime/hostfunc.h:25-160) and ImportObject
(include/runtime/importobj.h): a host function declares a wasm signature,
receives the caller's MemoryInstance plus typed arguments, and returns
typed results. Marshaling between raw 64-bit cells and typed Python values
happens here, so host bodies are written naturally.

The same objects serve the batch engine's outcall channel: lanes that hit a
host call trap out, the host drains the outcall buffer and runs these
bodies (SURVEY.md §5.8).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

from wasmedge_tpu_torch.common.errors import ErrCode, TrapError
from wasmedge_tpu_torch.common.types import (
    ValType, bits_to_typed, to_valtype, typed_to_bits)
from wasmedge_tpu_torch.loader.ast import FunctionType


class HostFunctionBase:
    """Subclass and implement body(mem, *args) -> tuple/scalar/None."""

    def __init__(self, params: Sequence[ValType], results: Sequence[ValType],
                 cost: int = 0, name: str = ""):
        self.functype = FunctionType(tuple(to_valtype(p) for p in params),
                                     tuple(to_valtype(r) for r in results))
        self.cost = cost
        self.name = name

    def body(self, mem, *args):
        raise NotImplementedError

    def run(self, mem, raw_args: List[int]) -> List[int]:
        ft = self.functype
        if len(raw_args) != len(ft.params):
            raise TrapError(ErrCode.FuncSigMismatch)
        typed = [bits_to_typed(t, v) for t, v in zip(ft.params, raw_args)]
        out = self.body(mem, *typed)
        if out is None:
            out = ()
        elif not isinstance(out, tuple):
            out = (out,)
        if len(out) != len(ft.results):
            raise TrapError(ErrCode.FuncSigMismatch)
        return [typed_to_bits(t, v) for t, v in zip(ft.results, out)]


class PyHostFunction(HostFunctionBase):
    """Host function from a plain Python callable fn(mem, *args)."""

    def __init__(self, fn: Callable, params, results, cost: int = 0, name: str = ""):
        super().__init__(params, results, cost, name or getattr(fn, "__name__", "host"))
        self._fn = fn

    def body(self, mem, *args):
        return self._fn(mem, *args)


class ImportObject:
    """Named host module: a bag of host funcs/tables/memories/globals
    registered under a module name (reference: include/runtime/importobj.h)."""

    def __init__(self, name: str):
        self.name = name
        self.funcs: Dict[str, HostFunctionBase] = {}
        self.memories: Dict[str, object] = {}
        self.tables: Dict[str, object] = {}
        self.globals: Dict[str, object] = {}

    def add_func(self, name: str, fn: HostFunctionBase) -> "ImportObject":
        fn.name = fn.name or name
        self.funcs[name] = fn
        return self

    def add_py_func(self, name: str, fn: Callable, params, results) -> "ImportObject":
        return self.add_func(name, PyHostFunction(fn, params, results, name=name))

    def add_memory(self, name: str, mem) -> "ImportObject":
        self.memories[name] = mem
        return self

    def add_table(self, name: str, table) -> "ImportObject":
        self.tables[name] = table
        return self

    def add_global(self, name: str, glob) -> "ImportObject":
        self.globals[name] = glob
        return self
