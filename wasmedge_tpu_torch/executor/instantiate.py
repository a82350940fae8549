"""Module instantiation entry points over the `Executor`.

`instantiate` (a validated AST -> a ModuleInstance in a store, start
function run on the scalar engine) and `register_import_object` (a host
module, with its functions, tables, memories and globals, becomes a named
instance) as functions, for callers that hold no `Executor`.
"""

from __future__ import annotations

from typing import Optional

from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.executor.executor import Executor
from wasmedge_tpu_torch.loader import ast
from wasmedge_tpu_torch.runtime.hostfunc import ImportObject
from wasmedge_tpu_torch.runtime.instance import ModuleInstance
from wasmedge_tpu_torch.runtime.store import StoreManager


def register_import_object(store: StoreManager,
                           impobj: ImportObject) -> ModuleInstance:
    return Executor().register_import_object(store, impobj)


def instantiate(store: StoreManager, mod: ast.Module,
                conf: Optional[Configure] = None,
                name: str = "") -> ModuleInstance:
    return Executor(conf).instantiate(store, mod, name)
