"""VM: load -> validate -> instantiate -> execute_batch, on the card.

A trimmed counterpart of `wasmedge_tpu/vm/vm.py`: the host modules the
configuration registers (`HostRegistration.Wasi` -> `wasi_module`) and
any registered with `register_import_object`, the staged pipeline, and
`execute_batch(func, args_lanes)`, which runs the instantiated module's
export over N lanes on the CUDA warp-interpreter, serving its host calls
between launches.  `make_engine` is the seam that picks the engine; the
port has one.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional, Sequence, Union

from wasmedge_tpu_torch.batch.engine import BatchEngine, BatchResult
from wasmedge_tpu_torch.common.configure import Configure, HostRegistration
from wasmedge_tpu_torch.common.errors import ErrCode, WasmError
from wasmedge_tpu_torch.executor.instantiate import (
    instantiate, register_import_object)
from wasmedge_tpu_torch.loader import ast
from wasmedge_tpu_torch.loader.loader import Loader
from wasmedge_tpu_torch.runtime.hostfunc import ImportObject
from wasmedge_tpu_torch.runtime.instance import ModuleInstance
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator.validator import Validator

Source = Union[bytes, bytearray, ast.Module]


class VMStage(enum.Enum):
    Inited = 0
    Loaded = 1
    Validated = 2
    Instantiated = 3


def make_engine(inst, store, conf: Configure, lanes: Optional[int] = None,
                device="cuda") -> BatchEngine:
    """The engine for an instantiated module: the warp-interpreter on
    `device` (the card unless the caller asks for the CPU)."""
    return BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                       device=device)


class VM:
    def __init__(self, conf: Optional[Configure] = None):
        self.conf = conf or Configure()
        self.store = StoreManager()
        self.loader = Loader(self.conf)
        self.validator = Validator(self.conf)
        self.stage = VMStage.Inited
        self._mod: Optional[ast.Module] = None
        self._active = None
        self.last_engine: Optional[BatchEngine] = None
        self._host_modules: Dict[HostRegistration, ImportObject] = {}
        self._init_host_modules()

    # -- host modules (reference: vm.py _init_host_modules) -----------------
    def _init_host_modules(self):
        if HostRegistration.Wasi in self.conf.host_registrations:
            from wasmedge_tpu_torch.host.wasi import WasiModule

            wasi = WasiModule()
            self._host_modules[HostRegistration.Wasi] = wasi
            register_import_object(self.store, wasi)

    @property
    def wasi_module(self):
        """The registered WASI host module (None unless
        `HostRegistration.Wasi` is in `conf.host_registrations`)."""
        return self._host_modules.get(HostRegistration.Wasi)

    def register_import_object(self, impobj: ImportObject) -> ModuleInstance:
        """Register a host module whose functions a module loaded after
        it may import."""
        inst = register_import_object(self.store, impobj)
        self.stage = VMStage.Inited
        return inst

    def load_wasm(self, source: Source):
        if isinstance(source, ast.Module):
            self._mod = source
        else:
            self._mod = self.loader.parse_module(bytes(source))
        self.stage = VMStage.Loaded

    def validate(self):
        if self.stage.value < VMStage.Loaded.value:
            raise WasmError(ErrCode.WrongVMWorkflow, "no loaded module")
        self._mod = self.validator.validate(self._mod)
        self.stage = VMStage.Validated

    def instantiate(self):
        if self.stage.value < VMStage.Validated.value:
            raise WasmError(ErrCode.WrongVMWorkflow, "no validated module")
        self._active = instantiate(self.store, self._mod, self.conf)
        self.stage = VMStage.Instantiated

    def execute_batch(self, func_name: str, args_lanes: Sequence,
                      lanes: Optional[int] = None,
                      max_steps: int = 10_000_000,
                      device="cuda") -> BatchResult:
        """Run the instantiated module's export over N lanes and return
        the per-lane results, traps and retired counts."""
        if self._active is None or self.stage != VMStage.Instantiated:
            raise WasmError(ErrCode.WrongVMWorkflow, "no instantiated module")
        eng = make_engine(self._active, self.store, self.conf, lanes=lanes,
                          device=device)
        self.last_engine = eng  # its hostcall_stats outlive the call
        return eng.run(func_name, list(args_lanes), max_steps=max_steps)
