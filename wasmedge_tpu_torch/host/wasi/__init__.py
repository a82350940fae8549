"""WasiModule: the wasi_snapshot_preview1 host module.

Mirrors WasmEdge lib/host/wasi/wasimodule.cpp:12-76 — registers the
same 60 host functions over a shared WASI::Environ. WasiError unwinds are
converted to errno returns at this boundary (the reference does the same
inside each body); WasiExit (proc_exit) propagates to terminate execution.
"""

from __future__ import annotations

from typing import Optional

from wasmedge_tpu_torch.host.wasi.environ import WasiEnviron, WasiError, WasiExit
from wasmedge_tpu_torch.host.wasi.wasifunc import WASI_FUNCS
from wasmedge_tpu_torch.runtime.hostfunc import HostFunctionBase, ImportObject


class WasiHostFunction(HostFunctionBase):
    def __init__(self, name: str, fn, params, results, env: WasiEnviron):
        super().__init__(params, results, cost=0, name=name)
        self._fn = fn
        self._env = env

    def body(self, mem, *args):
        from wasmedge_tpu_torch.common.errors import ErrCode, TrapError
        from wasmedge_tpu_torch.host.wasi.wasi_abi import Errno

        try:
            out = self._fn(self._env, mem, *args)
        except WasiError as e:
            out = e.errno
        except TrapError as e:
            # Bad guest pointers become EFAULT, matching the reference's
            # pointer validation (wasifunc.cpp MemInst->getPointer checks).
            if e.code != ErrCode.MemoryOutOfBounds:
                raise
            out = Errno.FAULT
        if not self.functype.results:
            return None
        return out


class WasiModule(ImportObject):
    """Import object "wasi_snapshot_preview1" with live Environ state."""

    MODULE_NAME = "wasi_snapshot_preview1"

    def __init__(self):
        super().__init__(self.MODULE_NAME)
        self.env = WasiEnviron()
        self.env.init()
        for name, (fn, params, results) in WASI_FUNCS.items():
            self.add_func(name, WasiHostFunction(name, fn, params, results,
                                                 self.env))

    def get_env(self) -> WasiEnviron:
        return self.env

    def init_wasi(self, dirs=None, prog_name: str = "wasm", args=None,
                  envs=None):
        """reference: WasiModule->getEnv().init (wasmedger.cpp:216-221)."""
        self.env.fini()
        self.env.init(dirs=dirs, prog_name=prog_name, args=args, envs=envs)

    @property
    def exit_code(self) -> int:
        return self.env.exit_code


__all__ = ["WasiModule", "WasiEnviron", "WasiError", "WasiExit"]
