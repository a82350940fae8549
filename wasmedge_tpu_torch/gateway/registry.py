"""Runtime guest-module registry for the serving gateway.

`POST /v1/modules` lands here: raw Wasm bytes go through the same
loader -> validator -> executor -> DeviceImage pipeline every other entry
point uses, each module in its own StoreManager with its own WASI
instance (the per-tenant isolation of batch/multitenant.py), and the
registry's current module set concatenates into one
`MultiModuleBatchEngine` per serving generation (`build_engine`).

Registration validates: a module that fails to parse, validate,
instantiate or batch is rejected with the load / validation ErrCode
taxonomy and never reaches an engine.  Each registered module keeps the
one-lane BatchEngine built at registration (on the gateway's device):
its image is what every later generation concatenates, so registering
module N lowers none of modules 1..N-1 again (`lowered_count`).

Guest stdout and stderr are sunk to /dev/null by default (`sink_stdout`):
a network server must not let thousands of guest lanes write to its own
stdout.  A concatenated image carries no tier-0 plane, so every host call
of a generation, fd_write included, is served between launches through
its module's own WASI instance and reaches that instance's fds.

A copy of `wasmedge_tpu/gateway/registry.py` with the device argument.
Left out: the `wasmedge` effect-handler import object (a guest importing
`wasmedge.await_event` does not link in the port yet: ROADMAP A7.4), the
persistent compile-cache tier (A7.7) and `devices=` / the lane mesh
(A7.9).
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, List, Optional, Tuple

from wasmedge_tpu_torch.common.errors import ErrCode, WasmError


class RegisteredModule:
    """One registered guest: its instantiated module and private store,
    and the one-lane BatchEngine built at registration (the normalized
    DeviceImage every later generation reuses)."""

    __slots__ = ("name", "inst", "store", "engine", "sha256", "nbytes",
                 "source", "tenant", "wasi", "snapshot", "_sink_fds")

    def __init__(self, name, inst, store, engine, sha256="", nbytes=0,
                 source="boot", tenant=None, sink_fds=(), wasi=None):
        self.name = name
        self.inst = inst
        self.store = store
        self.engine = engine
        self.sha256 = sha256
        self.nbytes = nbytes
        self.source = source
        # the tenant that registered this module (None = operator / boot);
        # rides the durable manifest, so a resumed gateway re-registers
        # under the same attribution
        self.tenant = tenant
        self.wasi = wasi  # per-module WasiModule (None on the boot path)
        # the image store's SnapshotEntry captured at registration (None:
        # no init export, snapshots off, or the capture skipped)
        self.snapshot = None
        self._sink_fds = list(sink_fds)

    def rename(self, name: str):
        """Adopt a new registration name (the probe-stash reuse path): the
        guest-visible argv[0] tracks it, so a stash hit is not observably
        different from a fresh registration."""
        self.name = name
        if self.wasi is not None and self.wasi.env.args:
            self.wasi.env.args[0] = name

    def exported_funcs(self) -> List[str]:
        return self.inst.func_names()

    def close(self):
        for fd in self._sink_fds:
            try:
                os.close(fd)
            except OSError:
                pass
        self._sink_fds = []


class ModuleRegistry:
    """Ordered name -> RegisteredModule map, and the engines of
    generations.  `device` is where the one-lane probe engines and every
    generation's engine live (the card unless the caller asks for the
    CPU)."""

    def __init__(self, conf=None, sink_stdout: bool = True,
                 device="cuda"):
        from wasmedge_tpu_torch.batch.engine import resolve_device
        from wasmedge_tpu_torch.common.configure import Configure
        from wasmedge_tpu_torch.imagestore.compilecache import CompileCache

        self.conf = conf or Configure()
        self.sink_stdout = sink_stdout
        self.device = resolve_device(device)
        self._mods: Dict[str, RegisteredModule] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()
        # the rejected-registration stash: a later add_wasm of identical
        # bytes adopts the parked engine instead of lowering twice
        self.compile_cache = CompileCache()
        # generation-segment memoization (imagestore/segments.py); the
        # gateway installs one when Configure.imagestore.segmented is on
        self.segment_cache = None
        # lowerings actually performed (stash hits do not count)
        self.lowered_count = 0

    def __len__(self) -> int:
        return len(self._order)

    @property
    def names(self) -> List[str]:
        return list(self._order)

    def get(self, name: str) -> Optional[RegisteredModule]:
        return self._mods.get(name)

    # -- registration ------------------------------------------------------
    def add_wasm(self, name: str, data: bytes, source: str = "http",
                 tenant: Optional[str] = None) -> RegisteredModule:
        """Validate, instantiate and register `data` under `name`.  Raises
        WasmError(ModuleNameConflict) for a duplicate name, load /
        validation / instantiation errors for bad wasm, and ValueError for
        a module the batch pipeline cannot image."""
        self._check_name(name)
        from wasmedge_tpu_torch.batch.engine import BatchEngine
        from wasmedge_tpu_torch.executor import Executor
        from wasmedge_tpu_torch.loader import Loader
        from wasmedge_tpu_torch.runtime.store import StoreManager
        from wasmedge_tpu_torch.validator import Validator

        data = bytes(data)
        sha = hashlib.sha256(data).hexdigest()
        cached = self.compile_cache.pop_probe(sha)
        if cached is not None:
            # identical bytes were lowered and then rolled back: adopt the
            # stashed engine under the new name instead of lowering again
            cached.rename(name)
            cached.source = source
            cached.tenant = tenant
            return self._install(cached)
        mod = Validator(self.conf).validate(
            Loader(self.conf).parse_module(data))
        store = StoreManager()
        ex = Executor(self.conf)
        wasi, sinks = self._register_wasi(ex, store, name)
        try:
            inst = ex.instantiate(store, mod)
            # prove batchability now, so that a bad module 400s at POST
            # time instead of sinking the next generation build, and keep
            # the engine: its image is what every generation concatenates
            eng = BatchEngine(inst, store=store, conf=self.conf, lanes=1,
                              device=self.device)
            self.lowered_count += 1
        except BaseException:
            # a rejected module must not leak its two sink fds
            for fd in sinks:
                try:
                    os.close(fd)
                except OSError:
                    pass
            raise
        rm = RegisteredModule(name, inst, store, eng, sha256=sha,
                              nbytes=len(data), source=source,
                              tenant=tenant, sink_fds=sinks, wasi=wasi)
        return self._install(rm)

    def add_instance(self, name: str, inst, store,
                     source: str = "boot") -> RegisteredModule:
        """Register an already-instantiated module (the VM boot path);
        batchability is proven the same way as add_wasm's."""
        self._check_name(name)
        from wasmedge_tpu_torch.batch.engine import BatchEngine

        eng = BatchEngine(inst, store=store, conf=self.conf, lanes=1,
                          device=self.device)
        self.lowered_count += 1
        return self._install(RegisteredModule(name, inst, store, eng,
                                              source=source))

    def remove(self, name: str, stash: bool = False):
        """Unregister `name`.  With stash=True a wasm-sourced module's
        lowered engine is parked in the probe stash (keyed by its bytes'
        sha256) instead of discarded: the rollback path, so a re-POST of
        the same bytes never pays for a second lowering."""
        with self._lock:
            rm = self._mods.pop(name, None)
            if rm is not None:
                self._order.remove(name)
        if rm is None:
            return
        if stash and rm.sha256:
            self.compile_cache.stash_probe(rm.sha256, rm)
        else:
            rm.close()

    def _check_name(self, name: str):
        if not name or ":" in name or "/" in name:
            raise WasmError(ErrCode.IllegalPath,
                            f"invalid module name {name!r} (non-empty, "
                            f"no ':' or '/')")
        if name in self._mods:
            raise WasmError(ErrCode.ModuleNameConflict,
                            f"module {name!r} already registered")

    def _install(self, rm: RegisteredModule) -> RegisteredModule:
        with self._lock:
            if rm.name in self._mods:   # lost a registration race
                rm.close()
                raise WasmError(ErrCode.ModuleNameConflict,
                                f"module {rm.name!r} already registered")
            self._mods[rm.name] = rm
            self._order.append(rm.name)
        return rm

    def _register_wasi(self, ex, store, prog_name: str
                       ) -> Tuple[object, List[int]]:
        """A fresh per-module WASI instance (its own environ: its own
        isolation), stdout and stderr sunk to /dev/null when configured.
        Registered for every module: a module that imports nothing is
        unaffected.  Returns (wasi, sink fds)."""
        from wasmedge_tpu_torch.host.wasi import WasiModule

        wasi = WasiModule()
        wasi.init_wasi(dirs=[], prog_name=prog_name)
        sinks = []
        if self.sink_stdout:
            for fd in (1, 2):
                e = wasi.env.fds.get(fd)
                if e is not None:
                    sink = os.open(os.devnull, os.O_WRONLY)
                    e.os_fd = sink
                    sinks.append(sink)
        ex.register_import_object(store, wasi)
        return wasi, sinks

    # -- generation engines ------------------------------------------------
    def modules_snapshot(self) -> List[RegisteredModule]:
        with self._lock:
            return [self._mods[n] for n in self._order]

    def build_engine(self, conf, lanes: int, init_overlays=None,
                     snapshot_counts=None):
        """The concatenated engine over the current module set (one
        serving generation's engine), on the registry's device.  The
        one-lane engines kept at registration are reused (`engines=`), so
        a swap costs one image concatenation, not a lowering of every
        module."""
        from wasmedge_tpu_torch.batch.multitenant import (
            MultiModuleBatchEngine)

        mods = self.modules_snapshot()
        if not mods:
            raise WasmError(ErrCode.WrongVMWorkflow,
                            "no modules registered")
        return MultiModuleBatchEngine(
            [(rm.name, rm.inst, rm.store) for rm in mods], conf=conf,
            lanes=lanes, engines=[rm.engine for rm in mods],
            segment_cache=self.segment_cache,
            init_overlays=init_overlays, snapshot_counts=snapshot_counts,
            device=self.device)

    def close(self):
        with self._lock:
            for rm in self._mods.values():
                rm.close()
        self.compile_cache.close()
