"""VM: load -> validate -> instantiate -> execute on the host or on the card.

A trimmed counterpart of `wasmedge_tpu/vm/vm.py` (after WasmEdge's
include/vm/vm.h): a {Inited, Loaded, Validated, Instantiated} stage
machine over the loader, validator, `Executor` and store; the host
modules the configuration registers (`HostRegistration.Wasi` ->
`wasi_module`) and any registered with `register_import_object`; named
modules (`register_module`) that later modules import from; a
`Statistics` shared by every execution.

Two ways to run an export:
- `execute` / `run_wasm_file` (and their `async_*` forms, with `stop()`)
  run it once on the scalar engine on the host, as WasmEdge's
  interpreter does; they take no device;
- `execute_batch(func, args_lanes)` runs it over N lanes on the CUDA
  warp-interpreter (the card unless the caller asks for the CPU), serving
  its host calls between launches.  A `Statistics` cost limit becomes
  the lanes' fuel and a non-uniform cost table their weights
  (`batch_conf_with_gas`).  `make_engine` is the seam that picks the
  engine; the port has one;
- `serve()` returns a continuous-batching `BatchServer` over the
  instantiated module (serve/), on the card unless asked otherwise.
"""

from __future__ import annotations

import copy
import enum
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

from wasmedge_tpu_torch.batch.engine import BatchEngine, BatchResult
from wasmedge_tpu_torch.common.configure import Configure, HostRegistration
from wasmedge_tpu_torch.common.errors import ErrCode, LoadError, WasmError
from wasmedge_tpu_torch.common.statistics import Statistics
from wasmedge_tpu_torch.executor.executor import Executor, StopToken
from wasmedge_tpu_torch.loader import ast
from wasmedge_tpu_torch.loader.loader import Loader
from wasmedge_tpu_torch.runtime.hostfunc import ImportObject
from wasmedge_tpu_torch.runtime.instance import FunctionInstance, ModuleInstance
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator.validator import Validator
from wasmedge_tpu_torch.vm.async_ import Async

Source = Union[str, bytes, bytearray, ast.Module]


def batch_conf_with_gas(conf: Configure, stat: Optional[Statistics]) -> Configure:
    """Statistics gas metering as the lanes' fuel (the JAX package's
    `batch_conf_with_gas`): with cost measuring on and a limit below
    2^31 - 1, each lane gets a fuel budget of limit + 1 (Statistics traps
    on a total above the limit, the fuel plane on fuel at or below 0, so
    a lane that lands exactly on the limit finishes) and, for a
    non-uniform cost table, per-opcode weights.  A limit the int32 fuel
    plane cannot hold leaves the run without gas.  Returns `conf` itself
    when nothing changes, else a copy."""
    if stat is None or not stat.cost_measuring:
        return conf
    limit = stat.cost_limit
    if limit >= (1 << 31) - 1 and conf.batch.fuel_per_launch is None:
        return conf
    conf = copy.deepcopy(conf)
    if conf.batch.fuel_per_launch is None:
        conf.batch.fuel_per_launch = int(limit) + 1
    if any(c != 1 for c in stat.cost_table):
        conf.batch.cost_table = tuple(stat.cost_table)
    return conf


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
        self.stat = Statistics(self.conf)
        self.loader = Loader(self.conf)
        self.validator = Validator(self.conf)
        self.executor = Executor(self.conf, self.stat)
        self.stage = VMStage.Inited
        self._mod: Optional[ast.Module] = None
        self._active: Optional[ModuleInstance] = None
        self.last_engine: Optional[BatchEngine] = None
        self._host_modules: Dict[HostRegistration, ImportObject] = {}
        self._lock = threading.RLock()
        self._init_host_modules()

    # -- host modules --------------------------------------------------------
    def _init_host_modules(self):
        if HostRegistration.Wasi in self.conf.host_registrations:
            from wasmedge_tpu_torch.host.wasi import WasiModule

            wasi = WasiModule()
            self._host_modules[HostRegistration.Wasi] = wasi
            self.executor.register_import_object(self.store, wasi)

    @property
    def wasi_module(self):
        """The registered WASI host module (None unless
        `HostRegistration.Wasi` is in `conf.host_registrations`)."""
        return self._host_modules.get(HostRegistration.Wasi)

    # -- staged pipeline -----------------------------------------------------
    def _parse(self, source: Source) -> ast.Module:
        if isinstance(source, ast.Module):
            return source
        if isinstance(source, (bytes, bytearray)):
            return self.loader.parse_module(bytes(source))
        if isinstance(source, str) and source.endswith(".wat"):
            from wasmedge_tpu_torch.utils.wat import WatError, parse_wat

            with open(source) as f:
                src = f.read()
            try:
                data = parse_wat(src)
            except WatError as e:
                raise LoadError(ErrCode.IllegalGrammar, f"wat: {e}") from e
            return self.loader.parse_module(data)
        return self.loader.parse_file(source)

    def load_wasm(self, source: Source) -> "VM":
        with self._lock:
            self._mod = self._parse(source)
            self.stage = VMStage.Loaded
        return self

    def validate(self) -> "VM":
        with self._lock:
            if self.stage.value < VMStage.Loaded.value:
                raise WasmError(ErrCode.WrongVMWorkflow, "no loaded module")
            self._mod = self.validator.validate(self._mod)
            self.stage = VMStage.Validated
        return self

    def instantiate(self) -> "VM":
        """Instantiate the validated module; its start function, if any,
        runs here on the scalar engine, charged to `statistics()`."""
        with self._lock:
            if self.stage.value < VMStage.Validated.value:
                raise WasmError(ErrCode.WrongVMWorkflow,
                                "no validated module")
            self._active = self.executor.instantiate(self.store, self._mod)
            self.stage = VMStage.Instantiated
        return self

    # -- registration --------------------------------------------------------
    def register_module(self, name: str, source: Source) -> ModuleInstance:
        """Load, validate and instantiate `source` under `name`, for
        modules loaded later to import from.  Resets the stage machine."""
        with self._lock:
            mod = self._parse(source)
            self.validator.validate(mod)
            inst = self.executor.register_module(self.store, mod, name)
            self.stage = VMStage.Inited
            return inst

    def register_import_object(self, impobj: ImportObject) -> ModuleInstance:
        """Register a host module whose functions, tables, memories and
        globals a module loaded after it may import."""
        with self._lock:
            inst = self.executor.register_import_object(self.store, impobj)
            self.stage = VMStage.Inited
            return inst

    # -- execution on the host -----------------------------------------------
    def _find_function(self, func_name: str,
                       module_name: Optional[str] = None) -> FunctionInstance:
        if module_name is None:
            inst = self._active
            if inst is None or self.stage != VMStage.Instantiated:
                raise WasmError(ErrCode.WrongVMWorkflow,
                                "no instantiated module")
        else:
            inst = self.store.find_module(module_name)
            if inst is None:
                raise WasmError(ErrCode.WrongInstanceAddress,
                                f"unknown module {module_name!r}")
        ex = inst.exports.get(func_name)
        if ex is None or ex[0] != 0:
            raise WasmError(ErrCode.FuncNotFound, func_name)
        return inst.funcs[ex[1]]

    def execute(self, func_name: str, args: Sequence = (),
                module_name: Optional[str] = None, _stop_token=None) -> list:
        """Run an export of the active module (or of the registered module
        `module_name`) once on the scalar engine; typed results."""
        # resolve under the lock, run outside it so that executions
        # proceed in parallel and stop() never blocks
        with self._lock:
            fi = self._find_function(func_name, module_name)
        return self.executor.invoke(self.store, fi, args, _stop_token)

    def run_wasm_file(self, source: Source, func_name: str,
                      args: Sequence = (), _stop_token=None) -> list:
        """Load, validate, instantiate and execute in one call."""
        with self._lock:
            self.load_wasm(source)
            self.validate()
            self.instantiate()
            fi = self._find_function(func_name)
        return self.executor.invoke(self.store, fi, args, _stop_token)

    def stop(self):
        """Interrupt every execution on the host in flight."""
        self.executor.stop()

    def async_execute(self, func_name: str, args: Sequence = (),
                      module_name: Optional[str] = None) -> Async:
        token = StopToken()
        return Async(lambda: self.execute(func_name, args, module_name,
                                          _stop_token=token),
                     stop_fn=token.stop)

    def async_run_wasm_file(self, source: Source, func_name: str,
                            args: Sequence = ()) -> Async:
        token = StopToken()
        return Async(lambda: self.run_wasm_file(source, func_name, args,
                                                _stop_token=token),
                     stop_fn=token.stop)

    # -- execution on the card -----------------------------------------------
    def execute_batch(self, func_name: str, args_lanes: Sequence,
                      lanes: Optional[int] = None,
                      max_steps: int = 10_000_000,
                      device="cuda", supervised: bool = False,
                      resume: bool = False,
                      checkpoint_dir: Optional[str] = None) -> BatchResult:
        """Run the instantiated module's export over N lanes and return
        the per-lane results, traps and retired counts.

        `supervised=True` runs the batch under batch/supervisor.py:
        periodic checkpoints into `checkpoint_dir` (a temporary directory
        when None), retry with backoff from the newest good snapshot, and
        the cuda -> cuda_unfused ladder (then scalar, for an engine on the
        CPU only), with FailureRecords landing on this VM's Statistics
        (`conf.supervisor` holds the knobs).  `resume=True` also adopts
        the lineage in `checkpoint_dir` at startup (a cross-process
        resume) and implies `supervised`."""
        with self._lock:
            if self._active is None or self.stage != VMStage.Instantiated:
                raise WasmError(ErrCode.WrongVMWorkflow,
                                "no instantiated module")
            inst = self._active
        # only the supervisor owns the checkpoint lineage: a resume is
        # never silently ignored
        if resume:
            supervised = True
        conf = batch_conf_with_gas(self.conf, self.stat)
        eng = make_engine(inst, self.store, conf, lanes=lanes, device=device)
        self.last_engine = eng  # its hostcall_stats outlive the call
        if supervised:
            from wasmedge_tpu_torch.batch.supervisor import BatchSupervisor

            sup = BatchSupervisor(eng, conf=conf, stats=self.stat,
                                  checkpoint_dir=checkpoint_dir,
                                  resume=resume)
            return sup.run(func_name, list(args_lanes), max_steps=max_steps)
        return eng.run(func_name, list(args_lanes), max_steps=max_steps)

    def serve(self, lanes: Optional[int] = None, weights=None, quotas=None,
              device="cuda", checkpoint_dir: Optional[str] = None,
              resume: bool = False):
        """Continuous-batching serving over the instantiated module
        (serve/): returns a BatchServer whose submit() queues one request
        a call and whose serving loop recycles retired lanes with queued
        requests instead of draining the batch.  `conf.serve` holds its
        knobs (queue capacity, per-request budget, checkpoint cadence,
        retries); `weights` / `quotas` set per-tenant fair admission; a
        `Statistics` cost limit becomes each lane's fuel, as in
        `execute_batch`.  The server checkpoints into `checkpoint_dir` (a
        temporary directory when None); `resume=True` adopts the serving
        lineage there: in-flight requests come back under fresh futures
        (`server.adopted`)."""
        from wasmedge_tpu_torch.serve import BatchServer

        with self._lock:
            if self._active is None or self.stage != VMStage.Instantiated:
                raise WasmError(ErrCode.WrongVMWorkflow,
                                "no instantiated module")
            inst = self._active
        conf = batch_conf_with_gas(self.conf, self.stat)
        return BatchServer(inst, store=self.store, conf=conf, lanes=lanes,
                           stats=self.stat, weights=weights, quotas=quotas,
                           checkpoint_dir=checkpoint_dir, resume=resume,
                           device=device)

    def gateway(self, host: str = "127.0.0.1", port: int = 0,
                lanes: Optional[int] = None, tenants=None,
                module_name: str = "main",
                state_dir: Optional[str] = None, device="cuda"):
        """The network-facing serving gateway over the instantiated module
        (gateway/): returns an UNSTARTED Gateway whose HTTP surface
        serves POST /v1/invoke (sync or async with polling), runtime
        module registration (POST /v1/modules: more guests join the
        concatenated image at generation swaps), /v1/status and a
        truthful /healthz.  This VM's module is registered as
        `module_name`; the gateway's generations run on `device`.
        `tenants` is a gateway.GatewayTenants policy table; `state_dir`
        makes runtime registrations and async request ids survive a
        restart (this instance-registered module has no bytes to keep: a
        resume restores only wasm-registered modules).  Call `.start()`
        on the result and `.shutdown()` to drain."""
        from wasmedge_tpu_torch.gateway import Gateway, GatewayService

        with self._lock:
            if self._active is None or self.stage != VMStage.Instantiated:
                raise WasmError(ErrCode.WrongVMWorkflow,
                                "no instantiated module")
            inst = self._active
        conf = batch_conf_with_gas(self.conf, self.stat)
        svc = GatewayService(conf=conf, lanes=lanes or 64, tenants=tenants,
                             state_dir=state_dir, device=device)
        svc.register_module(module_name, inst=inst, store=self.store,
                            source="vm")
        return Gateway(svc, host=host, port=port)

    # -- introspection -------------------------------------------------------
    def get_function_list(self) -> List[Tuple[str, ast.FunctionType]]:
        if self._active is None:
            return []
        return [(name, self._active.funcs[idx].functype)
                for name, (kind, idx) in self._active.exports.items()
                if kind == 0]

    @property
    def active_module(self) -> Optional[ModuleInstance]:
        return self._active

    def statistics(self) -> Statistics:
        return self.stat

    def cleanup(self):
        """Drop the loaded and active modules and reset the statistics;
        registered modules stay."""
        with self._lock:
            self._mod = None
            self._active = None
            self.store.reset(keep_registered=True)
            self.stat.reset()
            self.stage = VMStage.Inited
