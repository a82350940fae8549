"""GatewayService: multi-tenant serving generations over BatchServer.

The long-lived core the HTTP layer (gateway/http.py) is a thin skin
over.  One *generation* = one `MultiModuleBatchEngine` (the concatenated
image of every registered module, batch/multitenant.py) with its kernel
built, driven by one `BatchServer` on a background thread.  Runtime
module registration is a **generation swap**:

    POST /v1/modules
      -> registry.add_wasm()       (loader -> validator -> image, 400s on
                                    bad or unbatchable wasm)
      -> build generation N+1      (image rebuilt with the new module,
                                    then its fused kernel built)
      -> atomic pointer swap       (new submissions -> generation N+1)
      -> generation N drains       (in-flight and queued requests finish
                                    on the old image, then the old server
                                    shuts down on its own thread)

The swap holds the submit lock only for the pointer write; submitters
never wait for a build.  Both generations launch on the same card while
the old one drains; their planes are their own.

**The build, and how its timeout differs from the JAX package's.**  In
the JAX package a generation's timed build covers only the image
concatenation (`build_timeout_s`, 120 s by default); its XLA compile
happens later, on the serving thread's first launch.  In the port a new
module set's fused kernel is an nvcc build (tens of seconds, minutes
under contention), so the timed build covers the concatenation AND the
kernel build (`build_generation_kernels`: `interp.build_kernels` on the
card, nothing on the CPU).  A kernel that does not build then rolls back
as a retryable `GenerationBuildFailed` with the prior generation still
serving, instead of failing the new server after the swap, and no
submission lands on a generation that waits for nvcc.  The default
timeout is 600 s, not 120 s, since it covers nvcc.  A build that times
out keeps its nvcc running (`interp.build_kernels` keys its output by
source hash); the registry's probe stash keeps the module's lowering, so
a re-POST of the same bytes lowers nothing and finds the kernel built or
still building: the retry retries only the build.

Request lifecycle: `submit()` stamps a GatewayRequest into the stash keyed
by the process-wide request id (shared with ServeFuture), so `202
Accepted` clients poll `GET /v1/requests/<id>` against the object the
sync path waits on.  Resolved requests are kept for `result_cache`
completions and then pruned oldest-first.

Durability, swap safety, health and shedding are the JAX package's:

  durability    `state_dir=` attaches a DurableStore (module blobs,
                manifest and async-request journal, all crash-atomic);
                `resume=True` re-registers the stored module set under ONE
                boot generation, adopts the previous generation's
                BatchServer checkpoint lineage, replays resolved ids from
                the durable result cache and re-queues the rest under
                their ORIGINAL ids
  swap safety   a build or swap that fails or times out rolls back
                ATOMICALLY (registry stash kept for the retry, submit
                pointer untouched, prior generation serving)
  health        `health()` (gateway/health.py): serving-thread liveness,
                last-swap outcome, queue saturation, checkpoint and
                journal write health -> healthy / degraded / unhealthy
  shedding      while degraded, the lowest-weight tenant tier is
                refused up front with a retryable 429 (ShedLoad)
  chaos seams   a FaultInjector as `faults=` arms gateway_register /
                generation_build / generation_swap / journal_write (and
                the launch / serve / checkpoint seams of every
                generation's BatchServer); `kill()` is the simulated
                SIGKILL a resume starts from

A copy of `wasmedge_tpu/gateway/service.py`.  Left out, each with its
ROADMAP item: the recorder's spans, instants and `metrics_text` (A7.6);
`fleet`, `autoscale`, `reshard` and `devices` (A7.9); the scrubber
(A7.5); `wake` and `stream_of` (A7.4); the lane virtualizer's budgets
and status (A7.3); `_vet`'s policy gate and its bounded / unbounded
counts (A7.8: the port's analysis has no cost verdict); the persistent
compile cache (A7.7).  A knob of a left-out item that is set raises.
"""

from __future__ import annotations

import copy
import os
import shutil
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from wasmedge_tpu_torch.common.errors import EngineFailure, ErrCode, WasmError
from wasmedge_tpu_torch.gateway.durable import (
    DurabilityError,
    DurableStore,
    _resolved_entry,
    resolved_error,
)
from wasmedge_tpu_torch.gateway.health import HealthGate, ShedLoad
from wasmedge_tpu_torch.gateway.registry import ModuleRegistry
from wasmedge_tpu_torch.gateway.tenants import GatewayTenants, RateLimited

# ids remembered as "pruned" (vs never issued) for the distinct 404
# detail; bounded so a long-lived gateway cannot grow it forever
_PRUNED_MEMORY = 65536

# GatewayService arguments of subsystems the port does not have yet
_NOT_PORTED = {"devices": "A7.9", "fleet": "A7.9", "autoscale": "A7.9"}


def build_generation_kernels(engine) -> float:
    """Build (or find built) the kernel a generation's engine launches:
    its fused build on the card; nothing on the CPU, where the plain
    interpreter runs.  Returns the seconds it took.  Raises
    `interp.KernelBuildError` when nvcc fails: the generation then rolls
    back."""
    t0 = time.perf_counter()
    if engine.device.type == "cuda":
        from wasmedge_tpu_torch.batch import interp

        interp.build_kernels([engine.tables], per_op=())
    return time.perf_counter() - t0


class GenerationBuildFailed(EngineFailure):
    """A serving-generation build or swap failed (or exceeded the build
    timeout) and was rolled back: the prior generation kept serving and
    nothing was half-swapped.  Retryable: the lowered module is stashed
    in the registry's probe cache, so a re-POST of the same bytes skips
    the lowering and retries only the build."""

    retryable = True

    def __init__(self, msg: str):
        super().__init__(msg)
        self.retry_after_s = 1.0


class GatewayClosed(WasmError):
    """The gateway is shutting down: distinct from a tenant's permanent
    admission block (both ride ErrCode.Terminated).  The HTTP layer maps
    this to 503 (come back) and the admission block to 403.  Retryable:
    the same request is welcome at the restarted gateway."""

    retryable = True

    def __init__(self):
        super().__init__(ErrCode.Terminated, "gateway shut down")
        self.retry_after_s = 1.0


class GatewayRequest:
    """Stash entry for one gateway request (sync waiters and async pollers
    share it).  `args` and `deadline_s` ride along for the durable
    journal: a re-queued request must be re-executable verbatim."""

    __slots__ = ("id", "tenant", "module", "func", "future", "t_recv",
                 "gen_id", "finalized", "args", "deadline_s")

    def __init__(self, future, tenant, module, func, gen_id, t_recv,
                 args=(), deadline_s=None):
        self.id = future.request_id
        self.future = future
        self.tenant = tenant
        self.module = module
        self.func = func
        self.gen_id = gen_id
        self.t_recv = t_recv
        self.finalized = False
        self.args = tuple(int(a) for a in args)
        self.deadline_s = deadline_s


class _Generation:
    __slots__ = ("gen_id", "engine", "server", "modules", "serve_dir",
                 "build_s", "kernel_s")

    def __init__(self, gen_id, engine, server, modules, serve_dir=None,
                 build_s=0.0, kernel_s=0.0):
        self.gen_id = gen_id
        self.engine = engine
        self.server = server
        self.modules = tuple(modules)
        self.serve_dir = serve_dir
        self.build_s = build_s     # the whole timed build
        self.kernel_s = kernel_s   # of which the kernel build


class GatewayService:
    """The gateway's engine room (transport-free; see gateway/http.py).

    `conf` is the template Configure every generation deep-copies;
    `tenants` the edge policy table; `lanes` the per-generation serving
    pool width; `device` where the registry's probe engines and every
    generation run (the card unless the caller asks for the CPU)."""

    def __init__(self, conf=None, lanes: int = 64,
                 tenants: Optional[GatewayTenants] = None,
                 result_cache: int = 4096,
                 sync_wait_s: float = 60.0,
                 sink_stdout: bool = True,
                 faults=None,
                 state_dir: Optional[str] = None,
                 resume: bool = False,
                 build_timeout_s: float = 600.0,
                 shed_on_degraded: bool = True,
                 device="cuda",
                 devices=None, fleet=None, autoscale=None):
        from wasmedge_tpu_torch.common.configure import Configure

        for arg, value in (("devices", devices), ("fleet", fleet),
                           ("autoscale", autoscale)):
            if value is not None:
                raise NotImplementedError(
                    f"GatewayService({arg}=) is not in the port yet "
                    f"(ROADMAP {_NOT_PORTED[arg]})")
        self.template = conf or Configure()
        ist = self.template.imagestore
        if ist.compile_cache:
            raise NotImplementedError(
                "Configure.imagestore.compile_cache is not in the port yet "
                "(ROADMAP A7.7)")
        self.lanes = int(lanes)
        self.tenants = tenants or GatewayTenants()
        self.registry = ModuleRegistry(conf=self.template,
                                       sink_stdout=sink_stdout,
                                       device=device)
        self.device = self.registry.device
        self.result_cache = int(result_cache)
        self.sync_wait_s = float(sync_wait_s)
        self.faults = faults
        self.build_timeout_s = float(build_timeout_s)
        self.shed_on_degraded = bool(shed_on_degraded)
        self.force_degraded = False   # operator / test switch
        self._lock = threading.RLock()
        self._reg_lock = threading.Lock()   # one registration at a time
        self._capture_lock = threading.Lock()
        self._gens: List[_Generation] = []  # current is last
        self._gen_seq = 0
        self._reapers: List[threading.Thread] = []
        self._requests: Dict[int, GatewayRequest] = {}
        self._resolved = deque()
        self._pruned: "deque[int]" = deque(maxlen=_PRUNED_MEMORY)
        self._pruned_set = set()
        self._closed = False
        self.http_counts: Dict[str, int] = {}
        self.last_swap: Optional[dict] = None
        self.shed_counts: Dict[str, int] = {}
        # each drained generation: (gen_id, seconds from swap to its
        # server's end)
        self.drains: List[tuple] = []
        self.counters = {
            "received": 0, "completed": 0, "failed": 0, "deadline": 0,
            "rejected": 0, "rate_limited": 0, "registered_modules": 0,
            "generations": 0, "restarts": 0, "rollbacks": 0, "shed": 0,
            "journal_errors": 0, "resumed": 0,
        }
        # the durable result cache mirrored to the journal (capped below
        # the in-memory stash: every journal write serializes it)
        self._durable_cache_depth = min(max(self.result_cache, 1), 512)
        self._result_cache = deque(maxlen=self._durable_cache_depth)
        self._journal_fail_streak = 0
        self._manifest_dirty = False
        # serializes snapshot -> write, so that an older journal snapshot
        # can never land a newer sequence number
        self._journal_mutex = threading.Lock()
        # ids at or below this were issued by a pre-crash process: an
        # unknown id under it answers the pruned 404 detail
        self._resume_floor = 0
        self._max_issued = 0
        self._min_issued = 0   # 0 = nothing issued yet
        self._resume_min = 1
        # the serve lineage a resume's boot generation adopts (set only
        # during _resume_from_disk)
        self._pending_resume: Optional[str] = None
        self.durable = DurableStore(
            state_dir, faults=faults,
            result_cache=self._durable_cache_depth) \
            if state_dir else None
        # the image store: segmented images and pre-initialized snapshots,
        # both off by default (the registry's segment_cache stays None and
        # no snapshot store exists)
        self.snapshot_store = None
        self.snapshot_counts: Dict[str, int] = {}
        self.imagestore_enabled = bool(ist.active)
        if ist.segmented:
            from wasmedge_tpu_torch.imagestore import SegmentCache

            self.registry.segment_cache = SegmentCache()
        if ist.snapshots:
            from wasmedge_tpu_torch.hv.swapstore import SwapStore

            self.snapshot_store = SwapStore(dir=ist.snapshot_dir,
                                            faults=faults)
        self._health = HealthGate(self)
        if resume:
            if self.durable is None:
                raise ValueError("resume=True requires a state_dir")
            self._resume_from_disk()

    # -- generations -------------------------------------------------------
    @property
    def current(self) -> Optional[_Generation]:
        with self._lock:
            return self._gens[-1] if self._gens else None

    @property
    def generation(self) -> int:
        with self._lock:
            return self._gens[-1].gen_id if self._gens else 0

    def _make_generation(self, gen_id: int, serve_dir: Optional[str],
                         resume: bool, added=()) -> _Generation:
        """Build generation `gen_id`: the snapshots of the modules just
        `added`, the engine, its kernel and its server.  It commits no
        shared state but those snapshots, which a retry of the same
        modules keeps, and mutates no disk: the timed wrapper may abandon
        this work on a timeout, and the retry reuses `gen_id`."""
        from wasmedge_tpu_torch.serve.server import BatchServer

        t0 = time.perf_counter()
        if self.faults is not None:
            self.faults.fire("generation_build", generation=gen_id,
                             modules=self.registry.names)
        if self.snapshot_store is not None:
            self._capture_snapshots(added)
        conf = copy.deepcopy(self.template)
        if serve_dir is not None \
                and conf.serve.checkpoint_every_rounds is None:
            # durability implies a checkpoint cadence: a resume has
            # nothing to adopt otherwise
            conf.serve.checkpoint_every_rounds = 1
        init_overlays = None
        snapshot_counts = None
        if self.snapshot_store is not None:
            # each module's post-init snapshot as an overlay of this
            # generation's initial_state; a faulted or corrupt entry drops
            # to template init for that module (counted)
            from wasmedge_tpu_torch.imagestore import decode_overlay

            snapshot_counts = self.snapshot_counts
            init_overlays = {}
            for rm in self.registry.modules_snapshot():
                if rm.snapshot is None:
                    continue
                ov = decode_overlay(rm, self.snapshot_store,
                                    faults=self.faults,
                                    counts=self.snapshot_counts)
                if ov is not None:
                    init_overlays[rm.name] = ov
        engine = self.registry.build_engine(
            conf, self.lanes, init_overlays=init_overlays,
            snapshot_counts=snapshot_counts)
        kernel_s = build_generation_kernels(engine)
        server = BatchServer(engine=engine,
                             weights=self.tenants.weights(),
                             quotas=self.tenants.quotas(),
                             faults=self.faults,
                             checkpoint_dir=serve_dir,
                             resume=resume)
        return _Generation(gen_id, engine, server, self.registry.names,
                           serve_dir=serve_dir,
                           build_s=time.perf_counter() - t0,
                           kernel_s=kernel_s)

    def _build_generation_timed(self, added=()) -> _Generation:
        """Build the next generation against `build_timeout_s` on a worker
        thread, so that one wedged build cannot hold the registration lock
        forever.  A timed-out build is abandoned (a daemon thread that
        commits nothing; its nvcc goes on and its output is kept) and
        surfaces as a retryable GenerationBuildFailed; only a build that
        returns in time commits the generation counters."""
        gen_id = self._gen_seq + 1   # under _reg_lock: race-free
        serve_dir = None
        resume = False
        if self._pending_resume is not None:
            # the resume boot generation adopts the previous process's
            # serve-checkpoint lineage (in-flight requests come back)
            serve_dir, resume = self._pending_resume, True
        elif self.durable is not None:
            serve_dir = self.durable.serve_dir_for(gen_id)
            # a non-resume generation owns a fresh lineage: stale
            # serve-*.npz of an earlier process in this slot would
            # otherwise be adoptable by the next resume
            shutil.rmtree(serve_dir, ignore_errors=True)
        box: dict = {}
        done = threading.Event()

        def build():
            try:
                box["gen"] = self._make_generation(gen_id, serve_dir,
                                                   resume, added)
            except BaseException as e:
                box["err"] = e
            finally:
                done.set()

        t = threading.Thread(target=build, daemon=True,
                             name=f"gw-build-gen{gen_id}")
        t.start()
        if not done.wait(self.build_timeout_s):
            raise GenerationBuildFailed(
                f"generation {gen_id} build exceeded the "
                f"{self.build_timeout_s}s build timeout")
        err = box.get("err")
        if err is not None:
            if isinstance(err, (KeyboardInterrupt, SystemExit)):
                raise err
            raise GenerationBuildFailed(
                f"generation {gen_id} build failed: {err!r}") from err
        gen = box["gen"]
        self._gen_seq = gen_id
        self.counters["generations"] += 1
        return gen

    def _swap_in(self, gen: _Generation):
        """Install `gen` as current; the displaced generation drains in
        the background (its in-flight lanes finish on the old image) and
        is reaped once idle.  The `generation_swap` fault seam fires
        before the server starts or the pointer moves: an injected swap
        fault rolls back with the submit pointer untouched."""
        if self.faults is not None:
            self.faults.fire("generation_swap", generation=gen.gen_id,
                             modules=list(gen.modules))
        gen.server.start()
        with self._lock:
            old = self._gens[-1] if self._gens else None
            self._gens.append(gen)
        if old is not None:
            t = threading.Thread(target=self._drain_old,
                                 args=(old, time.perf_counter()),
                                 name=f"gw-drain-gen{old.gen_id}",
                                 daemon=True)
            t.start()
            self._reapers.append(t)

    def _drain_old(self, old: _Generation, t_swap: float):
        try:
            old.server.shutdown(drain=True)
        finally:
            with self._lock:
                if old in self._gens:
                    self._gens.remove(old)
                self.drains.append((old.gen_id,
                                    time.perf_counter() - t_swap))
            if self.durable is not None and old.serve_dir \
                    and not any(g.serve_dir == old.serve_dir
                                for g in self._gens):
                self.durable.drop_serve_dir(old.serve_dir)

    # -- module registration ----------------------------------------------
    def register_module(self, name: str, wasm_bytes: Optional[bytes] = None,
                        inst=None, store=None, source: str = "http",
                        tenant: Optional[str] = None) -> dict:
        """Register a module and swap in a fresh generation: either raw
        `wasm_bytes` (the HTTP path: the whole validation pipeline) or a
        pre-instantiated (inst, store) pair (the VM boot path)."""
        return self._register([(name, wasm_bytes, inst, store, tenant)],
                              source=source)

    def preload(self, entries, source: str = "boot") -> dict:
        """Register several modules with ONE generation build (the boot
        path must not build and drain N-1 throwaway generations).
        `entries` is [(name, wasm_bytes)]."""
        return self._register(
            [(n, b, None, None, None) for n, b in entries], source=source)

    def _register(self, entries, source: str) -> dict:
        """One registration transaction: add -> timed build -> swap ->
        persist.  Every failure before the pointer swap rolls back
        atomically (registry stash kept, prior generation serving);
        build and swap failures surface as a retryable
        GenerationBuildFailed (HTTP 503), while the wasm taxonomy of the
        add phase passes through unchanged (400s)."""
        with self._reg_lock:
            if self._closed:
                raise GatewayClosed()
            if self.faults is not None:
                self.faults.fire("gateway_register",
                                 names=[e[0] for e in entries])
            added = []
            try:
                for name, wasm_bytes, inst, store, owner in entries:
                    if wasm_bytes is not None:
                        rm = self.registry.add_wasm(name, wasm_bytes,
                                                    source=source,
                                                    tenant=owner)
                    else:
                        rm = self.registry.add_instance(name, inst, store,
                                                        source=source)
                    added.append((rm, wasm_bytes))
            except BaseException:
                # never leave a module registered that no generation
                # serves; stash=True parks the lowered engine for a
                # re-POST of the same bytes
                for rm, _ in added:
                    self.registry.remove(rm.name, stash=True)
                raise
            try:
                gen = self._build_generation_timed(
                    [rm for rm, _ in added])
                self._swap_in(gen)
            except BaseException as e:
                for rm, _ in added:
                    self.registry.remove(rm.name, stash=True)
                self._note_rollback(e)
                if isinstance(e, (KeyboardInterrupt, SystemExit,
                                  GatewayClosed, GenerationBuildFailed)):
                    raise
                raise GenerationBuildFailed(
                    f"generation swap failed: {e!r}") from e
            self.last_swap = {"ok": True, "generation": gen.gen_id,
                              "error": None, "t": time.monotonic()}
            durable_ok = self._persist_registration(added, gen)
        with self._lock:
            self.counters["registered_modules"] += len(added)
        last = added[-1][0]
        out = {
            "module": last.name,
            "sha256": last.sha256,
            "exports": last.exported_funcs(),
            "generation": gen.gen_id,
            "modules": list(gen.modules),
        }
        if self.durable is not None:
            out["durable"] = durable_ok
        return out

    def _capture_snapshots(self, added):
        """One init run per freshly added module, its post-init columns
        kept as a snapshot (imagestore/snapshot.py).  It runs inside the
        timed generation build, since on the card the init run launches
        the module's own one-lane kernel (an nvcc build the first time):
        a kernel that does not build or a launch that fails rolls the
        registration back like any build failure.  No init export, an
        init that traps, parks or runs out of steps, or a failed store
        write admits through template init.  A stash re-adoption keeps
        its capture; one lock for every capture, since a timed-out
        build's thread may still be running one on the same engine."""
        from wasmedge_tpu_torch.imagestore import capture_snapshot
        from wasmedge_tpu_torch.testing.faults import InjectedFault

        steps = self.template.imagestore.snapshot_init_max_steps
        with self._capture_lock:
            for rm in added:
                if rm.snapshot is not None:
                    continue
                try:
                    rm.snapshot = capture_snapshot(
                        rm, self.snapshot_store, self.snapshot_counts,
                        max_steps=steps)
                except (OSError, InjectedFault):
                    # the store write failed
                    self.snapshot_counts["skipped"] = \
                        self.snapshot_counts.get("skipped", 0) + 1

    def _note_rollback(self, exc: BaseException):
        with self._lock:
            self.counters["rollbacks"] += 1
        self.last_swap = {"ok": False, "generation": self.generation,
                          "error": repr(exc), "t": time.monotonic()}

    # -- durability --------------------------------------------------------
    def _persist_registration(self, added, gen: _Generation) -> bool:
        """Module blobs and manifest, written before the 201 returns.  A
        failed write degrades health (the body says durable: false) but
        does not un-swap the generation; the next durable write heals it
        through the dirty flag, since every manifest is the full set."""
        if self.durable is None:
            return True
        try:
            for rm, data in added:
                if data is not None and rm.sha256:
                    self.durable.save_module_bytes(rm.sha256, bytes(data))
            self._write_manifest(gen)
            return True
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException:
            with self._lock:
                self.counters["journal_errors"] += 1
                self._journal_fail_streak += 1
                self._manifest_dirty = True
            return False

    def _write_manifest(self, gen: _Generation):
        # instance-registered modules (the VM boot path) have no bytes to
        # restore from
        mods = [{"name": rm.name, "sha256": rm.sha256,
                 "tenant": rm.tenant, "source": rm.source}
                for rm in self.registry.modules_snapshot() if rm.sha256]
        rel = os.path.relpath(gen.serve_dir, self.durable.dir) \
            if gen.serve_dir else None
        self.durable.write_manifest(mods, gen.gen_id, rel,
                                    self.counters["restarts"])
        self._manifest_dirty = False

    def _journal_snapshot(self):
        with self._lock:
            unresolved = [{"id": r.id, "tenant": r.tenant,
                           "module": r.module, "func": r.func,
                           "args": list(r.args), "deadline_s": r.deadline_s}
                          for r in self._requests.values()
                          if not r.future.done]
            resolved = list(self._result_cache)
            # a resolved but not yet finalized id is no longer unresolved:
            # its outcome goes into the resolved cache inline
            seen = {e.get("id") for e in resolved}
            for r in self._requests.values():
                if r.future.done and not r.finalized and r.id not in seen:
                    try:
                        resolved.append(_resolved_entry(r))
                    except Exception:
                        pass
            max_id = max([self._resume_floor, self._max_issued]
                         + [r.id for r in self._requests.values()])
            mins = [self._min_issued]
            if self._resume_floor:
                mins.append(self._resume_min)
            min_id = min([m for m in mins if m] or [0])
        return unresolved, resolved, max_id, min_id

    def _journal_sync(self, strict_req: Optional[GatewayRequest] = None):
        """Write the request journal (and a dirty manifest).  With
        `strict_req`, a failed write withdraws that request's acceptance
        (out of the queue, its future rejected) and raises a retryable
        DurabilityError, so the gateway never issues a 202 id that would
        not survive a restart.  Without it (the finalize path), a failure
        only degrades health."""
        if self.durable is None:
            return
        try:
            with self._journal_mutex:
                unresolved, resolved, max_id, min_id = \
                    self._journal_snapshot()
                if self._manifest_dirty:
                    cur = self.current
                    if cur is not None:
                        self._write_manifest(cur)
                self.durable.write_journal(unresolved, resolved,
                                           max_id=max_id, min_id=min_id)
            with self._lock:
                self._journal_fail_streak = 0
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            with self._lock:
                self.counters["journal_errors"] += 1
                self._journal_fail_streak += 1
            if strict_req is not None:
                self._withdraw(strict_req)
                err = DurabilityError(f"request journal write failed: {e!r}")
                strict_req.future._reject(err)
                raise err from e

    def _withdraw(self, req: GatewayRequest):
        """Take back an acceptance that could not be made durable: out of
        the serving queue (if not yet admitted), out of the stash and out
        of the received tally."""
        with self._lock:
            gen = next((g for g in self._gens if g.gen_id == req.gen_id),
                       None)
            if self._requests.pop(req.id, None) is not None:
                self.counters["received"] -= 1
        if gen is not None:
            gen.server.withdraw(req.id)

    def _resume_from_disk(self):
        """Crash / restart resume: re-register the stored module set under
        ONE boot generation (adopting the previous generation's
        serve-checkpoint lineage), then re-install the async-request
        journal: resolved ids replay from the durable result cache,
        everything else re-queues under its original id."""
        manifest, journal = self.durable.load()
        self.counters["restarts"] = \
            int((manifest or {}).get("restarts", 0)) + 1
        mods = (manifest or {}).get("modules") or []
        gen = None
        if mods:
            # continue the generation numbering, so that a fresh
            # generation here can never reuse a dead process's slot
            self._gen_seq = max(int(manifest.get("generation", 0)),
                                self._gen_seq)
            entries = [(m["name"], self.durable.module_bytes(m["sha256"]),
                        None, None, m.get("tenant")) for m in mods]
            rel = manifest.get("serve_dir")
            self._pending_resume = \
                os.path.join(self.durable.dir, rel) if rel else None
            try:
                self._register(entries, source="resume")
            finally:
                self._pending_resume = None
            gen = self.current
        else:
            # nothing to restore; still make the restart count durable
            self.durable.write_manifest([], 0, None,
                                        self.counters["restarts"])
        self._restore_journal(journal or {}, gen)
        self._journal_sync()

    def _restore_journal(self, journal: dict, gen: Optional[_Generation]):
        from wasmedge_tpu_torch.serve.queue import (
            ServeFuture, ServeRejected, advance_request_ids)

        floor = int(journal.get("max_id", 0))
        self._resume_min = max(int(journal.get("min_id", 0) or 1), 1)
        if floor:
            # every id at or below the floor was issued by a dead process:
            # unknown ones answer the pruned 404, fresh ids go above
            self._resume_floor = floor
            advance_request_ids(floor)
        for entry in journal.get("resolved", []):
            self._result_cache.append(entry)
            self._install_replay(entry, gen)
        if gen is None:
            return
        adopted = dict(gen.server.adopted)
        with gen.server._lock:
            bind_by_id = {r.id: r for r in gen.server._bindings.values()}
        for entry in journal.get("unresolved", []):
            rid = int(entry["id"])
            with self._lock:
                if rid in self._requests:
                    continue
            tenant = entry.get("tenant", "default")
            func = entry.get("func", "")
            args = entry.get("args", [])
            fut = adopted.pop(rid, None)
            if fut is None:
                # accepted but not in the serve checkpoint: re-queue under
                # the original id (at-least-once); its deadline's clock
                # restarts here
                try:
                    fut = gen.server.submit(
                        func, args, tenant=tenant,
                        deadline_s=entry.get("deadline_s"), request_id=rid)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:
                    # unservable after resume: a machine-readable
                    # rejection, never a silently lost id
                    fut = ServeFuture(rid)
                    fut._reject(ServeRejected(
                        f"request {rid} could not be re-queued after "
                        f"gateway restart: {e}"))
                    advance_request_ids(rid)
            self._stash_resumed(GatewayRequest(
                fut, tenant, entry.get("module"), func, gen.gen_id,
                time.monotonic(), args=args,
                deadline_s=entry.get("deadline_s")))
        # adopted checkpoint requests the journal missed (a faulted
        # journal write raced the snapshot): wrap them too
        for rid, fut in adopted.items():
            with self._lock:
                if rid in self._requests:
                    continue
            sr = bind_by_id.get(rid)
            self._stash_resumed(GatewayRequest(
                fut, sr.tenant if sr else "default", None,
                sr.func_name if sr else "", gen.gen_id, time.monotonic(),
                args=(sr.args if sr else ())))

    def _stash_resumed(self, req: GatewayRequest):
        with self._lock:
            self._requests[req.id] = req
            self._note_issued(req.id)
            self.counters["received"] += 1
            self.counters["resumed"] += 1

    def _install_replay(self, entry: dict, gen: Optional[_Generation]):
        from wasmedge_tpu_torch.serve.queue import (
            ServeFuture, advance_request_ids)

        rid = int(entry["id"])
        with self._lock:
            if rid in self._requests:
                return
        fut = ServeFuture(rid)
        if entry.get("ok"):
            fut._resolve([int(c) for c in entry.get("result", [])])
        else:
            fut._reject(resolved_error(entry))
        advance_request_ids(rid)
        req = GatewayRequest(fut, entry.get("tenant", "default"), None,
                             entry.get("func", ""),
                             gen.gen_id if gen else 0, time.monotonic())
        req.finalized = True   # counted by the previous process
        with self._lock:
            self._requests[rid] = req
            self._note_issued(rid)
            self._resolved.append(rid)

    # -- requests ----------------------------------------------------------
    def submit(self, func: str, args, module: Optional[str] = None,
               tenant: str = "default",
               deadline_s: Optional[float] = None) -> GatewayRequest:
        """Edge admission: rate limit, degraded-mode shedding, then the
        current generation's BatchServer.  Raises RateLimited, ShedLoad /
        QueueSaturated (retryable), KeyError (unknown module or func),
        DurabilityError (the journal write failed: the id was never
        accepted), or the serving taxonomy."""
        try:
            self.tenants.check_rate(tenant)
        except RateLimited:
            with self._lock:
                self.counters["rate_limited"] += 1
            raise
        try:
            self._health.maybe_shed(tenant)
        except ShedLoad:
            with self._lock:
                self.counters["shed"] += 1
                self.shed_counts[tenant] = \
                    self.shed_counts.get(tenant, 0) + 1
            raise
        with self._lock:
            if self._closed:
                raise GatewayClosed()
            gen = self._gens[-1] if self._gens else None
        if gen is None:
            raise KeyError("no modules registered")
        qualified = f"{module}:{func}" if module else func
        t_recv = time.monotonic()
        while True:
            try:
                fut = gen.server.submit(qualified, args, tenant=tenant,
                                        deadline_s=deadline_s)
                break
            except WasmError:
                # a submit can race a swap: the captured generation starts
                # draining once its successor is installed and refuses
                # submissions permanently.  That refusal belongs to the
                # stale generation: retry on the successor.  Only a
                # still-current generation's refusal stands.
                with self._lock:
                    cur = self._gens[-1] if self._gens else None
                    closed = self._closed
                if cur is gen or cur is None:
                    with self._lock:
                        self.counters["rejected"] += 1
                    if closed:
                        raise GatewayClosed() from None
                    raise
                gen = cur
            except BaseException:
                with self._lock:
                    self.counters["rejected"] += 1
                raise
        req = GatewayRequest(fut, tenant, module, qualified, gen.gen_id,
                             t_recv, args=args, deadline_s=deadline_s)
        with self._lock:
            self.counters["received"] += 1
            self._requests[req.id] = req
            self._note_issued(req.id)
        # the acceptance is not real until it is durable
        self._journal_sync(strict_req=req)
        return req

    def _note_issued(self, rid: int):
        """Track the id range this gateway has stashed (callers hold
        self._lock); journaled as the resumed pruned-404 window."""
        rid = int(rid)
        self._max_issued = max(self._max_issued, rid)
        if self._min_issued == 0 or rid < self._min_issued:
            self._min_issued = rid

    def request_state(self, request_id: int):
        """('ok', req) for a stash-resident id, ('pruned', None) for an id
        whose resolved entry aged out of the result cache (the distinct
        404 detail), ('unknown', None) otherwise."""
        rid = int(request_id)
        with self._lock:
            req = self._requests.get(rid)
            pruned = req is None and (
                rid in self._pruned_set
                or self._resume_min <= rid <= self._resume_floor)
        if req is not None:
            self.finalize(req)
            return "ok", req
        return ("pruned" if pruned else "unknown"), None

    def wait(self, req: GatewayRequest,
             timeout_s: Optional[float] = None) -> bool:
        """Block on the request's future (the sync-invoke path); the
        gateway's cap applies when the caller sets none."""
        done = req.future.wait(self.sync_wait_s if timeout_s is None
                               else timeout_s)
        if done:
            self.finalize(req)
        return done

    def finalize(self, req: GatewayRequest, journal: bool = True):
        """Account a completed request exactly once (from every path that
        observes completion, and the sweep for never-polled async
        requests).  `journal=False` lets the sweep coalesce many
        resolutions into one durable write."""
        from wasmedge_tpu_torch.serve.queue import DeadlineExceeded

        if req.finalized or not req.future.done:
            return
        with self._lock:
            if req.finalized:
                return
            req.finalized = True
            self._resolved.append(req.id)
            err = req.future.error
            if err is None:
                self.counters["completed"] += 1
            elif isinstance(err, DeadlineExceeded):
                self.counters["deadline"] += 1
            else:
                self.counters["failed"] += 1
            if self.durable is not None:
                try:
                    self._result_cache.append(_resolved_entry(req))
                except Exception:
                    pass   # an unserializable outcome is just not cached
            while len(self._resolved) > self.result_cache:
                pruned_id = self._resolved.popleft()
                self._requests.pop(pruned_id, None)
                # remembered as pruned (bounded), for the 404 detail
                if len(self._pruned) == self._pruned.maxlen:
                    self._pruned_set.discard(self._pruned[0])
                self._pruned.append(pruned_id)
                self._pruned_set.add(pruned_id)
        # never strict: a completed request's durability failure degrades
        # health, it cannot un-complete
        if journal:
            self._journal_sync()

    def sweep(self):
        """Finalize resolved but unpolled async requests (keeps the
        counters complete; called from status)."""
        with self._lock:
            pending = [r for r in self._requests.values()
                       if not r.finalized and r.future.done]
        for r in pending:
            self.finalize(r, journal=False)
        if pending:
            self._journal_sync()   # one durable write for the batch

    # -- edge accounting ---------------------------------------------------
    def count_http(self, code: int):
        with self._lock:
            key = str(int(code))
            self.http_counts[key] = self.http_counts.get(key, 0) + 1

    # -- introspection -----------------------------------------------------
    def health(self, fresh: bool = True) -> dict:
        """The truthful /healthz body (gateway/health.py)."""
        return self._health.health(fresh=fresh)

    def status(self) -> dict:
        self.sweep()
        with self._lock:
            gen = self._gens[-1] if self._gens else None
            out = {
                "generation": gen.gen_id if gen else 0,
                "modules": {
                    name: self.registry.get(name).exported_funcs()
                    for name in (gen.modules if gen else ())},
                "lanes": self.lanes,
                "draining_generations": max(len(self._gens) - 1, 0),
                "gateway": dict(self.counters),
                "http": dict(self.http_counts),
                "tenants": sorted(self.tenants.policies),
                "shed": dict(self.shed_counts),
                "last_swap": dict(self.last_swap)
                if self.last_swap else None,
                "durable": self.durable is not None,
                "device": str(self.device),
            }
            if gen is not None:
                out["queue_depth"] = len(gen.server.queue)
                out["in_flight"] = gen.server.in_flight
                out["serve"] = dict(gen.server.counters)
                out["build_s"] = gen.build_s
                out["kernel_build_s"] = gen.kernel_s
        if self.imagestore_enabled:
            sc = self.registry.segment_cache
            out["coldstart"] = {
                "compile_cache": self.registry.compile_cache.stats(),
                "segments": sc.stats() if sc is not None else None,
                "snapshots": dict(self.snapshot_counts),
                "lowered_count": self.registry.lowered_count,
            }
        out["health"] = self.health()
        return out

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self, drain: bool = True,
                 timeout_s: Optional[float] = None):
        # _reg_lock first: an in-flight registration finishes its swap
        # (its generation lands in the snapshot below) and later ones see
        # _closed
        with self._reg_lock:
            with self._lock:
                self._closed = True
                gens = list(self._gens)
        for g in gens:
            g.server.shutdown(drain=drain, timeout_s=timeout_s)
        for t in self._reapers:
            t.join(timeout=5.0)
        self.sweep()
        self._journal_sync()   # the journal reflects the final state
        self.registry.close()

    def kill(self):
        """Simulated SIGKILL: stop every serving thread WITHOUT draining,
        rejecting futures or flushing the journal (the state a real kill
        -9 leaves on disk), so `GatewayService(resume=True)` over the same
        state_dir is the honest recovery test.  Registry fds are closed."""
        with self._lock:
            self._closed = True   # later registrations see it and stop
        with self._reg_lock:
            pass   # let an in-flight registration's swap finish or fail
        with self._lock:
            gens = list(self._gens)
        for g in gens:
            srv = g.server
            with srv._lock:
                srv._stop = True
                srv._draining = True
                srv._wake.notify_all()
            t = srv._thread
            if t is not None:
                t.join(timeout=30.0)
        self.registry.close()
