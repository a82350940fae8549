"""BatchServer: the continuous-batching execution service.

A copy of the core of `wasmedge_tpu/serve/server.py` (`:77-825`,
`:839-893`, `:1108-1221`) and of its supervision (`:1370-1545`,
`:1599-1760`).  `VM.execute_batch` and `run_mixed` run one
cohort of lanes to its end: a short request admitted behind fib(30)
waits for the whole batch while freed lanes sit parked.  `BatchServer`
turns the batch engine into a long-lived service:

  submit(func, args, tenant=, deadline_s=) -> ServeFuture
      a bounded queue (QueueSaturated backpressure) with per-tenant
      weighted-fair admission and in-flight quotas (serve/queue.py)

  serving loop (step / run_until_idle / start)
      each round expires queued deadlines, installs queued requests into
      the free lanes (serve/recycle.py: the `initial_state` columns, in
      place), runs ONE `steps_per_launch` slice of the engine
      (`run_from_state`: host calls served between launches as always),
      kills lanes past their deadline or `max_steps_per_request`,
      harvests every lane that stopped, resolves its future and parks
      the lane for the next install.  A request's result is the one a
      solo `execute_batch` gives it.

The launch's read-back (`run_slice`'s HostPlanes: trap, retired and
the result rows in one device-to-host copy) serves the round's kills
and harvest; a round without host calls copies from the
device once.  `engine=` takes a prebuilt engine, such as a
`MultiModuleBatchEngine` over several modules (`module:func` names).

Lane compaction (`conf.batch.compact`, batch/compact.py): the server
owns the boundary pass (`_compact_round`, after admission, while lanes
are bound), with narrowing off (serving lanes are capacity, not a fixed
cohort); its engine is marked `_compact_external`, so the engine never
permutes under the bindings.  Each permutation remaps the bindings, the
pending kills, the free lanes and the recycling history.

Supervision: a serving state checkpoints and restores like any batch
(batch/checkpoint.py; the lane->request binding journal rides the
checkpoint's invocation metadata, `serve-<total>.npz`), every
`checkpoint_every_rounds` rounds or on demand (`checkpoint()`, which
waits while a launch slice is in flight: the kernel writes the state's
tensors in place).  A failed launch or serve round (`_recover`) restores
the newest good snapshot, else an idle state, with backoff; requests
admitted after that snapshot are re-queued at the front, so in-flight
requests survive the failure, across processes too (`resume=True`
adopts the lineage and gives the adopted requests fresh futures,
`adopted`).  After `max_retries` consecutive failures the server fails
(`_fail`, EngineFailure): every in-flight and queued future is rejected.
A kernel that does not build (KernelBuildError) fails the server at once:
no retry mends it.
`faults` (testing/faults.py) arms the engine's launch and serve seams and
the checkpoint seams; FailureRecords land on `stats` (else the
process-wide log) and in `failures`.  Stdout is at least once across a
crash restore: a re-queued request may land on another lane, so the
written marks collapse to the restored positions (a replay may print
again what the failed attempt printed; nothing is lost).

Left out until their subsystems are ported (each is off by default in
the reference server): lane virtualization, guest suspend and resume
(effects), resharding and the mesh, integrity audits, autotune and the
recorder (with them, the hv and effects branches of `_recover`, the
checkpoint journal and `_compact_round`).  The recorder's admission
events are kept as a plain list, `admissions`: (request id, tenant,
lane) in admission order.
"""

from __future__ import annotations

import copy
import heapq
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from wasmedge_tpu_torch.batch import checkpoint as ckpt
from wasmedge_tpu_torch.batch.compact import LaneCompactor
from wasmedge_tpu_torch.batch.hostcall import stdout_cursor_reset
from wasmedge_tpu_torch.batch.image import TRAP_DONE
from wasmedge_tpu_torch.batch.interp import KernelBuildError
from wasmedge_tpu_torch.batch.lineage import Lineage
from wasmedge_tpu_torch.batch.supervisor import backoff_seconds
from wasmedge_tpu_torch.common.errors import EngineFailure, ErrCode, WasmError
from wasmedge_tpu_torch.common.statistics import FailureRecord, record_failure
from wasmedge_tpu_torch.serve.queue import (
    DeadlineExceeded, FairQueue, ServeFuture, ServeRejected, ServeRequest,
    advance_request_ids)
from wasmedge_tpu_torch.serve.recycle import LaneRecycler


class BatchServer:
    """Continuous-batching server over one instantiated module (or a
    prebuilt engine).  `weights` / `quotas` map tenant name -> DRR weight
    / most lanes in flight (serve/queue.py).  `faults` is an optional
    testing.faults.FaultInjector armed on the engine's launch and serve
    seams and on the checkpoint seams; `stats` an optional Statistics for
    the FailureRecords.  `resume=True` adopts an existing
    `checkpoint_dir` lineage: the serving state and its in-flight
    requests come back under fresh futures (`adopted`)."""

    def __init__(self, inst=None, store=None, conf=None,
                 lanes: Optional[int] = None, weights=None, quotas=None,
                 engine=None, device="cuda", stats=None, faults=None,
                 checkpoint_dir: Optional[str] = None,
                 resume: bool = False):
        from wasmedge_tpu_torch.batch.engine import BatchEngine
        from wasmedge_tpu_torch.common.configure import Configure

        if engine is not None:
            # a prebuilt engine: its Configure governs the run
            self.conf = engine.conf
            self.engine = engine
        else:
            self.conf = copy.deepcopy(conf) if conf is not None \
                else Configure()
            self.engine = BatchEngine(inst, store=store, conf=self.conf,
                                      lanes=lanes, device=device)
        self.k = self.conf.serve
        self.lanes = self.engine.lanes
        # lane compaction: the server's own compactor, never the engine's
        self.engine._compact_external = True
        self.engine.compactor = None
        self._compactor = None
        self.compact_s = 0.0
        if self.conf.batch.compact:
            self._compactor = LaneCompactor(self.engine, narrow=False)
        self.queue = FairQueue(self.k.queue_capacity, weights=weights,
                               quotas=quotas)
        self.recycler = LaneRecycler(self.engine)
        self.stats = stats
        self.faults = faults
        self.checkpoint_dir = checkpoint_dir
        self.state = None
        self.total = 0
        self._bindings: Dict[int, ServeRequest] = {}
        self._kills: Dict[int, BaseException] = {}
        self._rows = 0   # result rows the launch's read-back carries
        self._stepping = False   # one round at a time (see step())
        self._inflight = False   # a launch slice is running off the lock
        # min-heap of free lanes: lowest-lane-first admission
        self._free: List[int] = list(range(self.lanes))
        self._served_before = np.zeros(self.lanes, bool)
        # checkpoint members, the lane->request bindings as the payload
        self._lineage = Lineage()
        # the stdout cursor's positions taken when self.state was current:
        # the launch slice runs off the lock and its flushes advance the
        # engine's cursor while self.state is still the pre-launch state,
        # so an on-demand checkpoint() journals this copy, not the live
        # cursor (else a restore would skip output the saved state has
        # not produced yet)
        self._stdout_snap = None
        self._consecutive = 0
        self._pending_backoff = 0.0
        self.retries = 0
        # checkpoint-write health: consecutive failed snapshot saves since
        # the last good one, and the last error (the gateway's /healthz
        # reads them: a server that cannot persist its state is degraded)
        self.checkpoint_fail_streak = 0
        self.last_checkpoint_error: Optional[BaseException] = None
        self.failures: List[FailureRecord] = []
        self.failed: Optional[BaseException] = None
        self._draining = False
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._thread = None
        self._stop = False
        self.admissions: List[tuple] = []   # (request id, tenant, lane)
        self.counters = {
            "submitted": 0, "admitted": 0, "completed": 0, "trapped": 0,
            "rejected": 0, "expired": 0, "killed": 0, "recycled_lanes": 0,
            "rounds": 0, "retired_instructions": 0,
        }
        self.adopted: Dict[int, ServeFuture] = {}
        if resume:
            self._adopt_lineage()

    # -- submission --------------------------------------------------------
    def submit(self, func_name: str, args=(), tenant: str = "default",
               deadline_s: Optional[float] = None,
               request_id: Optional[int] = None) -> ServeFuture:
        """Queue one request; returns its future.  Raises QueueSaturated
        when the bounded queue is full, KeyError for an unknown export,
        and the server's terminal error once it has failed.
        `request_id` re-queues a journaled request under its original id
        (the gateway's resume); the process-wide id counter moves past
        it."""
        with self._lock:
            if self.failed is not None:
                raise self.failed
            if self._draining:
                raise WasmError(ErrCode.Terminated,
                                "server is draining; submissions closed")
            # a tenant configured out of admission (quota <= 0 or weight
            # <= 0) can never be installed: reject now, not QueueSaturated
            # (that says "try later")
            quota = self.queue.quotas.get(tenant)
            if (quota is not None and quota <= 0) \
                    or self.queue.weights.get(tenant, 1.0) <= 0:
                raise WasmError(
                    ErrCode.Terminated,
                    f"tenant {tenant!r} has no admission capacity "
                    f"(quota/weight <= 0)")
            self.recycler.func_idx(func_name)  # validate the export now
            now = time.monotonic()
            req = ServeRequest(
                func_name, tuple(int(a) for a in args), tenant=tenant,
                deadline=(now + float(deadline_s))
                if deadline_s is not None else None, t_submit=now,
                request_id=request_id)
            if request_id is not None:
                advance_request_ids(req.id)
            self.queue.push(req)   # raises QueueSaturated on backpressure
            self.counters["submitted"] += 1
            self._wake.notify_all()
            return req.future

    def withdraw(self, request_id: int) -> bool:
        """Remove a still-queued request (counted as rejected); False
        when it was already admitted."""
        with self._lock:
            if self.queue.remove_by_id(int(request_id)) is None:
                return False
            self.counters["rejected"] += 1
            return True

    # -- serving loop ------------------------------------------------------
    @property
    def in_flight(self) -> int:
        """Admitted requests holding a lane."""
        return len(self._bindings)

    def _has_work(self) -> bool:
        return bool(self._bindings or len(self.queue))

    def _flight_by_tenant(self) -> Dict[str, int]:
        """Lanes in flight per tenant (the FairQueue's quota count)."""
        out: Dict[str, int] = {}
        for req in self._bindings.values():
            out[req.tenant] = out.get(req.tenant, 0) + 1
        return out

    def step(self) -> bool:
        """One serving round: expire, admit, run one launch slice (or
        recover from its failure), enforce deadlines and budgets,
        harvest, checkpoint.  Returns True while queued or in-flight work
        remains."""
        with self._lock:
            if self.failed is not None:
                return False
            if self._stepping:
                # another thread is mid-round: wait for it to end
                self._wake.wait(timeout=0.05)
                return self._has_work()
            self._stepping = True
        try:
            return self._step_body()
        finally:
            # only the thread that ran the round takes the backoff its
            # _recover() set, and sleeps off the lock
            with self._lock:
                self._stepping = False
                self._inflight = False   # never strand a waiter
                self._wake.notify_all()
                nap, self._pending_backoff = self._pending_backoff, 0.0
            if nap > 0:
                time.sleep(nap)

    def _step_body(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self._expire_queued(now)
            admitted = self._admit(now)
            if self._compactor is not None and self._bindings:
                self._compact_round()
            run_from = (self.state, self.total) if self._bindings else None
            self._snap_stdout()   # the pre-launch pairing for checkpoint()
            self._inflight = run_from is not None
        # the launch slice runs outside the lock, so that submit() and
        # shutdown() from other threads do not wait for it; only the
        # serving thread reassigns state, total and the bindings
        launched = launch_err = None
        if run_from is not None:
            eng = self.engine
            chunk = max(int(eng.cfg.steps_per_launch), 1)
            try:
                if self.faults is not None:
                    eng._fault_hook = self.faults.fire
                launched = eng.run_slice(
                    run_from[0], run_from[1], run_from[1] + chunk,
                    self._rows)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                launch_err = e
            finally:
                eng._fault_hook = None
        with self._lock:
            self._inflight = False
            self._wake.notify_all()   # a waiting checkpoint() goes on
            if self.failed is not None:
                return False
            progressed = run_from is not None
            host = None
            if progressed:
                if launch_err is not None:
                    # raises the terminal EngineFailure past the budget
                    self._recover(launch_err)
                else:
                    self._consecutive = 0
                    self.state, self.total, host = launched
                    self._snap_stdout()   # the cursor is consistent again
                    self._enforce(time.monotonic(), host)
            self.counters["rounds"] += 1
            harvested = self._harvest(host)
            self._maybe_checkpoint()
            if not (admitted or progressed or harvested) \
                    and not self._bindings and len(self.queue):
                # a submit that raced the launch lands after this round's
                # admission: try it once more before declaring a stall
                if self._admit(time.monotonic()):
                    return True
                # everything queued is admission-blocked with nothing in
                # flight to unblock it: reject rather than strand it
                for req in self.queue.pop_all():
                    self.counters["rejected"] += 1
                    req.future._reject(ServeRejected(
                        f"request {req.id} can never be admitted "
                        f"(tenant {req.tenant!r} admission-blocked)"))
                return False
            return self._has_work()

    def run_until_idle(self, max_rounds: Optional[int] = None) -> int:
        """Drive step() until no work remains; returns rounds executed."""
        rounds = 0
        while self.step():
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
        return rounds

    # -- background drive --------------------------------------------------
    def start(self) -> "BatchServer":
        """Run the serving loop on a background thread until shutdown.
        The thread launches on the engine's device."""
        with self._lock:
            t = self._thread
            if t is not None and t.is_alive() and not self._stop:
                return self
        if t is not None:
            t.join()   # a stopping thread exits at its round's end
        with self._lock:
            if self._thread is t:
                self._thread = None
            if self._thread is not None:   # lost a race to another start()
                return self
            self._stop = False
            self._thread = threading.Thread(target=self._drive,
                                            name="wasmedge-serve",
                                            daemon=True)
            self._thread.start()
        return self

    def _drive(self):
        import torch

        dev = self.engine.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            with self._lock:
                if self._stop:
                    return
                if not self._has_work():
                    # sleep on the condition: submit() and shutdown()
                    # notify it
                    self._wake.wait(timeout=0.05)
                    if self._stop:
                        return
                    if not self._has_work():
                        continue
            try:
                self.step()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:  # the failure is recorded by step()
                return

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Stop admitting submissions and serve what is queued and in
        flight to its end.  Returns True when idle."""
        with self._lock:
            self._draining = True
            self._wake.notify_all()
            threaded = self._thread is not None
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        if threaded:
            while True:
                with self._lock:
                    if not self._has_work() or self.failed is not None:
                        return True
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                time.sleep(0.01)
        while self.step():
            if deadline is not None and time.monotonic() >= deadline:
                return False
        return not self._has_work()

    def shutdown(self, drain: bool = True,
                 timeout_s: Optional[float] = None):
        """Stop the server.  With drain=True queued and in-flight work
        is served first; without, unfinished futures are rejected."""
        if drain:
            self.drain(timeout_s=timeout_s)
        with self._lock:
            self._stop = True
            self._draining = True
            self._wake.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            if not t.is_alive():
                self._thread = None
        with self._lock:
            err = ServeRejected("server shut down")
            for req in list(self._bindings.values()):
                if not req.future.done:
                    self.counters["killed"] += 1   # terminated in flight
                req.future._reject(err)
            self._bindings.clear()
            self._free = list(range(self.lanes))
            for req in self.queue.pop_all():
                self.counters["rejected"] += 1
                req.future._reject(err)

    # -- round phases ------------------------------------------------------
    def _expire_queued(self, now: float):
        for req in self.queue.expire(now):
            self.counters["expired"] += 1
            req.future._reject(DeadlineExceeded(
                f"request {req.id} expired before admission"))

    def _admit(self, now: float) -> int:
        if not self._free or not len(self.queue):
            return 0
        picks = self.queue.pop(len(self._free), self._flight_by_tenant())
        if not picks:
            return 0
        if self.state is None:
            self.state = self.recycler.idle_state(
                self.recycler.func_idx(picks[0].func_name))
        # group by function, so that each install is one column-set pass
        by_func: Dict[int, List[ServeRequest]] = {}
        for req in picks:
            by_func.setdefault(self.recycler.func_idx(req.func_name),
                               []).append(req)
        nres = 0
        for fidx, reqs in by_func.items():
            lanes = [heapq.heappop(self._free) for _ in reqs]
            nargs = max((len(r.args) for r in reqs), default=0)
            args_rows = [[(r.args[i] if i < len(r.args) else 0)
                          for r in reqs] for i in range(nargs)]
            self.state = self.recycler.install(self.state, lanes, fidx,
                                               args_rows)
            nres = max(nres, self.recycler.nresults(fidx))
            for lane, req in zip(lanes, reqs):
                self._bindings[lane] = req
                if self._served_before[lane]:
                    self.counters["recycled_lanes"] += 1
                self._served_before[lane] = True
                self.admissions.append((req.id, req.tenant, lane))
        # the launch's read-back carries the result rows for the harvest
        self._rows = max(self._rows, nres)
        self.counters["admitted"] += len(picks)
        return len(picks)

    def _compact_round(self):
        """Lane compaction's boundary pass (under the lock, before the
        launch): when the policy fires, one gather permutes the lanes, and
        every lane-keyed structure of the server follows its lane: the
        bindings, the pending kills, the free lanes, the recycling history
        and the stdout cursor (permuted by the compactor itself); the
        binding journal is taken from the bindings, so a checkpoint
        always pairs a state with its own journal.  The policy reads the state after this round's installs.
        A launch's read-back (HostPlanes) lives only from that launch to
        the harvest of its round, after this pass, so no mirror taken
        before a permutation feeds a harvest.  `compact_s` sums the
        rounds' host seconds."""
        if self.state is None:
            return
        t0 = time.perf_counter()
        comp = self._compactor
        plan = comp.plan_boundary(self.engine, self.state)
        if plan is not None:
            d, perm = plan
            self.state = comp.permute_state(self.state, perm)
            inv = np.empty(perm.size, np.int64)
            inv[perm] = np.arange(perm.size)
            self._bindings = {int(inv[lane]): req
                              for lane, req in self._bindings.items()}
            self._kills = {int(inv[lane]): exc
                           for lane, exc in self._kills.items()}
            self._served_before = self._served_before[perm]
            self._free = sorted(int(inv[lane]) for lane in self._free)
            comp.fired(d)
            self._snap_stdout()   # the cursor moved with the lanes
        self.compact_s += time.perf_counter() - t0

    def _enforce(self, now: float, host):
        """Deadlines and the per-request step budget on in-flight lanes
        (`host`: the launch's HostPlanes): an offending lane is stopped in
        the trap plane and in `host`, and its future rejected at
        harvest."""
        if not self._bindings or host is None:
            return
        trap, retired = host.trap, host.retired
        cap = int(self.k.max_steps_per_request)
        kill_lanes, kill_codes = [], []
        for lane, req in self._bindings.items():
            if trap[lane] != 0:
                continue
            if req.deadline is not None and now >= req.deadline:
                kill_lanes.append(lane)
                kill_codes.append(int(ErrCode.Terminated))
                self._kills[lane] = DeadlineExceeded(
                    f"request {req.id} exceeded its deadline in flight")
            elif retired[lane] >= cap:
                kill_lanes.append(lane)
                kill_codes.append(int(ErrCode.CostLimitExceeded))
                self._kills[lane] = WasmError(
                    ErrCode.CostLimitExceeded,
                    f"request {req.id} exceeded max_steps_per_request")
        if kill_lanes:
            import torch

            dev = self.state.trap.device
            self.state.trap[torch.as_tensor(kill_lanes, device=dev)] = \
                torch.as_tensor(kill_codes, dtype=torch.int32, device=dev)
            trap[np.asarray(kill_lanes, np.int64)] = kill_codes

    def _harvest(self, host) -> int:
        """Resolve the futures of every bound lane that stopped in `host`
        (the launch's HostPlanes, kills applied); park and free the lanes
        (the recycling half of continuous batching)."""
        if not self._bindings or host is None:
            return 0
        trap, retired = host.trap, host.retired
        done = [lane for lane in self._bindings if trap[lane] != 0]
        if not done:
            return 0
        by_func: Dict[int, List[int]] = {}
        for lane in done:
            by_func.setdefault(
                self.recycler.func_idx(self._bindings[lane].func_name),
                []).append(lane)
        for fidx, lanes in by_func.items():
            cells = self.recycler.harvest_cells(self.state, lanes, fidx,
                                                host)
            for col, lane in enumerate(lanes):
                req = self._bindings.pop(lane)
                code = int(trap[lane])
                first = not req.future.done
                if code == int(TRAP_DONE):
                    req.future._resolve(
                        [int(cells[r, col]) for r in range(cells.shape[0])])
                    if first:
                        self.counters["completed"] += 1
                else:
                    exc = self._kills.pop(lane, None)
                    if exc is None:
                        # a guest trap
                        if first:
                            self.counters["trapped"] += 1
                        exc = WasmError(ErrCode(code)
                                        if code in ErrCode._value2member_map_
                                        else ErrCode.ExecutionFailed)
                    elif first:
                        self.counters["killed"] += 1
                    req.future._reject(exc)
                if first:
                    # install() resets the lane's retired count, so this
                    # is the request's own
                    self.counters["retired_instructions"] += \
                        int(retired[lane])
        self.state = self.recycler.park(self.state, done)
        for lane in done:
            heapq.heappush(self._free, lane)
        return len(done)

    def _fail(self, exc: BaseException):
        """The server's terminal failure (its retries spent): every
        in-flight and queued future is rejected with `exc` (the counters
        still reconcile)."""
        self.failed = exc
        for req in list(self._bindings.values()):
            if not req.future.done:
                self.counters["killed"] += 1
            req.future._reject(exc)
        self._bindings.clear()
        for req in self.queue.pop_all():
            if not req.future.done:
                self.counters["rejected"] += 1
            req.future._reject(exc)

    # -- supervision -------------------------------------------------------
    def _snap_stdout(self):
        """Take the stdout cursor positions that go with the current
        self.state (under the lock, wherever the pairing is known to
        hold; see _stdout_snap)."""
        cur = getattr(self.engine, "_stdout_cursor", None)
        self._stdout_snap = np.zeros(self.lanes, np.int64) \
            if cur is None else cur[0].copy()

    def _record(self, fault_class: str, exc, checkpoint=None):
        rec = FailureRecord(
            fault_class=fault_class,
            error="" if exc is None else repr(exc),
            retry=self.retries, checkpoint=checkpoint,
            tier="serve").stamp()
        self.failures.append(rec)
        if self.stats is not None:
            self.stats.add_failure(rec)
        else:
            record_failure(rec)

    def _recover(self, exc: BaseException):
        """A failed launch or serve round: restore the newest good
        checkpoint (or an idle state), re-queue the requests the snapshot
        does not cover, back off, and keep serving; in-flight requests
        survive the failure.  Past `max_retries` consecutive failures the
        server fails and this raises its EngineFailure.  The failed
        attempt wrote the state's tensors in place, so the restored state
        is always a fresh one.  A kernel that does not build fails the
        server at once and is raised."""
        self.retries += 1
        self._consecutive += 1
        point = getattr(exc, "point", None) or "launch"
        self._record("serve" if point == "serve" else "launch", exc)
        if isinstance(exc, KernelBuildError):
            self._fail(exc)
            raise exc
        if self._consecutive > int(self.k.max_retries):
            self._fail(EngineFailure(
                f"serving loop failed {self._consecutive} times: {exc!r}",
                self.failures))
            raise self.failed
        old_bindings = dict(self._bindings)

        def load(m):
            if self.faults is not None:
                self.faults.fire("checkpoint_load", path=m.path)
            st, tot = ckpt.load(m.path, self.engine)
            return st, tot, dict(m.payload or {})

        got = self._lineage.walk_newest(
            load, lambda e, m: self._record("checkpoint", e,
                                            checkpoint=m.path))
        if got is not None:
            state, total, bindings = got
        else:
            # no surviving snapshot: an all-idle state, and every
            # in-flight request goes back to the head of the queue
            fidx0 = self.recycler.func_idx(
                next(iter(old_bindings.values())).func_name) \
                if old_bindings else 0
            state, total, bindings = self.recycler.idle_state(fidx0), 0, {}
            stdout_cursor_reset(self.engine)
        # Stdout is at least once across a crash restore: unlike the
        # supervisor's fixed cohort, recovery may admit a re-queued
        # request onto another lane, so a lane's written mark no longer
        # describes its future stream; kept, it would swallow a later
        # request's first bytes.  Collapse it to the restored position.
        cur = getattr(self.engine, "_stdout_cursor", None)
        if cur is not None:
            cur[1][:] = cur[0]
        self.state, self.total = state, total
        self._bindings = bindings
        self._snap_stdout()   # the restored state and cursor pair up
        # submission order (request ids), not lane order: lanes are
        # given out again at admission, so lane order would invert a
        # tenant's FIFO across the restore
        covered = {req.id for req in bindings.values()}
        requeue = sorted((req for req in old_bindings.values()
                          if req.id not in covered and not req.future.done),
                         key=lambda r: r.id)
        self.queue.push_front(requeue)
        self._free = sorted(set(range(self.lanes)) - set(bindings))
        self._kills.clear()
        # the sleep happens in step() after the lock is released
        self._pending_backoff = backoff_seconds(self.k, self._consecutive)

    def _maybe_checkpoint(self):
        every = self.k.checkpoint_every_rounds
        if not every or self.state is None:
            return
        if self.counters["rounds"] % int(every):
            return
        # idle rounds do not advance total: a snapshot at the same step
        # count would replace the newest member with the same state
        newest = self._lineage.newest()
        if newest is not None and newest.steps == self.total:
            return
        self._checkpoint_locked()

    def checkpoint(self) -> Optional[str]:
        """Snapshot the serving state and the lane->request binding
        journal; returns the path (None when the save failed: a failed
        snapshot never kills a healthy server).  Under the lock, so the
        state and the journal come from the same round; it waits while a
        launch slice is in flight, since the kernel writes the state's
        tensors in place."""
        with self._lock:
            while self._inflight and self.failed is None:
                self._wake.wait(timeout=0.1)
            return self._checkpoint_locked()

    def _checkpoint_locked(self) -> Optional[str]:
        if self.state is None:
            return None
        if self.checkpoint_dir is None:
            self.checkpoint_dir = tempfile.mkdtemp(prefix="wasmedge-serve-")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.checkpoint_dir,
                            f"serve-{self.total:012d}.npz")
        journal = [dict(lane=lane, **req.asdict())
                   for lane, req in sorted(self._bindings.items())]
        try:
            if self.faults is not None:
                self.faults.fire("checkpoint_save", path=path)
            ckpt.save(path, self.engine, self.state, self.total,
                      invocation={"serve_bindings": journal},
                      stdout_pos=self._stdout_snap)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            self.checkpoint_fail_streak += 1
            self.last_checkpoint_error = e
            self._record("checkpoint", e, checkpoint=path)
            return None
        self.checkpoint_fail_streak = 0
        self.last_checkpoint_error = None
        # the same total gives the same path: Lineage.add replaces the
        # member instead of stacking one the prune would unlink while
        # others still name the file
        self._lineage.add(path, self.total, dict(self._bindings))
        self._lineage.prune(self.k.keep_checkpoints)
        return path

    def _adopt_lineage(self):
        """Cross-process resume: the newest loadable serve-*.npz and its
        binding journal (batch/lineage.py's walk); the adopted requests
        get fresh futures (`self.adopted[id]`).  Older members stay as
        _recover's fallbacks, their journals bound to the same request
        objects by id."""
        lin = self._lineage
        lin.install(Lineage.scan(self.checkpoint_dir, r"serve-(\d+)\.npz"))

        def load(m):
            state, total = ckpt.load(m.path, self.engine)
            inv = ckpt.read_meta(m.path).get("invocation", {})
            return state, total, inv.get("serve_bindings", [])

        got = lin.walk_newest(
            load, lambda e, m: self._record("checkpoint", e,
                                            checkpoint=m.path))
        if got is None:
            return
        state, total, journal = got
        self.state, self.total = state, total
        self._snap_stdout()   # load() set the cursor's positions
        for entry in journal:
            req = ServeRequest.from_journal(entry)
            req.t_submit = time.monotonic()
            self._bindings[int(entry["lane"])] = req
            self.adopted[req.id] = req.future
            advance_request_ids(req.id)
            self._rows = max(self._rows, self.recycler.nresults(
                self.recycler.func_idx(req.func_name)))
        self._free = sorted(set(range(self.lanes)) - set(self._bindings))
        self._served_before[list(self._bindings)] = True
        byid = {r.id: r for r in self._bindings.values()}
        survivors = []
        for m in lin.members[:-1]:
            try:
                j2 = ckpt.read_meta(m.path).get(
                    "invocation", {}).get("serve_bindings", [])
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                self._record("checkpoint", e, checkpoint=m.path)
                continue
            snap2 = {}
            for e2 in j2:
                req2 = byid.get(int(e2["id"]))
                if req2 is None:
                    req2 = ServeRequest.from_journal(e2)
                    advance_request_ids(req2.id)
                snap2[int(e2["lane"])] = req2
            m.payload = snap2
            survivors.append(m)
        newest = lin.members[-1]
        newest.payload = dict(self._bindings)
        lin.members = survivors + [newest]
        lin.prune(self.k.keep_checkpoints)
