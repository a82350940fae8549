"""Supervised batch execution: auto-checkpoint, retry, degradation ladder.

A copy of `wasmedge_tpu/batch/supervisor.py` over the port's engines.
Before this layer a single failed launch or host-serve exception
mid-run killed the whole batch and lost every in-flight lane.  The
supervisor wraps `BatchEngine` and `MultiTenantBatchEngine` runs with the
recovery loop a hypervisor owes its guests; it is cheap because a
`BatchState` is plain lane-fastest planes that batch/checkpoint.py
already snapshots:

1. **Periodic checkpointing**: a step and/or wall-clock cadence
   (SupervisorConfigure.checkpoint_every_steps / _every_s), atomic
   writes, a bounded lineage with pruning (batch/lineage.py).  Slices
   land on steps_per_launch boundaries, so a resumed run replays the
   exact launch sequence an uninterrupted run executes: crash and resume
   are bit-identical.

2. **Retry with exponential backoff**: a launch or serve exception
   restores the newest good checkpoint (older lineage members when the
   newest is corrupt; the initial state when none survive) and retries
   under a budget.  The engine writes its state's tensors in place, so a
   failed attempt's state is never reused: every restore gives fresh
   tensors.

3. **The degradation ladder**: `cuda` (the engine as built: blocks,
   super or per-op tables) -> `cuda_unfused` (a shallow copy of the engine
   with the per-op "none" tables, skipped when the engine already runs
   them; a state runs on either, and the image fingerprint ignores the
   encoding, so it adopts the newest lineage member) -> `scalar`
   (`scalar_rerun`: the gas-metered scalar engine, lane by lane from the
   original arguments, only for side-effect-free single-module batches).
   The scalar rung runs on the host, so it exists only under an engine on
   the CPU: under an engine on the card the ladder ends at `cuda_unfused`
   and then raises EngineFailure, and no answer computed on the host
   stands in for the card's (the JAX ladder goes on to its scalar rung
   from any device).  A kernel that does not build (KernelBuildError) is
   no launch fault: it is raised at once, neither retried nor demoted.
   The JAX package's rungs between its kernel and SIMT tiers (Pallas,
   simt_nocomp) have no counterpart: the port has one engine that runs on
   the card and checkpoints, and no tier-up.
   Per-lane poison quarantine: a failure attributed to lanes (exceptions
   carrying `.lanes`) that repeats demotes those lanes to the scalar rung
   (on the CPU, as above) or terminates them (ErrCode.Terminated); a lane
   past `lane_step_cap` retired instructions is a runaway and is
   terminated.

4. **Structured FailureRecords** (common/statistics.py): every incident
   (fault class, lanes, retry count, checkpoint, rung) lands on the given
   Statistics, else in the process-wide log.

Supervised runs are uncompacted: the quarantine, the runaway cap and the
scalar overlay key on physical lane indices across restores.  The engine
is put back as it was given when run() returns.

Side effects: tier-0 stdout is exactly once across restores (each flush
advances a per-lane cursor journaled in every checkpoint, and replayed
records are skipped up to the written mark, batch/hostcall.py
`_stdout_cursor`); the demoted rung shares the engine's cursor.  Tier-1
writes stay at least once; pure-compute batches are exactly once by
construction.
"""

from __future__ import annotations

import copy
import hashlib
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from wasmedge_tpu_torch.batch import checkpoint
from wasmedge_tpu_torch.batch.engine import BatchResult, decode_results
from wasmedge_tpu_torch.batch.hostcall import stdout_cursor_reset
from wasmedge_tpu_torch.batch.image import TRAP_DONE
from wasmedge_tpu_torch.batch.interp import KernelBuildError
from wasmedge_tpu_torch.batch.lineage import Lineage
from wasmedge_tpu_torch.common.errors import (
    EngineFailure, ErrCode, TrapError, WasmError)
from wasmedge_tpu_torch.common.statistics import (
    FailureRecord, Statistics, record_failure)

MASK64 = (1 << 64) - 1


class _TierExhausted(Exception):
    """Internal: the current rung burned its retry budget."""

    def __init__(self, cause):
        super().__init__(repr(cause))
        self.cause = cause


def backoff_seconds(knobs, attempt: int) -> float:
    """Exponential backoff shared by the supervisor and the serving layer
    (both knob objects carry backoff_base_s / _factor / _max_s)."""
    base = float(knobs.backoff_base_s)
    if base <= 0:
        return 0.0
    return min(float(knobs.backoff_max_s),
               base * float(knobs.backoff_factor) ** max(attempt - 1, 0))


def on_card(engine) -> bool:
    """Whether `engine` runs on a CUDA device: then the ladder has no
    rung on the host."""
    return torch.device(engine.device).type == "cuda"


def scalar_rerun(inst, conf, func_name: str, func_idx: int, args_lanes,
                 lanes, max_steps: int):
    """Gas-metered scalar re-execution of `lanes` from their original
    arguments: the ladder's bottom rung and the poison quarantine's.

    Only sound for modules without host imports (no WASI side effects to
    apply twice); callers gate on that.  Each lane runs on a fresh
    instance with a cost limit of `max_steps` (one unit an instruction),
    so an endless guest traps CostLimitExceeded instead of hanging the
    host.  Returns (cells [max(nres, 1), n] uint64 raw result cells, trap
    [n] int32 with TRAP_DONE on success, records), where `records` are
    FailureRecords for host-side errors the scalar engine itself hit
    (guest traps are per-lane trap codes, not incidents)."""
    from wasmedge_tpu_torch.common.types import bits_to_typed, typed_to_bits
    from wasmedge_tpu_torch.executor import Executor
    from wasmedge_tpu_torch.runtime.store import StoreManager

    conf = copy.deepcopy(conf)
    conf.statistics.cost_measuring = True
    conf.statistics.cost_limit = max(int(max_steps), 1)
    ft = inst.funcs[func_idx].functype
    nres = len(ft.results)
    lanes = np.asarray(lanes, np.int64)
    n = int(lanes.size)
    cells = np.zeros((max(nres, 1), n), np.uint64)
    trap = np.zeros(n, np.int32)
    records: List[FailureRecord] = []
    for col, lane in enumerate(lanes):
        # lane args are raw 64-bit cells; the scalar invoke takes typed
        # values (float params would otherwise be re-encoded from bits)
        args = [bits_to_typed(t, int(np.uint64(a[lane])))
                for t, a in zip(ft.params, args_lanes)]
        try:
            # the meter: the scalar engine counts gas only into a
            # Statistics it is given
            ex = Executor(conf, Statistics(conf))
            st = StoreManager()
            fresh = ex.instantiate(st, inst.ast)
            out = ex.invoke(st, fresh.find_func(func_name), args)
        except TrapError as te:
            # a guest trap (CostLimitExceeded from the meter too): a
            # per-lane outcome, as on the card
            trap[col] = int(te.code) or int(ErrCode.CostLimitExceeded)
            continue
        except WasmError:
            # an engine refusal other than a trap (instantiation ...): the
            # lane did not complete within its budget
            trap[col] = int(ErrCode.CostLimitExceeded)
            continue
        except Exception as e:  # a host-side bug: record, do not silence
            records.append(FailureRecord(
                fault_class="scalar_rerun", error=repr(e),
                lanes=(int(lane),), tier="scalar").stamp())
            trap[col] = int(ErrCode.CostLimitExceeded)
            continue
        for r, (t, v) in enumerate(zip(ft.results, out)):
            cells[r, col] = np.uint64(typed_to_bits(t, v) & MASK64)
        trap[col] = TRAP_DONE
    return cells, trap, records


class BatchSupervisor:
    """Drives one engine's batch to completion under supervision.

    `engine` is a BatchEngine or a MultiTenantBatchEngine; `run()` returns
    the same shape their unsupervised entries do (a BatchResult, or one
    per tenant).  `faults` is an optional testing.faults.FaultInjector
    armed on the engine's seams; `stats` an optional
    common.statistics.Statistics that collects the FailureRecords (the
    process-wide log gets them either way).  Checkpoints land in
    `checkpoint_dir` (a temporary directory when None); `resume=True`
    adopts the lineage a previous process left there."""

    def __init__(self, engine, conf=None, stats=None, faults=None,
                 checkpoint_dir: Optional[str] = None,
                 resume: bool = False):
        self.engine = engine
        # the engine as given: run() starts from it, so a demotion in one
        # run() never carries into the next
        self._engine0 = engine
        self.conf = conf if conf is not None else engine.conf
        self.k = self.conf.supervisor
        self.stats = stats
        self.faults = faults
        self.failures: List[FailureRecord] = []
        self.retries = 0
        self.checkpoint_dir = checkpoint_dir
        self.resume = bool(resume)
        self._lineage = Lineage()
        self._restored_from: Optional[str] = None
        self._overlay = {}  # lane -> (result cells, trap) from scalar rung
        self.tier = None    # the rung that produced the last result

    # -- public -----------------------------------------------------------
    def run(self, func_name: Optional[str] = None, args_lanes=None,
            max_steps: int = 10_000_000):
        eng = self._engine0
        # supervised rungs run uncompacted; marking the engine managed
        # outside before a lineage is adopted makes checkpoint.load refuse
        # a lane-compacted snapshot instead of returning lanes shuffled.
        # The engine gets both back when the run ends, so a later
        # unsupervised run on it compacts as configured.
        saved = (getattr(eng, "_compact_external", False),
                 getattr(eng, "compactor", None))
        eng._compact_external = True
        eng.compactor = None
        try:
            return self._run(func_name, args_lanes, max_steps)
        finally:
            eng._compact_external, eng.compactor = saved

    def _run(self, func_name, args_lanes, max_steps):
        self.engine = eng = self._engine0
        self._multi = hasattr(eng, "tenants")
        self._max_steps = int(max_steps)
        self._overlay = {}
        self._replay_tier = False
        if not self._multi:
            ex = eng.inst.exports.get(func_name)
            if ex is None or ex[0] != 0:
                raise KeyError(f"no exported function {func_name}")
            self._func_name = func_name
            self._func_idx = ex[1]
            self._args = []
            for a in (args_lanes or []):
                arr = np.asarray(a, np.int64)
                if arr.ndim == 0:
                    arr = np.full(eng.lanes, arr, np.int64)
                self._args.append(arr)
        # a fresh run never inherits a previous run()'s lineage (stale
        # checkpoints would restore the old run's state under new
        # arguments); only an explicit resume adopts what is on disk
        self._lineage.reset()
        self._adopted = None
        self._invocation = self._invocation_fingerprint()
        self._resumed = self.resume and self._adopt_lineage()
        tiers = ["cuda", "cuda_unfused"]
        if self._scalar_ok():
            tiers.append("scalar")
        last_exc = None
        for tier in tiers:
            try:
                if tier == "cuda_unfused":
                    if self.engine.fusion == "none":
                        continue   # already per-op: nothing to un-fuse
                    self._demote_unfused()
                if tier == "scalar":
                    res = self._run_scalar_tier(max_steps)
                else:
                    state, total = self._run_cuda_tier(max_steps)
                    res = self.engine.results_from_state(state, total) \
                        if self._multi else self._result_single(state,
                                                                total)
                self.tier = tier
                return res
            except _TierExhausted as e:
                last_exc = e.cause
                self._record("demote", e.cause, tier=tier)
        raise EngineFailure(
            f"supervised run failed on every tier: {last_exc!r}",
            self.failures)

    # -- ladder tiers -----------------------------------------------------
    def _demote_unfused(self):
        """Swap the supervised engine for a shallow copy whose tables are
        the per-op "none" encoding.  The copy shares the image, instance,
        state layout, host-call counters and stdout cursor; the encoding
        adds no state plane, so the fused rung's checkpoints restore onto
        it bit for bit (the image fingerprint ignores the encoding).  The
        newest surviving lineage member is adopted, so this rung goes on
        from the fused rung's progress."""
        eng = copy.copy(self.engine)
        eng.set_encoding("none")
        self.engine = eng
        self._replay_tier = True
        got = self._lineage.walk_newest(self._load_member,
                                        self._bad_member)
        if got is not None:
            self._adopted = got
            self._resumed = True

    def _run_cuda_tier(self, max_steps):
        eng = self.engine
        k = self.k
        if self._resumed and self._adopted is not None:
            # an adopted lineage (a cross-process resume or a demotion):
            # go on from the newest good member, loaded already
            state, total = self._adopted
            self._adopted = None
            self._restored_from = self._lineage.newest().path
        else:
            # a fresh run starts a fresh output stream; a replay after a
            # demotion keeps the written mark, so tier-0 output stays
            # exactly once across the restart (the copy shares the
            # engine's cursor)
            stdout_cursor_reset(self.engine,
                                keep_highwater=self._replay_tier)
            state, total = self._initial_state(), 0
        consecutive = 0
        fail_keys = {}
        # anchor the cadence at the starting position (the restored step
        # on resume, else 0)
        self._reset_cadence(total)
        while True:
            target = self._slice_target(total, max_steps)
            try:
                if self.faults is not None:
                    eng._fault_hook = self.faults.fire
                state, total = eng.run_from_state(state, total, target)
            except (KeyboardInterrupt, SystemExit, KernelBuildError):
                raise
            except Exception as e:
                self.retries += 1
                consecutive += 1
                point = getattr(e, "point", None) or "launch"
                lanes = tuple(getattr(e, "lanes", ()) or ())
                cls = "serve" if point == "serve" else "launch"
                self._record(cls, e, lanes=lanes, tier=self._tier_name())
                key = (point, lanes)
                fail_keys[key] = fail_keys.get(key, 0) + 1
                # the failed attempt wrote its state's tensors in place:
                # never reuse `state`, restore from the lineage
                state, total = self._restore()
                if lanes and fail_keys[key] >= k.poison_lane_retries:
                    state = self._quarantine_lanes(state, lanes)
                    fail_keys.pop(key, None)
                    consecutive = 0
                    continue
                if consecutive > k.max_retries:
                    raise _TierExhausted(e)
                self._backoff(consecutive)
                continue
            finally:
                eng._fault_hook = None
            consecutive = 0
            state = self._check_runaways(state)
            if not bool((state.trap == 0).any()) or total >= max_steps:
                return state, total
            self._maybe_checkpoint(state, total)

    def _tier_name(self) -> str:
        return "cuda_unfused" if self._replay_tier else "cuda"

    def _scalar_ok(self) -> bool:
        """Whether the scalar rung may run: an engine on the CPU (the rung
        runs on the host, never in place of the card) and a
        side-effect-free single-module batch."""
        return (not on_card(self.engine) and not self._multi
                and not any(getattr(f, "kind", None) == "host"
                            for f in self.engine.inst.funcs))

    def _run_scalar_tier(self, max_steps):
        eng = self.engine
        lanes = np.arange(eng.lanes, dtype=np.int64)
        cells, trap, recs = scalar_rerun(
            eng.inst, self.conf, self._func_name, self._func_idx,
            self._args, lanes, max_steps)
        for r in recs:
            self._record_rec(r)
        nres = int(eng.inst.lowered.funcs[self._func_idx].nresults)
        results = [cells[r].view(np.int64).copy() for r in range(nres)]
        # retired counts live in device state the scalar rung never has;
        # zeros keep the BatchResult contract (trap is authoritative)
        return BatchResult(results=results, trap=trap,
                           retired=np.zeros(eng.lanes, np.int64), steps=0)

    # -- state / lineage --------------------------------------------------
    def _invocation_fingerprint(self) -> dict:
        """What this run computes: the exported function and a hash of
        the per-lane arguments (multi-tenant: every tenant's).  Recorded
        in each checkpoint and checked at adoption: the image hash alone
        cannot tell f(30) from f(31), and a resume must never answer a
        new call with an old run's snapshot."""
        h = hashlib.sha256()
        if self._multi:
            names = []
            for t in self.engine.tenants:
                names.append(t.func_name)
                for a in t.args_lanes:
                    h.update(np.ascontiguousarray(
                        np.asarray(a, np.int64)).tobytes())
            func = "|".join(names)
        else:
            func = self._func_name
            for a in self._args:
                h.update(np.ascontiguousarray(a).tobytes())
        return {"func": func, "args_sha256": h.hexdigest()}

    def _load_member(self, m):
        """Load one lineage member onto the current engine: the fault
        seam, the invocation binding (a snapshot of another call is
        refused; one with no record is accepted), then checkpoint.load
        (image hash and geometry)."""
        if self.faults is not None:
            self.faults.fire("checkpoint_load", path=m.path)
        inv = checkpoint.read_meta(m.path).get("invocation")
        if inv is not None and inv != self._invocation:
            raise ValueError(
                f"checkpoint invocation mismatch: snapshot is "
                f"{inv}, this run is {self._invocation}")
        return checkpoint.load(m.path, self.engine)

    def _bad_member(self, exc, m):
        self._record("checkpoint", exc, checkpoint=m.path,
                     tier=self._tier_name())

    def _adopt_lineage(self) -> bool:
        """Cross-process resume: adopt the checkpoint_dir lineage a
        previous process wrote.  The newest member is verified now (the
        run never starts from a snapshot that will refuse to load
        mid-recovery; older members are checked when a restore reaches
        them) and kept for the first rung.  True when a good member
        exists."""
        lin = self._lineage
        lin.install(Lineage.scan(self.checkpoint_dir, r"ckpt-(\d+)\.npz"))
        self._adopted = lin.walk_newest(self._load_member,
                                        self._bad_member)
        return bool(lin)

    def _initial_state(self):
        if self._multi:
            return self.engine.initial_state()
        return self.engine.initial_state(self._func_idx, self._args)

    def _restore(self):
        """The newest surviving checkpoint, else the initial state.  A
        member that fails to load (corrupt, truncated, injected) is
        recorded and dropped from the lineage, and the next older one is
        tried."""
        def load(m):
            state, total = self._load_member(m)
            self._restored_from = m.path
            self._reset_cadence(total)
            return state, total

        got = self._lineage.walk_newest(load, self._bad_member)
        if got is not None:
            return got
        self._restored_from = None
        self._reset_cadence(0)
        # a replay from the start: rewind the logical stdout position but
        # keep the written mark, so output the failed attempt already
        # flushed is skipped, not written twice
        stdout_cursor_reset(self.engine, keep_highwater=True)
        return self._initial_state(), 0

    def _reset_cadence(self, total: int):
        """Anchor the checkpoint cadence at the restored position (else a
        restore to an older member leaves the anchor ahead of `total` and
        the replay runs unprotected)."""
        self._last_ckpt_total = int(total)
        self._last_ckpt_wall = time.monotonic()

    def _cadence(self) -> bool:
        return bool(self.k.checkpoint_every_steps
                    or self.k.checkpoint_every_s)

    def _slice_target(self, total, max_steps) -> int:
        # slices end where a checkpoint may be taken; without a cadence
        # one slice runs to the budget.  The two cadences are "whichever
        # fires first": a wall-clock cadence checks at every launch
        # boundary even beside a large step cadence.
        step = None
        if self.k.checkpoint_every_steps:
            step = int(self.k.checkpoint_every_steps)
        if self.k.checkpoint_every_s:
            chunk = max(int(self.engine.cfg.steps_per_launch), 1)
            step = chunk if step is None else min(step, chunk)
        if step is None:
            return max_steps
        return min(max_steps, total + step)

    def _maybe_checkpoint(self, state, total):
        if not self._cadence():
            return
        k = self.k
        due = bool(k.checkpoint_every_steps
                   and total - self._last_ckpt_total
                   >= k.checkpoint_every_steps)
        due = due or bool(k.checkpoint_every_s
                          and time.monotonic() - self._last_ckpt_wall
                          >= k.checkpoint_every_s)
        if not due:
            return
        if self.checkpoint_dir is None:
            self.checkpoint_dir = tempfile.mkdtemp(prefix="wasmedge-ckpt-")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.checkpoint_dir, f"ckpt-{total:012d}.npz")
        try:
            if self.faults is not None:
                self.faults.fire("checkpoint_save", path=path)
            checkpoint.save(path, self.engine, state, total,
                            invocation=self._invocation)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            # a failed snapshot never kills a healthy run
            self._record("checkpoint", e, checkpoint=path,
                         tier=self._tier_name())
            return
        self._lineage.add(path, total)
        self._last_ckpt_total = total
        self._last_ckpt_wall = time.monotonic()
        self._lineage.prune(self.k.keep_checkpoints)

    # -- quarantine -------------------------------------------------------
    def _terminate(self, state, lanes):
        """Stop `lanes` in the trap plane with ErrCode.Terminated."""
        idx = torch.as_tensor(np.asarray(lanes, np.int64),
                              device=state.trap.device)
        state.trap[idx] = int(ErrCode.Terminated)
        return state

    def _quarantine_lanes(self, state, lanes):
        """Lanes that repeatedly fault the kernel: demoted to the scalar
        rung (an engine on the CPU and a side-effect-free single-module
        batch: their results overlay the final harvest) or terminated
        (ErrCode.Terminated); either way the batch goes on without
        them."""
        lane_arr = np.asarray(sorted({int(x) for x in lanes}), np.int64)
        demoted = False
        if self._scalar_ok():
            cells, trap, recs = scalar_rerun(
                self.engine.inst, self.conf, self._func_name,
                self._func_idx, self._args, lane_arr, self._max_steps)
            for r in recs:
                self._record_rec(r)
            for col, lane in enumerate(lane_arr):
                self._overlay[int(lane)] = (cells[:, col].copy(),
                                            int(trap[col]))
            demoted = True
        self._record(
            "poison_lane", None, lanes=tuple(int(x) for x in lane_arr),
            tier="scalar" if demoted else self._tier_name(),
            error="demoted to scalar engine" if demoted
            else "terminated (ErrCode.Terminated)")
        return self._terminate(state, lane_arr)

    def _check_runaways(self, state):
        cap = self.k.lane_step_cap
        if cap is None:
            return state
        trap_np = state.trap.cpu().numpy()
        ret_np = state.retired.cpu().numpy()
        over = np.nonzero((trap_np == 0) & (ret_np >= int(cap)))[0]
        if not over.size:
            return state
        self._record("runaway", None,
                     lanes=tuple(int(x) for x in over),
                     error=f"lane_step_cap={int(cap)} exceeded; "
                           "terminated (ErrCode.Terminated)",
                     tier=self._tier_name())
        return self._terminate(state, over)

    # -- bookkeeping ------------------------------------------------------
    def _backoff(self, attempt: int):
        nap = backoff_seconds(self.k, attempt)
        if nap > 0:
            time.sleep(nap)

    def _record(self, fault_class, exc, lanes=(), tier="cuda",
                checkpoint=None, error=None):
        self._record_rec(FailureRecord(
            fault_class=fault_class,
            error=error if error is not None
            else ("" if exc is None else repr(exc)),
            lanes=tuple(int(x) for x in lanes), retry=self.retries,
            checkpoint=checkpoint or self._restored_from,
            tier=tier).stamp())

    def _record_rec(self, rec: FailureRecord):
        self.failures.append(rec.stamp())
        if self.stats is not None:
            self.stats.add_failure(rec)
        else:
            record_failure(rec)

    # -- harvest ----------------------------------------------------------
    def _result_single(self, state, total):
        nres = int(self.engine.inst.lowered.funcs[self._func_idx].nresults)
        R = max(nres, 1)
        results = decode_results(state.stack_lo[:R].cpu().numpy(),
                                 state.stack_hi[:R].cpu().numpy(), nres)
        trap = state.trap.cpu().numpy().copy()
        retired = state.retired.cpu().numpy().copy()
        for lane, (cells, tc) in self._overlay.items():
            trap[lane] = tc
            for r in range(nres):
                results[r][lane] = np.asarray(
                    [cells[r]], np.uint64).view(np.int64)[0]
        return BatchResult(results=results, trap=trap, retired=retired,
                           steps=total)
