"""Statistics: instruction counting, gas metering, wall-clock timers.

A trimmed copy of `wasmedge_tpu/common/statistics.py` (after WasmEdge's
include/common/statistics.h): per-run instruction count, a per-opcode
cost table with a limit (gas) whose excess traps `CostLimitExceeded`, and
the Wasm-vs-host time split.  The scalar engine counts into it
instruction by instruction; `VM.execute_batch` turns its cost limit and
table into the lanes' fuel and weights (`vm.vm.batch_conf_with_gas`).

`FailureRecord` is the failure taxonomy of supervised execution
(batch/supervisor.py, serve/server.py): every recovered or degraded
incident (a failed launch, a host-serve exception, a corrupt checkpoint,
a poisoned or runaway lane, a rung given up on) lands on a Statistics
instance or in the process-wide bounded log.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional, Tuple

from wasmedge_tpu_torch.common.errors import ErrCode, TrapError
from wasmedge_tpu_torch.common.opcodes import NUM_OPCODES

# The cost table covers lowered pseudo-ops (BR/BRZ/BRNZ) appended after the
# wasm opcode space by validator/image.py.
_NUM_COST_SLOTS = NUM_OPCODES + 3


@dataclasses.dataclass
class FailureRecord:
    """One supervised-execution incident.

    fault_class: "launch" (a kernel launch failed), "serve" (the host-side
    serve round raised), "checkpoint" (an unreadable or corrupt snapshot
    skipped in the lineage, or a failed save), "poison_lane" (a lane set
    repeatedly faulting the kernel, demoted or terminated), "runaway" (a
    lane past the per-lane step cap, terminated), "demote" (an engine rung
    given up on) or "scalar_rerun" (a host-side error inside the scalar
    bottom rung).
    """

    fault_class: str
    error: str = ""
    lanes: Tuple[int, ...] = ()      # affected lanes; () = whole batch
    retry: int = 0                   # retry count when the incident fired
    checkpoint: Optional[str] = None  # checkpoint lineage member involved
    tier: str = ""                   # the rung: "cuda", "cuda_unfused",
    #                                  "scalar", or "serve" for a server
    # Event timestamp (wall clock, time.time()) for humans and logs;
    # durations between incidents come from `mono_s`, the
    # time.monotonic() stamp, which survives wall-clock steps.
    time_s: float = 0.0
    mono_s: float = 0.0

    def asdict(self) -> dict:
        d = dataclasses.asdict(self)
        d["lanes"] = [int(x) for x in self.lanes]
        return d

    def stamp(self) -> "FailureRecord":
        """Fill any unset clocks (idempotent)."""
        if not self.time_s:
            self.time_s = time.time()
        if not self.mono_s:
            self.mono_s = time.monotonic()
        return self


# Process-wide bounded failure log: a supervisor or server given no
# Statistics records here; Statistics instances mirror into it, so one
# export point sees all.
_FAILURE_LOG: deque = deque(maxlen=256)


def record_failure(rec: FailureRecord):
    _FAILURE_LOG.append(rec.stamp())


def recent_failures() -> list:
    return list(_FAILURE_LOG)


def clear_failures():
    _FAILURE_LOG.clear()


class Statistics:
    def __init__(self, conf=None):
        sc = conf.statistics if conf is not None else None
        self.instr_counting = bool(sc.instr_counting) if sc else False
        self.cost_measuring = bool(sc.cost_measuring) if sc else False
        self.time_measuring = bool(sc.time_measuring) if sc else False
        self.cost_limit = sc.cost_limit if sc else (1 << 64) - 1
        self.cost_table = [1] * _NUM_COST_SLOTS
        self.reset()

    def reset(self):
        self.instr_count = 0
        self.total_cost = 0
        self.wasm_ns = 0
        self.host_ns = 0
        self._wasm_t0 = None
        self._host_t0 = None
        self.failures = []  # FailureRecords from supervised runs

    def add_failure(self, rec: FailureRecord):
        """Attach a supervised-execution incident to this run's stats and
        mirror it into the process-wide log."""
        self.failures.append(rec)
        record_failure(rec)

    # -- counters ----------------------------------------------------------
    def inc_instr(self, n: int = 1):
        self.instr_count += n

    def add_cost(self, cost: int):
        self.total_cost += cost
        if self.total_cost > self.cost_limit:
            raise TrapError(ErrCode.CostLimitExceeded)

    def add_instr_cost(self, op_id: int):
        self.add_cost(self.cost_table[op_id])

    def set_cost_limit(self, limit: int):
        self.cost_limit = limit

    # -- timers ------------------------------------------------------------
    def start_wasm(self):
        if self.time_measuring:
            self._wasm_t0 = time.perf_counter_ns()

    def stop_wasm(self):
        if self.time_measuring and self._wasm_t0 is not None:
            self.wasm_ns += time.perf_counter_ns() - self._wasm_t0
            self._wasm_t0 = None

    def start_host(self):
        if self.time_measuring:
            self._host_t0 = time.perf_counter_ns()

    def stop_host(self):
        if self.time_measuring and self._host_t0 is not None:
            self.host_ns += time.perf_counter_ns() - self._host_t0
            self._host_t0 = None

    @property
    def instr_per_second(self) -> float:
        if self.wasm_ns == 0:
            return 0.0
        return self.instr_count / (self.wasm_ns / 1e9)

    def dump(self) -> dict:
        out = {
            "instr_count": self.instr_count,
            "total_cost": self.total_cost,
            "wasm_ns": self.wasm_ns,
            "host_ns": self.host_ns,
            "instr_per_second": self.instr_per_second,
        }
        if self.failures:
            out["failures"] = [r.asdict() for r in self.failures]
        return out
