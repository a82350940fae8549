"""Statistics: instruction counting, gas metering, wall-clock timers.

A trimmed copy of `wasmedge_tpu/common/statistics.py` (after WasmEdge's
include/common/statistics.h): per-run instruction count, a per-opcode
cost table with a limit (gas) whose excess traps `CostLimitExceeded`, and
the Wasm-vs-host time split.  The scalar engine counts into it
instruction by instruction; `VM.execute_batch` turns its cost limit and
table into the lanes' fuel and weights (`vm.vm.batch_conf_with_gas`).
"""

from __future__ import annotations

import time

from wasmedge_tpu_torch.common.errors import ErrCode, TrapError
from wasmedge_tpu_torch.common.opcodes import NUM_OPCODES

# The cost table covers lowered pseudo-ops (BR/BRZ/BRNZ) appended after the
# wasm opcode space by validator/image.py.
_NUM_COST_SLOTS = NUM_OPCODES + 3


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
        return {
            "instr_count": self.instr_count,
            "total_cost": self.total_cost,
            "wasm_ns": self.wasm_ns,
            "host_ns": self.host_ns,
            "instr_per_second": self.instr_per_second,
        }
