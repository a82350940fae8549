"""Basic-block CFG over the lowered SoA image.

A copy of `wasmedge_tpu/analysis/cfg.py` (`BasicBlock`, `FuncCFG`,
`build_func_cfg`, `_brtable_targets`, `_block_kind`, `_mark_loops`), the
part that lane compaction's divergence scores read (analysis/analyzer.py).
The validator already compiles structured control flow away
(validator/image.py): every branch is an absolute-PC LOP_BR/BRZ/BRNZ,
br_table is a flat (target_pc, keep, pop_to) side table, calls are
absolute function indices.  That makes CFG construction a single linear
pass: leaders are function entries, branch/brtable targets, and the
instruction after any control transfer; edges come straight off the
instruction operands (including the full brtable entry table).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from wasmedge_tpu_torch.common.opcodes import NAME_TO_ID
from wasmedge_tpu_torch.validator.image import (
    LOP_BR,
    LOP_BRNZ,
    LOP_BRZ,
    LoweredModule,
)

_OP_BR_TABLE = NAME_TO_ID["br_table"]
_OP_RETURN = NAME_TO_ID["return"]
_OP_CALL = NAME_TO_ID["call"]
_OP_CALL_INDIRECT = NAME_TO_ID["call_indirect"]
_OP_RETCALL = NAME_TO_ID["return_call"]
_OP_RETCALL_INDIRECT = NAME_TO_ID["return_call_indirect"]
_OP_UNREACHABLE = NAME_TO_ID["unreachable"]

# Terminators that leave the function (no intra-function successor).
_EXIT_OPS = frozenset((_OP_RETURN, _OP_RETCALL, _OP_RETCALL_INDIRECT,
                       _OP_UNREACHABLE))
# Terminators that transfer control somewhere else in the function.
_BRANCH_OPS = frozenset((LOP_BR, LOP_BRZ, LOP_BRNZ, _OP_BR_TABLE))
# Calls end a block too: the interpreter's pc leaves the straight-line
# run (superinstruction fusion cannot span them) and control resumes at
# pc+1 only after the callee returns.
_CALL_OPS = frozenset((_OP_CALL, _OP_CALL_INDIRECT))


@dataclasses.dataclass
class BasicBlock:
    """One straight-line run [start, end] (both pcs inclusive)."""

    start: int
    end: int
    succ: Tuple[int, ...] = ()      # successor block START pcs
    kind: str = "fallthrough"       # terminator class (see _block_kind)
    brtable_entries: int = 0        # entry-table rows (incl. default)
    calls: Tuple[int, ...] = ()     # static callee func indices in block
    dynamic_call: bool = False      # block contains call_indirect
    in_loop: bool = False           # member of a CFG cycle
    is_loop_head: bool = False      # target of a back edge

    def pcs(self) -> range:
        return range(self.start, self.end + 1)


@dataclasses.dataclass
class FuncCFG:
    """Blocks of one defined function, keyed by start pc."""

    func_idx: int
    entry_pc: int
    end_pc: int
    blocks: List[BasicBlock]
    has_loop: bool = False

    def block_at(self, pc: int) -> Optional[BasicBlock]:
        for b in self.blocks:
            if b.start <= pc <= b.end:
                return b
        return None

    @property
    def by_start(self) -> Dict[int, BasicBlock]:
        return {b.start: b for b in self.blocks}


def _brtable_targets(image: LoweredModule, pc: int) -> List[int]:
    """All entry-table targets of a br_table, default included."""
    base, n = image.a[pc], image.b[pc]
    return [image.br_table[(base + e) * 3] for e in range(n + 1)]


def _block_kind(op: int) -> str:
    if op == LOP_BR:
        return "br"
    if op == LOP_BRZ:
        return "brz"
    if op == LOP_BRNZ:
        return "brnz"
    if op == _OP_BR_TABLE:
        return "br_table"
    if op == _OP_RETURN:
        return "return"
    if op in (_OP_RETCALL, _OP_RETCALL_INDIRECT):
        return "tail_call"
    if op == _OP_UNREACHABLE:
        return "unreachable"
    if op == _OP_CALL:
        return "call"
    if op == _OP_CALL_INDIRECT:
        return "call_indirect"
    return "fallthrough"


def build_func_cfg(image: LoweredModule, func_idx: int) -> FuncCFG:
    """CFG of one defined function (entry_pc >= 0)."""
    fn = image.funcs[func_idx]
    lo, hi = fn.entry_pc, fn.end_pc
    leaders = {lo}
    for pc in range(lo, hi + 1):
        op = image.op[pc]
        if op in (LOP_BR, LOP_BRZ, LOP_BRNZ):
            leaders.add(image.a[pc])
        elif op == _OP_BR_TABLE:
            leaders.update(_brtable_targets(image, pc))
        if (op in _BRANCH_OPS or op in _EXIT_OPS or op in _CALL_OPS) \
                and pc + 1 <= hi:
            leaders.add(pc + 1)
    leaders = sorted(t for t in leaders if lo <= t <= hi)

    blocks: List[BasicBlock] = []
    for i, start in enumerate(leaders):
        end = (leaders[i + 1] - 1) if i + 1 < len(leaders) else hi
        last = image.op[end]
        kind = _block_kind(last)
        succ: List[int] = []
        brtable_entries = 0
        if last == LOP_BR:
            succ = [image.a[end]]
        elif last in (LOP_BRZ, LOP_BRNZ):
            succ = [image.a[end]]
            if end + 1 <= hi:
                succ.append(end + 1)
        elif last == _OP_BR_TABLE:
            targets = _brtable_targets(image, end)
            brtable_entries = len(targets)
            seen = set()
            for t in targets:
                if t not in seen:
                    seen.add(t)
                    succ.append(t)
        elif last in _EXIT_OPS:
            succ = []
        else:  # call / call_indirect / plain fallthrough into a leader
            if end + 1 <= hi:
                succ = [end + 1]
        calls = tuple(image.a[pc] for pc in range(start, end + 1)
                      if image.op[pc] in (_OP_CALL, _OP_RETCALL))
        dynamic = any(image.op[pc] in (_OP_CALL_INDIRECT,
                                       _OP_RETCALL_INDIRECT)
                      for pc in range(start, end + 1))
        blocks.append(BasicBlock(
            start=start, end=end, succ=tuple(succ), kind=kind,
            brtable_entries=brtable_entries, calls=calls,
            dynamic_call=dynamic))

    cfg = FuncCFG(func_idx=func_idx, entry_pc=lo, end_pc=hi,
                  blocks=blocks)
    _mark_loops(cfg)
    return cfg


def _mark_loops(cfg: FuncCFG):
    """Tag blocks on CFG cycles (iterative Tarjan SCC) and loop heads
    (back-edge targets from an iterative DFS).  `has_loop` drives the
    bounded/unbounded cost verdict; `in_loop` weights the n-gram census
    (a sequence inside a loop is hotter than straight-line prologue)."""
    idx_of = {b.start: i for i, b in enumerate(cfg.blocks)}
    n = len(cfg.blocks)
    succs = [[idx_of[s] for s in b.succ if s in idx_of]
             for b in cfg.blocks]

    # Tarjan SCC, iterative (functions can be deep).
    index = [0] * n
    low = [0] * n
    on_stack = [False] * n
    visited = [False] * n
    stack: List[int] = []
    counter = [1]

    for root in range(n):
        if visited[root]:
            continue
        work = [(root, 0)]
        while work:
            v, ei = work[-1]
            if ei == 0:
                visited[v] = True
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            while ei < len(succs[v]):
                w = succs[v][ei]
                ei += 1
                if not visited[w]:
                    work[-1] = (v, ei)
                    work.append((w, 0))
                    advanced = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == v:
                        break
                cyclic = len(scc) > 1 or v in succs[v]
                if cyclic:
                    for w in scc:
                        cfg.blocks[w].in_loop = True
                    cfg.has_loop = True
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])

    # Loop heads: DFS back-edge targets (an edge into a block currently
    # on the DFS path).
    color = [0] * n  # 0 white, 1 on-path, 2 done
    work2: List[Tuple[int, int]] = [(0, 0)] if n else []
    while work2:
        v, ei = work2.pop()
        if ei == 0:
            color[v] = 1
        if ei < len(succs[v]):
            work2.append((v, ei + 1))
            w = succs[v][ei]
            if color[w] == 0:
                work2.append((w, 0))
            elif color[w] == 1:
                cfg.blocks[w].is_loop_head = True
        else:
            color[v] = 2
