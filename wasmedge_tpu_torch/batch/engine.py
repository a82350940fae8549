"""BatchEngine: runs one module's export over N lanes on the warp-interpreter.

Counterpart of `wasmedge_tpu/batch/engine.py` (`BatchState`,
`BatchResult`, `pack_lane_args`, `check_batch_entry`, `initial_state`) and
of the reference's host launch loop (`BatchEngine.run_from_state`,
`wasmedge_tpu/batch/engine.py:2414-2527`): launch chunks of
`steps_per_launch` instructions, serve the lanes parked at host calls
between launches (batch/hostcall.py), until every lane has stopped or
`max_steps` is reached, then collect per-lane results.  With
`optimistic` (B3) the engine keeps the per-warp state of optimistic
convergence (`WarpState`: each warp's interval and its rollback, entry and
commit counts, and the snapshot's shadow planes) next to the state.

Tier 0 (`tier0_hostcalls`, on by default as in the reference): the
interpreter retires pure WASI calls in place (`t0_effective_kinds`), with
the per-lane call counts `t0_ctr [4, lanes]` and, when the module's
fd_write is served, the stdout record buffer `so_buf [SW, lanes]` and its
fill `so_off [lanes]` in the state (None when tier 0 is off, as in the
reference's `t0_state_planes`).  Each launch gets the time base read on
the host just before it (`t0_time_planes`); the buffered stdout is
flushed before every serve round and at the end of the run, and the
`t0_ctr` delta of the run is folded into `hostcall_stats`.

Tables, segments and tail calls (the reference's r05 planes,
`r05_state_planes`): an image that mutates its table gives every lane its
own table `tab [table_cap, lanes]` (funcidx+1, 0 = null) and size `tsize
[lanes]`; one with table.init / elem.drop its element segments' dropped
flags `edrop [n_elem, lanes]`, one with memory.init / data.drop its data
segments' `ddrop [n_data, lanes]` (each None otherwise).  `table_cap` is
the declared maximum clamped by `table_elems_per_lane` (table.grow past
it returns -1).  With fuel on and a `cost_table` whose weights are not
all 1, each instruction costs its opcode's weight (`cost_plane`).

State layout is the reference's, lane fastest: value stacks
`[value_stack_depth, lanes]` (two planes, lo and hi, and two more, e2
and e3, when the image holds v128 ops), frames `[call_stack_depth,
lanes]`, globals
`[n_globals, lanes]`, memory `[words, lanes]` and the per-lane control
planes `[lanes]`, all int32.  The kernel updates them in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from wasmedge_tpu_torch.batch.compact import arm, restore_mirrors
from wasmedge_tpu_torch.batch.hostcall import (
    flush_stdout_buffers, serve_batch_state, stdout_cursor_reset)
from wasmedge_tpu_torch.batch.image import (
    CLS_DATA_DROP, CLS_ELEM_DROP, CLS_MEMGROW, CLS_MEMINIT, CLS_TABLE_GROW,
    CLS_TABLE_INIT, T0_FD_WRITE, T0_NEEDS_MEMORY, TRAP_DONE, TRAP_HOSTCALL,
    batchability, build_device_image, slice_refusal)
from wasmedge_tpu_torch.batch.interp import device_tables, run_chunk
from wasmedge_tpu_torch.batch.memwin import HBM_WINDOW_ROWS
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.batch.tier0 import t0_statics
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.opcodes import Op
from wasmedge_tpu_torch.common.types import ValType

PAGE_WORDS = 65536 // 4

CONTROL_FIELDS = ("pc", "sp", "fp", "opbase", "call_depth", "trap",
                  "retired", "fuel", "mem_pages")
PLANE_FIELDS = ("stack_lo", "stack_hi", "fr_ret_pc", "fr_fp", "fr_opbase",
                "glob_lo", "glob_hi", "mem")
# the upper two words of a v128 cell: [D, L] for images with v128 ops,
# None otherwise (the reference BatchState's stack_e2 / stack_e3)
SIMD_FIELDS = ("stack_e2", "stack_e3")
# tier 0: the per-lane call counts [T0_CTR_ROWS, L] (clock, random,
# fd_write, sched_yield + proc_exit), the stdout record buffer [SW, L] and
# its fill in words [L]; None when tier 0 is off (so_buf and so_off also
# when the module's fd_write is not served in place)
T0_FIELDS = ("t0_ctr", "so_buf", "so_off")
# tables and segments: each lane's table [table_cap, L] and its size [L]
# (an image that mutates its table), the dropped flags of the element
# segments [n_elem, L] (table.init / elem.drop) and of the data segments
# [n_data, L] (memory.init / data.drop); None when the image has no use
# for them (the reference's r05_state_planes)
A3_FIELDS = ("tab", "tsize", "edrop", "ddrop")
OPTIONAL_FIELDS = SIMD_FIELDS + T0_FIELDS + A3_FIELDS
T0_CTR_ROWS = 4


@dataclasses.dataclass
class BatchState:
    """Per-lane interpreter state (the reference BatchState's fields that
    this slice uses), int32 tensors on one device; `stack_e2` and
    `stack_e3` are None unless the image holds v128 ops, the tier-0
    planes (`T0_FIELDS`) None unless tier 0 is on, the table and segment
    planes (`A3_FIELDS`) None unless the image uses them."""

    pc: torch.Tensor
    sp: torch.Tensor
    fp: torch.Tensor
    opbase: torch.Tensor
    call_depth: torch.Tensor
    trap: torch.Tensor
    retired: torch.Tensor
    fuel: torch.Tensor
    mem_pages: torch.Tensor
    stack_lo: torch.Tensor
    stack_hi: torch.Tensor
    fr_ret_pc: torch.Tensor
    fr_fp: torch.Tensor
    fr_opbase: torch.Tensor
    glob_lo: torch.Tensor
    glob_hi: torch.Tensor
    mem: torch.Tensor
    stack_e2: Optional[torch.Tensor] = None
    stack_e3: Optional[torch.Tensor] = None
    t0_ctr: Optional[torch.Tensor] = None
    so_buf: Optional[torch.Tensor] = None
    so_off: Optional[torch.Tensor] = None
    tab: Optional[torch.Tensor] = None
    tsize: Optional[torch.Tensor] = None
    edrop: Optional[torch.Tensor] = None
    ddrop: Optional[torch.Tensor] = None

    FIELDS = CONTROL_FIELDS + PLANE_FIELDS + OPTIONAL_FIELDS

    @classmethod
    def from_numpy(cls, planes: dict, device) -> "BatchState":
        return cls(**{f: None if planes.get(f) is None else torch.as_tensor(
            np.array(planes[f], np.int32), device=device)
            for f in cls.FIELDS})

    def to_numpy(self) -> dict:
        return {f: None if getattr(self, f) is None
                else getattr(self, f).cpu().numpy() for f in self.FIELDS}

    def clone(self) -> "BatchState":
        return BatchState(**self.planes(clone=True))

    def planes(self, clone: bool = False) -> dict:
        """Field name -> tensor (a copy with clone) of the planes this
        state has."""
        return {f: getattr(self, f).clone() if clone else getattr(self, f)
                for f in self.FIELDS if getattr(self, f) is not None}


@dataclasses.dataclass
class BatchResult:
    results: List[np.ndarray]  # one [lanes] int64 raw-cell array per result
    # trap[k]: TRAP_DONE (-1) = finished, >0 = ErrCode trap, 0 = lane was
    # still running when max_steps ran out (its results slot is garbage)
    trap: np.ndarray
    retired: np.ndarray  # [lanes] instructions retired
    steps: int  # interpreter steps executed (the longest lane's count)

    @property
    def completed(self) -> np.ndarray:
        return self.trap == TRAP_DONE


@dataclasses.dataclass
class HostPlanes:
    """The host's copy of a state's `trap` and `retired` planes [L] and
    of its first result rows (`lo`, `hi` [rows, L]), read back in
    one device-to-host copy after a launch and kept equal to the state
    through the serve round that follows it."""

    trap: np.ndarray
    retired: np.ndarray
    lo: np.ndarray
    hi: np.ndarray


def check_batch_entry(inst, func_name: str) -> int:
    """Resolve an exported batch entry; v128 signatures are refused (the
    cells carry only 64 bits).  Returns the function index."""
    ex = inst.exports.get(func_name)
    if ex is None or ex[0] != 0:
        raise KeyError(f"no exported function {func_name}")
    ft = inst.funcs[ex[1]].functype
    if ValType.V128 in tuple(ft.params) + tuple(ft.results):
        raise ValueError(
            f"batch entry functions cannot take or return v128 ({func_name})")
    return ex[1]


def pack_lane_args(args_lanes, lanes: int, depth: int):
    """Entry arguments -> the (stack_lo, stack_hi) int32 planes: one int64
    cell per (arg, lane), scalars broadcast, shapes validated."""
    stack_lo = np.zeros((depth, lanes), np.int32)
    stack_hi = np.zeros((depth, lanes), np.int32)
    for i, arg in enumerate(args_lanes):
        arr = np.asarray(arg, dtype=np.int64)
        if arr.ndim == 0:
            arr = np.full(lanes, arr, np.int64)
        if arr.shape != (lanes,):
            raise ValueError(
                f"arg {i}: expected shape ({lanes},) (one value per "
                f"lane) or a scalar, got {arr.shape}")
        stack_lo[i] = (arr & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        stack_hi[i] = ((arr >> 32) & 0xFFFFFFFF).astype(np.uint32) \
            .view(np.int32)
    return stack_lo, stack_hi


def decode_results(stack_lo: np.ndarray, stack_hi: np.ndarray,
                   nres: int) -> List[np.ndarray]:
    out = []
    for r in range(nres):
        lo = stack_lo[r].view(np.uint32).astype(np.uint64)
        hi = stack_hi[r].view(np.uint32).astype(np.uint64)
        out.append((lo | (hi << np.uint64(32))).view(np.int64))
    return out


def new_hostcall_stats() -> dict:
    """Per-engine host-call counters: tier0_* the calls retired in the
    kernel (the reference's names), tier1_calls the lanes served between
    launches, tier1_vectorized those served by a vectorized WASI
    implementation, serve_rounds the park -> serve -> re-arm cycles,
    stdout_flushes and stdout_bytes the buffered stdout drained, and
    serve_s / flush_s the host seconds of serve rounds and flushes."""
    return {"tier0_clock": 0, "tier0_random": 0, "tier0_fd_write": 0,
            "tier0_sys": 0, "tier0_calls": 0,
            "tier1_calls": 0, "tier1_vectorized": 0, "serve_rounds": 0,
            "stdout_flushes": 0, "stdout_bytes": 0, "serve_s": 0.0,
            "flush_s": 0.0}


def t0_effective_kinds(img, cfg) -> Optional[np.ndarray]:
    """Per-pc tier-0 kinds this image and configuration serve in the
    kernel, or None when tier 0 is off (the knob, or no served stub): the
    reference's gate (`wasmedge_tpu/batch/engine.py:253-270`): fd_write
    only where `t0_fdwrite_safe`, the kinds that write guest memory only
    with a memory."""
    if not cfg.tier0_hostcalls:
        return None
    kinds = np.asarray(img.t0kind, np.int32).copy()
    if not img.t0_fdwrite_safe:
        kinds[kinds == T0_FD_WRITE] = 0
    if not img.has_memory:
        kinds[np.isin(kinds, T0_NEEDS_MEMORY)] = 0
    if not (kinds != 0).any():
        return None
    return kinds


def a3_plane_rows(img) -> dict:
    """The rows of each table and segment plane the image needs (the
    reference's r05_plane_names / r05_state_planes): "tab" (the table
    capacity) and "tsize" (None: a [lanes] plane) when the code mutates
    its table, "edrop" with table.init or elem.drop, "ddrop" with
    memory.init or data.drop."""
    out = {}
    if img.has_table_mut:
        out["tab"] = max(int(img.table_cap or img.table0.shape[0]), 1)
        out["tsize"] = None
    if np.isin(img.cls, (CLS_TABLE_INIT, CLS_ELEM_DROP)).any():
        out["edrop"] = int(img.elem_len.shape[0])
    if np.isin(img.cls, (CLS_MEMINIT, CLS_DATA_DROP)).any():
        out["ddrop"] = int(img.data_len.shape[0])
    return out


def cost_plane(img, cfg) -> Optional[np.ndarray]:
    """Per-pc gas weights [code_len] int32, or None for flat gas (one
    unit an instruction): the rule of the reference's step builder
    (`wasmedge_tpu/batch/engine.py:402-411`), the cost table gathered
    through the image's opcode plane, weights clipped to [0, 2**30], only
    with fuel on and a weight other than 1."""
    ct = cfg.cost_table
    if cfg.fuel_per_launch is None or ct is None or \
            not any(c != 1 for c in ct):
        return None
    ct = np.clip(np.asarray(ct, np.int64), 0, 1 << 30).astype(np.int32)
    return ct[np.clip(img.op_id, 0, len(ct) - 1)]


def t0_time_planes() -> np.ndarray:
    """The per-launch time base: (realtime, monotonic) ns as int32 (lo,
    hi) pairs, [2, 2] (the reference's `t0_time_planes`).  Read on the
    host just before each launch; clock_time_get returns it plus the
    lane's call count, so values rise per lane even within one launch."""
    out = np.zeros((2, 2), np.int32)
    for r, ns in enumerate((time.time_ns(), time.monotonic_ns())):
        out[r, 0] = np.int32(np.uint32(ns & 0xFFFFFFFF))
        out[r, 1] = np.int32(np.uint32((ns >> 32) & 0xFFFFFFFF))
    return out


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU;
    a card that is asked for (or left as the default) must exist.  A card
    without an index is resolved to the current one, so that a thread
    that later launches on the engine's tensors (a server's) can select
    that card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch interpreter")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class BatchEngine:
    """Runs one instantiated module's exports over `lanes` lanes.

    Lane compaction (`conf.batch.compact`, batch/compact.py): `run` arms
    a fresh `LaneCompactor` as `compactor` (None with the knob off), which
    `run_slice` asks before each launch to permute and narrow the lanes,
    and through which `run` gathers the results back to their lanes.  A
    server marks its engine `_compact_external` and compacts at its own
    boundaries."""

    compactor = None
    _compact_external = False

    def __init__(self, inst, store=None, conf: Optional[Configure] = None,
                 lanes: Optional[int] = None, device="cuda"):
        self.conf = conf or Configure()
        self.cfg = self.conf.batch
        self.lanes = lanes or self.cfg.lanes
        self.inst = inst
        self.device = resolve_device(device)
        host_imports = {i for i, f in enumerate(inst.funcs)
                        if f.kind == "host"}
        reason = batchability(inst.lowered, host_imports=host_imports,
                              n_memories=len(inst.memories or ()))
        if reason is not None:
            raise ValueError(f"module not batchable: {reason}")
        for g in inst.globals:
            if g.type.val_type == ValType.V128:
                raise ValueError("module not batchable: v128-typed global")
        img = build_device_image(
            inst.lowered, memories=inst.memories, globals_=inst.globals,
            table0=_table_snapshot(inst, store), mod=inst.ast,
            elem_segs=_elem_snapshot(inst, store),
            data_segs=[bytes(d.data) for d in inst.datas])
        # per-lane table capacity for table.grow, as the page ceiling
        # below: the declared max clamped by the knob; table.grow reads
        # it from its `b` (engine.py:2015-2028 of the reference)
        tsize0 = img.table0.shape[0]
        if img.has_table_grow:
            declared = img.table_max if img.table_max > 0 \
                else self.cfg.table_elems_per_lane
            img.table_cap = max(tsize0, min(declared,
                                            self.cfg.table_elems_per_lane))
            img.b[img.cls == CLS_TABLE_GROW] = img.table_cap
        else:
            img.table_cap = tsize0
        # static per-lane memory ceiling: the declared max clamped by the
        # knob (engine.py:2035-2040 of the reference); memory.grow reads
        # it from its `b`, as table.grow reads its capacity, so that in a
        # concatenated image (batch/multitenant.py) each tenant's grows
        # keep their own module's ceiling
        if img.has_memory:
            declared = img.mem_pages_max if img.mem_pages_max > 0 \
                else self.cfg.memory_pages_per_lane
            img.mem_pages_max = max(
                img.mem_pages_init,
                min(declared, self.cfg.memory_pages_per_lane))
            img.b[img.cls == CLS_MEMGROW] = img.mem_pages_max
        reason = slice_refusal(img)
        if reason is not None:
            raise NotImplementedError(reason)
        self._setup_image(img)

    def _setup_image(self, img) -> None:
        """What follows from the image: the encoding, memory and B3
        choices, the tier-0 kinds and gas weights, the code tables on the
        device, the per-warp state and the host-call counters (shared with
        the concatenated engine of batch/multitenant.py)."""
        self.img = img
        self.fusion = fusion_of(self.cfg.block_fusion, img.has_simd)
        self.mem_window = mem_window_of(self.cfg.mem_hbm, img)
        self.optimistic = optimistic_of(self.cfg.optimistic)
        self.t0kinds = t0_effective_kinds(img, self.cfg)
        # weighted gas: each pc's weight, None for flat gas
        self.cost = cost_plane(img, self.cfg)
        self.set_encoding(self.fusion)
        # per-warp state of optimistic convergence (its shadow planes are
        # allocated at the first run)
        self.warps = WarpState.new(self.lanes, self.device) \
            if self.optimistic else None
        self.hostcall_stats = new_hostcall_stats()

    def set_encoding(self, fusion: str) -> None:
        """Build the code tables in the encoding `fusion` ("none",
        "blocks", "super") with the engine's memory mode, B3 mode, stack
        depth, tier-0 kinds and gas weights.  The supervisor's demoted
        rung is a shallow copy of an engine with the per-op "none"
        tables; a state runs on either."""
        self.fusion = fusion
        self.tables = device_tables(
            self.img, self.device, fusion=fusion, mem_window=self.mem_window,
            optimistic=self.optimistic, stack_depth=self.cfg.value_stack_depth,
            t0kinds=self.t0kinds,
            t0=None if self.t0kinds is None else t0_statics(self.cfg),
            cost=self.cost)

    @property
    def optimistic_stats(self) -> dict:
        """Warps that entered a launch optimistically, rollbacks and
        clean commits, over every launch so far (zeros when
        `optimistic` is off)."""
        if self.warps is None:
            return {"entered": 0, "rollbacks": 0, "commits": 0}
        return self.warps.stats()

    def resolve_func(self, k: int):
        """Function index of a HOSTCALL stub -> its FunctionInstance."""
        return self.inst.funcs[k]

    def mem_pages_max_of(self, k: int) -> int:
        """The page ceiling of the module that owns function index `k`
        (a host function that grows memory keeps to it)."""
        return int(self.img.mem_pages_max)

    def export_func_idx(self, func_name: str) -> int:
        """Engine-global function index of an exported batch entry (the
        serving layer's LaneRecycler resolves names through it; the
        multi-module engine takes `module:func` names).  Raises KeyError
        for an unknown export, ValueError for a v128 signature."""
        return check_batch_entry(self.inst, func_name)

    def func_nresults(self, func_idx: int) -> int:
        """Result arity of an engine-global function index."""
        return int(self.img.f_nresults[func_idx])

    # -- state -------------------------------------------------------------
    def initial_state(self, func_idx: int, args_lanes) -> BatchState:
        cfg, L, img = self.cfg, self.lanes, self.img
        meta = self.inst.lowered.funcs[func_idx]
        D, CD = cfg.value_stack_depth, cfg.call_stack_depth
        stack_lo, stack_hi = pack_lane_args(args_lanes, L, D)
        dev = self.device

        def full(v):
            return torch.full((L,), int(v), dtype=torch.int32, device=dev)

        mem = torch.zeros((memory_words(img), L), dtype=torch.int32,
                          device=dev)
        if img.mem_init.shape[0] > 1 or img.mem_pages_init:
            init = torch.as_tensor(img.mem_init, device=dev)
            mem[: init.shape[0]] = init[:, None]
        fuel0 = cfg.fuel_per_launch if cfg.fuel_per_launch is not None else 0

        def planes(rows):
            return torch.zeros((rows, L), dtype=torch.int32, device=dev)

        e2, e3 = (planes(D), planes(D)) if img.has_simd else (None, None)
        t0 = {}
        if self.t0kinds is not None:
            t0["t0_ctr"] = planes(T0_CTR_ROWS)
            if (self.t0kinds == T0_FD_WRITE).any():
                t0["so_buf"] = planes(max(int(cfg.stdout_buffer_words), 16))
                t0["so_off"] = full(0)

        a3 = {}
        for f, rows in a3_plane_rows(img).items():
            if f == "tab":
                tab = np.zeros((rows, L), np.int32)
                n0 = min(img.table0.shape[0], rows)
                tab[:n0] = img.table0[:n0, None]
                a3[f] = torch.as_tensor(tab, device=dev)
            elif f == "tsize":
                a3[f] = full(img.table_size_init)
            else:
                a3[f] = planes(rows)

        def glob(v):
            return torch.as_tensor(v, device=dev)[:, None].repeat(1, L) \
                .contiguous()

        return BatchState(
            pc=full(meta.entry_pc), sp=full(meta.nlocals),
            fp=full(0), opbase=full(meta.nlocals), call_depth=full(0),
            trap=full(0), retired=full(0), fuel=full(fuel0),
            mem_pages=full(img.mem_pages_init),
            stack_lo=torch.as_tensor(stack_lo, device=dev),
            stack_hi=torch.as_tensor(stack_hi, device=dev),
            fr_ret_pc=planes(CD), fr_fp=planes(CD), fr_opbase=planes(CD),
            glob_lo=glob(img.globals_lo), glob_hi=glob(img.globals_hi),
            mem=mem, stack_e2=e2, stack_e3=e3, **t0, **a3)

    # -- execution ---------------------------------------------------------
    def run(self, func_name: str, args_lanes,
            max_steps: int = 10_000_000) -> BatchResult:
        func_idx = check_batch_entry(self.inst, func_name)
        arm(self)   # a fresh lane mapping a run (None: compaction off)
        stdout_cursor_reset(self)  # a fresh run is a fresh output stream
        state = self.initial_state(func_idx, args_lanes)
        state, total = self.run_from_state(state, 0, max_steps)
        nres = int(self.inst.lowered.funcs[func_idx].nresults)
        lo, hi, trap, retired = restore_mirrors(
            self.compactor, state.stack_lo[:max(nres, 1)].cpu().numpy(),
            state.stack_hi[:max(nres, 1)].cpu().numpy(),
            state.trap.cpu().numpy(), state.retired.cpu().numpy())
        return BatchResult(results=decode_results(lo, hi, nres),
                           trap=trap, retired=retired, steps=total)

    def run_from_state(self, state: BatchState, total: int, max_steps: int):
        """`run_slice` without the read-back's result rows: returns
        (state, total)."""
        state, total, _ = self.run_slice(state, total, max_steps, 0)
        return state, total

    def run_slice(self, state: BatchState, total: int, max_steps: int,
                  rows: int):
        """Launch loop from any state: each launch runs every live lane for
        up to `steps_per_launch` instructions; after a launch in which a
        lane parked at a host call, the parked lanes are served and the
        loop goes on.  It ends when no lane is live or `max_steps` is
        reached (checked before each launch, as the reference's loop
        does); lanes still parked then are served once, so TRAP_HOSTCALL
        never reaches the caller.  With tier 0 each launch gets its time
        base, the buffered stdout is flushed before each serve round and
        at the end, and the run's tier-0 calls are counted.  Each launch
        reads trap, retired and the first `rows` result rows back in one
        copy.  With a compactor armed, each launch is preceded by its
        boundary (which may permute the state's planes, in this state
        object, and narrow the launch width) and counted by it.  A
        supervisor or server arms `_fault_hook` (testing/faults.py): it
        fires "launch" before each launch and "serve" before each serve
        round inside the loop, so that injected faults raise where real
        ones would.  Returns (state, total, the last launch's HostPlanes;
        None when no launch ran)."""
        fault = getattr(self, "_fault_hook", None)
        chunk = self.cfg.steps_per_launch
        fuel_on = self.cfg.fuel_per_launch is not None
        t0_on = state.t0_ctr is not None
        if t0_on:
            ctr_in = state.t0_ctr.to(torch.int64).sum(1)
        comp = self.compactor
        host = None
        while total < max_steps:
            kw = {}
            if comp is not None:
                state = comp.boundary(self, state)
                kw["width"] = comp.width
            before = state.retired.clone()
            if fault is not None:
                fault("launch", total=total)
            run_chunk(self.tables, state, chunk, fuel_on, self.warps,
                      t0_time=t0_time_planes() if t0_on else None, **kw)
            host, done = self._read_back(state, before, rows)
            total += done
            if comp is not None:
                comp.note_launch(done)
            if (host.trap == TRAP_HOSTCALL).any():
                if fault is not None:
                    fault("serve", total=total)
                serve_batch_state(self, state, host.trap)
                continue
            if done == 0 or not (host.trap == 0).any():
                break
        serve_batch_state(self, state, None if host is None else host.trap)
        flush_stdout_buffers(self, state)
        if t0_on:
            ctr = (state.t0_ctr.to(torch.int64).sum(1) - ctr_in).tolist()
            stats = self.hostcall_stats
            for k, name in enumerate(("tier0_clock", "tier0_random",
                                      "tier0_fd_write", "tier0_sys")):
                stats[name] += int(ctr[k])
            stats["tier0_calls"] += int(sum(ctr))
        return state, total, host

    def _read_back(self, state: BatchState, before: torch.Tensor, R: int):
        """After a launch: trap, retired, each lane's retired delta and
        the first `R` result rows in one device-to-host copy.  Returns
        (HostPlanes, the largest delta)."""
        rows = torch.cat([state.trap[None], state.retired[None],
                          (state.retired - before)[None],
                          state.stack_lo[:R], state.stack_hi[:R]]).cpu() \
            .numpy()
        return (HostPlanes(trap=rows[0], retired=rows[1],
                           lo=rows[3:3 + R], hi=rows[3 + R:3 + 2 * R]),
                int(rows[2].max(initial=0)))


def fusion_of(block_fusion: Optional[bool], has_simd: bool) -> str:
    """The code encoding the interpreter runs, chosen as the Pallas
    kernel chooses it (pallas_engine.py :4051-4062): fused basic blocks
    unless `block_fusion` is False; then superinstructions, which move
    two-word cells, for images without v128 ops, and one op per dispatch
    for images with them."""
    if block_fusion is None or block_fusion:
        return "blocks"
    return "none" if has_simd else "super"


def optimistic_of(optimistic: Optional[bool]) -> bool:
    """Whether the kernel runs optimistic convergence (B3), as the Pallas
    engine reads the knob (pallas_engine.py :3921-3922):

        opt = getattr(self.cfg, "optimistic", None)
        self.optimistic = True if opt is None else bool(opt)
    """
    return True if optimistic is None else bool(optimistic)


def memory_words(img) -> int:
    """Rows of the [words, lanes] memory plane: the per-lane page ceiling
    in words (one row for an image without a memory)."""
    return max(img.mem_pages_max * PAGE_WORDS, 1)


def mem_window_of(mem_hbm: Optional[bool], img) -> bool:
    """Whether the image's memory goes through the window cache (B4), as
    the Pallas kernel chooses it (pallas_engine.py :3995-4013):

        if not self.img.has_memory: return False
        if self._mem_words() < self.HBM_WINDOW_ROWS: return False
        ...
        if forced is not None: return bool(forced) and blk_hbm is not None
        ...
        return blk_res is None or blk_hbm > blk_res

    An image without a memory, or one too small for two windows, has
    none; False forces direct access.  None (auto) and True give the
    windows: the JAX rule's resident slab of one 64 KiB page per lane
    never fits on chip (`blk_res` is None, or smaller than `blk_hbm`, at
    every geometry the port runs), and a forced True always finds its
    block, so both give the windows there."""
    if not img.has_memory or memory_words(img) < 2 * HBM_WINDOW_ROWS:
        return False
    return mem_hbm is None or bool(mem_hbm)


def _elem_snapshot(inst, store):
    """Element segments in the device funcref domain (funcidx+1, 0 =
    null) for table.init (the reference's `_elem_snapshot`).  A segment
    holding a reference to another module's function blocks only modules
    that can reach it (table.init); others run with that segment empty."""
    func_index = {id(f): i for i, f in enumerate(inst.funcs)}
    ops = np.asarray(inst.lowered.op[:inst.lowered.code_len])
    needs = bool((ops == int(Op.table_init)).any())
    segs = []
    for seg in inst.elems:
        refs = []
        for h in seg.refs:
            if h == 0:
                refs.append(0)
                continue
            fi = store.deref_func(h) if store is not None else None
            idx = func_index.get(id(fi)) if fi is not None else None
            if idx is None:
                if needs:
                    raise ValueError(
                        "element segment references a non-local function; "
                        "module not batchable")
                refs = []
                break
            refs.append(idx + 1)
        segs.append(refs)
    return segs


def _table_snapshot(inst, store):
    """Table 0 as funcidx+1 (0 = null), from the store-interned handles."""
    if not inst.tables:
        return None
    func_index = {id(f): i for i, f in enumerate(inst.funcs)}
    refs = []
    for h in inst.tables[0].refs:
        if h == 0:
            refs.append(0)
            continue
        fi = store.deref_func(h) if store is not None else None
        idx = func_index.get(id(fi)) if fi is not None else None
        if idx is None:
            raise ValueError("table entry references a non-local function; "
                             "module not batchable")
        refs.append(idx + 1)
    return refs
