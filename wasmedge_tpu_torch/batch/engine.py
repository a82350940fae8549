"""BatchEngine: runs one module's export over N lanes on the warp-interpreter.

Counterpart of `wasmedge_tpu/batch/engine.py` (`BatchState`,
`BatchResult`, `pack_lane_args`, `check_batch_entry`, `initial_state`) and
of the reference's host launch loop (`BatchEngine.run_from_state`,
`wasmedge_tpu/batch/engine.py:2414-2527`): launch chunks of
`steps_per_launch` instructions, serve the lanes parked at host calls
between launches (batch/hostcall.py), until every lane has stopped or
`max_steps` is reached, then collect per-lane results.

State layout is the reference's, lane fastest: value stacks
`[value_stack_depth, lanes]` (two planes, lo and hi, and two more, e2
and e3, when the image holds v128 ops), frames `[call_stack_depth,
lanes]`, globals
`[n_globals, lanes]`, memory `[words, lanes]` and the per-lane control
planes `[lanes]`, all int32.  The kernel updates them in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from wasmedge_tpu_torch.batch.hostcall import serve_batch_state
from wasmedge_tpu_torch.batch.image import (
    TRAP_DONE, TRAP_HOSTCALL, batchability, build_device_image,
    slice_refusal)
from wasmedge_tpu_torch.batch.interp import device_tables, run_chunk
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.types import ValType

PAGE_WORDS = 65536 // 4

CONTROL_FIELDS = ("pc", "sp", "fp", "opbase", "call_depth", "trap",
                  "retired", "fuel", "mem_pages")
PLANE_FIELDS = ("stack_lo", "stack_hi", "fr_ret_pc", "fr_fp", "fr_opbase",
                "glob_lo", "glob_hi", "mem")
# the upper two words of a v128 cell: [D, L] for images with v128 ops,
# None otherwise (the reference BatchState's stack_e2 / stack_e3)
SIMD_FIELDS = ("stack_e2", "stack_e3")


@dataclasses.dataclass
class BatchState:
    """Per-lane interpreter state (the reference BatchState's fields that
    this slice uses), int32 tensors on one device; `stack_e2` and
    `stack_e3` are None unless the image holds v128 ops."""

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

    FIELDS = CONTROL_FIELDS + PLANE_FIELDS + SIMD_FIELDS

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


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU;
    a card that is asked for (or left as the default) must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch interpreter")
    return dev


class BatchEngine:
    """Runs one instantiated module's exports over `lanes` lanes."""

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
            table0=_table_snapshot(inst, store), mod=inst.ast)
        # static per-lane memory ceiling: the declared max clamped by the
        # knob (engine.py:2035-2040 of the reference)
        if img.has_memory:
            declared = img.mem_pages_max if img.mem_pages_max > 0 \
                else self.cfg.memory_pages_per_lane
            img.mem_pages_max = max(
                img.mem_pages_init,
                min(declared, self.cfg.memory_pages_per_lane))
        reason = slice_refusal(img)
        if reason is not None:
            raise NotImplementedError(reason)
        self.img = img
        self.tables = device_tables(img, self.device)
        # serve rounds, lanes served, lanes served by a vectorized WASI
        # implementation, and host seconds spent in serve rounds
        # (batch/hostcall.py)
        self.hostcall_stats = {"serve_rounds": 0, "tier1_calls": 0,
                               "tier1_vectorized": 0, "serve_s": 0.0}

    def resolve_func(self, k: int):
        """Function index of a HOSTCALL stub -> its FunctionInstance."""
        return self.inst.funcs[k]

    # -- state -------------------------------------------------------------
    def initial_state(self, func_idx: int, args_lanes) -> BatchState:
        cfg, L, img = self.cfg, self.lanes, self.img
        meta = self.inst.lowered.funcs[func_idx]
        D, CD = cfg.value_stack_depth, cfg.call_stack_depth
        stack_lo, stack_hi = pack_lane_args(args_lanes, L, D)
        dev = self.device

        def full(v):
            return torch.full((L,), int(v), dtype=torch.int32, device=dev)

        W = max(img.mem_pages_max * PAGE_WORDS, 1)
        mem = torch.zeros((W, L), dtype=torch.int32, device=dev)
        if img.mem_init.shape[0] > 1 or img.mem_pages_init:
            init = torch.as_tensor(img.mem_init, device=dev)
            mem[: init.shape[0]] = init[:, None]
        fuel0 = cfg.fuel_per_launch if cfg.fuel_per_launch is not None else 0

        def planes(rows):
            return torch.zeros((rows, L), dtype=torch.int32, device=dev)

        e2, e3 = (planes(D), planes(D)) if img.has_simd else (None, None)

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
            mem=mem, stack_e2=e2, stack_e3=e3)

    # -- execution ---------------------------------------------------------
    def run(self, func_name: str, args_lanes,
            max_steps: int = 10_000_000) -> BatchResult:
        func_idx = check_batch_entry(self.inst, func_name)
        state = self.initial_state(func_idx, args_lanes)
        state, total = self.run_from_state(state, 0, max_steps)
        nres = int(self.inst.lowered.funcs[func_idx].nresults)
        lo = state.stack_lo[:max(nres, 1)].cpu().numpy()
        hi = state.stack_hi[:max(nres, 1)].cpu().numpy()
        return BatchResult(results=decode_results(lo, hi, nres),
                           trap=state.trap.cpu().numpy(),
                           retired=state.retired.cpu().numpy(),
                           steps=total)

    def run_from_state(self, state: BatchState, total: int, max_steps: int):
        """Launch loop from any state: each launch runs every live lane for
        up to `steps_per_launch` instructions; after a launch in which a
        lane parked at a host call, the parked lanes are served and the
        loop goes on.  It ends when no lane is live or `max_steps` is
        reached (checked before each launch, as the reference's loop
        does); lanes still parked then are served once, so TRAP_HOSTCALL
        never reaches the caller."""
        chunk = self.cfg.steps_per_launch
        fuel_on = self.cfg.fuel_per_launch is not None
        while total < max_steps:
            before = state.retired.clone()
            run_chunk(self.tables, state, chunk, fuel_on)
            done = int((state.retired - before).max().item())
            total += done
            trap = state.trap.cpu().numpy()
            if (trap == TRAP_HOSTCALL).any():
                serve_batch_state(self, state)
                continue
            if done == 0 or not (trap == 0).any():
                break
        serve_batch_state(self, state)
        return state, total


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
