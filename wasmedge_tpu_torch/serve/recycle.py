"""Lane recycling: re-initialize retired lanes in place.

A copy of `wasmedge_tpu/serve/recycle.py` over the port's `BatchState`.
A serving loop cannot wait for a batch to drain: a lane that retires
while its neighbours run on is dead capacity until then.
`LaneRecycler` captures, once per exported function, the lane-uniform
column of every state plane from `engine.initial_state()` (column 0:
the entry state holds the same values in every lane), and `install()`
writes those columns and the requests' argument cells into the freed
lanes with indexed assignments on the device, one per plane: pc, sp,
frames, globals, memory and table all reset to the function's entry
state, trap cleared to running.  No kernel is rebuilt; the next launch
finds the lanes live.  The reference pads the lane index vector to a
power of two to bound its jit retraces; an indexed assignment needs no
padding.

Idle lanes park with trap = TRAP_DONE: the kernel skips them, so an
under-occupied serving state costs only its planes' storage.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from wasmedge_tpu_torch.batch.engine import BatchState, decode_results
from wasmedge_tpu_torch.batch.hostcall import _cells_to_planes
from wasmedge_tpu_torch.batch.image import TRAP_DONE


class LaneRecycler:
    """Per-engine template cache and in-place lane (re)initialization."""

    def __init__(self, engine):
        self.engine = engine
        self.lanes = engine.lanes
        self._templates: Dict[int, dict] = {}   # func_idx -> columns
        self._nres: Dict[int, int] = {}
        self._fidx: Dict[str, int] = {}   # validated name -> func index

    def func_idx(self, func_name: str) -> int:
        """The engine-global function index of an export (memoized:
        `module:func` names on the multi-module engine)."""
        idx = self._fidx.get(func_name)
        if idx is None:
            idx = self._fidx[func_name] = \
                self.engine.export_func_idx(func_name)
        return idx

    def nresults(self, func_idx: int) -> int:
        n = self._nres.get(func_idx)
        if n is None:
            n = self._nres[func_idx] = self.engine.func_nresults(func_idx)
        return n

    def idle_state(self, func_idx: int) -> BatchState:
        """A fresh serving state with every lane parked TRAP_DONE (its
        geometry is the engine's; the function seeds the template
        cache)."""
        state = self.engine.initial_state(func_idx, [])
        self._capture(func_idx, state)
        state.trap.fill_(TRAP_DONE)
        return state

    def _capture(self, func_idx: int, state: Optional[BatchState] = None
                 ) -> dict:
        """The entry state's column of every plane (a [rows] tensor, or
        a 0-d one for the [L] planes), on the state's device."""
        tmpl = self._templates.get(func_idx)
        if tmpl is None:
            if state is None:
                state = self.engine.initial_state(func_idx, [])
            tmpl = self._templates[func_idx] = {
                f: p[..., 0].clone() for f, p in state.planes().items()}
        return tmpl

    def install(self, state: BatchState, lanes: Sequence[int],
                func_idx: int, args_rows: List[Sequence[int]]
                ) -> BatchState:
        """Re-initialize `lanes` in place for `func_idx`, with argument i
        of the request going into lanes[k] at `args_rows[i][k]`.
        Returns the state."""
        n = len(lanes)
        if n == 0:
            return state
        note = getattr(self.engine, "note_snapshot_install", None)
        if note is not None:
            note(func_idx, n)
        dev = state.pc.device
        idx = torch.as_tensor(np.asarray(lanes, np.int64), device=dev)
        for f, col in self._capture(func_idx).items():
            plane = getattr(state, f)
            if col.dim() == 0:
                plane[idx] = col
            else:
                plane[:, idx] = col[:, None].expand(-1, n)
        if args_rows:
            lo, hi = _cells_to_planes(np.asarray(args_rows, np.int64))
            state.stack_lo[:len(args_rows), idx] = torch.as_tensor(
                lo, device=dev)
            state.stack_hi[:len(args_rows), idx] = torch.as_tensor(
                hi, device=dev)
        return state

    def harvest_cells(self, state: BatchState, lanes: Sequence[int],
                      func_idx: int, host=None) -> np.ndarray:
        """Raw 64-bit result cells [nres, n] of retired lanes (stack rows
        0 .. nres - 1), from `host` (the `HostPlanes` that `run_slice`
        read back after the launch) when it carries the rows, else from
        the state."""
        lanes = np.asarray(lanes, np.int64)
        nres = self.nresults(func_idx)
        if nres == 0 or lanes.size == 0:
            return np.zeros((nres, lanes.size), np.int64)
        if host is not None and host.lo.shape[0] >= nres:
            lo, hi = host.lo[:nres, lanes], host.hi[:nres, lanes]
        else:
            lo = state.stack_lo[:nres].cpu().numpy()[:, lanes]
            hi = state.stack_hi[:nres].cpu().numpy()[:, lanes]
        return np.stack(decode_results(lo, hi, nres))

    def park(self, state: BatchState, lanes: Sequence[int]) -> BatchState:
        """Park lanes idle (TRAP_DONE) until their next install."""
        if len(lanes):
            state.trap[torch.as_tensor(np.asarray(lanes, np.int64),
                                       device=state.trap.device)] = TRAP_DONE
        return state
