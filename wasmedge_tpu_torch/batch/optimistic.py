"""Optimistic convergence (B3): the per-warp state and the plain version of the kernel's warp-leader fast path.

Counterpart of the optimistic mode of `wasmedge_tpu/batch/pallas_engine.py`
(`_build_kernel(..., optimistic=True)`: `agree_i32` / `agree_nz` /
`opt_addr_prolog` :964-995, `do_snapshot` / `do_restore` :996-1064,
`_opt_bulk_exit` :1065-1080, the commit before a dirty window write-back
:1895-1935, the periodic commit :3599-3651, the exit validation
:3669-3680; on the host the careful re-run `careful_recheck` :4397-4437 and
the adaptive interval of `_drive` :4360-4395).  `csrc/optimistic.cuh` is
the CUDA kernel's half; this module is its plain PyTorch version, which
`batch/interp_ref.py` runs launch by launch, and the per-warp state both
share.

A warp is 32 lanes (lane // 32).  A warp whose present lanes are all live
and share pc, sp, fp, operand base, call depth, pages, fuel and (with a
per-lane table) table size when a launch starts runs "on": every decision (a branch condition's zeroness; a
table index, a grow delta, a memory address, an ALU trap kind and the frame
row a return goes back through exactly: the entry compares no frame row)
is its lane 0's, and a lane whose own value differs sets its canary.  The
commit points are the kernel's: the first dispatch boundary once
`snap` steps have passed since the last snapshot (min(512, snap) for the
first of a launch), a window miss that would write a dirty way back, a
bulk op, a tier-0 host call or an instruction that writes the table,
its size, a dropped flag or memory from a data segment (after which the
warp leaves "on" for the launch; a uniform warp only at random_get, and
never at the table and segment writes, which its lanes make alike) and
the end of the warp's loop.  So no snapshot holds the table or
segment planes, and call_indirect agrees the handle it reads from the
lane's table.  A clean check writes the dirty windows back and
snapshots; a dirty one restores the snapshot (stack rows below its sp,
frames, globals, memory without windows), drops the windows, halves the
warp's interval (down to `SNAP_MIN`), counts a rollback and lets the rest
of the launch run per lane from the snapshot's step.  A launch without a
rollback doubles the interval back toward `snap_max`.

The entry rule of uniform warps: a warp that is on, whole (32 lanes) and
whose lanes equal its lane 0 in stack rows [0, sp) of every stack plane,
frame rows [0, call depth), the globals, memory rows [0, min(W, pages x
16384)) and, with tier 0, every row of the call counts `t0_ctr` and the
stdout buffer's fill `so_off` (not the buffer: Wasm never reads it) and,
with tables and segments, the table rows below the lane's size `tsize`
(rows at or above it are dead: table.grow writes every row it exposes)
and every row of the dropped flags `edrop` and `ddrop`, holds one state; its lanes run the same instructions on the same values until
the launch ends or a tier-0 random_get (seeded per lane) commits and
turns it off, so the kernel runs it without shuffles or snapshots
(`csrc/optimistic.cuh` `WarpUniform`).  Here such a warp runs as
every warp that is on does (its canaries can never be set, so what it
writes is the same); `WarpState.uniform` counts its entries.  The kernel copies
the frame rows at or above the snapshot's depth on their first write, so
that restoring them leaves them as they were; restoring every frame row
from a whole copy, as here, is the same.  Stack rows at or above the
snapshot's sp keep what lane 0's wrong path wrote, in the kernel and here.
"""

from __future__ import annotations

import dataclasses

import torch

SNAP_STEPS = 131072  # PallasUniformEngine.SNAP_STEPS (pallas_engine.py:3907)
SNAP_MIN = 256       # _SNAP_MIN (pallas_engine.py:238)
FIRST_INTERVAL = 512  # the first interval, min(512, snap) (:3608-3611)
WARP = 32
# why a warp waits for a commit: a window miss that would write a dirty
# way back, or a bulk op or tier-0 host call (after which it leaves "on")
DEFER_ACCESS, DEFER_BULK = 1, 2

# shadow plane -> the state plane a snapshot copies
SHADOWS = {"sh_lo": "stack_lo", "sh_hi": "stack_hi", "sh_e2": "stack_e2",
           "sh_e3": "stack_e3", "sh_fr_ret_pc": "fr_ret_pc",
           "sh_fr_fp": "fr_fp", "sh_fr_opbase": "fr_opbase",
           "sh_glo": "glob_lo", "sh_ghi": "glob_hi", "sh_mem": "mem"}
STACK_SHADOWS = ("sh_lo", "sh_hi", "sh_e2", "sh_e3")
_SAVED = ("pc", "sp", "fp", "opbase", "call_depth", "retired", "fuel",
          "mem_pages")


def n_warps(lanes: int) -> int:
    return (lanes + WARP - 1) // WARP


@dataclasses.dataclass
class WarpState:
    """Per-warp state of optimistic convergence, next to a `BatchState`
    (not in it: `BatchState` keeps the reference's fields), int32 [warps]
    on the state's device: `snap` the interval of the warp's next launch
    (the counterpart of ctrl column `_C_SNAP`, pallas_engine.py :233-238),
    `rollbacks` (of `recheck_rounds`), `entered` the launches it ran
    optimistically, `commits` its clean checks, `uniform` the launches
    it entered as a uniform warp (the entry rule above).  `shadows` holds
    the snapshot's planes, allocated once for a state's geometry."""

    snap: torch.Tensor
    rollbacks: torch.Tensor
    entered: torch.Tensor
    commits: torch.Tensor
    uniform: torch.Tensor
    snap_max: int = SNAP_STEPS
    shadows: dict = dataclasses.field(default_factory=dict)

    COUNTERS = ("snap", "rollbacks", "entered", "commits", "uniform")

    @classmethod
    def new(cls, lanes: int, device, snap_max: int = SNAP_STEPS):
        nw = n_warps(lanes)

        def full(v):
            return torch.full((nw,), int(v), dtype=torch.int32,
                              device=device)

        return cls(snap=full(snap_max), rollbacks=full(0), entered=full(0),
                   commits=full(0), uniform=full(0), snap_max=int(snap_max))

    def counters(self) -> dict:
        return {f: getattr(self, f) for f in self.COUNTERS}

    def stats(self) -> dict:
        """Warps entered optimistically, rollbacks and commits, summed
        over the warps and launches so far."""
        return {"entered": int(self.entered.sum()),
                "rollbacks": int(self.rollbacks.sum()),
                "commits": int(self.commits.sum())}

    def shadows_for(self, st, mem_window: bool) -> dict:
        """The shadow planes for state `st` (allocated on the first call
        and whenever the geometry changes): the stack planes (e2/e3 when
        the state has them), frames, globals and, when memory runs
        without windows and exists (more than one row), the memory."""
        want = {}
        for sh, plane in SHADOWS.items():
            t = getattr(st, plane)
            if t is None or (sh == "sh_mem" and (mem_window
                                                 or t.shape[0] <= 1)):
                continue
            want[sh] = (tuple(t.shape), t.device)
        have = {k: (tuple(v.shape), v.device)
                for k, v in self.shadows.items()}
        if have != want:
            self.shadows = {k: torch.zeros(shape, dtype=torch.int32,
                                           device=dev)
                            for k, (shape, dev) in want.items()}
        return self.shadows


class OptRun:
    """One launch of optimistic convergence in the plain interpreter:
    which warps are on, their canaries, snapshots and commit points.
    `interp_ref.run_chunk` calls `commit_points` at the top of every
    iteration and `close` at the end; its handlers take their decisions
    through `leads` (see `_Group.agree`)."""

    def __init__(self, tables, st, chunk: int, warps: WarpState, win):
        self.st, self.chunk, self.warps, self.win = st, int(chunk), warps, win
        self.sh = warps.shadows_for(st, tables.mem_window)
        L = st.pc.shape[0]
        dev = st.pc.device
        self.L, self.nw = L, n_warps(L)
        lane = torch.arange(L, device=dev)
        self.wid = lane // WARP
        self.leader = self.wid * WARP
        self.lead_lanes = torch.arange(self.nw, device=dev) * WARP
        same = st.trap == 0
        for f in ("pc", "sp", "fp", "opbase", "call_depth", "mem_pages",
                  "fuel", "tsize"):
            p = getattr(st, f)
            if p is None:
                continue
            same = same & (p == p[self.leader])
        self.on = self._all(same) & (self.chunk > 0)
        self.entered = self.on.clone()
        whole = (torch.arange(self.nw, device=dev) + 1) * WARP <= L
        self.uniform = self.on & whole
        if bool(self.uniform.any()):
            self.uniform &= self._all(self._same_rows(st))
        self.canary = torch.zeros(L, dtype=torch.bool, device=dev)
        self.pending = torch.zeros(self.nw, dtype=torch.int32, device=dev)
        self.ls = torch.zeros(self.nw, dtype=torch.int32, device=dev)
        self.rolled = torch.zeros_like(self.on)
        self.commits = torch.zeros_like(self.pending)
        self.snapv = warps.snap.clone()
        self.saved = {f: getattr(st, f).clone() for f in _SAVED}
        self._pos = torch.zeros(L, dtype=torch.int64, device=dev)
        lanes = self.lanes_of(self.on)
        if lanes.numel():
            self._save(lanes)  # the entry state is the first snapshot

    # -- helpers -------------------------------------------------------------
    def _all(self, per_lane):
        """Per warp: every present lane of it true."""
        pad = torch.ones(self.nw * WARP, dtype=torch.bool,
                         device=per_lane.device)
        pad[: self.L] = per_lane
        return pad.view(self.nw, WARP).all(1)

    def _same_rows(self, st):
        """Per lane: equal to its warp's lane 0 in the rows the entry rule
        compares (its own sp, call depth and pages; a warp that is on
        shares them; every row of the tier-0 counts and the stdout fill;
        the table rows below its size, every row of the dropped flags)."""
        ns, nf = st.sp.long(), st.call_depth.long()
        W = st.mem.shape[0]
        nm = torch.clamp(st.mem_pages.long() * 16384, max=W) if W > 1 \
            else torch.zeros_like(ns)
        same = torch.ones_like(st.sp, dtype=torch.bool)
        for plane, n in ((st.stack_lo, ns), (st.stack_hi, ns),
                         (st.stack_e2, ns), (st.stack_e3, ns),
                         (st.fr_ret_pc, nf), (st.fr_fp, nf),
                         (st.fr_opbase, nf), (st.glob_lo, None),
                         (st.glob_hi, None), (st.mem, nm),
                         (st.t0_ctr, None),
                         (None if st.so_off is None else st.so_off[None],
                          None),
                         (st.tab, None if st.tsize is None
                          else st.tsize.long()),
                         (st.edrop, None), (st.ddrop, None)):
            if plane is None:
                continue
            diff = plane != plane[:, self.leader]
            if n is not None:
                rows = torch.arange(plane.shape[0], device=plane.device)
                diff &= rows[:, None] < n[None, :]
            same &= ~diff.any(0)
        return same

    def lanes_of(self, warps_mask):
        return warps_mask[self.wid].nonzero().squeeze(1)

    def any_on(self) -> bool:
        return bool(self.on.any())

    def leads(self, lanes):
        """For the lanes of one handler group: None when none of their
        warps is on; else (on, lead): whether each lane's warp is on, and
        the position in `lanes` of its warp's lane 0 (its own position
        when off).  A warp that is on has every lane at one pc, so its
        lane 0 is in the same group."""
        ol = self.on[self.wid[lanes]]
        if not bool(ol.any()):
            return None
        n = lanes.shape[0]
        own = torch.arange(n, device=lanes.device)
        self._pos[lanes] = own
        lead = torch.where(ol, self._pos[self.leader[lanes]], own)
        if bool((lanes[lead] != self.leader[lanes])[ol].any()):
            raise AssertionError("a warp that is on has lanes at two pcs")
        return ol, lead

    def disagree(self, lanes, d):
        self.canary[lanes] = self.canary[lanes] | d

    def defer(self, lanes, kind: int):
        """These lanes' instruction waits for a commit of their warps."""
        self.pending[self.wid[lanes]] = kind

    # -- snapshots -------------------------------------------------------------
    def _save(self, lanes):
        st = self.st
        for sh, plane in SHADOWS.items():
            if sh in self.sh:
                self.sh[sh][:, lanes] = getattr(st, plane)[:, lanes]
        for f in _SAVED:
            self.saved[f][lanes] = getattr(st, f)[lanes]

    def _restore(self, lanes):
        st = self.st
        D = st.stack_lo.shape[0]
        below = torch.arange(D, device=lanes.device)[:, None] < \
            self.saved["sp"][lanes][None, :]
        for sh, plane in SHADOWS.items():
            if sh not in self.sh:
                continue
            p = getattr(st, plane)
            if sh in STACK_SHADOWS:
                p[:, lanes] = torch.where(below, self.sh[sh][:, lanes],
                                          p[:, lanes])
            else:
                p[:, lanes] = self.sh[sh][:, lanes]
        for f in _SAVED:
            getattr(st, f)[lanes] = self.saved[f][lanes]
        st.trap[lanes] = 0

    # -- commit points ---------------------------------------------------------
    def commit_points(self, left):
        """The warps that are on and due: the exit validation of those
        whose loop has ended, the periodic commit and the commits their
        handlers asked for.  A rolled-back warp's lanes get the steps
        from the snapshot's on (`left`)."""
        if not self.any_on():
            return
        lead = self.lead_lanes
        leftw = left[lead]
        finished = self.on & ((self.st.trap[lead] != 0) | (leftw <= 0))
        step = self.chunk - leftw
        interval = torch.where(self.ls == 0,
                               self.snapv.clamp(max=FIRST_INTERVAL),
                               self.snapv)
        due = self.on & ~finished & ((step - self.ls >= interval)
                                     | (self.pending != 0))
        check = finished | due
        if not bool(check.any()):
            return
        dirty = ~self._all(~self.canary)
        back = check & dirty
        clean = check & ~dirty
        leave = clean & (finished | (self.pending == DEFER_BULK))
        keep = clean & ~leave
        self.commits += clean.to(torch.int32)
        if bool(back.any()):
            lanes = self.lanes_of(back)
            self._restore(lanes)
            if self.win is not None:
                self.win.invalidate(lanes)
            left[lanes] = self.chunk - self.ls[self.wid[lanes]]
            self.rolled |= back
        if bool(keep.any()):
            lanes = self.lanes_of(keep)
            if self.win is not None:
                self.win.commit(lanes)
            self._save(lanes)
            self.ls = torch.where(keep, step, self.ls)
            self.canary[lanes] = False
        self.on &= ~(back | leave)
        self.pending[check] = 0

    def close(self):
        """The warps' intervals for their next launch and their counts."""
        w = self.warps
        e = self.entered
        w.snap.copy_(torch.where(
            e, torch.where(self.rolled, (self.snapv // 2).clamp(min=SNAP_MIN),
                           (self.snapv * 2).clamp(max=w.snap_max)),
            w.snap))
        w.rollbacks += (e & self.rolled).to(torch.int32)
        w.entered += e.to(torch.int32)
        w.commits += self.commits
        w.uniform += self.uniform.to(torch.int32)

