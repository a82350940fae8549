"""Plain PyTorch version of the CUDA warp-interpreter (`csrc/interp.cu`).

Same function as the kernel: every live lane runs up to `chunk`
instructions, and the state planes after the chunk are the kernel's, bit
for bit.  Per-instruction semantics follow the reference SIMT step
(`wasmedge_tpu/batch/engine.py` `_make_step`) exactly, including its
corner cases:

  - an ALU1/ALU2 result cell is written even when the op traps (the
    non-saturating i32.trunc_f32_{s,u} write 0 then);
  - a lane that runs out of fuel keeps the effects of its last
    instruction on the stack, frames, globals, memory and page count but
    not its pc/sp/fp/operand base/call depth;
  - a return from depth 0 sets trap = TRAP_DONE and sp = fp + nresults;
  - stack, frame and memory rows are clamped into their planes;
  - a host call parks the lane (trap = TRAP_HOSTCALL) at its stub with
    the instruction retired and its fuel charged, unless tier 0 serves it
    (`tables.t0k`, the reference SIMT step's engine.py:1309-1449): then
    clock_time_get, random_get, sched_yield and fd_write to fd 1 or 2
    retire in place (their errno at the frame's operand base, sp one
    above it, pc at the stub's RETURN) and proc_exit stops the lane
    (ErrCode.Terminated, its code at the operand base); a cputime clock,
    an oversized request, a full stdout buffer, another fd, more than one
    iovec or an unaligned iovec array park as before.  They read and
    write the memory plane after the lane's dirty windows are written
    back and dropped (as a bulk op does);
  - memory.fill / memory.copy check both ranges first, write nothing on
    a trap, and read copy sources from the unmodified plane (memmove),
    as `laneops.plane_fill_copy` does; one instruction and one fuel unit
    however long;
  - with `tables.mem_window` every memory access goes through the
    window cache of `batch/memwin.py` (B4): a load or store selects the
    window that holds its rows (up to five for a v128 access) and reads
    and writes the window's words; memory.fill / memory.copy first write
    the lane's dirty windows back and invalidate them, then run on the
    plane; the windows start invalid and every dirty one is written back
    when the launch ends, so the planes after a launch are the ones
    direct access leaves;
  - when the image holds v128 ops the stack has four planes (lo, hi, e2,
    e3): moves (local.get/set/tee, select, a kept branch value, return)
    carry all four words, every scalar write (const, global.get,
    memory.size/grow, ALU, load, the callee's zeroed locals, vextract,
    vtest) zeroes e2 and e3 at its row, and v128 ops (B7, through
    `batch/simdops.py`) read and write whole cells; a trapping
    v128.load / v128.store writes nothing;
  - with `tables.optimistic` (B3, `batch/optimistic.py`) a warp of 32
    lanes that starts the launch converged takes its lane 0's value at
    every decision (`_Group.agree` / `agree_nz`: branch conditions, table
    indexes, grow deltas, memory addresses, ALU trap kinds), and a
    load or store whose window miss would write a dirty way back, or a
    bulk op, waits for a commit (`defer`) instead of running; so does a
    tier-0 call, except in a uniform warp (the entry rule) where only
    random_get does (its bytes differ by lane), and after that commit
    the warp runs per lane for the rest of the launch, as after a bulk
    op; commits, snapshots and rollbacks are `OptRun`'s;
  - tables, segments and tail calls (`tables.a3`, the reference SIMT
    step's engine.py:1156-1307 and :1464-1516): table.get / set / size /
    grow / fill / copy / init over each lane's `tab` plane bounded by its
    `tsize` (table 0 and the instruction's `b` when the code never
    mutates it), elem.drop / data.drop setting the lane's dropped flag,
    memory.init from the image's data words (after the lane's windows
    are written back and dropped, as a bulk op), ref.func; call_indirect
    through the lane's table; return_call / return_call_indirect replace
    the frame (fp stays, the arguments slide down to it, no frame is
    pushed and only the value stack is checked).  Copy and init gather
    from the table before the op, as the reference does.  In a warp that
    is on and not uniform, an instruction that writes the table, its
    size, a dropped flag or memory from a segment waits for a commit and
    then runs per lane (as a bulk op); a uniform warp runs them in place;
    call_indirect agrees the handle it reads, not only the index;
  - weighted gas (`tables.cost`): an instruction costs its weight, a
    fused dispatch the sum of its ops' weights (`tables.gcum`), and runs
    only when the lane's fuel is above that sum.

Vectorised over lanes: each step groups the live lanes by the handler id
at their pc and applies one handler per group.  It is the reference the
tests hold the port against on the CPU and that `chip_smoke.py` holds the
kernel against on the card; no path of the engine calls it on the card.
"""

from __future__ import annotations

import torch

from wasmedge_tpu_torch.batch import laneops as ops
from wasmedge_tpu_torch.batch import simdops as sops
from wasmedge_tpu_torch.batch.fusion import H_BLOCK_BASE, super_family
from wasmedge_tpu_torch.batch import tier0 as t0f
from wasmedge_tpu_torch.batch.image import (
    ALU1_SUB, T0_CLOCK_TIME_GET, T0_FD_WRITE, T0_NEEDS_MEMORY, T0_PROC_EXIT,
    T0_RANDOM_GET, T0_SCHED_YIELD, TRAP_DONE, TRAP_HOSTCALL)
from wasmedge_tpu_torch.batch.interp import (
    A3_WRITES, H_DATA_DROP, H_ELEM_DROP, H_MEMINIT, H_REFFUNC, H_RETCALL,
    H_RETCALL_INDIRECT, H_TABLE_COPY, H_TABLE_FILL, H_TABLE_GET,
    H_TABLE_GROW, H_TABLE_INIT, H_TABLE_SET, H_TABLE_SIZE, H_ALU1_BASE, H_ALU2_BASE, H_BR, H_BR_TABLE, H_BRNZ, H_BRZ, H_CALL,
    H_CALL_INDIRECT, H_CONST, H_DROP, H_FUSE_A2R_BASE, H_FUSE_GBR,
    H_FUSE_GCA_BASE, H_FUSE_GCB_BASE, H_FUSE_GCC_BASE, H_FUSE_GCS_BASE,
    H_FUSE_GGA_BASE, H_FUSE_GGBNZ_BASE, H_FUSE_GGBZ_BASE, H_FUSE_GGS_BASE,
    H_GLOBAL_GET, H_GLOBAL_SET,
    H_HOSTCALL, H_LOAD, H_LOAD_D, H_LOAD_W, H_LOCAL_GET, H_LOCAL_SET,
    H_LOCAL_TEE, H_MEMCOPY, H_MEMFILL, H_MEMGROW, H_MEMSIZE, H_NOP,
    H_RETURN, H_SELECT, H_STORE, H_STORE_D, H_STORE_W, H_TRAP, H_V1_BASE,
    H_V2_BASE, H_VBITSEL, H_VCONST, H_VEXTRACT_BASE, H_VLOAD,
    H_VREPLACE_BASE, H_VSHIFT_BASE, H_VSHUFFLE, H_VSPLAT_BASE, H_VSTORE,
    H_VTEST_BASE, NUM_HANDLERS, Tables)
from wasmedge_tpu_torch.batch.memwin import MemWindows
from wasmedge_tpu_torch.batch.optimistic import (
    DEFER_ACCESS, DEFER_BULK, OptRun, WarpState, n_warps)
from wasmedge_tpu_torch.common.errors import ErrCode

I32 = torch.int32
_A3_WRITES = frozenset(A3_WRITES)
_TRUNC_F32 = (ALU1_SUB["i32.trunc_f32_s"], ALU1_SUB["i32.trunc_f32_u"])
_NUM_ALU1 = len(ALU1_SUB)


def run_chunk(t: Tables, st, chunk: int, fuel_on: bool,
              warps: WarpState = None, t0_time=None, width=None) -> None:
    """`warps`: the per-warp state of optimistic tables (a fresh one
    when None); `t0_time`: the launch's tier-0 time base ([2, 2] int32,
    needed with `t.t0k`); `width`: the lanes launched (all when None).
    A narrowed launch runs a copy of the lanes below `width` (and of
    their warps' counters) as a launch of `width` lanes and writes them
    back: the lanes beyond it are not touched, as in the kernel, whose
    grid covers `width` lanes."""
    L = st.pc.shape[0]
    if width is not None and int(width) < L:
        _run_prefix(t, st, chunk, fuel_on, warps, t0_time, int(width))
        return
    # steps each lane has left in this launch (a fused dispatch takes
    # several at once)
    left = torch.full_like(st.pc, int(chunk))
    # B4: the windows start invalid at every launch and are written back
    # when it ends (pallas_engine.py :3656-3660, :3683-3693)
    win = MemWindows(st.mem) if t.mem_window else None
    opt = None
    if t.optimistic:
        if warps is None:
            warps = WarpState.new(st.pc.shape[0], st.pc.device)
        opt = OptRun(t, st, chunk, warps, win)
    while True:
        if opt is not None:
            opt.commit_points(left)
        live = ((st.trap == 0) & (left > 0)).nonzero().squeeze(1)
        if live.numel() == 0:
            break
        _step(t, st, live, fuel_on, left, win, opt, t0_time)
    if win is not None:
        win.flush()
    if opt is not None:
        opt.close()


def _run_prefix(t: Tables, st, chunk, fuel_on, warps, t0_time, width):
    """run_chunk over lanes [0, width) of `st`: their columns (and, with
    optimistic tables, their warps' counters) copied out, run, and
    written back in place."""
    planes = st.planes()
    sub = type(st)(**{f: p[..., :width].clone() for f, p in planes.items()})
    sw = None
    if t.optimistic:
        if warps is None:
            warps = WarpState.new(st.pc.shape[0], st.pc.device)
        nw = n_warps(width)
        sw = WarpState(**{f: getattr(warps, f)[:nw].clone()
                          for f in WarpState.COUNTERS},
                       snap_max=warps.snap_max)
    run_chunk(t, sub, chunk, fuel_on, sw, t0_time)
    for f, p in planes.items():
        p[..., :width] = getattr(sub, f)
    if sw is not None:
        for f in WarpState.COUNTERS:
            getattr(warps, f)[:nw] = getattr(sw, f)


def _step(t: Tables, st, lanes, fuel_on, left, win, opt=None, t0_time=None):
    code_len = t.hid.shape[0]
    pc = st.pc[lanes].clamp(0, code_len - 1)
    pcl = pc.long()
    hid = t.hid[pcl]
    fused = torch.zeros_like(hid, dtype=torch.bool)
    if t.fusion != "none":
        # a fused id runs only when the lane's steps and fuel cover its
        # whole length; otherwise the head slot's original op runs
        flen = t.flen[pcl]
        fused = flen > 0
        fits = (left[lanes] >= flen) & (
            (st.fuel[lanes] > _gas(t, pc, flen)) if fuel_on else True)
        hid = torch.where(fused & ~fits, t.hid0[pcl], hid)
        fused = fused & fits
    for h in torch.unique(hid).tolist():
        m = hid == h
        if bool(fused[m].any()):
            _run_fused(t, st, lanes[m], pc[m], int(h), fuel_on, left, win,
                       opt, t0_time)
        else:
            ran = _Group(t, st, lanes[m], pc[m], fuel_on, win, opt,
                         t0_time).run(int(h))
            left[ran] -= 1


def _run_fused(t, st, lanes, pc, h, fuel_on, left, win, opt=None,
               t0_time=None):
    """One fused dispatch (a block or a superinstruction) on the lanes at
    fused id h, then the terminal op, per op, on the lanes it leaves at
    one; a block whose fused length counts one op more than its shape
    (a div or rem terminal chained to the lone call after it,
    `fusegen.chains`) runs that call too, per op, on the lanes the
    terminal left at it, as the kernel's case runs all three in one
    turn of its loop."""
    g = _Fused(t, st, lanes, pc, fuel_on, win, opt)
    if h >= H_BLOCK_BASE:
        g.block(t.shapes[h - H_BLOCK_BASE])
    else:
        g.superinstruction(*super_family(h))
    g.commit_fused()
    left[lanes] -= g.n
    tl = lanes[g.term]
    ran = _run_terms(t, st, tl, fuel_on, left, win, opt, t0_time)
    if h < H_BLOCK_BASE or ran.numel() == 0:
        return
    n = len(t.shapes[h - H_BLOCK_BASE])
    if not bool((t.flen[pc.long()] > n).any()):
        return
    head = torch.full_like(st.pc, -1)
    head[lanes] = pc
    hp = head[ran]
    call = (t.flen[hp.long()] > n) & (st.pc[ran] == hp + n) & \
        (st.trap[ran] == 0)
    _run_terms(t, st, ran[call], fuel_on, left, win, opt, t0_time)


def _run_terms(t, st, tl, fuel_on, left, win, opt, t0_time):
    """One op, per op, on the lanes `tl` at their pcs; returns the lanes
    that ran it (not those waiting for a commit)."""
    out = []
    if tl.numel() == 0:
        return tl
    tpc = st.pc[tl].clamp(0, t.hid.shape[0] - 1)
    th = t.hid[tpc.long()]
    for h2 in torch.unique(th).tolist():
        m = th == h2
        ran = _Group(t, st, tl[m], tpc[m], fuel_on, win, opt,
                     t0_time).run(int(h2))
        left[ran] -= 1
        out.append(ran)
    return torch.cat(out)


def _gas(t, pc, n):
    """The fuel n ops from pc cost: n with flat gas, the sum of their
    weights (wrapped to int32) with weighted gas."""
    if t.gcum is None:
        return n
    pcl = pc.long()
    return ops.wrap32(t.gcum[pcl + n].long() - t.gcum[pcl].long())


class _Group:
    """One handler applied to the lanes that sit at it this step; `win`
    the launch's memory windows (None: the plane is read directly);
    `opt` the launch's optimistic convergence (None: careful); `t0_time`
    the launch's tier-0 time base."""

    def __init__(self, t, st, lanes, pc, fuel_on, win=None, opt=None,
                 t0_time=None):
        self.t, self.st, self.lanes, self.pc = t, st, lanes, pc
        self.fuel_on = fuel_on
        self.win = win
        self.t0_time = t0_time
        self.way = None  # the way the last window select chose
        # (on, lead) of the lanes' warps, None when none is on
        self.opt = opt
        self.olead = None if opt is None or not opt.any_on() \
            else opt.leads(lanes)
        self.defer = None  # lanes whose instruction waits for a commit
        self.D = st.stack_lo.shape[0]
        self.simd = st.stack_e2 is not None
        pcl = pc.long()
        self.a, self.b, self.c = t.a[pcl], t.b[pcl], t.c[pcl]
        self.sp = st.sp[lanes]
        self.fp = st.fp[lanes]
        self.ob = st.opbase[lanes]
        self.cd = st.call_depth[lanes]
        z = torch.zeros_like(pc)
        # defaults: fall through to pc + 1, no trap
        self.new_pc = pc + 1
        self.new_sp = self.sp
        self.new_fp = self.fp
        self.new_ob = self.ob
        self.new_cd = self.cd
        self.trap = z
        self.sp_on_halt = None  # return-from-depth-0 sets sp even halted

    # -- plane access (rows clamped into the plane, as the reference) -----
    def gat(self, plane, rows):
        r = rows.clamp(0, plane.shape[0] - 1).long()
        return plane[r, self.lanes]

    def scat(self, plane, rows, vals, mask=None):
        r = rows.clamp(0, plane.shape[0] - 1).long()
        lanes = self.lanes
        if mask is not None:
            r, lanes, vals = r[mask], lanes[mask], vals[mask]
        plane[r, lanes] = vals

    def cell(self, rows):
        return (self.gat(self.st.stack_lo, rows),
                self.gat(self.st.stack_hi, rows))

    def put(self, rows, lo, hi, mask=None):
        """A scalar write: with four planes it zeroes e2 and e3."""
        z = torch.zeros_like(lo) if self.simd else None
        self.put4(rows, (lo, hi, z, z), mask)

    def cell4(self, rows):
        """The whole cell: (lo, hi, e2, e3), e2 and e3 None when the
        stack has two planes."""
        st = self.st
        ext = (self.gat(st.stack_e2, rows), self.gat(st.stack_e3, rows)) \
            if self.simd else (None, None)
        return (*self.cell(rows), *ext)

    def put4(self, rows, v4, mask=None):
        st = self.st
        planes = (st.stack_lo, st.stack_hi) + \
            ((st.stack_e2, st.stack_e3) if self.simd else ())
        for plane, v in zip(planes, v4):
            self.scat(plane, rows, v, mask)

    # -- decisions (B3) ------------------------------------------------------
    def agree(self, v, mask=None):
        """An exact decision: lane 0's value on lanes whose warp is on
        (a lane that differs sets its canary; `mask`: the lanes that take
        the decision), the lane's own elsewhere."""
        if self.olead is None:
            return v
        ol, lead = self.olead
        lv = v[lead]
        d = ol & (v != lv)
        self.opt.disagree(self.lanes, d if mask is None else d & mask)
        return lv

    def agree_nz(self, v, mask=None):
        """A condition: lane 0's value, compared by zeroness."""
        if self.olead is None:
            return v
        ol, lead = self.olead
        lv = v[lead]
        d = ol & ((v != 0) != (lv != 0))
        self.opt.disagree(self.lanes, d if mask is None else d & mask)
        return lv

    def wait(self, d):
        """Lanes `d` (whose warps are on) run nothing of this
        instruction: it waits for a commit."""
        self.defer = d if self.defer is None else self.defer | d

    # -- dispatch ------------------------------------------------------------
    def run(self, h):
        """Returns the lanes that ran (not those waiting for a commit)."""
        if h in _A3_WRITES and self.olead is not None:
            # B3: a warp that is on and not uniform commits first and
            # runs it per lane; a uniform warp runs it here
            d = self.olead[0] & ~self.opt.uniform[self.opt.wid[self.lanes]]
            if bool(d.any()):
                self.opt.defer(self.lanes[d], DEFER_BULK)
                rest = ~d
                if not bool(rest.any()):
                    return self.lanes[rest]
                return _Group(self.t, self.st, self.lanes[rest],
                              self.pc[rest], self.fuel_on, self.win,
                              self.opt, self.t0_time).run(h)
        if h >= H_ALU2_BASE and h < H_ALU1_BASE:
            self.alu2(h - H_ALU2_BASE)
        elif h >= H_ALU1_BASE and h < H_ALU1_BASE + _NUM_ALU1:
            self.alu1(h - H_ALU1_BASE)
        elif h in (H_LOAD, H_LOAD_W, H_LOAD_D):
            self.load()
        elif h in (H_STORE, H_STORE_W, H_STORE_D):
            self.store()
        elif h >= H_V2_BASE and h < NUM_HANDLERS:
            self.v128_family(h)
        else:
            handler = _BASE.get(h)
            if handler is None:
                raise ValueError(f"handler id {h} is not in this slice")
            handler(self)
        if self.defer is not None and bool(self.defer.any()):
            d = self.defer
            self.opt.defer(self.lanes[d], DEFER_BULK if h in (
                H_MEMFILL, H_MEMCOPY, H_HOSTCALL) else DEFER_ACCESS)
            self._keep(~d)
        self.commit()
        return self.lanes

    def _keep(self, m):
        """Only the lanes of `m` go on to the commit."""
        for f in ("lanes", "pc", "sp", "fp", "ob", "cd", "new_pc", "new_sp",
                  "new_fp", "new_ob", "new_cd", "trap", "sp_on_halt"):
            v = getattr(self, f)
            if v is not None:
                setattr(self, f, v[m])

    def commit(self):
        st, lanes = self.st, self.lanes
        st.retired[lanes] += 1
        trap = self.trap
        if self.fuel_on:
            fuel = st.fuel[lanes] - (1 if self.t.cost is None
                                     else self.t.cost[self.pc.long()])
            st.fuel[lanes] = fuel
            trap = torch.where((trap == 0) & (fuel <= 0),
                               torch.full_like(trap,
                                               int(ErrCode.CostLimitExceeded)),
                               trap)
        halted = trap != 0
        keep = ~halted
        st.trap[lanes] = trap
        st.pc[lanes] = torch.where(keep, self.new_pc, st.pc[lanes])
        sp_halt = self.sp if self.sp_on_halt is None else self.sp_on_halt
        st.sp[lanes] = torch.where(keep, self.new_sp, sp_halt)
        st.fp[lanes] = torch.where(keep, self.new_fp, self.fp)
        st.opbase[lanes] = torch.where(keep, self.new_ob, self.ob)
        st.call_depth[lanes] = torch.where(keep, self.new_cd, self.cd)

    # -- stack / locals / globals ----------------------------------------------
    def nop(self):
        pass

    def const(self):
        pcl = self.pc.long()
        self.put(self.sp, self.t.ilo[pcl], self.t.ihi[pcl])
        self.new_sp = self.sp + 1

    def local_get(self):
        self.put4(self.sp, self.cell4(self.fp + self.a))
        self.new_sp = self.sp + 1

    def local_set(self):
        self.put4(self.fp + self.a, self.cell4(self.sp - 1))
        self.new_sp = self.sp - 1

    def local_tee(self):
        self.put4(self.fp + self.a, self.cell4(self.sp - 1))

    def global_get(self):
        g = self.a.clamp(0, self.st.glob_lo.shape[0] - 1)
        lo = self.gat(self.st.glob_lo, g)
        hi = self.gat(self.st.glob_hi, g)
        self.put(self.sp, lo, hi)
        self.new_sp = self.sp + 1

    def global_set(self):
        g = self.a.clamp(0, self.st.glob_lo.shape[0] - 1)
        lo, hi = self.cell(self.sp - 1)
        self.scat(self.st.glob_lo, g, lo)
        self.scat(self.st.glob_hi, g, hi)
        self.new_sp = self.sp - 1

    def drop(self):
        self.new_sp = self.sp - 1

    def select(self):
        c_lo, _ = self.cell(self.sp - 1)
        v1 = self.cell4(self.sp - 2)
        v2 = self.cell4(self.sp - 3)
        z = c_lo == 0
        self.put4(self.sp - 3, tuple(
            None if a is None else torch.where(z, a, b)
            for a, b in zip(v1, v2)))
        self.new_sp = self.sp - 2

    # -- branches --------------------------------------------------------------
    def br(self):
        self.put4(self.ob + self.c, self.cell4(self.sp - 1), self.b == 1)
        self.new_sp = self.ob + self.c + self.b
        self.new_pc = self.a

    def brz(self):
        v_lo = self.agree_nz(self.cell(self.sp - 1)[0])
        self.new_sp = self.sp - 1
        self.new_pc = torch.where(v_lo == 0, self.a, self.pc + 1)

    def brnz(self):
        c_lo = self.agree_nz(self.cell(self.sp - 1)[0])
        taken = c_lo != 0
        self.put4(self.ob + self.c, self.cell4(self.sp - 2),
                  taken & (self.b == 1))
        self.new_sp = torch.where(taken, self.ob + self.c + self.b,
                                  self.sp - 1)
        self.new_pc = torch.where(taken, self.a, self.pc + 1)

    def br_table(self):
        i_lo = self.agree(self.cell(self.sp - 1)[0])
        idx = torch.where(ops.u_lt(self.b, i_lo), self.b, i_lo)
        n = self.t.brt.shape[0] // 3
        e = (self.a + idx).clamp(0, n - 1).long() * 3
        tgt, keep, pop = self.t.brt[e], self.t.brt[e + 1], self.t.brt[e + 2]
        self.put4(self.ob + pop, self.cell4(self.sp - 2), keep == 1)
        self.new_sp = self.ob + pop + keep
        self.new_pc = tgt

    # -- calls -----------------------------------------------------------------
    def ret(self):
        st = self.st
        nres = self.b
        self.put4(self.fp, self.cell4(self.sp - 1), nres == 1)
        done = self.cd == 0
        CD = st.fr_ret_pc.shape[0]
        rd = (self.cd - 1).clamp(0, CD - 1)
        # frame rows are the lane's own: where the return goes is a
        # decision (the entry compares no frame row)
        back = ~done
        self.new_pc = torch.where(done, self.pc, self.agree(
            self.gat(st.fr_ret_pc, rd), back))
        self.new_fp = torch.where(done, self.fp, self.agree(
            self.gat(st.fr_fp, rd), back))
        self.new_ob = torch.where(done, self.ob, self.agree(
            self.gat(st.fr_opbase, rd), back))
        self.new_cd = torch.where(done, self.cd, self.cd - 1)
        self.new_sp = self.fp + nres
        self.trap = torch.where(done, torch.full_like(self.trap, TRAP_DONE),
                                self.trap)
        self.sp_on_halt = torch.where(done, self.fp + nres, self.sp)

    def call(self):
        nf = self.t.fent.shape[0]
        self._call(self.a.clamp(0, nf - 1), self.sp, None)

    def retcall(self):
        nf = self.t.fent.shape[0]
        self._call(self.a.clamp(0, nf - 1), self.sp, None, tail=True)

    def retcall_indirect(self):
        self.call_indirect(tail=True)

    def call_indirect(self, tail=False):
        """Through the lane's own table where the code mutates it (its
        handle agreed under B3: lanes with one index can reach different
        callees), else table 0 with the instruction's size `b`."""
        t = self.t
        nf = t.fent.shape[0]
        i_lo = self.agree(self.cell(self.sp - 1)[0])
        size = self._tsize()
        ti = self.c + i_lo.clamp(min=0).minimum((size - 1).clamp(min=0))
        if t.tmut:
            handle = self.agree(self.gat(self.st.tab, ti))
        else:
            ti = ti.clamp(0, t.tbl.shape[0] - 1)
            handle = t.tbl[ti.long()]
        oob = ~ops.u_lt(i_lo, size)
        null = ~oob & (handle == 0)
        callee = (handle - 1).clamp(0, nf - 1)
        bad_sig = ~oob & ~null & (t.ftyp[callee.long()] != self.a)
        code = torch.zeros_like(self.trap)
        for m, err in ((oob, ErrCode.UndefinedElement),
                       (null, ErrCode.UninitializedElement),
                       (bad_sig, ErrCode.IndirectCallTypeMismatch)):
            code = torch.where(m, torch.full_like(code, int(err)), code)
        self._call(callee, self.sp - 1, code, tail)

    def _call(self, callee, sp_eff, code, tail=False):
        """A call, or with `tail` a return_call: the frame is replaced
        (fp stays, the arguments slide down to it in ascending order,
        which is overlap-safe since they lie at or above the operand
        base; no frame row is written and the call stack is not
        checked, engine.py:1496-1516 of the reference)."""
        t, st = self.t, self.st
        cl = callee.long()
        entry, npar, nloc, ftop = t.fent[cl], t.fnpar[cl], t.fnloc[cl], \
            t.ftop[cl]
        CD = st.fr_ret_pc.shape[0]
        fp_new = self.fp if tail else sp_eff - npar
        ob_new = fp_new + nloc
        if code is None:
            code = torch.zeros_like(self.trap)
        if not tail:
            code = torch.where(
                self.cd >= CD - 1,
                torch.full_like(code, int(ErrCode.CallStackExhausted)), code)
        code = torch.where(fp_new + ftop > self.D,
                           torch.full_like(code, int(ErrCode.StackOverflow)),
                           code)
        ok = code == 0
        if tail:
            for k in range(int(npar.max()) if npar.numel() else 0):
                self.put4(self.fp + k, self.cell4(sp_eff - npar + k),
                          ok & (k < npar))
        else:
            self.scat(st.fr_ret_pc, self.cd, self.pc + 1, ok)
            self.scat(st.fr_fp, self.cd, self.fp, ok)
            self.scat(st.fr_opbase, self.cd, self.ob, ok)
        zero = torch.zeros_like(self.pc)
        for k in range(t.max_local_zeros):
            self.put(fp_new + npar + k, zero, zero, ok & (k < nloc - npar))
        self.trap = code
        self.new_pc = entry
        self.new_fp = fp_new
        self.new_ob = ob_new
        self.new_sp = ob_new
        self.new_cd = self.cd if tail else self.cd + 1

    # -- memory ----------------------------------------------------------------
    def _ea(self, base, nbytes, off=None):
        """Effective address of an access of nbytes at base + offset (the
        op's `a` unless given), bounds in u32 with the carry, its first
        word and bit shift."""
        off = self.a if off is None else off
        ea = ops.wrap32(base.to(torch.int64) + off.to(torch.int64))
        pages = self.st.mem_pages[self.lanes]
        mem_bytes = ops.wrap32(pages.to(torch.int64) * 65536)
        end = ops.wrap32(ea.to(torch.int64) + nbytes)
        carry = ops.u_lt(ea, base) | ops.u_lt(ea, off)
        oob = carry | ops.u_lt(end, ea) | ops.u_lt(mem_bytes, end)
        widx = (ops.u32(ea) >> 2).to(I32)
        sh = (ea & 3) * 8
        return ea, oob, widx, sh

    def _access(self, base, nbytes, nwords, off=None, mask=None):
        """An access of nbytes (nwords words) at base + offset on the
        lanes of `mask` (all when None), the address lane 0's where the
        warp is on: (out-of-bounds mask, first word, bit shift, the lanes
        that access: in bounds, in `mask` and, with windows in an "on"
        warp, not waiting for the commit a dirty write-back needs)."""
        base = self.agree(base, mask)
        _, oob, widx, sh = self._ea(base, nbytes, off)
        en = ~oob if mask is None else ~oob & mask
        if self.win is not None and self.olead is not None:
            W = self.st.mem.shape[0]
            d = en & self.olead[0] & self.win.dirty_miss(
                self.lanes, widx.clamp(0, W - 1),
                (widx + nwords - 1).clamp(0, W - 1))
            if bool(d.any()):
                self.wait(d)
                en = en & ~d
        return oob, widx, sh, en

    def _words(self, widx, n=3, en=None):
        """The n memory words from row widx on of each lane (rows clamped
        into the plane): through the window that holds them, selected on
        the lanes of `en` (in-bounds accesses), when the windows are on."""
        W = self.st.mem.shape[0]
        rows = [(widx + k).clamp(0, W - 1) for k in range(n)]
        if self.win is None:
            return [self.gat(self.st.mem, r) for r in rows]
        self.way = self.win.select(self.lanes, rows[0], rows[-1], en)
        return [self.win.read(self.lanes, self.way, r) for r in rows]

    def _put_word(self, row, vals, mask):
        """Memory row `row` of each lane gets vals where mask (the window
        of the last `_words` when the windows are on)."""
        if self.win is None:
            self.scat(self.st.mem, row, vals, mask)
        else:
            W = self.st.mem.shape[0]
            self.win.write(self.lanes, self.way, row.clamp(0, W - 1), vals,
                           mask)

    def load(self):
        base, _ = self.cell(self.sp - 1)
        lo, hi, oob, en = self.load_val(base, self.a, self.b, self.c)
        self.put(self.sp - 1, lo, hi, en)
        self.trap = torch.where(
            oob, torch.full_like(self.trap, int(ErrCode.MemoryOutOfBounds)),
            self.trap)

    def load_val(self, base, off, nbytes, flags, mask=None):
        """The value (lo, hi) of a load of nbytes (flags: 1 signed, 2 to
        i64) at base + off on the lanes of `mask` (all when None), its
        out-of-bounds mask and the lanes that loaded."""
        oob, widx, sh, en = self._access(base, nbytes.to(torch.int64), 3,
                                         off, mask)
        w0, w1, w2 = (ops.u32(w) for w in self._words(widx, 3, en))
        sh64 = sh.to(torch.int64)
        raw_lo = ops.wrap32(ops.shr_u64(w0 | (w1 << 32), sh64))
        raw_hi = ops.wrap32(ops.shr_u64(w1 | (w2 << 32), sh64))
        signed, is64 = (flags & 1) != 0, (flags & 2) != 0
        b1, b2 = nbytes == 1, nbytes == 2
        lraw = torch.where(b1, raw_lo & 0xFF,
                           torch.where(b2, raw_lo & 0xFFFF, raw_lo))
        lsext = torch.where(b1, ops.wrap32(ops._sext(raw_lo, 8)),
                            torch.where(b2, ops.wrap32(ops._sext(raw_lo, 16)),
                                        raw_lo))
        lo = torch.where(signed, lsext, lraw)
        hi = torch.where(is64, torch.where(
            nbytes == 8, raw_hi,
            torch.where(signed, lo >> 31, torch.zeros_like(lo))),
            torch.zeros_like(lo))
        return lo, hi, oob, en

    def store(self):
        v_lo, v_hi = self.cell(self.sp - 1)
        base, _ = self.cell(self.sp - 2)
        oob = self.store_val(base, self.a, self.b, v_lo, v_hi)
        self.new_sp = self.sp - 2
        self.trap = torch.where(
            oob, torch.full_like(self.trap, int(ErrCode.MemoryOutOfBounds)),
            self.trap)

    def store_val(self, base, off, nbytes, v_lo, v_hi, mask=None):
        """A store of nbytes of (v_lo, v_hi) at base + off on the lanes of
        `mask` (all when None) that are in bounds; returns the
        out-of-bounds mask."""
        oob, widx, sh, ok = self._access(base, nbytes.to(torch.int64), 3,
                                         off, mask)
        words = self._words(widx, 3, ok)
        sh64 = sh.to(torch.int64)
        full = torch.where(nbytes == 1, torch.full_like(sh64, 0xFF),
                           torch.where(nbytes == 2,
                                       torch.full_like(sh64, 0xFFFF),
                                       torch.full_like(sh64, 0xFFFFFFFF)))
        full = torch.where(nbytes == 8, torch.full_like(sh64, -1), full)
        val = ops.pack(v_lo, v_hi)
        m01 = ops.shl64(full, sh64)
        v01 = ops.shl64(val, sh64)
        back = (64 - sh64).clamp(max=63)
        m2 = torch.where(sh64 == 0, torch.zeros_like(sh64),
                         ops.shr_u64(full, back) & 0xFFFFFFFF)
        v2 = torch.where(sh64 == 0, torch.zeros_like(sh64),
                         ops.shr_u64(val, back) & 0xFFFFFFFF)
        masks = [m01 & 0xFFFFFFFF, ops.shr_u64(m01, 32), m2]
        vals = [v01 & 0xFFFFFFFF, ops.shr_u64(v01, 32), v2]
        for k in range(3):
            mk = masks[k]
            new = (ops.u32(words[k]) & ~mk) | (vals[k] & mk)
            self._put_word(widx + k, ops.wrap32(new), ok & (mk != 0))
        return oob

    def memsize(self):
        pages = self.st.mem_pages[self.lanes]
        self.put(self.sp, pages, torch.zeros_like(pages))
        self.new_sp = self.sp + 1

    def memgrow(self):
        st = self.st
        delta = self.agree(self.cell(self.sp - 1)[0])
        pages = st.mem_pages[self.lanes]
        new = ops.wrap32(pages.to(torch.int64) + delta.to(torch.int64))
        cap = self.b  # the page ceiling of the module the pc belongs to
        ok = ~ops.u_lt(cap, new) & (delta >= 0) & (new >= pages)
        res = torch.where(ok, pages, torch.full_like(pages, -1))
        self.put(self.sp - 1, res, torch.zeros_like(res))
        st.mem_pages[self.lanes] = torch.where(ok, new, pages)

    def trap_op(self):
        self.trap = self.a.clone()

    # -- host calls and bulk memory --------------------------------------------
    def hostcall(self):
        """Park at the stub (the host re-arms the lane at pc + 1), unless
        tier 0 retires the call here (`_tier0`)."""
        park = torch.ones_like(self.pc, dtype=torch.bool)
        if self.t.t0k is not None:
            kind = self.t.t0k[self.pc.long()]
            t0 = kind != 0
            if bool(t0.any()):
                park = self._tier0(kind, t0)
        self.trap = torch.where(park, torch.full_like(self.trap,
                                                      TRAP_HOSTCALL),
                                self.trap)

    def _tier0(self, kind, t0):
        """The reference SIMT step's tier-0 section (engine.py:1309-1449,
        the write at the operand base :1577-1581, sp :1756, the traps
        :1795-1799) on the lanes of `t0` that run; returns the lanes
        that park."""
        st, lanes = self.st, self.lanes
        if self.olead is not None:
            # B3: a warp that is on commits first and then runs the call
            # per lane; a uniform warp runs it in place, but random_get
            on = self.olead[0]
            uni = self.opt.uniform[self.opt.wid[lanes]]
            d = on & t0 & (~uni | (kind == T0_RANDOM_GET))
            if bool(d.any()):
                self.wait(d)
                t0 = t0 & ~d
        if self.win is not None:
            w = t0 & torch.isin(kind, torch.tensor(T0_NEEDS_MEMORY,
                                                   device=kind.device))
            if bool(w.any()):
                self.win.flush(lanes[w])
        s = self.t.t0
        mem = st.mem
        zero = torch.zeros_like(self.pc)
        arg = [self.gat(st.stack_lo, self.fp + k) for k in range(4)]
        ctr = [st.t0_ctr[r, lanes] for r in range(4)]
        mem_bytes = ops.wrap32(st.mem_pages[lanes].to(torch.int64) * 65536)
        u_lt = ops.u_lt
        gat = self.gat

        def rmw(plane, rows, m, v, ok):
            cur = self.gat(plane, rows)
            self.scat(plane, rows, (cur & ~m) | (v & m), ok & (m != 0))
            return plane

        def wrap(v):
            return ops.wrap32(v.to(torch.int64))

        push = torch.zeros_like(t0)
        val = zero.clone()
        # clock_time_get(id, precision, *time)
        m_clk = t0 & (kind == T0_CLOCK_TIME_GET)
        if bool(m_clk.any()):
            cid, tptr = arg[0], arg[2]
            bad_id = u_lt(torch.full_like(cid, 3), cid)
            hard_id = (cid == 2) | (cid == 3)
            tend = wrap(tptr.to(torch.int64) + 8)
            c_oob = u_lt(tend, tptr) | u_lt(mem_bytes, tend)
            tv_lo, tv_hi = t0f.t0_clock_value(self.t0_time, cid, ctr[0])
            wr = m_clk & ~bad_id & ~hard_id & ~c_oob
            t0f.t0_masked_store(rmw, mem, tptr, tv_lo, tv_hi, 8, wr)
            done = m_clk & ~hard_id
            res = torch.where(bad_id, s["E_INVAL"],
                              torch.where(c_oob, s["E_FAULT"], 0))
            push |= done
            val = torch.where(done, res.to(torch.int32), val)
            ctr[0] = ctr[0] + wr.to(torch.int32)
        # random_get(*buf, len)
        m_rnd = t0 & (kind == T0_RANDOM_GET)
        if bool(m_rnd.any()):
            rbuf, rlen = arg[0], arg[1]
            fits = ~u_lt(torch.full_like(rlen, s["RMAX_W"] * 4), rlen)
            rend = wrap(rbuf.to(torch.int64) + ops.u32(rlen))
            r_oob = u_lt(rend, rbuf) | u_lt(mem_bytes, rend)
            ok = m_rnd & fits
            wr = ok & ~r_oob & (rlen != 0)
            seq_h = t0f.t0_rng_seq_hash(s["RNG_SEED"], lanes, ctr[1])
            if bool(wr.any()):
                t0f.t0_random_fill(rmw, mem, rbuf, rend, wr, seq_h,
                                   s["RMAX_W"], zero)
            push |= ok
            val = torch.where(ok, torch.where(r_oob, s["E_FAULT"], 0)
                              .to(torch.int32), val)
            ctr[1] = ctr[1] + wr.to(torch.int32)
        # fd_write(fd, *iovs, iovs_len, *nwritten)
        m_fdw = t0 & (kind == T0_FD_WRITE)
        if bool(m_fdw.any()):
            wfd, wiovs, wcnt, wnp = arg
            so_off = st.so_off[lanes]
            SW = st.so_buf.shape[0]
            iov_end = wrap(wiovs.to(torch.int64) + 8)
            iov_ok = ~(u_lt(iov_end, wiovs) | u_lt(mem_bytes, iov_end))
            iw = (ops.u32(wiovs) >> 2).to(torch.int32)
            wbuf, wlen = gat(mem, iw), gat(mem, iw + 1)
            fits = ~u_lt(torch.full_like(wlen, s["WMAX_W"] * 4), wlen)
            nwords = (ops.u32(wrap(ops.u32(wlen) + 3)) >> 2).to(torch.int32)
            space = ~u_lt(torch.full_like(wlen, SW),
                          wrap(ops.u32(so_off) + 1 + ops.u32(nwords)))
            npend = wrap(wnp.to(torch.int64) + 4)
            np_ok = ~(u_lt(npend, wnp) | u_lt(mem_bytes, npend))
            handled = m_fdw & ((wfd == 1) | (wfd == 2)) & (wcnt == 1) & \
                ((wiovs & 3) == 0) & iov_ok & fits & space & np_ok
            dend = wrap(ops.u32(wbuf) + ops.u32(wlen))
            d_oob = u_lt(dend, wbuf) | u_lt(mem_bytes, dend)
            wr = handled & ~d_oob
            if bool(wr.any()):
                shb = (wbuf & 3) * 8
                inv = (32 - shb) & 31
                hi_or = torch.where(shb == 0, 0, -1).to(torch.int32)
                w0 = (ops.u32(wbuf) >> 2).to(torch.int32)
                hdr = wlen | (wfd << 28)
                self.scat(st.so_buf, so_off, hdr, wr)
                for j in range(s["WMAX_W"]):
                    on_j = wr & (j * 4 < wlen)
                    if not bool(on_j.any()):
                        break
                    v = t0f.t0_shifted_src_word(gat, mem, w0, j, shb, inv,
                                                hi_or)
                    self.scat(st.so_buf, so_off + 1 + j, v, on_j)
                t0f.t0_masked_store(rmw, mem, wnp, wlen, zero, 4, wr)
                st.so_off[lanes] = torch.where(wr, so_off + 1 + nwords,
                                               so_off)
            push |= handled
            val = torch.where(handled, torch.where(d_oob, s["E_FAULT"], 0)
                              .to(torch.int32), val)
            ctr[2] = ctr[2] + wr.to(torch.int32)
        # sched_yield(), proc_exit(code)
        m_yld = t0 & (kind == T0_SCHED_YIELD)
        push |= m_yld
        m_ext = t0 & (kind == T0_PROC_EXIT)
        val = torch.where(m_ext, arg[0], val)
        ctr[3] = ctr[3] + (m_yld | m_ext).to(torch.int32)
        for r in range(4):
            st.t0_ctr[r, lanes] = ctr[r]
        # the result (or the exit code) at the operand base, as the host
        # serve writes it; a retired call resumes at the stub's RETURN
        self.put(self.ob, val, zero, push | m_ext)
        self.new_sp = torch.where(push, self.ob + 1, self.new_sp)
        self.trap = torch.where(m_ext, torch.full_like(
            self.trap, int(ErrCode.Terminated)), self.trap)
        return ~(push | m_ext)

    def memfill(self):
        self._bulk(copy=False)

    def memcopy(self):
        self._bulk(copy=True)

    def _bulk(self, copy):
        """Operands (top of stack): n, then the fill value or copy source,
        then dst.  Unsigned bounds in exact int64 arithmetic.  In a warp
        that is on, it waits for a commit and then runs per lane
        (`_opt_bulk_exit`, pallas_engine.py :1065-1080)."""
        go = None
        if self.olead is not None:
            self.wait(self.olead[0])
            go = ~self.olead[0]
        n = ops.u32(self.cell(self.sp - 1)[0])
        val_or_src = ops.u32(self.cell(self.sp - 2)[0])
        dst = ops.u32(self.cell(self.sp - 3)[0])
        pages = self.st.mem_pages[self.lanes].to(torch.int64)
        mem_bytes = (pages * 65536) & 0xFFFFFFFF
        end = dst + n
        oob = (end > 0xFFFFFFFF) | (end > mem_bytes)
        if copy:
            send = val_or_src + n
            oob = oob | (send > 0xFFFFFFFF) | (send > mem_bytes)
        self.trap = torch.where(
            oob, torch.full_like(self.trap, int(ErrCode.MemoryOutOfBounds)),
            self.trap)
        self.new_sp = self.sp - 3
        if self.win is not None:
            # the bulk loop runs on the plane: the lanes' dirty windows
            # go back first, and none stays valid (pallas_engine.py
            # :2303-2306)
            self.win.flush(self.lanes if go is None else self.lanes[go])
        go = ~oob & (n != 0) if go is None else go & ~oob & (n != 0)
        if bool(go.any()):
            _fill_copy(self.st.mem, self.lanes[go], dst[go], end[go],
                       val_or_src[go], copy)

    # -- tables and segments (engine.py:1156-1307 of the reference) ----------
    def _tsize(self):
        """Each lane's table size: its `tsize` where the code mutates the
        table, else the instruction's `b`."""
        return self.st.tsize[self.lanes] if self.t.tmut else self.b

    def _err(self, m, err):
        self.trap = torch.where(m, torch.full_like(self.trap, int(err)),
                                self.trap)

    def _trange(self, lo, hi, vals_of, go):
        """Rows [lo, hi) of each lane's table column (lanes of `go`) get
        vals_of(rows), gathered from the table as it was before the op."""
        if not bool(go.any()):
            return
        tab = self.st.tab
        T = tab.shape[0]
        rows = torch.arange(T, device=tab.device)[:, None]
        lanes = self.lanes[go]
        cur = tab[:, lanes]
        inr = (rows >= lo[go][None]) & (rows < hi[go][None])
        tab[:, lanes] = torch.where(inr, vals_of(rows, go, cur), cur)

    def table_get(self):
        i = self.cell(self.sp - 1)[0]
        oob = ~ops.u_lt(i, self._tsize())
        if self.t.tmut:
            val = self.gat(self.st.tab, self.c + i)
        else:
            n = self.t.tbl.shape[0]
            val = self.t.tbl[(self.c + i).clamp(0, n - 1).long()]
        self.put(self.sp - 1, val, torch.zeros_like(val), ~oob)
        self.trap = self.agree(torch.where(
            oob, torch.full_like(self.trap, int(ErrCode.TableOutOfBounds)),
            self.trap))

    def table_set(self):
        ref, i = self.cell(self.sp - 1)[0], self.cell(self.sp - 2)[0]
        oob = ~ops.u_lt(i, self._tsize())
        self.scat(self.st.tab, self.c + i, ref, ~oob)
        self._err(oob, ErrCode.TableOutOfBounds)
        self.new_sp = self.sp - 2

    def table_size(self):
        size = self._tsize()
        self.put(self.sp, size, torch.zeros_like(size))
        self.new_sp = self.sp + 1

    def table_grow(self):
        """delta on top, the init ref below; `b` is the capacity."""
        delta, init = self.cell(self.sp - 1)[0], self.cell(self.sp - 2)[0]
        size = self._tsize()
        new = ops.wrap32(size.to(torch.int64) + delta.to(torch.int64))
        ok = (delta >= 0) & (new >= size) & ~ops.u_lt(self.b, new)
        res = torch.where(ok, size, torch.full_like(size, -1))
        self.put(self.sp - 2, res, torch.zeros_like(res))
        self._trange(self.c + size, self.c + new,
                     lambda r, g, cur: init[g][None].expand_as(cur),
                     ok & (delta > 0))
        self.st.tsize[self.lanes] = torch.where(ok, new, size)
        self.new_sp = self.sp - 1

    def table_fill(self):
        """n on top, then the value, then the first row i."""
        n, val, i = (self.cell(self.sp - k)[0] for k in (1, 2, 3))
        end = ops.wrap32(i.to(torch.int64) + ops.u32(n))
        oob = ops.u_lt(end, i) | ops.u_lt(self._tsize(), end)
        self._trange(self.c + i, self.c + end,
                     lambda r, g, cur: val[g][None].expand_as(cur),
                     ~oob & (n != 0))
        self._err(oob, ErrCode.TableOutOfBounds)
        self.new_sp = self.sp - 3

    def table_copy(self):
        """n on top, then src, then dst; rows gathered from the table
        before the op (overlap-safe)."""
        n, src, dst = (self.cell(self.sp - k)[0] for k in (1, 2, 3))
        size = self._tsize()
        send = ops.wrap32(src.to(torch.int64) + ops.u32(n))
        dend = ops.wrap32(dst.to(torch.int64) + ops.u32(n))
        oob = ops.u_lt(send, src) | ops.u_lt(size, send) | \
            ops.u_lt(dend, dst) | ops.u_lt(size, dend)
        T = self.st.tab.shape[0]

        def vals(rows, g, cur):
            srow = (rows - dst[g][None] + src[g][None]).clamp(0, T - 1)
            return torch.gather(cur, 0, srow)

        self._trange(self.c + dst, self.c + dend, vals, ~oob & (n != 0))
        self._err(oob, ErrCode.TableOutOfBounds)
        self.new_sp = self.sp - 3

    def _segment(self, lens, offs, drops):
        """(length, offset) of segment `a` for each lane: length 0 once
        the lane dropped it."""
        k = self.a.clamp(0, lens.shape[0] - 1)
        kl = k.long()
        return torch.where(self.gat(drops, k) != 0, torch.zeros_like(k),
                           lens[kl]), offs[kl]

    def table_init(self):
        """n on top, then src (in the segment), then dst; segment `a`."""
        t = self.t
        n, src, dst = (self.cell(self.sp - k)[0] for k in (1, 2, 3))
        slen, soff = self._segment(t.elen, t.eoff, self.st.edrop)
        send = ops.wrap32(src.to(torch.int64) + ops.u32(n))
        dend = ops.wrap32(dst.to(torch.int64) + ops.u32(n))
        oob = ops.u_lt(send, src) | ops.u_lt(slen, send) | \
            ops.u_lt(dend, dst) | ops.u_lt(self._tsize(), dend)
        nf = t.efl.shape[0]
        base = self.c + dst

        def vals(rows, g, cur):
            k = soff[g][None] + src[g][None] + (rows - base[g][None])
            return t.efl[k.clamp(0, nf - 1).long()]

        self._trange(base, self.c + dend, vals, ~oob & (n != 0))
        self._err(oob, ErrCode.TableOutOfBounds)
        self.new_sp = self.sp - 3

    def elem_drop(self):
        k = self.a.clamp(0, self.st.edrop.shape[0] - 1)
        self.scat(self.st.edrop, k, torch.ones_like(k))

    def data_drop(self):
        k = self.a.clamp(0, self.st.ddrop.shape[0] - 1)
        self.scat(self.st.ddrop, k, torch.ones_like(k))

    def memory_init(self):
        """n on top, then src (in the segment), then dst; data segment
        `a`.  Bounds in u32 with the carry; the lane's windows are written
        back and dropped first, and the bytes go to the plane."""
        t = self.t
        n, src, dst = (ops.u32(self.cell(self.sp - k)[0]) for k in (1, 2, 3))
        slen, soff = self._segment(t.dlen, t.doff, self.st.ddrop)
        pages = self.st.mem_pages[self.lanes].to(torch.int64)
        mem_bytes = (pages * 65536) & 0xFFFFFFFF
        send, dend = (src + n) & 0xFFFFFFFF, (dst + n) & 0xFFFFFFFF
        oob = (send < src) | (ops.u32(slen) < send) | (dend < dst) | \
            (mem_bytes < dend)
        if self.win is not None:
            self.win.flush(self.lanes)
        go = ~oob & (n != 0)
        if bool(go.any()):
            _mem_init(self.st.mem, self.lanes[go], dst[go], dend[go],
                      (soff.to(torch.int64) + src - dst)[go], t.dwords)
        self._err(oob, ErrCode.MemoryOutOfBounds)
        self.new_sp = self.sp - 3

    def ref_func(self):
        v = self.a + 1
        self.put(self.sp, v, torch.zeros_like(v))
        self.new_sp = self.sp + 1

    # -- ALU -------------------------------------------------------------------
    def alu2(self, sub):
        y_lo, y_hi = self.cell(self.sp - 1)
        x_lo, x_hi = self.cell(self.sp - 2)
        lo, hi = ops.alu2(sub, x_lo, x_hi, y_lo, y_hi)
        self.put(self.sp - 2, lo, hi)
        self.new_sp = self.sp - 1
        if ops.alu2_traps(sub):
            self.trap = self.agree(ops.alu2_trap(sub, x_lo, x_hi, y_lo,
                                                 y_hi))

    def alu1(self, sub):
        w_lo, w_hi = self.cell(self.sp - 1)
        lo, hi = ops.alu1(sub, w_lo, w_hi)
        trap = None
        if ops.alu1_traps(sub):
            trap = ops.alu1_trap(sub, w_lo, w_hi)
            if sub in _TRUNC_F32:
                # the reference's f32 truncation writes 0 when it traps
                lo = torch.where(trap != 0, torch.zeros_like(lo), lo)
        self.put(self.sp - 1, lo, hi)
        if trap is not None:
            self.trap = self.agree(trap)

    # -- v128 (B7) -------------------------------------------------------------
    def _v128_row(self, a=None):
        n = self.t.v128.shape[0] // 4
        base = (self.a if a is None else a).clamp(0, n - 1).long() * 4
        return tuple(self.t.v128[base + k] for k in range(4))

    def vconst(self):
        self.put4(self.sp, self._v128_row())
        self.new_sp = self.sp + 1

    def vshuffle(self):
        x4, y4 = self.cell4(self.sp - 2), self.cell4(self.sp - 1)
        self.put4(self.sp - 2, sops.vshuffle_dyn(x4, y4, self._v128_row()))
        self.new_sp = self.sp - 1

    def vbitsel(self):
        # operands (v1, v2, mask) from the third cell down to the top
        w4, x4, y4 = (self.cell4(self.sp - k) for k in (3, 2, 1))
        self.put4(self.sp - 3, sops.vbitselect(w4, x4, y4))
        self.new_sp = self.sp - 2

    def v128_family(self, h):
        """The sub-indexed families: binary, unary, test, shift, splat,
        extract and replace."""
        sp = self.sp
        if h < H_V1_BASE:
            r = sops.v2_fn(h - H_V2_BASE)(self.cell4(sp - 2),
                                          self.cell4(sp - 1))
            self.put4(sp - 2, r)
            self.new_sp = sp - 1
        elif h < H_VTEST_BASE:
            self.put4(sp - 1, sops.v1_fn(h - H_V1_BASE)(self.cell4(sp - 1)))
        elif h < H_VSHIFT_BASE:
            r = sops.vtest_fn(h - H_VTEST_BASE)(self.cell4(sp - 1))
            self.put(sp - 1, r, torch.zeros_like(r))
        elif h < H_VSPLAT_BASE:
            n, _ = self.cell(sp - 1)
            self.put4(sp - 2, sops.vshift_fn(h - H_VSHIFT_BASE)(
                self.cell4(sp - 2), n))
            self.new_sp = sp - 1
        elif h < H_VEXTRACT_BASE:
            self.put4(sp - 1, sops.vsplat_fn(h - H_VSPLAT_BASE)(
                *self.cell(sp - 1)))
        elif h < H_VREPLACE_BASE:
            self.put(sp - 1, *sops.vextract_dyn(h - H_VEXTRACT_BASE)(
                self.cell4(sp - 1), self.a))
        else:
            lo, hi = self.cell(sp - 1)
            self.put4(sp - 2, sops.vreplace_dyn(h - H_VREPLACE_BASE)(
                self.cell4(sp - 2), self.a, lo, hi))
            self.new_sp = sp - 1

    def _v128_ea(self, base):
        """A 16-byte access: trap if out of bounds; the first of the five
        words it spans, the bit shift, the five words and the lanes that
        access."""
        oob, widx, sh, en = self._access(base, 16, 5)
        self.trap = torch.where(
            oob, torch.full_like(self.trap, int(ErrCode.MemoryOutOfBounds)),
            self.trap)
        words = [ops.u32(w) for w in self._words(widx, 5, en)]
        return en, widx, sh.to(torch.int64), words

    def vload(self):
        base, _ = self.cell(self.sp - 1)
        en, _, sh, w = self._v128_ea(base)
        r = tuple(ops.wrap32(torch.where(
            sh == 0, w[k], (w[k] >> sh) | (w[k + 1] << (32 - sh))))
            for k in range(4))
        self.put4(self.sp - 1, r, en)

    def vstore(self):
        base, _ = self.cell(self.sp - 2)
        val = [ops.u32(v) for v in self.cell4(self.sp - 1)]
        ok, widx, sh, w = self._v128_ea(base)
        full = torch.full_like(sh, 0xFFFFFFFF)
        zero = torch.zeros_like(sh)
        masks = [(full << sh) & 0xFFFFFFFF, full, full, full,
                 torch.where(sh == 0, zero, full >> (32 - sh))]
        prev = [zero] + val
        vals = [((prev[k + 1] if k < 4 else zero) << sh)
                | torch.where(sh == 0, zero, prev[k] >> (32 - sh))
                for k in range(5)]
        for k in range(5):
            m = masks[k]
            new = (w[k] & ~m) | (vals[k] & m)
            self._put_word(widx + k, ops.wrap32(new), ok & (m != 0))
        self.new_sp = self.sp - 2


_BASE = {
    H_NOP: _Group.nop, H_CONST: _Group.const, H_LOCAL_GET: _Group.local_get,
    H_LOCAL_SET: _Group.local_set, H_LOCAL_TEE: _Group.local_tee,
    H_GLOBAL_GET: _Group.global_get, H_GLOBAL_SET: _Group.global_set,
    H_DROP: _Group.drop, H_SELECT: _Group.select, H_BR: _Group.br,
    H_BRZ: _Group.brz, H_BRNZ: _Group.brnz, H_BR_TABLE: _Group.br_table,
    H_RETURN: _Group.ret, H_CALL: _Group.call,
    H_CALL_INDIRECT: _Group.call_indirect, H_MEMSIZE: _Group.memsize,
    H_MEMGROW: _Group.memgrow, H_TRAP: _Group.trap_op,
    H_HOSTCALL: _Group.hostcall, H_MEMFILL: _Group.memfill,
    H_MEMCOPY: _Group.memcopy,
    H_VCONST: _Group.vconst, H_VSHUFFLE: _Group.vshuffle,
    H_VBITSEL: _Group.vbitsel, H_VLOAD: _Group.vload,
    H_VSTORE: _Group.vstore,
    H_TABLE_GET: _Group.table_get, H_TABLE_SET: _Group.table_set,
    H_TABLE_SIZE: _Group.table_size, H_TABLE_GROW: _Group.table_grow,
    H_TABLE_FILL: _Group.table_fill, H_TABLE_COPY: _Group.table_copy,
    H_TABLE_INIT: _Group.table_init, H_ELEM_DROP: _Group.elem_drop,
    H_MEMINIT: _Group.memory_init, H_DATA_DROP: _Group.data_drop,
    H_RETCALL: _Group.retcall, H_RETCALL_INDIRECT: _Group.retcall_indirect,
    H_REFFUNC: _Group.ref_func,
}


class _Fused(_Group):
    """One fused dispatch on the lanes at one fused id: a B2 block shape
    run op by op over a virtual stack (a list of cells, each a tuple of
    per-lane tensors, lo/hi and e2/e3 or None), or a B6
    superinstruction.  The flush rule is the kernel's: at every exit the
    cells of the virtual stack at that point are written to their rows
    (scalar cells with e2/e3 zero), and nothing else of the stack is
    written.  Per lane it records the new pc and sp, the instructions
    retired (`n`), a trap, and whether a terminal op is left (`term`)."""

    def __init__(self, t, st, lanes, pc, fuel_on, win=None, opt=None,
                 t0_time=None):
        super().__init__(t, st, lanes, pc, fuel_on, win, opt, t0_time)
        z = torch.zeros_like(pc)
        self.active = torch.ones_like(pc, dtype=torch.bool)
        self.out_pc, self.out_sp = pc.clone(), self.sp.clone()
        self.n, self.otrap = z.clone(), z.clone()
        self.term = torch.zeros_like(self.active)

    def at(self, plane, j):
        return plane[(self.pc + j).long()]

    def sc(self, lo, hi):
        """A scalar cell."""
        z = torch.zeros_like(lo) if self.simd else None
        return (lo, hi, z, z)

    def exit(self, mask, snap, pc, sp, n, trap=0):
        mask = mask & self.active
        self.flush(snap, mask)
        self.out_pc = torch.where(mask, pc, self.out_pc)
        self.out_sp = torch.where(mask, sp, self.out_sp)
        self.n = torch.where(mask, torch.full_like(self.n, n), self.n)
        if trap:
            self.otrap = torch.where(mask, torch.full_like(self.n, trap),
                                     self.otrap)
        self.active = self.active & ~mask

    def flush(self, snap, mask):
        items, nbelow = snap
        for i, cell in enumerate(items):
            self.put4(self.sp + (i - nbelow), cell, mask)

    @staticmethod
    def sp_of(sp0, snap):
        return sp0 + (len(snap[0]) - snap[1])

    # -- B2 ------------------------------------------------------------------
    def block(self, shape):
        term = shape[-1][0] == "term"
        body = shape[:-1] if term else shape
        self.items, self.nbelow = [], 0
        for j, op in enumerate(body):
            self.block_op(j, op)
        snap = (self.items, self.nbelow)
        ran_through = self.active
        self.exit(ran_through, snap, self.pc + len(body),
                  self.sp_of(self.sp, snap), len(body))
        if term:
            self.term = ran_through

    def pop(self):
        if self.items:
            return self.items.pop()
        self.nbelow += 1
        return self.cell4(self.sp - self.nbelow)

    def peek(self):
        if self.items:
            return self.items[-1]
        return self.cell4(self.sp - self.nbelow - 1)

    def snap(self):
        return list(self.items), self.nbelow

    def block_op(self, j, op):
        kind, t = op[0], self.t
        push = self.items.append
        a = self.at(t.a, j)
        if kind == "nop":
            pass
        elif kind == "const":
            push(self.sc(self.at(t.ilo, j), self.at(t.ihi, j)))
        elif kind == "lget":
            # a local written earlier in the block reads back its new value
            push(self.cell4(self.fp + a))
        elif kind in ("lset", "ltee"):
            v = self.pop() if kind == "lset" else self.peek()
            self.put4(self.fp + a, v, self.active)
        elif kind == "gget":
            g = a.clamp(0, self.st.glob_lo.shape[0] - 1)
            push(self.sc(self.gat(self.st.glob_lo, g),
                         self.gat(self.st.glob_hi, g)))
        elif kind == "gset":
            v = self.pop()
            g = a.clamp(0, self.st.glob_lo.shape[0] - 1)
            self.scat(self.st.glob_lo, g, v[0], self.active)
            self.scat(self.st.glob_hi, g, v[1], self.active)
        elif kind == "drop":
            self.pop()
        elif kind == "select":
            cnd, x2, x1 = self.pop(), self.pop(), self.pop()
            z = cnd[0] == 0
            push(tuple(None if u is None else torch.where(z, u, w)
                       for u, w in zip(x2, x1)))
        elif kind == "memsize":
            pages = self.st.mem_pages[self.lanes]
            push(self.sc(pages, torch.zeros_like(pages)))
        elif kind == "alu2":
            y, x = self.pop(), self.pop()
            push(self.sc(*ops.alu2(op[1], x[0], x[1], y[0], y[1])))
        elif kind == "alu1":
            x = self.pop()
            push(self.sc(*ops.alu1(op[1], x[0], x[1])))
        elif kind in ("guardz", "guardnz"):
            cnd = self.agree_nz(self.pop()[0], self.active)
            snap = self.snap()
            if kind == "guardz":
                self.exit(cnd == 0, snap, a, self.sp_of(self.sp, snap),
                          j + 1)
            else:
                self.exit(cnd != 0, snap, a, self.ob + self.at(t.c, j),
                          j + 1)
        elif kind == "loadi":
            pre = self.snap()
            addr = self.pop()
            lo, hi, oob, _ = self.load_val(addr[0], a, self.at(t.b, j),
                                           self.at(t.c, j), self.active)
            self.access_exits(j, pre, oob)
            push(self.sc(lo, hi))
        elif kind == "storei":
            pre = self.snap()
            val, addr = self.pop(), self.pop()
            oob = self.store_val(addr[0], a, self.at(t.b, j), val[0], val[1],
                                 self.active)
            self.access_exits(j, pre, oob)
        else:
            push(self.block_v128(op, a))

    def access_exits(self, j, pre, oob):
        """After an inline access at op j: out of bounds, the lane exits
        with its trap, the op retired; waiting for a commit (an "on"
        warp's dirty write-back), it exits before the op."""
        sp = self.sp_of(self.sp, pre)
        self.exit(oob, pre, self.pc + j, sp, j + 1,
                  int(ErrCode.MemoryOutOfBounds))
        if self.defer is not None:
            d, self.defer = self.defer, None
            self.opt.defer(self.lanes[d & self.active], DEFER_ACCESS)
            self.exit(d, pre, self.pc + j, sp, j)

    def block_v128(self, op, a):
        kind = op[0]
        if kind == "v2":
            y, x = self.pop(), self.pop()
            return sops.v2_fn(op[1])(x, y)
        if kind == "v1":
            return sops.v1_fn(op[1])(self.pop())
        if kind == "vtest":
            r = sops.vtest_fn(op[1])(self.pop())
            return self.sc(r, torch.zeros_like(r))
        if kind == "vshift":
            cnt, x = self.pop(), self.pop()
            return sops.vshift_fn(op[1])(x, cnt[0])
        if kind == "vsplat":
            v = self.pop()
            return sops.vsplat_fn(op[1])(v[0], v[1])
        if kind == "vextract":
            return self.sc(*sops.vextract_dyn(op[1])(self.pop(), a))
        if kind == "vreplace":
            v, x = self.pop(), self.pop()
            return sops.vreplace_dyn(op[1])(x, a, v[0], v[1])
        if kind == "vconst":
            return self._v128_row(a)
        if kind == "vshuffle":
            y, x = self.pop(), self.pop()
            return sops.vshuffle_dyn(x, y, self._v128_row(a))
        if kind == "vbitsel":
            m, x, w = self.pop(), self.pop(), self.pop()
            return sops.vbitselect(w, x, m)
        raise ValueError(f"unknown block op {op}")

    # -- B6 ------------------------------------------------------------------
    def superinstruction(self, base, sub):
        t = self.t
        pcl = self.pc.long()
        fa, fb, fc = t.fa[pcl], t.fb[pcl], t.fc[pcl]
        filo, fihi = t.filo[pcl], t.fihi[pcl]
        fp, ob, sp, pc = self.fp, self.ob, self.sp, self.pc
        if base == H_FUSE_GBR:
            self.put4(ob + fc, self.cell4(fp + filo), fb == 1)
            self._super_out(fa, ob + fc + fb, 2)
            return
        if base == H_FUSE_A2R_BASE:
            # the result lands where the return moves it; the return is
            # the terminal
            x, y = self.cell(sp - 2), self.cell(sp - 1)
            self.put(fp, *ops.alu2(sub, *x, *y))
            self._super_out(pc + 1, fp + 1, 1, term=True)
            return
        if base in (H_FUSE_GGA_BASE, H_FUSE_GGS_BASE):
            x, y = self.cell(fp + fa), self.cell(fp + fc)
        elif base in (H_FUSE_GGBZ_BASE, H_FUSE_GGBNZ_BASE):
            x, y = self.cell(fp + filo), self.cell(fp + fihi)
        else:
            x, y = self.cell(fp + fa), (filo, fihi)
        r = ops.alu2(sub, *x, *y)
        if base in (H_FUSE_GCA_BASE, H_FUSE_GGA_BASE, H_FUSE_GCC_BASE):
            # GCC leaves its call to the per-op code
            self.put(sp, *r)
            self._super_out(pc + 3, sp + 1, 3,
                            term=base == H_FUSE_GCC_BASE)
        elif base in (H_FUSE_GCS_BASE, H_FUSE_GGS_BASE):
            self.put(fp + fb, *r)
            self._super_out(pc + 4, sp, 4)
        elif base in (H_FUSE_GCB_BASE, H_FUSE_GGBZ_BASE):
            tgt = fb if base == H_FUSE_GCB_BASE else fa
            self._super_out(torch.where(self.agree_nz(r[0]) == 0, tgt,
                                        pc + 4), sp, 4)
        else:  # GGBNZ
            taken = self.agree_nz(r[0]) != 0
            self.put4(ob + fc, self.cell4(sp - 1), taken & (fb == 1))
            self._super_out(torch.where(taken, fa, pc + 4),
                            torch.where(taken, ob + fc + fb, sp), 4)

    def _super_out(self, pc, sp, n, term=False):
        self.out_pc, self.out_sp = pc, sp
        self.n = torch.full_like(self.n, n)
        self.term = torch.full_like(self.term, term)

    def commit_fused(self):
        st, lanes = self.st, self.lanes
        st.pc[lanes] = self.out_pc
        st.sp[lanes] = self.out_sp
        st.retired[lanes] += self.n
        if self.fuel_on:
            st.fuel[lanes] -= _gas(self.t, self.pc, self.n)
        st.trap[lanes] = self.otrap


_BYTE_MASKS = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)


def _mem_init(mem, lanes, dst, end, base, words):
    """Bytes [dst, end) of each lane's column of the [W, L] memory plane
    get the data segment bytes at dst + base on (byte k of the flat
    segment bytes is byte k % 4 of words[k // 4]); rows outside the
    plane are not written (the reference's run_minit, restricted to the
    rows the lanes touch)."""
    W, nw = mem.shape[0], words.shape[0]
    r0 = int((dst >> 2).min())
    r1 = min(int(((end - 1) >> 2).max()), W - 1)
    if r0 > r1:
        return
    rows = torch.arange(r0, r1 + 1, dtype=torch.int64,
                        device=mem.device)[:, None]
    cols = lanes[None, :]
    out = ops.u32(mem[rows, cols])
    for bpos, bm in enumerate(_BYTE_MASKS):
        ba = rows * 4 + bpos
        inr = (ba >= dst[None, :]) & (ba < end[None, :])
        sb = ba + base[None, :]
        w = ops.u32(words[(sb >> 2).clamp(0, nw - 1)])
        byte = (w >> ((sb & 3) * 8)) & 0xFF
        out = torch.where(inr, (out & ~bm) | (byte << (8 * bpos)), out)
    mem[rows, cols] = ops.wrap32(out)


def _fill_copy(mem, lanes, dst, end, val_or_src, copy):
    """Bytes [dst, end) of each lane's column of the [W, L] memory plane
    get the fill byte, or the bytes at the same offsets from the copy
    source read from the plane before any write (memmove).  Word masks
    cover the byte edges; rows outside the plane are not written (the
    reference's `laneops.plane_fill_copy`, restricted to the rows the
    lanes touch)."""
    W = mem.shape[0]
    r0 = int((dst >> 2).min())
    r1 = min(int(((end - 1) >> 2).max()), W - 1)
    if r0 > r1:
        return
    rows = torch.arange(r0, r1 + 1, dtype=torch.int64,
                        device=mem.device)[:, None]
    byte0 = rows * 4
    mask = torch.zeros((rows.shape[0], lanes.shape[0]), dtype=torch.int64,
                       device=mem.device)
    for bpos, bm in enumerate(_BYTE_MASKS):
        ba = byte0 + bpos
        inr = (ba >= dst[None, :]) & (ba < end[None, :])
        mask = mask | torch.where(inr, bm, 0)
    cols = lanes[None, :]
    old = ops.u32(mem[rows, cols])
    if copy:
        # source word for each destination word, assembled from two
        # shifted words when src - dst is not a multiple of 4
        a0 = byte0 + (val_or_src - dst)[None, :]
        swi = a0 >> 2  # arithmetic: rounds toward -inf
        sh = (a0 & 3) * 8
        s0 = ops.u32(mem[swi.clamp(0, W - 1), cols])
        s1 = ops.u32(mem[(swi + 1).clamp(0, W - 1), cols])
        new = torch.where(sh == 0, s0,
                          ((s0 >> sh) | (s1 << (32 - sh))) & 0xFFFFFFFF)
    else:
        new = ((val_or_src & 0xFF) * 0x01010101)[None, :]
    mem[rows, cols] = ops.wrap32((old & ~mask) | (new & mask))

