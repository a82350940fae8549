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
    the instruction retired and its fuel charged;
  - memory.fill / memory.copy check both ranges first, write nothing on
    a trap, and read copy sources from the unmodified plane (memmove),
    as `laneops.plane_fill_copy` does; one instruction and one fuel unit
    however long.

Vectorised over lanes: each step groups the live lanes by the handler id
at their pc and applies one handler per group.  It is the reference the
tests hold the port against on the CPU and that `chip_smoke.py` holds the
kernel against on the card; no path of the engine calls it on the card.
"""

from __future__ import annotations

import torch

from wasmedge_tpu_torch.batch import laneops as ops
from wasmedge_tpu_torch.batch.image import ALU1_SUB, TRAP_DONE, TRAP_HOSTCALL
from wasmedge_tpu_torch.batch.interp import (
    H_ALU1_BASE, H_ALU2_BASE, H_BR, H_BR_TABLE, H_BRNZ, H_BRZ, H_CALL,
    H_CALL_INDIRECT, H_CONST, H_DROP, H_GLOBAL_GET, H_GLOBAL_SET,
    H_HOSTCALL, H_LOAD, H_LOAD_D, H_LOAD_W, H_LOCAL_GET, H_LOCAL_SET,
    H_LOCAL_TEE, H_MEMCOPY, H_MEMFILL, H_MEMGROW, H_MEMSIZE, H_NOP,
    H_RETURN, H_SELECT, H_STORE, H_STORE_D, H_STORE_W, H_TRAP, Tables)
from wasmedge_tpu_torch.common.errors import ErrCode

I32 = torch.int32
_TRUNC_F32 = (ALU1_SUB["i32.trunc_f32_s"], ALU1_SUB["i32.trunc_f32_u"])
_NUM_ALU1 = len(ALU1_SUB)


def run_chunk(t: Tables, st, chunk: int, fuel_on: bool) -> None:
    for _ in range(int(chunk)):
        live = (st.trap == 0).nonzero().squeeze(1)
        if live.numel() == 0:
            return
        _step(t, st, live, fuel_on)


def _step(t: Tables, st, lanes, fuel_on):
    code_len = t.hid.shape[0]
    pc = st.pc[lanes].clamp(0, code_len - 1)
    hid = t.hid[pc.long()]
    for h in torch.unique(hid).tolist():
        m = hid == h
        _Group(t, st, lanes[m], pc[m], fuel_on).run(int(h))


class _Group:
    """One handler applied to the lanes that sit at it this step."""

    def __init__(self, t, st, lanes, pc, fuel_on):
        self.t, self.st, self.lanes, self.pc = t, st, lanes, pc
        self.fuel_on = fuel_on
        self.D = st.stack_lo.shape[0]
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
        self.scat(self.st.stack_lo, rows, lo, mask)
        self.scat(self.st.stack_hi, rows, hi, mask)

    # -- dispatch ------------------------------------------------------------
    def run(self, h):
        if h >= H_ALU2_BASE and h < H_ALU1_BASE:
            self.alu2(h - H_ALU2_BASE)
        elif h >= H_ALU1_BASE and h < H_ALU1_BASE + _NUM_ALU1:
            self.alu1(h - H_ALU1_BASE)
        elif h in (H_LOAD, H_LOAD_W, H_LOAD_D):
            self.load()
        elif h in (H_STORE, H_STORE_W, H_STORE_D):
            self.store()
        else:
            handler = _BASE.get(h)
            if handler is None:
                raise ValueError(f"handler id {h} is not in this slice")
            handler(self)
        self.commit()

    def commit(self):
        st, lanes = self.st, self.lanes
        st.retired[lanes] += 1
        trap = self.trap
        if self.fuel_on:
            fuel = st.fuel[lanes] - 1
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
        lo, hi = self.cell(self.fp + self.a)
        self.put(self.sp, lo, hi)
        self.new_sp = self.sp + 1

    def local_set(self):
        lo, hi = self.cell(self.sp - 1)
        self.put(self.fp + self.a, lo, hi)
        self.new_sp = self.sp - 1

    def local_tee(self):
        lo, hi = self.cell(self.sp - 1)
        self.put(self.fp + self.a, lo, hi)

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
        v1_lo, v1_hi = self.cell(self.sp - 2)
        v2_lo, v2_hi = self.cell(self.sp - 3)
        z = c_lo == 0
        self.put(self.sp - 3, torch.where(z, v1_lo, v2_lo),
                 torch.where(z, v1_hi, v2_hi))
        self.new_sp = self.sp - 2

    # -- branches --------------------------------------------------------------
    def _keep_to(self, rows, lo, hi, keep):
        self.put(rows, lo, hi, keep == 1)

    def br(self):
        v_lo, v_hi = self.cell(self.sp - 1)
        self._keep_to(self.ob + self.c, v_lo, v_hi, self.b)
        self.new_sp = self.ob + self.c + self.b
        self.new_pc = self.a

    def brz(self):
        v_lo, _ = self.cell(self.sp - 1)
        self.new_sp = self.sp - 1
        self.new_pc = torch.where(v_lo == 0, self.a, self.pc + 1)

    def brnz(self):
        c_lo, _ = self.cell(self.sp - 1)
        v_lo, v_hi = self.cell(self.sp - 2)
        taken = c_lo != 0
        self.put(self.ob + self.c, v_lo, v_hi, taken & (self.b == 1))
        self.new_sp = torch.where(taken, self.ob + self.c + self.b,
                                  self.sp - 1)
        self.new_pc = torch.where(taken, self.a, self.pc + 1)

    def br_table(self):
        i_lo, _ = self.cell(self.sp - 1)
        v_lo, v_hi = self.cell(self.sp - 2)
        idx = torch.where(ops.u_lt(self.b, i_lo), self.b, i_lo)
        n = self.t.brt.shape[0] // 3
        e = (self.a + idx).clamp(0, n - 1).long() * 3
        tgt, keep, pop = self.t.brt[e], self.t.brt[e + 1], self.t.brt[e + 2]
        self.put(self.ob + pop, v_lo, v_hi, keep == 1)
        self.new_sp = self.ob + pop + keep
        self.new_pc = tgt

    # -- calls -----------------------------------------------------------------
    def ret(self):
        st = self.st
        nres = self.b
        v_lo, v_hi = self.cell(self.sp - 1)
        self.put(self.fp, v_lo, v_hi, nres == 1)
        done = self.cd == 0
        CD = st.fr_ret_pc.shape[0]
        rd = (self.cd - 1).clamp(0, CD - 1)
        self.new_pc = torch.where(done, self.pc, self.gat(st.fr_ret_pc, rd))
        self.new_fp = torch.where(done, self.fp, self.gat(st.fr_fp, rd))
        self.new_ob = torch.where(done, self.ob, self.gat(st.fr_opbase, rd))
        self.new_cd = torch.where(done, self.cd, self.cd - 1)
        self.new_sp = self.fp + nres
        self.trap = torch.where(done, torch.full_like(self.trap, TRAP_DONE),
                                self.trap)
        self.sp_on_halt = torch.where(done, self.fp + nres, self.sp)

    def call(self):
        nf = self.t.fent.shape[0]
        self._call(self.a.clamp(0, nf - 1), self.sp, None)

    def call_indirect(self):
        t = self.t
        nf = t.fent.shape[0]
        i_lo, _ = self.cell(self.sp - 1)
        size = self.b
        ti = self.c + i_lo.clamp(min=0).minimum((size - 1).clamp(min=0))
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
        self._call(callee, self.sp - 1, code)

    def _call(self, callee, sp_eff, code):
        t, st = self.t, self.st
        cl = callee.long()
        entry, npar, nloc, ftop = t.fent[cl], t.fnpar[cl], t.fnloc[cl], \
            t.ftop[cl]
        CD = st.fr_ret_pc.shape[0]
        fp_new = sp_eff - npar
        ob_new = fp_new + nloc
        if code is None:
            code = torch.zeros_like(self.trap)
        code = torch.where(self.cd >= CD - 1,
                           torch.full_like(code,
                                           int(ErrCode.CallStackExhausted)),
                           code)
        code = torch.where(fp_new + ftop > self.D,
                           torch.full_like(code, int(ErrCode.StackOverflow)),
                           code)
        ok = code == 0
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
        self.new_cd = self.cd + 1

    # -- memory ----------------------------------------------------------------
    def _ea(self, base):
        ea = ops.wrap32(base.to(torch.int64) + self.a.to(torch.int64))
        nbytes = self.b
        pages = self.st.mem_pages[self.lanes]
        mem_bytes = ops.wrap32(pages.to(torch.int64) * 65536)
        end = ops.wrap32(ea.to(torch.int64) + nbytes.to(torch.int64))
        carry = ops.u_lt(ea, base) | ops.u_lt(ea, self.a)
        oob = carry | ops.u_lt(end, ea) | ops.u_lt(mem_bytes, end)
        widx = (ops.u32(ea) >> 2).to(I32)
        sh = (ea & 3) * 8
        return ea, oob, widx, sh

    def _words(self, widx):
        mem = self.st.mem
        return [self.gat(mem, widx + k) for k in range(3)]

    def load(self):
        base, _ = self.cell(self.sp - 1)
        _, oob, widx, sh = self._ea(base)
        w0, w1, w2 = (ops.u32(w) for w in self._words(widx))
        sh64 = sh.to(torch.int64)
        raw_lo = ops.wrap32(ops.shr_u64(w0 | (w1 << 32), sh64))
        raw_hi = ops.wrap32(ops.shr_u64(w1 | (w2 << 32), sh64))
        nbytes, signed, is64 = self.b, (self.c & 1) != 0, (self.c & 2) != 0
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
        self.put(self.sp - 1, lo, hi, ~oob)
        self.trap = torch.where(
            oob, torch.full_like(self.trap, int(ErrCode.MemoryOutOfBounds)),
            self.trap)

    def store(self):
        v_lo, v_hi = self.cell(self.sp - 1)
        base, _ = self.cell(self.sp - 2)
        _, oob, widx, sh = self._ea(base)
        words = self._words(widx)
        nbytes = self.b
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
        ok = ~oob
        for k in range(3):
            mk = masks[k]
            new = (ops.u32(words[k]) & ~mk) | (vals[k] & mk)
            self.scat(self.st.mem, widx + k, ops.wrap32(new), ok & (mk != 0))
        self.new_sp = self.sp - 2
        self.trap = torch.where(
            oob, torch.full_like(self.trap, int(ErrCode.MemoryOutOfBounds)),
            self.trap)

    def memsize(self):
        pages = self.st.mem_pages[self.lanes]
        self.put(self.sp, pages, torch.zeros_like(pages))
        self.new_sp = self.sp + 1

    def memgrow(self):
        st = self.st
        delta, _ = self.cell(self.sp - 1)
        pages = st.mem_pages[self.lanes]
        new = ops.wrap32(pages.to(torch.int64) + delta.to(torch.int64))
        cap = torch.full_like(pages, self.t.mem_pages_max)
        ok = ~ops.u_lt(cap, new) & (delta >= 0) & (new >= pages)
        res = torch.where(ok, pages, torch.full_like(pages, -1))
        self.put(self.sp - 1, res, torch.zeros_like(res))
        st.mem_pages[self.lanes] = torch.where(ok, new, pages)

    def trap_op(self):
        self.trap = self.a.clone()

    # -- host calls and bulk memory --------------------------------------------
    def hostcall(self):
        # park at the stub; the host re-arms the lane at pc + 1
        self.trap = torch.full_like(self.trap, TRAP_HOSTCALL)

    def memfill(self):
        self._bulk(copy=False)

    def memcopy(self):
        self._bulk(copy=True)

    def _bulk(self, copy):
        """Operands (top of stack): n, then the fill value or copy source,
        then dst.  Unsigned bounds in exact int64 arithmetic."""
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
        go = ~oob & (n != 0)
        if bool(go.any()):
            _fill_copy(self.st.mem, self.lanes[go], dst[go], end[go],
                       val_or_src[go], copy)

    # -- ALU -------------------------------------------------------------------
    def alu2(self, sub):
        y_lo, y_hi = self.cell(self.sp - 1)
        x_lo, x_hi = self.cell(self.sp - 2)
        lo, hi = ops.alu2(sub, x_lo, x_hi, y_lo, y_hi)
        self.put(self.sp - 2, lo, hi)
        self.new_sp = self.sp - 1
        if ops.alu2_traps(sub):
            self.trap = ops.alu2_trap(sub, x_lo, x_hi, y_lo, y_hi)

    def alu1(self, sub):
        w_lo, w_hi = self.cell(self.sp - 1)
        lo, hi = ops.alu1(sub, w_lo, w_hi)
        if ops.alu1_traps(sub):
            self.trap = ops.alu1_trap(sub, w_lo, w_hi)
            if sub in _TRUNC_F32:
                # the reference's f32 truncation writes 0 when it traps
                lo = torch.where(self.trap != 0, torch.zeros_like(lo), lo)
        self.put(self.sp - 1, lo, hi)


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
}


_BYTE_MASKS = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)


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

