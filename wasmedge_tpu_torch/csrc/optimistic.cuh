// Optimistic convergence (B3) for the warp-interpreter (sm_90a).
//
// Replaces the optimistic mode of wasmedge_tpu/batch/pallas_engine.py
// `_build_kernel(..., optimistic=True)`: the lane-0 decisions `agree_i32`,
// `agree_nz` and `opt_addr_prolog` (:964-995), `do_snapshot`,
// `do_restore` and `rolled_carry` (:996-1064), `_opt_bulk_exit`
// (:1065-1080), the commit before a dirty window write-back (:1895-1935),
// the periodic commit (:3599-3651) and the exit validation (:3669-3680),
// and its host half, the careful re-run of a rolled-back block
// (`careful_recheck`, :4397-4437) and the adaptive interval (`_drive`,
// :4360-4395).  batch/optimistic.py is the plain version.
//
// The Pallas kernel's unit is the lane block, which runs one instruction
// stream; here it is the warp.  A warp whose present lanes are all live
// and share pc, sp, fp, operand base, call depth, pages and fuel at the
// launch's start is "on": it runs the warp-leader loop (interp.cu
// dispatch_loop with kLead), where every decision (a branch condition's
// zeroness; a table index, a grow delta, a memory address, an ALU trap
// kind and the frame row a return goes back through exactly: the entry
// compares no frame row) is lane 0's, taken with one __shfl_sync, and a
// lane whose own value differs ORs the difference into its canary
// register and follows lane 0.  So the warp never diverges while it is
// on, and a lane stops only where lane 0 stops.
//
// At each commit point the warp checks the canaries with one __any_sync:
//  - every `snap` dispatches (the first interval of a launch is
//    min(512, snap));
//  - before a window miss would write a dirty way back (memwin.cuh), so
//    the plane only ever holds validated words;
//  - at memory.fill / memory.copy, after which the warp is off for the
//    rest of the launch (they run per lane on the plane);
//  - when the loop ends (chunk end, trap, fuel, done, the host-call park).
// A clean check writes both dirty ways back and snapshots (below); a
// dirty one restores the snapshot, drops the windows, halves the warp's
// interval (down to 256), counts a rollback and re-runs the rest of the
// launch from the snapshot's step in the careful per-lane loop of the same
// kernel, where the TPU needed a second, careful kernel.  After every
// launch each lane's state equals the careful kernel's after the same
// launch, except stack rows at or above sp that lane 0's wrong path wrote
// (dead rows, as the fused blocks already leave).  A launch without a
// rollback doubles a shrunken interval back toward 131072.
//
// A snapshot copies, per lane, the stack rows below sp (lo and hi, and e2,
// e3 under kSimd; from shared memory below R, interp.cu `Lane`, and a
// restore writes them back there), the frame rows below the call depth,
// the globals and,
// when memory runs without windows, the whole memory column (JAX's
// `sh_mem`), into shadow planes [rows, L] in global memory, and the
// control registers and the step count into registers of the thread.  A
// frame row at or above the snapshot's depth is saved on its first write
// (a call), so a rollback leaves the frames exactly as they were.  What
// bounds it is bytes: a commit moves the rows it copies twice; between
// commits a decision costs one shuffle where the careful loop compares
// nothing.

namespace {

constexpr int OPT_SNAP_STEPS = 131072;  // PallasUniformEngine.SNAP_STEPS (pallas_engine.py:3907)
constexpr int OPT_SNAP_MIN = 256;       // _SNAP_MIN (:238)
constexpr int OPT_FIRST = 512;          // the first interval, min(512, snap) (:3608-3611)
// A load or store whose window miss would write a dirty way back, or a
// bulk op, in a warp that is on: nothing done, the commit comes first.
constexpr int OPT_DEFER = -3;
// what a warp waits for at the top of its next iteration: a commit, and
// then the instruction again (OPT_WAIT_BULK: in the careful loop)
constexpr int OPT_WAIT_ACCESS = 1;
constexpr int OPT_WAIT_BULK = 2;

// The warp's decisions.  Warp<false> (the careful loop): each value is the
// lane's own and nothing is compared.  Warp<true> (the warp-leader loop):
// each is lane 0's, and a lane whose own value differs sets its canary.
template <bool kOpt>
struct Warp {
  __device__ __forceinline__ bool on() const { return false; }
  __device__ __forceinline__ u32 agree(u32 v) { return v; }
  __device__ __forceinline__ bool nz(u32 v) { return v != 0; }
};

template <>
struct Warp<true> {
  unsigned mask;  // the present lanes (lane < L) of the warp
  u32 canary;     // nonzero: this lane disagreed since the last commit

  __device__ __forceinline__ bool on() const { return true; }
  // an exact decision: lane 0's value
  __device__ __forceinline__ u32 agree(u32 v) {
    const u32 l = __shfl_sync(mask, v, 0);
    canary |= v ^ l;
    return l;
  }
  // a condition: lane 0's zeroness
  __device__ __forceinline__ bool nz(u32 v) {
    const bool l = __shfl_sync(mask, v, 0) != 0;
    canary |= (u32)((v != 0) != l);
    return l;
  }
  __device__ __forceinline__ bool dirty() const {
    return __any_sync(mask, canary != 0);
  }
};

// ALU subs whose trap kind is a decision (the others never trap):
// div_s/div_u/rem_s/rem_u of i32 and i64, the non-saturating truncations.
__device__ __forceinline__ bool alu2_traps(int sub) {
  return (unsigned)(sub - 3) <= 3u || (unsigned)(sub - 28) <= 3u;
}
__device__ __forceinline__ bool alu1_traps(int sub) {
  return sub == 23 || sub == 24 || (unsigned)(sub - 49) <= 5u;
}

// A lane's loop registers: control state, trap and the launch's step.
struct LaneRegs {
  int pc, sp, fp, ob, cd, retired, fuel, pages, trap, step;
};

// The control registers of the last snapshot and its step count; `fhi`:
// frame rows [0, fhi) are in the shadow planes.
struct OptSnap {
  int pc, sp, fp, ob, cd, retired, fuel, pages, step, fhi;
};

// A warp's optimistic run in one launch: the last snapshot, the step at
// which the next periodic commit is due, the interval, the clean checks,
// a commit a handler asked for (OPT_WAIT_*), and whether the warp is
// still on, entered on at all and rolled back.
struct OptRun {
  OptSnap o;
  int snapv, due, commits, pending;
  bool on, entered, rolled;
};

// The step at which the periodic commit after a snapshot at `step` is
// due: the first interval of a launch is min(512, snap).
__device__ __forceinline__ int opt_due(int step, int snapv) {
  return step + (step == 0 ? min(OPT_FIRST, snapv) : snapv);
}

// do_snapshot: the lane's planes into the shadow planes (the windows
// have been written back: the plane is the snapshot's memory); its stack
// rows from where they live (Lane: on chip below R, the plane above).
template <bool kSimd, bool kWin>
__device__ __forceinline__ void opt_save(const Params& p,
                                         const Lane<kSimd>& s, int sp,
                                         int cd) {
  const int ns = clampi(sp, 0, p.D), nf = clampi(cd, 0, p.CD);
  const int lane = s.lane, L = p.L;
  i32* const sh[4] = {p.sh_lo, p.sh_hi, p.sh_e2, p.sh_e3};
  s.snap(sh, ns, false);
  copy_rows(p.sh_fr_ret_pc + lane, L, p.fr_ret_pc + lane, L, nf);
  copy_rows(p.sh_fr_fp + lane, L, p.fr_fp + lane, L, nf);
  copy_rows(p.sh_fr_opbase + lane, L, p.fr_opbase + lane, L, nf);
  copy_rows(p.sh_glo + lane, L, p.glob_lo + lane, L, p.NG);
  copy_rows(p.sh_ghi + lane, L, p.glob_hi + lane, L, p.NG);
  if (!kWin && p.W > 1) copy_rows(p.sh_mem + lane, L, p.mem + lane, L, p.W);
}

// Before a call writes frame row cd in a warp that is on: a row at or
// above the snapshot's depth goes to the shadow first (rows are written
// one depth at a time, so cd == fhi there).
__device__ __forceinline__ void opt_save_frame(const Params& p, int lane,
                                               int cd, int& fhi) {
  if (cd < fhi || cd >= p.CD) return;
  const size_t i = (size_t)cd * p.L + lane;
  const i32 r = p.fr_ret_pc[i], f = p.fr_fp[i], o = p.fr_opbase[i];
  p.sh_fr_ret_pc[i] = r;
  p.sh_fr_fp[i] = f;
  p.sh_fr_opbase[i] = o;
  fhi = cd + 1;
}

// do_restore: the inverse of opt_save; stack rows at or above the
// snapshot's sp keep what the wrong path wrote (dead rows).
template <bool kSimd, bool kWin>
__device__ __forceinline__ void opt_restore(const Params& p,
                                            const Lane<kSimd>& s,
                                            const OptSnap& o) {
  const int ns = clampi(o.sp, 0, p.D), nf = clampi(o.fhi, 0, p.CD);
  const int lane = s.lane, L = p.L;
  i32* const sh[4] = {p.sh_lo, p.sh_hi, p.sh_e2, p.sh_e3};
  s.snap(sh, ns, true);
  copy_rows(p.fr_ret_pc + lane, L, p.sh_fr_ret_pc + lane, L, nf);
  copy_rows(p.fr_fp + lane, L, p.sh_fr_fp + lane, L, nf);
  copy_rows(p.fr_opbase + lane, L, p.sh_fr_opbase + lane, L, nf);
  copy_rows(p.glob_lo + lane, L, p.sh_glo + lane, L, p.NG);
  copy_rows(p.glob_hi + lane, L, p.sh_ghi + lane, L, p.NG);
  if (!kWin && p.W > 1) copy_rows(p.mem + lane, L, p.sh_mem + lane, L, p.W);
}

// A commit point of a warp that is on: the canaries checked with one
// __any_sync.  Dirty: the lane is rolled back to the last snapshot, its
// step included, and the windows dropped; the warp is off.  Clean: with
// `leave` (the loop's end, a bulk op) the warp is off; otherwise the dirty
// windows go back to the plane and a snapshot is taken.  Returns whether
// the warp is still on.
template <bool kSimd, bool kWin>
__device__ __forceinline__ bool opt_commit(const Params& p,
                                           const Lane<kSimd>& s,
                                           Mem<kWin>& m, Warp<true>& w,
                                           LaneRegs& r, OptRun& os,
                                           bool leave) {
  os.pending = 0;
  if (w.dirty()) {
    const OptSnap& o = os.o;
    opt_restore<kSimd, kWin>(p, s, o);
    m.invalidate();
    r = LaneRegs{o.pc, o.sp, o.fp, o.ob, o.cd, o.retired, o.fuel, o.pages, 0,
                 o.step};
    os.on = false;
    os.rolled = true;
    return false;
  }
  ++os.commits;
  if (leave) {
    os.on = false;
    return false;
  }
  m.commit(p, s.lane);
  opt_save<kSimd, kWin>(p, s, r.sp, r.cd);
  os.o = OptSnap{r.pc, r.sp, r.fp, r.ob, r.cd, r.retired, r.fuel, r.pages,
                 r.step, r.cd};
  os.due = opt_due(r.step, os.snapv);
  w.canary = 0;
  return true;
}

}  // namespace
