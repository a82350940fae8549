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
// and share pc, sp, fp, operand base, call depth, pages, fuel and (with a
// per-lane table) table size at the
// launch's start is "on": it runs the warp-leader loop (interp.cu
// dispatch_loop with kLead), where every decision (a branch condition's
// zeroness; a table index and the handle it reads from a lane's own
// table, a grow delta, a memory address, an ALU or table.get trap
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
//    rest of the launch (they run per lane on the plane), and at a tier-0
//    host call in the same way (a uniform warp's only at random_get), and
//    at an instruction that writes the table, its size, a dropped flag or
//    memory from a data segment (a uniform warp's never: its lanes write
//    alike), so no snapshot needs to hold those planes;
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
//
// Uniform warps.  The TPU needed the leader because a lane block runs one
// pc; an H100 lane has its own, and the hardware keeps a warp converged
// while its lanes compute the same thing.  A warp that is on, whole (32
// lanes) and whose lanes hold one state at the launch's start (the entry
// compare `warp_uniform`, lane against lane 0: stack rows [0, sp) of every
// stack plane, frame rows [0, cd), the globals and memory rows [0,
// min(W, pages x 16384)) of the plane and, with tier 0, every row of the
// call counts t0_ctr and the stdout buffer's fill so_off, with tables the
// table rows below the lane's size and every row of the segments' dropped
// flags; rows nothing reads are not compared, nor the stdout buffer, which
// Wasm never reads)
// runs the same instructions on the same values in every lane until the
// launch ends: lane identity is not visible to Wasm, a host call parks
// the launch, and the tier-0 calls that the kernel serves compute from
// those planes alone, but random_get, whose stream is seeded by the
// lane: there the warp commits and is off for the rest of the launch,
// as at a bulk op.  So lane 0's value is always the lane's own, no
// canary can be set and no rollback can happen.  Such a warp runs the
// careful loop of its kOpt build (`WarpUniform`, its `on` set): the
// careful decisions (no shuffle, no canary) with the leader's commit
// points and their effects (commits counted, the interval advanced, the
// dirty windows written back, a bulk op's commit turning the warp off,
// the exit's validation counted), and no snapshot.
// The shadow planes are then untouched scratch; the per-warp counts come
// out as the leader loop's would, and w_uniform counts these entries.

namespace {

constexpr int OPT_SNAP_STEPS = 131072;  // PallasUniformEngine.SNAP_STEPS (pallas_engine.py:3907)
constexpr int OPT_SNAP_MIN = 256;       // _SNAP_MIN (:238)
constexpr int OPT_FIRST = 512;          // the first interval, min(512, snap) (:3608-3611)
// A load or store whose window miss would write a dirty way back, or a
// bulk op, in a warp that is on: nothing done, the commit comes first.
constexpr int OPT_DEFER = -3;
// what a warp's loop returned for (os.pending): a commit, and then the
// instruction again (OPT_WAIT_BULK: in the careful loop)
constexpr int OPT_WAIT_ACCESS = 1;
constexpr int OPT_WAIT_BULK = 2;

// The warp's decisions.  Warp<false> (the loop of a build without kOpt):
// each value is the lane's own and nothing is compared.  Warp<true> (the
// warp-leader loop): each is lane 0's, and a lane whose own value differs
// sets its canary.  WarpUniform (the careful loop of a kOpt build): each
// is the lane's own; while `on_` (a uniform warp that is on) the loop
// stops at the leader's commit points.  kCommits: the loop may stop for a
// commit; kLead: decisions are lane 0's, with snapshots and rollbacks.
template <bool kOpt>
struct Warp {
  static constexpr bool kCommits = false;
  static constexpr bool kLead = false;
  __device__ __forceinline__ bool on() const { return false; }
  __device__ __forceinline__ u32 agree(u32 v) { return v; }
  __device__ __forceinline__ bool nz(u32 v) { return v != 0; }
};

template <>
struct Warp<true> {
  static constexpr bool kCommits = true;
  static constexpr bool kLead = true;
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

struct WarpUniform {
  static constexpr bool kCommits = true;
  static constexpr bool kLead = false;
  bool on_;
  __device__ __forceinline__ bool on() const { return on_; }
  __device__ __forceinline__ u32 agree(u32 v) { return v; }
  __device__ __forceinline__ bool nz(u32 v) { return v != 0; }
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
// which the next commit is due (periodic, or the step of a handler that
// asked for one), the interval, the clean checks, the kind of commit a
// handler asked for (OPT_WAIT_*), and whether the warp is still on,
// entered on at all and rolled back.
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

// A commit point of a warp that is on.  The leader's (Warp<true>): the
// canaries checked with one __any_sync; dirty: the lane is rolled back to
// the last snapshot, its step included, and the windows dropped; the
// warp is off.  Clean (a uniform warp's always is): with `leave` (the
// loop's end, a bulk op) the warp is off; otherwise the dirty windows go
// back to the plane, the leader takes a snapshot, and the next periodic
// commit is due.  Returns whether the warp is still on.
template <bool kSimd, bool kWin, class Wp>
__device__ __forceinline__ bool opt_commit(const Params& p,
                                           const Lane<kSimd>& s,
                                           Mem<kWin>& m, Wp& w, LaneRegs& r,
                                           OptRun& os, bool leave) {
  os.pending = 0;
  if constexpr (Wp::kLead) {
    if (w.dirty()) {
      const OptSnap& o = os.o;
      opt_restore<kSimd, kWin>(p, s, o);
      m.invalidate();
      r = LaneRegs{o.pc, o.sp, o.fp, o.ob, o.cd, o.retired, o.fuel, o.pages,
                   0, o.step};
      os.on = false;
      os.rolled = true;
      return false;
    }
  }
  ++os.commits;
  if (leave) {
    os.on = false;
    if constexpr (!Wp::kLead) w.on_ = false;
    return false;
  }
  m.commit(p, s.lane);
  if constexpr (Wp::kLead) {
    opt_save<kSimd, kWin>(p, s, r.sp, r.cd);
    os.o = OptSnap{r.pc, r.sp, r.fp, r.ob, r.cd, r.retired, r.fuel, r.pages,
                   r.step, r.cd};
    w.canary = 0;
  }
  os.due = opt_due(r.step, os.snapv);
  return true;
}

// The entry compares since they were last read and cleared: compares
// run and their clock cycles summed over warps.
__device__ unsigned long long g_entry_counts[2];

// Whether some lane of the warp (all 32 threads call it, at plane column
// wbase + threadIdx.x) differs from lane 0 in rows [0, n) of `plane`.
// With 16-byte rows of 4 lanes (L % 4 == 0) a thread loads a quad of a
// row, 8 threads a whole 128-byte row, ENTRY_ROWS quads per step in
// flight (4 x ENTRY_ROWS rows); else a word a thread, ENTRY_ROWS rows a
// step.  Lane 0's word of each row comes from the thread holding it by a
// shuffle; the pass stops after the first step that differs.  Out of
// line: it runs once at a launch's entry.
constexpr int ENTRY_ROWS = 16;

__device__ __noinline__ bool rows_differ(const i32* plane, int L, int wbase,
                                         int n) {
  const int t = threadIdx.x;
  if ((L & 3) == 0) {
    const int q = t & 7, j = t >> 3;  // lanes 4q..4q+3 of row r0 + 4k + j
    const i32* base = plane + wbase + 4 * q;
    for (int r0 = 0; r0 < n; r0 += 4 * ENTRY_ROWS) {
      int4 v[ENTRY_ROWS];
#pragma unroll
      for (int k = 0; k < ENTRY_ROWS; ++k) {
        const int r = r0 + 4 * k + j;
        v[k] = r < n ? *reinterpret_cast<const int4*>(base + (size_t)r * L)
                     : make_int4(0, 0, 0, 0);
      }
      u32 diff = 0;
#pragma unroll
      for (int k = 0; k < ENTRY_ROWS; ++k) {
        const i32 l0 = __shfl_sync(0xffffffffu, v[k].x, t & 24);
        const int r = r0 + 4 * k + j;
        if (r < n)
          diff |= (u32)((v[k].x ^ l0) | (v[k].y ^ l0) | (v[k].z ^ l0) |
                        (v[k].w ^ l0));
      }
      if (__any_sync(0xffffffffu, diff != 0)) return true;
    }
    return false;
  }
  const i32* col = plane + wbase + t;
  for (int r0 = 0; r0 < n; r0 += ENTRY_ROWS) {
    i32 v[ENTRY_ROWS];
#pragma unroll
    for (int k = 0; k < ENTRY_ROWS; ++k)
      v[k] = r0 + k < n ? col[(size_t)(r0 + k) * L] : 0;
    u32 diff = 0;
#pragma unroll
    for (int k = 0; k < ENTRY_ROWS; ++k)
      diff |= (u32)(v[k] ^ __shfl_sync(0xffffffffu, v[k], 0));
    if (__any_sync(0xffffffffu, diff != 0)) return true;
  }
  return false;
}

// The entry rule of a whole warp that is on (its lanes share sp, cd and
// pages): every lane equal to lane 0 in the stack rows below sp (every
// stack plane, in the [D, L] planes: the launch has not loaded its
// on-chip rows yet), the frame rows below the depth, the globals and the
// live memory rows.  Lane 0 adds the compare and its cycles to
// g_entry_counts.
template <bool kSimd>
__device__ __forceinline__ bool warp_uniform(const Params& p, int lane, int sp,
                                             int cd, int pages) {
  const long long t0 = clock64();
  const int wbase = lane - (int)threadIdx.x;
  const int ns = clampi(sp, 0, p.D), nf = clampi(cd, 0, p.CD);
  const int nm = p.W > 1 ? (int)min((long long)p.W, (long long)pages * 16384)
                         : 0;
  const i32* const planes[9] = {p.stack_lo,  p.stack_hi, p.stack_e2,
                                p.stack_e3,  p.fr_ret_pc, p.fr_fp,
                                p.fr_opbase, p.glob_lo,  p.glob_hi};
  const int rows[9] = {ns, ns, kSimd ? ns : 0, kSimd ? ns : 0, nf, nf, nf,
                       p.NG, p.NG};
  bool same = true;
  for (int k = 0; k < 9 && same; ++k)
    if (rows[k] > 0) same = !rows_differ(planes[k], p.L, wbase, rows[k]);
  if (same && nm > 0) same = !rows_differ(p.mem, p.L, wbase, nm);
  if constexpr (kTier0) {
    // the tier-0 call counts (every row) and the stdout buffer's fill:
    // what a clock or fd_write call reads besides memory
    if (same) same = !rows_differ(p.t0.ctr, p.L, wbase, 4);
    if (same && p.t0.so_off) same = !rows_differ(p.t0.so_off, p.L, wbase, 1);
  }
  if constexpr (kTables) {
    // the table rows below the lane's size (a warp that is on shares it;
    // rows at or above it are dead: table.grow writes every row it
    // exposes) and every segment's dropped flag: what a table or segment
    // instruction reads besides the stack
    if (same && p.a3.tab)
      same = !rows_differ(p.a3.tab, p.L, wbase,
                          clampi(p.a3.tsize[lane], 0, p.a3.tcap));
    if (same && p.a3.edrop) same = !rows_differ(p.a3.edrop, p.L, wbase, p.a3.n_elem);
    if (same && p.a3.ddrop) same = !rows_differ(p.a3.ddrop, p.L, wbase, p.a3.n_data);
  }
  if (threadIdx.x == 0) {
    atomicAdd(&g_entry_counts[0], 1ull);
    atomicAdd(&g_entry_counts[1], (unsigned long long)(clock64() - t0));
  }
  return same;
}

}  // namespace
