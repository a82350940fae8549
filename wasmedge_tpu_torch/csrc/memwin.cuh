// Memory window cache (B4) for the warp-interpreter (sm_90a).
//
// Replaces the HBM memory mode of wasmedge_tpu/batch/pallas_engine.py
// (:1752-2470): the memory plane stays in HBM and each lane block keeps
// two windows of CW = HBM_WINDOW_ROWS rows in VMEM (`_win_select` :1779,
// `_win_flush` :1834, `win_read_row` / `win_write_row` :1849-1862, the
// hbm `h_load` :2089 and `h_store` :2160, the launch init :3656-3660 and
// the exit commit :3683-3693).  batch/memwin.py is the plain version.
//
// Here every thread (one Wasm lane) owns two ways of CW words of its own
// memory column in the block's dynamic shared memory, laid out
// [way][row][threadIdx.x]: a thread's words all sit in its own bank, so
// the lanes of a warp touch 32 distinct banks whatever rows they use,
// converged or not.  The way bases, dirty bits and the most recently used
// way (wb0, wd0, wb1, wd1, mru) live in registers, as the Pallas kernel
// keeps them in its loop carry (:940-950).  The rules are the JAX ones: a
// window is based at align8(rlo) clipped to [0, W - CW]; a miss replaces
// the least recently used way, written back first when dirty; at most one
// way holds any plane row, so an incoming window that overlaps the other
// way writes that way back (when dirty) and invalidates it before the fill
// reads the plane.  A fill moves CW words of the lane's column; in a
// converged warp the 32 lanes' loads of one row coalesce into one
// 128-byte access.  Windows start invalid at every launch and both ways
// are written back on every way out of the lane's loop (chunk end, trap,
// fuel, done and the host-call park, whose serve round reads the plane);
// memory.fill / memory.copy write them back and invalidate them first,
// then run on the plane.
//
// The Pallas kernel chooses a window for the whole lane block, so lanes
// whose rows differ need its compare-reduce gather (`_win_gather` :1863)
// and, beyond one window, a hand-off to the SIMT engine.  A per-lane
// window needs no agreement between lanes: both map to nothing here.
// An access touches at most five rows (v128, unaligned), which always
// fit one window: rhi - align8(rlo) <= 11 < CW.
//
// Optimistic convergence (B3, optimistic.cuh) keeps the plane validated:
// in a warp that is on, a miss that would write a dirty way back is a
// commit point (`dirty_miss`; the miss is warp-uniform there, so the check
// sits in the caller, not in win_move), a clean commit writes both dirty
// ways back and keeps them valid (`commit`), and a rollback drops the
// windows (`invalidate`), whose words were never validated.

namespace {

constexpr int WIN_ROWS = 128;     // CW (batch/memwin.py HBM_WINDOW_ROWS)
constexpr int WIN_SENT = -(1 << 30);  // the base of an invalid way
constexpr int WIN_SMEM_BYTES = 2 * WIN_ROWS * BLOCK_THREADS * 4;

// Write way w (this thread's column, stride BLOCK_THREADS) back to plane
// rows [back, back + CW) unless back is WIN_SENT, then fill it from rows
// [fill, fill + CW) unless fill is WIN_SENT.  Out of line: a miss is rare,
// and the dispatch loop keeps its registers.
__device__ __noinline__ void win_move(i32* mem, int L, int lane, i32* w,
                                      int back, int fill) {
  constexpr int kGroup = 16;  // loads in flight per thread
  if (back != WIN_SENT) {
    i32* dst = mem + (size_t)back * L + lane;
#pragma unroll 8
    for (int r = 0; r < WIN_ROWS; ++r)
      dst[(size_t)r * L] = w[r * BLOCK_THREADS];
  }
  if (fill != WIN_SENT) {
    const i32* src = mem + (size_t)fill * L + lane;
    for (int r0 = 0; r0 < WIN_ROWS; r0 += kGroup) {
      i32 v[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) v[k] = src[(size_t)(r0 + k) * L];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) w[(r0 + k) * BLOCK_THREADS] = v[k];
    }
  }
}

// One lane's access to its memory column: rows given already clamped
// into the plane, [rlo, rhi] selected before they are read or written.
// Mem<false> reads and writes the plane directly (no state); Mem<true>
// goes through the lane's two windows.
template <bool kWin>
struct Mem {
  __device__ __forceinline__ explicit Mem(i32*) {}
  __device__ __forceinline__ void select(const Params&, int, int, int) {}
  __device__ __forceinline__ u32 get(const Params& p, int lane, int r) const {
    return (u32)p.mem[(size_t)r * (size_t)p.L + (size_t)lane];
  }
  __device__ __forceinline__ void put(const Params& p, int lane, int r,
                                      u32 v) {
    p.mem[(size_t)r * (size_t)p.L + (size_t)lane] = (i32)v;
  }
  __device__ __forceinline__ void flush(const Params&, int) {}
  __device__ __forceinline__ bool dirty_miss(const Params&, int, int) const {
    return false;
  }
  __device__ __forceinline__ void commit(const Params&, int) {}
  __device__ __forceinline__ void invalidate() {}
};

template <>
struct Mem<true> {
  i32* win;  // word (way, row) of this thread at win[(way * CW + row) * 32]
  int wb0, wd0, wb1, wd1, mru;

  __device__ __forceinline__ explicit Mem(i32* smem)
      : win(smem + threadIdx.x), wb0(WIN_SENT), wd0(0), wb1(WIN_SENT),
        wd1(0), mru(0) {}

  // _win_select: make rows [rlo, rhi] resident in one way, which becomes
  // the most recently used
  __device__ __forceinline__ void select(const Params& p, int lane, int rlo,
                                         int rhi) {
    if (rlo >= wb0 && rhi < wb0 + WIN_ROWS) {
      mru = 0;
      return;
    }
    if (rlo >= wb1 && rhi < wb1 + WIN_ROWS) {
      mru = 1;
      return;
    }
    const int nb = clampi(rlo & ~7, 0, p.W - WIN_ROWS);
    if (mru == 0) {  // way 1 is the victim
      if (wb0 < nb + WIN_ROWS && nb < wb0 + WIN_ROWS) {
        if (wd0) win_move(p.mem, p.L, lane, win, wb0, WIN_SENT);
        wb0 = WIN_SENT;
        wd0 = 0;
      }
      win_move(p.mem, p.L, lane, win + WIN_ROWS * BLOCK_THREADS,
               wd1 ? wb1 : WIN_SENT, nb);
      wb1 = nb;
      wd1 = 0;
      mru = 1;
    } else {  // way 0 is the victim
      if (wb1 < nb + WIN_ROWS && nb < wb1 + WIN_ROWS) {
        if (wd1)
          win_move(p.mem, p.L, lane, win + WIN_ROWS * BLOCK_THREADS, wb1,
                   WIN_SENT);
        wb1 = WIN_SENT;
        wd1 = 0;
      }
      win_move(p.mem, p.L, lane, win, wd0 ? wb0 : WIN_SENT, nb);
      wb0 = nb;
      wd0 = 0;
      mru = 0;
    }
  }
  // win_read_row / win_write_row of the selected (most recent) way
  __device__ __forceinline__ u32 get(const Params&, int, int r) const {
    return (u32)win[(mru ? WIN_ROWS + r - wb1 : r - wb0) * BLOCK_THREADS];
  }
  __device__ __forceinline__ void put(const Params&, int, int r, u32 v) {
    if (mru) {
      win[(WIN_ROWS + r - wb1) * BLOCK_THREADS] = (i32)v;
      wd1 = 1;
    } else {
      win[(r - wb0) * BLOCK_THREADS] = (i32)v;
      wd0 = 1;
    }
  }
  // _win_flush: both dirty ways back to the plane, both invalid
  __device__ __forceinline__ void flush(const Params& p, int lane) {
    if (wd0) win_move(p.mem, p.L, lane, win, wb0, WIN_SENT);
    if (wd1)
      win_move(p.mem, p.L, lane, win + WIN_ROWS * BLOCK_THREADS, wb1, WIN_SENT);
    wb0 = wb1 = WIN_SENT;
    wd0 = wd1 = mru = 0;
  }
  // whether select(rlo, rhi) would write a dirty way back: the victim, or
  // the other way under the overlap rule (pallas_engine.py :1905-1922)
  __device__ __forceinline__ bool dirty_miss(const Params& p, int rlo,
                                             int rhi) const {
    if (rlo >= wb0 && rhi < wb0 + WIN_ROWS) return false;
    if (rlo >= wb1 && rhi < wb1 + WIN_ROWS) return false;
    const int nb = clampi(rlo & ~7, 0, p.W - WIN_ROWS);
    if (mru == 0)  // way 1 is the victim
      return wd1 || (wd0 && wb0 < nb + WIN_ROWS && nb < wb0 + WIN_ROWS);
    return wd0 || (wd1 && wb1 < nb + WIN_ROWS && nb < wb1 + WIN_ROWS);
  }
  // a commit: both dirty ways back to the plane, kept valid and clean
  __device__ __forceinline__ void commit(const Params& p, int lane) {
    if (wd0) win_move(p.mem, p.L, lane, win, wb0, WIN_SENT);
    if (wd1)
      win_move(p.mem, p.L, lane, win + WIN_ROWS * BLOCK_THREADS, wb1, WIN_SENT);
    wd0 = wd1 = 0;
  }
  // a rollback: both ways invalid, their words dropped
  __device__ __forceinline__ void invalidate() {
    wb0 = wb1 = WIN_SENT;
    wd0 = wd1 = mru = 0;
  }
};

}  // namespace
