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
// converged or not.  The way bases and, in one register, the ways' dirty
// and full flags and the most recently used way (wb0, wb1, fl) live in
// registers, as the Pallas kernel keeps them in its loop carry
// (:940-950).  The rules are the JAX ones: a window is based at
// align8(rlo) clipped to [0, W - CW]; a miss replaces the least recently
// used way, written back first when dirty; at most one way holds any
// plane row, so an incoming window that overlaps the other way writes
// that way back (when dirty) and invalidates it.  Windows start invalid
// at every launch and both ways are written back on every way out of the
// lane's loop (chunk end, trap, fuel, done and the host-call park, whose
// serve round reads the plane); memory.fill / memory.copy write them back
// and invalidate them first, then run on the plane.
//
// Rows, not ways, are what moves.  Each way has CW valid and CW dirty
// bits per lane (static shared memory beside the ways, WIN_BITS words of
// each, [way][kind][word][threadIdx.x]; the word a run of stores is
// setting bits in waits in a register, `dword` / `dbits`, and goes to
// shared memory before any bit is read); a row is valid when either of
// its bits is set, or when the way's full flag is.  A miss moves no row
// in: it writes the victim's dirty rows back and clears its bits.  A
// store of a whole word to a row that is not valid writes it and sets
// its dirty bit, with no fill; a partial store (store8, store16, the
// ends of an unaligned or v128 access) fills that one row first; a load
// whose rows are not all valid fills every row of the way that is not,
// as one batch of cp.async (4 bytes a row, each thread its own column:
// in a converged warp the 32 lanes' copies of one row coalesce into one
// 128-byte access), then waits once, and the way is full.  A write-back
// stores the dirty rows only.  A way is dirty (its flag, for the LRU and
// for `dirty_miss`) when any of its rows is.  What bounds B4 is bytes: the
// rows it moves, which the counters below report.
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
// sits in the caller, not in the miss), a clean commit writes both dirty
// ways back and keeps their rows valid (`commit`), and a rollback drops
// the windows (`invalidate`), whose words were never validated.
//
// Counts, per lane, added once at the loop's exit to g_win_counts (read
// by interp.py `window_counts`): hits in a register, and on the paths of
// a miss, in shared memory beside the row bits, misses, ways written
// back, the rows they stored and rows filled.

namespace {

constexpr int WIN_ROWS = 128;     // CW (batch/memwin.py HBM_WINDOW_ROWS)
constexpr int WIN_SENT = -(1 << 30);  // the base of an invalid way
constexpr int WIN_SMEM_BYTES = 2 * WIN_ROWS * BLOCK_THREADS * 4;
constexpr int WIN_BITS = WIN_ROWS / 32;  // bit words per way and kind

// The ways' valid and dirty bits, word j of kind k (0 valid, 1 dirty) of
// way w of thread t at win_meta[(w * 2 + k) * WIN_BITS + j][t], then the
// thread's counts of a miss's paths at win_meta[WIN_META_BITS + c][t]
// (c: misses, ways written back, rows they stored, rows filled).
constexpr int WIN_META_BITS = 2 * 2 * WIN_BITS;
__shared__ u32 win_meta[WIN_META_BITS + 4][BLOCK_THREADS];

// The window counts since they were last read and cleared: hits, misses,
// ways written back, rows they stored, rows filled.
__device__ unsigned long long g_win_counts[5];

// One 4-byte asynchronous copy from global to shared memory, and the
// wait for every copy this thread issued.
__device__ __forceinline__ void cp_async4(i32* dst, const i32* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The dirty rows of way w (this thread's column, stride BLOCK_THREADS;
// b its bit words) back to plane rows [base, base + CW), their dirty bits
// cleared and, with `keep`, set as valid bits.  Returns the rows stored.
// Out of line: a write-back is rare, and the dispatch loop keeps its
// registers.
__device__ __noinline__ int win_back(i32* mem, int L, int lane, const i32* w,
                                     u32* b, int base, bool keep) {
  i32* dst = mem + (size_t)base * L + lane;
  int n = 0;
  for (int j = 0; j < WIN_BITS; ++j) {
    u32* dw = b + (WIN_BITS + j) * BLOCK_THREADS;
    const u32 d = *dw;
    if (d == 0u) continue;
    n += __popc(d);
    const int r0 = j * 32;
    if (d == 0xFFFFFFFFu) {
#pragma unroll 8
      for (int k = 0; k < 32; ++k)
        dst[(size_t)(r0 + k) * L] = w[(r0 + k) * BLOCK_THREADS];
    } else {
      for (u32 m = d; m != 0u; m &= m - 1u) {
        const int r = r0 + __ffs(m) - 1;
        dst[(size_t)r * L] = w[r * BLOCK_THREADS];
      }
    }
    *dw = 0u;
    if (keep) b[j * BLOCK_THREADS] |= d;
  }
  return n;
}

// A way gets a new base: its dirty rows back first when `dirty`, then
// every bit cleared.  Returns the rows stored.
__device__ __noinline__ int win_evict(i32* mem, int L, int lane,
                                      const i32* w, u32* b, int base,
                                      bool dirty) {
  const int n = dirty ? win_back(mem, L, lane, w, b, base, false) : 0;
#pragma unroll
  for (int j = 0; j < 2 * WIN_BITS; ++j) b[j * BLOCK_THREADS] = 0u;
  return n;
}

// Every row of way w that is not valid from plane rows [base, base + CW),
// as cp.async copies, then one wait.  Returns the rows filled.
__device__ __noinline__ int win_fill(const i32* mem, int L, int lane, i32* w,
                                     const u32* b, int base) {
  const i32* src = mem + (size_t)base * L + lane;
  int n = 0;
  for (int j = 0; j < WIN_BITS; ++j) {
    const u32 need = ~(b[j * BLOCK_THREADS] |
                       b[(WIN_BITS + j) * BLOCK_THREADS]);
    n += __popc(need);
    const int r0 = j * 32;
    if (need == 0xFFFFFFFFu) {
#pragma unroll
      for (int k = 0; k < 32; ++k)
        cp_async4(w + (r0 + k) * BLOCK_THREADS, src + (size_t)(r0 + k) * L);
    } else {
      for (u32 m = need; m != 0u; m &= m - 1u) {
        const int r = r0 + __ffs(m) - 1;
        cp_async4(w + r * BLOCK_THREADS, src + (size_t)r * L);
      }
    }
  }
  cp_async_wait_all();
  return n;
}

// One lane's access to its memory column: rows given already clamped
// into the plane, [rlo, rhi] selected before they are read or written,
// and made readable before a load reads them.  Mem<false> reads and
// writes the plane directly (no state); Mem<true> goes through the lane's
// two windows.
template <bool kWin>
struct Mem {
  __device__ __forceinline__ explicit Mem(i32*) {}
  __device__ __forceinline__ void select(const Params&, int, int, int) {}
  __device__ __forceinline__ void readable(const Params&, int, int, int) {}
  __device__ __forceinline__ u32 get(const Params& p, int lane, int r) const {
    return (u32)p.mem[(size_t)r * (size_t)p.L + (size_t)lane];
  }
  // a whole word
  __device__ __forceinline__ void put(const Params& p, int lane, int r,
                                      u32 v) {
    p.mem[(size_t)r * (size_t)p.L + (size_t)lane] = (i32)v;
  }
  // the bytes of `mask`
  __device__ __forceinline__ void merge(const Params& p, int lane, int r,
                                        u32 v, u32 mask) {
    put(p, lane, r, (get(p, lane, r) & ~mask) | (v & mask));
  }
  __device__ __forceinline__ void flush(const Params&, int) {}
  __device__ __forceinline__ bool dirty_miss(const Params&, int, int) const {
    return false;
  }
  __device__ __forceinline__ void commit(const Params&, int) {}
  __device__ __forceinline__ void invalidate() {}
  __device__ __forceinline__ void count() const {}
};

template <>
struct Mem<true> {
  i32* win;  // word (way, row) of this thread at win[(way * CW + row) * 32]
  u32* bits;  // bit word (way, kind, j) at bits[((way * 2 + kind) * 4 + j) * 32]
  int wb0, wb1;
  // flags, one register: bit 0 the most recently used way, bit 1 + w way
  // w has a dirty row, bit 3 + w every row of way w is valid
  int fl;
  // dirty bits not yet in shared memory: bit word `dword` (an index into
  // `bits`, -1 none) gets `dbits`; a store sweep sets them in a register
  // and stores a word of them once, not a read-modify-write a store
  int dword;
  u32 dbits;
  int hits;

  __device__ __forceinline__ explicit Mem(i32* smem)
      : win(smem + threadIdx.x), bits(&win_meta[0][0] + threadIdx.x),
        wb0(WIN_SENT), wb1(WIN_SENT), fl(0), dword(-1), dbits(0u),
        hits(0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) bits[(WIN_META_BITS + c) * BLOCK_THREADS] = 0u;
  }

  __device__ __forceinline__ int mru() const { return fl & 1; }
  __device__ __forceinline__ bool dirty(int w) const {
    return (fl >> (1 + w)) & 1;
  }
  __device__ __forceinline__ bool full(int w) const {
    return (fl >> (3 + w)) & 1;
  }
  __device__ __forceinline__ int base(int w) const { return w ? wb1 : wb0; }

  // count c of a miss's paths (misses, ways written back, rows stored,
  // rows filled) += n
  __device__ __forceinline__ void add(int c, int n) const {
    bits[(WIN_META_BITS + c) * BLOCK_THREADS] += (u32)n;
  }

  __device__ __forceinline__ i32* way(int w) const {
    return win + w * WIN_ROWS * BLOCK_THREADS;
  }
  __device__ __forceinline__ u32* way_bits(int w) const {
    return bits + w * 2 * WIN_BITS * BLOCK_THREADS;
  }
  // the pending dirty bits into shared memory, before any bit is read
  __device__ __forceinline__ void sync_bits() {
    if (dword >= 0) {
      bits[dword * BLOCK_THREADS] |= dbits;
      dword = -1;
    }
  }
  // the dirty way w's rows back (keep: they stay valid)
  __device__ __forceinline__ void back(const Params& p, int lane, int w,
                                       bool keep) {
    sync_bits();
    add(1, 1);
    add(2, win_back(p.mem, p.L, lane, way(w), way_bits(w), base(w), keep));
  }
  // way w invalid: not dirty, not full
  __device__ __forceinline__ void drop(int w) {
    if (w)
      wb1 = WIN_SENT;
    else
      wb0 = WIN_SENT;
    fl &= ~(10 << w);
  }
  // way w based at nb, its rows not valid (the dirty ones back first)
  __device__ __forceinline__ void rebase(const Params& p, int lane, int w,
                                         int nb) {
    sync_bits();
    add(1, dirty(w));
    add(2, win_evict(p.mem, p.L, lane, way(w), way_bits(w), base(w),
                     dirty(w)));
    drop(w);
    if (w)
      wb1 = nb;
    else
      wb0 = nb;
  }

  // _win_select: make rows [rlo, rhi] resident in one way, which becomes
  // the most recently used; a miss moves no row in
  __device__ __forceinline__ void select(const Params& p, int lane, int rlo,
                                         int rhi) {
    if (rlo >= wb0 && rhi < wb0 + WIN_ROWS) {
      fl &= ~1;
      ++hits;
      return;
    }
    if (rlo >= wb1 && rhi < wb1 + WIN_ROWS) {
      fl |= 1;
      ++hits;
      return;
    }
    add(0, 1);
    const int nb = clampi(rlo & ~7, 0, p.W - WIN_ROWS);
    const int v = 1 - mru();  // the victim; the other way is o
    const int o = mru();
    if (base(o) < nb + WIN_ROWS && nb < base(o) + WIN_ROWS) {
      if (dirty(o)) back(p, lane, o, false);
      drop(o);
    }
    rebase(p, lane, v, nb);
    fl = (fl & ~1) | v;
  }
  // the selected way's rows [rlo, rhi] valid before a load reads them:
  // unless the way is full or they are, every row of it that is not
  // valid is filled
  __device__ __forceinline__ void readable(const Params& p, int lane, int rlo,
                                           int rhi) {
    const int w = mru();
    if (full(w)) return;
    sync_bits();
    const u32* b = way_bits(w);
    bool ok = true;
    for (int r = rlo - base(w); r <= rhi - base(w); ++r) {
      const int j = (r >> 5) * BLOCK_THREADS;
      ok = ok && (((b[j] | b[WIN_BITS * BLOCK_THREADS + j]) >> (r & 31)) & 1u);
    }
    if (ok) return;
    add(3, win_fill(p.mem, p.L, lane, way(w), b, base(w)));
    fl |= 8 << w;
  }
  // win_read_row of the selected (most recent) way
  __device__ __forceinline__ u32 get(const Params&, int, int r) const {
    return (u32)win[(mru() ? WIN_ROWS + r - wb1 : r - wb0) * BLOCK_THREADS];
  }
  // win_write_row of a whole word: the row valid and dirty, no fill
  __device__ __forceinline__ void put(const Params&, int, int r, u32 v) {
    const int w = mru();
    const int o = r - base(w);
    win[(w * WIN_ROWS + o) * BLOCK_THREADS] = (i32)v;
    const int k = (w * 2 + 1) * WIN_BITS + (o >> 5);
    if (k != dword) {
      sync_bits();
      dword = k;
      dbits = 0u;
    }
    dbits |= 1u << (o & 31);
    fl |= 2 << w;
  }
  // the bytes of `mask`: a row that is not valid is filled first
  __device__ __forceinline__ void merge(const Params& p, int lane, int r,
                                        u32 v, u32 mask) {
    const int w = mru();
    const int o = r - base(w);
    i32* cell = win + (w * WIN_ROWS + o) * BLOCK_THREADS;
    if (!full(w)) {
      sync_bits();
      const u32* b = way_bits(w) + (o >> 5) * BLOCK_THREADS;
      if (!(((b[0] | b[WIN_BITS * BLOCK_THREADS]) >> (o & 31)) & 1u)) {
        *cell = p.mem[(size_t)r * (size_t)p.L + (size_t)lane];
        add(3, 1);
      }
    }
    put(p, lane, r, ((u32)*cell & ~mask) | (v & mask));
  }
  // _win_flush: both dirty ways back to the plane, both invalid (at the
  // launch's exit, and before an instruction that works on the plane:
  // memory.fill / memory.copy, memory.init, a tier-0 call with memory)
  __device__ __forceinline__ void flush(const Params& p, int lane) {
    if (dirty(0)) back(p, lane, 0, false);
    if (dirty(1)) back(p, lane, 1, false);
    wb0 = wb1 = WIN_SENT;
    fl = 0;
  }
  // whether select(rlo, rhi) would write a dirty way back: the victim, or
  // the other way under the overlap rule (pallas_engine.py :1905-1922)
  __device__ __forceinline__ bool dirty_miss(const Params& p, int rlo,
                                             int rhi) const {
    if (rlo >= wb0 && rhi < wb0 + WIN_ROWS) return false;
    if (rlo >= wb1 && rhi < wb1 + WIN_ROWS) return false;
    const int nb = clampi(rlo & ~7, 0, p.W - WIN_ROWS);
    const int o = mru();  // the other way; 1 - o is the victim
    return dirty(1 - o) ||
           (dirty(o) && base(o) < nb + WIN_ROWS && nb < base(o) + WIN_ROWS);
  }
  // a commit: both dirty ways' rows back to the plane, kept valid, clean
  __device__ __forceinline__ void commit(const Params& p, int lane) {
    if (dirty(0)) back(p, lane, 0, true);
    if (dirty(1)) back(p, lane, 1, true);
    fl &= ~6;
  }
  // a rollback: both ways invalid, their words dropped
  __device__ __forceinline__ void invalidate() {
    wb0 = wb1 = WIN_SENT;
    fl = 0;
    dword = -1;
  }
  // the lane's counts into g_win_counts, once at the exit
  __device__ __forceinline__ void count() const {
    const u32* m = bits + WIN_META_BITS * BLOCK_THREADS;
    const unsigned long long c[5] = {
        (unsigned long long)hits, m[0], m[BLOCK_THREADS],
        m[2 * BLOCK_THREADS], m[3 * BLOCK_THREADS]};
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (c[k] != 0) atomicAdd(&g_win_counts[k], c[k]);
  }
};

}  // namespace
