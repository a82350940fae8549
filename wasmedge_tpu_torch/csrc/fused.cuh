// Fused dispatch for the warp-interpreter: B2 basic blocks and B6 peephole
// superinstructions (sm_90a).
//
// Replaces, in wasmedge_tpu/batch/pallas_engine.py, the fused basic blocks
// `mk_block` (:2758-3201, planner `fuse_blocks` :429-569) and the
// superinstruction handlers `mk_fuse_gca` ... `h_fuse_gbr` (:2472-2652,
// planner `fuse_image` :269-388), and inside blocks the v128 handlers
// (:3203-3520).  The Pallas kernel builds one handler per block shape
// while it traces, with a virtual stack resolved at trace time, so a
// block's intermediates live in vector registers.  Here a generator
// (batch/fusegen.py) writes the dispatch of one module, with a virtual
// stack resolved when the code is generated: every cell a block pushes
// and pops is a variable of straight-line code, so nvcc keeps it in
// registers; local and global writes commit at once, and a later read of
// the same local or global ordinal takes the written (or first read)
// value; at any exit the live cells are written to the stack rows.  The
// module's source includes interp.cu and this file, and instantiates
// interp_kernel once, with the module's kBulk, kSimd and kWin (memory
// through the window cache, memwin.cuh), kOpt (optimistic convergence,
// optimistic.cuh) and its `Fused` dispatch, into a shared library of its
// own.
//
// B2 blocks: one case of `Fused::at_pc` per block head pc, switched on by
// the clamped pc at the top of interp.cu's dispatch loop (a jump table
// where the heads are dense), every immediate a literal: what a Wasm
// instruction costs in blocks on the H100 is the length of its chain of
// dependent instructions, loads and taken branches, one warp per SM
// scheduler with nothing to hide it, and a literal takes the operand
// load, the hid and flen loads and the second dispatch of a terminal off
// that chain.  The case runs br, brnz, return and direct calls itself;
// v128 ops are force-inlined by their literal sub (interp.cu v2_fn,
// v1_fn), shuffles literal byte permutes.  Heads beyond the generator's
// cap, and B6 superinstructions, keep `Fused::step`, dispatched by the
// fused id in the hid plane, operands from the code planes.
//
// Under kOpt a block's decisions (its guard and branch conditions, the
// addresses of its inline loads and stores, a return's frame row, a
// superinstruction's branch) go through the warp's `w` as the per-op
// handlers' do, a call saves its frame row for a rollback first
// (opt_save_frame), and an inline access whose window miss would write a
// dirty way back exits the block before it (n ops retired, no trap) for
// the commit, as an out-of-bounds access exits it with its trap.
//
// Semantics kept exact (batch/interp_ref.py is the plain version):
//  - a fused dispatch runs only when the lane's remaining steps in the
//    launch and its fuel cover the whole fused length (its terminal
//    included), so `retired`, `fuel` and the stopping instruction are the
//    per-op loop's; a terminal in the case never meets the fuel limit;
//  - exits inside a block leave the per-op state: a taken forward branch
//    (guard) exits at its op having retired it; an inline load or store
//    out of bounds traps with everything before it committed, pc at the
//    op and sp its pre-op sp; a terminal runs after the flush, as the
//    per-op step would, its rows below the block's exit sp noted first;
//  - the flush rule: at every exit each cell of the virtual stack at that
//    point is written to its row (a scalar cell with e2/e3 zeroed, a v128
//    cell with all four words); rows the per-op loop would write for
//    cells that die inside the dispatch are not written.

namespace {

// ---------------------------------------------------------------------------
// Cells of the virtual stack: u64 (scalar) or V4 (v128, kSimd builds)
// ---------------------------------------------------------------------------
__device__ __forceinline__ u64 lo64(u64 v) { return v; }
__device__ __forceinline__ u64 lo64(const V4& v) {
  return ((u64)v.w[1] << 32) | v.w[0];
}
__device__ __forceinline__ V4 v4of(u64 v) {
  return V4{{(u32)v, (u32)(v >> 32), 0u, 0u}};
}
__device__ __forceinline__ V4 v4of(const V4& v) { return v; }

// an ALU op that cannot trap (the planner fuses no div/rem and no trapping
// truncation), its sub known when the code is generated
__device__ __forceinline__ u64 fused_alu2(int sub, u64 x, u64 y) {
  int t = 0;
  return alu2(sub, x, y, t);
}
__device__ __forceinline__ u64 fused_alu1(int sub, u64 w) {
  int t = 0;
  return alu1(sub, w, t);
}

template <bool kSimd>
__device__ __forceinline__ u64 fused_gget(const Params& p,
                                          const Lane<kSimd>& s, int g) {
  const size_t i = s.at(g, p.NG);
  return pack(p.glob_lo[i], p.glob_hi[i]);
}
template <bool kSimd>
__device__ __forceinline__ void fused_gset(const Params& p,
                                           const Lane<kSimd>& s, int g,
                                           u64 v) {
  const size_t i = s.at(g, p.NG);
  p.glob_lo[i] = lo32(v);
  p.glob_hi[i] = hi32(v);
}

// v128 table row `a`: a v128.const value or a shuffle's byte selectors
__device__ __forceinline__ V4 fused_vrow(const Params& p, int a) {
  const int row = clampi(a, 0, p.nv - 1) * 4;
  return V4{{(u32)__ldg(&p.v128[row]), (u32)__ldg(&p.v128[row + 1]),
             (u32)__ldg(&p.v128[row + 2]), (u32)__ldg(&p.v128[row + 3])}};
}
__device__ __forceinline__ V4 fused_vshuffle(const Params& p, int a,
                                             const V4& x, const V4& y) {
  const V4 c = fused_vrow(p, a);
  V4 r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.w[k] = shuffle_word(x, y, c.w[k], false);
  return r;
}
// operands (v1, v2, mask) from the third cell down to the top
__device__ __forceinline__ V4 fused_vbitsel(const V4& a, const V4& b,
                                            const V4& m) {
  V4 r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.w[k] = (a.w[k] & m.w[k]) | (b.w[k] & ~m.w[k]);
  return r;
}

// ---------------------------------------------------------------------------
// Inline loads and stores: interp.cu's per-op H_LOAD / H_STORE cases with
// the width and flags known when the code is generated, through the
// lane's memory access `m` (the window cache with kWin) and the warp's
// decisions `w` (the address is lane 0's under kOpt).  Returns 0 (done),
// E_MEM_OOB (out of bounds, nothing read or written) or OPT_DEFER (kOpt:
// a commit first, nothing read or written).
// ---------------------------------------------------------------------------
template <bool kSimd, bool kWin, class Wp>
__device__ __forceinline__ int fused_load(const Params& p,
                                          const Lane<kSimd>& s, Mem<kWin>& m,
                                          Wp& w, int pages, u32 base, u32 off,
                                          int nbytes, int flags, u64& out) {
  base = w.agree(base);
  const u32 ea = base + off;
  const u32 end = ea + (u32)nbytes;
  const u32 mem_bytes = (u32)pages * 65536u;
  if (ea < base || ea < off || end < ea || mem_bytes < end) return E_MEM_OOB;
  const int widx = (int)(ea >> 2);
  const u32 sh = (ea & 3) * 8;
  int row[3];
  u32 wd[3];
  for (int k = 0; k < 3; ++k) row[k] = clampi(widx + k, 0, p.W - 1);
  if (w.on() && m.dirty_miss(p, row[0], row[2])) return OPT_DEFER;
  m.select(p, s.lane, row[0], row[2]);
  for (int k = 0; k < 3; ++k) wd[k] = m.get(p, s.lane, row[k]);
  const bool sgn = (flags & 1) != 0, is64 = (flags & 2) != 0;
  const u32 raw_lo = sh ? (wd[0] >> sh) | (wd[1] << (32 - sh)) : wd[0];
  const u32 raw_hi = sh ? (wd[1] >> sh) | (wd[2] << (32 - sh)) : wd[1];
  u32 lo;
  if (nbytes == 1) lo = sgn ? sext(raw_lo, 8) : (raw_lo & 0xFFu);
  else if (nbytes == 2) lo = sgn ? sext(raw_lo, 16) : (raw_lo & 0xFFFFu);
  else lo = raw_lo;
  u32 hi = 0;
  if (is64) hi = nbytes == 8 ? raw_hi : (sgn ? (u32)((i32)lo >> 31) : 0u);
  out = ((u64)hi << 32) | lo;
  return 0;
}

template <bool kSimd, bool kWin, class Wp>
__device__ __forceinline__ int fused_store(const Params& p,
                                           const Lane<kSimd>& s,
                                           Mem<kWin>& m, Wp& w, int pages,
                                           u32 base, u32 off, int nbytes,
                                           u64 val) {
  base = w.agree(base);
  const u32 ea = base + off;
  const u32 end = ea + (u32)nbytes;
  const u32 mem_bytes = (u32)pages * 65536u;
  if (ea < base || ea < off || end < ea || mem_bytes < end) return E_MEM_OOB;
  const int widx = (int)(ea >> 2);
  const u32 sh = (ea & 3) * 8;
  int row[3];
  u32 wd[3];
  for (int k = 0; k < 3; ++k) row[k] = clampi(widx + k, 0, p.W - 1);
  if (w.on() && m.dirty_miss(p, row[0], row[2])) return OPT_DEFER;
  m.select(p, s.lane, row[0], row[2]);
  for (int k = 0; k < 3; ++k) wd[k] = m.get(p, s.lane, row[k]);
  const u64 full = nbytes == 1 ? 0xFFull : nbytes == 2 ? 0xFFFFull
                   : nbytes == 8 ? ~0ull : 0xFFFFFFFFull;
  const u64 m01 = full << sh, v01 = val << sh;
  const u32 mk[3] = {(u32)m01, (u32)(m01 >> 32),
                     sh ? (u32)(full >> (64 - sh)) : 0u};
  const u32 vk[3] = {(u32)v01, (u32)(v01 >> 32),
                     sh ? (u32)(val >> (64 - sh)) : 0u};
  for (int k = 0; k < 3; ++k)
    if (mk[k] != 0) m.put(p, s.lane, row[k], (wd[k] & ~mk[k]) | (vk[k] & mk[k]));
  return 0;
}

// ---------------------------------------------------------------------------
// Launch of a module's fused kernel: one instantiation, the module's
// kBulk, kSimd, kWin and kOpt (with kWin, the windows' shared memory as
// interp.cu's per-op launch gives it).  Returns a CUDA error code (0 =
// launched).
// ---------------------------------------------------------------------------
template <bool kBulk, bool kSimd, bool kWin, bool kOpt, class F>
int fused_launch(const Params& p, int bulk, int simd, int win, int opt,
                 void* stream) {
  if ((bulk != 0) != kBulk || (simd != 0) != kSimd || (win != 0) != kWin ||
      (opt != 0) != kOpt || !p.hid0 || !p.flen)
    return (int)cudaErrorInvalidValue;
  if (kSimd && (p.stack_e2 == nullptr || p.stack_e3 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kWin && p.W < WIN_ROWS) return (int)cudaErrorInvalidValue;
  return launch_kernel<kBulk, kSimd, F, kWin, kOpt>(p, (cudaStream_t)stream);
}

}  // namespace

// The module's C entries: wasm_interp_launch's arguments, with the fused
// tables (hid0, flen and the superinstructions' operand planes, null for
// blocks) before the optimistic ones; and interp.cu's kernel_attrs of its
// one instantiation at depth D.
#define WASM_FUSED_LAUNCH(KBULK, KSIMD, KWIN, KOPT, FUSED)                     \
  extern "C" int wasm_fused_launch(                                            \
      const int* hid, const int* a, const int* b, const int* c,                \
      const int* ilo, const int* ihi, const int* fent, const int* fnpar,       \
      const int* fnloc, const int* ftop, const int* ftyp, const int* brt,      \
      const int* tbl, const int* v128, int* pc, int* sp, int* fp,              \
      int* opbase, int* call_depth, int* trap, int* retired, int* fuel,        \
      int* mem_pages, int* stack_lo, int* stack_hi, int* stack_e2,             \
      int* stack_e3, int* fr_ret_pc, int* fr_fp, int* fr_opbase,               \
      int* glob_lo, int* glob_hi, int* mem, const int* hid0,                   \
      const int* flen, const int* fa, const int* fb, const int* fc,            \
      const int* filo, const int* fihi, WASM_OPT_ARGS, int code_len, int nf,   \
      int n_brt, int tsize, int nv, int L, int D, int CD, int NG, int W,       \
      int chunk, int fuel_on, int max_local_zeros, int mem_pages_max,          \
      int bulk, int simd, int win, int opt, int snap_max, void* stream) {      \
    Params p{hid,       a,         b,        c,         ilo,                   \
             ihi,       fent,      fnpar,    fnloc,     ftop,                  \
             ftyp,      brt,       tbl,      pc,        sp,                    \
             fp,        opbase,    call_depth, trap,    retired,               \
             fuel,      mem_pages, stack_lo, stack_hi,  fr_ret_pc,             \
             fr_fp,     fr_opbase, glob_lo,  glob_hi,   mem,                   \
             code_len,  nf,        n_brt,    tsize,     L,                     \
             D,         CD,        NG,       W,         chunk,                 \
             fuel_on,   max_local_zeros, mem_pages_max, v128, stack_e2,        \
             stack_e3,  nv,        hid0,     flen,      fa,                    \
             fb,        fc,        filo,     fihi,      WASM_OPT_FIELDS,       \
             snap_max};                                                        \
    return fused_launch<KBULK, KSIMD, KWIN, KOPT, FUSED>(p, bulk, simd, win,  \
                                                         opt, stream);         \
  }                                                                            \
  extern "C" int wasm_fused_attrs(int D, int* out) {                           \
    return kernel_attrs<KBULK, KSIMD, FUSED, KWIN, KOPT>(D, out);              \
  }
