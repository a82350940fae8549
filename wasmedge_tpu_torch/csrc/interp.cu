// Warp-interpreter for Hopper (sm_90a): one CUDA thread per Wasm lane.
//
// Replaces the TPU kernel `_build_kernel` in
// wasmedge_tpu/batch/pallas_engine.py (the one pl.pallas_call, :3825): its
// dispatch loop (:3557-3651), base handlers (:1082-1388), ALU makers
// (:2653, :2715), loads/stores (:1549-1700), fuel (:3695-3711), the host
// call park `h_hostcall` (:1520) and bulk memory `h_memfill` (:1389) and
// `h_memcopy` (:1441).  The Pallas kernel keeps one scalar pc per lane
// block, because the TPU runs one instruction stream per VMEM block, and
// hands divergent blocks to a scheduler and a SIMT engine.  An H100 runs
// one pc per thread, so here every lane carries its own pc, sp, fp,
// operand base, call depth, page count, fuel and retired count in
// registers for the whole launch, and warp divergence is left to the
// hardware.  The per-lane results equal
// what the Pallas kernel, the block scheduler and the SIMT residue give
// together; per-instruction semantics are those of the reference SIMT
// step (wasmedge_tpu/batch/engine.py _make_step), bit for bit, and
// batch/interp_ref.py is the plain PyTorch version of this file.
//
// State planes keep the reference layout, lane fastest ([rows, lanes]
// int32), so the lanes of a converged warp touch one 128-byte row per
// access: the GPU form of the TPU's uniform-address fast path.  What
// bounds it on this card is the latency of the dependent accesses each
// instruction makes (handler id, operands, result), not bandwidth.  Every
// launch runs one-warp blocks (BLOCK_THREADS), so 4096 lanes are 128
// blocks on 128 of the H100's 132 SMs, and the lowest R rows of each
// lane's value stack live in its block's shared memory for the whole
// launch (Lane), as the Pallas kernel keeps a lane block's stack in VMEM:
// an instruction's result reaches the next one through shared memory,
// not through a global store and a dependent global load.  R follows
// from the depth D (stack_rows); rows at or above R stay in the [D, L]
// planes.
//
// Linear memory (kWin, B4, memwin.cuh): with the window cache on, each
// lane's loads and stores go through two windows of 128 words of its
// memory column in shared memory (32 KiB per block, before the stack
// rows), filled from and written back to the [W, L] plane; without it
// they read and write the plane directly.
//
// Host calls: a lane at a HOSTCALL stub parks (trap = TRAP_HOSTCALL, pc
// left at the stub); the host serves it between launches and re-arms it
// at the stub's RETURN, so the kernel itself never leaves the card.
// Tier 0 (WASM_TIER0 builds, those of images with tier-0 kinds; the
// reference SIMT step's engine.py:1309-1449, which the Pallas kernel never
// runs): clock_time_get, random_get, sched_yield, proc_exit and fd_write
// to fd 1 or 2 are served at the stub by `tier0_call` instead: the result
// at the frame's operand base and on at the stub's RETURN, or the lane
// stops (proc_exit); fd_write appends a record to the lane's column of the
// stdout buffer, which the host drains between launches.  The shapes the
// reference leaves to the host (a cputime clock, an oversized request, a
// full buffer, another fd, more than one iovec, an unaligned iovec array)
// park as before.  A build without WASM_TIER0 has none of this compiled
// in: fib's builds keep their code.
//
// Tables, element and data segments, tail calls and ref.func (WASM_TABLES
// builds, those of images with such classes; the reference SIMT step's
// engine.py:1156-1307 and :1464-1516, which no Pallas code runs: the
// Pallas engine sends such images to the SIMT engine,
// pallas_engine.py:578-595): each lane has its own table column in the
// [table_cap, L] plane and its size (when the image mutates its table),
// and its own dropped flag per segment; table.get / set / size / grow /
// fill / copy / init, elem.drop, memory.init, data.drop and ref.func run
// per lane in `a3_step` (out of line: the dispatch loop keeps its
// registers), as row walks over the lane's column (copy walks backward
// when dst > src: the reference gathers from the table before the op);
// memory.init walks the lane's memory column bytewise from the segment's
// words, after the lane's windows are written back and dropped (as a bulk
// op).  call_indirect reads the lane's table; return_call and
// return_call_indirect replace the frame: fp stays, the arguments slide
// down to it, no frame row is written and only the value stack is
// checked.  Weighted gas (WASM_GAS) charges each instruction its weight
// and a fused dispatch its ops' sum.  A build without these defines has
// none of this compiled in.
//
// v128 (B7, `h_vconst` ... `h_vstore`, pallas_engine.py :3203-3520): a
// v128 cell is four words, kept in four stack planes (lo, hi, e2, e3).
// Only images that hold v128 ops run the kSimd instantiations, which have
// the four-word cells and the 216 handlers; everything else runs the
// instantiations without them, as the reference SIMT step compiles its
// v128 section only for such images (HAS_SIMD).  Under kSimd a move
// (local.get/set/tee, select, a kept branch value, return) carries all
// four words and every scalar write zeroes e2/e3 at its row, as the SIMT
// step does (engine.py:1536-1637).  Integer lane ops use the
// SIMD-in-a-word intrinsics (__vadd4, __vcmpeq2, ...) and __byte_perm for
// shuffles; float lanes call the scalar float functions below, so vector
// and scalar floats give the same bits.  v128.load / v128.store read a
// five-word window of the lane's memory column shifted by (ea & 3) * 8.
// Inside a B2 block (fused.cuh) each op is its force-inlined body with
// its sub a literal (v2_fn, v1_fn, ...), so nvcc folds it to its own
// instructions on the cell in registers; the per-op step calls v2_op and
// v1_op out of line with the sub known at run time.
//
// memory.fill / memory.copy (B5) run as a warp-cooperative row pass
// (bulk_op): the lanes of a warp at the op together form groups as the
// TPU kernel's agree rule does, and each group's rows are moved 16 bytes
// a thread by every thread at the op, under per-lane byte masks.  The
// work is bounded by bytes (each byte filled is written once, each byte
// copied read and written once).
//
// Optimistic convergence (kOpt, B3, optimistic.cuh): a warp whose lanes
// start a launch converged takes lane 0's decision at every branch,
// table index, grow delta, memory address and ALU trap, with a canary
// for lanes that disagree, validated at commit points; a dirty check
// restores the last snapshot and re-runs the rest of the launch in the
// careful per-lane loop below, in the same kernel.  A whole warp whose
// lanes also hold one state (stack rows below sp, frames, globals, live
// memory) cannot disagree: it runs the careful decisions with the
// commit points and takes no snapshot.  Every other warp, and every warp
// of a build without kOpt, runs the careful loop alone.
//
// Numerics are IEEE-strict: build with -fmad=false and without -ftz or
// --use_fast_math; every float op uses an _rn intrinsic and NaNs are
// canonicalised as the reference does.  Integer arithmetic runs on
// unsigned types (no signed-overflow UB), shift counts are masked, and
// INT_MIN / -1 and division by zero are caught before dividing.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

// The scalar ALU functions below are left to nvcc's inliner in the shared
// per-op build; a fused build (fused.cuh) forces them inline, so that a
// block's ALU op with its sub known at compile time folds to its one case.
#ifndef ALU_INLINE
#define ALU_INLINE
#endif

namespace {

typedef int32_t i32;
typedef uint32_t u32;
typedef int64_t i64;
typedef uint64_t u64;

// Trap codes (wasmedge_tpu/common/errors.py ErrCode, compared bit for bit).
constexpr int TRAP_DONE = -1;
constexpr int TRAP_HOSTCALL = -2;
constexpr int E_DIV_ZERO = 0x84;
constexpr int E_INT_OVERFLOW = 0x85;
constexpr int E_INVALID_CONV = 0x86;
constexpr int E_TABLE_OOB = 0x87;
constexpr int E_MEM_OOB = 0x88;
constexpr int E_UNINIT_ELEM = 0x8A;
constexpr int E_UNDEF_ELEM = 0x8B;
constexpr int E_SIG_MISMATCH = 0x8C;
constexpr int E_CALL_STACK = 0x90;
constexpr int E_STACK_OVERFLOW = 0x91;
constexpr int E_COST_LIMIT = 0x92;
constexpr int E_EXEC_FAILED = 0x95;
constexpr int E_TERMINATED = 0x01;

// Handler ids (batch/interp.py, numbering shared with pallas_engine.py).
constexpr int H_NOP = 0;
constexpr int H_CONST = 1;
constexpr int H_LOCAL_GET = 2;
constexpr int H_LOCAL_SET = 3;
constexpr int H_LOCAL_TEE = 4;
constexpr int H_GLOBAL_GET = 5;
constexpr int H_GLOBAL_SET = 6;
constexpr int H_DROP = 7;
constexpr int H_SELECT = 8;
constexpr int H_BR = 9;
constexpr int H_BRZ = 10;
constexpr int H_BRNZ = 11;
constexpr int H_BR_TABLE = 12;
constexpr int H_RETURN = 13;
constexpr int H_CALL = 14;
constexpr int H_CALL_INDIRECT = 15;
constexpr int H_MEMSIZE = 16;
constexpr int H_MEMGROW = 17;
constexpr int H_TRAP = 18;
constexpr int H_LOAD = 19;
constexpr int H_STORE = 20;
constexpr int H_HOSTCALL = 21;
constexpr int H_MEMFILL = 22;
constexpr int H_MEMCOPY = 23;
constexpr int H_ALU2_BASE = 24;
constexpr int NUM_ALU2 = 76;
constexpr int H_ALU1_BASE = 100;
constexpr int NUM_ALU1 = 61;
constexpr int H_FUSE_GCA_BASE = 161;  // B6 superinstructions, 161-845
constexpr int H_FUSE_GBR = 845;
constexpr int H_LOAD_W = 846;
constexpr int H_LOAD_D = 847;
constexpr int H_STORE_W = 848;
constexpr int H_STORE_D = 849;
constexpr int H_VCONST = 850;
constexpr int H_VSHUFFLE = 851;
constexpr int H_VBITSEL = 852;
constexpr int H_VLOAD = 853;
constexpr int H_VSTORE = 854;
constexpr int H_V2_BASE = 855;
constexpr int H_V1_BASE = 975;
constexpr int H_VTEST_BASE = 1025;
constexpr int H_VSHIFT_BASE = 1034;
constexpr int H_VSPLAT_BASE = 1046;
constexpr int H_VEXTRACT_BASE = 1052;
constexpr int H_VREPLACE_BASE = 1060;
constexpr int NUM_HANDLERS = 1066;  // B2 block ids start here
// Tables, segments, tail calls and ref.func (WASM_TABLES builds only):
// negative, so that the ids above and the block ids keep their numbers.
constexpr int H_A3_BASE = -64;
constexpr int H_TABLE_GET = -64;
constexpr int H_TABLE_SET = -63;
constexpr int H_TABLE_SIZE = -62;
constexpr int H_TABLE_GROW = -61;
constexpr int H_TABLE_FILL = -60;
constexpr int H_TABLE_COPY = -59;
constexpr int H_TABLE_INIT = -58;
constexpr int H_ELEM_DROP = -57;
constexpr int H_MEMINIT = -56;
constexpr int H_DATA_DROP = -55;
constexpr int H_RETCALL = -54;
constexpr int H_RETCALL_INDIRECT = -53;
constexpr int H_REFFUNC = -52;

// First sub id of each family in batch/simdops.py's V2_NAMES / V1_NAMES
// (the ops of a family follow in the order of its name list there).
constexpr int V2_I8X16 = 4;     // i8x16.add
constexpr int V2_I16X8 = 26;    // i16x8.add
constexpr int V2_I32X4 = 48;    // i32x4.add
constexpr int V2_I64X2 = 65;    // i64x2.add
constexpr int V2_F32X4 = 74;    // f32x4.add
constexpr int V2_F64X2 = 88;    // f64x2.add
constexpr int V2_NARROW = 102;  // i8x16.narrow_i16x8_s
constexpr int V2_EXTMUL = 108;  // i16x8.extmul_low_i8x16_s
constexpr int V1_F32X4 = 10;    // f32x4.abs
constexpr int V1_F64X2 = 17;    // f64x2.abs
constexpr int V1_CONVERT = 24;  // i32x4.trunc_sat_f32x4_s
constexpr int V1_EXTEND = 34;   // i16x8.extend_low_i8x16_s
constexpr int V1_EXTADD = 46;   // i16x8.extadd_pairwise_i8x16_s

constexpr u32 SIGN32 = 0x80000000u;
constexpr u32 F32_CANON_NAN = 0x7FC00000u;
constexpr u64 F64_CANON_NAN = 0x7FF8000000000000ull;
constexpr u64 SIGN64 = 0x8000000000000000ull;

// Tier 0's launch arguments (null and 0 in a build without WASM_TIER0):
// the kind each stub pc serves in the kernel (batch/image.py T0_*, 0
// elsewhere), the per-lane call counts [4, L] (clock, random, fd_write,
// sched_yield + proc_exit), the stdout record buffer [sw, L] and each
// lane's fill in words [L] (null when the module's fd_write is not
// served), on, the buffer's rows, the PRNG seed, the longest random_get
// and fd_write payloads in words, and the launch's time base (realtime
// and monotonic ns as (lo, hi), read on the host before the launch).
struct T0Args {
  const i32* __restrict__ kind;
  i32* ctr;
  i32* so_buf;
  i32* so_off;
  int on, sw, seed, rmax_w, wmax_w, rt_lo, rt_hi, mono_lo, mono_hi;
};

// The tables' and weighted gas's launch arguments (null and 0 in a build
// without WASM_TABLES / WASM_GAS): each lane's table [tcap, L] and size
// [L] (null unless the image mutates its table), the segments' dropped
// flags [n_elem, L] and [n_data, L] (null when unused), the element
// segments (funcidx+1, flat, with offsets and lengths) and the data
// segments (bytes packed into words, with byte offsets and lengths), each
// pc's gas weight [code_len] and their running sum [code_len + 1]
// (WASM_GAS), on, the table plane's rows, the segment counts, the flat
// element and data word counts, and gas on.
struct A3Args {
  i32* tab;
  i32* tsize;
  i32* edrop;
  i32* ddrop;
  const i32* __restrict__ efl;
  const i32* __restrict__ eoff;
  const i32* __restrict__ elen;
  const i32* __restrict__ dwords;
  const i32* __restrict__ doff;
  const i32* __restrict__ dlen;
  const i32* __restrict__ cost;
  const i32* __restrict__ gcum;
  int on, tcap, n_elem, n_data, n_efl, n_dwords, gas_on;
};

struct Params {
  // read-only code tables
  const i32* __restrict__ hid;
  const i32* __restrict__ a;
  const i32* __restrict__ b;
  const i32* __restrict__ c;
  const i32* __restrict__ ilo;
  const i32* __restrict__ ihi;
  const i32* __restrict__ fent;
  const i32* __restrict__ fnpar;
  const i32* __restrict__ fnloc;
  const i32* __restrict__ ftop;
  const i32* __restrict__ ftyp;
  const i32* __restrict__ brt;
  const i32* __restrict__ tbl;
  // per-lane state, updated in place
  i32* pc;
  i32* sp;
  i32* fp;
  i32* opbase;
  i32* call_depth;
  i32* trap;
  i32* retired;
  i32* fuel;
  i32* mem_pages;
  i32* stack_lo;
  i32* stack_hi;
  i32* fr_ret_pc;
  i32* fr_fp;
  i32* fr_opbase;
  i32* glob_lo;
  i32* glob_hi;
  i32* mem;
  int code_len, nf, n_brt, tsize, L, D, CD, NG, W, chunk, fuel_on,
      max_local_zeros;
  // v128 (kSimd): appended, so that the fields above keep their places
  const i32* __restrict__ v128;  // [nv, 4]: v128.const values, masks
  i32* stack_e2;                 // null unless the image holds v128 ops
  i32* stack_e3;
  int nv;
  // fused encodings (a fused build only): the original hid plane, the
  // instructions a fused dispatch retires in full, and the rewritten
  // operand planes of the superinstructions
  const i32* __restrict__ hid0;
  const i32* __restrict__ flen;
  const i32* __restrict__ fa;
  const i32* __restrict__ fb;
  const i32* __restrict__ fc;
  const i32* __restrict__ filo;
  const i32* __restrict__ fihi;
  // optimistic convergence (kOpt): the per-warp interval, rollback,
  // entry, commit and uniform-entry counts ([ceil(L / 32)]), the
  // snapshot's shadow planes ([rows, L], null where unused) and the
  // interval's ceiling
  i32* w_snap;
  i32* w_rollbacks;
  i32* w_entered;
  i32* w_commits;
  i32* w_uniform;
  i32* sh_lo;
  i32* sh_hi;
  i32* sh_e2;
  i32* sh_e3;
  i32* sh_fr_ret_pc;
  i32* sh_fr_fp;
  i32* sh_fr_opbase;
  i32* sh_glo;
  i32* sh_ghi;
  i32* sh_mem;
  int snap_max;
  // stack rows on chip (Lane): set by the launch from D, kSimd and kWin
  int srows;
  // tier 0 (WASM_TIER0 builds)
  T0Args t0;
  // tables, segments and weighted gas (WASM_TABLES, WASM_GAS builds)
  A3Args a3;
  // the lanes launched (lane compaction's narrowed launches): lanes
  // [0, width) run, L stays the pitch of every plane
  int width;
};

// Threads per block of every launch: one warp, so that 4096 lanes are 128
// blocks on 128 of the H100's 132 SMs in one wave.
constexpr int BLOCK_THREADS = 32;

// WASM_STACK_SPLIT 0: a build for depths whose every stack row fits on
// chip (D <= the rows the block's shared memory holds, stack_rows), whose
// stack accesses have no compare and no global path: on an H100 the
// compare cost fib(30) x 4096 a sixth of its time (PERF.md); a launch at
// a deeper stack is refused.  1: rows at or above R stay in global
// memory.  The wrapper picks the build from the engine's depth
// (batch/interp.py `stack_split`).
#ifndef WASM_STACK_SPLIT
#define WASM_STACK_SPLIT 1
#endif
constexpr bool kStackSplit = WASM_STACK_SPLIT != 0;

// WASM_TIER0 1: the build of an image with tier-0 kinds, with the tier-0
// handlers at its stubs (tier0_call) and its planes in B3's entry
// compare; a launch must then give t0.on, and a build without it refuses
// one that does.  Undefined in every other build, whose code it leaves as
// it was: one more case label slowed fib(30) x 4096 by 1.5 % on an H100
// (PERF.md).
#ifndef WASM_TIER0
#define WASM_TIER0 0
#endif
constexpr bool kTier0 = WASM_TIER0 != 0;

// WASM_TABLES 1: the build of an image with table, segment, tail-call or
// ref.func classes, with their handlers (a3_step, the tail calls in the
// call case, call_indirect through the lane's table) and the table and
// segment planes in B3's entry compare; a launch must then give a3.on,
// and a build without it refuses one that does.  WASM_GAS 1: weighted
// gas (a launch gives a3.gas_on and the weights).  Undefined in every
// other build, whose code they leave as it was.
#ifndef WASM_TABLES
#define WASM_TABLES 0
#endif
#ifndef WASM_GAS
#define WASM_GAS 0
#endif
constexpr bool kTables = WASM_TABLES != 0;
constexpr bool kGas = WASM_GAS != 0;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ u64 pack(i32 lo, i32 hi) {
  return ((u64)(u32)hi << 32) | (u64)(u32)lo;
}
__device__ __forceinline__ i32 lo32(u64 v) { return (i32)(u32)v; }
__device__ __forceinline__ i32 hi32(u64 v) { return (i32)(u32)(v >> 32); }
__device__ __forceinline__ u64 cell32(u32 lo) { return (u64)lo; }

// ---------------------------------------------------------------------------
// binary32 helpers (bit domain, laneops.py)
// ---------------------------------------------------------------------------
__device__ __forceinline__ float f32(u32 b) { return __uint_as_float(b); }
__device__ __forceinline__ u32 bits32(float f) { return __float_as_uint(f); }
__device__ __forceinline__ bool is_nan32(u32 b) {
  return (b & 0x7F800000u) == 0x7F800000u && (b & 0x007FFFFFu) != 0;
}
__device__ __forceinline__ u32 canon32(u32 b) {
  return is_nan32(b) ? F32_CANON_NAN : b;
}
__device__ __forceinline__ i32 key32(u32 b) {
  i32 z = (b == SIGN32) ? 0 : (i32)b;
  return z ^ ((z >> 31) & 0x7FFFFFFF);
}
__device__ __forceinline__ bool f32_eq(u32 x, u32 y) {
  if (is_nan32(x) || is_nan32(y)) return false;
  u32 zx = (x == SIGN32) ? 0u : x, zy = (y == SIGN32) ? 0u : y;
  return zx == zy;
}
__device__ __forceinline__ bool f32_lt(u32 x, u32 y) {
  if (is_nan32(x) || is_nan32(y)) return false;
  return key32(x) < key32(y);
}
__device__ __forceinline__ u32 f32_min(u32 x, u32 y) {
  if (is_nan32(x) || is_nan32(y)) return F32_CANON_NAN;
  if (((x | y) & 0x7FFFFFFFu) == 0) return x | y;
  return key32(x) < key32(y) ? x : y;
}
__device__ __forceinline__ u32 f32_max(u32 x, u32 y) {
  if (is_nan32(x) || is_nan32(y)) return F32_CANON_NAN;
  if (((x | y) & 0x7FFFFFFFu) == 0) return x & y;
  return key32(x) > key32(y) ? x : y;
}
__device__ __forceinline__ u32 sign_fix32(u32 r, u32 x) {
  return (r & 0x7FFFFFFFu) == 0 ? (r | (x & SIGN32)) : r;
}

// ---------------------------------------------------------------------------
// binary64 helpers (softfloat.py semantics)
// ---------------------------------------------------------------------------
__device__ __forceinline__ double f64(u64 b) { return __longlong_as_double((i64)b); }
__device__ __forceinline__ u64 bits64(double d) { return (u64)__double_as_longlong(d); }
__device__ __forceinline__ bool is_nan64(u64 v) {
  return ((v >> 52) & 0x7FF) == 0x7FF && (v & 0xFFFFFFFFFFFFFull) != 0;
}
__device__ __forceinline__ bool is_inf64(u64 v) {
  return ((v >> 52) & 0x7FF) == 0x7FF && (v & 0xFFFFFFFFFFFFFull) == 0;
}
__device__ __forceinline__ bool is_zero64(u64 v) { return (v & ~SIGN64) == 0; }
__device__ __forceinline__ u64 canon64(u64 v) {
  return is_nan64(v) ? F64_CANON_NAN : v;
}
__device__ __forceinline__ u64 f64_min(u64 x, u64 y) {
  if (is_nan64(x) || is_nan64(y)) return F64_CANON_NAN;
  bool eq = f64(x) == f64(y);
  bool pick_x = (eq && (i64)x < 0) || (!eq && f64(x) < f64(y));
  return pick_x ? x : y;
}
__device__ __forceinline__ u64 f64_max(u64 x, u64 y) {
  if (is_nan64(x) || is_nan64(y)) return F64_CANON_NAN;
  bool eq = f64(x) == f64(y);
  bool pick_x = (eq && (i64)x >= 0) || (!eq && f64(y) < f64(x));
  return pick_x ? x : y;
}
__device__ __forceinline__ u64 f32_to_f64(u32 x) {
  return canon64(bits64((double)f32(x)));
}
__device__ __forceinline__ u32 f64_to_f32(u64 v) {
  return canon32(bits32(__double2float_rn(f64(v))));
}

// softfloat.f64_to_i64_trunc, carried over literally: its out-of-range
// value is what a trapping truncation leaves on the stack.
__device__ __forceinline__ u64 f64_to_i64_trunc(u64 v, bool& ok_s, bool& ok_u,
                                                bool& nan) {
  bool s = (v >> 63) != 0;
  int be = (int)((v >> 52) & 0x7FF);
  int e = be - 1023;
  u64 m = v & 0xFFFFFFFFFFFFFull;
  if (be != 0) m |= 1ull << 52;
  int sh = e - 52;
  u64 mag = sh >= 0 ? (m << (sh < 63 ? sh : 63)) : (m >> (-sh < 63 ? -sh : 63));
  if (e < 0) mag = 0;
  nan = is_nan64(v);
  bool inf = is_inf64(v);
  ok_s = (e < 63 && !nan && !inf) || (s && e == 63 && mag == SIGN64 && !nan);
  ok_u = (!s && e < 64 && !nan && !inf) || is_zero64(v) || (s && e < 0);
  return s ? (u64)0 - mag : mag;
}

// softfloat.f32_from_i64: i64 -> f32 rounded once to 24 bits.
__device__ __forceinline__ u32 f32_from_i64(u64 v, bool is_signed) {
  u32 s = 0;
  u64 m = v;
  if (is_signed && (i64)v < 0) {
    m = (u64)0 - v;
    s = 1;
  }
  if (m == 0) return s << 31;
  int msb = 63 - __clzll((long long)m);
  int shift = msb - 26;
  bool sticky = false;
  u32 w;
  if (shift >= 0) {
    sticky = shift > 0 && (m & ((1ull << shift) - 1)) != 0;
    w = (u32)(m >> shift);
  } else {
    w = (u32)(m << -shift);
  }
  u32 e32 = (u32)(msb + 127);
  u32 rnd = (w >> 2) & 1;
  bool sticky2 = (w & 3) != 0 || sticky;
  u32 lsb = (w >> 3) & 1;
  u32 mm = (w >> 3) + ((rnd == 1 && (sticky2 || lsb == 1)) ? 1u : 0u);
  if (mm & 0x01000000u) {
    mm >>= 1;
    e32 += 1;
  }
  return (s << 31) | (e32 << 23) | (mm & 0x007FFFFFu);
}

__device__ __forceinline__ u32 ctz32(u32 v) { return __popc((v & (0u - v)) - 1u); }
__device__ __forceinline__ u32 sext(u32 v, int bits) {
  u32 m = (1u << bits) - 1u, h = 1u << (bits - 1);
  return ((v & m) ^ h) - h;
}

// ---------------------------------------------------------------------------
// ALU2: sub (image.py numbering) on x, y -> result cell; trap code out.
// ---------------------------------------------------------------------------
__device__ ALU_INLINE u64 alu2_i32(int op, u32 x, u32 y, int& trap) {
  i32 xs = (i32)x, ys = (i32)y;
  u32 n = y & 31;
  switch (op) {
    case 0: return cell32(x + y);
    case 1: return cell32(x - y);
    case 2: return cell32(x * y);
    case 3: {  // div_s
      if (ys == 0) { trap = E_DIV_ZERO; return cell32(x); }
      if (xs == INT32_MIN && ys == -1) { trap = E_INT_OVERFLOW; return cell32(x); }
      return cell32((u32)(xs / ys));
    }
    case 4:  // div_u
      if (y == 0) { trap = E_DIV_ZERO; return cell32(x); }
      return cell32(x / y);
    case 5:  // rem_s
      if (ys == 0) { trap = E_DIV_ZERO; return 0; }
      if (ys == -1) return 0;
      return cell32((u32)(xs % ys));
    case 6:  // rem_u
      if (y == 0) { trap = E_DIV_ZERO; return 0; }
      return cell32(x % y);
    case 7: return cell32(x & y);
    case 8: return cell32(x | y);
    case 9: return cell32(x ^ y);
    case 10: return cell32(x << n);
    case 11: return cell32((u32)(xs >> n));
    case 12: return cell32(x >> n);
    case 13: return cell32(n ? (x << n) | (x >> (32 - n)) : x);
    case 14: { u32 k = (32 - n) & 31; return cell32(k ? (x << k) | (x >> (32 - k)) : x); }
    case 15: return x == y;
    case 16: return x != y;
    case 17: return xs < ys;
    case 18: return x < y;
    case 19: return xs > ys;
    case 20: return x > y;
    case 21: return xs <= ys;
    case 22: return x <= y;
    case 23: return xs >= ys;
    default: return x >= y;  // 24: ge_u
  }
}

__device__ ALU_INLINE u64 alu2_i64(int op, u64 x, u64 y, int& trap) {
  i64 xs = (i64)x, ys = (i64)y;
  u32 n = (u32)(y & 63);
  switch (op) {
    case 0: return x + y;
    case 1: return x - y;
    case 2: return x * y;
    case 3:  // div_s
      if (y == 0) { trap = E_DIV_ZERO; return x; }
      if (xs == INT64_MIN && ys == -1) { trap = E_INT_OVERFLOW; return x; }
      return (u64)(xs / ys);
    case 4:
      if (y == 0) { trap = E_DIV_ZERO; return x; }
      return x / y;
    case 5:
      if (y == 0) { trap = E_DIV_ZERO; return 0; }
      if (ys == -1) return 0;
      return (u64)(xs % ys);
    case 6:
      if (y == 0) { trap = E_DIV_ZERO; return 0; }
      return x % y;
    case 7: return x & y;
    case 8: return x | y;
    case 9: return x ^ y;
    case 10: return x << n;
    case 11: return (u64)(xs >> n);
    case 12: return x >> n;
    case 13: return n ? (x << n) | (x >> (64 - n)) : x;
    case 14: { u32 k = (64 - n) & 63; return k ? (x << k) | (x >> (64 - k)) : x; }
    case 15: return x == y;
    case 16: return x != y;
    case 17: return xs < ys;
    case 18: return x < y;
    case 19: return xs > ys;
    case 20: return x > y;
    case 21: return xs <= ys;
    case 22: return x <= y;
    case 23: return xs >= ys;
    default: return x >= y;
  }
}

__device__ ALU_INLINE u64 alu2_f32(int op, u32 x, u32 y) {
  switch (op) {
    case 0: return canon32(bits32(__fadd_rn(f32(x), f32(y))));
    case 1: return canon32(bits32(__fsub_rn(f32(x), f32(y))));
    case 2: return canon32(bits32(__fmul_rn(f32(x), f32(y))));
    case 3: return canon32(bits32(__fdiv_rn(f32(x), f32(y))));
    case 4: return f32_min(x, y);
    case 5: return f32_max(x, y);
    case 6: return (x & 0x7FFFFFFFu) | (y & SIGN32);
    case 7: return f32_eq(x, y);
    case 8: return !f32_eq(x, y);
    case 9: return f32_lt(x, y);
    case 10: return f32_lt(y, x);
    case 11: return (f32_lt(x, y) || f32_eq(x, y)) && !is_nan32(x) && !is_nan32(y);
    default: return (f32_lt(y, x) || f32_eq(x, y)) && !is_nan32(x) && !is_nan32(y);
  }
}

__device__ ALU_INLINE u64 alu2_f64(int op, u64 x, u64 y) {
  double dx = f64(x), dy = f64(y);
  switch (op) {
    case 0: return canon64(bits64(__dadd_rn(dx, dy)));
    case 1: return canon64(bits64(__dsub_rn(dx, dy)));
    case 2: return canon64(bits64(__dmul_rn(dx, dy)));
    case 3: return canon64(bits64(__ddiv_rn(dx, dy)));
    case 4: return f64_min(x, y);
    case 5: return f64_max(x, y);
    case 6: return (x & ~SIGN64) | (y & SIGN64);
    case 7: return dx == dy;
    case 8: return !(dx == dy);
    case 9: return dx < dy;
    case 10: return dy < dx;
    case 11: return dx < dy || dx == dy;
    default: return dy < dx || dx == dy;
  }
}

__device__ __forceinline__ u64 alu2(int sub, u64 x, u64 y, int& trap) {
  if (sub < 25) return alu2_i32(sub, (u32)x, (u32)y, trap);
  if (sub < 50) return alu2_i64(sub - 25, x, y, trap);
  if (sub < 63) return alu2_f32(sub - 50, (u32)x, (u32)y);
  return alu2_f64(sub - 63, x, y);
}

// ---------------------------------------------------------------------------
// ALU1
// ---------------------------------------------------------------------------
// float -> int truncations (subs 23-26 and 49-60): laneops.alu1_fns trunc64
// and alu1_trap_fns, via the exact f64 integer path.
__device__ ALU_INLINE u64 alu1_trunc(u64 w, bool src32, bool to32, bool is_signed, bool sat,
                          int& trap) {
  u64 v = src32 ? f32_to_f64((u32)w) : w;
  bool ok_s, ok_u, nan;
  u64 out = f64_to_i64_trunc(v, ok_s, ok_u, nan);
  u32 olo = (u32)out, ohi = (u32)(out >> 32);
  if (to32) {
    ok_s = ok_s && (i32)ohi == ((i32)olo >> 31);
    ok_u = ok_u && ohi == 0;
  }
  bool ok = is_signed ? ok_s : ok_u;
  bool neg = (i64)v < 0;
  if (!sat) {
    if (nan || !ok) trap = nan ? E_INVALID_CONV : E_INT_OVERFLOW;
    return to32 ? cell32(olo) : out;
  }
  if (to32) {
    u32 clamp = is_signed ? (neg ? SIGN32 : 0x7FFFFFFFu) : (neg ? 0u : 0xFFFFFFFFu);
    return cell32(nan ? 0u : (ok ? olo : clamp));
  }
  u64 clamp = is_signed ? (neg ? SIGN64 : ~SIGN64) : (neg ? 0ull : ~0ull);
  return nan ? 0 : (ok ? out : clamp);
}

__device__ ALU_INLINE u64 alu1(int sub, u64 w, int& trap) {
  u32 lo = (u32)w, hi = (u32)(w >> 32);
  switch (sub) {
    case 0: return __clz((int)lo);
    case 1: return ctz32(lo);
    case 2: return __popc(lo);
    case 3: return lo == 0;
    case 4: return cell32(sext(lo, 8));
    case 5: return cell32(sext(lo, 16));
    case 6: return hi == 0 ? 32 + __clz((int)lo) : __clz((int)hi);
    case 7: return lo == 0 ? 32 + ctz32(hi) : ctz32(lo);
    case 8: return __popc(lo) + __popc(hi);
    case 9: return (lo | hi) == 0;
    case 10: { u32 r = sext(lo, 8); return pack((i32)r, (i32)r >> 31); }
    case 11: { u32 r = sext(lo, 16); return pack((i32)r, (i32)r >> 31); }
    case 12: return pack((i32)lo, (i32)lo >> 31);
    case 13: return lo & 0x7FFFFFFFu;
    case 14: return lo ^ SIGN32;
    case 15: return canon32(bits32(ceilf(f32(lo))));
    case 16: return canon32(bits32(floorf(f32(lo))));
    case 17: return canon32(sign_fix32(bits32(truncf(f32(lo))), lo));
    case 18: return canon32(sign_fix32(bits32(rintf(f32(lo))), lo));
    case 19: return canon32(bits32(__fsqrt_rn(f32(lo))));
    case 20: return lo;
    case 21: return pack((i32)lo, (i32)lo >> 31);
    case 22: return lo;
    case 23: return alu1_trunc(w, true, true, true, false, trap);
    case 24: return alu1_trunc(w, true, true, false, false, trap);
    case 25: return alu1_trunc(w, true, true, true, true, trap);
    case 26: return alu1_trunc(w, true, true, false, true, trap);
    case 27: return bits32(__int2float_rn((int)lo));
    case 28: return bits32(__uint2float_rn(lo));
    case 29: return lo;
    case 30: return lo;
    case 31: return (lo | hi) == 0;
    case 32: return w & ~SIGN64;
    case 33: return w ^ SIGN64;
    case 34: return canon64(bits64(ceil(f64(w))));
    case 35: return canon64(bits64(floor(f64(w))));
    case 36: return canon64(bits64(trunc(f64(w))));
    case 37: return canon64(bits64(rint(f64(w))));
    case 38: return canon64(bits64(__dsqrt_rn(f64(w))));
    case 39: return f64_to_f32(w);
    case 40: return f32_to_f64(lo);
    case 41: return w;
    case 42: return w;
    case 43: return bits64((double)(i32)lo);
    case 44: return bits64((double)lo);
    case 45: return bits64(__ll2double_rn((long long)w));
    case 46: return bits64(__ull2double_rn((unsigned long long)w));
    case 47: return f32_from_i64(w, true);
    case 48: return f32_from_i64(w, false);
    case 49: return alu1_trunc(w, false, true, true, false, trap);
    case 50: return alu1_trunc(w, false, true, false, false, trap);
    case 51: return alu1_trunc(w, true, false, true, false, trap);
    case 52: return alu1_trunc(w, true, false, false, false, trap);
    case 53: return alu1_trunc(w, false, false, true, false, trap);
    case 54: return alu1_trunc(w, false, false, false, false, trap);
    case 55: return alu1_trunc(w, false, true, true, true, trap);
    case 56: return alu1_trunc(w, false, true, false, true, trap);
    case 57: return alu1_trunc(w, true, false, true, true, trap);
    case 58: return alu1_trunc(w, true, false, false, true, trap);
    case 59: return alu1_trunc(w, false, false, true, true, trap);
    default: return alu1_trunc(w, false, false, false, true, trap);  // 60
  }
}

// ---------------------------------------------------------------------------
// v128 (B7): batch/simdops.py's ops on four-word cells
// ---------------------------------------------------------------------------
struct V4 {
  u32 w[4];
};

__device__ __forceinline__ u64 pair64(const V4& x, int k) {
  return ((u64)x.w[k + 1] << 32) | x.w[k];
}
__device__ __forceinline__ void set_pair(V4& r, int k, u64 v) {
  r.w[k] = (u32)v;
  r.w[k + 1] = (u32)(v >> 32);
}
// word k of x for a lane index known only at run time (a select chain,
// so that x stays in registers)
__device__ __forceinline__ u32 pick(const V4& x, int k) {
  return k == 3 ? x.w[3] : k == 2 ? x.w[2] : k == 1 ? x.w[1] : x.w[0];
}
// element e of a word: byte (bits 8) or half (bits 16), sign-extended or not
__device__ __forceinline__ i32 elem(u32 w, int bits, int e, bool sgn) {
  const u32 v = (w >> (bits * e)) & ((1u << bits) - 1u);
  return sgn ? (i32)sext(v, bits) : (i32)v;
}
__device__ __forceinline__ i32 sat(i32 v, i32 lo, i32 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// 0/1 -> an all-ones 32-bit element mask
__device__ __forceinline__ u32 mask32(bool c) { return c ? 0xFFFFFFFFu : 0u; }

// A 16-byte select from the 32 bytes of (x, y) (or the 16 of x when
// `swz`): output byte j of word k is source byte m_j, the j-th byte of
// mask word mk, and 0 when m_j is out of range.  __byte_perm picks from
// each aligned 8-byte pair with the selectors' low 3 bits; the pair a
// byte comes from is m_j >> 3.
__device__ __forceinline__ u32 shuffle_word(const V4& x, const V4& y, u32 mk,
                                            bool swz) {
  const u32 nib = (mk & 7u) | ((mk >> 4) & 0x70u) | ((mk >> 8) & 0x700u) |
                  ((mk >> 12) & 0x7000u);
  const u32 q = (mk >> 3) & 0x1F1F1F1Fu;
  u32 r = (__byte_perm(x.w[0], x.w[1], nib) & __vcmpeq4(q, 0u)) |
          (__byte_perm(x.w[2], x.w[3], nib) & __vcmpeq4(q, 0x01010101u));
  if (!swz)
    r |= (__byte_perm(y.w[0], y.w[1], nib) & __vcmpeq4(q, 0x02020202u)) |
         (__byte_perm(y.w[2], y.w[3], nib) & __vcmpeq4(q, 0x03030303u));
  return r;
}

// The ten integer comparisons of a family (eq ne lt_s lt_u gt_s gt_u le_s
// le_u ge_s ge_u) on a word of bytes or halves: an all-ones mask per true
// element.
__device__ __forceinline__ u32 cmp4(int c, u32 a, u32 b) {
  switch (c) {
    case 0: return __vcmpeq4(a, b);
    case 1: return __vcmpne4(a, b);
    case 2: return __vcmplts4(a, b);
    case 3: return __vcmpltu4(a, b);
    case 4: return __vcmpgts4(a, b);
    case 5: return __vcmpgtu4(a, b);
    case 6: return __vcmples4(a, b);
    case 7: return __vcmpleu4(a, b);
    case 8: return __vcmpges4(a, b);
    default: return __vcmpgeu4(a, b);
  }
}
__device__ __forceinline__ u32 cmp2(int c, u32 a, u32 b) {
  switch (c) {
    case 0: return __vcmpeq2(a, b);
    case 1: return __vcmpne2(a, b);
    case 2: return __vcmplts2(a, b);
    case 3: return __vcmpltu2(a, b);
    case 4: return __vcmpgts2(a, b);
    case 5: return __vcmpgtu2(a, b);
    case 6: return __vcmples2(a, b);
    case 7: return __vcmpleu2(a, b);
    case 8: return __vcmpges2(a, b);
    default: return __vcmpgeu2(a, b);
  }
}
__device__ __forceinline__ u32 cmp1(int c, u32 a, u32 b) {
  const i32 x = (i32)a, y = (i32)b;
  switch (c) {
    case 0: return mask32(a == b);
    case 1: return mask32(a != b);
    case 2: return mask32(x < y);
    case 3: return mask32(a < b);
    case 4: return mask32(x > y);
    case 5: return mask32(a > b);
    case 6: return mask32(x <= y);
    case 7: return mask32(a <= b);
    case 8: return mask32(x >= y);
    default: return mask32(a >= b);
  }
}

// one word of an i8x16 (bits 8) or i16x8 (bits 16) binary op, op being
// the offset in the family's list (add sub [mul] add_sat_s add_sat_u
// sub_sat_s sub_sat_u min_s min_u max_s max_u avgr_u, then i8x16's
// swizzle, then the comparisons)
__device__ __forceinline__ u32 v2_small(int op, u32 a, u32 b, bool i8) {
  if (i8) {
    switch (op) {
      case 0: return __vadd4(a, b);
      case 1: return __vsub4(a, b);
      case 2: return __vaddss4(a, b);
      case 3: return __vaddus4(a, b);
      case 4: return __vsubss4(a, b);
      case 5: return __vsubus4(a, b);
      case 6: return __vmins4(a, b);
      case 7: return __vminu4(a, b);
      case 8: return __vmaxs4(a, b);
      case 9: return __vmaxu4(a, b);
      case 10: return __vavgu4(a, b);
      default: return cmp4(op - 12, a, b);  // 11 (swizzle) is not per word
    }
  }
  switch (op) {
    case 0: return __vadd2(a, b);
    case 1: return __vsub2(a, b);
    case 2: return ((a * b) & 0xFFFFu) | (((a >> 16) * (b >> 16)) << 16);
    case 3: return __vaddss2(a, b);
    case 4: return __vaddus2(a, b);
    case 5: return __vsubss2(a, b);
    case 6: return __vsubus2(a, b);
    case 7: return __vmins2(a, b);
    case 8: return __vminu2(a, b);
    case 9: return __vmaxs2(a, b);
    case 10: return __vmaxu2(a, b);
    case 11: return __vavgu2(a, b);
    default: return cmp2(op - 12, a, b);
  }
}

__device__ __forceinline__ u32 v2_i32(int op, u32 a, u32 b) {
  switch (op) {
    case 0: return a + b;
    case 1: return a - b;
    case 2: return a * b;
    case 3: return (i32)a < (i32)b ? a : b;
    case 4: return a < b ? a : b;
    case 5: return (i32)a > (i32)b ? a : b;
    case 6: return a > b ? a : b;
    default: return cmp1(op - 7, a, b);
  }
}

__device__ __forceinline__ u64 v2_i64(int op, u64 a, u64 b) {
  const i64 x = (i64)a, y = (i64)b;
  switch (op) {
    case 0: return a + b;
    case 1: return a - b;
    case 2: return a * b;
    case 3: return a == b ? ~0ull : 0ull;
    case 4: return a != b ? ~0ull : 0ull;
    case 5: return x < y ? ~0ull : 0ull;
    case 6: return x > y ? ~0ull : 0ull;
    case 7: return x <= y ? ~0ull : 0ull;
    default: return x >= y ? ~0ull : 0ull;
  }
}

// f32x4 / f64x2: op is the offset in add sub mul div min max pmin pmax eq
// ne lt gt le ge; the scalar ALU numbers the same ops without pmin/pmax.
__device__ __forceinline__ u32 v2_f32(int op, u32 a, u32 b) {
  if (op == 6) return (u32)alu2_f32(9, b, a) ? b : a;  // pmin: b < a ? b : a
  if (op == 7) return (u32)alu2_f32(9, a, b) ? b : a;  // pmax: a < b ? b : a
  if (op < 6) return (u32)alu2_f32(op, a, b);
  return mask32(alu2_f32(op - 1, a, b) != 0);
}
__device__ __forceinline__ u64 v2_f64(int op, u64 a, u64 b) {
  if (op == 6) return alu2_f64(9, b, a) ? b : a;
  if (op == 7) return alu2_f64(9, a, b) ? b : a;
  if (op < 6) return alu2_f64(op, a, b);
  return alu2_f64(op - 1, a, b) != 0 ? ~0ull : 0ull;
}

// Binary v128 ops: x is the cell below the top, y the top.  A fused
// build's generated code calls v2_fn with its sub a literal, so that the
// op folds to its own few instructions on the V4 in registers; the per-op
// step calls v2_op, out of line, with the sub known at run time.
__device__ __forceinline__ V4 v2_fn(int sub, V4 x, V4 y) {
  V4 r;
  if (sub < V2_I8X16) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const u32 a = x.w[k], b = y.w[k];
      r.w[k] = sub == 0 ? a & b : sub == 1 ? a | b : sub == 2 ? a ^ b : a & ~b;
    }
  } else if (sub < V2_I32X4) {
    const bool i8 = sub < V2_I16X8;
    const int op = sub - (i8 ? V2_I8X16 : V2_I16X8);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.w[k] = i8 && op == 11 ? shuffle_word(x, x, y.w[k], true)
                              : v2_small(op, x.w[k], y.w[k], i8);
  } else if (sub < V2_I64X2) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.w[k] = v2_i32(sub - V2_I32X4, x.w[k], y.w[k]);
  } else if (sub < V2_F32X4) {
    set_pair(r, 0, v2_i64(sub - V2_I64X2, pair64(x, 0), pair64(y, 0)));
    set_pair(r, 2, v2_i64(sub - V2_I64X2, pair64(x, 2), pair64(y, 2)));
  } else if (sub < V2_F64X2) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.w[k] = v2_f32(sub - V2_F32X4, x.w[k], y.w[k]);
  } else if (sub < V2_NARROW) {
    set_pair(r, 0, v2_f64(sub - V2_F64X2, pair64(x, 0), pair64(y, 0)));
    set_pair(r, 2, v2_f64(sub - V2_F64X2, pair64(x, 2), pair64(y, 2)));
  } else if (sub < V2_NARROW + 2) {
    // i8x16.narrow_i16x8_{s,u}: the 16 signed halves of x then y,
    // saturated into bytes
    const bool sg = sub == V2_NARROW;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const u32 w0 = k < 2 ? x.w[2 * k] : y.w[2 * k - 4];
      const u32 w1 = k < 2 ? x.w[2 * k + 1] : y.w[2 * k - 3];
      u32 v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const i32 h = elem(e < 2 ? w0 : w1, 16, e & 1, true);
        v |= ((u32)sat(h, sg ? -128 : 0, sg ? 127 : 255) & 0xFFu) << (8 * e);
      }
      r.w[k] = v;
    }
  } else if (sub < V2_NARROW + 4) {
    // i16x8.narrow_i32x4_{s,u}: the 8 words of x then y into halves
    const bool sg = sub == V2_NARROW + 2;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const u32 w0 = k < 2 ? x.w[2 * k] : y.w[2 * k - 4];
      const u32 w1 = k < 2 ? x.w[2 * k + 1] : y.w[2 * k - 3];
      const i32 lo = sg ? -32768 : 0, hi = sg ? 32767 : 65535;
      r.w[k] = ((u32)sat((i32)w0, lo, hi) & 0xFFFFu) |
               ((u32)sat((i32)w1, lo, hi) << 16);
    }
  } else if (sub == V2_NARROW + 4) {
    // i16x8.q15mulr_sat_s
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u32 v = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const i32 p = elem(x.w[k], 16, e, true) * elem(y.w[k], 16, e, true);
        v |= ((u32)sat((p + 0x4000) >> 15, -32768, 32767) & 0xFFFFu)
             << (16 * e);
      }
      r.w[k] = v;
    }
  } else if (sub == V2_NARROW + 5) {
    // i32x4.dot_i16x8_s (the sum wraps)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.w[k] = (u32)(elem(x.w[k], 16, 0, true) * elem(y.w[k], 16, 0, true)) +
               (u32)(elem(x.w[k], 16, 1, true) * elem(y.w[k], 16, 1, true));
  } else {
    // extended multiplies: low or high half of the source elements
    const int op = sub - V2_EXTMUL;  // family * 4 + high * 2 + unsigned
    const bool sg = (op & 1) == 0, high = (op & 2) != 0;
    const int fam = op >> 2;  // 0: i16x8 <- i8, 1: i32x4 <- i16, 2: i64x2
    if (fam == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // result halves 2k, 2k + 1 <- source bytes 2k, 2k + 1 of the half
        const int src = (high ? 2 : 0) + (k >> 1), e0 = (k & 1) * 2;
        u32 v = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v |= ((u32)(elem(x.w[src], 8, e0 + e, sg) *
                      elem(y.w[src], 8, e0 + e, sg)) & 0xFFFFu) << (16 * e);
        r.w[k] = v;
      }
    } else if (fam == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int src = (high ? 2 : 0) + (k >> 1);
        r.w[k] = (u32)elem(x.w[src], 16, k & 1, sg) *
                 (u32)elem(y.w[src], 16, k & 1, sg);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const u32 a = x.w[(high ? 2 : 0) + k], b = y.w[(high ? 2 : 0) + k];
        const u64 a64 = sg ? (u64)(i64)(i32)a : (u64)a;
        const u64 b64 = sg ? (u64)(i64)(i32)b : (u64)b;
        set_pair(r, 2 * k, a64 * b64);
      }
    }
  }
  return r;
}
__device__ __noinline__ V4 v2_op(int sub, V4 x, V4 y) { return v2_fn(sub, x, y); }

// The ALU1 sub (image.py ALU1_SUB) of f32x4 / f64x2 op `op` of abs neg
// sqrt ceil floor trunc nearest.
__device__ __forceinline__ int a1_f32(int op) {
  return op == 0 ? 13 : op == 1 ? 14 : op == 2 ? 19 : 12 + op;
}
__device__ __forceinline__ int a1_f64(int op) {
  return op == 0 ? 32 : op == 1 ? 33 : op == 2 ? 38 : 31 + op;
}

// Unary v128 ops (v1_fn inline with a literal sub, v1_op out of line).
__device__ __forceinline__ V4 v1_fn(int sub, V4 x) {
  V4 r;
  int trap = 0;  // no op of this set traps
  if (sub == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = ~x.w[k];
  } else if (sub < 8) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const u32 a = x.w[k];
      switch (sub) {
        case 1: r.w[k] = __vabs4(a); break;  // wraps: 0x80 stays 0x80
        case 2: r.w[k] = __vneg4(a); break;
        case 3: {
          u32 v = a - ((a >> 1) & 0x55555555u);
          v = (v & 0x33333333u) + ((v >> 2) & 0x33333333u);
          r.w[k] = (v + (v >> 4)) & 0x0F0F0F0Fu;
          break;
        }
        case 4: r.w[k] = __vabs2(a); break;
        case 5: r.w[k] = __vneg2(a); break;
        case 6: r.w[k] = (i32)a < 0 ? 0u - a : a; break;
        default: r.w[k] = 0u - a; break;
      }
    }
  } else if (sub < V1_F32X4) {
#pragma unroll
    for (int k = 0; k < 4; k += 2) {
      const u64 v = pair64(x, k);
      set_pair(r, k, sub == 9 || (i64)v < 0 ? (u64)0 - v : v);
    }
  } else if (sub < V1_F64X2) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.w[k] = (u32)alu1(a1_f32(sub - V1_F32X4), x.w[k], trap);
  } else if (sub < V1_CONVERT) {
#pragma unroll
    for (int k = 0; k < 4; k += 2)
      set_pair(r, k, alu1(a1_f64(sub - V1_F64X2), pair64(x, k), trap));
  } else if (sub < V1_CONVERT + 4) {
    // i32x4.trunc_sat_f32x4_{s,u}, f32x4.convert_i32x4_{s,u}: per word
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.w[k] = (u32)alu1(25 + sub - V1_CONVERT, x.w[k], trap);
  } else if (sub < V1_CONVERT + 6 || sub == V1_CONVERT + 8) {
    // i32x4.trunc_sat_f64x2_{s,u}_zero, f32x4.demote_f64x2_zero
    const int a1 = sub == V1_CONVERT + 8 ? 39 : 55 + sub - (V1_CONVERT + 4);
    r.w[0] = (u32)alu1(a1, pair64(x, 0), trap);
    r.w[1] = (u32)alu1(a1, pair64(x, 2), trap);
    r.w[2] = r.w[3] = 0;
  } else if (sub < V1_EXTEND) {
    // f64x2.convert_low_i32x4_{s,u}, f64x2.promote_low_f32x4
    const int a1 = sub == V1_CONVERT + 9 ? 40 : 43 + sub - (V1_CONVERT + 6);
    set_pair(r, 0, alu1(a1, x.w[0], trap));
    set_pair(r, 2, alu1(a1, x.w[1], trap));
  } else if (sub < V1_EXTADD) {
    // extend_{low,high}_*_{s,u}: family * 4 + high * 2 + unsigned
    const int op = sub - V1_EXTEND;
    const bool sg = (op & 1) == 0, high = (op & 2) != 0;
    const int fam = op >> 2;
    const int base = high ? 2 : 0;
    if (fam == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const u32 w = x.w[base + (k >> 1)];
        const int e0 = (k & 1) * 2;
        r.w[k] = ((u32)elem(w, 8, e0, sg) & 0xFFFFu) |
                 ((u32)elem(w, 8, e0 + 1, sg) << 16);
      }
    } else if (fam == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        r.w[k] = (u32)elem(x.w[base + (k >> 1)], 16, k & 1, sg);
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const u32 w = x.w[base + k];
        r.w[2 * k] = w;
        r.w[2 * k + 1] = sg ? (u32)((i32)w >> 31) : 0u;
      }
    }
  } else {
    // extadd_pairwise: i16x8 <- byte pairs, i32x4 <- half pairs
    const int op = sub - V1_EXTADD;
    const bool sg = (op & 1) == 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const u32 w = x.w[k];
      if (op < 2)
        r.w[k] = ((u32)(elem(w, 8, 0, sg) + elem(w, 8, 1, sg)) & 0xFFFFu) |
                 ((u32)(elem(w, 8, 2, sg) + elem(w, 8, 3, sg)) << 16);
      else
        r.w[k] = (u32)(elem(w, 16, 0, sg) + elem(w, 16, 1, sg));
    }
  }
  return r;
}
__device__ __noinline__ V4 v1_op(int sub, V4 x) { return v1_fn(sub, x); }

// any_true, all_true (i8x16 i16x8 i32x4 i64x2), bitmask (the same four)
__device__ __forceinline__ u32 vtest_op(int sub, const V4& x) {
  const u32 a = x.w[0], b = x.w[1], c = x.w[2], d = x.w[3];
  switch (sub) {
    case 0: return (a | b | c | d) != 0;
    case 1:
      return (__vcmpeq4(a, 0u) | __vcmpeq4(b, 0u) | __vcmpeq4(c, 0u) |
              __vcmpeq4(d, 0u)) == 0;
    case 2:
      return (__vcmpeq2(a, 0u) | __vcmpeq2(b, 0u) | __vcmpeq2(c, 0u) |
              __vcmpeq2(d, 0u)) == 0;
    case 3: return a != 0 && b != 0 && c != 0 && d != 0;
    case 4: return (a | b) != 0 && (c | d) != 0;
    case 5: {
      u32 m = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          m |= ((x.w[k] >> (8 * e + 7)) & 1u) << (4 * k + e);
      return m;
    }
    case 6: {
      u32 m = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m |= (((x.w[k] >> 15) & 1u) << (2 * k)) |
             (((x.w[k] >> 31) & 1u) << (2 * k + 1));
      return m;
    }
    case 7:
      return (a >> 31) | ((b >> 31) << 1) | ((c >> 31) << 2) |
             ((d >> 31) << 3);
    default: return (b >> 31) | ((d >> 31) << 1);
  }
}

// shl, shr_s, shr_u of i8x16 i16x8 i32x4 i64x2 by n mod the element width
__device__ __forceinline__ V4 vshift_op(int sub, const V4& x, u32 n) {
  V4 r;
  const int fam = sub / 3, op = sub % 3;
  if (fam == 3) {
    const u32 c = n & 63;
#pragma unroll
    for (int k = 0; k < 4; k += 2) {
      const u64 v = pair64(x, k);
      set_pair(r, k, op == 0 ? v << c : op == 1 ? (u64)((i64)v >> c) : v >> c);
    }
    return r;
  }
  const int bits = 8 << fam;
  const u32 c = n & (bits - 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const u32 w = x.w[k];
    if (fam == 2) {
      r.w[k] = op == 0 ? w << c : op == 1 ? (u32)((i32)w >> c) : w >> c;
      continue;
    }
    u32 v = 0;
    const u32 m = (1u << bits) - 1u;
    for (int e = 0; e < 32 / bits; ++e) {
      const u32 u = (w >> (bits * e)) & m;
      const u32 s = op == 0 ? u << c
                  : op == 1 ? (u32)((i32)sext(u, bits) >> c) : u >> c;
      v |= (s & m) << (bits * e);
    }
    r.w[k] = v;
  }
  return r;
}

// i8x16 i16x8 i32x4 i64x2 f32x4 f64x2 .splat of the scalar cell v
__device__ __forceinline__ V4 vsplat_op(int sub, u64 v) {
  const u32 lo = (u32)v, hi = (u32)(v >> 32);
  if (sub == 3 || sub == 5) return V4{{lo, hi, lo, hi}};
  const u32 w = sub == 0 ? (lo & 0xFFu) * 0x01010101u
              : sub == 1 ? (lo & 0xFFFFu) * 0x00010001u : lo;
  return V4{{w, w, w, w}};
}

// i8x16 s/u, i16x8 s/u, i32x4, i64x2, f32x4, f64x2 .extract_lane
__device__ __forceinline__ u64 vextract_op(int sub, const V4& x, int lane) {
  if (sub < 4) {
    const int bits = sub < 2 ? 8 : 16, per = 32 / bits;
    return cell32((u32)elem(pick(x, lane / per), bits, lane % per,
                            (sub & 1) == 0));
  }
  if (sub == 4 || sub == 6) return cell32(pick(x, lane));
  return lane == 0 ? pair64(x, 0) : pair64(x, 2);
}

// i8x16 i16x8 i32x4 i64x2 f32x4 f64x2 .replace_lane with the scalar v
__device__ __forceinline__ V4 vreplace_op(int sub, const V4& x, int lane,
                                          u64 v) {
  V4 r = x;
  if (sub == 3 || sub == 5) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (lane == k) set_pair(r, 2 * k, v);
    return r;
  }
  const int bits = sub == 0 ? 8 : sub == 1 ? 16 : 32, per = 32 / bits;
  const u32 sh = (u32)(bits * (lane % per));
  const u32 m = (bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u) << sh;
  const u32 val = ((u32)v << sh) & m;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (lane / per == k) r.w[k] = (x.w[k] & ~m) | val;
  return r;
}

// ---------------------------------------------------------------------------
// The interpreter
// ---------------------------------------------------------------------------
// Rows [0, n) of one lane's column from src (stride ss words) to dst
// (stride ds), up to 16 loads in flight.  Out of line: it runs at a
// launch's entry and exit and at B3's snapshots, and the dispatch loop
// keeps its registers.
__device__ __noinline__ void copy_rows(i32* dst, int ds, const i32* src,
                                       int ss, int n) {
  constexpr int kGroup = 16;
  int r = 0;
  for (; r + kGroup <= n; r += kGroup) {
    i32 v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) v[k] = src[(size_t)(r + k) * ss];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) dst[(size_t)(r + k) * ds] = v[k];
  }
  for (; r < n; ++r) dst[(size_t)r * ds] = src[(size_t)r * ss];
}

// Access to one lane's value stack, rows clamped into the plane as the
// reference's gathers and scatters clamp them.  The lowest R rows of each
// stack plane (lo and hi, and e2 and e3 with kSimd) live in the block's
// dynamic shared memory for the whole launch, as the Pallas kernel keeps
// a lane block's stack in VMEM scratch (pallas_engine.py :805-815): word
// (row r, plane k) of this thread at sm[r * kRow + k * kPlane], so a
// cell's words sit at fixed offsets from one address and the threads of
// a warp touch distinct banks whatever rows they use (two planes: a
// stripe of 32 words per plane; kSimd: a cell's four words side by side,
// one 16-byte access (LDS.128 / STS.128), the warp's 512 bytes of a row
// contiguous; on an H100 about 5 % faster on vloop(1e6) x 4096 in blocks
// than four stripes 128 B apart, PERF.md).  Rows at or
// above R stay in the [D, L] planes in global memory, where one compare
// picks the place; a build for depths that fit wholly on chip
// (kStackSplit false) compiles neither.  `enter` loads the rows below the lane's sp (the rows a
// launch can read before it writes them: a push writes its row, a call
// zeroes its locals); the dispatch loop `note`s the sp after every
// instruction (with a fuel trap, the sp the instruction would have left),
// above which it never writes, so rows [0, hw) hold every row it wrote
// and no row it neither loaded nor wrote; `leave` writes them back, and
// the planes after a launch hold what the global-memory kernel leaves,
// dead rows included.  Holds copies of the pointers (never a reference to
// the kernel parameters, so they stay in the constant bank).  With kSimd
// a stack cell is four words (lo, hi, e2, e3) and `Cell` is the whole
// cell; without it, 64 bits.
template <bool kSimd>
struct Lane {
  static constexpr int kPlanes = kSimd ? 4 : 2;
  static constexpr int kRow = kPlanes * BLOCK_THREADS;  // words a row
  // word (row r, plane k) of this thread at sm[r * kRow + k * kPlane],
  // this thread's row 0 at kLaneWords * threadIdx.x
  static constexpr int kPlane = kSimd ? 1 : BLOCK_THREADS;
  static constexpr int kLaneWords = kSimd ? kPlanes : 1;
  i32* lo;
  i32* hi;
  i32* e2;
  i32* e3;
  i32* sm;  // this thread's word of on-chip row 0, plane 0
  int L, D, lane, R;
  mutable int hw;  // on-chip rows [0, hw) to write back
  using Cell = typename std::conditional<kSimd, V4, u64>::type;

  // a [rows, L] plane's index of this lane's row (frames, globals)
  __device__ __forceinline__ size_t at(int row, int rows) const {
    return (size_t)clampi(row, 0, rows - 1) * (size_t)L + (size_t)lane;
  }
  __device__ __forceinline__ i32* plane(int k) const {
    return k == 0 ? lo : k == 1 ? hi : k == 2 ? e2 : e3;
  }
  __device__ __forceinline__ void note(int sp) const { hw = max(hw, sp); }
  __device__ __forceinline__ u64 get(int row) const {
    const int r = clampi(row, 0, D - 1);
    if (!kStackSplit || r < R) {
      const i32* w = sm + r * kRow;
      return pack(w[0], w[kPlane]);
    }
    const size_t i = (size_t)r * (size_t)L + (size_t)lane;
    return pack(lo[i], hi[i]);
  }
  // a scalar write: zeroes e2 and e3 of a four-word cell
  __device__ __forceinline__ void put(int row, u64 v) const {
    const int r = clampi(row, 0, D - 1);
    if (!kStackSplit || r < R) {
      i32* w = sm + r * kRow;
      if constexpr (kSimd) {
        *reinterpret_cast<uint4*>(w) = make_uint4((u32)v, (u32)(v >> 32), 0u, 0u);
      } else {
        w[0] = lo32(v);
        w[kPlane] = hi32(v);
      }
      return;
    }
    const size_t i = (size_t)r * (size_t)L + (size_t)lane;
    lo[i] = lo32(v);
    hi[i] = hi32(v);
    if constexpr (kSimd) {
      e2[i] = 0;
      e3[i] = 0;
    }
  }
  // the four-word cell; a two-plane stack (no v128 op in the image, so
  // the per-op step's v128 code it is compiled into is never reached)
  // reads and writes lo and hi
  __device__ __forceinline__ V4 get4(int row) const {
    if constexpr (!kSimd) {
      const u64 v = get(row);
      return V4{{(u32)v, (u32)(v >> 32), 0u, 0u}};
    }
    const int r = clampi(row, 0, D - 1);
    if (!kStackSplit || r < R) {
      const uint4 c = *reinterpret_cast<const uint4*>(sm + r * kRow);
      return V4{{c.x, c.y, c.z, c.w}};
    }
    const size_t i = (size_t)r * (size_t)L + (size_t)lane;
    return V4{{(u32)lo[i], (u32)hi[i], (u32)e2[i], (u32)e3[i]}};
  }
  __device__ __forceinline__ void put4(int row, const V4& v) const {
    if constexpr (!kSimd) {
      put(row, (u64)v.w[0] | ((u64)v.w[1] << 32));
      return;
    }
    const int r = clampi(row, 0, D - 1);
    if (!kStackSplit || r < R) {
      *reinterpret_cast<uint4*>(sm + r * kRow) =
          make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
      return;
    }
    const size_t i = (size_t)r * (size_t)L + (size_t)lane;
    lo[i] = (i32)v.w[0];
    hi[i] = (i32)v.w[1];
    e2[i] = (i32)v.w[2];
    e3[i] = (i32)v.w[3];
  }
  // moves: the whole cell
  __device__ __forceinline__ Cell getc(int row) const {
    if constexpr (kSimd) return get4(row); else return get(row);
  }
  __device__ __forceinline__ void putc(int row, const Cell& v) const {
    if constexpr (kSimd) put4(row, v); else put(row, v);
  }
  // the launch's entry: the on-chip rows below sp from the planes
  __device__ __forceinline__ void enter(int sp) const {
    const int n = min(clampi(sp, 0, D), R);
    for (int k = 0; k < kPlanes; ++k)
      copy_rows(sm + k * kPlane, kRow, plane(k) + lane, L, n);
  }
  // the launch's exit: on-chip rows [0, hw) back to the planes
  __device__ __forceinline__ void leave() const {
    const int n = min(hw, R);
    for (int k = 0; k < kPlanes; ++k)
      copy_rows(plane(k) + lane, L, sm + k * kPlane, kRow, n);
  }
  // rows [0, n) of every stack plane to (save) or from (restore) the
  // [D, L] shadow planes sh[k] of a B3 snapshot
  __device__ __forceinline__ void snap(i32* const (&sh)[4], int n,
                                       bool restore) const {
    const int nc = min(n, R);
    for (int k = 0; k < kPlanes; ++k) {
      i32* const s = sh[k] + lane;
      i32* const on = sm + k * kPlane;
      i32* const g = plane(k) + lane;
      const size_t off = (size_t)nc * L;
      if (restore) {
        copy_rows(on, kRow, s, L, nc);
        copy_rows(g + off, L, s + off, L, n - nc);
      } else {
        copy_rows(s, L, on, kRow, nc);
        copy_rows(s + off, L, g + off, L, n - nc);
      }
    }
    if (restore) note(n);
  }
};

}  // namespace

#include "memwin.cuh"
#include "optimistic.cuh"

namespace {

// ---------------------------------------------------------------------------
// Tier-0 host calls (WASM_TIER0): batch/tier0.py's functions and the
// reference SIMT step's handlers (engine.py:1309-1449), on one lane's
// columns.  They read and write the memory plane: with the window cache
// the caller has written the lane's windows back and dropped them first
// (as a bulk op does), so the plane is the lane's memory.  What bounds a
// call is bytes: the iovec, the payload and the record for fd_write, the
// bytes stored for the others.
// ---------------------------------------------------------------------------
constexpr int T0_NONE = 0;
constexpr int T0_CLOCK = 1;
constexpr int T0_RANDOM = 2;
constexpr int T0_YIELD = 3;
constexpr int T0_EXIT = 4;
constexpr int T0_FDWRITE = 5;
// tier0_call's outcome, in the high word of what it returns (the low
// word: the errno, or proc_exit's code)
constexpr int T0_RETIRED = 0;
constexpr int T0_EXITED = 1;
constexpr int T0_PARKED = 2;
constexpr u32 WASI_EFAULT = 21;  // host/wasi/wasi_abi.py Errno
constexpr int WASI_EINVAL = 28;

// t0_prng32: the counter-PRNG's avalanche
__device__ __forceinline__ u32 t0_prng32(u32 x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Word `row` (clamped into the plane) of the lane's memory column gets the
// bytes of `m` from v; nothing when m is 0.
__device__ __forceinline__ void t0_rmw(i32* mem, int L, int W, int lane,
                                       u32 row, u32 m, u32 v) {
  if (m == 0u) return;
  i32* c = mem + (size_t)(row < (u32)(W - 1) ? row : (u32)(W - 1)) * L + lane;
  *c = (i32)(((u32)*c & ~m) | (v & m));
}

__device__ __forceinline__ u32 t0_word(const i32* mem, int L, int W, int lane,
                                       u32 row) {
  return (u32)mem[(size_t)(row < (u32)(W - 1) ? row : (u32)(W - 1)) * L + lane];
}

// t0_masked_store: 4 or 8 bytes of val at byte address ea (in bounds)
__device__ __forceinline__ void t0_store(i32* mem, int L, int W, int lane,
                                         u32 ea, u64 val, bool eight) {
  const u32 row = ea >> 2, sh = (ea & 3u) * 8u;
  const u64 full = eight ? ~0ull : 0xFFFFFFFFull;
  const u64 m01 = full << sh, v01 = (val & full) << sh;
  t0_rmw(mem, L, W, lane, row, (u32)m01, (u32)v01);
  t0_rmw(mem, L, W, lane, row + 1u, (u32)(m01 >> 32), (u32)(v01 >> 32));
  if (sh != 0u)
    t0_rmw(mem, L, W, lane, row + 2u, (u32)(full >> (64u - sh)),
           (u32)((val & full) >> (64u - sh)));
}

// One lane's tier-0 call of kind `kind` with its first four argument
// cells' low words a0..a3 and its memory's size in bytes.  Returns
// (T0_RETIRED, errno), (T0_EXITED, code) or (T0_PARKED, 0) as
// (outcome << 32) | word.  Out of line: only stubs reach it, and the
// dispatch loop keeps its registers.
__device__ __noinline__ u64 tier0_call(const T0Args t0, i32* mem, int L, int W,
                                       int lane, int kind, u32 a0, u32 a1,
                                       u32 a2, u32 a3, u32 mem_bytes) {
  constexpr u64 kPark = (u64)T0_PARKED << 32;
  i32* const ctr = t0.ctr + lane;  // count r at ctr[r * L]
  switch (kind) {
    case T0_CLOCK: {
      // clock_time_get(id, precision, *time): the time base of the id's
      // clock plus the lane's clock calls so far; the cputime ids park
      if (a0 == 2u || a0 == 3u) return kPark;
      if (a0 > 3u) return (u64)WASI_EINVAL;
      const u32 tend = a2 + 8u;
      if (tend < a2 || mem_bytes < tend) return (u64)WASI_EFAULT;
      const i32 c = ctr[0];
      const u64 base = a0 == 1u ? pack(t0.mono_lo, t0.mono_hi)
                                : pack(t0.rt_lo, t0.rt_hi);
      t0_store(mem, L, W, lane, a2, base + (u64)(u32)c, true);
      ctr[0] = c + 1;
      return 0;
    }
    case T0_RANDOM: {
      // random_get(*buf, len): the counter-PRNG's words of (seed, lane,
      // call), shifted to the buffer's byte offset, byte-masked at both
      // edges (t0_random_fill); a request above the limit parks
      if ((u32)(t0.rmax_w * 4) < a1) return kPark;
      const u32 rend = a0 + a1;
      if (rend < a0 || mem_bytes < rend) return (u64)WASI_EFAULT;
      if (a1 == 0u) return 0;
      const i32 c = ctr[L];
      const u32 seq = t0_prng32((u32)t0.seed ^ (((u32)lane + 1u) * 0x9E3779B9u)) ^
                      ((u32)c * 0x85EBCA6Bu);
      const u32 shb = (a0 & 3u) * 8u, w0 = a0 >> 2;
      u32 prev = 0u;
      for (int j = 0; j <= t0.rmax_w; ++j) {
        const u32 row = w0 + (u32)j;
        if ((u64)row * 4u >= (u64)rend) break;  // no byte of it is the buffer's
        const u32 pw = j < t0.rmax_w ? t0_prng32(seq ^ ((u32)j * 0x27220A95u)) : 0u;
        const u32 v = (pw << shb) | (shb != 0u ? prev >> (32u - shb) : 0u);
        u32 mk = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const u32 ba = row * 4u + (u32)b;
          if (ba >= a0 && ba < rend) mk |= 0xFFu << (8 * b);
        }
        t0_rmw(mem, L, W, lane, row, mk, v);
        prev = pw;
      }
      ctr[L] = c + 1;
      return 0;
    }
    case T0_YIELD:
      ctr[3 * L] += 1;
      return 0;
    case T0_EXIT:
      ctr[3 * L] += 1;
      return ((u64)T0_EXITED << 32) | a0;
    case T0_FDWRITE: {
      // fd_write(fd, *iovs, iovs_len, *nwritten): one aligned iovec to fd
      // 1 or 2 whose record fits the lane's buffer; the record is a
      // header (fd << 28 | len) and the payload padded to words, read
      // from the guest's bytes at any offset before nwritten is stored
      const u32 iov_end = a1 + 8u;
      const bool iov_ok = !(iov_end < a1 || mem_bytes < iov_end);
      const u32 wbuf = t0_word(mem, L, W, lane, a1 >> 2);
      const u32 wlen = t0_word(mem, L, W, lane, (a1 >> 2) + 1u);
      const u32 nwords = (wlen + 3u) >> 2;
      const i32 off = t0.so_off[lane];
      const u32 npend = a3 + 4u;
      if (!((a0 == 1u || a0 == 2u) && a2 == 1u && (a1 & 3u) == 0u && iov_ok &&
            wlen <= (u32)(t0.wmax_w * 4) &&
            (u32)off + 1u + nwords <= (u32)t0.sw &&
            !(npend < a3 || mem_bytes < npend)))
        return kPark;
      const u32 dend = wbuf + wlen;
      if (dend < wbuf || mem_bytes < dend) return (u64)WASI_EFAULT;
      i32* const rec = t0.so_buf + (size_t)off * L + lane;
      rec[0] = (i32)(wlen | (a0 << 28));
      const u32 shb = (wbuf & 3u) * 8u, w0 = wbuf >> 2;
      u32 s0 = t0_word(mem, L, W, lane, w0);
      for (u32 j = 0; j < nwords; ++j) {
        const u32 s1 = t0_word(mem, L, W, lane, w0 + j + 1u);
        rec[(size_t)(j + 1u) * L] = (i32)(shb != 0u ? (s0 >> shb) | (s1 << (32u - shb)) : s0);
        s0 = s1;
      }
      t0_store(mem, L, W, lane, a3, wlen, false);
      t0.so_off[lane] = off + 1 + (i32)nwords;
      ctr[2 * L] += 1;
      return 0;
    }
    default:
      return kPark;
  }
}

// What n instructions from pc cost: n, or (WASM_GAS) the sum of their
// weights, from the running sum (wrapping, as the int32 sums of the plain
// version).
__device__ __forceinline__ int gas_run(const Params& p, int pc, int n) {
  if constexpr (kGas)
    return (int)((u32)__ldg(&p.a3.gcum[pc + n]) - (u32)__ldg(&p.a3.gcum[pc]));
  else
    return n;
}

// ---------------------------------------------------------------------------
// Tables and segments (WASM_TABLES): the reference SIMT step's handlers
// (engine.py:1156-1307), on one lane's columns.
// ---------------------------------------------------------------------------
#if WASM_TABLES
// The stack change of each table and segment handler (H_A3_BASE on):
// get, set, size, grow, fill, copy, init, elem.drop, memory.init,
// data.drop, the two tail calls (not used: the call case sets sp) and
// ref.func.
__device__ __forceinline__ int a3_sp_delta(int h) {
  constexpr int kDelta[13] = {0, -2, 1, -1, -3, -3, -3, 0, -3, 0, 0, 0, 1};
  return kDelta[h - H_A3_BASE];
}

// The handlers that write the table, its size, a dropped flag or memory
// from a data segment: a warp-leader commits and is off before them.
__device__ __forceinline__ bool a3_writes(int h) {
  return h >= H_TABLE_SET && h <= H_DATA_DROP && h != H_TABLE_SIZE;
}

// Bytes [dst, end) of one lane's memory column from the data segment
// bytes at sb on (byte k at byte k % 4 of words[k / 4]), byte by byte;
// rows beyond the plane are not written.
__device__ __noinline__ void mem_init_walk(i32* mem, int L, int W, int lane,
                                           u32 dst, u32 end, u32 sb,
                                           const i32* __restrict__ words,
                                           int nw) {
  const int w0 = (int)(dst >> 2), w1 = (int)((end - 1u) >> 2);
  const int wlast = w1 < W - 1 ? w1 : W - 1;
  for (int r = w0; r <= wlast; ++r) {
    u32 mk = 0u, v = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const u32 ba = (u32)r * 4u + (u32)b;
      if (ba >= dst && ba < end) {
        const u32 k = ba - dst + sb;
        const u32 wi = k >> 2;
        const u32 wv = (u32)__ldg(&words[wi < (u32)(nw - 1) ? wi : (u32)(nw - 1)]);
        mk |= 0xFFu << (8 * b);
        v |= ((wv >> ((k & 3u) * 8u)) & 0xFFu) << (8 * b);
      }
    }
    i32* const c = mem + (size_t)r * L + lane;
    *c = (i32)(((u32)*c & ~mk) | (v & mk));
  }
}

// One table or segment instruction h (not a tail call) of one lane, with
// its immediates a, b (the table size, or table.grow's capacity) and c
// (the table's base row), the lane's sp and memory size in bytes; returns
// its trap code.  The stack change is a3_sp_delta's; memory.init's
// caller has written the lane's windows back and dropped them.  Out of
// line: the dispatch loop keeps its registers.
template <bool kSimd>
__device__ __noinline__ int a3_step(const A3Args t, const Lane<kSimd> s,
                                    const i32* __restrict__ tbl, int ntbl,
                                    i32* mem, int W, int h, int a, int b,
                                    int c, int sp, u32 mem_bytes) {
  const int L = s.L, lane = s.lane, T = t.tcap;
  const u32 size = t.tsize ? (u32)t.tsize[lane] : (u32)b;
  i32* const col = t.tab ? t.tab + lane : nullptr;  // row r at col[r * L]
  switch (h) {
    case H_TABLE_GET: {
      const i32 i = (i32)s.get(sp - 1);
      if (!((u32)i < size)) return E_TABLE_OOB;
      const i32 v = col ? col[(size_t)clampi(c + i, 0, T - 1) * L]
                        : __ldg(&tbl[clampi(c + i, 0, ntbl - 1)]);
      s.put(sp - 1, cell32((u32)v));
      return 0;
    }
    case H_TABLE_SET: {
      const i32 i = (i32)s.get(sp - 2);
      if (!((u32)i < size)) return E_TABLE_OOB;
      col[(size_t)clampi(c + i, 0, T - 1) * L] = (i32)s.get(sp - 1);
      return 0;
    }
    case H_TABLE_SIZE:
      s.put(sp, cell32(size));
      return 0;
    case H_TABLE_GROW: {
      // delta on top, the init ref below; b is the capacity
      const i32 delta = (i32)s.get(sp - 1), init = (i32)s.get(sp - 2);
      const i32 sz = (i32)size, nsz = (i32)(size + (u32)delta);
      const bool ok = delta >= 0 && nsz >= sz && !((u32)b < (u32)nsz);
      s.put(sp - 2, cell32(ok ? size : 0xFFFFFFFFu));
      if (ok) {
        for (int r = max(c + sz, 0); r < min(c + nsz, T); ++r)
          col[(size_t)r * L] = init;
        t.tsize[lane] = nsz;
      }
      return 0;
    }
    case H_TABLE_FILL:
    case H_TABLE_COPY:
    case H_TABLE_INIT: {
      // n on top, then the value (fill) or source, then the first row
      const u32 n = (u32)s.get(sp - 1), v = (u32)s.get(sp - 2);
      const u32 dst = (u32)s.get(sp - 3), dend = dst + n;
      u32 slimit = size, soff = 0u;
      if (h == H_TABLE_INIT) {
        const int k = clampi(a, 0, t.n_elem - 1);
        const bool dropped = t.edrop && t.edrop[(size_t)k * L + lane] != 0;
        slimit = dropped ? 0u : (u32)__ldg(&t.elen[k]);
        soff = (u32)__ldg(&t.eoff[k]);
      }
      const bool oob = dend < dst || size < dend ||
                       (h != H_TABLE_FILL && (v + n < v || slimit < v + n));
      if (oob) return E_TABLE_OOB;
      const int d0 = c + (i32)dst, s0 = c + (i32)v;
      if (h == H_TABLE_FILL) {
        for (u32 k = 0; k < n; ++k) col[(size_t)clampi(d0 + (int)k, 0, T - 1) * L] = (i32)v;
      } else if (h == H_TABLE_INIT) {
        for (u32 k = 0; k < n; ++k)
          col[(size_t)clampi(d0 + (int)k, 0, T - 1) * L] =
              __ldg(&t.efl[clampi((int)(soff + v + k), 0, t.n_efl - 1)]);
      } else if (d0 > s0) {
        // overlap-safe: a row is read before the walk writes it
        for (u32 k = n; k-- > 0u;)
          col[(size_t)clampi(d0 + (int)k, 0, T - 1) * L] =
              col[(size_t)clampi(s0 + (int)k, 0, T - 1) * L];
      } else {
        for (u32 k = 0; k < n; ++k)
          col[(size_t)clampi(d0 + (int)k, 0, T - 1) * L] =
              col[(size_t)clampi(s0 + (int)k, 0, T - 1) * L];
      }
      return 0;
    }
    case H_ELEM_DROP:
      t.edrop[(size_t)clampi(a, 0, t.n_elem - 1) * L + lane] = 1;
      return 0;
    case H_DATA_DROP:
      t.ddrop[(size_t)clampi(a, 0, t.n_data - 1) * L + lane] = 1;
      return 0;
    case H_MEMINIT: {
      // n on top, then the source offset in the segment, then dst
      const u32 n = (u32)s.get(sp - 1), src = (u32)s.get(sp - 2);
      const u32 dst = (u32)s.get(sp - 3);
      const int k = clampi(a, 0, t.n_data - 1);
      const bool dropped = t.ddrop[(size_t)k * L + lane] != 0;
      const u32 slen = dropped ? 0u : (u32)__ldg(&t.dlen[k]);
      const u32 send = src + n, dend = dst + n;
      if (send < src || slen < send || dend < dst || mem_bytes < dend)
        return E_MEM_OOB;  // nothing written
      if (n != 0u)
        mem_init_walk(mem, L, W, lane, dst, dend,
                      (u32)__ldg(&t.doff[k]) + src, t.dwords, t.n_dwords);
      return 0;
    }
    case H_REFFUNC:
      s.put(sp, cell32((u32)(a + 1)));
      return 0;
    default:
      return E_EXEC_FAILED;
  }
}
#endif  // WASM_TABLES

// memory.fill (copy = false, v = the fill byte) or memory.copy (copy =
// true, v = the source address) of bytes [dst, end) in one lane's column,
// end > dst, both ranges already bounds-checked.  Words are masked at the
// two byte edges; rows beyond the plane are not written and source rows
// are clamped into it, as laneops.plane_fill_copy does.  Each group of up
// to BULK_GROUP words reads every source word before it writes any: a
// forward copy (src > dst) reads words at or above the ones it writes, a
// backward copy (dst > src) words at or below them, and words already
// written lie behind the walk, so every source byte is read before it is
// overwritten (memmove).  The per-lane walk: a lane alone in its group
// (below), or a warp with fewer than 8 threads at the op.
constexpr int BULK_GROUP = 16;

__device__ __noinline__ void bulk_fill_copy(i32* mem, int L, int W, int lane,
                                            u32 dst, u32 end, u32 v,
                                            bool copy) {
  const int w0 = (int)(dst >> 2), w1 = (int)((end - 1u) >> 2);
  const int wlast = w1 < W - 1 ? w1 : W - 1;
  if (w0 > wlast) return;
  const u32 head = 0xFFFFFFFFu << ((dst & 3u) * 8u);
  const u32 tail = 0xFFFFFFFFu >> ((3u - ((end - 1u) & 3u)) * 8u);
  const u32 fill = (v & 0xFFu) * 0x01010101u;
  const i32 delta = (i32)(v - dst);
  const bool backward = copy && delta < 0;
  const int nwords = wlast - w0 + 1;
  for (int done = 0; done < nwords; done += BULK_GROUP) {
    u32 val[BULK_GROUP];
#pragma unroll
    for (int j = 0; j < BULK_GROUP; ++j) {
      const int k = done + j;
      val[j] = fill;
      if (copy && k < nwords) {
        const int w = backward ? wlast - k : w0 + k;
        const i32 a0 = (i32)((u32)w * 4u + (u32)delta);
        const int swi = a0 >> 2;  // arithmetic: rounds toward -inf
        const u32 sh = (u32)(a0 & 3) * 8u;
        const u32 s0 = (u32)mem[(size_t)clampi(swi, 0, W - 1) * L + lane];
        if (sh == 0) {
          val[j] = s0;
        } else {
          const u32 s1 = (u32)mem[(size_t)clampi(swi + 1, 0, W - 1) * L + lane];
          val[j] = (s0 >> sh) | (s1 << (32u - sh));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BULK_GROUP; ++j) {
      const int k = done + j;
      if (k >= nwords) break;
      const int w = backward ? wlast - k : w0 + k;
      u32 m = 0xFFFFFFFFu;
      if (w == w0) m &= head;
      if (w == w1) m &= tail;
      i32* cell = &mem[(size_t)w * L + lane];
      *cell = m == 0xFFFFFFFFu ? (i32)val[j]
                               : (i32)(((u32)*cell & ~m) | (val[j] & m));
    }
  }
}

// The warp-cooperative row pass (h_memfill / h_memcopy's row form,
// pallas_engine.py :1389-1518).  The lanes of a warp that are at a bulk
// op together (__activemask) form groups as the reference's agree rule
// does (:1459-1468): every fill is one group, each lane with its own dst,
// end and byte; copies group by src - dst (__match_any_sync), one pass per
// distinct delta; a lane out of bounds or with n == 0 joins none.  A pass
// walks the union of its lanes' rows, forward or backward by the sign of
// the delta as the per-lane walk does, with every present thread of the
// warp as a worker: a thread moves 16 bytes per access (4 adjacent lanes
// of one row, a "quad"; 8 threads cover the warp's 128-byte row), K rows
// of one quad per step, all of a step's source rows read (K + 1 of them:
// a shifted copy's second word is the next row's first) before a
// __syncwarp and its rows written after it.  Each lane's byte masks and
// fill byte apply per element; a word of a lane outside the group is never
// written (that lane may be running another path of the warp at the same
// time), so a quad that is not whole in the group, or whose words are
// not all whole, is stored word by word, and a partial word byte by byte
// (no read of the old word).  Planes whose rows are not 16-byte aligned
// (L % 4 != 0) read word by word too.  Source reads of a step lie at or
// beyond its own rows in the walk's direction and every earlier step
// wrote rows behind it, so each source byte is read before it is
// overwritten, as in memmove.
//
// What bounds it is bytes; with one warp per block (BLOCK_THREADS) each
// SM runs one warp, so the rows a step keeps in flight (K per thread,
// 32 threads) set how near the pass comes to the HBM rate.
constexpr int BULK_ROWS = 16;  // K: rows of one quad per thread per step

// Counts of the bulk ops since they were last read and cleared: warp
// passes, lanes that took one, and per-lane walks.
__device__ unsigned long long g_bulk_counts[3];

// The byte mask of the lane's word at row r, [w0, w1] its words.
__device__ __forceinline__ u32 bulk_mask(int r, int w0, int w1, u32 head,
                                         u32 tail) {
  if (r < w0 || r > w1) return 0u;
  u32 m = 0xFFFFFFFFu;
  if (r == w0) m &= head;
  if (r == w1) m &= tail;
  return m;
}

// Words j of a quad that are in `qb` (all four as one 16-byte access when
// `vec`) from the row starting at q.
__device__ __forceinline__ void bulk_load(const i32* q, unsigned qb, bool vec,
                                          u32 (&out)[4]) {
  if (vec) {
    const int4 v = *reinterpret_cast<const int4*>(q);
    out[0] = (u32)v.x;
    out[1] = (u32)v.y;
    out[2] = (u32)v.z;
    out[3] = (u32)v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = (qb >> j) & 1u ? (u32)q[j] : 0u;
}

// The quad's words under their masks: one 16-byte store when all four
// are whole and in the group, else word by word, a partial word byte by
// byte, a word outside the group or its lane's range not at all.
__device__ __forceinline__ void bulk_store(i32* q, unsigned qb, bool vec,
                                           const u32 (&val)[4],
                                           const u32 (&m)[4]) {
  if (vec && qb == 15u && (m[0] & m[1] & m[2] & m[3]) == 0xFFFFFFFFu) {
    *reinterpret_cast<int4*>(q) =
        make_int4((int)val[0], (int)val[1], (int)val[2], (int)val[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (m[j] == 0u) continue;
    if (m[j] == 0xFFFFFFFFu) {
      q[j] = (i32)val[j];
      continue;
    }
    unsigned char* b = reinterpret_cast<unsigned char*>(q + j);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if ((m[j] >> (8 * k)) & 0xFFu) b[k] = (unsigned char)(val[j] >> (8 * k));
  }
}

// One pass over rows [R0, R1] of the warp's columns for the lanes in
// `grp` (kMode 0: fill; 1: copy by a delta d that is a multiple of 4; 2:
// copy by any other d), run by every thread of `act` (at least 8);
// tab[0..2][t]: lane t's dst, end and fill value or source.  A step whose
// K rows of the quad lie whole inside the ranges of its lanes in the
// group, in a plane of 16-byte rows, with every source row inside the
// plane, runs as K plain 16-byte loads and 16-byte stores (4-byte stores
// of the group's words when the quad is not whole in the group) one row
// apart: the bulk of a long op.  Any other step goes row by row through
// the masks and clamps.
template <int kMode>
__device__ __noinline__ void bulk_rows(i32* mem, int L, int W, int wbase,
                                       unsigned act, unsigned grp, i32 d,
                                       int R0, int R1,
                                       const u32 (*tab)[BLOCK_THREADS]) {
  constexpr int K = BULK_ROWS;
  const int tid = threadIdx.x;
  const int rank = __popc(act & ((1u << tid) - 1u));
  const int G = __popc(act) >> 3;  // row groups of 8 workers
  const int q = rank & 7, g = rank >> 3;
  const unsigned qb = rank < 8 * G ? (grp >> (4 * q)) & 15u : 0u;
  const bool vec = ((size_t)mem & 15u) == 0 && (L & 3) == 0;
  const bool back = kMode != 0 && d < 0;
  const int dr = back ? -1 : 1;  // the walk's direction in rows
  const u32 sh = (u32)(d & 3) * 8u;
  int w0[4], w1[4];
  int wlo = INT_MIN, whi = INT_MAX;  // rows whole in the quad's group lanes
  u32 head[4], tail[4], fw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * q + j;
    const u32 dst = tab[0][t], end = tab[1][t];
    const bool in = (qb >> j) & 1u;
    w0[j] = in ? (int)(dst >> 2) : 1;
    w1[j] = in ? (int)((end - 1u) >> 2) : 0;  // w0 > w1: no row
    head[j] = 0xFFFFFFFFu << ((dst & 3u) * 8u);
    tail[j] = 0xFFFFFFFFu >> ((3u - ((end - 1u) & 3u)) * 8u);
    fw[j] = (tab[2][t] & 0xFFu) * 0x01010101u;
    wlo = max(wlo, in ? w0[j] + ((dst & 3u) != 0u) : INT_MIN);
    whi = min(whi, in ? w1[j] - ((end & 3u) != 0u) : INT_MAX);
  }
  i32* const col = mem + wbase + 4 * q;
  const size_t stride = back ? (size_t)0 - (size_t)L : (size_t)L;
  const int nrows = R1 - R0 + 1;
  for (int base = 0; base < nrows; base += G * K) {
    const int r0 = base + g * K;  // this thread's first row, in walk order
    const int rf = back ? R1 - r0 : R0 + r0;  // its row
    const int rl = rf + dr * (K - 1);
    // the source row of the first position (rows advance with the walk)
    const int sf = (i32)((u32)rf * 4u + (u32)d) >> 2;
    const bool whole = vec && qb != 0u && r0 + K <= nrows &&
                       min(rf, rl) >= wlo && max(rf, rl) <= whi &&
                       (kMode == 0 || (min(sf, sf + dr * K) >= 0 &&
                                       max(sf - dr, sf + dr * K) <= W - 1));
    // src[k + 1]: the first source word of walk position k, k in [-1, K]
    u32 src[K + 2][4];
    if (kMode != 0 && qb != 0u) {
#pragma unroll
      for (int k = -1; k <= K; ++k) {
        // a shifted copy also reads the row after its last (forward) or
        // before its first (backward), the second word of its edge row
        const bool need = kMode == 1 ? k >= 0 && k < K
                        : back ? k < K : k >= 0;
        if (!need) continue;
        if (whole) {
          bulk_load(col + (size_t)sf * L + (size_t)k * stride, qb, true,
                    src[k + 1]);
          continue;
        }
        const int off = r0 + k;
        if (off > nrows || (kMode == 1 && off >= nrows)) continue;
        const int r = back ? R1 - off : R0 + off;
        const int swi = (i32)((u32)r * 4u + (u32)d) >> 2;
        bulk_load(col + (size_t)clampi(swi, 0, W - 1) * L, qb, vec,
                  src[k + 1]);
      }
    }
    __syncwarp(act);
    // the word of walk position k for lane j of the quad (a shifted
    // copy's second source word is the next position's first forward, the
    // previous position's backward)
    auto value = [&](int k, int j) -> u32 {
      if (kMode == 0) return fw[j];
      if (kMode == 1) return src[k + 1][j];
      const u32 s1 = back ? src[k][j] : src[k + 2][j];
      return (src[k + 1][j] >> sh) | (s1 << (32u - sh));
    };
    if (whole && qb == 15u) {
      // a quad whole in the group: 16 bytes a row
      i32* row = col + (size_t)rf * L;
#pragma unroll
      for (int k = 0; k < K; ++k, row += stride)
        *reinterpret_cast<int4*>(row) =
            make_int4((int)value(k, 0), (int)value(k, 1), (int)value(k, 2),
                      (int)value(k, 3));
    } else if (whole) {
      // the group's words of the quad
      i32* row = col + (size_t)rf * L;
#pragma unroll
      for (int k = 0; k < K; ++k, row += stride) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if ((qb >> j) & 1u) row[j] = (i32)value(k, j);
      }
    } else if (qb != 0u) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int off = r0 + k;
        if (off >= nrows) break;
        const int r = back ? R1 - off : R0 + off;
        u32 val[4], m[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m[j] = bulk_mask(r, w0[j], w1[j], head[j], tail[j]);
          val[j] = value(k, j);
        }
        bulk_store(col + (size_t)r * L, qb, vec, val, m);
      }
    }
    __syncwarp(act);
  }
}

// memory.fill / memory.copy of the threads of the warp at a bulk op:
// every thread of `act` calls it, `part` false for a lane that traps or
// has n == 0.  The windows of every lane have been written back.
__device__ void bulk_op(i32* mem, int L, int W, int lane, unsigned act,
                        u32 dst, u32 end, u32 v, bool copy, bool part) {
  __shared__ u32 tab[3][BLOCK_THREADS];
  const int tid = threadIdx.x;
  if (__popc(act) < 8) {
    // too few threads for a row of quads: each lane walks its column
    if (part) {
      bulk_fill_copy(mem, L, W, lane, dst, end, v, copy);
      atomicAdd(&g_bulk_counts[2], 1ull);
    }
    return;
  }
  tab[0][tid] = dst;
  tab[1][tid] = end;
  tab[2][tid] = v;
  const unsigned long long key =
      !part ? 1ull << 33 : copy ? (unsigned long long)(v - dst) : 1ull << 32;
  const unsigned mine = __match_any_sync(act, key);
  unsigned todo = __ballot_sync(act, part);
  // the windows written back and the table before any thread reads
  // another lane's column or entry
  __syncwarp(act);
  const int w_lo = (int)(dst >> 2);
  const int w_hi = min((int)((end - 1u) >> 2), W - 1);
  while (todo != 0u) {
    const int leader = __ffs(todo) - 1;
    const unsigned grp = __shfl_sync(act, mine, leader);
    todo &= ~grp;
    const bool in = (grp >> tid) & 1u;
    const int R0 = __reduce_min_sync(act, in ? w_lo : INT_MAX);
    const int R1 = __reduce_max_sync(act, in ? w_hi : -1);
    const i32 d = (i32)__shfl_sync(act, v - dst, leader);
    const bool gcopy = __shfl_sync(act, (int)copy, leader) != 0;
    // a source address of the walk that leaves the int32 range (never in
    // a plane of a real size) keeps the per-lane walk
    const bool wraps = gcopy && ((long long)R0 * 4 + d < INT_MIN ||
                                 (long long)R1 * 4 + 4 + d > INT_MAX);
    if (__popc(grp) == 1 || wraps) {
      if (in) {
        bulk_fill_copy(mem, L, W, lane, dst, end, v, copy);
        atomicAdd(&g_bulk_counts[2], 1ull);
      }
    } else if (R0 <= R1) {
      const int wbase = lane - tid;
      if (!gcopy)
        bulk_rows<0>(mem, L, W, wbase, act, grp, d, R0, R1, tab);
      else if ((d & 3) == 0)
        bulk_rows<1>(mem, L, W, wbase, act, grp, d, R0, R1, tab);
      else
        bulk_rows<2>(mem, L, W, wbase, act, grp, d, R0, R1, tab);
      if (tid == leader) {
        atomicAdd(&g_bulk_counts[0], 1ull);
        atomicAdd(&g_bulk_counts[1], (unsigned long long)__popc(grp));
      }
    }
    __syncwarp(act);
  }
}

// One v128 instruction, handler h >= H_VCONST at pcc (kSimd only).
// Returns its trap code: a v128.load / v128.store out of bounds writes
// nothing.
template <bool kSimd, bool kWin, class Wp>
__device__ __forceinline__ int simd_step(const Params& p,
                                         const Lane<kSimd>& s, Mem<kWin>& m,
                                         Wp& w, int h, int pcc, int sp,
                                         int pages, int& new_sp) {
  if (h >= H_V2_BASE) {
    if (h < H_V1_BASE) {
      s.put4(sp - 2, v2_op(h - H_V2_BASE, s.get4(sp - 2), s.get4(sp - 1)));
      new_sp = sp - 1;
    } else if (h < H_VTEST_BASE) {
      s.put4(sp - 1, v1_op(h - H_V1_BASE, s.get4(sp - 1)));
    } else if (h < H_VSHIFT_BASE) {
      s.put(sp - 1, vtest_op(h - H_VTEST_BASE, s.get4(sp - 1)));
    } else if (h < H_VSPLAT_BASE) {
      s.put4(sp - 2, vshift_op(h - H_VSHIFT_BASE, s.get4(sp - 2),
                               (u32)s.get(sp - 1)));
      new_sp = sp - 1;
    } else if (h < H_VEXTRACT_BASE) {
      s.put4(sp - 1, vsplat_op(h - H_VSPLAT_BASE, s.get(sp - 1)));
    } else if (h < H_VREPLACE_BASE) {
      s.put(sp - 1, vextract_op(h - H_VEXTRACT_BASE, s.get4(sp - 1),
                                __ldg(&p.a[pcc])));
    } else {
      s.put4(sp - 2, vreplace_op(h - H_VREPLACE_BASE, s.get4(sp - 2),
                                 __ldg(&p.a[pcc]), s.get(sp - 1)));
      new_sp = sp - 1;
    }
    return 0;
  }
  if (h == H_VCONST || h == H_VSHUFFLE) {
    // the v128 table row a: the constant, or the shuffle's byte selectors
    const int row = clampi(__ldg(&p.a[pcc]), 0, p.nv - 1) * 4;
    const V4 c{{(u32)__ldg(&p.v128[row]), (u32)__ldg(&p.v128[row + 1]),
                (u32)__ldg(&p.v128[row + 2]), (u32)__ldg(&p.v128[row + 3])}};
    if (h == H_VCONST) {
      s.put4(sp, c);
      new_sp = sp + 1;
      return 0;
    }
    const V4 x = s.get4(sp - 2), y = s.get4(sp - 1);
    V4 r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = shuffle_word(x, y, c.w[k], false);
    s.put4(sp - 2, r);
    new_sp = sp - 1;
    return 0;
  }
  if (h == H_VBITSEL) {
    // operands (v1, v2, mask) from the third cell down to the top
    const V4 a = s.get4(sp - 3), b = s.get4(sp - 2), m = s.get4(sp - 1);
    V4 r;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.w[k] = (a.w[k] & m.w[k]) | (b.w[k] & ~m.w[k]);
    s.put4(sp - 3, r);
    new_sp = sp - 2;
    return 0;
  }
  // v128.load (address on top) / v128.store (address, then the value)
  const bool store = h == H_VSTORE;
  const u32 off = (u32)__ldg(&p.a[pcc]);
  const u32 base = w.agree((u32)s.get(store ? sp - 2 : sp - 1));
  const u32 ea = base + off, end = ea + 16u;
  const u32 mem_bytes = (u32)pages * 65536u;
  if (ea < base || ea < off || end < ea || mem_bytes < end) return E_MEM_OOB;
  const int widx = (int)(ea >> 2);
  const u32 sh = (ea & 3u) * 8u;
  int row[5];  // the five rows, clamped into the plane
#pragma unroll
  for (int k = 0; k < 5; ++k) row[k] = clampi(widx + k, 0, p.W - 1);
  if (w.on() && m.dirty_miss(p, row[0], row[4])) return OPT_DEFER;
  m.select(p, s.lane, row[0], row[4]);
  if (!store) {
    m.readable(p, s.lane, row[0], row[4]);
    u32 word[5];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      word[k] = k < 4 || sh ? m.get(p, s.lane, row[k]) : 0u;
    V4 r;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.w[k] = sh ? (word[k] >> sh) | (word[k + 1] << (32u - sh)) : word[k];
    s.put4(sp - 1, r);
    return 0;
  }
  const V4 v = s.get4(sp - 1);
  new_sp = sp - 2;
  if (sh == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) m.put(p, s.lane, row[k], v.w[k]);
    return 0;
  }
  // the 16 bytes span five words: keep the bytes below ea in the first
  // and those from ea + 16 on in the last
  const u32 keep = 0xFFFFFFFFu << sh;
  m.merge(p, s.lane, row[0], v.w[0] << sh, keep);
#pragma unroll
  for (int k = 1; k < 4; ++k)
    m.put(p, s.lane, row[k], (v.w[k] << sh) | (v.w[k - 1] >> (32u - sh)));
  m.merge(p, s.lane, row[4], v.w[3] >> (32u - sh), ~keep);
  return 0;
}

// Where a call's table operands and its table index come from: the code
// planes at its pc and the stack row below sp (the per-op step), or
// literals and a register (a B2 instance case, batch/fusegen.py).
template <bool kSimd>
struct CallAtPc {
  const Params& p;
  const Lane<kSimd>& s;
  int pc, sp;
  __device__ __forceinline__ int b() const { return __ldg(&p.b[pc]); }
  __device__ __forceinline__ int c() const { return __ldg(&p.c[pc]); }
  __device__ __forceinline__ u32 index() const { return (u32)s.get(sp - 1); }
};
struct CallLit {
  int b_, c_;
  u32 index_;
  __device__ __forceinline__ int b() const { return b_; }
  __device__ __forceinline__ int c() const { return c_; }
  __device__ __forceinline__ u32 index() const { return index_; }
};

// The call family's one body, for the per-op step and a B2 instance
// case's terminal alike: call, call_indirect, return_call and
// return_call_indirect (`indirect`, `tail`) at pc with sp, `a` the callee
// or the type index.  call_indirect goes through table 0 of size b at
// base c, or (WASM_TABLES, an image that mutates its table) through the
// lane's own table [tcap, L] and size, its index and handle agreed:
// lanes with one index can reach different callees.  Traps, the last
// one set winning: E_UNDEF_ELEM, E_UNINIT_ELEM, E_SIG_MISMATCH,
// E_CALL_STACK (not for a tail call), E_STACK_OVERFLOW.  A tail call
// replaces the frame: fp stays, the arguments slide down to it
// (ascending: they lie at or above the operand base), no frame row is
// written and only the value stack is checked.  Returns the trap code;
// the new control registers are written either way (the caller takes
// them on 0), the rows only when the call enters.
template <bool kSimd, class Wp, class Src>
__device__ __forceinline__ int call_op(const Params& p, const Lane<kSimd>& s,
                                       Wp& w, OptRun& os, const Src& src,
                                       const bool indirect, const bool tail,
                                       const int a, const int pc, const int sp,
                                       const int fp, const int ob, const int cd,
                                       int& new_pc, int& new_fp, int& new_ob,
                                       int& new_sp, int& new_cd) {
  const int lane = s.lane;
  int callee, sp_eff = sp, code = 0;
  if (!indirect) {
    callee = clampi(a, 0, p.nf - 1);
  } else {
    const int b = src.b(), c = src.c();
    const i32 idx = (i32)w.agree(src.index());
#if WASM_TABLES
    const int size = p.a3.tsize ? p.a3.tsize[lane] : b;
    const int ti = c + clampi(idx, 0, size - 1 > 0 ? size - 1 : 0);
    const int handle =
        p.a3.tab ? (int)w.agree((u32)p.a3.tab[(size_t)clampi(ti, 0, p.a3.tcap - 1) * p.L + lane])
                 : __ldg(&p.tbl[clampi(ti, 0, p.tsize - 1)]);
    const bool oob = !((u32)idx < (u32)size);
#else
    const int ti = clampi(c + clampi(idx, 0, b - 1 > 0 ? b - 1 : 0), 0,
                          p.tsize - 1);
    const int handle = __ldg(&p.tbl[ti]);
    const bool oob = !((u32)idx < (u32)b);
#endif
    const bool null_ref = !oob && handle == 0;
    callee = clampi(handle - 1, 0, p.nf - 1);
    if (oob) code = E_UNDEF_ELEM;
    if (null_ref) code = E_UNINIT_ELEM;
    if (!oob && !null_ref && __ldg(&p.ftyp[callee]) != a) code = E_SIG_MISMATCH;
    sp_eff = sp - 1;
  }
  const int npar = __ldg(&p.fnpar[callee]), nloc = __ldg(&p.fnloc[callee]);
  const int fp_new = tail ? fp : sp_eff - npar, ob_new = fp_new + nloc;
  if (!tail && cd >= p.CD - 1) code = E_CALL_STACK;
  if (fp_new + __ldg(&p.ftop[callee]) > p.D) code = E_STACK_OVERFLOW;
  if (code == 0) {
    if (tail) {
      for (int k = 0; k < npar; ++k) s.putc(fp + k, s.getc(sp_eff - npar + k));
    } else {
      if constexpr (Wp::kLead) opt_save_frame(p, lane, cd, os.o.fhi);
      const size_t r = s.at(cd, p.CD);
      p.fr_ret_pc[r] = pc + 1;
      p.fr_fp[r] = fp;
      p.fr_opbase[r] = ob;
    }
    for (int k = 0; k < nloc - npar && k < p.max_local_zeros; ++k)
      s.put(fp_new + npar + k, 0);
  }
  new_pc = __ldg(&p.fent[callee]);
  new_fp = fp_new;
  new_ob = ob_new;
  new_sp = ob_new;
  new_cd = tail ? cd : cd + 1;
  return code;
}

// kBulk: the image holds memory.fill / memory.copy.  An image without
// them runs the instantiation that has no bulk loop, as the reference
// SIMT step compiles its bulk path only for such images (HAS_BULK,
// engine.py:1007): compiled into the dispatch loop, the bulk loop raised
// the kernel from 40 to 48 registers and slowed fib(30) x 4096 on an
// H100 by 6 %, and out of line (__noinline__) it still cost 1-2 %
// (PERF.md).  kSimd: the image holds v128 ops (four-word cells and the
// B7 handlers, above); without them nothing of v128 is compiled in.
//
// F: the fused dispatch of a per-module build (fused.cuh and the code
// batch/fusegen.py generates; B2 blocks or B6 superinstructions), or
// NoFusion for the shared per-op build, which then compiles to the loop
// it always was.  A fused dispatch runs only when the lane's remaining
// steps in the launch and, with fuel on, its remaining fuel cover the
// whole fused length, so a launch stops at the same instruction as the
// per-op loop; otherwise the lane runs the head slot's original op
// (hid0) and goes on one op at a time.  B2 and B6 builds (F::kByPc)
// switch on the pc: F::at_pc runs a block head's or superinstruction's
// case, which may run its terminal too (any other pc takes the hid plane,
// a block or superinstruction beyond the instance cap F::step), and
// returns the handler the per-op code runs next or FUSED_DONE; a build
// generated without instance cases (fusegen.cuda_source with no image)
// loads the hid and runs F::step at a fused id.
// Either retires n ops (their writes committed, the live cells of its
// virtual stack flushed) and may leave a terminal op at pc to the per-op
// code below.
//
// kWin: memory accesses go through the lane's window cache (memwin.cuh);
// the launch gives each block WIN_SMEM_BYTES of dynamic shared memory
// before the stack rows (block_smem).  Every way out of the loop below
// ends in the flush and the stack rows' write-back after it.
//
// kOpt: optimistic convergence (optimistic.cuh).  The warp's present mask
// is taken before any thread returns (a warp intrinsic after a return
// would name absent threads).  A warp whose present lanes are all live
// and share their control state runs the warp-leader loop
// (dispatch_loop<..., Warp<true>>: every decision through `w`, lane
// 0's) up to each commit point: the loop's bound is the step at which
// the interval has passed, and a handler that asks for a commit
// (OPT_DEFER: the instruction has not run and runs again after it)
// returns early with os.pending set; the kernel commits and runs the loop
// again until the launch ends, then validates.  A rollback or a bulk op
// hands the rest of the launch, from the snapshot's step or the bulk op,
// to the careful loop (dispatch_loop<..., WarpUniform>, off), which every
// other warp runs from the start to the launch's end, with no commit
// point.  A whole warp whose lanes also hold one state (the entry rule,
// optimistic.cuh `warp_uniform`) runs the careful loop on (`on_`) up to
// each commit point in the same way, and takes no snapshot, until a bulk
// op's commit turns it off.  Two instantiations of one loop in a kOpt
// build; a build without kOpt has the careful one alone (Warp<false>, no
// commit point compiled in).
struct NoFusion {
  static constexpr bool kOn = false;
  static constexpr bool kByPc = false;
};

// What a fused build's at_pc returns when it leaves nothing to the per-op
// code (not a handler id).
constexpr int FUSED_DONE = -1;

// WASM_TURN_COUNTS 1: the counting build of tools/tail_probe.py, whose
// dispatch loop counts its turns: each lane its own (summed over lanes:
// the sum of __popc(__activemask()) over the warps' turns) and, for the
// lanes that run a turn together, the lowest of them one (the warps'
// turns); added to g_turn_counts when the loop returns.  Undefined in
// every other build, whose code it leaves as it was.
#ifndef WASM_TURN_COUNTS
#define WASM_TURN_COUNTS 0
#endif
#if WASM_TURN_COUNTS
__device__ unsigned long long g_turn_counts[2];
struct TurnCount {
  unsigned long long lane = 0, warp = 0;
  __device__ __forceinline__ void turn() {
    ++lane;
    if ((int)(threadIdx.x & 31u) == __ffs(__activemask()) - 1) ++warp;
  }
  __device__ __forceinline__ ~TurnCount() {
    atomicAdd(&g_turn_counts[0], lane);
    atomicAdd(&g_turn_counts[1], warp);
  }
};
#endif

template <bool kBulk, bool kSimd, class F, bool kWin, class Wp>
__device__ __forceinline__ void dispatch_loop(const Params& p,
                                              const Lane<kSimd>& s,
                                              Mem<kWin>& m, Wp& w,
                                              LaneRegs& r, OptRun& os,
                                              const int lim) {
  const int lane = s.lane;
  int &pc = r.pc, &sp = r.sp, &fp = r.fp, &ob = r.ob, &cd = r.cd;
  int &retired = r.retired, &fuel = r.fuel, &pages = r.pages;
  int &trap = r.trap, &step = r.step;
#if WASM_TURN_COUNTS
  TurnCount turns;
#endif
  for (; step < lim; ++step) {
#if WASM_TURN_COUNTS
    turns.turn();
#endif
    int pcc = clampi(pc, 0, p.code_len - 1);
    int h;
    if constexpr (F::kByPc) {
      // B2 blocks and B6 superinstructions: the generated switch on pc
      // runs a block head's or a superinstruction's own case (its budget
      // test, its ops and, for br / brnz / return / call /
      // call_indirect / tail call / div / rem, or a superinstruction's
      // call or return, its terminal, every immediate a literal), or
      // returns the handler the per-op code below runs at pc: a pc that
      // heads no case, a head whose case the budget does not cover (its
      // own op), a terminal left to the per-op code (after the case's n
      // ops).  FUSED_DONE: nothing left for the per-op code.
      int n = 0, xtrap = 0;
      h = F::template at_pc<kSimd, kWin>(p, s, m, w, os, pcc,
                                         p.chunk - step, fuel, pc, sp, fp,
                                         ob, cd, pages, n, xtrap);
      if (h == FUSED_DONE || n != 0) {
        retired += n;
#if WASM_GAS
        if (p.fuel_on) fuel -= gas_run(p, pcc, n);
#else
        if (p.fuel_on) fuel -= n;
#endif
        s.note(sp);  // a fused dispatch writes rows below its exit's sp
        if (xtrap != 0) {
          if constexpr (Wp::kCommits) {
            if (xtrap == OPT_DEFER) {
              // the n ops before the access retired; the commit it asks
              // for comes first
              step += n;
              os.pending = OPT_WAIT_ACCESS;
              return;
            }
          }
          trap = xtrap;  // pc and sp are the trapping op's own
          break;
        }
        step += n;
        if (h == FUSED_DONE) {
          --step;  // the loop's increment
          continue;
        }
        pcc = clampi(pc, 0, p.code_len - 1);
      }
    } else {
      h = __ldg(&p.hid[pcc]);
    }
    if constexpr (F::kOn && !F::kByPc) {
      // A build without instance cases (blocks or superinstructions
      // dispatched by the hid plane, fusegen.cuda_source with no image:
      // the pc switch's yardstick).  Routing B6 through at_pc's default
      // test alone ran fib(30) in super 5.9 % slower on an H100
      // (PERF.md): a second test on every per-op instruction's path; its
      // instance cases take the hid test off the path.
      if ((unsigned)(h - H_FUSE_GCA_BASE) <= (unsigned)(H_FUSE_GBR - H_FUSE_GCA_BASE) ||
          h >= NUM_HANDLERS) {
        const int len = __ldg(&p.flen[pcc]);
#if WASM_GAS
        if (p.chunk - step >= len && (!p.fuel_on || fuel > gas_run(p, pcc, len))) {
#else
        if (p.chunk - step >= len && (!p.fuel_on || fuel > len)) {
#endif
          int n = 0, xtrap = 0;
          const bool term = F::template step<kSimd, kWin>(
              p, s, m, w, h, pc, sp, fp, ob, pages, n, xtrap);
          retired += n;
#if WASM_GAS
          if (p.fuel_on) fuel -= gas_run(p, pcc, n);
#else
          if (p.fuel_on) fuel -= n;
#endif
          s.note(sp);  // a fused dispatch writes rows below its exit's sp
          if (xtrap != 0) {
            if constexpr (Wp::kCommits) {
              if (xtrap == OPT_DEFER) {
                // the n ops before the access retired; the commit it
                // asks for comes first
                step += n;
                os.pending = OPT_WAIT_ACCESS;
                return;
              }
            }
            trap = xtrap;  // pc and sp are the trapping op's own
            break;
          }
          step += n;
          if (!term) {
            --step;  // the loop's increment
            continue;
          }
          pcc = clampi(pc, 0, p.code_len - 1);
          h = __ldg(&p.hid[pcc]);  // the terminal keeps its original id
        } else {
          h = __ldg(&p.hid0[pcc]);
        }
      }
    }
    int new_pc = pcc + 1, new_sp = sp, new_fp = fp, new_ob = ob, new_cd = cd;
    int ntrap = 0;
    int sp_halt = sp;

    if (h >= H_ALU2_BASE && h < H_ALU2_BASE + NUM_ALU2) {
      const u64 y = s.get(sp - 1), x = s.get(sp - 2);
      s.put(sp - 2, alu2(h - H_ALU2_BASE, x, y, ntrap));  // written even on a trap
      if (alu2_traps(h - H_ALU2_BASE)) ntrap = (int)w.agree((u32)ntrap);
      new_sp = sp - 1;
    } else if (h >= H_ALU1_BASE && h < H_ALU1_BASE + NUM_ALU1) {
      const int sub = h - H_ALU1_BASE;
      u64 r = alu1(sub, s.get(sp - 1), ntrap);
      if (ntrap != 0 && (sub == 23 || sub == 24)) r = 0;  // f32 -> i32 trap writes 0
      s.put(sp - 1, r);
      if (alu1_traps(sub)) ntrap = (int)w.agree((u32)ntrap);
    } else if (kSimd && h >= H_VCONST) {
      ntrap = simd_step<kSimd, kWin>(p, s, m, w, h, pcc, sp, pages, new_sp);
    } else {
      switch (h) {
        case H_NOP:
          break;
        case H_CONST:
          s.put(sp, pack(__ldg(&p.ilo[pcc]), __ldg(&p.ihi[pcc])));
          new_sp = sp + 1;
          break;
        case H_LOCAL_GET:
          s.putc(sp, s.getc(fp + __ldg(&p.a[pcc])));
          new_sp = sp + 1;
          break;
        case H_LOCAL_SET:
          s.putc(fp + __ldg(&p.a[pcc]), s.getc(sp - 1));
          new_sp = sp - 1;
          break;
        case H_LOCAL_TEE:
          s.putc(fp + __ldg(&p.a[pcc]), s.getc(sp - 1));
          break;
        case H_GLOBAL_GET: {
          const size_t g = s.at(__ldg(&p.a[pcc]), p.NG);
          s.put(sp, pack(p.glob_lo[g], p.glob_hi[g]));
          new_sp = sp + 1;
          break;
        }
        case H_GLOBAL_SET: {
          const size_t g = s.at(__ldg(&p.a[pcc]), p.NG);
          const u64 v = s.get(sp - 1);
          p.glob_lo[g] = lo32(v);
          p.glob_hi[g] = hi32(v);
          new_sp = sp - 1;
          break;
        }
        case H_DROP:
          new_sp = sp - 1;
          break;
        case H_SELECT: {
          const u32 cond = (u32)s.get(sp - 1);
          const auto v1 = s.getc(sp - 2), v2 = s.getc(sp - 3);
          s.putc(sp - 3, cond == 0 ? v1 : v2);
          new_sp = sp - 2;
          break;
        }
        case H_BR: {
          const int a = __ldg(&p.a[pcc]), b = __ldg(&p.b[pcc]), c = __ldg(&p.c[pcc]);
          if (b == 1) s.putc(ob + c, s.getc(sp - 1));
          new_sp = ob + c + b;
          new_pc = a;
          break;
        }
        case H_BRZ:
          new_sp = sp - 1;
          if (!w.nz((u32)s.get(sp - 1))) new_pc = __ldg(&p.a[pcc]);
          break;
        case H_BRNZ: {
          if (w.nz((u32)s.get(sp - 1))) {
            const int a = __ldg(&p.a[pcc]), b = __ldg(&p.b[pcc]), c = __ldg(&p.c[pcc]);
            if (b == 1) s.putc(ob + c, s.getc(sp - 2));
            new_sp = ob + c + b;
            new_pc = a;
          } else {
            new_sp = sp - 1;
          }
          break;
        }
        case H_BR_TABLE: {
          const int a = __ldg(&p.a[pcc]), b = __ldg(&p.b[pcc]);
          const i32 idx = (i32)w.agree((u32)s.get(sp - 1));
          const int i = ((u32)b < (u32)idx) ? b : idx;
          const int e = clampi(a + i, 0, p.n_brt - 1) * 3;
          const int tgt = __ldg(&p.brt[e]), keep = __ldg(&p.brt[e + 1]);
          const int pop = __ldg(&p.brt[e + 2]);
          if (keep == 1) s.putc(ob + pop, s.getc(sp - 2));
          new_sp = ob + pop + keep;
          new_pc = tgt;
          break;
        }
        case H_RETURN: {
          const int nres = __ldg(&p.b[pcc]);
          if (nres == 1) s.putc(fp, s.getc(sp - 1));
          new_sp = fp + nres;
          if (cd == 0) {
            ntrap = TRAP_DONE;
            sp_halt = fp + nres;
          } else {
            // frame rows are the lane's own (the entry compares none of
            // them): where the return goes is a decision
            const size_t r = s.at(cd - 1, p.CD);
            new_pc = (int)w.agree((u32)p.fr_ret_pc[r]);
            new_fp = (int)w.agree((u32)p.fr_fp[r]);
            new_ob = (int)w.agree((u32)p.fr_opbase[r]);
            new_cd = cd - 1;
          }
          break;
        }
#if WASM_TABLES
        case H_RETCALL:
        case H_RETCALL_INDIRECT:
#endif
        case H_CALL:
        case H_CALL_INDIRECT: {
#if WASM_TABLES
          const bool tail = h == H_RETCALL || h == H_RETCALL_INDIRECT;
          const bool indirect = h == H_CALL_INDIRECT || h == H_RETCALL_INDIRECT;
#else
          const bool tail = false, indirect = h != H_CALL;
#endif
          ntrap = call_op<kSimd>(p, s, w, os, CallAtPc<kSimd>{p, s, pcc, sp}, indirect,
                                 tail, __ldg(&p.a[pcc]), pcc, sp, fp, ob, cd, new_pc,
                                 new_fp, new_ob, new_sp, new_cd);
          break;
        }
        case H_MEMSIZE:
          s.put(sp, cell32((u32)pages));
          new_sp = sp + 1;
          break;
        case H_MEMGROW: {
          // b is the page ceiling of the module this pc belongs to (each
          // tenant's own in a concatenated image)
          const i32 delta = (i32)w.agree((u32)s.get(sp - 1));
          const i32 grown = (i32)((u32)pages + (u32)delta);
          const bool ok = !((u32)__ldg(&p.b[pcc]) < (u32)grown) && delta >= 0 &&
                          grown >= pages;
          s.put(sp - 1, cell32(ok ? (u32)pages : 0xFFFFFFFFu));
          if (ok) pages = grown;  // the page count is not rolled back by a fuel trap
          break;
        }
        case H_TRAP:
          ntrap = __ldg(&p.a[pcc]);
          break;
        case H_LOAD:
        case H_LOAD_W:
        case H_LOAD_D:
        case H_STORE:
        case H_STORE_W:
        case H_STORE_D: {
          const bool is_store = h == H_STORE || h == H_STORE_W || h == H_STORE_D;
          const u32 off = (u32)__ldg(&p.a[pcc]);
          const int nbytes = __ldg(&p.b[pcc]);
          const u32 base = w.agree((u32)s.get(is_store ? sp - 2 : sp - 1));
          const u32 ea = base + off;
          const u32 end = ea + (u32)nbytes;
          const u32 mem_bytes = (u32)pages * 65536u;
          const bool oob = ea < base || ea < off || end < ea || mem_bytes < end;
          if (is_store) new_sp = sp - 2;
          if (oob) {
            ntrap = E_MEM_OOB;
            break;
          }
          const int widx = (int)(ea >> 2);
          const u32 sh = (ea & 3) * 8;
          int row[3];  // clamped into the plane
          u32 w3[3];  // a load's words
          for (int k = 0; k < 3; ++k) row[k] = clampi(widx + k, 0, p.W - 1);
          if (w.on() && m.dirty_miss(p, row[0], row[2])) {
            ntrap = OPT_DEFER;
            break;
          }
          m.select(p, lane, row[0], row[2]);
          if (!is_store) {
            m.readable(p, lane, row[0], row[2]);
            for (int k = 0; k < 3; ++k) w3[k] = m.get(p, lane, row[k]);
            const int c = __ldg(&p.c[pcc]);
            const bool sgn = (c & 1) != 0, is64 = (c & 2) != 0;
            const u32 raw_lo = sh ? (w3[0] >> sh) | (w3[1] << (32 - sh)) : w3[0];
            const u32 raw_hi = sh ? (w3[1] >> sh) | (w3[2] << (32 - sh)) : w3[1];
            u32 lo;
            if (nbytes == 1) lo = sgn ? sext(raw_lo, 8) : (raw_lo & 0xFFu);
            else if (nbytes == 2) lo = sgn ? sext(raw_lo, 16) : (raw_lo & 0xFFFFu);
            else lo = raw_lo;
            u32 hi = 0;
            if (is64) hi = nbytes == 8 ? raw_hi : (sgn ? (u32)((i32)lo >> 31) : 0u);
            s.put(sp - 1, ((u64)hi << 32) | lo);
          } else {
            const u64 full = nbytes == 1 ? 0xFFull : nbytes == 2 ? 0xFFFFull
                             : nbytes == 8 ? ~0ull : 0xFFFFFFFFull;
            const u64 val = s.get(sp - 1);
            const u64 m01 = full << sh, v01 = val << sh;
            const u32 mk[3] = {(u32)m01, (u32)(m01 >> 32),
                               sh ? (u32)(full >> (64 - sh)) : 0u};
            const u32 vk[3] = {(u32)v01, (u32)(v01 >> 32),
                               sh ? (u32)(val >> (64 - sh)) : 0u};
            for (int k = 0; k < 3; ++k) {
              if (mk[k] == 0xFFFFFFFFu)
                m.put(p, lane, row[k], vk[k]);
              else if (mk[k] != 0)
                m.merge(p, lane, row[k], vk[k], mk[k]);
            }
          }
          break;
        }
        default:
          // The host-call park and bulk memory sit here, not under case
          // labels of their own: as cases they slowed fib(30) x 4096, which
          // runs neither, by 1.5 % on an H100 (PERF.md).
#if WASM_TABLES
          if (h < 0) {
            // tables and segments: a warp-leader commits first and runs
            // a write per lane, off for the rest of the launch; a uniform
            // warp runs it in place (its lanes write alike)
            if (w.on() && Wp::kLead && a3_writes(h)) {
              ntrap = OPT_DEFER;
              break;
            }
            if (h == H_MEMINIT) m.flush(p, lane);  // it works on the plane
            ntrap = a3_step<kSimd>(p.a3, s, p.tbl, p.tsize, p.mem, p.W, h,
                                   __ldg(&p.a[pcc]), __ldg(&p.b[pcc]),
                                   __ldg(&p.c[pcc]), sp, (u32)pages * 65536u);
            if (h == H_TABLE_GET) ntrap = (int)w.agree((u32)ntrap);
            new_sp = sp + a3_sp_delta(h);
            break;
          }
#endif
          if (h == H_HOSTCALL) {
            if constexpr (kTier0) {
              const int kind = __ldg(&p.t0.kind[pcc]);
              if (kind != T0_NONE) {
                // B3: a warp that is on commits first and runs the call
                // per lane, off for the rest of the launch, as at a bulk
                // op; a uniform warp runs it in place, but random_get,
                // whose bytes differ by lane
                if (w.on() && (Wp::kLead || kind == T0_RANDOM)) {
                  ntrap = OPT_DEFER;
                  break;
                }
                if (kind == T0_CLOCK || kind == T0_RANDOM || kind == T0_FDWRITE)
                  m.flush(p, lane);
                const u64 res = tier0_call(
                    p.t0, p.mem, p.L, p.W, lane, kind, (u32)s.get(fp),
                    (u32)s.get(fp + 1), (u32)s.get(fp + 2), (u32)s.get(fp + 3),
                    (u32)pages * 65536u);
                const int how = (int)(res >> 32);
                if (how != T0_PARKED) {
                  // the errno or the exit code at the operand base, where
                  // the host's serve writes a result
                  s.put(ob, cell32((u32)res));
                  if (how == T0_EXITED) {
                    ntrap = E_TERMINATED;
                    s.note(ob + 1);
                  } else {
                    new_sp = ob + 1;
                  }
                  break;
                }
              }
            }
            // park: retired and charged like any instruction; the halt
            // path below keeps pc at the stub and sp as it is
            ntrap = TRAP_HOSTCALL;
            break;
          }
          if (!kBulk || (h != H_MEMFILL && h != H_MEMCOPY)) {
            ntrap = E_EXEC_FAILED;  // the engine refuses such images up front
            break;
          }
          if (w.on()) {
            // a commit point; the op runs in the careful loop
            // (_opt_bulk_exit, pallas_engine.py :1065-1080)
            ntrap = OPT_DEFER;
            break;
          }
          {
            // memory.fill / memory.copy; stack: dst, fill value or
            // source, n (top).  The threads at the op together run it as
            // one warp pass per group (bulk_op), out-of-bounds lanes and
            // n == 0 included as workers.
            const unsigned act = __activemask();
            const bool copy = h == H_MEMCOPY;
            // the bulk loop runs on the plane: the windows go back first
            // and none stays valid (pallas_engine.py :2303-2306)
            m.flush(p, lane);
            const u32 n = (u32)s.get(sp - 1), v = (u32)s.get(sp - 2);
            const u32 dst = (u32)s.get(sp - 3);
            const u32 mem_bytes = (u32)pages * 65536u;
            const u32 end = dst + n;
            bool oob = end < dst || mem_bytes < end;
            if (copy) oob = oob || v + n < v || mem_bytes < v + n;
            bulk_op(p.mem, p.L, p.W, lane, act, dst, end, v, copy,
                    !oob && n != 0);
            if (oob) {
              ntrap = E_MEM_OOB;  // nothing written
              break;
            }
            new_sp = sp - 3;
          }
          break;
      }
    }

    ++retired;
    if (p.fuel_on) {
#if WASM_GAS
      fuel = (int)((u32)fuel - (u32)__ldg(&p.a3.cost[pcc]));
#else
      --fuel;
#endif
      if (ntrap == 0 && fuel <= 0) ntrap = E_COST_LIMIT;
    }
    if (ntrap != 0) {
      if constexpr (Wp::kCommits) {
        if (ntrap == OPT_DEFER) {
          // nothing of the instruction ran (not retired, not charged):
          // the commit first, then the instruction again (a bulk op in
          // the careful loop)
          --retired;
#if WASM_GAS
          if (p.fuel_on) fuel = (int)((u32)fuel + (u32)__ldg(&p.a3.cost[pcc]));
#else
          if (p.fuel_on) ++fuel;
#endif
#if WASM_TABLES
          // a table or segment write: the commit, then the rest of the
          // launch per lane, as at a bulk op
          os.pending = h == H_MEMFILL || h == H_MEMCOPY ||
                               (kTier0 && h == H_HOSTCALL) || h < 0
                           ? OPT_WAIT_BULK
                           : OPT_WAIT_ACCESS;
#else
          os.pending = h == H_MEMFILL || h == H_MEMCOPY ||
                               (kTier0 && h == H_HOSTCALL)
                           ? OPT_WAIT_BULK
                           : OPT_WAIT_ACCESS;
#endif
          return;
        }
      }
      // a halted lane keeps its pre-instruction control state; a fuel trap
      // keeps the instruction's writes, which lie below its new sp
      s.note(ntrap == E_COST_LIMIT ? new_sp : sp);
      trap = ntrap;
      sp = sp_halt;
      break;
    }
    pc = new_pc;
    sp = new_sp;
    s.note(sp);
    fp = new_fp;
    ob = new_ob;
    cd = new_cd;
  }
}

template <bool kBulk, bool kSimd, class F = NoFusion, bool kWin = false,
          bool kOpt = false>
__global__ void __launch_bounds__(BLOCK_THREADS) interp_kernel(const Params p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned mask = 0;
  if constexpr (kOpt) mask = __ballot_sync(0xffffffffu, lane < p.width);
  if (lane >= p.width) return;
  const int trap0 = p.trap[lane];
  if constexpr (!kOpt) {
    if (trap0 != 0) return;
  }
  // dynamic shared memory: the windows (kWin), then the stack rows
  extern __shared__ __align__(16) i32 dyn_smem[];
  Mem<kWin> m(dyn_smem);
  const Lane<kSimd> s{p.stack_lo, p.stack_hi, p.stack_e2, p.stack_e3,
                      dyn_smem + (kWin ? WIN_SMEM_BYTES / 4 : 0) +
                          Lane<kSimd>::kLaneWords * threadIdx.x,
                      p.L, p.D, lane, p.srows, 0};
  LaneRegs r{p.pc[lane],      p.sp[lane],      p.fp[lane],
             p.opbase[lane],  p.call_depth[lane], p.retired[lane],
             p.fuel[lane],    p.mem_pages[lane], 0, 0};
  OptRun os{};
  bool done = false, uniform = false;
  if constexpr (kOpt) {
    const int l_pc = __shfl_sync(mask, r.pc, 0);
    const int l_sp = __shfl_sync(mask, r.sp, 0);
    const int l_fp = __shfl_sync(mask, r.fp, 0);
    const int l_ob = __shfl_sync(mask, r.ob, 0);
    const int l_cd = __shfl_sync(mask, r.cd, 0);
    const int l_pages = __shfl_sync(mask, r.pages, 0);
    const int l_fuel = __shfl_sync(mask, r.fuel, 0);
#if WASM_TABLES
    // the lane's table size is a control register of the entry compare
    // (its shuffle outside the && chain: every lane of the mask takes it)
    const int tsz = p.a3.tsize ? p.a3.tsize[lane] : 0;
    const int l_tsz = __shfl_sync(mask, tsz, 0);
    const bool same = trap0 == 0 && r.pc == l_pc && r.sp == l_sp &&
                      r.fp == l_fp && r.ob == l_ob && r.cd == l_cd &&
                      r.pages == l_pages && r.fuel == l_fuel && tsz == l_tsz;
#else
    const bool same = trap0 == 0 && r.pc == l_pc && r.sp == l_sp &&
                      r.fp == l_fp && r.ob == l_ob && r.cd == l_cd &&
                      r.pages == l_pages && r.fuel == l_fuel;
#endif
    os.entered = os.on = __all_sync(mask, same) && p.chunk > 0;
    if (trap0 != 0) return;
    // a whole warp that is on: the entry rule (optimistic.cuh), on the
    // planes before the on-chip rows are loaded
    if (os.on && mask == 0xffffffffu)
      uniform = warp_uniform<kSimd>(p, lane, r.sp, r.cd, r.pages);
  }
  s.enter(r.sp);
  // the careful loop's decisions: a kOpt build's carry a uniform warp's
  // commit points while `on` (WarpUniform), a build without kOpt's none
  using Careful = typename std::conditional<kOpt, WarpUniform,
                                            Warp<false>>::type;
  Careful careful{};
  if constexpr (kOpt) {
    if (os.on) {
      os.snapv = p.w_snap[lane >> 5];
      os.due = opt_due(0, os.snapv);
      if (uniform) {
        // no snapshot: nothing can roll back
        careful.on_ = true;
      } else {
        // the entry state is the first snapshot (pallas_engine.py
        // :3661-3666); the windows start invalid
        Warp<true> w{mask, 0u};
        opt_save<kSimd, kWin>(p, s, r.sp, r.cd);
        os.o = OptSnap{r.pc, r.sp, r.fp, r.ob, r.cd, r.retired, r.fuel,
                       r.pages, 0, r.cd};
        // the leader loop up to each commit point (the interval passed,
        // or a handler asked for one: os.pending), then the commit; a
        // rollback or a bulk op ends it
        for (;;) {
          dispatch_loop<kBulk, kSimd, F, kWin, Warp<true>>(
              p, s, m, w, r, os, min(p.chunk, os.due));
          if (r.trap != 0 || r.step >= p.chunk ||
              !opt_commit<kSimd, kWin>(p, s, m, w, r, os,
                                       os.pending == OPT_WAIT_BULK))
            break;
        }
        if (os.on) {
          // the exit validation (pallas_engine.py :3669-3680): chunk end,
          // trap, fuel, done and the park publish nothing unvalidated; a
          // rollback leaves the rest of the launch to the careful loop
          opt_commit<kSimd, kWin>(p, s, m, w, r, os, true);
          done = !os.rolled;
        }
      }
    }
  }
  // the careful loop (one instantiation): a uniform warp's runs up to
  // each commit point and commits there as the leader's does (a bulk
  // op's commit turns the points off: the op runs next); every other
  // warp's runs to the launch's end with no commit point
  while (!done) {
    dispatch_loop<kBulk, kSimd, F, kWin, Careful>(
        p, s, m, careful, r, os,
        careful.on() ? min(p.chunk, os.due) : p.chunk);
    done = true;
    if constexpr (kOpt) {
      if (careful.on() && r.trap == 0 && r.step < p.chunk) {
        opt_commit<kSimd, kWin>(p, s, m, careful, r, os,
                                os.pending == OPT_WAIT_BULK);
        done = false;
      }
    }
  }
  if constexpr (kOpt) {
    // a uniform warp still on: the exit validation
    if (careful.on()) opt_commit<kSimd, kWin>(p, s, m, careful, r, os, true);
  }

  // the exit commit (pallas_engine.py :3683-3693): chunk end, trap, fuel,
  // done and the host-call park all leave the loops above to here; the
  // windows and the on-chip stack rows go back to the planes
  m.flush(p, lane);
  m.count();
  s.leave();
  p.pc[lane] = r.pc;
  p.sp[lane] = r.sp;
  p.fp[lane] = r.fp;
  p.opbase[lane] = r.ob;
  p.call_depth[lane] = r.cd;
  p.trap[lane] = r.trap;
  p.retired[lane] = r.retired;
  p.fuel[lane] = r.fuel;
  p.mem_pages[lane] = r.pages;
  if constexpr (kOpt) {
    // the warp's interval for its next launch (careful_recheck halves it,
    // _drive doubles it back, pallas_engine.py :4371-4395, :4411-4416)
    // and its counts, by lane 0
    if (os.entered && (lane & 31) == 0) {
      const int wid = lane >> 5;
      p.w_snap[wid] = os.rolled ? max(os.snapv / 2, OPT_SNAP_MIN)
                                : min(os.snapv * 2, p.snap_max);
      p.w_rollbacks[wid] += os.rolled ? 1 : 0;
      p.w_entered[wid] += 1;
      p.w_commits[wid] += os.commits;
      p.w_uniform[wid] += uniform ? 1 : 0;
    }
  }
}

// The block's dynamic shared memory: the windows (kWin) and the on-chip
// stack rows.  SMEM_BLOCK_MAX is what an H100 block may use (opt-in),
// SMEM_STATIC kept for static shared memory (bulk_op's table, the
// windows' row bits and counts).  R, the stack rows on chip, is the
// depth D up to what the rest of the budget holds in whole 32-row steps
// and at most STACK_ROWS_MAX (512 rows: 128 KiB of two planes), which
// leaves the SM's L1 room for the code tables, frames and globals;
// batch/interp.py `block_geometry` is the same rule.
constexpr int SMEM_BLOCK_MAX = 232448;
constexpr int SMEM_STATIC = 3072;
constexpr int STACK_ROWS_MAX = 512;

template <bool kSimd, bool kWin>
int stack_rows(int D) {
  const int budget = SMEM_BLOCK_MAX - SMEM_STATIC - (kWin ? WIN_SMEM_BYTES : 0);
  int rows = (budget / (Lane<kSimd>::kPlanes * 4 * BLOCK_THREADS)) & ~31;
  if (rows > STACK_ROWS_MAX) rows = STACK_ROWS_MAX;
  return D < rows ? (D > 0 ? D : 0) : rows;
}

// The dynamic shared bytes of a launch at depth D, and the kernel's limit
// set to them (above the 48 KiB default only as dynamic shared memory); a
// card without room fails here or at the launch, and the wrapper raises.
template <bool kSimd, bool kWin, class K>
int block_smem(K kernel, int D, size_t* bytes) {
  *bytes = (size_t)(kWin ? WIN_SMEM_BYTES : 0) +
           (size_t)stack_rows<kSimd, kWin>(D) * Lane<kSimd>::kPlanes * 4 *
               BLOCK_THREADS;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

// kOpt: the per-warp tensors and the shadow planes a snapshot writes
// (the e2/e3 shadows with kSimd, the memory's without kWin).
template <bool kSimd, bool kWin, bool kOpt>
bool opt_args_ok(const Params& p) {
  if (!kOpt) return true;
  if (!p.w_snap || !p.w_rollbacks || !p.w_entered || !p.w_commits ||
      !p.w_uniform ||
      !p.sh_lo || !p.sh_hi || !p.sh_fr_ret_pc || !p.sh_fr_fp ||
      !p.sh_fr_opbase || !p.sh_glo || !p.sh_ghi || p.snap_max < 1)
    return false;
  if (kSimd && (!p.sh_e2 || !p.sh_e3)) return false;
  return kWin || p.W <= 1 || p.sh_mem;
}

template <bool kBulk, bool kSimd, class F, bool kWin, bool kOpt>
int launch_kernel(const Params& p, cudaStream_t st) {
  if (!opt_args_ok<kSimd, kWin, kOpt>(p)) return (int)cudaErrorInvalidValue;
  // tier 0 only in a build with its handlers, and then with its planes
  if ((p.t0.on != 0) != kTier0) return (int)cudaErrorInvalidValue;
  if (kTier0 && (!p.t0.kind || !p.t0.ctr || (p.t0.so_buf && !p.t0.so_off)))
    return (int)cudaErrorInvalidValue;
  // the tables' and weighted gas's handlers only in builds with them, and
  // then with their planes
  if ((p.a3.on != 0) != kTables || (p.a3.gas_on != 0) != kGas)
    return (int)cudaErrorInvalidValue;
  if (kTables && (!p.a3.efl || !p.a3.eoff || !p.a3.elen || !p.a3.dwords ||
                  !p.a3.doff || !p.a3.dlen || (!p.a3.tab != !p.a3.tsize) ||
                  p.a3.tcap < 1 || p.a3.n_efl < 1 || p.a3.n_dwords < 1))
    return (int)cudaErrorInvalidValue;
  if (kGas && (!p.a3.cost || !p.a3.gcum)) return (int)cudaErrorInvalidValue;
  // a build without the split runs only depths whose rows all fit on chip
  if (!kStackSplit && stack_rows<kSimd, kWin>(p.D) < p.D)
    return (int)cudaErrorInvalidValue;
  if (p.width < 0 || p.width > p.L) return (int)cudaErrorInvalidValue;
  const int blocks = (p.width + BLOCK_THREADS - 1) / BLOCK_THREADS;
  if (blocks <= 0) return 0;
  size_t smem;
  const auto k = interp_kernel<kBulk, kSimd, F, kWin, kOpt>;
  const int err = block_smem<kSimd, kWin>(k, p.D, &smem);
  if (err != 0) return err;
  Params q = p;
  q.srows = stack_rows<kSimd, kWin>(p.D);
  k<<<blocks, BLOCK_THREADS, smem, st>>>(q);
  return (int)cudaGetLastError();
}

// What the runtime reports of an instantiation, with the shared memory of
// its launch at depth D: registers, local (stack) bytes per thread, static
// and maximum dynamic shared bytes per block, the dynamic bytes a launch
// asks for, the blocks of BLOCK_THREADS threads that fit on one SM, the
// threads per block, the stack rows on chip and whether the build splits
// the stack (WASM_STACK_SPLIT).
template <bool kBulk, bool kSimd, class F, bool kWin, bool kOpt>
int kernel_attrs(int D, int* out) {
  const auto k = interp_kernel<kBulk, kSimd, F, kWin, kOpt>;
  size_t smem;
  int err = block_smem<kSimd, kWin>(k, D, &smem);
  if (err != 0) return err;
  cudaFuncAttributes a;
  err = (int)cudaFuncGetAttributes(&a, k);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                           BLOCK_THREADS, smem);
  if (err != 0) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxDynamicSharedSizeBytes;
  out[4] = (int)smem;
  out[5] = blocks;
  out[6] = BLOCK_THREADS;
  out[7] = stack_rows<kSimd, kWin>(D);
  out[8] = kStackSplit ? 1 : 0;
  return 0;
}

}  // namespace

// The pointer arguments of optimistic convergence (null for a careful
// launch), after the state planes (and a fused build's tables).
#define WASM_OPT_ARGS                                                       \
  int *w_snap, int *w_rollbacks, int *w_entered, int *w_commits,          \
      int *w_uniform, int *sh_lo, int *sh_hi, int *sh_e2, int *sh_e3,     \
      int *sh_fr_ret_pc, int *sh_fr_fp, int *sh_fr_opbase, int *sh_glo,   \
      int *sh_ghi, int *sh_mem
#define WASM_OPT_FIELDS                                                     \
  w_snap, w_rollbacks, w_entered, w_commits, w_uniform, sh_lo, sh_hi,     \
      sh_e2, sh_e3, sh_fr_ret_pc, sh_fr_fp, sh_fr_opbase, sh_glo, sh_ghi, \
      sh_mem
// Tier 0's arguments (T0Args; null and 0 for a build without it): its
// pointers after the optimistic ones, its ints after snap_max.
#define WASM_T0_PTR_ARGS const int *t0k, int *t0_ctr, int *so_buf, int *so_off
#define WASM_T0_INT_ARGS                                                  \
  int t0_on, int t0_sw, int t0_seed, int t0_rmax_w, int t0_wmax_w,        \
      int t0_rt_lo, int t0_rt_hi, int t0_mono_lo, int t0_mono_hi
// The tables' and weighted gas's arguments (A3Args; null and 0 for a
// build without them): pointers after tier 0's, ints after tier 0's.
#define WASM_A3_PTR_ARGS                                                  \
  int *tab, int *tsize_p, int *edrop, int *ddrop, const int *efl,         \
      const int *eoff, const int *elen, const int *dwords,                \
      const int *doff, const int *dlen, const int *cost, const int *gcum
#define WASM_A3_INT_ARGS                                                  \
  int a3_on, int tcap, int n_elem, int n_data, int n_efl, int n_dwords,   \
      int gas_on
#define WASM_A3_FIELDS                                                    \
  A3Args {                                                                \
    tab, tsize_p, edrop, ddrop, efl, eoff, elen, dwords, doff, dlen,      \
        cost, gcum, a3_on, tcap, n_elem, n_data, n_efl, n_dwords, gas_on  \
  }
#define WASM_T0_FIELDS                                                    \
  T0Args {                                                                \
    t0k, t0_ctr, so_buf, so_off, t0_on, t0_sw, t0_seed, t0_rmax_w,        \
        t0_wmax_w, t0_rt_lo, t0_rt_hi, t0_mono_lo, t0_mono_hi             \
  }

// A device counter array of this library into out, then set to 0 when
// `clear`.
template <class T>
int read_counts(const T& sym, unsigned long long* out, int clear) {
  int err = (int)cudaMemcpyFromSymbol(out, sym, sizeof(T));
  if (err != 0 || !clear) return err;
  const T zero = {};
  return (int)cudaMemcpyToSymbol(sym, zero, sizeof(T));
}

// The bulk counts of this library's kernels (g_bulk_counts: warp passes,
// the lanes that took them, per-lane walks) into out[3].
extern "C" int wasm_bulk_counts(unsigned long long* out, int clear) {
  return read_counts(g_bulk_counts, out, clear);
}
// The window counts (g_win_counts: hits, misses, ways written back, the
// rows they stored, rows filled) into out[5].
extern "C" int wasm_win_counts(unsigned long long* out, int clear) {
  return read_counts(g_win_counts, out, clear);
}
// The entry compares (g_entry_counts: compares, their cycles summed over
// warps) into out[2].
extern "C" int wasm_entry_counts(unsigned long long* out, int clear) {
  return read_counts(g_entry_counts, out, clear);
}
#if WASM_TURN_COUNTS
// The dispatch loop's turns (g_turn_counts: lane turns, warp turns).
extern "C" int wasm_turn_counts(unsigned long long* out, int clear) {
  return read_counts(g_turn_counts, out, clear);
}
#endif

#ifndef WASM_FUSED_BUILD
// The shared per-op build: interp.cu alone, with WASM_MEM_WINDOW 0
// (direct memory access) or 1 (the window cache), WASM_OPTIMISTIC 0 (the
// careful loop) or 1 (optimistic convergence) and WASM_STACK_SPLIT, four
// instantiations each, as libraries built side by side.
#ifndef WASM_MEM_WINDOW
#define WASM_MEM_WINDOW 0
#endif
#ifndef WASM_OPTIMISTIC
#define WASM_OPTIMISTIC 0
#endif
extern "C" int wasm_interp_launch(
    const int* hid, const int* a, const int* b, const int* c, const int* ilo,
    const int* ihi, const int* fent, const int* fnpar, const int* fnloc,
    const int* ftop, const int* ftyp, const int* brt, const int* tbl,
    const int* v128, int* pc, int* sp, int* fp, int* opbase, int* call_depth,
    int* trap, int* retired, int* fuel, int* mem_pages, int* stack_lo,
    int* stack_hi, int* stack_e2, int* stack_e3, int* fr_ret_pc, int* fr_fp,
    int* fr_opbase, int* glob_lo, int* glob_hi, int* mem, WASM_OPT_ARGS,
    WASM_T0_PTR_ARGS, WASM_A3_PTR_ARGS, int code_len, int nf, int n_brt,
    int tsize, int nv, int L, int D, int CD, int NG, int W, int chunk,
    int fuel_on, int max_local_zeros, int bulk, int simd, int win, int opt,
    int snap_max, WASM_T0_INT_ARGS, WASM_A3_INT_ARGS, int width,
    void* stream) {
  Params p{hid, a, b, c, ilo, ihi, fent, fnpar, fnloc, ftop, ftyp, brt, tbl,
           pc, sp, fp, opbase, call_depth, trap, retired, fuel, mem_pages,
           stack_lo, stack_hi, fr_ret_pc, fr_fp, fr_opbase, glob_lo, glob_hi,
           mem, code_len, nf, n_brt, tsize, L, D, CD, NG, W, chunk, fuel_on,
           max_local_zeros, v128, stack_e2, stack_e3, nv,
           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           WASM_OPT_FIELDS, snap_max};
  p.t0 = WASM_T0_FIELDS;
  p.a3 = WASM_A3_FIELDS;
  p.width = width;
  constexpr bool kWin = WASM_MEM_WINDOW != 0;
  constexpr bool kOpt = WASM_OPTIMISTIC != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if ((win != 0) != kWin || (kWin && W < WIN_ROWS) || (opt != 0) != kOpt)
    return (int)cudaErrorInvalidValue;
  if (simd && (stack_e2 == nullptr || stack_e3 == nullptr))
    return (int)cudaErrorInvalidValue;
#if WASM_TIER0 || WASM_TABLES || WASM_GAS
  // a build with handlers compiled in on request holds one instantiation
  constexpr bool kB = WASM_ONE_BULK != 0, kS = WASM_ONE_SIMD != 0;
  if ((bulk != 0) != kB || (simd != 0) != kS) return (int)cudaErrorInvalidValue;
  return launch_kernel<kB, kS, NoFusion, kWin, kOpt>(p, st);
#else
  if (bulk && simd) return launch_kernel<true, true, NoFusion, kWin, kOpt>(p, st);
  if (bulk) return launch_kernel<true, false, NoFusion, kWin, kOpt>(p, st);
  if (simd) return launch_kernel<false, true, NoFusion, kWin, kOpt>(p, st);
  return launch_kernel<false, false, NoFusion, kWin, kOpt>(p, st);
#endif
}

// kernel_attrs of the instantiation a launch with these flags runs, at
// depth D (nine ints into out).
extern "C" int wasm_interp_attrs(int bulk, int simd, int D, int* out) {
  constexpr bool kWin = WASM_MEM_WINDOW != 0;
  constexpr bool kOpt = WASM_OPTIMISTIC != 0;
#if WASM_TIER0 || WASM_TABLES || WASM_GAS
  constexpr bool kB = WASM_ONE_BULK != 0, kS = WASM_ONE_SIMD != 0;
  if ((bulk != 0) != kB || (simd != 0) != kS) return (int)cudaErrorInvalidValue;
  return kernel_attrs<kB, kS, NoFusion, kWin, kOpt>(D, out);
#else
  if (bulk && simd) return kernel_attrs<true, true, NoFusion, kWin, kOpt>(D, out);
  if (bulk) return kernel_attrs<true, false, NoFusion, kWin, kOpt>(D, out);
  if (simd) return kernel_attrs<false, true, NoFusion, kWin, kOpt>(D, out);
  return kernel_attrs<false, false, NoFusion, kWin, kOpt>(D, out);
#endif
}
#endif  // WASM_FUSED_BUILD
