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
// bounds it on this card is the latency of the dependent global-memory
// accesses each instruction makes (handler id, operands, result), not
// bandwidth: with 4096 lanes there are only 128 warps.  Keeping stack and
// memory windows in shared memory is later work.
//
// Host calls: a lane at a HOSTCALL stub parks (trap = TRAP_HOSTCALL, pc
// left at the stub); the host serves it between launches and re-arms it
// at the stub's RETURN, so the kernel itself never leaves the card.
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
//
// memory.fill / memory.copy run one lane per thread over the lane's own
// column of mem[W, L], a word per step, so the lanes of a converged warp
// write one 128-byte row per step.  The work is bounded by bytes (each
// byte filled is written once, each byte copied read and written once),
// but with one thread per lane 4096 lanes make about one warp per SM, so
// the loop runs far above that bound (PERF.md).  It keeps eight words in
// flight per thread, reading all eight sources before it writes, which
// is safe for memmove because a copy walks away from the bytes it has
// not read yet (backward when dst > src).
//
// Numerics are IEEE-strict: build with -fmad=false and without -ftz or
// --use_fast_math; every float op uses an _rn intrinsic and NaNs are
// canonicalised as the reference does.  Integer arithmetic runs on
// unsigned types (no signed-overflow UB), shift counts are masked, and
// INT_MIN / -1 and division by zero are caught before dividing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int E_MEM_OOB = 0x88;
constexpr int E_UNINIT_ELEM = 0x8A;
constexpr int E_UNDEF_ELEM = 0x8B;
constexpr int E_SIG_MISMATCH = 0x8C;
constexpr int E_CALL_STACK = 0x90;
constexpr int E_STACK_OVERFLOW = 0x91;
constexpr int E_COST_LIMIT = 0x92;
constexpr int E_EXEC_FAILED = 0x95;

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
constexpr int NUM_HANDLERS = 1066;

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
      max_local_zeros, mem_pages_max;
  // v128 (kSimd): appended, so that the fields above keep their places
  const i32* __restrict__ v128;  // [nv, 4]: v128.const values, masks
  i32* stack_e2;                 // null unless the image holds v128 ops
  i32* stack_e3;
  int nv;
};

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
__device__ u64 alu2_i32(int op, u32 x, u32 y, int& trap) {
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

__device__ u64 alu2_i64(int op, u64 x, u64 y, int& trap) {
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

__device__ u64 alu2_f32(int op, u32 x, u32 y) {
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

__device__ u64 alu2_f64(int op, u64 x, u64 y) {
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
__device__ u64 alu1_trunc(u64 w, bool src32, bool to32, bool is_signed, bool sat,
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

__device__ u64 alu1(int sub, u64 w, int& trap) {
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

// Binary v128 ops: x is the cell below the top, y the top.
__device__ __noinline__ V4 v2_op(int sub, V4 x, V4 y) {
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

// The ALU1 sub (image.py ALU1_SUB) of f32x4 / f64x2 op `op` of abs neg
// sqrt ceil floor trunc nearest.
__device__ __forceinline__ int a1_f32(int op) {
  return op == 0 ? 13 : op == 1 ? 14 : op == 2 ? 19 : 12 + op;
}
__device__ __forceinline__ int a1_f64(int op) {
  return op == 0 ? 32 : op == 1 ? 33 : op == 2 ? 38 : 31 + op;
}

// Unary v128 ops.
__device__ __noinline__ V4 v1_op(int sub, V4 x) {
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
// Access to one lane's column of the [rows, L] planes, rows clamped into
// the plane as the reference's gathers and scatters clamp them.  Holds
// copies of the pointers (never a reference to the kernel parameters, so
// they stay in the constant bank).  With kSimd a stack cell is four words
// (lo, hi, e2, e3) and `Cell` is the whole cell; without it, 64 bits.
template <bool kSimd>
struct Lane {
  i32* lo;
  i32* hi;
  i32* e2;
  i32* e3;
  int L, D, lane;
  using Cell = typename std::conditional<kSimd, V4, u64>::type;
  __device__ __forceinline__ size_t at(int row, int rows) const {
    return (size_t)clampi(row, 0, rows - 1) * (size_t)L + (size_t)lane;
  }
  __device__ __forceinline__ u64 get(int row) const {
    const size_t i = at(row, D);
    return pack(lo[i], hi[i]);
  }
  // a scalar write: zeroes e2 and e3 of a four-word cell
  __device__ __forceinline__ void put(int row, u64 v) const {
    const size_t i = at(row, D);
    lo[i] = lo32(v);
    hi[i] = hi32(v);
    if constexpr (kSimd) {
      e2[i] = 0;
      e3[i] = 0;
    }
  }
  __device__ __forceinline__ V4 get4(int row) const {
    const size_t i = at(row, D);
    return V4{{(u32)lo[i], (u32)hi[i], (u32)e2[i], (u32)e3[i]}};
  }
  __device__ __forceinline__ void put4(int row, const V4& v) const {
    const size_t i = at(row, D);
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
};

// memory.fill (copy = false, v = the fill byte) or memory.copy (copy =
// true, v = the source address) of bytes [dst, end) in one lane's column,
// end > dst, both ranges already bounds-checked.  Words are masked at the
// two byte edges; rows beyond the plane are not written and source rows
// are clamped into it, as laneops.plane_fill_copy does.  Each group of up
// to BULK_GROUP words reads every source word before it writes any: a
// forward copy (src > dst) reads words at or above the ones it writes, a
// backward copy (dst > src) words at or below them, and words already
// written lie behind the walk, so every source byte is read before it is
// overwritten (memmove).
constexpr int BULK_GROUP = 8;

__device__ void bulk_fill_copy(i32* mem, int L, int W, int lane, u32 dst,
                               u32 end, u32 v, bool copy) {
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

// One v128 instruction, handler h >= H_VCONST at pcc (kSimd only).
// Returns its trap code: a v128.load / v128.store out of bounds writes
// nothing.
template <bool kSimd>
__device__ __forceinline__ int simd_step(const Params& p,
                                         const Lane<kSimd>& s, int h,
                                         int pcc, int sp, int pages,
                                         int& new_sp) {
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
  const u32 base = (u32)s.get(store ? sp - 2 : sp - 1);
  const u32 ea = base + off, end = ea + 16u;
  const u32 mem_bytes = (u32)pages * 65536u;
  if (ea < base || ea < off || end < ea || mem_bytes < end) return E_MEM_OOB;
  const int widx = (int)(ea >> 2);
  const u32 sh = (ea & 3u) * 8u;
  if (!store) {
    u32 w[5];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      w[k] = k < 4 || sh ? (u32)p.mem[s.at(widx + k, p.W)] : 0u;
    V4 r;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.w[k] = sh ? (w[k] >> sh) | (w[k + 1] << (32u - sh)) : w[k];
    s.put4(sp - 1, r);
    return 0;
  }
  const V4 v = s.get4(sp - 1);
  new_sp = sp - 2;
  if (sh == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) p.mem[s.at(widx + k, p.W)] = (i32)v.w[k];
    return 0;
  }
  // the 16 bytes span five words: keep the bytes below ea in the first
  // and those from ea + 16 on in the last
  const u32 keep = 0xFFFFFFFFu << sh;
  i32* w0 = &p.mem[s.at(widx, p.W)];
  i32* w4 = &p.mem[s.at(widx + 4, p.W)];
  *w0 = (i32)(((u32)*w0 & ~keep) | (v.w[0] << sh));
#pragma unroll
  for (int k = 1; k < 4; ++k)
    p.mem[s.at(widx + k, p.W)] =
        (i32)((v.w[k] << sh) | (v.w[k - 1] >> (32u - sh)));
  *w4 = (i32)(((u32)*w4 & keep) | (v.w[3] >> (32u - sh)));
  return 0;
}

// kBulk: the image holds memory.fill / memory.copy.  An image without
// them runs the instantiation that has no bulk loop, as the reference
// SIMT step compiles its bulk path only for such images (HAS_BULK,
// engine.py:1007): compiled into the dispatch loop, the bulk loop raised
// the kernel from 40 to 48 registers and slowed fib(30) x 4096 on an
// H100 by 6 %, and out of line (__noinline__) it still cost 1-2 %
// (PERF.md).  kSimd: the image holds v128 ops (four-word cells and the
// B7 handlers, above); without them nothing of v128 is compiled in.
template <bool kBulk, bool kSimd>
__global__ void __launch_bounds__(128) interp_kernel(const Params p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.L) return;
  if (p.trap[lane] != 0) return;
  const Lane<kSimd> s{p.stack_lo, p.stack_hi, p.stack_e2, p.stack_e3,
                      p.L,        p.D,        lane};
  int pc = p.pc[lane], sp = p.sp[lane], fp = p.fp[lane], ob = p.opbase[lane];
  int cd = p.call_depth[lane], retired = p.retired[lane], fuel = p.fuel[lane];
  int pages = p.mem_pages[lane];
  int trap = 0;

  for (int step = 0; step < p.chunk; ++step) {
    const int pcc = clampi(pc, 0, p.code_len - 1);
    const int h = __ldg(&p.hid[pcc]);
    int new_pc = pcc + 1, new_sp = sp, new_fp = fp, new_ob = ob, new_cd = cd;
    int ntrap = 0;
    int sp_halt = sp;

    if (h >= H_ALU2_BASE && h < H_ALU2_BASE + NUM_ALU2) {
      const u64 y = s.get(sp - 1), x = s.get(sp - 2);
      s.put(sp - 2, alu2(h - H_ALU2_BASE, x, y, ntrap));  // written even on a trap
      new_sp = sp - 1;
    } else if (h >= H_ALU1_BASE && h < H_ALU1_BASE + NUM_ALU1) {
      const int sub = h - H_ALU1_BASE;
      u64 r = alu1(sub, s.get(sp - 1), ntrap);
      if (ntrap != 0 && (sub == 23 || sub == 24)) r = 0;  // f32 -> i32 trap writes 0
      s.put(sp - 1, r);
    } else if (kSimd && h >= H_VCONST) {
      ntrap = simd_step<kSimd>(p, s, h, pcc, sp, pages, new_sp);
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
          if ((u32)s.get(sp - 1) == 0) new_pc = __ldg(&p.a[pcc]);
          break;
        case H_BRNZ: {
          if ((u32)s.get(sp - 1) != 0) {
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
          const i32 idx = (i32)(u32)s.get(sp - 1);
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
            const size_t r = s.at(cd - 1, p.CD);
            new_pc = p.fr_ret_pc[r];
            new_fp = p.fr_fp[r];
            new_ob = p.fr_opbase[r];
            new_cd = cd - 1;
          }
          break;
        }
        case H_CALL:
        case H_CALL_INDIRECT: {
          const int a = __ldg(&p.a[pcc]);
          int callee, sp_eff = sp, code = 0;
          if (h == H_CALL) {
            callee = clampi(a, 0, p.nf - 1);
          } else {
            const int b = __ldg(&p.b[pcc]), c = __ldg(&p.c[pcc]);
            const i32 idx = (i32)(u32)s.get(sp - 1);
            const int ti = clampi(c + clampi(idx, 0, b - 1 > 0 ? b - 1 : 0), 0,
                                  p.tsize - 1);
            const int handle = __ldg(&p.tbl[ti]);
            const bool oob = !((u32)idx < (u32)b);
            const bool null_ref = !oob && handle == 0;
            callee = clampi(handle - 1, 0, p.nf - 1);
            if (oob) code = E_UNDEF_ELEM;
            if (null_ref) code = E_UNINIT_ELEM;
            if (!oob && !null_ref && __ldg(&p.ftyp[callee]) != a) code = E_SIG_MISMATCH;
            sp_eff = sp - 1;
          }
          const int npar = __ldg(&p.fnpar[callee]), nloc = __ldg(&p.fnloc[callee]);
          const int fp_new = sp_eff - npar, ob_new = fp_new + nloc;
          if (cd >= p.CD - 1) code = E_CALL_STACK;
          if (fp_new + __ldg(&p.ftop[callee]) > p.D) code = E_STACK_OVERFLOW;
          if (code == 0) {
            const size_t r = s.at(cd, p.CD);
            p.fr_ret_pc[r] = pcc + 1;
            p.fr_fp[r] = fp;
            p.fr_opbase[r] = ob;
            for (int k = 0; k < nloc - npar && k < p.max_local_zeros; ++k)
              s.put(fp_new + npar + k, 0);
          }
          ntrap = code;
          new_pc = __ldg(&p.fent[callee]);
          new_fp = fp_new;
          new_ob = ob_new;
          new_sp = ob_new;
          new_cd = cd + 1;
          break;
        }
        case H_MEMSIZE:
          s.put(sp, cell32((u32)pages));
          new_sp = sp + 1;
          break;
        case H_MEMGROW: {
          const i32 delta = (i32)(u32)s.get(sp - 1);
          const i32 grown = (i32)((u32)pages + (u32)delta);
          const bool ok = !((u32)p.mem_pages_max < (u32)grown) && delta >= 0 &&
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
          const u32 base = (u32)s.get(is_store ? sp - 2 : sp - 1);
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
          size_t wi[3];
          u32 w[3];
          for (int k = 0; k < 3; ++k) {
            wi[k] = s.at(widx + k, p.W);
            w[k] = (u32)p.mem[wi[k]];
          }
          if (!is_store) {
            const int c = __ldg(&p.c[pcc]);
            const bool sgn = (c & 1) != 0, is64 = (c & 2) != 0;
            const u32 raw_lo = sh ? (w[0] >> sh) | (w[1] << (32 - sh)) : w[0];
            const u32 raw_hi = sh ? (w[1] >> sh) | (w[2] << (32 - sh)) : w[1];
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
            for (int k = 0; k < 3; ++k)
              if (mk[k] != 0) p.mem[wi[k]] = (i32)((w[k] & ~mk[k]) | (vk[k] & mk[k]));
          }
          break;
        }
        default:
          // The host-call park and bulk memory sit here, not under case
          // labels of their own: as cases they slowed fib(30) x 4096, which
          // runs neither, by 1.5 % on an H100 (PERF.md).
          if (h == H_HOSTCALL) {
            // park: retired and charged like any instruction; the halt
            // path below keeps pc at the stub and sp as it is
            ntrap = TRAP_HOSTCALL;
            break;
          }
          if (!kBulk || (h != H_MEMFILL && h != H_MEMCOPY)) {
            ntrap = E_EXEC_FAILED;  // the engine refuses such images up front
            break;
          }
          {
            // memory.fill / memory.copy; stack: dst, fill value or
            // source, n (top)
            const bool copy = h == H_MEMCOPY;
            const u32 n = (u32)s.get(sp - 1), v = (u32)s.get(sp - 2);
            const u32 dst = (u32)s.get(sp - 3);
            const u32 mem_bytes = (u32)pages * 65536u;
            const u32 end = dst + n;
            bool oob = end < dst || mem_bytes < end;
            if (copy) oob = oob || v + n < v || mem_bytes < v + n;
            if (oob) {
              ntrap = E_MEM_OOB;  // nothing written
              break;
            }
            if (n != 0)
              bulk_fill_copy(p.mem, p.L, p.W, lane, dst, end, v, copy);
            new_sp = sp - 3;
          }
          break;
      }
    }

    ++retired;
    if (p.fuel_on) {
      --fuel;
      if (ntrap == 0 && fuel <= 0) ntrap = E_COST_LIMIT;
    }
    if (ntrap != 0) {
      // a halted lane keeps its pre-instruction control state
      trap = ntrap;
      sp = sp_halt;
      break;
    }
    pc = new_pc;
    sp = new_sp;
    fp = new_fp;
    ob = new_ob;
    cd = new_cd;
  }

  p.pc[lane] = pc;
  p.sp[lane] = sp;
  p.fp[lane] = fp;
  p.opbase[lane] = ob;
  p.call_depth[lane] = cd;
  p.trap[lane] = trap;
  p.retired[lane] = retired;
  p.fuel[lane] = fuel;
  p.mem_pages[lane] = pages;
}

}  // namespace

extern "C" int wasm_interp_launch(
    const int* hid, const int* a, const int* b, const int* c, const int* ilo,
    const int* ihi, const int* fent, const int* fnpar, const int* fnloc,
    const int* ftop, const int* ftyp, const int* brt, const int* tbl,
    const int* v128, int* pc, int* sp, int* fp, int* opbase, int* call_depth,
    int* trap, int* retired, int* fuel, int* mem_pages, int* stack_lo,
    int* stack_hi, int* stack_e2, int* stack_e3, int* fr_ret_pc, int* fr_fp,
    int* fr_opbase, int* glob_lo, int* glob_hi, int* mem, int code_len,
    int nf, int n_brt, int tsize, int nv, int L, int D, int CD, int NG, int W,
    int chunk, int fuel_on, int max_local_zeros, int mem_pages_max,
    int bulk, int simd, void* stream) {
  Params p{hid, a, b, c, ilo, ihi, fent, fnpar, fnloc, ftop, ftyp, brt, tbl,
           pc, sp, fp, opbase, call_depth, trap, retired, fuel, mem_pages,
           stack_lo, stack_hi, fr_ret_pc, fr_fp, fr_opbase, glob_lo, glob_hi,
           mem, code_len, nf, n_brt, tsize, L, D, CD, NG, W, chunk, fuel_on,
           max_local_zeros, mem_pages_max, v128, stack_e2, stack_e3, nv};
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks > 0) {
    if (simd && (stack_e2 == nullptr || stack_e3 == nullptr))
      return (int)cudaErrorInvalidValue;
    if (bulk && simd)
      interp_kernel<true, true><<<blocks, threads, 0, st>>>(p);
    else if (bulk)
      interp_kernel<true, false><<<blocks, threads, 0, st>>>(p);
    else if (simd)
      interp_kernel<false, true><<<blocks, threads, 0, st>>>(p);
    else
      interp_kernel<false, false><<<blocks, threads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
