// Tier 0's stdout flush on the card (sm_90a): each lane's buffered
// fd_write records cut out into one byte stream per fd.
//
// Replaces no TPU kernel: the JAX package's flush is host code
// (wasmedge_tpu/batch/hostcall.py `flush_stdout_buffers`, :214), the host
// half of the tier-0 calls that its SIMT step retires (engine.py
// :1309-1449; the Pallas kernel `h_hostcall`, pallas_engine.py :1520,
// parks every call).  Its plain version is batch/hostcall.py `_records`,
// which downloads the buffer's rows below the largest fill and cuts the
// records out on the host.
//
// The buffer is the [SW, L] int32 plane `so_buf`, lane fastest: lane l's
// records lie in its column, rows [0, so_off[l]), each a header
// `fd << 28 | len` and the payload padded to whole words.  What the host
// writes is, for fd 1 and for fd 2, the payload bytes of every lane's
// records to that fd, lane after lane and each lane's records in order,
// with the first skip[l] payload bytes of lane l's records (over both
// fds) left out: a replay below the stdout cursor's high-water mark.
// Each lane's payload bytes, the skipped ones included, advance its
// cursor (`lens`).
//
// Three launches on the caller's stream, one-warp blocks for the lanes:
//  1. flush_count, a thread a lane: walks the lane's headers and counts
//     its bytes to fd 1 and to fd 2 after the skip, and its payload
//     bytes (lens); flags lanes whose records reach past the fill or
//     name another fd (the tier-0 gate makes both unreachable).
//  2. flush_scan, one block: an exclusive scan over the 2L counts (fd
//     1's lanes, then fd 2's), kPer contiguous counts a thread, so each
//     lane has its two offsets in the output, fd 2's stream right after
//     fd 1's.
//  3. flush_copy, a thread a lane: walks the records again and writes
//     the bytes after the skip at its offsets.  Rows of adjacent lanes
//     are adjacent words, so a warp whose lanes hold one layout (echo,
//     any converged batch) reads each row as one 128-byte transaction;
//     a record of up to kPre words is loaded in one round and cut from
//     registers; a skip or offset that is not a multiple of 4 is handled
//     by funnel shifts on the words read and byte stores at the two ends
//     of each lane's piece, whole aligned words between them.
// What bounds it on this card: not bytes (about 1.2 MB for echo x 4096,
// well under a microsecond at the HBM rate) but each lane's chain of
// dependent loads (a header gives the next header's row) and the three
// launches; the per-fd counts and writers are kept in registers (as
// arrays indexed by the fd they were local memory, PERF.md).  The host
// then copies exactly the stream's bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef uint32_t u32;
typedef uint64_t u64;
typedef long long i64;

// one warp a block: 4096 lanes are 128 blocks, spread over the SMs (a
// lane's walk is a chain of dependent loads; more warps an SM hide none
// of it)
constexpr int kThreads = 32;
constexpr int kScanThreads = 1024;
constexpr int kPer = 8;  // scan elements a thread: 2 L <= 8192 in one tile
constexpr int kPre = 8;  // payload words a record's copy loads at once

// meta [kMeta + L]: bytes to fd 1, to fd 2, lanes with records, lanes
// with a bad record, then each lane's payload bytes
constexpr int kMeta = 4;

__device__ __forceinline__ u32 word_at(const int* buf, int L, int row,
                                       int lane) {
  return (u32)__ldg(&buf[(size_t)row * L + lane]);
}

__global__ void __launch_bounds__(kThreads)
    flush_count(const int* so_buf, const int* so_off, const int* skip, int SW,
                int L, int* meta, i64* cnt) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int fill = so_off[lane];
  const int end = fill < 0 ? 0 : (fill > SW ? SW : fill);
  int k = skip[lane];
  // bytes to fd 1 and 2 (two registers: an array indexed by the fd was
  // local memory)
  i64 n1 = 0, n2 = 0;
  int total = 0;
  bool bad = fill > SW;
  for (int off = 0; off < end;) {
    const u32 hdr = word_at(so_buf, L, off, lane);
    const int fd = (int)(hdr >> 28), ln = (int)(hdr & 0x0FFFFFFFu);
    const int s = k < ln ? k : ln;
    k -= s;
    if (fd == 1)
      n1 += ln - s;
    else if (fd == 2)
      n2 += ln - s;
    else
      bad = true;
    total += ln;
    off += 1 + (ln + 3) / 4;
    if (off > end) bad = true;
  }
  cnt[lane] = n1;
  cnt[L + lane] = n2;
  meta[kMeta + lane] = total;
  if (end > 0) atomicAdd(&meta[2], 1);
  if (bad) atomicAdd(&meta[3], 1);
}

// exclusive scan of cnt [n = 2 L] in place, one block, kPer contiguous
// elements a thread (loaded together: one round of loads a tile, not
// kPer); the two totals to meta
__global__ void __launch_bounds__(kScanThreads)
    flush_scan(i64* __restrict__ cnt, int n, int L, int* __restrict__ meta) {
  __shared__ i64 warp_sums[kScanThreads / 32];
  __shared__ i64 carry;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  if (t == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kScanThreads * kPer) {
    const int i0 = base + t * kPer;
    i64 v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = i0 + j < n ? cnt[i0 + j] : 0;
    i64 sum = 0;  // the thread's elements, exclusive
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const i64 x = v[j];
      v[j] = sum;
      sum += x;
    }
    i64 x = sum;  // the warp's threads, inclusive
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const i64 y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
      i64 w = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const i64 y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const i64 before = carry + (wid ? warp_sums[wid - 1] : 0) + x - sum;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = i0 + j;
      if (i < n) cnt[i] = before + v[j];
      // fd 1's stream ends where fd 2's starts
      if (i == L) meta[0] = (int)(before + v[j]);
    }
    __syncthreads();
    if (t == kScanThreads - 1) carry = before + sum;
    __syncthreads();
  }
  if (t == 0) meta[1] = (int)carry - meta[0];
}

// A lane's piece of one fd's stream: bytes appended in order, stored as
// single bytes up to a word boundary and at the end, as whole words
// between (the pieces of neighbouring lanes share the end words).
struct Writer {
  unsigned char* out;
  i64 pos;
  u64 acc = 0;
  int n = 0;
  __device__ __forceinline__ void put(u32 v, int nb) {
    if (nb < 4) v &= (1u << (8 * nb)) - 1u;
    acc |= (u64)v << (8 * n);
    n += nb;
    while (n > 0 && (pos & 3)) {
      out[pos++] = (unsigned char)acc;
      acc >>= 8;
      --n;
    }
    while (n >= 4) {
      *reinterpret_cast<u32*>(out + pos) = (u32)acc;
      acc >>= 32;
      n -= 4;
      pos += 4;
    }
  }
  __device__ __forceinline__ void finish() {
    while (n > 0) {
      out[pos++] = (unsigned char)acc;
      acc >>= 8;
      --n;
    }
  }
};

// bytes [s, ln) of the payload of nw words at rows row0 ... of `lane`
// to `wr`: 4-byte chunks from byte s, each the funnel shift of two
// adjacent words
__device__ __forceinline__ void append(Writer& wr, const int* buf, int L,
                                       int lane, int row0, int nw, int s,
                                       int ln) {
  int q = s >> 2;
  const u32 sh = (u32)(s & 3) * 8u;
  u32 cur = word_at(buf, L, row0 + q, lane);
  for (int b = s; b < ln; b += 4, ++q) {
    const u32 nxt = q + 1 < nw ? word_at(buf, L, row0 + q + 1, lane) : 0u;
    const u32 chunk = sh ? __funnelshift_r(cur, nxt, sh) : cur;
    wr.put(chunk, ln - b < 4 ? ln - b : 4);
    cur = nxt;
  }
}

// word i of the kPre words w (0 past them), by selects: registers, where
// an index that is not known when compiled puts w in local memory
__device__ __forceinline__ u32 pick(const u32 (&w)[kPre], int i) {
  u32 r = 0u;
#pragma unroll
  for (int j = 0; j < kPre; ++j) r = i == j ? w[j] : r;
  return r;
}

// bytes [s, ln) of a record's payload (nw words at rows row0 ...) to
// `wr`: a short record (echo's are 4 words) has its words loaded
// together, one round of loads, and cut from registers; a longer one
// word after word (`append`)
__device__ __forceinline__ void cut(Writer& wr, const int* buf, int L,
                                    int lane, int row0, int nw, int s,
                                    int ln) {
  if (nw > kPre) {
    append(wr, buf, L, lane, row0, nw, s, ln);
    return;
  }
  u32 wv[kPre];
#pragma unroll
  for (int j = 0; j < kPre; ++j)
    wv[j] = j < nw ? word_at(buf, L, row0 + j, lane) : 0u;
  const u32 sh = (u32)(s & 3) * 8u;
  for (int b = s; b < ln; b += 4) {
    const int q = b >> 2;
    const u32 lo = pick(wv, q);
    wr.put(sh ? __funnelshift_r(lo, pick(wv, q + 1), sh) : lo,
           ln - b < 4 ? ln - b : 4);
  }
}

__global__ void __launch_bounds__(kThreads)
    flush_copy(const int* __restrict__ so_buf,
               const int* __restrict__ so_off, const int* __restrict__ skip,
               int SW, int L, const i64* __restrict__ cnt,
               unsigned char* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int fill = so_off[lane];
  const int end = fill < 0 ? 0 : (fill > SW ? SW : fill);
  int k = skip[lane];
  // one writer a fd (two objects: an array of them indexed by the fd was
  // local memory)
  Writer w1{out, cnt[lane]}, w2{out, cnt[L + lane]};
  for (int off = 0; off < end;) {
    const u32 hdr = word_at(so_buf, L, off, lane);
    const int fd = (int)(hdr >> 28), ln = (int)(hdr & 0x0FFFFFFFu);
    const int nw = (ln + 3) / 4;
    const int s = k < ln ? k : ln;
    k -= s;
    if (s < ln && off + 1 + nw <= end) {
      // each writer by its own call: one chosen at run time would be
      // addressed, in local memory
      if (fd == 1)
        cut(w1, so_buf, L, lane, off + 1, nw, s, ln);
      else if (fd == 2)
        cut(w2, so_buf, L, lane, off + 1, nw, s, ln);
    }
    off += 1 + nw;
  }
  w1.finish();
  w2.finish();
}

}  // namespace

// The flush's C entry: so_buf [SW, L], so_off [L] and skip [L] int32 on
// the card; meta [4 + L] int32 and cnt [2 L] int64 scratch, zeroed here;
// out: at least 4 * (the sum of the fills) bytes.  After it, meta holds
// the bytes to fd 1 and fd 2 (fd 1's stream at out[0, meta[0]), fd 2's
// right after it), the lanes with records, the lanes with a bad record,
// and each lane's payload bytes.  Returns a CUDA error code (0 =
// launched).
extern "C" int wasm_stdout_flush(const int* so_buf, const int* so_off,
                                 const int* skip, int SW, int L, int* meta,
                                 long long* cnt, unsigned char* out,
                                 void* stream) {
  if (!so_buf || !so_off || !skip || !meta || !cnt || !out || SW < 0 ||
      L <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(meta, 0, sizeof(int) * kMeta, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (L + kThreads - 1) / kThreads;
  flush_count<<<blocks, kThreads, 0, s>>>(so_buf, so_off, skip, SW, L, meta,
                                          cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flush_scan<<<1, kScanThreads, 0, s>>>(cnt, 2 * L, L, meta);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flush_copy<<<blocks, kThreads, 0, s>>>(so_buf, so_off, skip, SW, L, cnt,
                                         out);
  return (int)cudaGetLastError();
}
