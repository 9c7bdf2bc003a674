// The device dispatch's two kernels over the slicer output
// [B, J, E, R, W] (csrc/slice.cu): content dedup and record gather.
//
// Replace the JAX package's decoders/device_dispatch.py _content_dup
// (an XLA broadcast of [B, J, E, E, R, W] pairwise compares) and
// _gather_records (a jitted gather); their wrappers and plain torch
// versions are in decoders/device_dispatch.py.
//
// content_dup: a warp per lane (b, j), a thread per event (E <= 32), stores
// for event e the first e' <= e whose row count is equal and, over the
// rows below that count clamped to [0, R], whose per-row bit counts, syncs
// and all W bytes of each row are equal (e itself if no earlier one is).
// The compared data of two events with one count are three contiguous
// prefixes: rows * W bytes of `bytes` (the event stride is R * W), rows
// ints each of `bits_per_row` and `syncs`; rows past the count are
// scratch. So
//   1. the header: each event's thread loads its count (the lane's counts
//      are one coalesced run) and finds its candidates, the earlier events
//      with an equal count, by shuffles; an event with no candidate, or
//      with clamped rows 0 (every candidate is equal), is settled here
//      without a byte read;
//   2. the compares, in rounds: every open event (up to 16 a round) tries
//      its next candidate in ascending e' on a group of the warp's threads
//      (32, 16, ... 2 by the number open), consecutive threads of a group
//      on consecutive 16-byte chunks of the two prefixes (4-byte words or
//      bytes where a base is not 16- or 4-byte aligned, and for the tail),
//      then on the two int prefixes; one ballot reduces every group; an
//      event stops at its first equal candidate.
// Every read is a read-only load; dup is written once. A warp per lane,
// not several lanes a warp: the rounds of one lane are a chain of load
// latencies, and warps side by side hide them.
// Bound: the bytes the compare must read (the counts, and the live
// prefixes of the events that share their count with another event of
// their lane, each once) and dup written; a call is a few rounds of load
// latency.
//
// gather_records: the kept records of any number of families' slicer
// outputs in one launch. A small table gives each family its planes'
// base pointers (bytes [B, J, E, R, W], syncs [B, J, E, R]), J, E, R, W,
// its first record and the offsets of its [P_f, R, W] bytes and [P_f, R]
// syncs in one flat output buffer, which the host copies back once; a
// record is (family, b, j, e). One warp per record copies its R x W
// bytes with 16-byte loads and stores where both ends are 16-byte
// aligned (words where they are 4-byte aligned, else bytes; the tail in
// bytes) and its R syncs, a word per lane. Bound: the bytes moved (each
// record's bytes and syncs read and written once, the table and records
// read once); a drain's few thousand records are a few microseconds of
// the card, so the launch count, one per materialization pass instead of
// one per family and per train, is what the redesign buys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// the bits in which events a and b (indices into the [BJ * E] event axis)
// differ over their first `rows` rows, as seen by thread `sub` of a group
// of `gs` threads (0 where they agree); every group reduces its own
__device__ unsigned diff_rows(const uint8_t* __restrict__ bytes,
                              const int* __restrict__ bpr,
                              const int* __restrict__ syncs, long a, long b,
                              int rows, int R, int W, int sub, int gs) {
  const size_t ev = (size_t)R * W;
  const uint8_t* pa = bytes + a * ev;
  const uint8_t* pb = bytes + b * ev;
  const int n = rows * W;
  const uintptr_t al = (uintptr_t)pa | (uintptr_t)pb;
  unsigned diff = 0;
  int done = 0;
  if ((al & 15) == 0) {
    const uint4* a4 = reinterpret_cast<const uint4*>(pa);
    const uint4* b4 = reinterpret_cast<const uint4*>(pb);
    for (int i = sub; i < n >> 4; i += gs) {
      const uint4 x = __ldg(a4 + i), y = __ldg(b4 + i);
      diff |= (x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w);
    }
    done = n & ~15;
  } else if ((al & 3) == 0) {
    const unsigned* a1 = reinterpret_cast<const unsigned*>(pa);
    const unsigned* b1 = reinterpret_cast<const unsigned*>(pb);
    for (int i = sub; i < n >> 2; i += gs)
      diff |= __ldg(a1 + i) ^ __ldg(b1 + i);
    done = n & ~3;
  }
  for (int i = done + sub; i < n; i += gs)
    diff |= __ldg(pa + i) ^ __ldg(pb + i);
  const int* ra = bpr + a * R;
  const int* rb = bpr + b * R;
  const int* sa = syncs + a * R;
  const int* sb = syncs + b * R;
  for (int i = sub; i < rows; i += gs)
    diff |= (unsigned)(__ldg(ra + i) ^ __ldg(rb + i)) |
            (unsigned)(__ldg(sa + i) ^ __ldg(sb + i));
  return diff;
}

__global__ void __launch_bounds__(128)
content_dup_kernel(const uint8_t* __restrict__ bytes,
                   const int* __restrict__ nrows,
                   const int* __restrict__ bpr,
                   const int* __restrict__ syncs, int BJ, int E, int R,
                   int W, int* __restrict__ dup) {
  const int t = threadIdx.x & 31;
  const long lane = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (lane >= BJ) return;                  // the whole warp
  const long ev0 = lane * E;
  const bool live = t < E;
  // 1. the header: the count, and the earlier events with an equal one
  const int n = live ? __ldg(nrows + ev0 + t) : 0;
  const int rows = min(max(n, 0), R);
  unsigned cand = 0;
  for (int k = 0; k + 1 < E; ++k) {
    const int v = __shfl_sync(kFull, n, k);
    if (k < t && v == n) cand |= 1u << k;
  }
  if (!live) cand = 0;
  int found = t;
  if (rows == 0 && cand) {
    found = __ffs(cand) - 1;
    cand = 0;
  }
  // 2. the rounds: the q-th open event (q < 16) on threads [q gs, q gs + gs)
  for (unsigned open = __ballot_sync(kFull, cand != 0); open;
       open = __ballot_sync(kFull, cand != 0)) {
    const int k = min(__popc(open), 16);
    const int gs = 32 >> (32 - __clz(k - 1));
    const int q = t / gs;
    unsigned m = open;
    for (int i = 0; i < q && m; ++i) m &= m - 1;
    const int e = q < k ? __ffs(m) - 1 : 0;
    const int c = __shfl_sync(kFull, __ffs(cand) - 1, e);
    const int rw = __shfl_sync(kFull, rows, e);
    const unsigned d = q < k ? diff_rows(bytes, bpr, syncs, ev0 + e, ev0 + c,
                                         rw, R, W, t - q * gs, gs)
                             : 0u;
    const unsigned D = __ballot_sync(kFull, d != 0);
    const int qe = __popc(open & ((1u << t) - 1));     // this event's rank
    if (cand && qe < k) {
      const unsigned gm = gs == 32 ? kFull : (1u << gs) - 1;
      if (((D >> (qe * gs)) & gm) == 0) {
        found = __ffs(cand) - 1;
        cand = 0;
      } else {
        cand &= cand - 1;
      }
    }
  }
  if (live) dup[ev0 + t] = found;
}

// one family of the batched gather: its row of the int64 table
enum { GF_BYTES = 0, GF_SYNCS, GF_J, GF_E, GF_R, GF_W, GF_OUT_BYTES,
       GF_OUT_SYNCS, GF_FIRST, GF_COLS = 10 };

// n bytes from src to dst by the lanes of a warp
__device__ __forceinline__ void warp_copy(const uint8_t* __restrict__ src,
                                          uint8_t* __restrict__ dst, int n,
                                          int lane) {
  const uintptr_t al = (uintptr_t)src | (uintptr_t)dst;
  int done = 0;
  if ((al & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = lane; i < n >> 4; i += 32) d4[i] = __ldg(s4 + i);
    done = n & ~15;
  } else if ((al & 3) == 0) {
    const unsigned* s1 = reinterpret_cast<const unsigned*>(src);
    unsigned* d1 = reinterpret_cast<unsigned*>(dst);
    for (int i = lane; i < n >> 2; i += 32) d1[i] = __ldg(s1 + i);
    done = n & ~3;
  }
  for (int i = done + lane; i < n; i += 32) dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(128)
gather_records_kernel(const long long* __restrict__ fams,
                      const int4* __restrict__ recs, int P,
                      uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (i >= P) return;  // the whole warp
  const int4 r = __ldg(recs + i);  // (family, b, j, e)
  const long long* f = fams + (size_t)GF_COLS * r.x;
  const int J = (int)f[GF_J], E = (int)f[GF_E];
  const int R = (int)f[GF_R], W = (int)f[GF_W];
  const size_t src = ((size_t)r.y * J + r.z) * E + r.w;
  const size_t k = (size_t)(i - (int)f[GF_FIRST]);
  const size_t n = (size_t)R * W;
  warp_copy(reinterpret_cast<const uint8_t*>(f[GF_BYTES]) + src * n,
            out + f[GF_OUT_BYTES] + k * n, (int)n, lane);
  const int* sy = reinterpret_cast<const int*>(f[GF_SYNCS]) + src * R;
  int* ds = reinterpret_cast<int*>(out + f[GF_OUT_SYNCS]) + k * R;
  for (int q = lane; q < R; q += 32) ds[q] = __ldg(sy + q);
}

}  // namespace

// a warp per lane of E <= 32 events, four warps a block
extern "C" int rtl433_content_dup(const void* bytes, const void* nrows,
                                  const void* bpr, const void* syncs,
                                  int BJ, int E, int R, int W, void* dup,
                                  void* stream) {
  if (BJ < 1 || E < 1 || E > 32 || R < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  content_dup_kernel<<<(BJ + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int*)nrows, (const int*)bpr,
      (const int*)syncs, BJ, E, R, W, (int*)dup);
  return (int)cudaGetLastError();
}

// meta: the int64 family table [F, GF_COLS], then the records as int32
// [P, 4] (16-byte aligned: GF_COLS * 8 is a multiple of 16); a warp per
// record, four warps a block
extern "C" int rtl433_gather_records(const void* meta, int F, int P,
                                     void* out, void* stream) {
  if (F < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const long long* fams = (const long long*)meta;
  gather_records_kernel<<<(P + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      fams, reinterpret_cast<const int4*>(fams + (size_t)GF_COLS * F), P,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
