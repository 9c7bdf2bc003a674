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
// gather_records: one CTA per kept record copies its R x W bytes and R
// syncs into dense [P, R, W] and [P, R] outputs. Bound: the bytes moved.

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

__global__ void gather_records_kernel(const uint8_t* __restrict__ bytes,
                                      const int* __restrict__ syncs,
                                      const int* __restrict__ bs,
                                      const int* __restrict__ js,
                                      const int* __restrict__ es, int J,
                                      int E, int R, int W, uint8_t* out_b,
                                      int* out_s) {
  const int i = blockIdx.x;
  const size_t src = ((size_t)bs[i] * J + js[i]) * E + es[i];
  const uint8_t* sb = bytes + src * R * W;
  uint8_t* db = out_b + (size_t)i * R * W;
  for (int k = threadIdx.x; k < R * W; k += blockDim.x) db[k] = sb[k];
  for (int k = threadIdx.x; k < R; k += blockDim.x)
    out_s[(size_t)i * R + k] = syncs[src * R + k];
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

extern "C" int rtl433_gather_records(const void* bytes, const void* syncs,
                                     const void* bs, const void* js,
                                     const void* es, int P, int J, int E,
                                     int R, int W, void* out_b, void* out_s,
                                     void* stream) {
  gather_records_kernel<<<P, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int*)syncs, (const int*)bs,
      (const int*)js, (const int*)es, J, E, R, W, (uint8_t*)out_b,
      (int*)out_s);
  return (int)cudaGetLastError();
}
