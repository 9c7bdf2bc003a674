// The device dispatch's two kernels over the slicer output
// [B, J, E, R, W] (csrc/slice.cu): content dedup and record gather.
//
// Replace the JAX package's decoders/device_dispatch.py _content_dup
// (an XLA broadcast of [B, J, E, E, R, W] pairwise compares) and
// _gather_records (a jitted gather); their wrappers and plain torch
// versions are in decoders/device_dispatch.py.
//
// content_dup: one thread per (b, j, e) compares event e with each e' <= e
// of its lane: row count, then, over the rows below that count, per-row
// bit counts, syncs and row bytes; it stores the first e' that is equal in
// all of them (e itself if none earlier is). Bound: the bytes of the
// planes, each read about E / 2 times from L1/L2, and a compare per byte.
//
// gather_records: one CTA per kept record copies its R x W bytes and R
// syncs into dense [P, R, W] and [P, R] outputs. Bound: the bytes moved.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void content_dup_kernel(const uint8_t* __restrict__ bytes,
                                   const int* __restrict__ nrows,
                                   const int* __restrict__ bpr,
                                   const int* __restrict__ syncs, int BJ,
                                   int E, int R, int W, int* dup) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= BJ * E) return;
  const int lane = t / E, e = t % E;
  const int* nr = nrows + (size_t)lane * E;
  const int n = nr[e];
  const int rows = min(max(n, 0), R);
  const size_t ev_rows = (size_t)lane * E * R;
  int found = e;
  for (int e2 = 0; e2 < e; ++e2) {
    if (nr[e2] != n) continue;
    bool eq = true;
    for (int r = 0; r < rows && eq; ++r) {
      const size_t a = ev_rows + (size_t)e * R + r;
      const size_t b = ev_rows + (size_t)e2 * R + r;
      eq = bpr[a] == bpr[b] && syncs[a] == syncs[b];
      const uint8_t* ra = bytes + a * W;
      const uint8_t* rb = bytes + b * W;
      for (int k = 0; k < W && eq; ++k) eq = ra[k] == rb[k];
    }
    if (eq) {
      found = e2;
      break;
    }
  }
  dup[t] = found;
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

extern "C" int rtl433_content_dup(const void* bytes, const void* nrows,
                                  const void* bpr, const void* syncs,
                                  int BJ, int E, int R, int W, void* dup,
                                  void* stream) {
  const int n = BJ * E;
  const int threads = 128;
  content_dup_kernel<<<(n + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
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
