// Package compaction: every published package slot of every channel,
// gathered into dense [cap, ...] rows, channel-major, then by slot.
//
// Replaces: rtl_433_tpu/dsp/engine.py::compact_packages (XLA; there a
// one-hot f32 matmul, which dodges TPU gathers and is not carried over).
// Computes, to the integer (the JAX meta plane goes through a byte split,
// pulse and gap widths below 2^24 through f32; here every copy is int32):
//   v[c]    = clamp(out_n[c], 0, S) valid slots of channel c;
//   rank    = the slot's place among all valid slots, channel-major;
//   rows    = for rank < cap, the whole P-wide pulse and gap rows and the
//             F-wide meta row of that slot; padding rows are all zeros;
//   channel = the row's channel, -1 in padding rows;
//   count   = sum of v, which may exceed cap.
//
// What bounds it. Bytes: the valid rows read once (2P + F ints each), all
// cap rows written once, out_n read once. At C=4096, S=8, P=1200 and a few
// hundred packages that is a few MB, microseconds at 3.35 TB/s; the two
// launches' fixed cost is of the same order.
//
// Design. Kernel 1 is one CTA of 1024 threads: each thread sums the v of a
// run of consecutive channels, a warp-shuffle scan and a scan of the 32
// warp sums give each run its base, and each thread then writes the source
// row (c * S + s) of every rank < cap its channels own; the threads stride
// over [min(count, cap), cap) to mark padding with -1. Any C works (runs
// grow with C). Kernel 2 gives each output row one CTA (grid-stride past
// 65535) and writes all of it into one int32 buffer, so that the host reads
// the kept rows in one copy: the pulse and gap rows move as 16-byte int4
// loads and stores when P is a multiple of 4, the row stride W is too and
// the planes are 16-byte aligned (the wrapper decides), the meta row and the
// channel as scalars; a padding row is written as zeros and -1.

#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kCopyThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int valid_slots(const int* out_n, int c, int S) {
    return min(max(out_n[c], 0), S);
}

__global__ void __launch_bounds__(kScanThreads)
compact_scan_kernel(const int* __restrict__ out_n, int C, int S, int cap,
                    int* __restrict__ row_src, int* __restrict__ count) {
    __shared__ int warp_base[32];
    __shared__ int total_s;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int per = (C + kScanThreads - 1) / kScanThreads;
    const int c0 = min(tid * per, C);
    const int c1 = min(c0 + per, C);
    int local = 0;
    for (int c = c0; c < c1; ++c) local += valid_slots(out_n, c, S);

    int incl = local;
    for (int o = 1; o < 32; o <<= 1) {
        int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
    }
    if (lane == 31) warp_base[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = warp_base[lane];
        int wi = w;
        for (int o = 1; o < 32; o <<= 1) {
            int t = __shfl_up_sync(kFull, wi, o);
            if (lane >= o) wi += t;
        }
        warp_base[lane] = wi - w;
        if (lane == 31) total_s = wi;
    }
    __syncthreads();

    int base = warp_base[warp] + incl - local;
    const int total = total_s;
    for (int c = c0; c < c1 && base < cap; ++c) {
        const int v = valid_slots(out_n, c, S);
        for (int s = 0; s < v && base + s < cap; ++s)
            row_src[base + s] = c * S + s;
        base += v;
    }
    for (int r = min(total, cap) + tid; r < cap; r += kScanThreads)
        row_src[r] = -1;
    if (tid == 0) *count = total;
}

__global__ void __launch_bounds__(kCopyThreads)
compact_copy_kernel(const int* __restrict__ out_p,
                    const int* __restrict__ out_g,
                    const int* __restrict__ out_meta,
                    const int* __restrict__ row_src, int S, int P, int F,
                    int cap, int W, int vec, int* __restrict__ rows) {
    for (int r = blockIdx.x; r < cap; r += gridDim.x) {
        const int src = row_src[r];
        int* dp = rows + static_cast<size_t>(r) * W;
        int* dg = dp + P;
        int* dm = dg + P;
        // the channel column, then zeros to the row's end (1 to 4 ints)
        if (threadIdx.x < W - 2 * P - F)
            dm[F + threadIdx.x] = threadIdx.x ? 0 : (src >= 0 ? src / S : -1);
        if (src >= 0) {
            const int* sp = out_p + static_cast<size_t>(src) * P;
            const int* sg = out_g + static_cast<size_t>(src) * P;
            const int* sm = out_meta + static_cast<size_t>(src) * F;
            if (vec) {
                const int4* sp4 = reinterpret_cast<const int4*>(sp);
                const int4* sg4 = reinterpret_cast<const int4*>(sg);
                int4* dp4 = reinterpret_cast<int4*>(dp);
                int4* dg4 = reinterpret_cast<int4*>(dg);
                for (int i = threadIdx.x; i < (P >> 2); i += kCopyThreads) {
                    dp4[i] = __ldg(sp4 + i);
                    dg4[i] = __ldg(sg4 + i);
                }
            } else {
                for (int i = threadIdx.x; i < P; i += kCopyThreads) {
                    dp[i] = __ldg(sp + i);
                    dg[i] = __ldg(sg + i);
                }
            }
            for (int i = threadIdx.x; i < F; i += kCopyThreads)
                dm[i] = __ldg(sm + i);
        } else {
            if (vec) {
                const int4 z = make_int4(0, 0, 0, 0);
                int4* dp4 = reinterpret_cast<int4*>(dp);
                int4* dg4 = reinterpret_cast<int4*>(dg);
                for (int i = threadIdx.x; i < (P >> 2); i += kCopyThreads) {
                    dp4[i] = z;
                    dg4[i] = z;
                }
            } else {
                for (int i = threadIdx.x; i < P; i += kCopyThreads) {
                    dp[i] = 0;
                    dg[i] = 0;
                }
            }
            for (int i = threadIdx.x; i < F; i += kCopyThreads) dm[i] = 0;
        }
    }
}

}  // namespace

// out_n int32 [C]; out_p, out_g int32 [C, S, P]; out_meta int32 [C, S, F];
// row_src int32 [cap] scratch; rows int32 [cap, W], W >= 2P + F + 1: each
// row is pulse [0, P), gap [P, 2P), meta [2P, 2P + F), the channel at
// 2P + F, then zeros; count int32 [1]. Returns the cudaGetLastError() code
// after the launches.
extern "C" int rtl433_compact(const void* out_n, const void* out_p,
                              const void* out_g, const void* out_meta, int C,
                              int S, int P, int F, int cap, int W, int vec,
                              void* row_src, void* rows, void* count,
                              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    compact_scan_kernel<<<1, kScanThreads, 0, s>>>(
        static_cast<const int*>(out_n), C, S, cap,
        static_cast<int*>(row_src), static_cast<int*>(count));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = cap < 65535 ? cap : 65535;
    compact_copy_kernel<<<grid, kCopyThreads, 0, s>>>(
        static_cast<const int*>(out_p), static_cast<const int*>(out_g),
        static_cast<const int*>(out_meta), static_cast<const int*>(row_src),
        S, P, F, cap, W, vec, static_cast<int*>(rows));
    return static_cast<int>(cudaGetLastError());
}
