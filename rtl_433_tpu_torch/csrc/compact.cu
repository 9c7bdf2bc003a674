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
// What bounds it. Bytes: out_n read once, the kept rows read once (2P + F
// ints each) and all cap rows written once (W ints each). At C=4096, S=8,
// P=1200, cap 768 and 256 kept rows that is 9.9 MB, 2.95 us at 3.35 TB/s,
// the same order as the fixed cost of one launch (about 2 us); a call is
// latency as much as bytes: the launch, then one L2 round trip for out_n
// and one DRAM round trip for the rows, which the design keeps to.
//
// Design: one launch, no scratch to clear. kCtasPerSm CTAs of kThreads per
// SM (fewer when cap is smaller) take the output rows r = blockIdx.x + i *
// gridDim.x. Every CTA first counts the valid slots itself (level 1 of a
// two-level count): one 16-byte load of out_n per tile of 4 channels
// (coalesced; out_n sits in L2, 16 KB at C=4096), the clamped counts kept
// in shared memory, and a block-wide scan of the tile sums gives each
// tile's first rank. A thread per output row finds its tile by a binary
// search over those ranks and its channel among the tile's counts (level
// 2). Then thread t copies unit t (and t + kThreads, ...) of every row of
// its CTA, the 16-byte loads of kUnroll rows in flight before their
// stores: pulse and gap as int4 when P % 4 == 0 and the planes and rows are
// 16-byte aligned (the launcher decides), the meta row, the channel and the
// zero tail assembled into int4 stores; otherwise int32 copies. A padding
// row is written as zeros and -1. At the multichannel state (cap 768, 256
// kept rows) a CTA holds three rows: one round of loads per thread.
//
// What bounds the design: up to kOneCta channels every CTA rescans out_n
// (4C bytes of L2 reads a CTA, 5C ints of shared memory). Past kOneCta the
// rescan would grow with C in every CTA, so the tiles are shared instead:
// each thread of the grid sums whole tiles of at least kMinTile channels
// (at most kMaxTiles tiles), writes them to scratch after the rows, and
// one grid-wide barrier (a cooperative launch, whose CTAs are all resident
// by contract) precedes the scan of the tile sums, which every CTA then
// reads, kMaxTiles ints at most, and the walk reads out_n. Any C runs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 2;
constexpr int kUnroll = 4;
// channels every CTA rescans; past them the tile sums are shared (the
// wrapper, ops/compact.py ONE_CTA, leaves kMaxTiles ints of scratch)
constexpr int kOneCta = 8192;
constexpr int kMaxTiles = 8192;
constexpr int kMinTile = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int valid(int n, int S) {
    return min(max(n, 0), S);
}

// sum of clamp(out_n[c], 0, S) over [c0, c1); c0 is a multiple of 4, so
// with a 16-byte aligned out_n (nvec) the loads are int4
__device__ int tile_sum(const int* __restrict__ out_n, int c0, int c1, int S,
                        bool nvec) {
    int s = 0;
    int c = c0;
    if (nvec)
        for (; c + 4 <= c1; c += 4) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(out_n + c));
            s += valid(v.x, S) + valid(v.y, S) + valid(v.z, S) +
                 valid(v.w, S);
        }
    for (; c < c1; ++c) s += valid(__ldg(out_n + c), S);
    return s;
}

// in-place exclusive scan of a[0, n), a[n] = the total (n <= kMaxTiles);
// every thread returns the total
__device__ int block_scan(int* a, int n, int* warp_tot) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int per = (n + kThreads - 1) / kThreads;
    const int i0 = min(tid * per, n), i1 = min(i0 + per, n);
    int local = 0;
    for (int i = i0; i < i1; ++i) local += a[i];
    int incl = local;
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int w = lane < kWarps ? warp_tot[lane] : 0;
        int wi = w;
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(kFull, wi, o);
            if (lane >= o) wi += t;
        }
        if (lane < kWarps) warp_tot[lane] = wi - w;
        if (lane == 31) warp_tot[kWarps] = a[n] = wi;
    }
    __syncthreads();
    int run = warp_tot[warp] + incl - local;
    for (int i = i0; i < i1; ++i) {
        const int v = a[i];
        a[i] = run;
        run += v;
    }
    const int total = warp_tot[kWarps];
    __syncthreads();
    return total;
}

// the source planes: pulse, gap [C * S, P], meta [C * S, F]
struct Planes {
    const int* p;
    const int* g;
    const int* m;
    int S, P, F;
};

// int u of a row (the scalar copy): pulse and gap (u < 2P), then meta,
// the channel and zeros; a padding row (src < 0) is zeros and -1
__device__ __forceinline__ int row_int(const Planes& x, int src, int u) {
    const int P = x.P, F = x.F;
    if (src < 0) return u == 2 * P + F ? -1 : 0;
    if (u < P) return __ldg(x.p + static_cast<size_t>(src) * P + u);
    if (u < 2 * P) return __ldg(x.g + static_cast<size_t>(src) * P + u - P);
    if (u < 2 * P + F)
        return __ldg(x.m + static_cast<size_t>(src) * F + u - 2 * P);
    return u == 2 * P + F ? src / x.S : 0;
}

// 16-byte unit u of a row (P % 4 == 0): pulse and gap (u < P / 2) as int4
// loads, the tail (meta, channel, zeros) assembled from ints
__device__ __forceinline__ int4 row_int4(const Planes& x, int src, int u) {
    const int P4 = x.P >> 2;
    if (u < 2 * P4) {
        if (src < 0) return make_int4(0, 0, 0, 0);
        const int* plane = u < P4 ? x.p : x.g;
        return __ldg(reinterpret_cast<const int4*>(
                         plane + static_cast<size_t>(src) * x.P) +
                     (u < P4 ? u : u - P4));
    }
    const int q = 4 * u;
    return make_int4(row_int(x, src, q), row_int(x, src, q + 1),
                     row_int(x, src, q + 2), row_int(x, src, q + 3));
}

// kGrid: the tile sums are shared through `tiles` across a cooperative
// grid (C > kOneCta); otherwise every CTA computes them all
template <bool kGrid>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const int* __restrict__ out_n, Planes x, int C, int cap,
               int W, int LT, int NT, int nvec, int vec,
               int* __restrict__ rows, int* __restrict__ count,
               int* __restrict__ tiles) {
    extern __shared__ int4 smem[];
    // [4 NT] each channel's v (C <= kOneCta), [NT + 1] each tile's first
    // rank, [kThreads] a batch's row sources
    int* counts = reinterpret_cast<int*>(smem);
    int* first = counts + (kGrid ? 0 : 4 * NT);
    int* row_src = first + NT + 1;
    __shared__ int warp_tot[kWarps + 1];
    const int tid = threadIdx.x;

    // level 1: each tile's count of valid slots
    if constexpr (kGrid) {
        for (int t = blockIdx.x * kThreads + tid; t < NT;
             t += gridDim.x * kThreads)
            tiles[t] = tile_sum(out_n, t * LT, min(t * LT + LT, C), x.S,
                                nvec);
        cg::this_grid().sync();
        for (int t = tid; t < NT; t += kThreads) first[t] = __ldcg(tiles + t);
    } else {  // tiles of LT = 4 channels, their counts kept
#pragma unroll 4
        for (int t = tid; t < NT; t += kThreads) {
            const int c = 4 * t;
            int4 v;
            if (nvec && c + 4 <= C) {
                v = __ldg(reinterpret_cast<const int4*>(out_n + c));
            } else {
                v.x = __ldg(out_n + c);
                v.y = c + 1 < C ? __ldg(out_n + c + 1) : 0;
                v.z = c + 2 < C ? __ldg(out_n + c + 2) : 0;
                v.w = c + 3 < C ? __ldg(out_n + c + 3) : 0;
            }
            v = make_int4(valid(v.x, x.S), valid(v.y, x.S), valid(v.z, x.S),
                          valid(v.w, x.S));
            smem[t] = v;
            first[t] = v.x + v.y + v.z + v.w;
        }
    }
    __syncthreads();
    const int total = block_scan(first, NT, warp_tot);
    if (blockIdx.x == 0 && tid == 0) *count = total;
    const int kept = min(total, cap);

    // this CTA's rows: r = blockIdx.x + i * gridDim.x, in batches of
    // kThreads
    const int n_rows = cap > static_cast<int>(blockIdx.x)
                           ? (cap - 1 - blockIdx.x) / gridDim.x + 1
                           : 0;
    const int U = vec ? W >> 2 : W;
    auto out_row = [](int i) {
        return blockIdx.x + static_cast<size_t>(i) * gridDim.x;
    };
    for (int i0 = 0; i0 < n_rows; i0 += kThreads) {
        const int nb = min(kThreads, n_rows - i0);
        if (tid < nb) {
            // level 2: the tile, then the channel, of row r
            const int r = static_cast<int>(out_row(i0 + tid));
            int src = -1;
            if (r < kept) {
                int lo = 0, hi = NT;    // first[lo] <= r < first[hi]
                while (hi - lo > 1) {
                    const int mid = (lo + hi) >> 1;
                    if (first[mid] <= r) lo = mid;
                    else hi = mid;
                }
                // the channel: a walk that ends inside tile lo
                int base = first[lo], c = lo * LT;
                if constexpr (!kGrid) {
                    while (base + counts[c] <= r) base += counts[c++];
                } else {
                    for (;;) {
                        if (nvec && c + 4 <= C) {
                            const int4 v = __ldg(
                                reinterpret_cast<const int4*>(out_n + c));
                            const int a = valid(v.x, x.S),
                                      b = valid(v.y, x.S),
                                      d = valid(v.z, x.S),
                                      e = valid(v.w, x.S);
                            if (base + a > r) break;
                            base += a;
                            ++c;
                            if (base + b > r) break;
                            base += b;
                            ++c;
                            if (base + d > r) break;
                            base += d;
                            ++c;
                            if (base + e > r) break;
                            base += e;
                            ++c;
                        } else {
                            const int v = valid(__ldg(out_n + c), x.S);
                            if (base + v > r) break;
                            base += v;
                            ++c;
                        }
                    }
                }
                src = c * x.S + (r - base);
            }
            row_src[tid] = src;
        }
        __syncthreads();
        // thread tid takes units u = tid, tid + kThreads, ... of every
        // row of the batch, kUnroll rows' loads in flight before the stores
        for (int u = tid; u < U; u += kThreads) {
            for (int i = 0; i < nb; i += kUnroll) {
                if (vec) {
                    int4 v[kUnroll];
#pragma unroll
                    for (int j = 0; j < kUnroll; ++j)
                        if (i + j < nb) v[j] = row_int4(x, row_src[i + j], u);
#pragma unroll
                    for (int j = 0; j < kUnroll; ++j)
                        if (i + j < nb)
                            reinterpret_cast<int4*>(
                                rows + out_row(i0 + i + j) * W)[u] = v[j];
                } else {
                    int v[kUnroll];
#pragma unroll
                    for (int j = 0; j < kUnroll; ++j)
                        if (i + j < nb) v[j] = row_int(x, row_src[i + j], u);
#pragma unroll
                    for (int j = 0; j < kUnroll; ++j)
                        if (i + j < nb)
                            rows[out_row(i0 + i + j) * W + u] = v[j];
                }
            }
        }
        __syncthreads();
    }
}

int sm_count() {
    static int sms[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) dev = 0;
    if (!sms[dev])
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    return sms[dev] > 0 ? sms[dev] : 1;
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// out_n int32 [C]; out_p, out_g int32 [C, S, P]; out_meta int32 [C, S, F];
// out int32: rows [cap, W] (W >= 2P + F + 1, a multiple of 4): each row is
// pulse [0, P), gap [P, 2P), meta [2P, 2P + F), the channel at 2P + F,
// then zeros; then the count; then, when C > 8192 (kOneCta), 8192
// (kMaxTiles) ints of scratch. One kernel launch. Returns the CUDA error
// code of the launch.
extern "C" int rtl433_compact(const void* out_n, const void* out_p,
                              const void* out_g, const void* out_meta, int C,
                              int S, int P, int F, int cap, int W, void* out,
                              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int* rows = static_cast<int*>(out);
    int* count = rows + static_cast<size_t>(cap) * W;
    Planes x{static_cast<const int*>(out_p),
                   static_cast<const int*>(out_g),
                   static_cast<const int*>(out_meta), S, P, F};
    const int* n = static_cast<const int*>(out_n);
    int nvec = aligned16(out_n);
    int vec = P % 4 == 0 && W % 4 == 0 && aligned16(out_p) &&
              aligned16(out_g) && aligned16(out);
    const bool grid_scan = C > kOneCta;
    // tiles of one int4 of out_n, or past kOneCta of at least kMinTile
    int LT = 4;
    if (grid_scan)
        LT = (max(kMinTile, (C + kMaxTiles - 1) / kMaxTiles) + 3) & ~3;
    int NT = (C + LT - 1) / LT;
    const size_t smem =
        sizeof(int) * ((grid_scan ? 0 : 4 * NT) + NT + 1 + kThreads);
    int grid = min(cap, kCtasPerSm * sm_count());
    if (!grid_scan) {
        compact_kernel<false><<<grid, kThreads, smem, s>>>(
            n, x, C, cap, W, LT, NT, nvec, vec, rows, count, nullptr);
        return static_cast<int>(cudaGetLastError());
    }
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, compact_kernel<true>, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid = max(1, min(grid, per_sm * sm_count()));
    int* tiles = count + 1;
    void* args[] = {&n, &x, &C, &cap, &W, &LT, &NT,
                    &nvec, &vec, &rows, &count, &tiles};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(compact_kernel<true>), dim3(grid),
        dim3(kThreads), args, smem, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
