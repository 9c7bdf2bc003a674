// Fused baseband front-end for cu8 IQ: one block per group of up to 32
// channels, walking the block in time tiles staged in shared memory.
//
// Replaces: rtl_433_tpu/ops/frontend.py::_kernel (the Pallas TPU kernel,
// built by _build, wrapped by frontend). Computes, bit-exactly vs the
// reference per-sample loops (ref src/baseband.c):
//   - AM estimator: envelope (127-I)^2 + (127-Q)^2, or the 122/51
//     magnitude estimate (:36-79);
//   - AM low-pass: order-1 Q0.15 IIR with int16 store-truncation (:145-169);
//   - FM discriminator x[n]*conj(x[n-1]) with integer atan2, pi == 32767
//     (:181-259), C truncating division as CUDA's own `/`;
//   - FM low-pass with the runtime alp1/blp (:263-271);
//   - carries frozen past n_valid; the per-channel uint32 envelope sum.
// With a per-channel origin vector lane_t0 (time-shard segments as the
// channels of one launch, parallel/timeshard.py), channel c's valid count is
// clamp(n_valid - lane_t0[c], 0, N) with n_valid in the block frame, as the
// JAX engine computes per device (_block_scan :969-971); a null lane_t0
// keeps one region-local count clamp(n_valid, 0, N) for every channel (the
// LANES=false instantiation: the scalar path's code is unchanged).
// With FM off the fm stream is the raw envelope as int32 (the reference's
// buf.temp/buf.fm union alias).
//
// What bounds it. Only the two order-1 IIRs are sequential, and they are
// independent of each other; everything else (the loads, the envelope,
// the discriminator products, atan2 with its emulated 32-bit division, the
// IIR input terms b*(x[t] + x[t-1]), and every output past n_valid) is
// data-parallel. At C=1 the time is therefore set by one IIR chain of N
// steps; at C=4096 (128 blocks of 32 channels, one per SM) by the
// data-parallel pass, about 60 int32 operations per sample with FM on.
//
// Design. Each block stages a tile of T samples per channel into shared
// memory with cp.async (16-byte pieces when the rows are aligned, plain
// loads otherwise), double-buffered: tile j+1 is in flight while tile j is
// worked on. Per tile:
//   A. all 256 threads compute env[t] (the uint32 sum is a warp reduction
//      plus one shared atomic per warp and channel) and phi[t], whose
//      previous-sample operand is x[min(t, n_valid) - 1] as in
//      frontend_plain;
//   B. all threads form the IIR input terms K[t] = b*(x[t] + x[p]) with
//      p = min(t, n_valid) - 1, pre-shifted left by 2 so that the chain's
//      sext16(v >> 14) becomes one arithmetic shift;
//   C. lane c of warp 0 runs channel c's AM chain y = (4*a1*y + K[t]) >> 16
//      over the valid samples, and lane c of warp 1 its FM chain, at the
//      same time: two dependent operations per sample, with the K terms
//      read a batch ahead into registers; warp 2 takes the tile's carries;
//   D. all threads store am/fm coalesced from shared memory, computing the
//      outputs past n_valid from the frozen carries.
// Shared rows are channel-major with odd word strides, so the chain lanes
// (one per channel, same t) and the tile passes (one channel, consecutive
// t) both read without bank conflicts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kIPi4 = 32767 / 4;           // 8191
constexpr int kI3Pi4 = 3 * 32767 / 4;      // 24575
constexpr int kThreads = 256;
constexpr int kLanes = 32;                 // channels per block
constexpr int kSmemBudget = 160 * 1024;
constexpr int kSmall = 7 * kLanes;         // per-channel carries and sums
constexpr int kSmallNv = kSmall + kLanes;  // ... and valid counts
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int sext16(int v) {
    return static_cast<int>(static_cast<int16_t>(v & 0xFFFF));
}

// Integer atan2, pi == INT16_MAX (ref src/baseband.c:181-202)
__device__ __forceinline__ int atan2_int16(int y, int x) {
    if (x == 0 && y == 0) return 0;
    const int abs_y = y < 0 ? -y : y;
    int angle;
    if (x >= 0) {
        int d = abs_y + x;
        if (d == 0) d = 1;
        angle = kIPi4 - kIPi4 * (x - abs_y) / d;
    } else {
        int d = abs_y - x;
        if (d == 0) d = 1;
        angle = kI3Pi4 - kIPi4 * (x + abs_y) / d;
    }
    if (y < 0) angle = -angle;
    return sext16(angle);
}

// sext16((a1*y + K) >> 14) with k4 = K << 2 and a4 = a1 << 2, in int32
// wrap-around arithmetic: bits 14..29 of the sum, sign-extended
__device__ __forceinline__ int iir(int a4, int y, int k4) {
    return static_cast<int>(static_cast<unsigned>(a4) * static_cast<unsigned>(y) +
                            static_cast<unsigned>(k4)) >> 16;
}

__device__ __forceinline__ int shl2(int v) {
    return static_cast<int>(static_cast<unsigned>(v) << 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One channel's serial IIR over n valid samples of its K row, in place.
// The K terms are read a batch ahead into registers, so the chain is the
// multiply-add and the shift and never waits on shared memory. The read
// ahead may pass the row's end by one batch; it stays inside the block's
// shared memory (rows are followed by the other arrays) and is not used.
constexpr int kChainU = 8;

__device__ __forceinline__ int chain(int* k, int n, int y, int a4) {
    int cur[kChainU];
#pragma unroll
    for (int u = 0; u < kChainU; ++u) cur[u] = k[u];
    int t = 0;
    for (; t + kChainU <= n; t += kChainU) {
        int nxt[kChainU];
#pragma unroll
        for (int u = 0; u < kChainU; ++u) nxt[u] = k[t + kChainU + u];
#pragma unroll
        for (int u = 0; u < kChainU; ++u) {
            y = iir(a4, y, cur[u]);
            k[t + u] = y;
            cur[u] = nxt[u];
        }
    }
    for (; t < n; ++t) {
        y = iir(a4, y, k[t]);
        k[t] = y;
    }
    return y;
}

template <bool MAG_EST, bool FM, bool LANES, typename FmT>
__global__ void __launch_bounds__(kThreads, 1)
frontend_kernel(const uint8_t* __restrict__ iq, int C, int N, int n_valid,
                const int* __restrict__ lane_t0, int T, int am_a1, int am_b,
                int alp1, int blp,
                int* __restrict__ state, int16_t* __restrict__ am,
                FmT* __restrict__ fm, int* __restrict__ env_sum) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int cbase = blockIdx.x * kLanes;
    const int Lc = min(kLanes, C - cbase);       // channels of this block
    const int Lm = min(kLanes, C);               // layout width
    const int KS = T + 1, ES = T + 2;            // row strides (words, halves)
    uchar2* iqs0 = reinterpret_cast<uchar2*>(smem);
    uchar2* iqs1 = iqs0 + Lm * T;
    int* ka = reinterpret_cast<int*>(iqs1 + Lm * T);
    int* kf = ka + Lm * KS;
    uint16_t* envs = reinterpret_cast<uint16_t*>(kf + Lm * KS);
    int16_t* phis = reinterpret_cast<int16_t*>(envs + Lm * ES);
    int* small = reinterpret_cast<int*>(phis + Lm * ES);
    int* s_yam = small;
    int* s_yfm = small + kLanes;
    int* s_pe = small + 2 * kLanes;    // env at the last valid sample
    int* s_pp = small + 3 * kLanes;    // phi at the last valid sample
    int* s_xr = small + 4 * kLanes;    // I, Q at the last valid sample
    int* s_xi = small + 5 * kLanes;
    unsigned* s_sum = reinterpret_cast<unsigned*>(small + 6 * kLanes);
    int* s_nv = small + 7 * kLanes;    // valid samples of each channel

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nv0 = min(max(n_valid, 0), N);     // the one count of !LANES
    if (tid < Lc) {
        const int c = cbase + tid;
        if (LANES) s_nv[tid] = min(max(n_valid - lane_t0[c], 0), N);
        s_yam[tid] = state[0 * C + c]; s_pe[tid] = state[1 * C + c];
        s_yfm[tid] = state[2 * C + c]; s_pp[tid] = state[3 * C + c];
        s_xr[tid] = state[4 * C + c]; s_xi[tid] = state[5 * C + c];
        s_sum[tid] = 0u;
    }
    const int a4am = shl2(am_a1), a4fm = shl2(alp1);
    // store-pass mapping: lane -> (channel, time offset), coalesced for
    // any group width
    int lp_bits = 0;
    while ((1 << lp_bits) < Lc) ++lp_bits;
    const int sc = lane & ((1 << lp_bits) - 1);
    const int nsub = 32 >> lp_bits;
    const int st0 = warp * nsub + (lane >> lp_bits);
    const int sstep = (kThreads / 32) * nsub;

    const uchar2* src = reinterpret_cast<const uchar2*>(iq) + (size_t)cbase * N;
    const bool aligned = (N % 8 == 0) && ((reinterpret_cast<uintptr_t>(iq) & 15) == 0);
    auto stage = [&](uchar2* dst, int t0, int Tj) {
        if (aligned && Tj % 8 == 0) {
            const int pieces = Tj / 8;           // 16 bytes = 8 samples
            for (int c = 0; c < Lc; ++c)
                for (int q = tid; q < pieces; q += kThreads)
                    cp_async16(dst + c * T + 8 * q, src + (size_t)c * N + t0 + 8 * q);
        } else {
            for (int c = 0; c < Lc; ++c)
                for (int t = tid; t < Tj; t += kThreads)
                    dst[c * T + t] = src[(size_t)c * N + t0 + t];
        }
        cp_async_commit();
    };

    const int ntiles = (N + T - 1) / T;
    stage(iqs0, 0, min(T, N));
    for (int j = 0; j < ntiles; ++j) {
        const int t0 = j * T, Tj = min(T, N - t0);
        uchar2* iqs = (j & 1) ? iqs1 : iqs0;
        cp_async_wait_all();
        __syncthreads();   // tile j staged; tile j-1's stores done
        if (j + 1 < ntiles) stage((j & 1) ? iqs0 : iqs1, t0 + T, min(T, N - t0 - T));

        // A. envelope, discriminator, envelope sum
        for (int c = 0; c < Lc; ++c) {
            const uchar2* X = iqs + c * T;
            uint16_t* Ev = envs + c * ES;
            int16_t* Ph = phis + c * ES;
            const int nv = LANES ? s_nv[c] : nv0;
            unsigned acc = 0u;
            for (int t = tid; t < Tj; t += kThreads) {
                const uchar2 s = X[t];
                const int xr = static_cast<int>(s.x) - 128;
                const int xi = static_cast<int>(s.y) - 128;
                int env;
                if (MAG_EST) {
                    const int ax = xr < 0 ? -xr : xr, ay = xi < 0 ? -xi : xi;
                    env = 122 * max(ax, ay) + 51 * min(ax, ay);
                } else {
                    const int ex = -xr - 1, ey = -xi - 1;   // 127 - I, 127 - Q
                    env = ex * ex + ey * ey;
                }
                acc += static_cast<unsigned>(env);
                Ev[t] = static_cast<uint16_t>(env);
                if (FM) {
                    const int p = min(t0 + t, nv) - 1;
                    int pr_r, pr_i;
                    if (p >= t0) {
                        const uchar2 q = X[p - t0];
                        pr_r = static_cast<int>(q.x) - 128;
                        pr_i = static_cast<int>(q.y) - 128;
                    } else {
                        pr_r = s_xr[c];
                        pr_i = s_xi[c];
                    }
                    const int pr = xr * pr_r + xi * pr_i;
                    const int pi = xi * pr_r - xr * pr_i;
                    Ph[t] = static_cast<int16_t>(atan2_int16(pi, pr));
                }
            }
            acc = __reduce_add_sync(kFull, acc);
            if (lane == 0) atomicAdd(&s_sum[c], acc);
        }
        __syncthreads();

        // B. IIR input terms, pre-shifted
        for (int c = 0; c < Lc; ++c) {
            const uint16_t* Ev = envs + c * ES;
            const int16_t* Ph = phis + c * ES;
            const int nv = LANES ? s_nv[c] : nv0;
            for (int t = tid; t < Tj; t += kThreads) {
                const int p = min(t0 + t, nv) - 1;
                const int pe = p >= t0 ? static_cast<int>(Ev[p - t0]) : s_pe[c];
                ka[c * KS + t] = shl2(am_b * (static_cast<int>(Ev[t]) + pe));
                if (FM) {
                    const int pp = p >= t0 ? static_cast<int>(Ph[p - t0]) : s_pp[c];
                    kf[c * KS + t] = shl2(blp * (static_cast<int>(Ph[t]) + pp));
                }
            }
        }
        __syncthreads();

        // C. the two chains, one lane per channel; warp 2 takes the carries
        const int nvl =
            min(max((LANES ? (lane < Lc ? s_nv[lane] : 0) : nv0) - t0, 0), Tj);
        if (warp == 0 && lane < Lc) {
            s_yam[lane] = chain(ka + lane * KS, nvl, s_yam[lane], a4am);
        } else if (FM && warp == 1 && lane < Lc) {
            s_yfm[lane] = chain(kf + lane * KS, nvl, s_yfm[lane], a4fm);
        } else if (warp == 2 && lane < Lc && nvl > 0) {
            const int pl = nvl - 1;
            s_pe[lane] = envs[lane * ES + pl];
            if (FM) {
                const uchar2 q = iqs[lane * T + pl];
                s_xr[lane] = static_cast<int>(q.x) - 128;
                s_xi[lane] = static_cast<int>(q.y) - 128;
                s_pp[lane] = phis[lane * ES + pl];
            }
        }
        __syncthreads();

        // D. coalesced stores; past n_valid from the frozen carries
        if (sc < Lc) {
            const int ya0 = s_yam[sc], yf0 = s_yfm[sc];
            const int nvl = min(max((LANES ? s_nv[sc] : nv0) - t0, 0), Tj);
            for (int t = st0; t < Tj; t += sstep) {
                const size_t o = (size_t)(t0 + t) * C + cbase + sc;
                int ya = ka[sc * KS + t];
                if (t >= nvl) ya = iir(a4am, ya0, ya);
                am[o] = static_cast<int16_t>(ya);
                if (FM) {
                    int yf = kf[sc * KS + t];
                    if (t >= nvl) yf = iir(a4fm, yf0, yf);
                    fm[o] = static_cast<FmT>(yf);
                } else {
                    fm[o] = static_cast<FmT>(envs[sc * ES + t]);
                }
            }
        }
    }
    __syncthreads();
    if (tid < Lc) {
        const int c = cbase + tid;
        state[0 * C + c] = s_yam[tid]; state[1 * C + c] = s_pe[tid];
        state[2 * C + c] = s_yfm[tid]; state[3 * C + c] = s_pp[tid];
        state[4 * C + c] = s_xr[tid]; state[5 * C + c] = s_xi[tid];
        env_sum[c] = static_cast<int>(s_sum[tid]);
    }
}

// Shared bytes per sample and channel: two iq buffers, K_am, K_fm, env, phi
constexpr int kBytesPerSample = 2 * 2 + 4 + 4 + 2 + 2;

template <bool MAG_EST, bool FM, typename FmT>
int launch(const void* iq, int C, int N, int n_valid, const int* lane_t0,
           int am_a1, int am_b, int alp1, int blp, void* state, void* am,
           void* fm, void* env_sum, cudaStream_t stream) {
    const int Lm = C < kLanes ? C : kLanes;
    int T = (kSmemBudget - kSmall * 4 - 64) / (kBytesPerSample * Lm) / 64 * 64;
    const int n64 = (N + 63) / 64 * 64;
    if (T > n64) T = n64;
    const size_t smem = (size_t)Lm * T * 2 * 2 + (size_t)Lm * (T + 1) * 4 * 2 +
                        (size_t)Lm * (T + 2) * 2 * 2 +
                        (lane_t0 ? kSmallNv : kSmall) * 4;
    auto kern = lane_t0 ? frontend_kernel<MAG_EST, FM, true, FmT>
                        : frontend_kernel<MAG_EST, FM, false, FmT>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (C + kLanes - 1) / kLanes;
    kern<<<blocks, kThreads, smem, stream>>>(
        static_cast<const uint8_t*>(iq), C, N, n_valid, lane_t0, T, am_a1,
        am_b, alp1, blp, static_cast<int*>(state), static_cast<int16_t*>(am),
        static_cast<FmT*>(fm), static_cast<int*>(env_sum));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// iq: uint8 [C, N, 2]; state: int32 [6, C] (lp_y, lp_x, fm_y, fm_phi_prev,
// fm_xr, fm_xi), updated in place; am: int16 [N, C]; fm: int16 [N, C], or
// int32 [N, C] with FM off; env_sum: int32 [C] (uint32 bits); lane_t0:
// null, or int32 [C], each channel's block-frame origin (n_valid is then in
// the block frame).
// Returns cudaGetLastError() after the launch.
extern "C" int rtl433_frontend(const void* iq, int C, int N, int n_valid,
                               const void* lane_t0, int use_mag_est,
                               int enable_fm, int am_a1, int am_b, int alp1,
                               int blp, void* state, void* am, void* fm,
                               void* env_sum, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* t0v = static_cast<const int*>(lane_t0);
    if (use_mag_est && enable_fm)
        return launch<true, true, int16_t>(iq, C, N, n_valid, t0v, am_a1, am_b,
                                           alp1, blp, state, am, fm, env_sum, s);
    if (use_mag_est)
        return launch<true, false, int32_t>(iq, C, N, n_valid, t0v, am_a1, am_b,
                                            alp1, blp, state, am, fm, env_sum, s);
    if (enable_fm)
        return launch<false, true, int16_t>(iq, C, N, n_valid, t0v, am_a1, am_b,
                                            alp1, blp, state, am, fm, env_sum, s);
    return launch<false, false, int32_t>(iq, C, N, n_valid, t0v, am_a1, am_b,
                                         alp1, blp, state, am, fm, env_sum, s);
}
