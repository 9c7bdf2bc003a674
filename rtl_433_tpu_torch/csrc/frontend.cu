// Fused baseband front-end for cu8 IQ, one thread per channel.
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
// With FM off the fm stream is the raw envelope as int32 (the reference's
// buf.temp/buf.fm union alias).
//
// Design: the TPU kernel tiled channels over vector lanes and carried the
// IIR state across sequential grid steps in VMEM. Here one thread owns one
// channel and walks the whole block in time order with the six carries and
// the sum in registers, so nothing is carried between blocks of the grid.
// Outputs are time-major [N, C] (what the detector scan reads), so the
// stores of one time step are coalesced across a warp.
//
// Bound on an H100: bytes moved are 2 (iq) + 2 (am) + 2 or 4 (fm) per
// sample; at C=1 the time is set instead by the serial chain of N IIR steps
// (each y[n] needs y[n-1]: multiply-add, shift, sign-extend). The kernel
// does nothing about the chain yet; splitting time is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kIPi4 = 32767 / 4;           // 8191
constexpr int kI3Pi4 = 3 * 32767 / 4;      // 24575

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

template <bool MAG_EST, bool FM, typename FmT>
__global__ void frontend_kernel(const uint8_t* __restrict__ iq, int C, int N,
                                int n_valid, int am_a1, int am_b, int alp1,
                                int blp, int* __restrict__ state,
                                int16_t* __restrict__ am,
                                FmT* __restrict__ fm,
                                int* __restrict__ env_sum) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    int lp_y = state[0 * C + c], lp_x = state[1 * C + c];
    int fm_y = state[2 * C + c], fm_pp = state[3 * C + c];
    int pr_r = state[4 * C + c], pr_i = state[5 * C + c];
    unsigned acc = 0u;
    const uchar2* src = reinterpret_cast<const uchar2*>(iq) + (size_t)c * N;
    for (int t = 0; t < N; ++t) {
        const uchar2 s = src[t];
        const int xr = static_cast<int>(s.x) - 128;
        const int xi = static_cast<int>(s.y) - 128;
        const bool upd = t < n_valid;
        int env;
        if (MAG_EST) {
            const int ax = xr < 0 ? -xr : xr, ay = xi < 0 ? -xi : xi;
            env = 122 * max(ax, ay) + 51 * min(ax, ay);
        } else {
            const int ex = -xr - 1, ey = -xi - 1;   // 127 - I, 127 - Q
            env = ex * ex + ey * ey;
        }
        acc += static_cast<unsigned>(env);
        const int a = sext16((am_a1 * lp_y + am_b * (env + lp_x)) >> 14);
        am[(size_t)t * C + c] = static_cast<int16_t>(a);
        if (upd) { lp_y = a; lp_x = env; }
        if (FM) {
            const int pr = xr * pr_r + xi * pr_i;
            const int pi = xi * pr_r - xr * pr_i;
            const int phi = atan2_int16(pi, pr);
            const int f = sext16((alp1 * fm_y + blp * (phi + fm_pp)) >> 14);
            fm[(size_t)t * C + c] = static_cast<FmT>(f);
            if (upd) { fm_y = f; fm_pp = phi; pr_r = xr; pr_i = xi; }
        } else {
            fm[(size_t)t * C + c] = static_cast<FmT>(env);
        }
    }
    state[0 * C + c] = lp_y; state[1 * C + c] = lp_x;
    state[2 * C + c] = fm_y; state[3 * C + c] = fm_pp;
    state[4 * C + c] = pr_r; state[5 * C + c] = pr_i;
    env_sum[c] = static_cast<int>(acc);
}

template <bool MAG_EST, bool FM, typename FmT>
void launch(const void* iq, int C, int N, int n_valid, int am_a1, int am_b,
            int alp1, int blp, void* state, void* am, void* fm, void* env_sum,
            cudaStream_t stream) {
    // 32 threads a block spreads a few thousand channels over all SMs
    const int threads = 32;
    const int blocks = (C + threads - 1) / threads;
    frontend_kernel<MAG_EST, FM, FmT><<<blocks, threads, 0, stream>>>(
        static_cast<const uint8_t*>(iq), C, N, n_valid, am_a1, am_b, alp1,
        blp, static_cast<int*>(state), static_cast<int16_t*>(am),
        static_cast<FmT*>(fm), static_cast<int*>(env_sum));
}

}  // namespace

// iq: uint8 [C, N, 2]; state: int32 [6, C] (lp_y, lp_x, fm_y, fm_phi_prev,
// fm_xr, fm_xi), updated in place; am: int16 [N, C]; fm: int16 [N, C], or
// int32 [N, C] with FM off; env_sum: int32 [C] (uint32 bits).
// Returns cudaGetLastError() after the launch.
extern "C" int rtl433_frontend(const void* iq, int C, int N, int n_valid,
                               int use_mag_est, int enable_fm, int am_a1,
                               int am_b, int alp1, int blp, void* state,
                               void* am, void* fm, void* env_sum,
                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (use_mag_est && enable_fm)
        launch<true, true, int16_t>(iq, C, N, n_valid, am_a1, am_b, alp1, blp,
                                    state, am, fm, env_sum, s);
    else if (use_mag_est)
        launch<true, false, int32_t>(iq, C, N, n_valid, am_a1, am_b, alp1,
                                     blp, state, am, fm, env_sum, s);
    else if (enable_fm)
        launch<false, true, int16_t>(iq, C, N, n_valid, am_a1, am_b, alp1,
                                     blp, state, am, fm, env_sum, s);
    else
        launch<false, false, int32_t>(iq, C, N, n_valid, am_a1, am_b, alp1,
                                      blp, state, am, fm, env_sum, s);
    return static_cast<int>(cudaGetLastError());
}
