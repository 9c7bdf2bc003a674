// The declarative decode bank: every (bit row, protocol) candidate through
// the length gate, the preamble search, the invert/Manchester transforms,
// the MIC checks and the field extraction.
//
// Replaces the JAX package's ops/decode_bank.py run (:334) on its xp=jnp
// backend (XLA under jit); the wrapper and the plain torch version are in
// ops/decode_bank.py (run_torch, run_torch_plain), which also builds the
// tables: the spec rows (SP_* and CK_FIELDS there) and the per-spec
// weight tables gf2 [S, C, FB] (uint32), add [S, C, FB] (int32) and raw
// [S, R, FB] (uint32).
//
// One warp per candidate, WARPS candidates per CTA. The row's IN stored
// bits are packed MSB first into 32-bit words in shared memory with one
// ballot per word; lane l tests the preamble at offsets t = l (mod 32),
// 32 offsets per step, each a funnel-shifted 32-bit window against the
// spec's pattern and care mask (first match: the lowest set bit of the
// step's ballot, as the JAX argmax takes the first t). The frame (FB
// bytes) goes to shared memory: stale stored bits below n_store are read,
// zero outside [0, n_store); invert flips bits below n. Manchester finds
// its first stop pair with a ballot and compacts the second bits in
// place. Each check slot is a lane-local XOR (GF(2)) or wrapping int32 sum
// (additive) over the set frame bits, then a warp reduction; each field
// a wrapping uint32 sum. C's % truncates where the JAX code floors:
// ((s % mod) + mod) % mod is the same for mod > 0 either way.
//
// Bound: the candidate's IN bytes and four int32 read once, 4 + 4R bytes
// written; the tables (~1.7 MB for the 77 specs) stay in L2. The work is
// about FB * (1 + C + R) int32 operations per candidate plus the offsets
// the preamble search tries, so a drain's batch of a few thousand
// candidates is a few microseconds of the card either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // candidates per CTA
constexpr unsigned FULL = 0xffffffffu;

// the spec row (ops/decode_bank.py SP_*, CK_FIELDS)
enum {
  SP_MIN = 0, SP_MAX = 1, SP_EL = 2, SP_LA_LEN = 6, SP_LA_OFF = 8,
  SP_PLEN = 10, SP_PRE_START = 11, SP_ALIGN = 12, SP_NEED = 13, SP_TF = 14,
  SP_MC_MIN = 15, SP_NRAW = 16, SP_CHECKS = 17
};
enum { CK_KIND = 0, CK_NEQ = 1, CK_TC = 2, CK_MOD = 3, CK_TCA = 4,
       CK_FIELDS = 5 };
enum { CK_OFF = 0, CK_GF2 = 1 };
enum { TF_INVERT = 1, TF_MANCHESTER = 2 };
enum { ABORT_LENGTH = -1, ABORT_EARLY = -2, FAIL_MIC = -3 };

__device__ __forceinline__ unsigned bit_at(const unsigned* w, int i) {
  return (w[i >> 5] >> (31 - (i & 31))) & 1u;
}

// the 32 stored bits from bit t on, MSB first
__device__ __forceinline__ unsigned window(const unsigned* w, int t) {
  return __funnelshift_l(w[(t >> 5) + 1], w[t >> 5], t & 31);
}

__device__ __forceinline__ unsigned warp_xor(unsigned x) {
  for (int o = 16; o; o >>= 1) x ^= __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ unsigned warp_sum(unsigned x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__global__ void decl_bank_kernel(
    const uint8_t* __restrict__ bits, const int* __restrict__ n_bits,
    const int* __restrict__ n_store, const int* __restrict__ sid, int B,
    int IN, const int* __restrict__ spec, int K, int S,
    const unsigned* __restrict__ gf2, const int* __restrict__ add,
    const unsigned* __restrict__ raw, int FB, int C, int R, int PW,
    int* code, unsigned* raws) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + wib;
  if (b >= B) return;  // the whole warp
  const int NWP = ((IN + 31) >> 5) + PW + 1;
  unsigned* words = smem + wib * (NWP + ((FB + 3) >> 2));
  uint8_t* fb = (uint8_t*)(words + NWP);
  const int n = n_bits[b], ns = n_store[b], s = sid[b];
  if (s < 0 || s >= S) {  // not a spec: no read out of the tables
    for (int r = lane; r < R; r += 32) raws[(size_t)b * R + r] = 0;
    if (lane == 0) code[b] = ABORT_LENGTH;
    return;
  }
  const int* sp = spec + (size_t)s * K;

  // the stored bits, packed MSB first; zero past IN
  const uint8_t* row = bits + (size_t)b * IN;
  for (int w = 0; w < NWP; ++w) {
    const int i = (w << 5) + lane;
    const unsigned bal = __ballot_sync(FULL, i < IN && row[i] != 0);
    if (lane == 0) words[w] = __brev(bal);
  }
  __syncwarp();

  // length gate
  bool ok_len = n >= sp[SP_MIN] && n <= sp[SP_MAX];
  bool has_el = false, in_el = false;
  for (int k = 0; k < 4; ++k) {
    has_el |= sp[SP_EL + k] > 0;
    in_el |= sp[SP_EL + k] == n;
  }
  ok_len = ok_len && (!has_el || in_el);

  // preamble: the first t >= pre_start with t + plen <= n that matches
  const int plen = sp[SP_PLEN];
  bool found = false;
  int pos = 0;
  if (plen > 0) {
    const unsigned* pat = (const unsigned*)(sp + SP_CHECKS + CK_FIELDS * C);
    const unsigned* care = pat + PW;
    const int pre = sp[SP_PRE_START];
    const int t_end = min(IN, n - plen + 1);
    for (int base = max(pre, 0) & ~31; base < t_end; base += 32) {
      const int t = base + lane;
      bool m = t < t_end && t >= pre;
      for (int k = 0; m && k < PW; ++k)
        m = ((window(words, t + 32 * k) ^ pat[k]) & care[k]) == 0;
      const unsigned bal = __ballot_sync(FULL, m);
      if (bal) {
        found = true;
        pos = base + __ffs(bal) - 1;
        break;
      }
    }
  }
  int frame_off = (plen > 0 ? pos + plen : 0) + sp[SP_ALIGN];
  for (int k = 0; k < 2; ++k) {
    const int la = sp[SP_LA_LEN + k];
    if (la > 0 && la == n) frame_off += sp[SP_LA_OFF + k];
  }
  const bool ok_pre = plen == 0 || found;
  const bool ok_need = frame_off + sp[SP_NEED] <= n;

  // frame, and invert
  const int tf = sp[SP_TF];
  for (int j = lane; j < FB; j += 32) {
    const int src = frame_off + j;
    unsigned v = (src >= 0 && src < ns) ? bit_at(words, min(src, IN - 1))
                                        : 0u;
    if (tf == TF_INVERT && src < n) v ^= 1u;
    fb[j] = (uint8_t)v;
  }
  __syncwarp();

  // Manchester: pairs up to the first equal pair or the first pair whose
  // first bit is at or past n; their second bits, then zeros
  bool ok_tf = true;
  if (tf == TF_MANCHESTER) {
    const int H = FB >> 1;
    int n_out = H;
    for (int base = 0; base < H; base += 32) {
      const int p = base + lane;
      const bool stop =
          p < H && (fb[2 * p] == fb[2 * p + 1] || frame_off + 2 * p >= n);
      const unsigned bal = __ballot_sync(FULL, stop);
      if (bal) {
        n_out = base + __ffs(bal) - 1;
        break;
      }
    }
    // in place: step k reads bytes from 64k + 1 on and writes 32k..32k+31
    for (int base = 0; base < FB; base += 32) {
      const int p = base + lane;
      const uint8_t v = (p < H && p < n_out) ? fb[2 * p + 1] : 0;
      __syncwarp();
      if (p < FB) fb[p] = v;
      __syncwarp();
    }
    ok_tf = n_out >= sp[SP_MC_MIN];
  }

  // MIC checks
  bool ok_mic = true;
  for (int c = 0; c < C; ++c) {
    const int* ck = sp + SP_CHECKS + CK_FIELDS * c;
    const int kind = ck[CK_KIND];
    if (kind == CK_OFF) continue;
    bool ok;
    if (kind == CK_GF2) {
      const unsigned* tab = gf2 + ((size_t)s * C + c) * FB;
      unsigned x = 0;
      for (int j = lane; j < FB; j += 32)
        if (fb[j]) x ^= tab[j];
      ok = warp_xor(x) == (unsigned)ck[CK_TC];
    } else {
      const int* tab = add + ((size_t)s * C + c) * FB;
      unsigned x = 0;
      for (int j = lane; j < FB; j += 32)
        if (fb[j]) x += (unsigned)tab[j];
      const int sum = (int)warp_sum(x), mod = ck[CK_MOD];
      ok = ((sum % mod) + mod) % mod == ck[CK_TCA];
    }
    ok_mic = ok_mic && (ok != (ck[CK_NEQ] != 0));
  }

  // fields (rows past the spec's last non-zero one are 0)
  const int nraw = sp[SP_NRAW];
  for (int r = 0; r < R; ++r) {
    unsigned x = 0;
    if (r < nraw) {
      const unsigned* tab = raw + ((size_t)s * R + r) * FB;
      for (int j = lane; j < FB; j += 32)
        if (fb[j]) x += tab[j];
      x = warp_sum(x);
    }
    if (lane == 0) raws[(size_t)b * R + r] = x;
  }
  if (lane == 0) {
    int c = ABORT_LENGTH;
    if (ok_len) c = ABORT_EARLY;
    if (ok_len && ok_pre && ok_need && ok_tf) c = ok_mic ? 0 : FAIL_MIC;
    code[b] = c;
  }
}

}  // namespace

extern "C" int rtl433_decl_bank(const void* bits, const void* n_bits,
                                const void* n_store, const void* sid, int B,
                                int IN, const void* spec, int K, int S,
                                const void* gf2, const void* add,
                                const void* raw, int FB, int C, int R,
                                int PW, void* code, void* raws,
                                void* stream) {
  const int NWP = ((IN + 31) >> 5) + PW + 1;
  const size_t smem = (size_t)WARPS * 4 * (NWP + ((FB + 3) >> 2));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decl_bank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decl_bank_kernel<<<(B + WARPS - 1) / WARPS, 32 * WARPS, smem,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const int*)n_bits, (const int*)n_store,
      (const int*)sid, B, IN, (const int*)spec, K, S, (const unsigned*)gf2,
      (const int*)add, (const unsigned*)raw, FB, C, R, PW, (int*)code,
      (unsigned*)raws);
  return (int)cudaGetLastError();
}
