// The declarative decode bank: every (bit row, protocol) candidate through
// the length gate, the preamble search, the invert/Manchester transforms,
// the MIC checks and the field extraction.
//
// Replaces the JAX package's ops/decode_bank.py run (:334) on its xp=jnp
// backend (XLA under jit); the wrapper, the plain torch version and a
// plain emulation of this kernel's sparse evaluation are in
// ops/decode_bank.py (run_torch, run_torch_plain, run_torch_sparse_plain),
// which also builds the tables: the spec rows (SP_* and CK_FIELDS there)
// and the sparse entry tables (sparse_tables): per spec, each live check
// slot's and each field row's non-zero (frame bit, weight) pairs, padded
// to chunks of 32, a directory entry per chunk (kind | target << 8) and
// the spec's first chunk (chunk_start). The dense tables hold about 2200
// weights per spec of which some 80 are not zero, so the sparse lists
// drop nearly every load; XOR and wrapping sums do not depend on order,
// so dropping the zeros is exact.
//
// One warp per candidate, WARPS candidates per CTA. The loads come in
// three rounds, each waiting only on the one before: the row's first 512
// bytes (one 16-byte load a lane, where IN is a multiple of 16 and the
// rows are 16-byte aligned) with the candidate's n, n_store and spec id;
// the spec row and the spec's chunk range; each lane's entry of the
// spec's first U chunks (one coalesced 8-byte load a chunk) and their
// directory. The row is packed LSB first (bit i of word k is stored bit
// 32k + i) into shared memory: each lane makes 16 bits of its 16 bytes
// and one shuffle joins two lanes into a word (else one ballot a word).
// Lane l tests the preamble at offsets t = l (mod 32), each a
// funnel-shifted window against the spec's pattern and care mask, up to
// its own first match; the first is the least of the lanes' (one
// __reduce_min_sync, as the JAX argmax takes the first t). Lane
// w < ceil(FB / 32) holds frame word w in a register: a funnel shift of
// two stored words from frame_off + 32w on, with word masks for
// [0, n_store), the clamp of reads past IN to bit IN - 1, invert below n
// and the frame's end. Manchester finds its first stop pair by a ballot
// and compacts the second bits of two frame words into one. An entry
// takes its frame bit from the word's lane by one shuffle; each chunk
// makes one __reduce_xor_sync and one __reduce_add_sync and keeps the one
// its kind asks for (GF(2) check: XOR; additive check, field: sum), so
// that no branch stands between the chunks, G of which run between two
// tests of the chunk count; the lane of the chunk's target (field row r:
// lane r; check slot c: lane R + c) accumulates it. C's % truncates where
// the JAX code floors: ((s % mod) + mod) % mod is the same for mod > 0
// either way.
//
// Bound: the candidate's IN bytes and three int32 read once, 4 + 4R bytes
// written; per spec present its spec row and its non-zero entries (8
// bytes each; the padded table is ~131 KB for the 77 specs, held in L2).
// The work is a few int32 operations per entry and per frame word plus
// the offsets the preamble search tries, so a drain's batch of a few
// thousand candidates is a fraction of a microsecond of the card's
// operations; a call is a chain of latencies (the load rounds, the
// shuffles and reductions of the chunks, the preamble's steps), and a
// large batch is bound by the instructions each warp issues, which the
// sparse lists, the branch-free chunks and the registers kept low (U)
// cut.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // candidates per CTA
constexpr int CHUNK = 32;  // entries per chunk, one per lane
constexpr int U = 12;      // chunks whose entries a lane loads first
constexpr int G = 2;       // chunks reduced together, without a branch
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
enum { CH_GF2 = 0, CH_ADD = 1, CH_RAW = 2 };  // ops/decode_bank.py CH_*
enum { TF_INVERT = 1, TF_MANCHESTER = 2 };
enum { ABORT_LENGTH = -1, ABORT_EARLY = -2, FAIL_MIC = -3 };

// bit positions [a, b) of a word, LSB first; a and b clamped to [0, 32]
__device__ __forceinline__ unsigned range_mask(int a, int b) {
  a = max(a, 0);
  b = min(b, 32);
  if (a >= b) return 0u;  // so a < 32
  return (b == 32 ? ~0u : (1u << b) - 1u) & (~0u << a);
}

// stored word k, 0 outside the row's NW words
__device__ __forceinline__ unsigned stored(const unsigned* w, int NW,
                                           int k) {
  return (k >= 0 && k < NW) ? w[k] : 0u;
}

// the 32 stored bits from bit t on (t may be negative), LSB first
__device__ __forceinline__ unsigned window(const unsigned* w, int NW,
                                           int t) {
  const int k = t >> 5;  // floor
  return __funnelshift_r(stored(w, NW, k), stored(w, NW, k + 1), t & 31);
}

// 4 bytes to 4 bits, byte i to bit i: each non-zero byte's flag at bits
// 0, 8, 16, 24, multiplied to bits 21-24 (no two partial products meet)
__device__ __forceinline__ unsigned nibble(unsigned x) {
  const unsigned t = __vcmpne4(x, 0u) & 0x01010101u;
  return ((t * 0x00204081u) >> 21) & 0xfu;
}

// the 16 odd bits of a word, packed into its low half
__device__ __forceinline__ unsigned compress_odd(unsigned x) {
  x = (x >> 1) & 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0f0f0f0fu;
  x = (x | (x >> 4)) & 0x00ff00ffu;
  return (x | (x >> 8)) & 0x0000ffffu;
}

// one chunk: each lane's entry takes its frame bit from the lane that holds
// its word, one warp reduction, added into the target lane's accumulator
// (field row r: lane r; check slot c: lane R + c)
__device__ __forceinline__ unsigned chunk(unsigned acc, int2 e, int d,
                                          unsigned fw, int lane, int R) {
  const unsigned word = __shfl_sync(FULL, fw, e.x >> 5);
  const unsigned v = ((word >> (e.x & 31)) & 1u) ? (unsigned)e.y : 0u;
  const int kind = d & 0xff, target = d >> 8;
  // both reductions, then a select: no branch between the chunks
  const unsigned rx = __reduce_xor_sync(FULL, v);
  const unsigned ra = __reduce_add_sync(FULL, v);
  const unsigned red = kind == CH_GF2 ? rx : ra;
  if (lane != (kind == CH_RAW ? target : R + target)) return acc;
  return kind == CH_GF2 ? acc ^ red : acc + red;
}

__global__ void __launch_bounds__(32 * WARPS)
decl_bank_kernel(const uint8_t* __restrict__ bits,
                 const int* __restrict__ n_bits,
                 const int* __restrict__ n_store,
                 const int* __restrict__ sid, int B, int IN, bool vec,
                 const int* __restrict__ spec, int K, int S,
                 const int2* __restrict__ entries,
                 const int* __restrict__ chunk_dir,
                 const int* __restrict__ chunk_start, int FB, int C, int R,
                 int PW, int* __restrict__ code,
                 unsigned* __restrict__ raws) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + wib;
  if (b >= B) return;  // the whole warp
  const int NW = (IN + 31) >> 5;
  unsigned* words = smem + wib * NW;
  // the loads in three rounds, each waiting only on the one before: the
  // row's first 512 bytes and the candidate's scalars; the spec row and
  // the spec's chunk range; every entry of its first U chunks
  const uint8_t* row = bits + (size_t)b * IN;
  uint4 v0 = make_uint4(0u, 0u, 0u, 0u);
  if (vec && 16 * lane < IN)
    v0 = __ldg(reinterpret_cast<const uint4*>(row) + lane);
  const int n = __ldg(n_bits + b), ns = __ldg(n_store + b);
  const int s = __ldg(sid + b);
  if (s < 0 || s >= S) {  // not a spec: no read out of the tables
    for (int r = lane; r < R; r += 32) raws[(size_t)b * R + r] = 0;
    if (lane == 0) code[b] = ABORT_LENGTH;
    return;
  }
  const int* sp = spec + (size_t)s * K;
  const int c0 = __ldg(chunk_start + s);
  const int nch = __ldg(chunk_start + s + 1) - c0;
  const int min_bits = __ldg(sp + SP_MIN), max_bits = __ldg(sp + SP_MAX);
  int el[4], la_len[2], la_off[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) el[k] = __ldg(sp + SP_EL + k);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    la_len[k] = __ldg(sp + SP_LA_LEN + k);
    la_off[k] = __ldg(sp + SP_LA_OFF + k);
  }
  const int plen = __ldg(sp + SP_PLEN), pre = __ldg(sp + SP_PRE_START);
  const int align = __ldg(sp + SP_ALIGN), need = __ldg(sp + SP_NEED);
  const int tf = __ldg(sp + SP_TF), mc_min = __ldg(sp + SP_MC_MIN);
  // the pattern's first word and its care mask, LSB first
  const int* pat = sp + SP_CHECKS + CK_FIELDS * C;  // MSB first
  const unsigned pat0 = PW > 0 ? __brev((unsigned)__ldg(pat)) : 0u;
  const unsigned care0 = PW > 0 ? __brev((unsigned)__ldg(pat + PW)) : 0u;
  // lane R + c: check slot c's kind, negation, targets and modulus
  int ck[CK_FIELDS] = {CK_OFF, 0, 0, 1, 0};
  if (lane >= R && lane < R + C) {
#pragma unroll
    for (int f = 0; f < CK_FIELDS; ++f)
      ck[f] = __ldg(sp + SP_CHECKS + CK_FIELDS * (lane - R) + f);
  }

  const int dirs = lane < nch ? __ldg(chunk_dir + c0 + lane) : 0;
  int2 e[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    e[u] = u < nch ? __ldg(entries + (size_t)(c0 + u) * CHUNK + lane)
                   : make_int2(0, 0);

  // the stored bits, packed LSB first; zero past IN
  if (vec) {
    for (int c = 0; c < IN; c += 16 * 32) {
      const int i = c + 16 * lane;
      unsigned h = 0;
      if (i < IN) {
        const uint4 v =
            c == 0 ? v0 : __ldg(reinterpret_cast<const uint4*>(row + i));
        h = nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
            nibble(v.w) << 12;
      }
      const unsigned hi = __shfl_down_sync(FULL, h, 1);
      if (!(lane & 1) && i < IN) words[(c >> 5) + (lane >> 1)] = h | hi << 16;
    }
  } else {
    for (int w = 0; w < NW; ++w) {
      const int i = (w << 5) + lane;
      const unsigned bal = __ballot_sync(FULL, i < IN && row[i] != 0);
      if (lane == 0) words[w] = bal;
    }
  }
  __syncwarp();

  // length gate
  bool ok_len = n >= min_bits && n <= max_bits;
  bool has_el = false, in_el = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    has_el |= el[k] > 0;
    in_el |= el[k] == n;
  }
  ok_len = ok_len && (!has_el || in_el);

  // preamble: the first t >= pre_start with t + plen <= n that matches.
  // Lane l tests t0 + l, t0 + l + 32, ... up to its own first match; the
  // warp's first is the least of the lanes' (one reduction)
  bool found = false;
  int pos = 0;
  if (plen > 0) {
    const int t_end = min(IN, n - plen + 1);
    int first = INT_MAX;
    for (int t = max(pre, 0) + lane; t < t_end; t += 32) {
      bool m = ((window(words, NW, t) ^ pat0) & care0) == 0;
      for (int k = 1; m && k < PW; ++k)
        m = ((window(words, NW, t + 32 * k) ^
              __brev((unsigned)__ldg(pat + k))) &
             __brev((unsigned)__ldg(pat + PW + k))) == 0;
      if (m) {
        first = t;
        break;
      }
    }
    first = __reduce_min_sync(FULL, first);
    found = first != INT_MAX;
    pos = found ? first : 0;
  }
  int frame_off = (plen > 0 ? pos + plen : 0) + align;
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (la_len[k] > 0 && la_len[k] == n) frame_off += la_off[k];
  const bool ok_pre = plen == 0 || found;
  const bool ok_need = frame_off + need <= n;

  // the frame: lane w holds frame bits 32w .. 32w + 31 (0 past FB)
  const int t = frame_off + 32 * lane;
  unsigned fw = window(words, NW, t);
  const unsigned last = (words[(IN - 1) >> 5] >> ((IN - 1) & 31)) & 1u;
  const unsigned past = range_mask(IN - t, 32);  // reads clamp to IN - 1
  fw = (fw & ~past) | (last ? past : 0u);
  fw &= range_mask(-t, ns - t);
  if (tf == TF_INVERT) fw ^= range_mask(0, n - t);
  fw &= range_mask(0, FB - 32 * lane);

  // Manchester: pairs up to the first equal pair or the first pair whose
  // first bit is at or past n; their second bits, then zeros
  bool ok_tf = true;
  if (tf == TF_MANCHESTER) {
    const int H = FB >> 1;
    const unsigned pairs = 0x55555555u;  // a pair's first bit
    const unsigned eq = ~(fw ^ (fw >> 1)) & pairs;
    const unsigned gone = range_mask(n - frame_off - 32 * lane, 32) & pairs;
    const unsigned stop = (eq | gone) & range_mask(0, 2 * H - 32 * lane);
    const unsigned bal = __ballot_sync(FULL, stop != 0);
    int n_out = H;
    if (bal) {
      const int L = __ffs(bal) - 1;
      const unsigned first = __shfl_sync(FULL, stop, L);
      n_out = 16 * L + ((__ffs(first) - 1) >> 1);
    }
    const unsigned odd = compress_odd(fw);
    const unsigned lo = __shfl_sync(FULL, odd, (2 * lane) & 31);
    const unsigned hi = __shfl_sync(FULL, odd, (2 * lane + 1) & 31);
    fw = lane < 16 ? (lo | hi << 16) & range_mask(0, n_out - 32 * lane)
                   : 0u;
    ok_tf = n_out >= mc_min;
  }

  // the chunks, the first U from the entries loaded at the start in
  // groups of G without a branch (a chunk past nch has zero entries and
  // directory entry 0: an XOR of 0 into check slot 0), then any more
  unsigned acc = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u % G == 0 && u >= nch) break;
    acc = chunk(acc, e[u], __shfl_sync(FULL, dirs, u), fw, lane, R);
  }
  for (int ch = U; ch < nch; ++ch)
    acc = chunk(acc, __ldg(entries + (size_t)(c0 + ch) * CHUNK + lane),
                __ldg(chunk_dir + c0 + ch), fw, lane, R);

  // the checks on lanes R .. R + C - 1, the fields on lanes 0 .. R - 1
  bool bad = false;
  if (ck[CK_KIND] != CK_OFF) {
    bool ok;
    if (ck[CK_KIND] == CK_GF2) {
      ok = acc == (unsigned)ck[CK_TC];
    } else {
      const int sum = (int)acc, mod = ck[CK_MOD];
      ok = ((sum % mod) + mod) % mod == ck[CK_TCA];
    }
    bad = ok == (ck[CK_NEQ] != 0);
  }
  const bool ok_mic = !__any_sync(FULL, bad);
  if (lane < R) raws[(size_t)b * R + lane] = acc;
  if (lane == 0) {
    int c = ABORT_LENGTH;
    if (ok_len) c = ABORT_EARLY;
    if (ok_len && ok_pre && ok_need && ok_tf) c = ok_mic ? 0 : FAIL_MIC;
    code[b] = c;
  }
}

}  // namespace

// R + C <= 32 and FB <= 1024 (a frame word and an accumulator per lane):
// the wrapper checks both
extern "C" int rtl433_decl_bank(const void* bits, const void* n_bits,
                                const void* n_store, const void* sid, int B,
                                int IN, const void* spec, int K, int S,
                                const void* entries, const void* chunk_dir,
                                const void* chunk_start, int FB, int C,
                                int R, int PW, void* code, void* raws,
                                void* stream) {
  if (B < 1 || IN < 1 || FB > 32 * 32 || R + C > 32)
    return (int)cudaErrorInvalidValue;
  const bool vec = (IN & 15) == 0 && ((uintptr_t)bits & 15) == 0;
  const size_t smem = (size_t)WARPS * 4 * ((IN + 31) >> 5);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decl_bank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decl_bank_kernel<<<(B + WARPS - 1) / WARPS, 32 * WARPS, smem,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const int*)n_bits, (const int*)n_store,
      (const int*)sid, B, IN, vec, (const int*)spec, K, S,
      (const int2*)entries, (const int*)chunk_dir, (const int*)chunk_start,
      FB, C, R, PW, (int*)code, (unsigned*)raws);
  return (int)cudaGetLastError();
}
