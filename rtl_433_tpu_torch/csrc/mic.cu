// Batched MIC digests: the twelve functions of the JAX package's
// ops/mic.py (crc8 :32 ... parity_bytes :164) over [rows, stride] byte rows
// (ref src/bit_util.c:240-556).
//
// One template for all twelve (enum Algo, in the order of ops/_cuda.py
// MIC_ALGOS); the input is uint8 or int32 (read & 0xFF), of any stride.
//
// What bounds it. The message bytes read once and one int32 written per
// row, or the integer work per message byte, whichever is larger; the work
// is the least a table-driven digest needs (chip_smoke.py's MIC_OPS: the
// table read and the remainder's update, not this kernel's address
// arithmetic), so at 16-byte rows every digest but crc16 is bound by its
// bytes. At 65536 rows of 16 bytes either bound is under a microsecond, so
// a call there is latency: the launch and one dependent chain of loads.
//
// Design. A thread per row, CTAs of kThreads rows, a persistent grid (the
// CTAs one SM holds at once, times the SMs) looping over the tiles of rows,
// so that the tables below are loaded into shared memory once a CTA.
//  - Rows. The digest reads its row a 16-byte chunk at a time, as four
//    little-endian words of bytes, from one of two sources, chosen by the
//    launcher from the shape: VEC, 16-byte loads of the row itself, where
//    the rows are 16-byte aligned (uint8 rows of a stride that is a
//    multiple of 16, int32 rows of a multiple of 4, on an aligned base): at
//    stride 16 a warp's loads are one contiguous 512-byte span, and on
//    wider rows only the chunks under nbytes are read; SCALAR, single loads
//    of the first nbytes bytes (or ints), for every other shape (stride 15,
//    an offset view, unaligned int32 rows). Unaligned rows are not staged
//    through shared memory: the digests' callers pass aligned byte rows,
//    and no timing has shown a staged copy beating the single loads there.
//  - CRCs: a byte step from a 256-entry table per (algorithm, polynomial),
//    built on the host (ops/mic.py crc_table) by the bit-serial recurrence
//    of the JAX code; the CRC is linear, so eight bit steps on a state x
//    are T[x] (8-bit), (x >> 8) ^ T[x & 0xFF] (LSB-first 16-bit) or
//    ((x & 0xFF) << 8) ^ T[x >> 8] (MSB-first 16-bit). The table is held in
//    kCopies interleaved copies, lane l reading copy l % kCopies, so that
//    the random lookups of a warp meet in a bank at most rarely.
//  - LFSR digests: the rolling-key schedule does not depend on the data,
//    so the host folds it into two 16-entry tables per byte position
//    (ops/mic.py lfsr_tables: the XOR of the keys under each high and each
//    low nibble); a byte is two lookups and two XORs, taken a whole word
//    at a time (the nibbles' table offsets cut from the word at once) and
//    byte by byte in a last partial word. All threads read the same
//    position's 32 words at once, one word per bank. Positions are loaded
//    `chunk` at a time
//    (ops/mic.py MIC_CHUNK); a longer message walks its positions in
//    chunks, every tile reloading them.
//  - Folds (xor_bytes, add_bytes, add_nibbles, parity_bytes): word-wide,
//    four bytes an operation (__dp4a for the sums), the last word masked
//    to nbytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Algo {
  CRC8, CRC8LE, CRC16, CRC16LSB, LFSR8, LFSR8_REVERSE, LFSR8_REFLECT,
  LFSR16, XOR_BYTES, ADD_BYTES, ADD_NIBBLES, PARITY_BYTES, N_ALGOS
};

// how a thread reads its row
enum Path { VEC, SCALAR };

constexpr int kThreads = 256;  // rows per tile, a thread per row; the
                               // CRC table's entries, one per thread
constexpr int kCopies = 8;     // interleaved copies of a CRC table

__host__ __device__ constexpr bool is_crc(int a) { return a <= CRC16LSB; }
__host__ __device__ constexpr bool is_lfsr(int a) {
  return a >= LFSR8 && a <= LFSR16;
}

// ---- the digests: a state fed byte by byte (or word by word)

template <int A>
struct Crc {
  static constexpr bool kFold = false, kWordStep = false;
  unsigned v;
  const unsigned* t;  // this lane's table copy: entry i at t[i * kCopies]
  __device__ Crc(int init, const unsigned* tab)
      : v(A == CRC8 || A == CRC8LE ? init & 0xFF : init & 0xFFFF), t(tab) {}
  __device__ __forceinline__ void byte(unsigned b) {
    if (A == CRC8 || A == CRC8LE) {
      v = t[(v ^ b) * kCopies];
    } else if (A == CRC16) {
      v = ((v << 8) & 0xFFFF) ^ t[((v >> 8) ^ b) * kCopies];
    } else {  // CRC16LSB
      v = (v >> 8) ^ t[((v ^ b) & 0xFF) * kCopies];
    }
  }
  __device__ int result(int) const { return static_cast<int>(v); }
};

template <int A>
struct Lfsr {
  static constexpr bool kFold = false, kWordStep = true;
  unsigned v = 0;
  const unsigned* p;  // this position's tables: high nibble, then low
  __device__ Lfsr(int, const unsigned* tab) : p(tab) {}
  __device__ __forceinline__ void byte(unsigned b) {
    v ^= p[b >> 4] ^ p[16 + (b & 15)];
    p += 32;
  }
  // four bytes at once: each nibble times 4 is the byte offset of its
  // table word (high nibble tables at 0, low at 64 bytes; 128 bytes a
  // position), taken from the word without a byte's extraction
  __device__ __forceinline__ void word(unsigned w) {
    const unsigned hi = (w >> 2) & 0x3C3C3C3Cu, lo = (w << 2) & 0x3C3C3C3Cu;
    const char* q = reinterpret_cast<const char*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v ^= *reinterpret_cast<const unsigned*>(q + 128 * j +
                                              __byte_perm(hi, 0, 0x4440 + j)) ^
           *reinterpret_cast<const unsigned*>(q + 128 * j + 64 +
                                              __byte_perm(lo, 0, 0x4440 + j));
    p += 128;
  }
  __device__ int result(int mask) const { return static_cast<int>(v) & mask; }
};

template <int A>
struct Fold {
  static constexpr bool kFold = true, kWordStep = true;
  unsigned v = 0;
  __device__ Fold(int, const unsigned*) {}
  __device__ __forceinline__ void word(unsigned w) {
    if (A == XOR_BYTES || A == PARITY_BYTES) {
      v ^= w;
    } else if (A == ADD_BYTES) {
      v = __dp4a(w, 0x01010101u, v);
    } else {  // ADD_NIBBLES: the two nibbles of a byte sum below 31
      v = __dp4a((w & 0x0F0F0F0Fu) + ((w >> 4) & 0x0F0F0F0Fu), 0x01010101u,
                 v);
    }
  }
  __device__ int result(int) const {
    unsigned x = v;
    if (A == XOR_BYTES || A == PARITY_BYTES) {
      x ^= x >> 16;
      x = (x ^ (x >> 8)) & 0xFF;
      if (A == PARITY_BYTES) {
        x ^= x >> 4;
        x = (0x6996u >> (x & 0xF)) & 1;
      }
    }
    return static_cast<int>(x);
  }
};

template <int A>
using Digest = typename std::conditional<
    is_crc(A), Crc<A>,
    typename std::conditional<is_lfsr(A), Lfsr<A>, Fold<A>>::type>::type;

// nb (1 to 4) bytes of word w, first byte lowest: a fold takes the word
// masked to them, an LFSR digest a whole word at once, else byte by byte
template <class D>
__device__ __forceinline__ void feed(D& d, unsigned w, int nb) {
  if constexpr (D::kFold) {
    d.word(nb >= 4 ? w : w & ((1u << (8 * nb)) - 1));
  } else {
    if constexpr (D::kWordStep) {
      if (nb >= 4) {
        d.word(w);
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nb) d.byte((w >> (8 * j)) & 0xFF);
  }
}

// ---- the row sources: chunk(k, k1) is bytes [k, k + 16) of the row as
// four words (k a multiple of 16; bytes at or past k1 are not read where a
// read could leave the row, and are never used)

__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

template <typename T, int PATH>
struct Row;

template <>
struct Row<uint8_t, VEC> {
  const uint4* p;
  __device__ explicit Row(const uint8_t* row)
      : p(reinterpret_cast<const uint4*>(row)) {}
  __device__ __forceinline__ uint4 chunk(int k, int) const {
    return __ldg(p + (k >> 4));
  }
};

template <>
struct Row<int, VEC> {
  const int4* p;
  __device__ explicit Row(const int* row)
      : p(reinterpret_cast<const int4*>(row)) {}
  __device__ __forceinline__ unsigned word(int k, int m, int k1) const {
    if (k + 4 * m >= k1) return 0;
    const int4 x = __ldg(p + (k >> 2) + m);
    return pack4(x.x, x.y, x.z, x.w);
  }
  __device__ __forceinline__ uint4 chunk(int k, int k1) const {
    return make_uint4(word(k, 0, k1), word(k, 1, k1), word(k, 2, k1),
                      word(k, 3, k1));
  }
};

template <typename T>
struct Row<T, SCALAR> {
  const T* p;
  __device__ explicit Row(const T* row) : p(row) {}
  __device__ __forceinline__ uint4 chunk(int k, int k1) const {
    int b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      b[i] = k + i < k1 ? static_cast<int>(p[k + i]) : 0;
    return make_uint4(pack4(b[0], b[1], b[2], b[3]),
                      pack4(b[4], b[5], b[6], b[7]),
                      pack4(b[8], b[9], b[10], b[11]),
                      pack4(b[12], b[13], b[14], b[15]));
  }
};

// bytes [k0, k1) of a row into d; k0 a multiple of 16, c the row's bytes
// [k0, k0 + 16) already loaded
template <class D, class R>
__device__ __forceinline__ void digest(D& d, const R& row, int k0, int k1,
                                       uint4 c) {
  int k = k0;
  while (k + 16 <= k1) {
    feed(d, c.x, 4);
    feed(d, c.y, 4);
    feed(d, c.z, 4);
    feed(d, c.w, 4);
    k += 16;
    if (k < k1) c = row.chunk(k, k1);
  }
  if (k < k1) {
    const int n = k1 - k;
    feed(d, c.x, min(n, 4));
    if (n > 4) feed(d, c.y, min(n - 4, 4));
    if (n > 8) feed(d, c.z, min(n - 8, 4));
    if (n > 12) feed(d, c.w, n - 12);
  }
}

// n (at most 8 * kThreads) words of src into dst, every load issued
// before the first store
__device__ __forceinline__ void fill(unsigned* dst, const int* src, int n) {
  unsigned v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int w = threadIdx.x + j * kThreads;
    if (w < n) v[j] = __ldg(src + w);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int w = threadIdx.x + j * kThreads;
    if (w < n) dst[w] = v[j];
  }
}

// this thread's row in tile t
template <typename T, int PATH>
__device__ __forceinline__ Row<T, PATH> row_in(const T* msg, int stride,
                                               int t) {
  return Row<T, PATH>(msg + (static_cast<size_t>(t) * kThreads + threadIdx.x) *
                                stride);
}

// a live row's first 16 bytes
template <class R>
__device__ __forceinline__ uint4 first_chunk(const R& row, bool live,
                                             int nbytes) {
  return live && nbytes > 0 ? row.chunk(0, nbytes) : make_uint4(0, 0, 0, 0);
}

// words of tables in shared memory
template <int A>
__host__ __device__ int table_words(int nbytes, int chunk) {
  if (is_crc(A)) return 256 * kCopies;
  if (is_lfsr(A)) return 32 * (nbytes < chunk ? nbytes : chunk);
  return 0;
}

// init: the CRC's initial remainder (crc8le's already reversed on the
// host); mask: the LFSR key width; table: the CRC byte table [256] or the
// LFSR nibble tables [nbytes, 32] (ops/mic.py crc_table, lfsr_tables)
// an LFSR digest's word steps would hoist a chunk's 32 table reads into
// 72 registers, three CTAs an SM: too few rows in flight at a large batch
template <int A, typename T, int PATH>
__global__ void __launch_bounds__(kThreads, is_lfsr(A) ? 5 : 1)
mic_kernel(const T* __restrict__ msg, int rows, int stride, int nbytes,
           int init, int mask, const int* __restrict__ table, int chunk,
           int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  const int tid = threadIdx.x;
  const int n_tab = table_words<A>(nbytes, chunk);
  unsigned* tab = smem;
  const bool whole = !is_lfsr(A) || nbytes <= chunk;
  const unsigned* own = is_crc(A) ? tab + (tid & (kCopies - 1)) : tab;
  const int n_tiles = (rows + kThreads - 1) / kThreads;
  // the first tile's first 16 bytes of this thread's row are loaded
  // before the tables, so that the two latencies overlap
  unsigned c0 = 0, c1 = 0, c2 = 0, c3 = 0;  // as words, kept scalar
  if (static_cast<int>(blockIdx.x) < n_tiles) {
    const uint4 f =
        first_chunk(row_in<T, PATH>(msg, stride, blockIdx.x),
                    static_cast<int>(blockIdx.x) * kThreads + tid < rows,
                    nbytes);
    c0 = f.x, c1 = f.y, c2 = f.z, c3 = f.w;
  }
  if (is_crc(A)) {  // entry tid, into its kCopies copies
    const unsigned e = __ldg(table + tid);
#pragma unroll
    for (int k = 0; k < kCopies; ++k) tab[tid * kCopies + k] = e;
  }
  if (is_lfsr(A) && whole) fill(tab, table, n_tab);
  __syncthreads();

  // the positions one load of the tables covers (an LFSR digest past
  // `chunk` positions reloads them for each chunk)
  const int span = whole ? nbytes : chunk;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r = tile * kThreads + tid;
    const bool live = r < rows;
    const Row<T, PATH> row = row_in<T, PATH>(msg, stride, tile);
    if (tile != static_cast<int>(blockIdx.x)) {
      const uint4 f = first_chunk(row, live, nbytes);
      c0 = f.x, c1 = f.y, c2 = f.z, c3 = f.w;
    }
    Digest<A> d(init, own);
    for (int k0 = 0; k0 == 0 || k0 < nbytes; k0 += span) {
      const int k1 = min(k0 + span, nbytes);
      if constexpr (is_lfsr(A)) {
        if (!whole) {
          __syncthreads();
          fill(tab, table + 32 * k0, 32 * (k1 - k0));
          __syncthreads();
          d.p = tab;
        }
      }
      if (k0 && live) {
        const uint4 f = row.chunk(k0, k1);
        c0 = f.x, c1 = f.y, c2 = f.z, c3 = f.w;
      }
      if (live && k1 > k0) digest(d, row, k0, k1, make_uint4(c0, c1, c2, c3));
      if (span == 0) break;
    }
    if (live) out[r] = d.result(mask);
  }
}

int sm_count() {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!sms[dev])
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 1;
}

template <int A, typename T, int PATH>
cudaError_t launch(const void* msg, int rows, int stride, int nbytes,
                   int init, int mask, const int* table, int chunk, int* out,
                   cudaStream_t stream) {
  auto kernel = mic_kernel<A, T, PATH>;
  const size_t smem = sizeof(unsigned) * table_words<A>(nbytes, chunk);
  // CTAs one SM holds at once, by this shared memory (cached per size)
  static size_t last_smem = ~static_cast<size_t>(0);
  static int per_sm = 1;
  if (smem != last_smem) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    per_sm = per_sm > 0 ? per_sm : 1;
    last_smem = smem;
  }
  const int n_tiles = (rows + kThreads - 1) / kThreads;
  const int grid = min(n_tiles, per_sm * sm_count());
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(msg), rows,
                                           stride, nbytes, init, mask, table,
                                           chunk, out);
  return cudaGetLastError();
}

template <int A>
cudaError_t dispatch(int is_i32, const void* msg, int rows, int stride,
                     int nbytes, int init, int mask, const int* table,
                     int chunk, int* out, cudaStream_t s) {
  const bool aligned = (reinterpret_cast<uintptr_t>(msg) & 15) == 0;
  if (is_i32)
    return aligned && stride % 4 == 0
               ? launch<A, int, VEC>(msg, rows, stride, nbytes, init, mask,
                                     table, chunk, out, s)
               : launch<A, int, SCALAR>(msg, rows, stride, nbytes, init,
                                        mask, table, chunk, out, s);
  return aligned && stride % 16 == 0
             ? launch<A, uint8_t, VEC>(msg, rows, stride, nbytes, init, mask,
                                       table, chunk, out, s)
             : launch<A, uint8_t, SCALAR>(msg, rows, stride, nbytes, init,
                                          mask, table, chunk, out, s);
}

}  // namespace

// msg [rows, stride] uint8 (is_i32 0) or int32 (1); the digest of each
// row's first nbytes into out int32 [rows]. table: the CRC byte table or
// the LFSR nibble tables (NULL for the folds); chunk: the LFSR positions a
// CTA's tables hold at once (a multiple of 16, at most 64). One launch;
// returns the CUDA error code.
extern "C" int rtl433_mic(int algo, int is_i32, const void* msg, int rows,
                          int stride, int nbytes, int init, int mask,
                          const void* table, int chunk, void* out,
                          void* stream) {
  const int* t = static_cast<const int*>(table);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 16 || chunk % 16 || 32 * chunk > 8 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (algo) {
#define MIC_CASE(A) \
  case A:           \
    return static_cast<int>(dispatch<A>(is_i32, msg, rows, stride, nbytes, \
                                        init, mask, t, chunk, o, s));
    MIC_CASE(CRC8)
    MIC_CASE(CRC8LE)
    MIC_CASE(CRC16)
    MIC_CASE(CRC16LSB)
    MIC_CASE(LFSR8)
    MIC_CASE(LFSR8_REVERSE)
    MIC_CASE(LFSR8_REFLECT)
    MIC_CASE(LFSR16)
    MIC_CASE(XOR_BYTES)
    MIC_CASE(ADD_BYTES)
    MIC_CASE(ADD_NIBBLES)
    MIC_CASE(PARITY_BYTES)
#undef MIC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
