// Batched MIC digests: the twelve functions of the JAX package's
// ops/mic.py (crc8 :32 ... parity_bytes :164) over [rows, stride] byte rows.
//
// One thread per row; the algorithm is a template parameter (enum Algo,
// in the order of ops/_cuda.py MIC_ALGOS) and the input is uint8 or int32
// (read & 0xFF). Each digest follows its host twin in bits/util.py step
// for step: the CRCs shift bit by bit with the polynomial and the masks
// of the JAX code; the Galois LFSR digests XOR, for every set message bit,
// the key that the host-precomputed schedule (ops/mic.py lfsr_key_layout,
// MSB-first bit order) gives it; the reductions fold the bytes.
//
// Bound: the message bytes read once and one int32 written per row, or,
// for the CRCs, their ~4 int32 operations per message bit; a row of a
// dozen bytes is a few hundred operations in one thread, so a launch of
// 65536 rows is a few microseconds either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Algo {
  CRC8, CRC8LE, CRC16, CRC16LSB, LFSR8, LFSR8_REVERSE, LFSR8_REFLECT,
  LFSR16, XOR_BYTES, ADD_BYTES, ADD_NIBBLES, PARITY_BYTES, N_ALGOS
};

template <typename T>
__device__ __forceinline__ int byte_at(const T* row, int k) {
  return (int)row[k] & 0xFF;
}

// p1, p2: (poly, init) for the CRCs (crc8le: both already reverse8'd on
// the host), the key width mask for the LFSR digests
template <int A, typename T>
__global__ void mic_kernel(const T* __restrict__ msg, int rows, int stride,
                           int nbytes, int p1, int p2,
                           const int* __restrict__ keys, int* out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* row = msg + (size_t)r * stride;
  int v = 0;
  if (A == CRC8) {
    v = p2 & 0xFF;
    for (int k = 0; k < nbytes; ++k) {
      v ^= byte_at(row, k);
      for (int i = 0; i < 8; ++i)
        v = (v & 0x80) ? ((v << 1) ^ p1) & 0xFF : (v << 1) & 0xFF;
    }
  } else if (A == CRC8LE) {
    v = p2;
    for (int k = 0; k < nbytes; ++k) {
      v ^= byte_at(row, k);
      for (int i = 0; i < 8; ++i) v = (v & 1) ? (v >> 1) ^ p1 : v >> 1;
    }
    v &= 0xFF;
  } else if (A == CRC16) {
    v = p2 & 0xFFFF;
    for (int k = 0; k < nbytes; ++k) {
      v = (v ^ (byte_at(row, k) << 8)) & 0xFFFF;
      for (int i = 0; i < 8; ++i)
        v = (v & 0x8000) ? ((v << 1) ^ p1) & 0xFFFF : (v << 1) & 0xFFFF;
    }
  } else if (A == CRC16LSB) {
    v = p2 & 0xFFFF;
    for (int k = 0; k < nbytes; ++k) {
      v ^= byte_at(row, k);
      for (int i = 0; i < 8; ++i)
        v = (v & 1) ? ((v >> 1) ^ p1) & 0xFFFF : v >> 1;
    }
  } else if (A == LFSR8 || A == LFSR8_REVERSE || A == LFSR8_REFLECT ||
             A == LFSR16) {
    for (int k = 0; k < nbytes; ++k) {
      const int b = byte_at(row, k);
      for (int i = 0; i < 8; ++i)
        if ((b >> (7 - i)) & 1) v ^= keys[8 * k + i];
    }
    v &= p1;
  } else if (A == XOR_BYTES || A == PARITY_BYTES) {
    for (int k = 0; k < nbytes; ++k) v ^= byte_at(row, k);
    if (A == PARITY_BYTES) {
      v ^= v >> 4;
      v = (0x6996 >> (v & 0xF)) & 1;
    }
  } else if (A == ADD_BYTES) {
    for (int k = 0; k < nbytes; ++k) v += byte_at(row, k);
  } else if (A == ADD_NIBBLES) {
    for (int k = 0; k < nbytes; ++k) {
      const int b = byte_at(row, k);
      v += (b >> 4) + (b & 0x0F);
    }
  }
  out[r] = v;
}

template <int A>
cudaError_t launch(int is_i32, const void* msg, int rows, int stride,
                   int nbytes, int p1, int p2, const int* keys, int* out,
                   cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (rows + threads - 1) / threads;
  if (is_i32)
    mic_kernel<A, int><<<blocks, threads, 0, stream>>>(
        (const int*)msg, rows, stride, nbytes, p1, p2, keys, out);
  else
    mic_kernel<A, uint8_t><<<blocks, threads, 0, stream>>>(
        (const uint8_t*)msg, rows, stride, nbytes, p1, p2, keys, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtl433_mic(int algo, int is_i32, const void* msg, int rows,
                          int stride, int nbytes, int p1, int p2,
                          const void* keys, void* out, void* stream) {
  const int* k = (const int*)keys;
  int* o = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (algo) {
#define MIC_CASE(A) \
  case A:           \
    return (int)launch<A>(is_i32, msg, rows, stride, nbytes, p1, p2, k, o, s);
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
      return (int)cudaErrorInvalidValue;
  }
}
