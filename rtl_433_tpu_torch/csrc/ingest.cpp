// Host-side ingest runtime for rtl_433_tpu: sample-format conversions and
// a single-producer/single-consumer block ring buffer feeding the device
// pipeline. The TPU-native equivalent of the reference's acquisition path
// (ref src/sdr.c:1718 acquire_thread, src/rtl_433.c:1812-1834 format
// conversions) — the compute hot path is JAX/Pallas; this is the native
// I/O layer in front of it.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Sample-format conversions (ref src/rtl_433.c:1812-1834)

// CS8 -> CU8: bias by 128 (ref :1829-1833)
void cs8_to_cu8(const int8_t *src, uint8_t *dst, size_t n)
{
    for (size_t i = 0; i < n; ++i)
        dst[i] = (uint8_t)(src[i] + 128);
}

// CF32 -> CS16: clamp to [-1,1] and scale to Q0.15 (ref :1812-1824)
void cf32_to_cs16(const float *src, int16_t *dst, size_t n)
{
    for (size_t i = 0; i < n; ++i) {
        int s = (int)(src[i] * 32767.0f);
        if (s < -32767) s = -32767;
        else if (s > 32767) s = 32767;
        dst[i] = (int16_t)s;
    }
}

// CU8 -> CS16: widen with bias removal (scale 127 -> Q0.15-ish by <<8)
void cu8_to_cs16(const uint8_t *src, int16_t *dst, size_t n)
{
    for (size_t i = 0; i < n; ++i)
        dst[i] = (int16_t)(((int)src[i] - 128) << 8);
}

// Envelope (power) of CU8 IQ: y = (127-I)^2 + (127-Q)^2, uint16 full scale
// 16384 (ref src/baseband.c:25-45) — reference CPU implementation used for
// differential tests against the Pallas kernel and as a host fallback.
void envelope_cu8(const uint8_t *iq, uint16_t *y, size_t n_samples)
{
    for (size_t i = 0; i < n_samples; ++i) {
        int di = 127 - (int)iq[2 * i];
        int dq = 127 - (int)iq[2 * i + 1];
        y[i] = (uint16_t)(di * di + dq * dq);
    }
}

// Magnitude estimate of CU8 IQ: y = 122*max(|I|,|Q|) + 51*min(|I|,|Q|)
// (ref src/baseband.c:65-80)
void magnitude_est_cu8(const uint8_t *iq, uint16_t *y, size_t n_samples)
{
    for (size_t i = 0; i < n_samples; ++i) {
        int ai = (int)iq[2 * i] - 128;
        int aq = (int)iq[2 * i + 1] - 128;
        if (ai < 0) ai = -ai;
        if (aq < 0) aq = -aq;
        int mx = ai > aq ? ai : aq;
        int mn = ai > aq ? aq : ai;
        y[i] = (uint16_t)(122 * mx + 51 * mn);
    }
}

// ---------------------------------------------------------------------------
// SPSC block ring buffer: fixed-size byte blocks, lock-free, one acquisition
// thread pushing, one consumer popping (ref include/sdr.h:17-18: 15 async
// buffers of 256 KiB).

struct BlockRing {
    uint8_t *data;
    size_t block_size;
    size_t n_blocks;
    std::atomic<uint64_t> head; // next write
    std::atomic<uint64_t> tail; // next read
    std::atomic<uint64_t> dropped;
};

BlockRing *ring_create(size_t block_size, size_t n_blocks)
{
    BlockRing *r = new BlockRing();
    r->data = (uint8_t *)malloc(block_size * n_blocks);
    if (!r->data) {
        delete r;
        return nullptr;
    }
    r->block_size = block_size;
    r->n_blocks = n_blocks;
    r->head.store(0);
    r->tail.store(0);
    r->dropped.store(0);
    return r;
}

void ring_free(BlockRing *r)
{
    if (r) {
        free(r->data);
        delete r;
    }
}

// Push one block; drops (and counts) when full. Returns 1 on success.
int ring_push(BlockRing *r, const uint8_t *block)
{
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    if (head - tail >= r->n_blocks) {
        r->dropped.fetch_add(1, std::memory_order_relaxed);
        return 0;
    }
    memcpy(r->data + (head % r->n_blocks) * r->block_size, block,
           r->block_size);
    r->head.store(head + 1, std::memory_order_release);
    return 1;
}

// Pop one block into out. Returns 1 on success, 0 when empty.
int ring_pop(BlockRing *r, uint8_t *out)
{
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    if (tail == head)
        return 0;
    memcpy(out, r->data + (tail % r->n_blocks) * r->block_size,
           r->block_size);
    r->tail.store(tail + 1, std::memory_order_release);
    return 1;
}

uint64_t ring_fill(BlockRing *r)
{
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_acquire);
}

uint64_t ring_dropped(BlockRing *r)
{
    return r->dropped.load(std::memory_order_relaxed);
}

} // extern "C"
