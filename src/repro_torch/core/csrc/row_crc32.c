/* zlib's crc32 (the reflected polynomial 0xEDB88320, initial value 0) of
 * many payload rows in one call, for the offload plane's wave buffers
 * (core/wave_batch.py).
 *
 * On an x86-64 host with PCLMULQDQ the bulk of a row is folded 64 bytes at a
 * time by carry-less multiplies (four 128-bit lanes), reduced to 32 bits by
 * Barrett reduction: the method and constants of Intel's "Fast CRC
 * Computation for Generic Polynomials Using PCLMULQDQ Instruction" (2009),
 * as zlib's own SIMD variants use them. The fold covers the row's first
 * (length & ~15) bytes when the row has at least 64; a byte table finishes
 * the rest, and does all of a shorter row. The fold is compiled under a
 * target attribute and taken where crc_has_clmul() says the host has it;
 * core/row_crc.py uses this library only there (zlib elsewhere).
 *
 * Plain C interface, loaded with ctypes (core/row_crc.py). No threads.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__x86_64__) || defined(__i386__)
#define ROW_CRC_X86 1
#include <immintrin.h>
#endif

static uint32_t table[256];
static int has_clmul;       /* the host has PCLMULQDQ and SSE4.1 */

__attribute__((constructor)) static void row_crc_init(void) {
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int k = 0; k < 8; k++)
            c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        table[n] = c;
    }
#ifdef ROW_CRC_X86
    __builtin_cpu_init();
    has_clmul = __builtin_cpu_supports("pclmul") &&
                __builtin_cpu_supports("sse4.1");
#endif
}

/* The running (inverted) crc over len bytes, one byte at a time. */
static uint32_t crc_table(uint32_t c, const uint8_t *p, size_t len) {
    while (len--)
        c = table[(c ^ *p++) & 0xff] ^ (c >> 8);
    return c;
}

#ifdef ROW_CRC_X86
/* The running (inverted) crc over len bytes, len >= 64 and a multiple of 16. */
__attribute__((target("pclmul,sse4.1")))
static uint32_t crc_fold(uint32_t c, const uint8_t *p, size_t len) {
    /* x^(k) mod P, bit-reflected: k1 k2 fold 512 bits, k3 k4 128 bits,
     * k5 64 bits; then P and mu for the Barrett step */
    const __m128i k1k2 = _mm_set_epi64x(0x01c6e41596, 0x0154442bd4);
    const __m128i k3k4 = _mm_set_epi64x(0x00ccaa009e, 0x01751997d0);
    const __m128i k5k0 = _mm_set_epi64x(0, 0x0163cd6124);
    const __m128i poly = _mm_set_epi64x(0x01f7011641, 0x01db710641);
    const __m128i low32 = _mm_setr_epi32(~0, 0, ~0, 0);
    __m128i x1, x2, x3, x4, x5, x6, x7, x8;

    x1 = _mm_loadu_si128((const __m128i *)(p + 0x00));
    x2 = _mm_loadu_si128((const __m128i *)(p + 0x10));
    x3 = _mm_loadu_si128((const __m128i *)(p + 0x20));
    x4 = _mm_loadu_si128((const __m128i *)(p + 0x30));
    x1 = _mm_xor_si128(x1, _mm_cvtsi32_si128((int)c));
    p += 64;
    len -= 64;
    while (len >= 64) {             /* four lanes, 512 bits a step */
        x5 = _mm_clmulepi64_si128(x1, k1k2, 0x00);
        x6 = _mm_clmulepi64_si128(x2, k1k2, 0x00);
        x7 = _mm_clmulepi64_si128(x3, k1k2, 0x00);
        x8 = _mm_clmulepi64_si128(x4, k1k2, 0x00);
        x1 = _mm_clmulepi64_si128(x1, k1k2, 0x11);
        x2 = _mm_clmulepi64_si128(x2, k1k2, 0x11);
        x3 = _mm_clmulepi64_si128(x3, k1k2, 0x11);
        x4 = _mm_clmulepi64_si128(x4, k1k2, 0x11);
        x1 = _mm_xor_si128(_mm_xor_si128(x1, x5),
                           _mm_loadu_si128((const __m128i *)(p + 0x00)));
        x2 = _mm_xor_si128(_mm_xor_si128(x2, x6),
                           _mm_loadu_si128((const __m128i *)(p + 0x10)));
        x3 = _mm_xor_si128(_mm_xor_si128(x3, x7),
                           _mm_loadu_si128((const __m128i *)(p + 0x20)));
        x4 = _mm_xor_si128(_mm_xor_si128(x4, x8),
                           _mm_loadu_si128((const __m128i *)(p + 0x30)));
        p += 64;
        len -= 64;
    }
    /* the four lanes into one */
    x5 = _mm_clmulepi64_si128(x1, k3k4, 0x00);
    x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, x2), x5);
    x5 = _mm_clmulepi64_si128(x1, k3k4, 0x00);
    x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, x3), x5);
    x5 = _mm_clmulepi64_si128(x1, k3k4, 0x00);
    x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, x4), x5);
    while (len >= 16) {             /* one lane, 128 bits a step */
        x2 = _mm_loadu_si128((const __m128i *)p);
        x5 = _mm_clmulepi64_si128(x1, k3k4, 0x00);
        x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
        x1 = _mm_xor_si128(_mm_xor_si128(x1, x2), x5);
        p += 16;
        len -= 16;
    }
    /* 128 bits to 64 */
    x2 = _mm_clmulepi64_si128(x1, k3k4, 0x10);
    x1 = _mm_xor_si128(_mm_srli_si128(x1, 8), x2);
    x2 = _mm_srli_si128(x1, 4);
    x1 = _mm_and_si128(x1, low32);
    x1 = _mm_xor_si128(_mm_clmulepi64_si128(x1, k5k0, 0x00), x2);
    /* Barrett reduction to 32 bits */
    x2 = _mm_and_si128(x1, low32);
    x2 = _mm_clmulepi64_si128(x2, poly, 0x10);
    x2 = _mm_and_si128(x2, low32);
    x2 = _mm_clmulepi64_si128(x2, poly, 0x00);
    x1 = _mm_xor_si128(x1, x2);
    return (uint32_t)_mm_extract_epi32(x1, 1);
}
#endif

/* zlib.crc32 of len bytes at p. */
static uint32_t crc32_row(const uint8_t *p, size_t len) {
    uint32_t c = 0xFFFFFFFFu;
#ifdef ROW_CRC_X86
    if (has_clmul && len >= 64) {
        size_t bulk = len & ~(size_t)15;
        c = crc_fold(c, p, bulk);
        p += bulk;
        len -= bulk;
    }
#endif
    return ~crc_table(c, p, len);
}

/* out[i] = zlib.crc32 of row i of the n contiguous rows of row_bytes at
 * base. */
void crc_rows(const void *base, int64_t n, int64_t row_bytes, uint32_t *out) {
    const uint8_t *p = (const uint8_t *)base;
    for (int64_t i = 0; i < n; i++)
        out[i] = crc32_row(p + i * row_bytes, (size_t)row_bytes);
}

/* Row idx[i] of the store_rows rows of row_bytes at store (an index outside
 * [0, store_rows) clipped into it) copied to row i of out_rows; where
 * check[i], crc_out[i] = zlib.crc32 of that copy, read right after it is
 * written (crc_out[i] is left as it is elsewhere). */
void gather_crc_rows(const void *store, int64_t store_rows,
                     const int64_t *idx, int64_t n, int64_t row_bytes,
                     void *out_rows, const uint8_t *check, uint32_t *crc_out) {
    const uint8_t *src = (const uint8_t *)store;
    uint8_t *dst = (uint8_t *)out_rows;
    for (int64_t i = 0; i < n; i++) {
        int64_t j = idx[i] < 0 ? 0
                  : idx[i] >= store_rows ? store_rows - 1 : idx[i];
        uint8_t *row = dst + i * row_bytes;
        memcpy(row, src + j * row_bytes, (size_t)row_bytes);
        if (check[i])
            crc_out[i] = crc32_row(row, (size_t)row_bytes);
    }
}

/* Whether the host takes the fold (else every byte goes through the
 * table). */
int crc_has_clmul(void) {
    return has_clmul;
}
