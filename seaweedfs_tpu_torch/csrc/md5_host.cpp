// MD5 of sub-ranges of one host buffer: the dedup write path's ETags of
// index misses (HashService.md5_spans / hash_spans). Host code, not a
// device kernel: the port's own copy of the JAX package's native
// sw_md5_batch_var / sw_md5_batch_spans. Span batches are host-resident and
// latency-bound, the worst case for a device round trip, so they stay on
// the host as in the JAX package. 16 spans advance in lockstep, one per
// 32-bit AVX-512 lane, where the CPU has AVX-512 (verified against the
// scalar core at first use); the scalar core runs the rest.
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <algorithm>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#define SW_MD5_AVX512 1
#endif

namespace {

struct MD5Ctx {
    uint32_t a, b, c, d;
};

const uint32_t K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};

const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                   5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20,
                   4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                   6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};

inline uint32_t rotl(uint32_t x, int s) { return (x << s) | (x >> (32 - s)); }

void md5_block(MD5Ctx& ctx, const uint8_t* p) {
    uint32_t m[16];
    std::memcpy(m, p, 64);
    uint32_t a = ctx.a, b = ctx.b, c = ctx.c, d = ctx.d;
    for (int i = 0; i < 64; i++) {
        uint32_t f;
        int g;
        if (i < 16) { f = (b & c) | (~b & d); g = i; }
        else if (i < 32) { f = (d & b) | (~d & c); g = (5 * i + 1) & 15; }
        else if (i < 48) { f = b ^ c ^ d; g = (3 * i + 5) & 15; }
        else { f = c ^ (b | ~d); g = (7 * i) & 15; }
        uint32_t tmp = d;
        d = c;
        c = b;
        b = b + rotl(a + f + K[i] + m[g], S[i]);
        a = tmp;
    }
    ctx.a += a; ctx.b += b; ctx.c += c; ctx.d += d;
}

void md5_one(const uint8_t* data, size_t len, uint8_t* out) {
    MD5Ctx ctx{0x67452301, 0xefcdab89, 0x98badcfe, 0x10325476};
    size_t full = len / 64;
    for (size_t i = 0; i < full; i++) md5_block(ctx, data + i * 64);
    uint8_t tail[128] = {0};
    size_t rem = len - full * 64;
    std::memcpy(tail, data + full * 64, rem);
    tail[rem] = 0x80;
    size_t tail_len = (rem + 9 <= 64) ? 64 : 128;
    uint64_t bits = (uint64_t)len * 8;
    std::memcpy(tail + tail_len - 8, &bits, 8);
    md5_block(ctx, tail);
    if (tail_len == 128) md5_block(ctx, tail + 64);
    std::memcpy(out, &ctx.a, 4);
    std::memcpy(out + 4, &ctx.b, 4);
    std::memcpy(out + 8, &ctx.c, 4);
    std::memcpy(out + 12, &ctx.d, 4);
}

#ifdef SW_MD5_AVX512
inline __m512i rotl16(__m512i x, int s) {
    return _mm512_or_si512(_mm512_slli_epi32(x, s), _mm512_srli_epi32(x, 32 - s));
}

// Variable-length lockstep: 16 blobs of DIFFERENT lengths advance together,
// each lane staging its own next 64B block into a contiguous 16x64 buffer
// (L1-resident, so the per-round vpgatherdd hits cache); lanes whose blob
// ran out of full blocks retire via merge-masked state adds. Callers get
// the most out of it by length-sorting the batch so groups retire together
// (CDC dedup chunks have content-defined, i.e. unique, lengths).
void md5_16lane_var(const uint8_t* const ptrs[16], const size_t lens[16],
                    uint8_t* out) {
    alignas(64) uint8_t stage[16 * 64];
    const __m512i lane_off = _mm512_slli_epi32(
        _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
        6);  // l*64: lane l's block lives at stage + l*64
    __m512i a = _mm512_set1_epi32((int)0x67452301);
    __m512i b = _mm512_set1_epi32((int)0xefcdab89);
    __m512i c = _mm512_set1_epi32((int)0x98badcfe);
    __m512i d = _mm512_set1_epi32((int)0x10325476);
    const __m512i ones = _mm512_set1_epi32(-1);
    size_t full[16];
    size_t maxfull = 0;
    for (int l = 0; l < 16; l++) {
        full[l] = lens[l] / 64;
        if (full[l] > maxfull) maxfull = full[l];
    }
    for (size_t blk = 0; blk < maxfull; blk++) {
        __mmask16 active = 0;
        for (int l = 0; l < 16; l++)
            if (blk < full[l]) {
                std::memcpy(stage + l * 64, ptrs[l] + blk * 64, 64);
                active |= (__mmask16)(1u << l);
            }
        __m512i m[16];
        for (int g = 0; g < 16; g++)
            m[g] = _mm512_i32gather_epi32(lane_off, (const int*)(stage + g * 4), 1);
        __m512i aa = a, bb = b, cc = c, dd = d;
        for (int i = 0; i < 64; i++) {
            __m512i f;
            int g;
            if (i < 16) {
                f = _mm512_or_si512(_mm512_and_si512(bb, cc),
                                    _mm512_andnot_si512(bb, dd));
                g = i;
            } else if (i < 32) {
                f = _mm512_or_si512(_mm512_and_si512(dd, bb),
                                    _mm512_andnot_si512(dd, cc));
                g = (5 * i + 1) & 15;
            } else if (i < 48) {
                f = _mm512_xor_si512(_mm512_xor_si512(bb, cc), dd);
                g = (3 * i + 5) & 15;
            } else {
                f = _mm512_xor_si512(cc,
                                     _mm512_or_si512(bb, _mm512_xor_si512(dd, ones)));
                g = (7 * i) & 15;
            }
            __m512i sum = _mm512_add_epi32(
                _mm512_add_epi32(aa, f),
                _mm512_add_epi32(_mm512_set1_epi32((int)K[i]), m[g]));
            __m512i tmp = dd;
            dd = cc;
            cc = bb;
            bb = _mm512_add_epi32(bb, rotl16(sum, S[i]));
            aa = tmp;
        }
        a = _mm512_mask_add_epi32(a, active, a, aa);
        b = _mm512_mask_add_epi32(b, active, b, bb);
        c = _mm512_mask_add_epi32(c, active, c, cc);
        d = _mm512_mask_add_epi32(d, active, d, dd);
    }
    uint32_t av[16], bv[16], cv[16], dv[16];
    _mm512_storeu_si512(av, a);
    _mm512_storeu_si512(bv, b);
    _mm512_storeu_si512(cv, c);
    _mm512_storeu_si512(dv, d);
    uint8_t tail[128];
    for (int l = 0; l < 16; l++) {
        MD5Ctx ctx{av[l], bv[l], cv[l], dv[l]};
        size_t rem = lens[l] - full[l] * 64;
        size_t tail_len = (rem + 9 <= 64) ? 64 : 128;
        std::memset(tail, 0, sizeof(tail));
        std::memcpy(tail, ptrs[l] + full[l] * 64, rem);
        tail[rem] = 0x80;
        uint64_t bits = (uint64_t)lens[l] * 8;
        std::memcpy(tail + tail_len - 8, &bits, 8);
        md5_block(ctx, tail);
        if (tail_len == 128) md5_block(ctx, tail + 64);
        uint8_t* o = out + (size_t)l * 16;
        std::memcpy(o, &ctx.a, 4);
        std::memcpy(o + 4, &ctx.b, 4);
        std::memcpy(o + 8, &ctx.c, 4);
        std::memcpy(o + 12, &ctx.d, 4);
    }
}

bool md5_avx512_ok() {
    static int ok = -1;
    if (ok >= 0) return ok;
    if (!__builtin_cpu_supports("avx512f")) { ok = 0; return false; }
    // self-test 16 lanes of different lengths vs scalar
    uint8_t blobs[16 * 200], want[16 * 16], got[16 * 16];
    const uint8_t* ptrs[16];
    size_t lens[16];
    for (int i = 0; i < 16 * 200; i++) blobs[i] = (uint8_t)(i * 31 + 7);
    for (int l = 0; l < 16; l++) {
        ptrs[l] = blobs + l * 200;
        lens[l] = 200 - 9 * l;
        md5_one(ptrs[l], lens[l], want + l * 16);
    }
    md5_16lane_var(ptrs, lens, got);
    ok = std::memcmp(want, got, sizeof(want)) == 0;
    return ok;
}
#endif

}  // namespace

// Variable-length batch: ptrs/lens describe n independent blobs anywhere in
// memory. Caller should length-sort for best lane utilization; groups of 16
// run the lockstep kernel, the remainder runs scalar.
extern "C" void sw_md5_batch_var(const unsigned char* const* ptrs,
                                 const size_t* lens, size_t n,
                                 unsigned char* out) {
    size_t i = 0;
#ifdef SW_MD5_AVX512
    if (n >= 16 && md5_avx512_ok()) {
        for (; i + 16 <= n; i += 16)
            md5_16lane_var(ptrs + i, lens + i, out + i * 16);
    }
#endif
    for (; i < n; i++) md5_one(ptrs[i], lens[i], out + i * 16);
}

// Span batch: n sub-ranges of one contiguous buffer (CDC chunks of an
// upload) — zero per-piece copies on the Python side. Length-sorts
// internally so lockstep lanes retire together, restoring caller order.
extern "C" void sw_md5_batch_spans(const unsigned char* base,
                                   const size_t* offs, const size_t* lens,
                                   size_t n, unsigned char* out) {
    if (n == 0) return;
    std::vector<size_t> order(n);
    for (size_t i = 0; i < n; i++) order[i] = i;
    std::sort(order.begin(), order.end(),
              [&](size_t a, size_t b) { return lens[a] > lens[b]; });
    std::vector<const unsigned char*> ptrs(n);
    std::vector<size_t> slens(n);
    for (size_t i = 0; i < n; i++) {
        ptrs[i] = base + offs[order[i]];
        slens[i] = lens[order[i]];
    }
    std::vector<unsigned char> tmp(n * 16);
    sw_md5_batch_var(ptrs.data(), slens.data(), n, tmp.data());
    for (size_t i = 0; i < n; i++)
        std::memcpy(out + order[i] * 16, tmp.data() + i * 16, 16);
}
