// CRC32-Castagnoli on the host, matching Go hash/crc32 Update semantics
// (the needle checksum of weed/storage/needle/crc.go). Host code, not a
// device kernel: the port's own copy of the JAX package's native
// sw_crc32c_update, which the fastlane engine links against too. Uses the
// SSE4.2 crc32 instruction where the compiler targets it (-march=native on
// x86-64), else slice-by-8 tables.
#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

#if !defined(__SSE4_2__)
uint32_t tables[8][256];

void init_tables() {
    static const bool built = [] {
        const uint32_t poly = 0x82F63B78u;
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
            tables[0][i] = c;
        }
        for (int t = 1; t < 8; t++)
            for (uint32_t i = 0; i < 256; i++)
                tables[t][i] = tables[t - 1][i] >> 8 ^ tables[0][tables[t - 1][i] & 0xFF];
        return true;
    }();
    (void)built;
}
#endif

}  // namespace

extern "C" uint32_t sw_crc32c_update(uint32_t crc, const unsigned char* data, size_t n) {
    uint32_t c = ~crc;
#if defined(__SSE4_2__)
    while (n >= 8) {
        uint64_t v;
        std::memcpy(&v, data, 8);
        c = (uint32_t)_mm_crc32_u64(c, v);
        data += 8;
        n -= 8;
    }
    while (n--) c = _mm_crc32_u8(c, *data++);
#else
    init_tables();
    while (n >= 8) {
        uint64_t v;
        std::memcpy(&v, data, 8);
        v ^= c;
        c = tables[7][v & 0xFF] ^ tables[6][(v >> 8) & 0xFF] ^
            tables[5][(v >> 16) & 0xFF] ^ tables[4][(v >> 24) & 0xFF] ^
            tables[3][(v >> 32) & 0xFF] ^ tables[2][(v >> 40) & 0xFF] ^
            tables[1][(v >> 48) & 0xFF] ^ tables[0][(v >> 56) & 0xFF];
        data += 8;
        n -= 8;
    }
    while (n--) c = tables[0][(c ^ *data++) & 0xFF] ^ (c >> 8);
#endif
    return ~c;
}

// CRC32C of n sub-ranges of one contiguous buffer (the CDC chunks of an
// upload): out[i] = CRC of base[offs[i], offs[i] + lens[i]). The port's
// counterpart of the JAX package's native sw_crc32c_batch_spans, equal in
// output; spans are hashed one after another.
extern "C" void sw_crc32c_batch_spans(const unsigned char* base, const size_t* offs,
                                      const size_t* lens, size_t n, uint32_t* out) {
    for (size_t i = 0; i < n; i++) out[i] = sw_crc32c_update(0, base + offs[i], lens[i]);
}
