// SW128: fast 128-bit content-identity hash for the CDC dedup index.
// Host code, not a device kernel: the port's own copy of the JAX package's
// native sw_fast128 / sw_fast128_spans, equal in behaviour byte for byte
// (dedup keys written by either package match the other's).
//
// The dedup key only needs collision resistance against accidental (and
// casually adversarial) duplicates — the same bar xxhash/spookyhash meet
// for ZFS-class dedup — while running far faster than MD5 (which is both
// slow AND cryptographically broken for collisions, so it bought nothing
// extra as a key). MD5 stays the chunk-ETag format; this hash exists only
// inside index keys ("x<hex32>-<len>"), never on the wire.
//
// STABILITY CONTRACT: keys persist in the filer store across restarts and
// upgrades, so this function must never change behavior. Golden vectors
// are pinned in tests/test_hash_kernels.py and tests/test_torch_dedup.py;
// any change that breaks them must introduce a new key prefix instead.
//
// Construction (wyhash/umash-style, 8 independent mul-mix lanes):
//   per 64-byte block, lane i (i = 0..7):
//     acc[i] = rot64((acc[i] ^ w[i]) * M[i], 29) + w[(i+1) & 7]
//   The multiply diffuses within a lane; the neighbor-add propagates
//   across lanes; 8 independent chains keep the multiplier pipeline full.
//   Tail blocks are zero-padded; total length is folded into finalization
//   (so padding cannot collide with explicit zeros).
//   Finalize: pairwise 64x64->128 "mum" folds of the accumulators with
//   fresh constants, then two moremur rounds per output half.

#include <stdint.h>
#include <string.h>

#include <cstddef>

namespace {

inline uint64_t rot64(uint64_t v, int r) {
    return (v << r) | (v >> (64 - r));
}

inline uint64_t mum(uint64_t a, uint64_t b) {
    __uint128_t m = (__uint128_t)a * b;
    return (uint64_t)m ^ (uint64_t)(m >> 64);
}

inline uint64_t moremur(uint64_t x) {
    x ^= x >> 27;
    x *= 0x3C79AC492BA7B653ULL;
    x ^= x >> 33;
    x *= 0x1C69B3F74AC4AE35ULL;
    x ^= x >> 27;
    return x;
}

// odd 64-bit constants (from splitmix64 of 1..18)
constexpr uint64_t M[8] = {
    0x910A2DEC89025CC1ULL, 0xBEAA4A2FB23C9F93ULL,
    0x6BB4C5F9DF6A1E8BULL, 0x2B8347B4A49D1C07ULL,
    0xD1B54A32D192ED03ULL, 0xAEF17502108EF2D9ULL,
    0x994846F1D5CF9E8DULL, 0x70E15C9D7A53F8EFULL,
};
constexpr uint64_t F[10] = {
    0x9E3779B97F4A7C15ULL, 0xC2B2AE3D27D4EB4FULL,
    0x165667B19E3779F9ULL, 0x27D4EB2F165667C5ULL,
    0x85EBCA77C2B2AE63ULL, 0xFF51AFD7ED558CCDULL,
    0xC4CEB9FE1A85EC53ULL, 0x2545F4914F6CDD1DULL,
    0x9FB21C651E98DF25ULL, 0xD6E8FEB86659FD93ULL,
};

// Hand-unrolled lanes in named locals: gcc's AVX-512 auto-vectorization
// of the array-indexed form uses VPMULLQ (3 uops, high latency) and
// measures ~2x SLOWER than the scalar 64-bit multiplier pipeline this
// loop is designed around; explicit registers sidestep both the
// vectorizer and the acc[]/nxt[] spills.
// seed0/seed1: per-store random secret (filer/dedup.py keeps it under the
// index root). An unseeded mul-mix hash is offline-collidable — with the
// seed folded into every accumulator, an attacker cannot construct the
// colliding pair that would make a victim's upload dedup to attacker
// bytes. seed0 == seed1 == 0 reproduces the unseeded goldens.
void sw128_one(const unsigned char* p, size_t len, uint64_t seed0,
               uint64_t seed1, unsigned char out[16]) {
    uint64_t a0 = F[0] ^ (M[0] * 1) ^ seed0, a1 = F[1] ^ (M[1] * 2) ^ seed1,
             a2 = F[2] ^ (M[2] * 3) ^ rot64(seed0, 17),
             a3 = F[3] ^ (M[3] * 4) ^ rot64(seed1, 31),
             a4 = F[4] ^ (M[4] * 5) ^ rot64(seed0, 43),
             a5 = F[5] ^ (M[5] * 6) ^ rot64(seed1, 11),
             a6 = F[6] ^ (M[6] * 7) ^ (seed0 + seed1),
             a7 = F[7] ^ (M[7] * 8) ^ (seed0 ^ rot64(seed1, 53));
    size_t full = len / 64;
    uint64_t w[8];
    for (size_t b = 0; b < full; b++) {
        memcpy(w, p + b * 64, 64);  // little-endian load (x86)
        uint64_t n0 = rot64((a0 ^ w[0]) * M[0], 29) + w[1];
        uint64_t n1 = rot64((a1 ^ w[1]) * M[1], 29) + w[2];
        uint64_t n2 = rot64((a2 ^ w[2]) * M[2], 29) + w[3];
        uint64_t n3 = rot64((a3 ^ w[3]) * M[3], 29) + w[4];
        uint64_t n4 = rot64((a4 ^ w[4]) * M[4], 29) + w[5];
        uint64_t n5 = rot64((a5 ^ w[5]) * M[5], 29) + w[6];
        uint64_t n6 = rot64((a6 ^ w[6]) * M[6], 29) + w[7];
        uint64_t n7 = rot64((a7 ^ w[7]) * M[7], 29) + w[0];
        a0 = n0; a1 = n1; a2 = n2; a3 = n3;
        a4 = n4; a5 = n5; a6 = n6; a7 = n7;
    }
    size_t rem = len - full * 64;
    if (rem) {
        memset(w, 0, sizeof w);
        memcpy(w, p + full * 64, rem);
        uint64_t n0 = rot64((a0 ^ w[0]) * M[0], 29) + w[1];
        uint64_t n1 = rot64((a1 ^ w[1]) * M[1], 29) + w[2];
        uint64_t n2 = rot64((a2 ^ w[2]) * M[2], 29) + w[3];
        uint64_t n3 = rot64((a3 ^ w[3]) * M[3], 29) + w[4];
        uint64_t n4 = rot64((a4 ^ w[4]) * M[4], 29) + w[5];
        uint64_t n5 = rot64((a5 ^ w[5]) * M[5], 29) + w[6];
        uint64_t n6 = rot64((a6 ^ w[6]) * M[6], 29) + w[7];
        uint64_t n7 = rot64((a7 ^ w[7]) * M[7], 29) + w[0];
        a0 = n0; a1 = n1; a2 = n2; a3 = n3;
        a4 = n4; a5 = n5; a6 = n6; a7 = n7;
    }
    uint64_t h1 = mum(a0 ^ F[0], a1 ^ F[1]) ^ mum(a2 ^ F[2], a3 ^ F[3]) ^
                  ((uint64_t)len * F[8]);
    uint64_t h2 = mum(a4 ^ F[4], a5 ^ F[5]) ^ mum(a6 ^ F[6], a7 ^ F[7]) ^
                  (rot64((uint64_t)len, 32) * F[9]);
    uint64_t ha = moremur(h1 ^ rot64(h2, 31));
    uint64_t hb = moremur(h2 ^ rot64(ha, 29));
    memcpy(out, &ha, 8);
    memcpy(out + 8, &hb, 8);
}

}  // namespace

extern "C" {

// seed: 16 bytes (two little-endian u64) or null for the unseeded form
void sw_fast128(const unsigned char* data, size_t len,
                const unsigned char* seed, unsigned char out[16]) {
    uint64_t s0 = 0, s1 = 0;
    if (seed != nullptr) {
        memcpy(&s0, seed, 8);
        memcpy(&s1, seed + 8, 8);
    }
    sw128_one(data, len, s0, s1, out);
}

// spans of one contiguous buffer: cuts are exclusive ends ([prev, cut))
void sw_fast128_spans(const unsigned char* base, const size_t* cuts,
                      size_t n, const unsigned char* seed,
                      unsigned char* out) {
    uint64_t s0 = 0, s1 = 0;
    if (seed != nullptr) {
        memcpy(&s0, seed, 8);
        memcpy(&s1, seed + 8, 8);
    }
    size_t prev = 0;
    for (size_t i = 0; i < n; i++) {
        sw128_one(base + prev, cuts[i] - prev, s0, s1, out + i * 16);
        prev = cuts[i];
    }
}

}  // extern "C"
