// MD5 (RFC 1321) of N equal-length blobs for Hopper: out[i] = md5(x[i, 0:L]),
// byte-identical to hashlib.md5.
//
// Replaces the JAX device function seaweedfs_tpu/ops/md5_kernel.py::
// _compiled_batch, which advances N states in lockstep on the VPU's lanes
// (64 rounds per block under lax.scan) after concatenating a padded copy of
// the blobs on the device.
//
// Bound: the dependent chain. MD5 is sequential within a blob: each of a
// block's 64 rounds needs the one before, and on sm_90 a round is 4
// dependent integer instructions (LOP3 for the boolean function, IADD3 and
// IMAD.IADD for a + f + K + m, LEA.HI for the rotate and the + b together).
// At a few cycles each, one 64-byte block takes about a thousand cycles
// whatever the card does, so no design beats blocks x 64 x 4 dependent
// issues. The bytes (N*L over 3.35 TB/s) and the integer operations (about
// 265 a block at 64 a clock per SM) bound it only when far more blobs than
// the card has schedulers are hashed at once.
//
// What the design does about it: one thread per blob (the only parallelism
// there is) and nothing else on the chain. Loading a block's 16 words at
// the top of its iteration would make every block wait one memory round
// trip (about 730 cycles) before its first round. So each warp owns 32 blobs and a ring of kStages blocks per blob in shared memory,
// filled by cp.async: while a block's rounds run, the next kStages - 1
// blocks of all 32 blobs are in flight. The warp fetches cooperatively:
// lane l copies 16-byte piece l % 4 of blob l / 4 + 8q (q = 0..3), so each
// copy instruction moves 8 whole 64-byte blocks. A 16-byte copy needs a
// 16-byte aligned destination, so the layout is not padded but swizzled:
// piece p of blob b sits in slot 4b + (p ^ ((b >> 1) & 3)), and the 8 lanes
// of each quarter-warp that read piece p of their blobs with one 16-byte
// load hit 8 different groups of 4 banks. Blocks are one warp each, so a
// batch spreads over ceil(N / 32) SMs' schedulers (the chunked path's 256
// blobs run on 8 SMs).
//
// The rounds are unrolled, K sits in __constant__ memory (a warp reads the
// same one, so it broadcasts), the rotates are __funnelshift_l. The last
// one or two blocks, with the 0x80 byte, the zeros and the 64-bit bit
// length, are built in registers; no padded copy of the blobs is made.
// Rows that are not 16-byte aligned (a view at an odd offset) take
// md5_batch_bytes_kernel, which reads each block byte by byte in place.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlobs = 32;   // blobs per warp, one per lane; blocks are one warp
constexpr int kStages = 4;   // the block being hashed and three ahead, per blob
constexpr int kPieces = 4;   // 16-byte pieces of a 64-byte block

__constant__ uint32_t kK[64] = {
    0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu,
    0xf57c0fafu, 0x4787c62au, 0xa8304613u, 0xfd469501u,
    0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,
    0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u,
    0xf61e2562u, 0xc040b340u, 0x265e5a51u, 0xe9b6c7aau,
    0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,
    0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu,
    0xa9e3e905u, 0xfcefa3f8u, 0x676f02d9u, 0x8d2a4c8au,
    0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,
    0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u,
    0x289b7ec6u, 0xeaa127fau, 0xd4ef3085u, 0x04881d05u,
    0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,
    0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u,
    0x655b59c3u, 0x8f0ccc92u, 0xffeff47du, 0x85845dd1u,
    0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
    0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u,
};

// per-round rotate amounts: {7,12,17,22}, {5,9,14,20}, {4,11,16,23}, {6,10,15,21}
__host__ __device__ constexpr int shift_of(int i) {
    return i < 16   ? (i % 4 == 0 ? 7 : i % 4 == 1 ? 12 : i % 4 == 2 ? 17 : 22)
           : i < 32 ? (i % 4 == 0 ? 5 : i % 4 == 1 ? 9 : i % 4 == 2 ? 14 : 20)
           : i < 48 ? (i % 4 == 0 ? 4 : i % 4 == 1 ? 11 : i % 4 == 2 ? 16 : 23)
                    : (i % 4 == 0 ? 6 : i % 4 == 1 ? 10 : i % 4 == 2 ? 15 : 21);
}

__device__ __forceinline__ void md5_block(uint32_t s[4], const uint32_t m[16]) {
    uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        uint32_t f;
        int g;
        if (i < 16) {
            f = (b & c) | (~b & d);
            g = i;
        } else if (i < 32) {
            f = (d & b) | (~d & c);
            g = (5 * i + 1) & 15;
        } else if (i < 48) {
            f = b ^ c ^ d;
            g = (3 * i + 5) & 15;
        } else {
            f = c ^ (b | ~d);
            g = (7 * i) & 15;
        }
        const uint32_t tmp = d;
        d = c;
        c = b;
        const uint32_t v = a + f + kK[i] + m[g];
        b = b + __funnelshift_l(v, v, shift_of(i));
        a = tmp;
    }
    s[0] += a;
    s[1] += b;
    s[2] += c;
    s[3] += d;
}

// the last len % 64 bytes at p, 0x80, zeros and the bit length: one block,
// or two when fewer than 8 bytes are left for the length
__device__ __forceinline__ void md5_tail(uint32_t s[4], const uint8_t* p, long long len) {
    const int r = (int)(len & 63);
    const int tail_blocks = r < 56 ? 1 : 2;
    const unsigned long long bits = (unsigned long long)len * 8ull;
    uint32_t m[16];
    for (int e = 0; e < tail_blocks; ++e) {
#pragma unroll
        for (int w = 0; w < 16; ++w) m[w] = 0;
        if (e == 0) {
#pragma unroll
            for (int k = 0; k < 64; ++k) {
                uint32_t byte = 0;
                if (k < r) byte = p[k];
                else if (k == r) byte = 0x80u;
                m[k >> 2] |= byte << ((k & 3) * 8);
            }
        }
        if (e == tail_blocks - 1) {
            m[14] = (uint32_t)bits;
            m[15] = (uint32_t)(bits >> 32);
        }
        md5_block(s, m);
    }
}

__device__ __forceinline__ int slot_of(int blob, int piece) {
    return blob * kPieces + (piece ^ ((blob >> 1) & 3));
}

__device__ __forceinline__ void cp_async16(uint4* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy group but the newest kStages - 1 has landed
__device__ __forceinline__ void cp_async_wait_oldest() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// rows 16-byte aligned: blocks staged through the per-warp cp.async ring
__global__ void __launch_bounds__(kBlobs)
md5_batch_kernel(const uint8_t* __restrict__ x, long long stride, long long n, long long len,
                 uint8_t* __restrict__ out) {
    __shared__ uint4 ring[kStages][kBlobs * kPieces];
    const int lane = threadIdx.x;
    const long long first = (long long)blockIdx.x * kBlobs;
    const long long full = len / 64;

    // this lane's four copies of each block: piece lane % 4 of blobs lane / 4 + 8q
    const int piece = lane & 3;
    const uint8_t* src[4];
    int dst[4];
    bool live[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int b = (lane >> 2) + 8 * q;
        live[q] = first + b < n;
        src[q] = x + (live[q] ? (first + b) * stride : 0) + 16 * piece;
        dst[q] = slot_of(b, piece);
    }
    // one commit group per block, empty past the last full block, so that
    // the wait below always leaves exactly kStages - 1 groups in flight
    auto fetch = [&](long long blk) {
        if (blk < full) {
            uint4* stage = ring[blk & (kStages - 1)];
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (live[q]) cp_async16(stage + dst[q], src[q] + blk * 64);
        }
        cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) fetch(s);

    uint32_t s[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu, 0x10325476u};
    for (long long blk = 0; blk < full; ++blk) {
        __syncwarp();  // every lane has read the stage the next fetch refills
        fetch(blk + kStages - 1);
        cp_async_wait_oldest();  // this lane's copies of block blk have landed
        __syncwarp();            // and so have every other lane's
        const uint4* stage = ring[blk & (kStages - 1)];
        uint32_t m[16];
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
            const uint4 v = stage[slot_of(lane, p)];
            m[4 * p] = v.x;
            m[4 * p + 1] = v.y;
            m[4 * p + 2] = v.z;
            m[4 * p + 3] = v.w;
        }
        md5_block(s, m);
    }
    const long long i = first + lane;
    if (i >= n) return;
    md5_tail(s, x + i * stride + full * 64, len);
    reinterpret_cast<uint4*>(out)[i] = make_uint4(s[0], s[1], s[2], s[3]);
}

// rows at any byte offset: each block read byte by byte in place
__global__ void __launch_bounds__(kBlobs)
md5_batch_bytes_kernel(const uint8_t* __restrict__ x, long long stride, long long n,
                       long long len, uint8_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * kBlobs + threadIdx.x;
    if (i >= n) return;
    const uint8_t* row = x + i * stride;
    uint32_t s[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu, 0x10325476u};
    uint32_t m[16];
    const long long full = len / 64;
    for (long long blk = 0; blk < full; ++blk) {
        const uint8_t* p = row + blk * 64;
#pragma unroll
        for (int w = 0; w < 16; ++w)
            m[w] = (uint32_t)p[4 * w] | (uint32_t)p[4 * w + 1] << 8 |
                   (uint32_t)p[4 * w + 2] << 16 | (uint32_t)p[4 * w + 3] << 24;
        md5_block(s, m);
    }
    md5_tail(s, row + full * 64, len);
    reinterpret_cast<uint4*>(out)[i] = make_uint4(s[0], s[1], s[2], s[3]);
}

}  // namespace

extern "C" int md5_batch(const void* x, long long stride, long long n, long long len, void* out,
                         void* stream) {
    if (n <= 0) return 0;
    if (len < 0 || ((uintptr_t)out % 16) != 0) return (int)cudaErrorInvalidValue;
    const long long blocks = (n + kBlobs - 1) / kBlobs;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const bool aligned = ((uintptr_t)x % 16 == 0) && (n == 1 || stride % 16 == 0);
    if (aligned)
        md5_batch_kernel<<<(unsigned)blocks, kBlobs, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)x, stride, n, len, (uint8_t*)out);
    else
        md5_batch_bytes_kernel<<<(unsigned)blocks, kBlobs, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)x, stride, n, len, (uint8_t*)out);
    return (int)cudaGetLastError();
}
