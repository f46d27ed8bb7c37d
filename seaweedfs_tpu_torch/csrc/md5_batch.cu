// MD5 (RFC 1321) of N equal-length blobs for Hopper: out[i] = md5(x[i, 0:L]),
// byte-identical to hashlib.md5.
//
// Replaces the JAX device function seaweedfs_tpu/ops/md5_kernel.py::
// _compiled_batch, which advances N states in lockstep on the VPU's lanes
// (64 rounds per block under lax.scan) after concatenating a padded copy of
// the blobs on the device.
//
// Bound: bytes, narrowly. sm_90 runs a round in 4 integer instructions
// (LOP3 for the boolean function, IADD3 and IMAD.IADD for a + f + K + m,
// LEA.HI for the rotate and the + b together), about 265 per 64-byte block
// with the state update and the loop, so at the card's 32-bit integer rate
// (64 per clock per SM) the operations take a little less time than
// reading the bytes. MD5 is sequential within a blob, so the only
// parallelism is across blobs: one thread per blob. The rounds
// are unrolled, the constants sit in __constant__ memory (a warp reads the
// same one, so it broadcasts), the rotates are __funnelshift_l, and each
// round's message word is a register. A round is a chain of dependent
// operations, so a thread runs at the latency of that chain; only many
// blobs in flight fill the card, and a batch of 8192 blobs is 256 warps on
// 528 schedulers: the card stays far from its integer rate at that size.
//
// Full blocks are read in place (16-byte loads when the rows are aligned,
// bytes otherwise); the last one or two blocks, with the 0x80 byte, the
// zeros and the 64-bit bit length, are built in registers. No padded copy
// of the blobs is made.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

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

__global__ void __launch_bounds__(kThreads)
md5_batch_kernel(const uint8_t* __restrict__ x, long long stride, long long n, long long len,
                 uint8_t* __restrict__ out, int vec) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint8_t* row = x + i * stride;
    uint32_t s[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu, 0x10325476u};
    uint32_t m[16];
    const long long full = len / 64;
    for (long long blk = 0; blk < full; ++blk) {
        const uint8_t* p = row + blk * 64;
        if (vec) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const uint4 v = reinterpret_cast<const uint4*>(p)[q];
                m[4 * q] = v.x;
                m[4 * q + 1] = v.y;
                m[4 * q + 2] = v.z;
                m[4 * q + 3] = v.w;
            }
        } else {
#pragma unroll
            for (int w = 0; w < 16; ++w)
                m[w] = (uint32_t)p[4 * w] | (uint32_t)p[4 * w + 1] << 8 |
                       (uint32_t)p[4 * w + 2] << 16 | (uint32_t)p[4 * w + 3] << 24;
        }
        md5_block(s, m);
    }
    // the last L % 64 bytes, 0x80, zeros and the bit length: one block, or
    // two when fewer than 8 bytes are left for the length
    const int r = (int)(len - full * 64);
    const uint8_t* p = row + full * 64;
    const int tail_blocks = r < 56 ? 1 : 2;
    const unsigned long long bits = (unsigned long long)len * 8ull;
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
    reinterpret_cast<uint4*>(out)[i] = make_uint4(s[0], s[1], s[2], s[3]);
}

}  // namespace

extern "C" int md5_batch(const void* x, long long stride, long long n, long long len, void* out,
                         void* stream) {
    if (n <= 0) return 0;
    if (len < 0 || ((uintptr_t)out % 16) != 0) return (int)cudaErrorInvalidValue;
    const int vec = ((uintptr_t)x % 16 == 0) && (n == 1 || stride % 16 == 0);
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    md5_batch_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, stride, n, len, (uint8_t*)out, vec);
    return (int)cudaGetLastError();
}
