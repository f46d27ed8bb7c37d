// CRC32C of N equal-length blobs for Hopper: out[i] = crc32c(x[i, 0:L]),
// byte-identical to storage/crc.crc32c (Go hash/crc32, Castagnoli).
//
// Replaces the JAX device function seaweedfs_tpu/ops/crc32c_kernel.py::
// _compiled_batch, which writes the CRC as a GF(2) affine map and runs it
// as an (N, 8L) x (8L, 32) int8 matmul on the MXU.
//
// Bound: memory. The function reads N*L bytes and writes 4N, and a table
// CRC spends about three integer operations per byte, under the memory
// time on this card. The bit-matmul form would expand every byte into 8
// operands, so this kernel uses tables and keeps only the affine structure:
//
//   crc(x) = XOR_lanes A^(L - end_j) * r_j  ^  crc(0^L)
//
// One warp per blob. Lane j computes r_j, the register-only CRC (init 0,
// no final XOR) of its contiguous segment [j*seg, end_j), by slice-by-8
// tables in shared memory (8 KiB); `seg` is ceil(L/32) rounded up to 16
// bytes, so each lane reads its segment with 16-byte loads when the rows
// are aligned. A^m is the 32x32 GF(2) matrix of m zero bytes; its 32
// columns per lane are built on the host per L (ops/crc32c_kernel.py::
// _lane_columns, 4 KiB) and staged in shared memory padded to 33 words, so
// the 32 conditional XORs of a warp hit 32 different banks. A
// __shfl_xor_sync butterfly XORs the lanes together, and lane 0 writes the
// blob's CRC. Nothing is padded or copied: rows may sit at any stride.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t step8(const uint32_t (*t)[256], uint32_t c, uint32_t lo,
                                          uint32_t hi) {
    lo ^= c;
    return t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
           t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
}

__global__ void __launch_bounds__(kThreads)
crc32c_batch_kernel(const uint8_t* __restrict__ x, long long stride, long long n, long long len,
                    long long seg, const uint32_t* __restrict__ tables,
                    const uint32_t* __restrict__ cols, uint32_t zero_crc,
                    uint32_t* __restrict__ out, int vec) {
    __shared__ uint32_t t[8][256];
    __shared__ uint32_t c[32 * 33];
    for (int k = threadIdx.x; k < 8 * 256; k += blockDim.x) (&t[0][0])[k] = tables[k];
    for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x) c[(k >> 5) * 33 + (k & 31)] = cols[k];
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const long long start = (long long)lane * seg;
    const long long end = start + seg < len ? start + seg : len;
    const uint32_t* lc = c + lane * 33;
    const long long warps = (long long)gridDim.x * kWarps;
    // the loop is uniform across a warp: every lane works on the same blob
    for (long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); b < n; b += warps) {
        const uint8_t* row = x + b * stride;
        uint32_t r = 0;
        long long i = start;
        if (vec) {
            for (; i + 16 <= end; i += 16) {
                const uint4 v = *reinterpret_cast<const uint4*>(row + i);
                r = step8(t, r, v.x, v.y);
                r = step8(t, r, v.z, v.w);
            }
        }
        for (; i < end; ++i) r = t[0][(r ^ row[i]) & 0xFF] ^ (r >> 8);
        uint32_t y = 0;
#pragma unroll
        for (int k = 0; k < 32; ++k) y ^= lc[k] & (0u - ((r >> k) & 1u));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) y ^= __shfl_xor_sync(0xFFFFFFFFu, y, off);
        if (lane == 0) out[b] = y ^ zero_crc;
    }
}

}  // namespace

extern "C" int crc32c_batch(const void* x, long long stride, long long n, long long len,
                            long long seg, const void* tables, const void* cols,
                            unsigned int zero_crc, void* out, void* stream) {
    if (n <= 0 || len <= 0) return 0;
    if (seg <= 0 || seg % 16 != 0 || seg * 32 < len) return (int)cudaErrorInvalidValue;
    const int vec = ((uintptr_t)x % 16 == 0) && (n == 1 || stride % 16 == 0);
    long long blocks = (n + kWarps - 1) / kWarps;
    if (blocks > 132LL * 8) blocks = 132LL * 8;  // 8 blocks of 8 warps per SM, then stride
    crc32c_batch_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, stride, n, len, seg, (const uint32_t*)tables, (const uint32_t*)cols,
        zero_crc, (uint32_t*)out, vec);
    return (int)cudaGetLastError();
}
