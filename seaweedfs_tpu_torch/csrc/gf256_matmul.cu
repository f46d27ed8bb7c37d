// GF(2^8) shard transform for Hopper: out[r] = XOR_c M[r,c] * x[c] over the
// field 0x11D, byte-identical to ops/gf256.py::gf_matmul_bytes.
//
// Replaces the Pallas kernel seaweedfs_tpu/ops/rs_pallas.py::_compiled (the
// repo's only pallas_call), which expands every byte into 8 bit-planes and
// runs an (8*rows, 8*cols) x (8*cols, TILE) int8 matmul on the MXU.
//
// Bound: memory. RS(10,4) does a few operations per byte: it reads cols*n
// bytes and writes rows*n bytes, so the least time is (rows+cols)*n over the
// card's memory rate. The bit-plane form would spend 8x the bytes in bits, so
// this kernel uses product tables instead: tables[c][r][v] = M[r,c] * v,
// 256 bytes per coefficient (rows*cols*256 bytes, 10 KiB for RS(10,4)),
// built once per matrix on the host and copied into shared memory by every
// block. A 256-byte table spans each of the 32 banks with two words, so a
// warp's lookups conflict at most 2-way.
//
// Work split: each thread owns 16 contiguous bytes of a column (one uint4
// load per input shard, coalesced), XOR-accumulates all `rows` outputs in
// registers (ROWS is a template parameter so the accumulators stay in
// registers) and writes each with one uint4 store. A grid-stride loop walks
// n; blockIdx.y walks an optional batch dimension, so the (row_count, 10,
// block) .dat layout of an encode batch is read in place, without a device
// transpose. The ragged tail (n % 16) and any input that is not 16-byte
// aligned go through a byte-wise path; nothing is padded.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 14;
constexpr int kMaxCols = 14;
constexpr int kThreads = 256;

template <int ROWS>
__device__ __forceinline__ void bytewise(const uint8_t* __restrict__ smem, int cols,
                                         const uint8_t* __restrict__ xb,
                                         long long x_row_stride,
                                         uint8_t* __restrict__ ob,
                                         long long out_row_stride, long long i) {
    uint32_t acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0;
    for (int c = 0; c < cols; ++c) {
        const uint32_t v = xb[c * x_row_stride + i];
        const uint8_t* tc = smem + c * ROWS * 256;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] ^= tc[r * 256 + v];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) ob[r * out_row_stride + i] = (uint8_t)acc[r];
}

// x: element (b, c, i) at x + b*x_batch_stride + c*x_row_stride + i.
// out: element (r, b, i) at out + r*out_row_stride + b*n + i.
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
gf256_matmul_kernel(const uint8_t* __restrict__ tables, int cols,
                    const uint8_t* __restrict__ x, long long x_batch_stride,
                    long long x_row_stride, uint8_t* __restrict__ out,
                    long long out_row_stride, long long n, long long batches,
                    int vec) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int words = ROWS * cols * 256 / 16;
    for (int k = threadIdx.x; k < words; k += blockDim.x)
        reinterpret_cast<uint4*>(smem)[k] = reinterpret_cast<const uint4*>(tables)[k];
    __syncthreads();

    const long long step = (long long)gridDim.x * blockDim.x;
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long b = blockIdx.y; b < batches; b += gridDim.y) {
        const uint8_t* xb = x + b * x_batch_stride;
        uint8_t* ob = out + b * n;
        if (!vec) {
            for (long long i = first; i < n; i += step)
                bytewise<ROWS>(smem, cols, xb, x_row_stride, ob, out_row_stride, i);
            continue;
        }
        const long long units = (n + 15) / 16;
        for (long long u = first; u < units; u += step) {
            const long long i = u * 16;
            if (i + 16 > n) {
                for (long long t = i; t < n; ++t)
                    bytewise<ROWS>(smem, cols, xb, x_row_stride, ob, out_row_stride, t);
                continue;
            }
            uint32_t acc[ROWS][4];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
                for (int k = 0; k < 4; ++k) acc[r][k] = 0;
            for (int c = 0; c < cols; ++c) {
                const uint4 v = *reinterpret_cast<const uint4*>(xb + c * x_row_stride + i);
                const uint32_t w[4] = {v.x, v.y, v.z, v.w};
                const uint8_t* tc = smem + c * ROWS * 256;
#pragma unroll
                for (int k = 0; k < 4; ++k)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const uint32_t byte = (w[k] >> (8 * j)) & 0xFFu;
#pragma unroll
                        for (int r = 0; r < ROWS; ++r)
                            acc[r][k] ^= (uint32_t)tc[r * 256 + byte] << (8 * j);
                    }
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
                *reinterpret_cast<uint4*>(ob + r * out_row_stride + i) =
                    make_uint4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
    }
}

template <int ROWS>
cudaError_t launch(const uint8_t* tables, int cols, const uint8_t* x,
                   long long xbs, long long xrs, uint8_t* out, long long ors,
                   long long n, long long batches, int vec, cudaStream_t stream) {
    const int smem = ROWS * cols * 256;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            gf256_matmul_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    const long long per_batch = vec ? (n + 15) / 16 : n;
    const long long gy = batches < 65535 ? batches : 65535;
    // about 16 blocks of 256 threads per SM over the whole grid
    const long long want = (132LL * 16 + gy - 1) / gy;
    long long gx = (per_batch + kThreads - 1) / kThreads;
    if (gx > want) gx = want;
    if (gx < 1) gx = 1;
    dim3 grid((unsigned)gx, (unsigned)gy);
    gf256_matmul_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
        tables, cols, x, xbs, xrs, out, ors, n, batches, vec);
    return cudaGetLastError();
}

}  // namespace

extern "C" int gf256_matmul(const void* tables, int rows, int cols, const void* x,
                            long long x_batch_stride, long long x_row_stride,
                            void* out, long long out_row_stride, long long n,
                            long long batches, void* stream) {
    if (rows < 1 || rows > kMaxRows || cols < 1 || cols > kMaxCols)
        return (int)cudaErrorInvalidValue;
    if (n <= 0 || batches <= 0) return 0;
    const uintptr_t xa = (uintptr_t)x, oa = (uintptr_t)out;
    const int vec = (xa % 16 == 0) && (oa % 16 == 0) && (x_row_stride % 16 == 0) &&
                    (out_row_stride % 16 == 0) &&
                    (batches == 1 || (n % 16 == 0 && x_batch_stride % 16 == 0));
    const uint8_t* t = (const uint8_t*)tables;
    const uint8_t* xi = (const uint8_t*)x;
    uint8_t* o = (uint8_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e;
    switch (rows) {
#define GF_CASE(R) \
    case R: e = launch<R>(t, cols, xi, x_batch_stride, x_row_stride, o, out_row_stride, n, batches, vec, s); break;
        GF_CASE(1) GF_CASE(2) GF_CASE(3) GF_CASE(4) GF_CASE(5) GF_CASE(6) GF_CASE(7)
        GF_CASE(8) GF_CASE(9) GF_CASE(10) GF_CASE(11) GF_CASE(12) GF_CASE(13) GF_CASE(14)
#undef GF_CASE
        default: e = cudaErrorInvalidValue;
    }
    return (int)e;
}
