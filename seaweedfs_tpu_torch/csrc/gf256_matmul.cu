// GF(2^8) shard transform for Hopper: out[r] = XOR_c M[r,c] * x[c] over the
// field 0x11D, byte-identical to ops/gf256.py::gf_matmul_bytes.
//
// Replaces the Pallas kernel seaweedfs_tpu/ops/rs_pallas.py::_compiled (the
// repo's only pallas_call), which expands every byte into 8 bit-planes and
// runs an (8*rows, 8*cols) x (8*cols, TILE) int8 matmul on the MXU.
//
// Bound: memory. RS(10,4) reads cols*n bytes and writes rows*n bytes, so the
// least time is (rows+cols)*n over the card's memory rate (0.140 ms for the
// (32, 10, 1 MiB) encode batch). What sets the pace instead is the table
// lookups in shared memory: a warp's 32 data-dependent lookups into one
// table meet bank conflicts, and the SM serves one pass of 32 banks a clock.
//
// Design: packed-row tables, one 32-bit lookup per input byte for four
// output rows. For row group g (rows 4g..4g+3) and column c the host builds
//   T[g][c][v] = M[4g,c]*v | M[4g+1,c]*v << 8 | M[4g+2,c]*v << 16 | M[4g+3,c]*v << 24
// (rs_cuda.packed_tables; rows past the last are 0), 1 KiB per (group,
// column), 10 KiB for RS(10,4), staged into shared memory once per block.
// A thread owns 16 contiguous bytes of every column (one uint4 load each,
// coalesced) and keeps one uint32 accumulator per byte position and group:
// each input byte costs one LDS.32 and one XOR per group, ceil(rows/4)
// lookups where a byte table costs `rows`. After the last column a 4x4 byte
// transpose (__byte_perm, 8 prmt per 4 words) turns a group's accumulators
// into its four rows' uint4 stores. COLS = 10, the only width on the EC
// path, is a template parameter, so a unit's ten loads are in flight
// together and every table offset is an immediate; other widths take a
// run-time loop.
// One row (the degraded read) keeps a 256-byte table per column (its low
// bytes, 2-way conflicts where a 1 KiB table meets about 3.5-way).
//
// Work split: a grid-stride loop over whole 16-byte units; blockIdx.y walks
// an optional batch dimension, so the (row_count, 10, block) .dat layout of
// an encode batch is read in place. The ragged tail (n % 16) and any input
// that is not 16-byte aligned go one byte a thread (coalesced), through the
// same tables; nothing is padded. The caller caps the grid (max_blocks:
// rs_cuda.py, the device's SM count times its blocks a SM); the kernel
// splits the cap over the batches.
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
__host__ __device__ constexpr int groups() { return (ROWS + 3) / 4; }

// Tables into shared memory: the packed words as they are, or for one row
// their low bytes, a 256-byte table per column.
template <int ROWS>
__device__ __forceinline__ void stage(uint32_t* smem, const uint32_t* __restrict__ tables,
                                      int cols) {
    const uint4* src = reinterpret_cast<const uint4*>(tables);
    const int vecs = groups<ROWS>() * cols * 64;  // 256 words = 64 uint4 a table
    for (int k = threadIdx.x; k < vecs; k += kThreads) {
        const uint4 t = src[k];
        if constexpr (ROWS == 1)
            smem[k] = (t.x & 0xFFu) | (t.y & 0xFFu) << 8 | (t.z & 0xFFu) << 16 | t.w << 24;
        else
            reinterpret_cast<uint4*>(smem)[k] = t;
    }
    __syncthreads();
}

// One output byte position i of every row.
template <int ROWS, int COLS>
__device__ __forceinline__ void one_byte(const uint32_t* smem, int cols,
                                         const uint8_t* __restrict__ xb, long long xrs,
                                         uint8_t* __restrict__ ob, long long ors,
                                         long long i) {
    constexpr int G = groups<ROWS>();
    const int nc = COLS ? COLS : cols;
    uint32_t acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0;
    for (int c = 0; c < nc; ++c) {
        const uint32_t v = xb[c * xrs + i];
        if constexpr (ROWS == 1) {
            acc[0] ^= reinterpret_cast<const uint8_t*>(smem)[c * 256 + v];
        } else {
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g] ^= smem[(g * nc + c) * 256 + v];
        }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) ob[r * ors + i] = (uint8_t)(acc[r / 4] >> (8 * (r % 4)));
}

// acc[4k + j] ^= table[byte j of word k]: one packed lookup per input byte.
__device__ __forceinline__ void lookup_packed(uint32_t (&acc)[16], const uint32_t* table,
                                              const uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 * k + j] ^= table[(w[k] >> (8 * j)) & 0xFFu];
}

// acc[k] ^= table[byte j of word k] << 8j: one byte lookup per input byte.
__device__ __forceinline__ void lookup_bytes(uint32_t (&acc)[4], const uint8_t* table,
                                             const uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            acc[k] ^= (uint32_t)table[(w[k] >> (8 * j)) & 0xFFu] << (8 * j);
}

__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ xb, int c, long long xrs,
                                        long long i) {
    return *reinterpret_cast<const uint4*>(xb + c * xrs + i);
}

// The 16 bytes at i of every row, from the 16 bytes at i of every column.
template <int ROWS, int COLS>
__device__ __forceinline__ void unit(const uint32_t* smem, int cols,
                                     const uint8_t* __restrict__ xb, long long xrs,
                                     uint8_t* __restrict__ ob, long long ors, long long i) {
    if constexpr (ROWS == 1) {
        const uint8_t* tb = reinterpret_cast<const uint8_t*>(smem);
        uint32_t acc[4] = {0, 0, 0, 0};
        if constexpr (COLS > 0) {
            uint4 v[COLS];
#pragma unroll
            for (int c = 0; c < COLS; ++c) v[c] = load16(xb, c, xrs, i);
#pragma unroll
            for (int c = 0; c < COLS; ++c) lookup_bytes(acc, tb + c * 256, v[c]);
        } else {
            for (int c = 0; c < cols; ++c) lookup_bytes(acc, tb + c * 256, load16(xb, c, xrs, i));
        }
        *reinterpret_cast<uint4*>(ob + i) = make_uint4(acc[0], acc[1], acc[2], acc[3]);
    } else {
        constexpr int G = groups<ROWS>();
        uint32_t acc[G][16];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int p = 0; p < 16; ++p) acc[g][p] = 0;
        if constexpr (COLS > 0) {
            uint4 v[COLS];
#pragma unroll
            for (int c = 0; c < COLS; ++c) v[c] = load16(xb, c, xrs, i);
#pragma unroll
            for (int c = 0; c < COLS; ++c)
#pragma unroll
                for (int g = 0; g < G; ++g)
                    lookup_packed(acc[g], smem + (g * COLS + c) * 256, v[c]);
        } else {
            for (int c = 0; c < cols; ++c) {
                const uint4 v = load16(xb, c, xrs, i);
#pragma unroll
                for (int g = 0; g < G; ++g) lookup_packed(acc[g], smem + (g * cols + c) * 256, v);
            }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
            // o[k][w]: word w of row 4g+k = byte k of acc[g][4w..4w+3]
            uint32_t o[4][4];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                const uint32_t a0 = acc[g][4 * w], a1 = acc[g][4 * w + 1];
                const uint32_t a2 = acc[g][4 * w + 2], a3 = acc[g][4 * w + 3];
                const uint32_t t0 = __byte_perm(a0, a1, 0x5140);  // a0b0 a1b0 a0b1 a1b1
                const uint32_t t1 = __byte_perm(a0, a1, 0x7362);  // a0b2 a1b2 a0b3 a1b3
                const uint32_t t2 = __byte_perm(a2, a3, 0x5140);
                const uint32_t t3 = __byte_perm(a2, a3, 0x7362);
                o[0][w] = __byte_perm(t0, t2, 0x5410);  // a0b0 a1b0 a2b0 a3b0
                o[1][w] = __byte_perm(t0, t2, 0x7632);
                o[2][w] = __byte_perm(t1, t3, 0x5410);
                o[3][w] = __byte_perm(t1, t3, 0x7632);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (4 * g + k < ROWS)
                    *reinterpret_cast<uint4*>(ob + (4 * g + k) * ors + i) =
                        make_uint4(o[k][0], o[k][1], o[k][2], o[k][3]);
        }
    }
}

// x: element (b, c, i) at x + b*x_batch_stride + c*x_row_stride + i.
// out: element (r, b, i) at out + r*out_row_stride + b*n + i.
// COLS = 0: the column count is `cols`, read at run time.
template <int ROWS, int COLS>
__global__ void __launch_bounds__(kThreads)
gf256_matmul_kernel(const uint32_t* __restrict__ tables, int cols,
                    const uint8_t* __restrict__ x, long long x_batch_stride,
                    long long x_row_stride, uint8_t* __restrict__ out,
                    long long out_row_stride, long long n, long long batches, int vec) {
    extern __shared__ __align__(16) uint32_t smem[];
    stage<ROWS>(smem, tables, COLS ? COLS : cols);

    const long long step = (long long)gridDim.x * kThreads;
    const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long units = vec ? n / 16 : 0;
    for (long long b = blockIdx.y; b < batches; b += gridDim.y) {
        const uint8_t* xb = x + b * x_batch_stride;
        uint8_t* ob = out + b * n;
#pragma unroll 1
        for (long long u = first; u < units; u += step)
            unit<ROWS, COLS>(smem, cols, xb, x_row_stride, ob, out_row_stride, u * 16);
        // what no whole unit covers: the tail, or every byte of an unaligned input
#pragma unroll 1
        for (long long i = units * 16 + first; i < n; i += step)
            one_byte<ROWS, COLS>(smem, cols, xb, x_row_stride, ob, out_row_stride, i);
    }
}

template <int ROWS, int COLS>
cudaError_t launch(const uint32_t* tables, int cols, const uint8_t* x, long long xbs,
                   long long xrs, uint8_t* out, long long ors, long long n,
                   long long batches, int vec, int max_blocks, cudaStream_t stream) {
    auto kernel = gf256_matmul_kernel<ROWS, COLS>;
    const int nc = COLS ? COLS : cols;
    const int smem = ROWS == 1 ? nc * 256 : groups<ROWS>() * nc * 1024;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    // the caller's cap on blocks, split over the batches
    const long long gy = batches < 65535 ? batches : 65535;
    const long long per_batch = vec ? (n / 16 > 0 ? n / 16 : n) : n;
    const long long want = max_blocks / gy > 1 ? max_blocks / gy : 1;
    long long gx = (per_batch + kThreads - 1) / kThreads;
    if (gx > want) gx = want;
    if (gx < 1) gx = 1;
    dim3 grid((unsigned)gx, (unsigned)gy);
    kernel<<<grid, kThreads, smem, stream>>>(tables, cols, x, xbs, xrs, out, ors, n, batches, vec);
    return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_rows(const uint32_t* t, int cols, const uint8_t* x, long long xbs,
                        long long xrs, uint8_t* o, long long ors, long long n,
                        long long batches, int vec, int mb, cudaStream_t s) {
    return cols == 10 ? launch<ROWS, 10>(t, cols, x, xbs, xrs, o, ors, n, batches, vec, mb, s)
                      : launch<ROWS, 0>(t, cols, x, xbs, xrs, o, ors, n, batches, vec, mb, s);
}

}  // namespace

// tables: rs_cuda.packed_tables(M) on the device, (ceil(rows/4), cols, 256)
// uint32. max_blocks: the most blocks the launch may use.
extern "C" int gf256_matmul(const void* tables, int rows, int cols, const void* x,
                            long long x_batch_stride, long long x_row_stride,
                            void* out, long long out_row_stride, long long n,
                            long long batches, int max_blocks, void* stream) {
    if (rows < 1 || rows > kMaxRows || cols < 1 || cols > kMaxCols || max_blocks < 1)
        return (int)cudaErrorInvalidValue;
    if (n <= 0 || batches <= 0) return 0;
    const uintptr_t xa = (uintptr_t)x, oa = (uintptr_t)out;
    const int vec = (xa % 16 == 0) && (oa % 16 == 0) && (x_row_stride % 16 == 0) &&
                    (out_row_stride % 16 == 0) &&
                    (batches == 1 || (n % 16 == 0 && x_batch_stride % 16 == 0));
    const uint32_t* t = (const uint32_t*)tables;
    const uint8_t* xi = (const uint8_t*)x;
    uint8_t* o = (uint8_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e;
    switch (rows) {
#define GF_CASE(R) \
    case R: e = launch_rows<R>(t, cols, xi, x_batch_stride, x_row_stride, o, out_row_stride, n, batches, vec, max_blocks, s); break;
        GF_CASE(1) GF_CASE(2) GF_CASE(3) GF_CASE(4) GF_CASE(5) GF_CASE(6) GF_CASE(7)
        GF_CASE(8) GF_CASE(9) GF_CASE(10) GF_CASE(11) GF_CASE(12) GF_CASE(13) GF_CASE(14)
#undef GF_CASE
        default: e = cudaErrorInvalidValue;
    }
    return (int)e;
}
