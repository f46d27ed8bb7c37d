// CRC32C of N equal-length blobs for Hopper: out[i] = crc32c(x[i, 0:L]),
// byte-identical to storage/crc.crc32c (Go hash/crc32, Castagnoli).
//
// Replaces the JAX device function seaweedfs_tpu/ops/crc32c_kernel.py::
// _compiled_batch, which writes the CRC as a GF(2) affine map and runs it
// as an (N, 8L) x (8L, 32) int8 matmul on the MXU.
//
// Bound: bytes. The function reads N*L bytes and writes 4N, and a table CRC
// spends about three integer operations a byte, under the memory time on
// this card. What stands between the kernel and the bytes is the table
// lookups: one a byte, in shared memory, where 32 lanes reading random
// entries meet about 3.5-way bank conflicts, so a 132-SM card looks up
// about 2.4 TB/s, under its 3.35 TB/s of HBM. The bit-matmul form would
// expand every byte into 8 operands, so this kernel uses tables and keeps
// only the affine structure:
//
//   crc(x) = XOR_lanes A^e(lane) * r_lane  ^  crc(0^L)
//
// where r_lane is a register-only CRC (init 0, no final XOR) and A^e the
// 32x32 GF(2) matrix of e zero bytes (e < 0 undoes zero bytes).
//
// What the design does about it:
// - Coalesced loads. A blob is cut into `warps` spans of `span` bytes (a
//   multiple of 512; the last may be short), one warp each. In its span,
//   lane j takes the 16-byte pieces j, j + 32, j + 64, ..., so each warp
//   load is 512 contiguous bytes, eight loads in flight a lane. A lane
//   advances its CRC by 512 bytes a piece: its piece, then the other lanes'
//   496 bytes as zeros, with 16 tables of 256 words (ops/crc32c_kernel.py::
//   _piece_tables), one lookup a byte; 12 of a piece's 16 lookups do not
//   wait for the previous piece. Each lane consumes exactly what it loaded,
//   so the bytes go straight to registers, not through shared memory.
// - The card full at every shape. ops/crc32c_kernel.py::crc_warps gives a
//   blob one warp while the batch has enough of them (4 KiB blobs) and up to
//   32 (16 for the chunked path's 256 x 4 MiB, 4,096 warps), so no lane walks
//   a long chain alone.
// - A two-level fold. Lanes fold into their warp by columns relative to the
//   end of the warp's span (one set for a full span, one for the blob's
//   last), then a shuffle butterfly; warps fold into the blob by one column
//   set per warp and a second butterfly, and the blob's warps meet in shared
//   memory. The columns are built on the host per (L, warps)
//   (ops/crc32c_kernel.py::_fold_columns); lane j reads its 32 columns
//   starting from column j, so a warp's 32 conditional XORs hit 32 banks.
// - Tables and columns staged once per block, by 16-byte cp.async copies
//   all in flight at once (one-word loads, one after another, would cost
//   more than the hashing of a 16-blob batch). Blocks loop over blobs; the
//   caller sizes the block and the grid (ops/crc32c_kernel.py::crc_grid).
// Rows that are not 16-byte aligned take the same kernel with byte loads.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPiece = 16;             // bytes a lane loads at once
constexpr int kStride = 32 * kPiece;   // bytes a warp loads at once
constexpr int kMaxThreads = 1024;      // 32 warps of one blob
constexpr int kAhead = 8;              // pieces a lane loads before hashing them

__device__ __forceinline__ uint32_t step(const uint32_t (*t)[256], uint32_t r, uint4 v) {
    const uint32_t rest =
        t[4][v.y & 0xFF] ^ t[5][(v.y >> 8) & 0xFF] ^ t[6][(v.y >> 16) & 0xFF] ^ t[7][v.y >> 24] ^
        t[8][v.z & 0xFF] ^ t[9][(v.z >> 8) & 0xFF] ^ t[10][(v.z >> 16) & 0xFF] ^ t[11][v.z >> 24] ^
        t[12][v.w & 0xFF] ^ t[13][(v.w >> 8) & 0xFF] ^ t[14][(v.w >> 16) & 0xFF] ^ t[15][v.w >> 24];
    const uint32_t a = v.x ^ r;
    return rest ^ t[0][a & 0xFF] ^ t[1][(a >> 8) & 0xFF] ^ t[2][(a >> 16) & 0xFF] ^ t[3][a >> 24];
}

__device__ __forceinline__ uint32_t word_at(const uint8_t* p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
}

template <bool kVec>
__device__ __forceinline__ uint4 load_piece(const uint8_t* p) {
    if (kVec) return __ldg(reinterpret_cast<const uint4*>(p));
    return make_uint4(word_at(p), word_at(p + 4), word_at(p + 8), word_at(p + 12));
}

// the blob's last `bytes` (< 16) bytes, zeros after them
__device__ __forceinline__ uint4 load_partial(const uint8_t* p, int bytes) {
    unsigned long long lo = 0, hi = 0;  // two halves in registers, not an indexed array
    for (int k = 0; k < bytes; ++k) {
        if (k < 8) lo |= (unsigned long long)p[k] << (8 * k);
        else hi |= (unsigned long long)p[k] << (8 * (k - 8));
    }
    return make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
}

// 16-byte asynchronous copies of `words` words (a multiple of 4) from
// global to shared memory, spread over the block; waited for by stage_wait
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src, int words) {
    for (int k = 4 * threadIdx.x; k < words; k += 4 * blockDim.x) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst + k);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + k) : "memory");
    }
}

__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
}

__device__ __forceinline__ uint32_t xor_warp(uint32_t y) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) y ^= __shfl_xor_sync(0xFFFFFFFFu, y, off);
    return y;
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
crc32c_batch_kernel(const uint8_t* __restrict__ x, long long stride, long long n, long long len,
                    int warps, long long span, const uint32_t* __restrict__ tables,
                    const uint32_t* __restrict__ cols, uint32_t zero_crc,
                    uint32_t* __restrict__ out) {
    __shared__ __align__(16) uint32_t t[16][256];
    // lanes of a full span, lanes of the blob's last span, then one column
    // set per warp of a blob
    __shared__ __align__(16) uint32_t c[(64 + 32) * 32];
    __shared__ uint32_t part[32];  // each warp's share, carried to its blob's end
    stage(&t[0][0], tables, 16 * 256);
    stage(c, cols, (64 + warps) * 32);
    stage_wait();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int blobs_per_block = (blockDim.x >> 5) / warps;
    const int w = warp % warps;  // this warp's span in its blob
    const long long last = (len - 1) / span;
    const long long groups = (n + blobs_per_block - 1) / blobs_per_block;
    // the loop is uniform across the block: every warp runs every group
    for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
        const long long b = g * blobs_per_block + warp / warps;
        uint32_t y = 0;
        if (b < n && w <= last) {
            const uint8_t* row = x + b * stride;
            const long long s = w * span;
            const long long e = s + span < len ? s + span : len;
            const long long full = (e - s) / kPiece;  // whole pieces of the span
            const int rem = (int)((e - s) % kPiece);  // only in the blob's last span
            const uint8_t* p = row + s + kPiece * lane;
            const long long pieces = full > lane ? (full - lane + 31) / 32 : 0;
            uint32_t r = 0;
            long long k = 0;
            for (; k + kAhead <= pieces; k += kAhead) {
                uint4 v[kAhead];
#pragma unroll
                for (int a = 0; a < kAhead; ++a) v[a] = load_piece<kVec>(p + kStride * (k + a));
#pragma unroll
                for (int a = 0; a < kAhead; ++a) r = step(t, r, v[a]);
            }
            for (; k < pieces; ++k) r = step(t, r, load_piece<kVec>(p + kStride * k));
            // the partial last piece belongs to the lane whose next piece it is
            if (rem && lane == (int)(full & 31)) r = step(t, r, load_partial(row + s + kPiece * full, rem));
            // lane j reads its columns from column j on, so that the 32 lanes
            // of each step hit 32 banks
            const uint32_t* lc = c + (w == last ? 32 + lane : lane) * 32;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int k = (i + lane) & 31;
                y ^= lc[k] & (0u - ((r >> k) & 1u));
            }
            y = xor_warp(y);
            if (warps > 1) y = xor_warp(c[(64 + w) * 32 + lane] & (0u - ((y >> lane) & 1u)));
        }
        if (warps == 1) {
            if (lane == 0 && b < n) out[b] = y ^ zero_crc;
            continue;
        }
        if (lane == 0) part[warp] = y;
        __syncthreads();
        if (w == 0 && b < n) {  // the blob's first warp gathers its warps
            const uint32_t v = xor_warp(lane < warps ? part[warp + lane] : 0u);
            if (lane == 0) out[b] = v ^ zero_crc;
        }
        __syncthreads();
    }
}

}  // namespace

// threads: a multiple of 32 * warps, at most 1024 (whole blobs a block)
extern "C" int crc32c_batch(const void* x, long long stride, long long n, long long len,
                            int warps, long long span, int threads, long long blocks,
                            const void* tables, const void* cols, unsigned int zero_crc,
                            void* out, void* stream) {
    if (n <= 0 || len <= 0) return 0;
    if (warps < 1 || warps > 32 || (warps & (warps - 1)) != 0 || span <= 0 ||
        span % kStride != 0 || span * warps < len || threads < 32 * warps ||
        threads > kMaxThreads || threads % (32 * warps) != 0 || blocks < 1 ||
        blocks > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const bool vec = ((uintptr_t)x % 16 == 0) && (n == 1 || stride % 16 == 0);
    if (vec)
        crc32c_batch_kernel<true><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)x, stride, n, len, warps, span, (const uint32_t*)tables,
            (const uint32_t*)cols, zero_crc, (uint32_t*)out);
    else
        crc32c_batch_kernel<false><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)x, stride, n, len, warps, span, (const uint32_t*)tables,
            (const uint32_t*)cols, zero_crc, (uint32_t*)out);
    return (int)cudaGetLastError();
}
