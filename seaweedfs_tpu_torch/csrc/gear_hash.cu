// Gear window hash of every position of a buffer, for Hopper:
//   out[i] = XOR_{k=0}^{31} ( G[x[i-k]] << k )   (uint32; terms with i-k < 0 absent)
// byte-identical to ops/cdc.py::gear_hashes_numpy.
//
// Replaces the JAX device function seaweedfs_tpu/ops/cdc.py::_compiled_hashes,
// which gathers G[x] for the whole (1 MiB-bucketed) buffer and XORs 32
// shifted copies of it.
//
// In uint32 the window equals the recurrence h_i = (h_{i-1} << 1) ^ G[x_i]
// with h_{-1} = 0, because the 32nd shift falls off the word. So a thread
// takes a run of 32 consecutive positions, warms h up over the 31 bytes
// before its run, and emits 32 hashes: 63 lookups for 32 outputs instead
// of the window form's 32 gathers per output.
//
// Bound: memory. The function reads n bytes and writes 4n; its lookups and
// XORs come to about three integer operations per position, far under the
// memory time. So the design keeps the traffic to one read of the input and
// one coalesced write of the output:
//   - the 1 KiB gear table is in shared memory;
//   - a block of 128 threads covers a tile of 4096 positions and stages the
//     tile's bytes (with the 32 bytes before it) in shared memory as words,
//     one pad word after every 32, so the 32 threads of a warp, which read
//     words 8 apart, hit 32 different banks;
//   - hashes go to a shared (128 x 33) word tile and leave it in position
//     order, each warp storing 128 contiguous bytes.
// The kernel takes n and masks the ragged tail; nothing is padded.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 32;                     // positions per thread
constexpr int kTile = kThreads * kRun;       // positions per tile
constexpr int kInWords = (kTile + 32) / 4;   // the tile's bytes and the 32 before it
constexpr int kInPadded = kInWords + kInWords / 32 + 1;

__device__ __forceinline__ int padded(int w) { return w + (w >> 5); }

__global__ void __launch_bounds__(kThreads)
gear_hash_kernel(const uint8_t* __restrict__ x, long long n, const uint32_t* __restrict__ gear,
                 uint32_t* __restrict__ out, int aligned) {
    __shared__ uint32_t g[256];
    __shared__ uint32_t in[kInPadded];
    __shared__ uint32_t o[kThreads * 33];
    for (int k = threadIdx.x; k < 256; k += kThreads) g[k] = gear[k];

    const long long tiles = (n + kTile - 1) / kTile;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long base = tile * kTile;
        __syncthreads();  // the previous tile's words and hashes are consumed
        // in word w holds bytes base - 32 + 4w .. +3 (zero outside [0, n))
        if (aligned && base >= 32 && base + kTile <= n) {
            const uint32_t* src = reinterpret_cast<const uint32_t*>(x + base - 32);
            for (int w = threadIdx.x; w < kInWords; w += kThreads) in[padded(w)] = src[w];
        } else {
            for (int w = threadIdx.x; w < kInWords; w += kThreads) {
                uint32_t v = 0;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const long long p = base - 32 + 4 * w + q;
                    if (p >= 0 && p < n) v |= (uint32_t)x[p] << (8 * q);
                }
                in[padded(w)] = v;
            }
        }
        __syncthreads();

        // this thread: positions p0 .. p0+31, bytes p0-31 .. p0+31, which are
        // bytes 1..63 of words 8t .. 8t+15
        const long long p0 = base + (long long)threadIdx.x * kRun;
        uint32_t w[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) w[q] = in[padded(threadIdx.x * 8 + q)];
        uint32_t h = 0;
#pragma unroll
        for (int k = 1; k < 64; ++k) {
            const uint32_t byte = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
            if (k < 32) {
                if (p0 - 32 + k >= 0) h = (h << 1) ^ g[byte];  // warm-up
            } else {
                h = (h << 1) ^ g[byte];
                o[threadIdx.x * 33 + (k - 32)] = h;
            }
        }
        __syncthreads();
        for (int j = threadIdx.x; j < kTile; j += kThreads) {
            const long long p = base + j;
            if (p < n) out[p] = o[(j >> 5) * 33 + (j & 31)];
        }
    }
}

}  // namespace

extern "C" int gear_hash(const void* x, long long n, const void* gear, void* out, void* stream) {
    if (n <= 0) return 0;
    const int aligned = ((uintptr_t)x % 4) == 0;
    long long blocks = (n + kTile - 1) / kTile;
    if (blocks > 132LL * 8) blocks = 132LL * 8;  // 8 blocks per SM, then stride over tiles
    gear_hash_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, n, (const uint32_t*)gear, (uint32_t*)out, aligned);
    return (int)cudaGetLastError();
}
