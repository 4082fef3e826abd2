// Bulk per-row popcount for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_popcount_kernel` / `popcount` of
// src/repro/kernels/popcount.py: (N, W) uint32 words -> (N, 1) int32
// per-row bit counts.  The TPU kernel's SWAR adder tree (the CRAM-PM
// Fig. 4b reduction) is one `__popc` per word here.  The TPU grid needs
// whole 256-row tiles; this kernel takes any N >= 1 and W >= 1 and masks
// the ragged last tile itself, so callers pass their rows unpadded.
//
// What bounds it on this card: bytes.  It reads N * W * 4 bytes and
// writes N * 4 against N * W popcounts: at the SWAR form of chr1
// (620,840 x 33 words) 82.0 MB read and 2.5 MB written, ~25 us at 3.35
// TB/s, against 20.5 M popcounts (~3 us at 16 a clock per SM).
//
// What the design does about it: it keeps enough bytes in flight on every
// SM (at ~0.7 us of latency, 3.35 TB/s needs ~18 KB per SM).
//  * One block per tile of T rows, T a multiple of 4 (so a tile starts on
//    16 bytes for any W), sized by the wrapper so that a tile's T * W * 4
//    contiguous bytes stay within 32 KB: W = 33 gives T = 128 and 16.9 KB,
//    a dozen resident blocks and ~200 KB in flight on each SM.  A block a
//    tile, not a persistent one-wave grid: the block scheduler spreads the
//    traffic over the SMs to the end of the launch.
//  * One thread arms an mbarrier with the tile's byte count and issues a
//    single cp.async.bulk of the tile (the Tensor Memory Accelerator
//    computes the addresses; no thread spends registers or issue slots
//    on the copy); the block waits on the barrier.  The ragged last
//    tile's copy takes the largest multiple of 16 bytes, and its last 1-3
//    words are read with plain loads.
//  * G threads count a row (G = 1 up to W = 64; wider rows take 2-32, a
//    segmented shuffle sums them).  Each row's reads start at a per-row
//    rotation that puts the rows a warp reads at once on distinct banks:
//    at most 2-way bank conflicts for every W, where a plain stride of W
//    words would be 32-way at W = 32, 64, ...  One int32 store per row,
//    coalesced across the block.
//  * Rows too wide for a 4-row tile (W > 2048) stream the tile through the
//    32 KB buffer in chunks, one bulk copy each.
// Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int WARP = 32;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_SMEM = 48 * 1024;            // dynamic shared memory without opt-in
constexpr long long MAX_BLOCKS = 0x7fffffff;   // grid.x limit

// Where the row at `r` within its warp starts reading: the rows a warp
// reads at once begin on distinct banks.  W >= 32: row r's word q lies on
// bank r * G + q (mod 32) until the rotation wraps; W < 32 and even:
// rotate by the 32-word lines before the row; W odd: the stride alone
// spreads the rows.
__device__ __forceinline__ int rotation(int r, int W, int G) {
  if (W >= WARP) return (int)((unsigned)(r * (G - W)) & (WARP - 1));
  return W % 2 == 0 ? r * W / WARP : 0;
}

template <int G>
__global__ void __launch_bounds__(MAX_THREADS)
popcount_kernel(const uint32_t* __restrict__ words, long long N, int W,
                int chunk_words, int32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint32_t buf[];
  __shared__ __align__(8) uint64_t bar;
  const int tid = (int)threadIdx.x;
  const int T = (int)blockDim.x / G;
  const int r = tid / G, g = tid % G;
  const long long row0 = (long long)blockIdx.x * T;
  const int rows = (int)min((long long)T, N - row0);
  const long long tile_words = (long long)rows * W;
  const uint32_t* tile = words + row0 * W;
  // This thread's row, in words of the tile (empty past the last row).
  const long long r_lo = (long long)r * W, r_hi = r < rows ? r_lo + W : r_lo;
  const int rot = rotation((tid % WARP) / G, W, G);
  if (tid == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  int c = 0;
  uint32_t parity = 0;
  for (long long c0 = 0; c0 < tile_words; c0 += chunk_words) {
    const int n = (int)min((long long)chunk_words, tile_words - c0);
    const int n_bulk = n & ~3;   // whole 16-byte units
    if (c0) __syncthreads();     // every thread is done with the last chunk
    if (tid == 0 && n_bulk) {
      fence_proxy_async();
      mbar_expect_tx(&bar, (uint32_t)n_bulk * 4u);
      bulk_load(buf, tile + c0, (uint32_t)n_bulk * 4u, &bar);
    }
    if (tid < n - n_bulk) buf[n_bulk + tid] = tile[c0 + n_bulk + tid];
    if (n_bulk) {
      mbar_wait(&bar, parity);
      parity ^= 1u;
    }
    if (n != n_bulk) __syncthreads();   // the plain-loaded tail words
    const long long lo = max(r_lo, c0), hi = min(r_hi, c0 + n);
    if (lo < hi) {
      const int len = (int)(hi - lo);
      const uint32_t* seg = buf + (lo - c0);
      const int s = rot < len ? rot : rot % len;
#pragma unroll 4
      for (int q = g; q < len; q += G) {
        int p = q + s;
        if (p >= len) p -= len;
        c += __popc(seg[p]);
      }
    }
  }
#pragma unroll
  for (int off = G / 2; off; off /= 2) c += __shfl_down_sync(0xffffffffu, c, off);
  if (g == 0 && r < rows) out[row0 + r] = c;
}

}  // namespace

extern "C" {

// T rows a tile (T % 4 == 0), G threads a row (a power of two up to 32,
// T * G a whole number of warps), smem_bytes of staging buffer (a
// multiple of 16: the tile, or a chunk of it), grid = ceil(N / T) blocks.
// kernels/popcount.py::launch_geometry computes them.
int popcount_launch(const void* words, long long N, int W, int T, int G,
                    int smem_bytes, long long grid, void* out, void* stream) {
  const long long threads = (long long)T * G;
  if (N < 1 || W < 1 || T < 4 || T % 4 || G < 1 || G > WARP || (G & (G - 1)) ||
      threads > MAX_THREADS || threads % WARP || smem_bytes < 16 ||
      smem_bytes % 16 || smem_bytes > MAX_SMEM || grid != (N + T - 1) / T ||
      grid > MAX_BLOCKS || reinterpret_cast<uintptr_t>(words) % 16)
    return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<int32_t*>(out);
  const int chunk = smem_bytes / 4;
  const dim3 grd((unsigned)grid), blk((unsigned)threads);
  auto s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: popcount_kernel<1><<<grd, blk, smem_bytes, s>>>(w, N, W, chunk, o); break;
    case 2: popcount_kernel<2><<<grd, blk, smem_bytes, s>>>(w, N, W, chunk, o); break;
    case 4: popcount_kernel<4><<<grd, blk, smem_bytes, s>>>(w, N, W, chunk, o); break;
    case 8: popcount_kernel<8><<<grd, blk, smem_bytes, s>>>(w, N, W, chunk, o); break;
    case 16: popcount_kernel<16><<<grd, blk, smem_bytes, s>>>(w, N, W, chunk, o); break;
    default: popcount_kernel<32><<<grd, blk, smem_bytes, s>>>(w, N, W, chunk, o); break;
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
