// Bulk per-row popcount for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_popcount_kernel` / `popcount` of
// src/repro/kernels/popcount.py: (N, W) uint32 words -> (N, 1) int32
// per-row bit counts, N a multiple of N_TILE (256).  The TPU kernel's
// SWAR adder tree (the CRAM-PM Fig. 4b reduction) is one `__popc` per
// word here.
//
// What bounds it on this card: bytes.  Per row it reads W words and
// writes one int32; at the SWAR form of chr1 (620,928 x 33 words) that
// is 82 MB, ~25 us at 3.35 TB/s, against 20.5 M popcounts (~3 us).
// Design: one warp per row, lanes striding over the row's words (a
// warp's loads are one contiguous segment), a shuffle sum, one store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int ROWS_PER_BLOCK = 8;

__global__ void __launch_bounds__(ROWS_PER_BLOCK * WARP)
popcount_kernel(const uint32_t* __restrict__ words, int W,
                int32_t* __restrict__ out) {
  const int lane = threadIdx.x % WARP;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / WARP;
  const uint32_t* r = words + row * W;
  int c = 0;
  for (int j = lane; j < W; j += WARP) c += __popc(r[j]);
#pragma unroll
  for (int off = WARP / 2; off; off /= 2) c += __shfl_down_sync(0xffffffffu, c, off);
  if (lane == 0) out[row] = c;
}

}  // namespace

extern "C" {

int popcount_launch(const void* words, long long N, int W, void* out,
                    void* stream) {
  if (N <= 0 || N % ROWS_PER_BLOCK || W < 1) return (int)cudaErrorInvalidValue;
  popcount_kernel<<<(unsigned)(N / ROWS_PER_BLOCK), ROWS_PER_BLOCK * WARP, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), W, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
