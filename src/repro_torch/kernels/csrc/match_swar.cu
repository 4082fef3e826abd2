// SWAR bit-parallel sliding string match for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_swar_kernel` / `match_swar` and
// `_swar_masks_kernel` / `match_swar_masks` of
// src/repro/kernels/match_swar.py.  Same contract, uint32 words:
//
//   ref    (R, W)        16 two-bit chars per word, >= 1 zero look-ahead word
//   pat    (R, NP*wp)    pattern words (NP = 1), or four bit-planes
//                        (NP = 4, plane c in words [c*wp, (c+1)*wp)); the
//                        row stride may be 0 (one pattern broadcast to all)
//   valid  (1, wp)       low bit of every valid pattern lane
//   out    (R, L) int32  P - mismatches per alignment
//
// What bounds it on this card: instruction throughput, not bytes.  Per
// (row, alignment, pattern word) the compiled loop issues two shared
// loads, four INT32 logic/shift ops (funnel shift, xor, shift,
// fold-and-mask; eleven for the bit-plane variant), one popcount, which
// runs at a quarter of the INT32 rate, and one add (an IMAD on the FMA
// pipe).  At the main path's shape (F = 500, P = 100: W = 33, wp = 7,
// L = 401) the INT32 ops and the popcounts each outlast the row read
// plus the (R, L) int32 store over HBM bandwidth; the shared loads and
// the popcounts share one issue queue.
//
// What the design does about it:
//  * one block = ROW_TILE rows, one warp per row; the block stages its
//    rows' words in shared memory once (the row is read from HBM once);
//  * lanes run across alignments, so the int32 stores of a warp are 32
//    consecutive words (coalesced);
//  * the pattern words, planes and valid mask sit in registers
//    (template WPT >= wp, fully unrolled) -- patterns wider than 16
//    words (P > 256) take the WPT = 0 instantiation that reads them from
//    shared memory;
//  * the window word is one `__funnelshift_r`, which handles shift 0
//    natively (the TPU kernel guards `x << 32` with a select), and the
//    count is one `__popc` per word instead of the TPU's SWAR adder tree
//    (`mism` has at most one bit per 2-bit lane, so the counts agree).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROW_TILE = 8;  // rows per block (the Pallas row tile)
constexpr int WARP = 32;
constexpr uint32_t M1 = 0x55555555u;

__device__ __forceinline__ uint32_t mism_exact(uint32_t win, uint32_t p,
                                               uint32_t valid) {
  const uint32_t d = win ^ p;
  return (d | (d >> 1)) & M1 & valid;
}

// A lane matches when its code c is accepted by plane c at that position.
__device__ __forceinline__ uint32_t mism_masks(uint32_t win, uint32_t p0,
                                               uint32_t p1, uint32_t p2,
                                               uint32_t p3, uint32_t valid) {
  uint32_t d = win;                         // code 0: lanes 00
  uint32_t acc = ~(d | (d >> 1)) & M1 & p0;
  d = win ^ 0x55555555u;                    // code 1: lanes 01
  acc |= ~(d | (d >> 1)) & M1 & p1;
  d = win ^ 0xAAAAAAAAu;                    // code 2: lanes 10
  acc |= ~(d | (d >> 1)) & M1 & p2;
  d = ~win;                                 // code 3: lanes 11
  acc |= ~(d | (d >> 1)) & M1 & p3;
  return valid & ~acc;
}

template <int WPT, bool MASKS>
__global__ void __launch_bounds__(ROW_TILE * WARP)
swar_kernel(const uint32_t* __restrict__ ref, int W,
            const uint32_t* __restrict__ pat, long long pat_stride,
            const uint32_t* __restrict__ valid, int wp, int n_locs,
            int pattern_chars, int32_t* __restrict__ out) {
  constexpr int NP = MASKS ? 4 : 1;
  extern __shared__ uint32_t smem[];
  uint32_t* rows_s = smem;                              // ROW_TILE * W
  const int lane = threadIdx.x;
  const int rl = threadIdx.y;
  const int tid = rl * WARP + lane;
  const long long row0 = (long long)blockIdx.x * ROW_TILE;
  const long long row = row0 + rl;

  const uint32_t* src = ref + row0 * W;
  for (int i = tid; i < ROW_TILE * W; i += ROW_TILE * WARP) rows_s[i] = src[i];

  const uint32_t* prow = pat + row * pat_stride;
  constexpr int NR = WPT > 0 ? WPT : 1;
  uint32_t pr[NP * NR];
  uint32_t vm[NR];
  uint32_t* pat_s = rows_s + ROW_TILE * W;              // WPT == 0 only
  uint32_t* val_s = pat_s + ROW_TILE * NP * wp;
  if constexpr (WPT > 0) {
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      vm[j] = j < wp ? valid[j] : 0u;
#pragma unroll
      for (int c = 0; c < NP; ++c) pr[c * WPT + j] = j < wp ? prow[c * wp + j] : 0u;
    }
  } else {
    for (int i = lane; i < NP * wp; i += WARP) pat_s[rl * NP * wp + i] = prow[i];
    if (rl == 0)
      for (int i = lane; i < wp; i += WARP) val_s[i] = valid[i];
  }
  __syncthreads();

  const uint32_t* seg = rows_s + rl * W;
  int32_t* orow = out + row * n_locs;
  for (int loc = lane; loc < n_locs; loc += WARP) {
    const int base = loc >> 4;
    const unsigned sh = (unsigned)(loc & 15) * 2u;
    int mism = 0;
    if constexpr (WPT > 0) {
#pragma unroll
      for (int j = 0; j < WPT; ++j) {
        if (j < wp) {
          const uint32_t win = __funnelshift_r(seg[base + j], seg[base + j + 1], sh);
          if constexpr (MASKS)
            mism += __popc(mism_masks(win, pr[j], pr[WPT + j], pr[2 * WPT + j],
                                      pr[3 * WPT + j], vm[j]));
          else
            mism += __popc(mism_exact(win, pr[j], vm[j]));
        }
      }
    } else {
      const uint32_t* ps = pat_s + rl * NP * wp;
      for (int j = 0; j < wp; ++j) {
        const uint32_t win = __funnelshift_r(seg[base + j], seg[base + j + 1], sh);
        if constexpr (MASKS)
          mism += __popc(mism_masks(win, ps[j], ps[wp + j], ps[2 * wp + j],
                                    ps[3 * wp + j], val_s[j]));
        else
          mism += __popc(mism_exact(win, ps[j], val_s[j]));
      }
    }
    orow[loc] = pattern_chars - mism;
  }
}

template <int WPT, bool MASKS>
int launch_wpt(const void* ref, long long R, int W, const void* pat,
               long long pat_stride, const void* valid, int wp, int n_locs,
               int pattern_chars, void* out, cudaStream_t stream) {
  constexpr int NP = MASKS ? 4 : 1;
  size_t smem = sizeof(uint32_t) * (size_t)ROW_TILE * W;
  if (WPT == 0) smem += sizeof(uint32_t) * ((size_t)ROW_TILE * NP * wp + wp);
  auto kern = swar_kernel<WPT, MASKS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(WARP, ROW_TILE);
  const dim3 grid((unsigned)(R / ROW_TILE));
  kern<<<grid, block, smem, stream>>>(
      static_cast<const uint32_t*>(ref), W, static_cast<const uint32_t*>(pat),
      pat_stride, static_cast<const uint32_t*>(valid), wp, n_locs,
      pattern_chars, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

template <bool MASKS>
int launch(const void* ref, long long R, int W, const void* pat,
           long long pat_stride, const void* valid, int wp, int n_locs,
           int pattern_chars, void* out, void* stream_ptr) {
  if (R <= 0 || R % ROW_TILE || wp < 1 || n_locs < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define REPRO_SWAR_GO(N) \
  return launch_wpt<N, MASKS>(ref, R, W, pat, pat_stride, valid, wp, n_locs, pattern_chars, out, s)
  if (wp <= 1) REPRO_SWAR_GO(1);
  if (wp <= 2) REPRO_SWAR_GO(2);
  if (wp <= 4) REPRO_SWAR_GO(4);
  if (wp <= 8) REPRO_SWAR_GO(8);
  if (wp <= 16) REPRO_SWAR_GO(16);
  REPRO_SWAR_GO(0);
#undef REPRO_SWAR_GO
}

}  // namespace

extern "C" {

int match_swar_launch(const void* ref, long long R, int W, const void* pat,
                      long long pat_stride, const void* valid, int wp,
                      int n_locs, int pattern_chars, void* out, void* stream) {
  return launch<false>(ref, R, W, pat, pat_stride, valid, wp, n_locs,
                       pattern_chars, out, stream);
}

int match_swar_masks_launch(const void* ref, long long R, int W,
                            const void* planes, long long plane_stride,
                            const void* valid, int wp, int n_locs,
                            int pattern_chars, void* out, void* stream) {
  return launch<true>(ref, R, W, planes, plane_stride, valid, wp, n_locs,
                      pattern_chars, out, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
