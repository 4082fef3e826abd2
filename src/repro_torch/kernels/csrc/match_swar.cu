// SWAR bit-parallel sliding string match for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_swar_kernel` / `match_swar` and
// `_swar_masks_kernel` / `match_swar_masks` of
// src/repro/kernels/match_swar.py, and the merger's argmax / max that
// follow `match_swar` for the best and top-k reductions.  uint32 words:
//
//   ref    (R, W)        16 two-bit chars per word, >= 1 zero look-ahead word
//   pat    (R, NP*wp)    pattern words (NP = 1), or four bit-planes
//                        (NP = 4, plane c in words [c*wp, (c+1)*wp)); the
//                        row stride may be 0 (one pattern broadcast to all)
//   valid  (1, wp)       low bit of every valid pattern lane
//
// The exact predicate runs one mainloop with two epilogues:
//   STORE  out (R, L) int32 = P - mismatches per alignment (the TPU
//          kernel's contract; threshold, full and verify read it);
//   BEST   best_score (R,) int32 = max over l < L of the score, best_loc
//          (R,) int32 = the first l attaining it (argmax semantics).
// The accept-set predicate (`match_swar_masks`) keeps its own loop.
//
// What bounds it on this card: instruction throughput, not bytes.  Per
// (row, alignment, pattern word) the exact test is a funnel shift, an
// xor, a shift and a fold-and-mask (LOP3), then one popcount, which runs
// at a quarter of the INT32 rate.  At the main path's shape (F = 500,
// P = 100: W = 33, wp = 7, L = 401) the INT32 ops and the popcounts each
// outlast the row read (and STORE's (R, L) int32 write) over HBM.
//
// What the exact mainloop does about it:
//  * register window: a thread owns a work item (row, g), the 16
//    alignments 16g + s that share the words seg[g .. g + wp].  It loads
//    those wp + 1 words once from the staged row and shifts them by the
//    compile-time amounts 2s (`__funnelshift_r`, which takes no high word
//    at s = 0), so a word-alignment costs ~1/16 of a shared load instead
//    of two, and the loads leave the popcounts' issue queue;
//  * rows fastest: thread t owns row t % rb of the block's rb rows and
//    walks groups t / rb, t / rb + 256 / rb, ...; a warp holds 32 rows at
//    one group, so the ragged last group idles no lanes of a busy warp
//    and shared reads at the odd row stride hit 32 banks;
//  * pairs of pattern words: a word's mismatching lanes are flagged at
//    the odd bit of each lane, (d | d << 1) & valid << 1 (the shift runs
//    on the FMA pipe as an IMAD), the next word's at the even bit,
//    (d | d >> 1) & valid, and the two are added (disjoint bits, so the
//    add is an OR that can also issue as an IMAD), so one `__popc` counts
//    both: half the quarter-rate popcounts for half an INT32 op a word;
//  * BEST keeps the reduction on chip: the accumulators start at s and
//    add 16 x popcount, so the minimum of the 16 keys is the fewest
//    mismatches at the first alignment with them; a thread folds its
//    groups in ascending order, the block takes the minimum of the
//    threads' (mismatches, loc) keys per row in shared memory, and only
//    the (R,) pairs reach HBM;
//  * STORE starts the accumulators at P and subtracts, stages the block's
//    (rb, L) scores in shared memory (odd row stride: no bank conflicts)
//    and writes each row as consecutive words, a warp per row;
//  * patterns up to 16 words (P <= 256) sit in registers (template WPT,
//    unrolled); wider ones take the WPT = 0 instantiation that reads them
//    from shared memory.
// The mainloop's templates live in swar_exact.cuh; this file instantiates
// the shipped design only.  match_swar_variants.cu instantiates each
// design choice undone, for `python -m
// repro_torch.kernels.match_swar_variants`.

#include <cstdint>
#include <cuda_runtime.h>

#include "swar_exact.cuh"

namespace {

using namespace swar;

template <int WPT, int EPI>
int exact_ship(const ExactArgs& a, cudaStream_t s) {
  const bool wide = WPT == 0, best = EPI == BEST;
  const int rb = pick_rb(a.W, a.wp, a.n_locs, wide, best, SHIP_STAGE);
  if (rb)
    return exact_go<WPT, EPI, SHIP_WINDOW, SHIP_PAIR, SHIP_STAGE>(a, rb, s);
  if constexpr (EPI == STORE && SHIP_STAGE) {
    // Rows too long to stage their scores: each thread stores its own.
    const int rb_direct = pick_rb(a.W, a.wp, a.n_locs, wide, false, false);
    if (rb_direct)
      return exact_go<WPT, STORE, SHIP_WINDOW, SHIP_PAIR, false>(
          a, rb_direct, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int EPI>
int exact_launch(const ExactArgs& a, void* stream) {
  if (int e = exact_check(a)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.wp <= 1) return exact_ship<1, EPI>(a, s);
  if (a.wp <= 2) return exact_ship<2, EPI>(a, s);
  if (a.wp <= 4) return exact_ship<4, EPI>(a, s);
  if (a.wp <= 8) return exact_ship<8, EPI>(a, s);
  if (a.wp <= 16) return exact_ship<16, EPI>(a, s);
  return exact_ship<0, EPI>(a, s);
}

// -- accept-set predicate -----------------------------------------------------

constexpr int ROW_TILE = 8;  // rows per block (the Pallas row tile)

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

// One block = ROW_TILE rows, one warp per row, the rows staged in shared
// memory; lanes run across alignments (coalesced int32 stores); the four
// planes and the valid mask in registers (WPT >= wp) or, for WPT = 0, in
// shared memory.  Each alignment funnel-shifts its window words out of
// the staged row.
template <int WPT>
__global__ void __launch_bounds__(ROW_TILE * WARP)
swar_masks_kernel(const uint32_t* __restrict__ ref, int W,
                  const uint32_t* __restrict__ pat, long long pat_stride,
                  const uint32_t* __restrict__ valid, int wp, int n_locs,
                  int pattern_chars, int32_t* __restrict__ out) {
  constexpr int NP = 4;
  extern __shared__ uint32_t masks_smem[];
  uint32_t* rows_s = masks_smem;                        // ROW_TILE * W
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
          mism += __popc(mism_masks(win, pr[j], pr[WPT + j], pr[2 * WPT + j],
                                    pr[3 * WPT + j], vm[j]));
        }
      }
    } else {
      const uint32_t* ps = pat_s + rl * NP * wp;
      for (int j = 0; j < wp; ++j) {
        const uint32_t win = __funnelshift_r(seg[base + j], seg[base + j + 1], sh);
        mism += __popc(mism_masks(win, ps[j], ps[wp + j], ps[2 * wp + j],
                                  ps[3 * wp + j], val_s[j]));
      }
    }
    orow[loc] = pattern_chars - mism;
  }
}

template <int WPT>
int masks_go(const void* ref, long long R, int W, const void* pat,
             long long pat_stride, const void* valid, int wp, int n_locs,
             int pattern_chars, void* out, cudaStream_t stream) {
  constexpr int NP = 4;
  size_t smem = sizeof(uint32_t) * (size_t)ROW_TILE * W;
  if (WPT == 0) smem += sizeof(uint32_t) * ((size_t)ROW_TILE * NP * wp + wp);
  auto kern = swar_masks_kernel<WPT>;
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

}  // namespace

extern "C" {

int match_swar_launch(const void* ref, long long R, int W, const void* pat,
                      long long pat_stride, const void* valid, int wp,
                      int n_locs, int pattern_chars, void* out, void* stream) {
  const ExactArgs a{ref, R, W, pat, pat_stride, valid, wp, n_locs,
                    pattern_chars, out, nullptr, nullptr};
  return exact_launch<STORE>(a, stream);
}

int match_swar_best_launch(const void* ref, long long R, int W,
                           const void* pat, long long pat_stride,
                           const void* valid, int wp, int n_locs,
                           int pattern_chars, void* best_loc,
                           void* best_score, void* stream) {
  const ExactArgs a{ref, R, W, pat, pat_stride, valid, wp, n_locs,
                    pattern_chars, nullptr, best_loc, best_score};
  return exact_launch<BEST>(a, stream);
}

int match_swar_masks_launch(const void* ref, long long R, int W,
                            const void* planes, long long plane_stride,
                            const void* valid, int wp, int n_locs,
                            int pattern_chars, void* out, void* stream) {
  if (R <= 0 || R % ROW_TILE || wp < 1 || n_locs < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SWAR_GO(N) \
  return masks_go<N>(ref, R, W, planes, plane_stride, valid, wp, n_locs, pattern_chars, out, s)
  if (wp <= 1) REPRO_SWAR_GO(1);
  if (wp <= 2) REPRO_SWAR_GO(2);
  if (wp <= 4) REPRO_SWAR_GO(4);
  if (wp <= 8) REPRO_SWAR_GO(8);
  if (wp <= 16) REPRO_SWAR_GO(16);
  REPRO_SWAR_GO(0);
#undef REPRO_SWAR_GO
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
