// The exact-predicate SWAR mainloop for Hopper (sm_90a), with its STORE
// and BEST epilogues: the templates that `match_swar.cu` instantiates in
// its shipped design and `match_swar_variants.cu` with each design choice
// undone.  The design and what bounds it are described in match_swar.cu.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace swar {

constexpr int WARP = 32;
constexpr uint32_t M1 = 0x55555555u;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block can use

// -- exact predicate: one mainloop, STORE and BEST epilogues -----------------

constexpr int NT = 256;    // threads per block
constexpr int GROUP = 16;  // alignments per work item: the 16 shifts of a word
enum Epi { STORE = 0, BEST = 1 };
// The shipped design (what `match_swar_launch` / `match_swar_best_launch`
// run): register window, word pairs, staged STORE rows.
constexpr bool SHIP_WINDOW = true;
constexpr bool SHIP_PAIR = true;
constexpr bool SHIP_STAGE = true;

// Mismatching lanes flagged at the odd (resp. even) bit of each lane.
__device__ __forceinline__ uint32_t lanes_odd(uint32_t d, uint32_t vo) {
  return (d | (d << 1)) & vo;
}
__device__ __forceinline__ uint32_t lanes_even(uint32_t d, uint32_t ve) {
  return (d | (d >> 1)) & ve;
}

// The 16 alignments of one pattern word (TWO: of two) against the window
// words a0, a1 (, a2).  acc[s] += STEP * mismatches.  RELOAD reads the
// window from shared memory again for every alignment (the variant
// without the register window).
template <bool TWO, bool RELOAD, int STEP>
__device__ __forceinline__ void step16(const uint32_t* seg, uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t p0,
                                       uint32_t p1, uint32_t vo0, uint32_t ve1,
                                       int (&acc)[GROUP]) {
  const volatile uint32_t* vseg = seg;
#pragma unroll
  for (int s = 0; s < GROUP; ++s) {
    if (RELOAD) {
      a0 = vseg[0];
      a1 = vseg[1];
      if (TWO) a2 = vseg[2];
    }
    uint32_t e = lanes_odd(__funnelshift_r(a0, a1, 2 * s) ^ p0, vo0);
    if (TWO) e += lanes_even(__funnelshift_r(a1, a2, 2 * s) ^ p1, ve1);
    acc[s] += STEP * __popc(e);
  }
}

// Patterns in registers (WPT >= wp words, zero beyond): seg points at the
// work item's first word in the staged row.
template <int WPT, bool WINDOW, bool PAIR, int STEP>
__device__ __forceinline__ void group_regs(const uint32_t* seg, int wp,
                                           const uint32_t (&pr)[WPT + 1],
                                           const uint32_t (&vm)[WPT + 1],
                                           int (&acc)[GROUP]) {
  uint32_t w[WPT + 2];
#pragma unroll
  for (int j = 0; j < WPT + 2; ++j) w[j] = WINDOW && j <= wp ? seg[j] : 0u;
#pragma unroll
  for (int j = 0; j < WPT; j += PAIR ? 2 : 1) {
    if (j < wp) {
      if (PAIR && j + 1 < wp)
        step16<true, !WINDOW, STEP>(seg + j, w[j], w[j + 1], w[j + 2], pr[j],
                                    pr[j + 1], vm[j] << 1, vm[j + 1], acc);
      else
        step16<false, !WINDOW, STEP>(seg + j, w[j], w[j + 1], 0u, pr[j], 0u,
                                     vm[j] << 1, 0u, acc);
    }
  }
}

// Patterns wider than 16 words, read from shared memory (ps, vs).
template <bool PAIR, int STEP>
__device__ __forceinline__ void group_wide(const uint32_t* seg,
                                           const uint32_t* ps,
                                           const uint32_t* vs, int wp,
                                           int (&acc)[GROUP]) {
  for (int j = 0; j < wp; j += PAIR ? 2 : 1) {
    if (PAIR && j + 1 < wp)
      step16<true, false, STEP>(seg + j, seg[j], seg[j + 1], seg[j + 2],
                                ps[j], ps[j + 1], vs[j] << 1, vs[j + 1], acc);
    else
      step16<false, false, STEP>(seg + j, seg[j], seg[j + 1], 0u, ps[j], 0u,
                                 vs[j] << 1, 0u, acc);
  }
}

// Shared memory of one block, in 32-bit words: BEST's (NT,) u64 keys
// first (8-byte aligned), the staged rows (stride ws), the wide path's
// patterns (stride wps) and valid mask, STORE's staged scores (stride ls).
struct Layout {
  int rb, ws, wps, ls;
  size_t rows, pat, val, out, words;
};

__host__ __device__ inline Layout layout(int rb, int W, int wp, int n_locs,
                                         bool wide, bool best, bool stage) {
  Layout y;
  y.rb = rb;
  y.ws = W | 1;
  y.wps = wp | 1;
  y.ls = n_locs | 1;
  y.rows = best ? 2 * NT : 0;
  y.pat = y.rows + (size_t)rb * y.ws;
  y.val = y.pat + (wide ? (size_t)rb * y.wps : 0);
  y.out = y.val + (wide ? wp : 0);
  y.words = y.out + (!best && stage ? (size_t)rb * y.ls : 0);
  return y;
}

template <int WPT, int EPI, bool WINDOW, bool PAIR, bool STAGE>
__global__ void __launch_bounds__(NT)
swar_exact_kernel(const uint32_t* __restrict__ ref, long long R, int W,
                  const uint32_t* __restrict__ pat, long long pat_stride,
                  const uint32_t* __restrict__ valid, int wp, int n_locs,
                  int pattern_chars, int rb, int32_t* __restrict__ out,
                  int32_t* __restrict__ best_loc,
                  int32_t* __restrict__ best_score) {
  constexpr bool WIDE = WPT == 0;
  constexpr int STEP = EPI == BEST ? GROUP : -1;
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout y = layout(rb, W, wp, n_locs, WIDE, EPI == BEST, STAGE);
  uint32_t* rows_s = smem + y.rows;
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * rb;
  const int nrows = (int)min((long long)rb, R - row0);

  const uint32_t* src = ref + row0 * W;
  for (int i = tid; i < nrows * W; i += NT) {
    const int r = i / W;
    rows_s[r * y.ws + (i - r * W)] = src[i];
  }
  const int r = tid % rb;
  const bool live = r < nrows;
  const long long row = row0 + r;
  constexpr int NR = WIDE ? 0 : WPT;
  uint32_t pr[NR + 1], vm[NR + 1];
  if constexpr (WIDE) {
    uint32_t* pat_s = smem + y.pat;
    for (int i = tid; i < nrows * wp; i += NT) {
      const int rr = i / wp, j = i - rr * wp;
      pat_s[rr * y.wps + j] = pat[(row0 + rr) * pat_stride + j];
    }
    for (int j = tid; j < wp; j += NT) smem[y.val + j] = valid[j] & M1;
  } else {
#pragma unroll
    for (int j = 0; j <= WPT; ++j) {
      pr[j] = live && j < wp ? pat[row * pat_stride + j] : 0u;
      vm[j] = j < wp ? valid[j] & M1 : 0u;
    }
  }
  __syncthreads();

  const int n_groups = (n_locs + GROUP - 1) / GROUP;
  unsigned long long best = ~0ull;  // (mismatches << 32 | loc): least wins
  int32_t* out_s = reinterpret_cast<int32_t*>(smem + y.out);
  if (live) {
    const uint32_t* seg = rows_s + r * y.ws;
    for (int g = tid / rb; g < n_groups; g += NT / rb) {
      int acc[GROUP];
#pragma unroll
      for (int s = 0; s < GROUP; ++s) acc[s] = EPI == BEST ? s : pattern_chars;
      if constexpr (WIDE)
        group_wide<PAIR, STEP>(seg + g, smem + y.pat + r * y.wps,
                               smem + y.val, wp, acc);
      else
        group_regs<WPT, WINDOW, PAIR, STEP>(seg + g, wp, pr, vm, acc);
      const int l0 = g * GROUP;
      const int n = min(GROUP, n_locs - l0);
      if constexpr (EPI == BEST) {
        // acc[s] = 16 * mismatches + s: the smallest is the first best.
        int k = acc[0];
#pragma unroll
        for (int s = 1; s < GROUP; ++s)
          if (s < n) k = min(k, acc[s]);
        const unsigned long long key =
            ((unsigned long long)(uint32_t)(k >> 4) << 32) |
            (uint32_t)(l0 + (k & 15));
        best = min(best, key);
      } else {
#pragma unroll
        for (int s = 0; s < GROUP; ++s) {
          if (s < n) {
            if (STAGE)
              out_s[r * y.ls + l0 + s] = acc[s];
            else
              out[row * n_locs + l0 + s] = acc[s];
          }
        }
      }
    }
  }

  if constexpr (EPI == BEST) {
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
    keys[tid] = best;
    __syncthreads();
    if (tid < nrows) {
      unsigned long long b = keys[tid];
      for (int t = tid + rb; t < NT; t += rb) b = min(b, keys[t]);
      best_score[row0 + tid] = pattern_chars - (int)(b >> 32);
      best_loc[row0 + tid] = (int)(uint32_t)b;
    }
  } else if constexpr (STAGE) {
    __syncthreads();
    const int lane = tid % WARP;
    for (int rr = tid / WARP; rr < nrows; rr += NT / WARP) {
      int32_t* orow = out + (row0 + rr) * n_locs;
      for (int c = lane; c < n_locs; c += WARP) orow[c] = out_s[rr * y.ls + c];
    }
  }
}

// Rows per block: the most of 32, 16, 8 whose shared memory fits; 0 if
// none does.
int pick_rb(int W, int wp, int n_locs, bool wide, bool best, bool stage) {
  for (int rb = 32; rb >= 8; rb /= 2)
    if (layout(rb, W, wp, n_locs, wide, best, stage).words * 4 <= MAX_SMEM)
      return rb;
  return 0;
}

struct ExactArgs {
  const void* ref;
  long long R;
  int W;
  const void* pat;
  long long pat_stride;
  const void* valid;
  int wp, n_locs, pattern_chars;
  void *out, *best_loc, *best_score;
};

template <int WPT, int EPI, bool WINDOW, bool PAIR, bool STAGE>
int exact_go(const ExactArgs& a, int rb, cudaStream_t s) {
  const size_t smem = layout(rb, a.W, a.wp, a.n_locs, WPT == 0, EPI == BEST,
                             STAGE).words * 4;
  auto kern = swar_exact_kernel<WPT, EPI, WINDOW, PAIR, STAGE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((a.R + rb - 1) / rb);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const uint32_t*>(a.ref), a.R, a.W,
      static_cast<const uint32_t*>(a.pat), a.pat_stride,
      static_cast<const uint32_t*>(a.valid), a.wp, a.n_locs, a.pattern_chars,
      rb, static_cast<int32_t*>(a.out), static_cast<int32_t*>(a.best_loc),
      static_cast<int32_t*>(a.best_score));
  return (int)cudaGetLastError();
}

int exact_check(const ExactArgs& a) {
  const bool ok = a.R > 0 && a.wp >= 1 && a.n_locs >= 1 &&
                  a.W >= (a.n_locs - 1) / GROUP + a.wp + 1;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace swar
}  // namespace
