// Q-gram signature filters for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_filter_kernel` / `filter_qgram` and
// `_bank_kernel` / `bank_prefilter` of src/repro/kernels/filter_qgram.py.
// Same contracts, uint32 words:
//
//   filter_qgram    sigs (R, Wb), qsig (1, Wb), slack  ->  out (R, 1) int32
//                   out[r] = popcount(qsig & ~sigs[r]) <= slack
//   bank_prefilter  psig (Q, Wb), dsig (D, Wb), slacks (Q, 1) int32
//                   ->  out (Q, 1) int32
//                   out[p] = exists d: popcount(psig[p] & ~dsig[d]) <= slacks[p]
//
// R and Q are multiples of ROW_TILE (128); a negative slack never passes.
// The TPU kernels inline the SWAR adder tree of `popcount_words`; here
// each word is one `__popc`.  The TPU compiles one filter per static
// slack; here the slack is a runtime argument.
//
// What bounds them on this card:
//  * filter_qgram: bytes.  Per row it reads Wb words and writes one int32
//    (36 B at Wb = 8) and issues Wb popcounts + 2 Wb logic ops; at the
//    chr1 shape (620,928 rows) that is 22.4 MB, ~6.7 us at 3.35 TB/s,
//    while the popcounts alone take ~1.2 us at the card's popcount rate.
//    Design: one thread per row, the row's words as 16-byte vector loads
//    (neighbouring threads read neighbouring 32-byte rows, so a warp's
//    loads are contiguous), the query signature through the read-only
//    cache (every thread reads the same words: one broadcast).  At this
//    size the launch itself (several us) is comparable to the bound.
//  * bank_prefilter: popcount issue.  The work is Q x D x Wb popcounts
//    on Q x Wb + D x Wb input words; at Q = 4,096, D = 256, Wb = 8 that
//    is 8.4 M popcounts on 45 KB, but a pattern stops at its first
//    admitting doc, so what a batch needs depends on its data.  Design:
//    LPG lanes per pattern (a group; 128 / LPG patterns per 128-thread
//    block, so 4,096 patterns are 1,024 blocks at LPG = 32), the pattern's
//    signature and slack in each lane's registers; the block stages the
//    doc signatures in shared memory once (8 KB at D = 256, Wb = 8; rows
//    padded to WBT words and read as 16-byte vectors), and the lanes of
//    a group test docs d0 + lane, d0 + LPG + lane, ...; after each step a
//    warp ballot tells every group whether one of its lanes admitted,
//    the group stops, the warp stops once all its groups have, and the
//    block stops loading doc tiles once all its warps have.
//    The bank kernel's templates live in bank_prefilter.cuh;
//    match_swar_variants.cu launches other LPG for timing.

#include <cstdint>
#include <cuda_runtime.h>

#include "bank_prefilter.cuh"

namespace {

constexpr int ROW_TILE = 128;        // rows per filter block

template <bool VEC>
__global__ void __launch_bounds__(ROW_TILE)
filter_kernel(const uint32_t* __restrict__ sigs,
              const uint32_t* __restrict__ qsig, int wb, int slack,
              int32_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  const uint32_t* s = sigs + row * wb;
  int absent = 0;
  if constexpr (VEC) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    const uint4* q4 = reinterpret_cast<const uint4*>(qsig);
    for (int j = 0; j < wb / 4; ++j) {
      const uint4 a = s4[j];
      const uint4 q = __ldg(q4 + j);
      absent += __popc(q.x & ~a.x) + __popc(q.y & ~a.y) +
                __popc(q.z & ~a.z) + __popc(q.w & ~a.w);
    }
  } else {
    for (int j = 0; j < wb; ++j) absent += __popc(__ldg(qsig + j) & ~s[j]);
  }
  out[row] = absent <= slack ? 1 : 0;
}

}  // namespace

extern "C" {

int filter_qgram_launch(const void* sigs, long long R, int wb,
                        const void* qsig, int slack, void* out,
                        void* stream) {
  if (R <= 0 || R % ROW_TILE || wb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = wb % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(sigs) |
                    reinterpret_cast<uintptr_t>(qsig)) % 16 == 0;
  const unsigned grid = (unsigned)(R / ROW_TILE);
  const uint32_t* sp = static_cast<const uint32_t*>(sigs);
  const uint32_t* qp = static_cast<const uint32_t*>(qsig);
  int32_t* op = static_cast<int32_t*>(out);
  if (vec)
    filter_kernel<true><<<grid, ROW_TILE, 0, s>>>(sp, qp, wb, slack, op);
  else
    filter_kernel<false><<<grid, ROW_TILE, 0, s>>>(sp, qp, wb, slack, op);
  return (int)cudaGetLastError();
}

int bank_prefilter_launch(const void* psig, long long Q, int wb,
                          const void* dsig, int D, const void* slacks,
                          void* out, void* stream) {
  if (int e = bank::bank_check(Q, wb, D)) return e;
  return bank::bank_lpg<bank::BANK_LPG>(psig, Q, wb, dsig, D, slacks, out,
                                        static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
