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
//    is 8.4 M popcounts on 45 KB.  Design: one thread per pattern, its
//    signature and slack in registers; the block stages DOC_TILE doc
//    signatures in shared memory (8 KB at Wb = 8), which every thread of
//    the block reads at the same address (a broadcast, no bank
//    conflicts); a thread stops at its first admitting doc and the block
//    stops loading tiles once every thread has decided.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROW_TILE = 128;        // rows (patterns) per block
constexpr int DOC_TILE = 256;        // doc signatures staged per step
constexpr int SMEM_WORDS = 12288;    // 48 KB: the static shared-memory limit

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

// WBT > 0: the pattern signature lives in WBT registers (wb <= WBT, the
// rest zero); WBT == 0: it is read from global memory (wide signatures).
template <int WBT>
__global__ void __launch_bounds__(ROW_TILE)
bank_kernel(const uint32_t* __restrict__ psig,
            const uint32_t* __restrict__ dsig,
            const int32_t* __restrict__ slacks, int wb, int D, int doc_tile,
            int32_t* __restrict__ out) {
  extern __shared__ uint32_t d_s[];                  // doc_tile * wb
  const long long p = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  const int slack = slacks[p];
  const uint32_t* prow = psig + p * wb;
  constexpr int NR = WBT > 0 ? WBT : 1;
  uint32_t ps[NR];
  if constexpr (WBT > 0) {
#pragma unroll
    for (int j = 0; j < WBT; ++j) ps[j] = j < wb ? prow[j] : 0u;
  }
  bool found = false;
  bool done = slack < 0;                 // unsatisfiable or a pad row
  for (int d0 = 0; d0 < D; d0 += doc_tile) {
    // Also the barrier that protects the previous tile from this load.
    if (__syncthreads_and(done)) break;
    const int nd = min(doc_tile, D - d0);
    const uint32_t* src = dsig + (long long)d0 * wb;
    for (int i = threadIdx.x; i < nd * wb; i += ROW_TILE) d_s[i] = src[i];
    __syncthreads();
    if (done) continue;
    for (int d = 0; d < nd; ++d) {
      const uint32_t* ds = d_s + d * wb;
      int absent = 0;
      if constexpr (WBT > 0) {
#pragma unroll
        for (int j = 0; j < WBT; ++j)
          if (j < wb) absent += __popc(ps[j] & ~ds[j]);
      } else {
        for (int j = 0; j < wb; ++j) absent += __popc(__ldg(prow + j) & ~ds[j]);
      }
      if (absent <= slack) {
        found = true;
        done = true;
        break;
      }
    }
  }
  out[p] = found ? 1 : 0;
}

template <int WBT>
int bank_go(const void* psig, long long Q, int wb, const void* dsig, int D,
            const void* slacks, void* out, cudaStream_t s) {
  const int doc_tile = wb <= SMEM_WORDS / DOC_TILE ? DOC_TILE : SMEM_WORDS / wb;
  const size_t smem = sizeof(uint32_t) * (size_t)doc_tile * wb;
  bank_kernel<WBT><<<(unsigned)(Q / ROW_TILE), ROW_TILE, smem, s>>>(
      static_cast<const uint32_t*>(psig), static_cast<const uint32_t*>(dsig),
      static_cast<const int32_t*>(slacks), wb, D, doc_tile,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
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
  if (Q <= 0 || Q % ROW_TILE || wb < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wb <= 4) return bank_go<4>(psig, Q, wb, dsig, D, slacks, out, s);
  if (wb <= 8) return bank_go<8>(psig, Q, wb, dsig, D, slacks, out, s);
  if (wb <= 16) return bank_go<16>(psig, Q, wb, dsig, D, slacks, out, s);
  return bank_go<0>(psig, Q, wb, dsig, D, slacks, out, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
