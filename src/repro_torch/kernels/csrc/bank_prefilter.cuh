// The standing bank's prefilter kernel for Hopper (sm_90a): the templates
// that `filter_qgram.cu` instantiates at the shipped lanes per pattern and
// `match_swar_variants.cu` at the others.  The design and what bounds it
// are described in filter_qgram.cu.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace bank {

constexpr int ROW_TILE = 128;        // Q's multiple
constexpr int WARP = 32;
constexpr int BANK_THREADS = 128;    // threads per bank block
constexpr int BANK_LPG = 32;         // lanes per pattern (the shipped design)
constexpr int SMEM_WORDS = 12288;    // 48 KB: the static shared-memory limit

// WBT > 0: the pattern signature lives in WBT registers (wb <= WBT, the
// rest zero) and the staged docs are padded to WBT words, read as 16-byte
// vectors; WBT == 0: the pattern is read from global memory and the docs
// from shared memory at stride wb (wide signatures).
template <int WBT, int LPG>
__global__ void __launch_bounds__(BANK_THREADS)
bank_kernel(const uint32_t* __restrict__ psig,
            const uint32_t* __restrict__ dsig,
            const int32_t* __restrict__ slacks, int wb, int D, int doc_tile,
            int32_t* __restrict__ out) {
  extern __shared__ uint4 d_s4[];                    // doc_tile * stride
  uint32_t* d_s = reinterpret_cast<uint32_t*>(d_s4);
  const int stride = WBT > 0 ? WBT : wb;
  const int lane = threadIdx.x % WARP;
  const int gl = threadIdx.x % LPG;                  // lane in the group
  const unsigned gmask = (LPG == WARP ? ~0u : (1u << LPG) - 1u)
                         << (lane - gl);
  const long long p = (long long)blockIdx.x * (BANK_THREADS / LPG) +
                      threadIdx.x / LPG;
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
    for (int i = threadIdx.x; i < nd * stride; i += BANK_THREADS) {
      const int d = i / stride, j = i - d * stride;
      d_s[i] = j < wb ? src[(long long)d * wb + j] : 0u;
    }
    __syncthreads();
    for (int d = gl; d - gl < nd; d += LPG) {         // warp-uniform trips
      if (__all_sync(~0u, done)) break;
      bool hit = false;
      if (!done && d < nd) {
        const uint32_t* ds = d_s + d * stride;
        int absent = 0;
        if constexpr (WBT > 0) {
#pragma unroll
          for (int v = 0; v < WBT / 4; ++v) {
            const uint4 x = reinterpret_cast<const uint4*>(ds)[v];
            absent += __popc(ps[4 * v] & ~x.x) + __popc(ps[4 * v + 1] & ~x.y) +
                      __popc(ps[4 * v + 2] & ~x.z) + __popc(ps[4 * v + 3] & ~x.w);
          }
        } else {
          for (int j = 0; j < wb; ++j) absent += __popc(__ldg(prow + j) & ~ds[j]);
        }
        hit = absent <= slack;
      }
      if (__ballot_sync(~0u, hit) & gmask) {
        found = true;
        done = true;
      }
    }
  }
  if (gl == 0) out[p] = found ? 1 : 0;
}

template <int WBT, int LPG>
int bank_go(const void* psig, long long Q, int wb, const void* dsig, int D,
            const void* slacks, void* out, cudaStream_t s) {
  const int stride = WBT > 0 ? WBT : wb;
  const int doc_tile = min(D, SMEM_WORDS / stride);
  if (doc_tile < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * (size_t)doc_tile * stride;
  bank_kernel<WBT, LPG><<<(unsigned)(Q / (BANK_THREADS / LPG)), BANK_THREADS,
                          smem, s>>>(
      static_cast<const uint32_t*>(psig), static_cast<const uint32_t*>(dsig),
      static_cast<const int32_t*>(slacks), wb, D, doc_tile,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

template <int LPG>
int bank_lpg(const void* psig, long long Q, int wb, const void* dsig, int D,
             const void* slacks, void* out, cudaStream_t s) {
  if (wb <= 4) return bank_go<4, LPG>(psig, Q, wb, dsig, D, slacks, out, s);
  if (wb <= 8) return bank_go<8, LPG>(psig, Q, wb, dsig, D, slacks, out, s);
  if (wb <= 16) return bank_go<16, LPG>(psig, Q, wb, dsig, D, slacks, out, s);
  return bank_go<0, LPG>(psig, Q, wb, dsig, D, slacks, out, s);
}

int bank_check(long long Q, int wb, int D) {
  return Q <= 0 || Q % ROW_TILE || wb < 1 || D < 1 ? (int)cudaErrorInvalidValue
                                                    : 0;
}

}  // namespace bank
}  // namespace
