// One-hot correlation string match on the tensor cores of Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mxu_kernel` / `match_mxu` of
// src/repro/kernels/match_mxu.py.  Same contract:
//
//   ref  (R, F4)        bf16  char-major one-hot rows (F4 = 4 * chars)
//   pat  (P4, Q)        bf16  multi-hot patterns, P4 % 128 == 0, Q % 128 == 0
//   out  (R, l_pad, Q)  f32   out[r, l, q] = sum_k ref[r, 4l + k] * pat[k, q]
//
// The im2col window is a stride-4 view of the flat row: row l of the A
// operand starts 4 bf16 (8 bytes) after row l - 1.  WMMA's
// load_matrix_sync needs a 32-byte aligned tile and a leading dimension
// that is a multiple of 8 elements, which that view is not.
//
// What bounds it on this card: its f32 output.  Each output element costs
// 2 * P4 flops (1,024 at P = 100) against 4 bytes written, about 256
// flop/byte, under the ~295 flop/byte the card needs before the tensor
// cores are the limit; the output bytes over HBM bandwidth are the bound.
// Fusing the best reduction into the epilogue (so the block never leaves
// the chip) is the fix, left to a later change.
//
// What the design does:
//  * tensor cores through WMMA (bf16 16x16x16, f32 accumulate).  Scores
//    are sums of 0/1 products, so f32 accumulation is exact;
//  * the whole B tile (P4 x QT patterns) stays resident in shared memory
//    for the life of the block, and each block walks many (row, 64
//    alignments) work items: B is read from HBM once per block, not once
//    per output tile;
//  * per work item the block stages the row segment flat[4*l0 : 4*(l0+64)
//    + P4] in shared memory once, then per 128-wide K chunk builds the A
//    tile A[l][k] = seg[4l + k] with an aligned, padded stride (136) that
//    WMMA accepts;
//  * QT (patterns per block) is the largest of 128/64/32/16 whose B tile
//    fits the 227 KB of shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int LT = 64;        // alignments per work item (4 x 16-row tiles)
constexpr int KC = 128;       // A columns staged per step (32 chars x 4)
constexpr int PAD = 8;        // bf16 row padding: keeps 16-byte rows, spreads banks
constexpr int LDA = KC + PAD;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_FRAGS = 4;  // accumulator tiles per warp at QT = 128

size_t smem_bytes(int P4, int qt) {
  return sizeof(bf16) * ((size_t)P4 * (qt + PAD) + (size_t)LT * LDA +
                         (size_t)LT * 4 + P4);
}

__global__ void __launch_bounds__(THREADS)
mxu_kernel(const bf16* __restrict__ ref, long long R, int F4,
           const bf16* __restrict__ pat, int P4, int Q, int l_pad, int qt,
           float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldb = qt + PAD;
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);   // P4 x ldb
  bf16* a_s = b_s + (size_t)P4 * ldb;              // LT x LDA
  bf16* seg = a_s + LT * LDA;                      // LT*4 + P4
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int q0 = blockIdx.y * qt;

  // Resident B tile, 16-byte vectors (qt and ldb are multiples of 8).
  const int vec_per_row = qt / 8;
  for (int i = tid; i < P4 * vec_per_row; i += THREADS) {
    const int k = i / vec_per_row, v = i % vec_per_row;
    *reinterpret_cast<uint4*>(b_s + (size_t)k * ldb + v * 8) =
        *reinterpret_cast<const uint4*>(pat + (size_t)k * Q + q0 + v * 8);
  }

  // Warp w owns the 16-alignment slice rt = w % 4 and the 16-pattern
  // column tiles ct = w / 4 + 2 i, i < MAX_FRAGS (those below qt / 16).
  const int rt = warp & 3;
  const int n_ct = qt / 16;
  const int seg_vec = (LT * 4 + P4) / 4;           // 8-byte vectors
  const int n_lt = l_pad / LT;
  const long long n_items = R * n_lt;

  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long r = item / n_lt;
    const int l0 = (int)(item % n_lt) * LT;
    __syncthreads();  // B staged / previous item done with seg and a_s
    const uint2* src = reinterpret_cast<const uint2*>(ref + r * F4 + (size_t)l0 * 4);
    for (int i = tid; i < seg_vec; i += THREADS) reinterpret_cast<uint2*>(seg)[i] = src[i];

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_FRAGS];
#pragma unroll
    for (int f = 0; f < MAX_FRAGS; ++f) wmma::fill_fragment(acc[f], 0.0f);

    for (int kc = 0; kc < P4; kc += KC) {
      __syncthreads();  // seg staged / previous chunk's A consumed
      // A[l][k] = seg[4l + kc + k]: 4 bf16 (8 bytes) per copy.
      for (int i = tid; i < LT * (KC / 4); i += THREADS) {
        const int l = i / (KC / 4), g = i % (KC / 4);
        *reinterpret_cast<uint2*>(a_s + l * LDA + g * 4) =
            *reinterpret_cast<const uint2*>(seg + l * 4 + kc + g * 4);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a_s + rt * 16 * LDA + ks, LDA);
#pragma unroll
        for (int f = 0; f < MAX_FRAGS; ++f) {
          const int ct = (warp >> 2) + 2 * f;
          if (ct < n_ct) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, b_s + (size_t)(kc + ks) * ldb + ct * 16, ldb);
            wmma::mma_sync(acc[f], fa, fb, acc[f]);
          }
        }
      }
    }
#pragma unroll
    for (int f = 0; f < MAX_FRAGS; ++f) {
      const int ct = (warp >> 2) + 2 * f;
      if (ct < n_ct) {
        float* dst = out + ((size_t)r * l_pad + l0 + rt * 16) * Q + q0 + ct * 16;
        wmma::store_matrix_sync(dst, acc[f], Q, wmma::mem_row_major);
      }
    }
  }
}

}  // namespace

extern "C" {

int match_mxu_launch(const void* ref, long long R, int F4, const void* pat,
                     int P4, int Q, int l_pad, void* out, void* stream_ptr) {
  if (R <= 0 || P4 <= 0 || P4 % KC || Q <= 0 || Q % 128 || l_pad <= 0 ||
      l_pad % LT || F4 % 4 || 4LL * l_pad + P4 > F4)
    return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  int qt = 128;
  while (qt > 16 && smem_bytes(P4, qt) > (size_t)max_smem) qt /= 2;
  const size_t smem = smem_bytes(P4, qt);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mxu_kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_items = R * (l_pad / LT);
  const long long slots = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  const dim3 grid((unsigned)(n_items < slots ? n_items : slots), (unsigned)(Q / qt));
  mxu_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const bf16*>(ref), R, F4, static_cast<const bf16*>(pat), P4,
      Q, l_pad, qt, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
