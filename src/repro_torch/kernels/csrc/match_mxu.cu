// One-hot correlation string match on the tensor cores of Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mxu_kernel` / `match_mxu` of
// src/repro/kernels/match_mxu.py.  One mainloop, two epilogues:
//
//   ref  (R, F4)        bf16  char-major one-hot rows (F4 = 4 * chars)
//   pat  (P4, Q)        bf16  multi-hot patterns, P4 % 128 == 0, Q % 128 == 0
//   S[r, l, q] = sum_{k < n_k} ref[r, 4l + k] * pat[k, q]
//
//   STORE  out (R, l_pad, Q) f32 = S for every l < l_pad (n_k = P4): the
//          TPU kernel's contract, used by the threshold and full
//          reductions.
//   BEST   best_score (R, Q) int32 = max over l < n_locs of round(S),
//          best_loc (R, Q) int32 = the first l attaining it (argmax
//          semantics).  Only K rows < n_k are read: the pattern matrix is
//          zero beyond 4P, so skipping them changes nothing.
//
// What bounds it on this card.  STORE: its f32 output (2 * P4 flops per 4
// bytes written, under the ~295 flop/byte at which the tensor cores
// become the limit).  BEST: the tensor-core operations, since only 8
// bytes per (row, pattern) leave the chip.
//
// What the design does about it:
//  * wgmma with A from registers, no im2col tile.  A[l][k] = seg[4l + k]
//    is a stride-4 view of the staged row segment; the register A
//    fragment of wgmma (per warp, the m16n8k16 layout) holds the pairs
//    seg[4(l0+g) + k0 + 2t + {0,1}]: one 4-byte shared load each, the 32
//    lanes on distinct banks or on the same word.  No A tile, no block
//    barrier per K chunk.  A warpgroup computes 64 alignments x QT
//    patterns (m64nQTk16), two register sets of A in flight.
//  * B resident.  The CTA's (K x QT) pattern tile is loaded once by
//    cp.async.bulk, 16 bytes at a time, into the no-swizzle MN-major
//    layout wgmma reads (8 x 8 core matrices of 128 contiguous bytes, K
//    blocks outer), completion on an mbarrier.
//  * Persistent warpgroups.  Each owns a (row, QT-pattern tile) task and
//    walks all of the row's alignment tiles of 64 itself.  Each tile's
//    row segment, 4 * 64 + n_k bf16, is prefetched by cp.async.bulk into
//    the warpgroup's second buffer while the current one computes.  The
//    wrapper takes any row width F4 % 4 == 0, so a row may start only 8
//    bytes aligned; a bulk copy wants 16, so such a segment is copied
//    from 8 bytes earlier and read at an offset of 4 bf16.  The engine's
//    rows are always 16-byte aligned (f_chars = l_pad + p_chars is even
//    and above F), so only direct callers take that branch.
//  * BEST folds each alignment tile into a per-column (score, loc) pair
//    in registers, ascending l with a strict >, reduces across lanes
//    under (score desc, loc asc) with shuffles and across the 4 warps in
//    shared memory; only the (Q,) pairs per row reach HBM.  Scores are
//    sums of 0/1 products, exact in the f32 accumulators.
//  * STORE stages each warp's 16 x 64 f32 sub-tiles through shared
//    memory and writes whole 256-byte rows with 16-byte streaming stores.
//  * QT (patterns per CTA) is the largest of 128/64/32/16/8 whose B tile
//    fits beside the segments; with QT = 8 the warpgroups per CTA drop
//    from 2 to 1 before a shape is refused (K depth above ~11,000).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MT = 64;          // alignments per tile: the wgmma M
constexpr int MAX_WGS = 2;      // warpgroups per CTA
constexpr int BAR_BYTES = 256;  // mbarriers: 1 for B + 2 per warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of the given parity completes.  A copy that never
// lands traps after ~10 s (2^34 cycles) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - t0 > (1LL << 34)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk copy global -> shared; dst, src and bytes 16-byte aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma descriptor of a no-swizzle B tile: start address, LBO = stride
// between 8-row K blocks, SBO = 128 bytes between 8-column N blocks.
__device__ __forceinline__ uint64_t b_desc(const bf16* p, uint32_t lbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

// D (64 x N f32, N / 2 a thread) += A (64 x 16 bf16, registers) * B (desc).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Segment buffer length (bf16): 64 alignments x 4 + the K depth.
__host__ __device__ __forceinline__ int seg_len(int n_kpad) { return 4 * MT + n_kpad; }
__host__ __device__ __forceinline__ int stage_cols(int qt) { return qt < 64 ? qt : 64; }

size_t smem_bytes(int n_kpad, int qt, int wgs, bool store) {
  size_t b = BAR_BYTES + sizeof(bf16) * (size_t)n_kpad * qt +
             (size_t)wgs * 2 * sizeof(bf16) * seg_len(n_kpad);
  if (store)
    b += (size_t)wgs * 4 * 16 * (stage_cols(qt) + 4) * sizeof(float);
  else
    b += (size_t)wgs * 4 * qt * sizeof(int2);
  return b;
}

// N: patterns per CTA (the wgmma N); STORE selects the epilogue.  Work:
// blockIdx.y picks an N-wide pattern tile; warpgroups walk rows
// round-robin across the grid.
template <int N, bool STORE>
__global__ void __launch_bounds__(MAX_WGS * 128, 1)
mxu_kernel(const bf16* __restrict__ ref, long long R, int F4, const bf16* __restrict__ pat,
           int Q, int n_k, int n_locs, int l_pad, float* __restrict__ out,
           int* __restrict__ best_loc, int* __restrict__ best_score) {
  constexpr int NJ = N / 8;  // n8 column tiles
  constexpr int NC = N < 64 ? N : 64;  // STORE staging width
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int wgs = blockDim.x >> 7;
  const int wg = threadIdx.x >> 7, wtid = threadIdx.x & 127;
  const int warp = wtid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_kpad = (n_k + 15) & ~15;
  const int slen = seg_len(n_kpad);

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);  // [0] B, [1 + 2 wg + b] segments
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw + BAR_BYTES);
  bf16* segs = b_s + (size_t)n_kpad * N;                    // wgs x 2 x slen
  unsigned char* tail = reinterpret_cast<unsigned char*>(segs + (size_t)wgs * 2 * slen);
  bf16* my_seg = segs + (size_t)wg * 2 * slen;
  uint64_t* my_bar = bars + 1 + 2 * wg;

  const int q0 = blockIdx.y * N;
  const int n_mt = (n_locs + MT - 1) / MT;

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    for (int i = 0; i < 2 * wgs; ++i) mbar_init(&bars[1 + i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bars[0], (uint32_t)(n_kpad * N * sizeof(bf16)));
  }
  __syncthreads();

  // Resident B in 16-byte pieces: (k, n8 block) -> core matrix
  // (k / 8, n / 8), row k % 8.
  for (int c = threadIdx.x; c < n_kpad * NJ; c += blockDim.x) {
    const int k = c / NJ, nb = c % NJ;
    bulk_load(b_s + ((size_t)(k >> 3) * NJ + nb) * 64 + (k & 7) * 8,
              pat + (size_t)k * Q + q0 + 8 * nb, 16, &bars[0]);
  }

  // Start of the (row, m-tile) segment in global memory, and its read
  // offset in the buffer: 4 bf16 when the row segment is only 8-byte
  // aligned, which is then copied from 8 bytes earlier (an odd F4 / 4 of
  // a direct caller; the engine's rows are 16-byte aligned).
  auto seg_src = [&](long long r, int mt, int& shift) {
    const bf16* src = ref + r * F4 + (size_t)mt * MT * 4;
    shift = (reinterpret_cast<uintptr_t>(src) & 15) ? 4 : 0;
    return src - shift;
  };
  auto issue = [&](long long r, int mt, int buf) {
    if (wtid == 0) {
      int shift;
      const bf16* src = seg_src(r, mt, shift);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(&my_bar[buf], (uint32_t)(slen * sizeof(bf16)));
      bulk_load(my_seg + (size_t)buf * slen, src, slen * sizeof(bf16), &my_bar[buf]);
    }
  };

  const long long stride = (long long)gridDim.x * wgs;
  long long r = (long long)blockIdx.x * wgs + wg;
  int mt = 0, buf = 0;
  uint32_t phase = 0;  // bit b: parity of the next wait on buffer b
  if (r < R) issue(r, 0, 0);
  mbar_wait(&bars[0], 0);
  const uint64_t desc0 = b_desc(b_s, NJ * 128);
  const uint64_t desc_step = (2 * NJ * 128) >> 4;  // two K blocks per k16 step

  int bs[NJ][2], bl[NJ][2];  // BEST: running (score, loc) per column
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bs[j][e] = INT32_MIN, bl[j][e] = 0;

  while (r < R) {
    long long nr = r;
    int nmt = mt + 1;
    if (nmt == n_mt) nr = r + stride, nmt = 0;
    mbar_wait(&my_bar[buf], (phase >> buf) & 1);
    phase ^= 1u << buf;
    if (nr < R) issue(nr, nmt, buf ^ 1);

    const int l0 = mt * MT;
    int shift;
    seg_src(r, mt, shift);
    const bf16* sa = my_seg + (size_t)buf * slen + shift + 16 * 4 * warp + 4 * g + 2 * t;

    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    // Two A register sets: a k-step's registers are refilled only after
    // the wgmma that read them has retired (wait_group 1).
    uint32_t a0[4], a1[4];
    auto load_a = [&](uint32_t (&a)[4], int ks) {
      const bf16* p = sa + 16 * ks;
      a[0] = ld_pair(p);
      a[1] = ld_pair(p + 32);
      a[2] = ld_pair(p + 8);
      a[3] = ld_pair(p + 40);
    };
    const int n_ks = n_kpad / 16;
    load_a(a0, 0);
    for (int ks = 0; ks < n_ks; ks += 2) {
      wgmma_fence();
      wgmma_rs<N>(acc, a0, desc0 + ks * desc_step);
      wgmma_commit();
      if (ks + 1 < n_ks) {
        wgmma_wait<1>();
        load_a(a1, ks + 1);
        wgmma_fence();
        wgmma_rs<N>(acc, a1, desc0 + (ks + 1) * desc_step);
        wgmma_commit();
      }
      if (ks + 2 < n_ks) {
        wgmma_wait<1>();
        load_a(a0, ks + 2);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    // acc[4j + 2h + e] is row 16 warp + 8h + g, column 8j + 2t + e.
    if constexpr (STORE) {
      float* st = reinterpret_cast<float*>(tail) + (size_t)(wg * 4 + warp) * 16 * (NC + 4);
#pragma unroll
      for (int c0 = 0; c0 < N; c0 += NC) {
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int jj = c0 / 8 + j;
          *reinterpret_cast<float2*>(st + g * (NC + 4) + 8 * j + 2 * t) =
              make_float2(acc[4 * jj], acc[4 * jj + 1]);
          *reinterpret_cast<float2*>(st + (g + 8) * (NC + 4) + 8 * j + 2 * t) =
              make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
        }
        __syncwarp();
        float* dst = out + ((size_t)r * l_pad + l0 + 16 * warp) * Q + q0 + c0;
#pragma unroll
        for (int p = 0; p < NC / 8; ++p) {
          const int idx = lane + 32 * p;
          const int row = idx / (NC / 4), c4 = idx % (NC / 4);
          __stcs(reinterpret_cast<float4*>(dst + (size_t)row * Q) + c4,
                 *reinterpret_cast<const float4*>(st + row * (NC + 4) + 4 * c4));
        }
        __syncwarp();
      }
    } else {
      // Fold this tile's alignments, ascending l, strict >.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + 16 * warp + 8 * h + g;
        if (l < n_locs) {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = __float2int_rn(acc[4 * j + 2 * h + e]);
              if (s > bs[j][e]) bs[j][e] = s, bl[j][e] = l;
            }
        }
      }
      if (nmt == 0) {
        // Row done: reduce over the 8 lanes of each column (same t),
        // then over the 4 warps, under (score desc, loc asc).
        int2* red = reinterpret_cast<int2*>(tail) + (size_t)wg * 4 * N;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              const int os = __shfl_xor_sync(0xffffffffu, bs[j][e], m);
              const int ol = __shfl_xor_sync(0xffffffffu, bl[j][e], m);
              if (os > bs[j][e] || (os == bs[j][e] && ol < bl[j][e])) bs[j][e] = os, bl[j][e] = ol;
            }
            if (g == 0) red[warp * N + 8 * j + 2 * t + e] = make_int2(bs[j][e], bl[j][e]);
            bs[j][e] = INT32_MIN, bl[j][e] = 0;
          }
        wg_barrier(1 + wg);
        for (int col = wtid; col < N; col += 128) {
          int2 best = red[col];
#pragma unroll
          for (int w = 1; w < 4; ++w) {
            const int2 c = red[w * N + col];
            if (c.x > best.x || (c.x == best.x && c.y < best.y)) best = c;
          }
          best_score[(size_t)r * Q + q0 + col] = best.x;
          best_loc[(size_t)r * Q + q0 + col] = best.y;
        }
      }
    }
    wg_barrier(1 + wg);  // buffer `buf` (and `red`) consumed before reuse
    r = nr, mt = nmt, buf ^= 1;
  }
}

template <int N, bool STORE>
int launch_n(const bf16* ref, long long R, int F4, const bf16* pat, int Q, int wgs, int n_k,
             int n_locs, int l_pad, float* out, int* bl, int* bs, size_t smem, int n_sm,
             cudaStream_t stream) {
  auto kern = mxu_kernel<N, STORE>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, wgs * 128, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_qt = Q / N;
  long long blocks = ((long long)n_sm * per_sm + n_qt - 1) / n_qt;
  const long long need = (R + wgs - 1) / wgs;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  kern<<<dim3((unsigned)blocks, (unsigned)n_qt), wgs * 128, smem, stream>>>(
      ref, R, F4, pat, Q, n_k, n_locs, l_pad, out, bl, bs);
  return (int)cudaGetLastError();
}

// Shared launcher: picks QT and the warpgroups per CTA, then the instance.
int launch(const void* ref, long long R, int F4, const void* pat, int P4, int Q, int n_k,
           int n_locs, int l_pad, void* out, void* bl, void* bs, void* stream_ptr) {
  const bool store = out != nullptr;
  if (R <= 0 || P4 <= 0 || P4 % 128 || Q <= 0 || Q % 128 || F4 % 4 || n_k <= 0 ||
      n_k > P4 || n_locs <= 0 || n_locs > l_pad || l_pad % 256 || 4LL * l_pad + P4 > F4 ||
      (reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(pat)) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int n_kpad = (n_k + 15) & ~15;
  int qt = 128, wgs = MAX_WGS;
  while (qt > 8 && smem_bytes(n_kpad, qt, wgs, store) > (size_t)max_smem) qt /= 2;
  while (wgs > 1 && smem_bytes(n_kpad, qt, wgs, store) > (size_t)max_smem) wgs /= 2;
  const size_t smem = smem_bytes(n_kpad, qt, wgs, store);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const bf16* r = static_cast<const bf16*>(ref);
  const bf16* p = static_cast<const bf16*>(pat);
  float* o = static_cast<float*>(out);
  int* l = static_cast<int*>(bl);
  int* s = static_cast<int*>(bs);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
#define MXU_GO(N)                                                                           \
  return store ? launch_n<N, true>(r, R, F4, p, Q, wgs, n_k, n_locs, l_pad, o, l, s, smem,   \
                                   n_sm, st)                                                \
               : launch_n<N, false>(r, R, F4, p, Q, wgs, n_k, n_locs, l_pad, o, l, s, smem,  \
                                    n_sm, st)
  switch (qt) {
    case 8: MXU_GO(8);
    case 16: MXU_GO(16);
    case 32: MXU_GO(32);
    case 64: MXU_GO(64);
    default: MXU_GO(128);
  }
#undef MXU_GO
}

}  // namespace

extern "C" {

// STORE: out (R, l_pad, Q) f32, every alignment, the full K depth.
int match_mxu_launch(const void* ref, long long R, int F4, const void* pat, int P4, int Q,
                     int l_pad, void* out, void* stream_ptr) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  return launch(ref, R, F4, pat, P4, Q, P4, l_pad, l_pad, out, nullptr, nullptr, stream_ptr);
}

// BEST: best_loc, best_score (R, Q) int32 over l < n_locs, K rows < n_k.
int match_mxu_best_launch(const void* ref, long long R, int F4, const void* pat, int P4, int Q,
                          int n_k, int n_locs, int l_pad, void* best_loc, void* best_score,
                          void* stream_ptr) {
  if (best_loc == nullptr || best_score == nullptr) return (int)cudaErrorInvalidValue;
  return launch(ref, R, F4, pat, P4, Q, n_k, n_locs, l_pad, nullptr, best_loc, best_score,
                stream_ptr);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
