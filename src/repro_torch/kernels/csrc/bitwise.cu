// Bulk bitwise ops for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bitwise_kernel` / `bitwise` of
// src/repro/kernels/bitwise.py: elementwise NOT, OR, AND, NAND, NOR or
// XOR over (N, W) uint32 operands (the CRAM-PM Fig. 11 gate analogue),
// the op fixed at compile time as there (a template parameter here).
// NOT reads one operand.
//
// What bounds it on this card: bytes (two words read and one written per
// one logic op).  Design, for HBM at full rate: one 16-byte vector per
// operand per thread (one word when a pointer is not 16-byte aligned),
// one block per BLOCK vectors so the block scheduler spreads HBM traffic
// over the SMs to the end of the launch, plain loads and stores; then a
// scalar tail of n % 4 words.  `bitwise_xor_variant` launches XOR with
// the alternatives: a one-wave grid sized by occupancy, 2 or 4
// independent vectors per thread per trip, and streaming hints
// (__ldcs / __stcs).  kernels/bitwise_variants.py times all twelve
// against torch.bitwise_xor: on the H100 the hints and the one-wave grid
// each cost 3-4%, and 1, 2 or 4 vectors differ by under 1% (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op { NOT = 0, OR = 1, AND = 2, NAND = 3, NOR = 4, XOR = 5 };
constexpr int BLOCK = 256;
constexpr long long MAX_BLOCKS = 0x7fffffff;   // grid.x limit

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
  if constexpr (OP == NOT) return ~a;
  if constexpr (OP == OR) return a | b;
  if constexpr (OP == AND) return a & b;
  if constexpr (OP == NAND) return ~(a & b);
  if constexpr (OP == NOR) return ~(a | b);
  return a ^ b;
}

template <int OP>
__device__ __forceinline__ uint4 apply(uint4 a, uint4 b) {
  return make_uint4(apply<OP>(a.x, b.x), apply<OP>(a.y, b.y), apply<OP>(a.z, b.z),
                    apply<OP>(a.w, b.w));
}

template <bool HINT, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (HINT) return __ldcs(p);
  return *p;
}

template <bool HINT, typename T>
__device__ __forceinline__ void store(T* p, T v) {
  if constexpr (HINT) __stcs(p, v);
  else *p = v;
}

// out[i] = op(a[i], b[i]) for i < n elements of T (uint4 or uint32).  A
// trip covers UV * BLOCK elements per block; thread t takes elements
// t, t + BLOCK, ... (coalesced), loading all of them before storing.
template <int OP, int UV, bool HINT, typename T>
__device__ __forceinline__ void run(const T* __restrict__ a, const T* __restrict__ b,
                                    T* __restrict__ out, long long n) {
  const long long step = (long long)gridDim.x * BLOCK * UV;
  for (long long k = (long long)blockIdx.x * BLOCK * UV + threadIdx.x; k < n;
       k += step) {
    T x[UV], y[UV];
    if (k + (long long)(UV - 1) * BLOCK < n) {
#pragma unroll
      for (int j = 0; j < UV; ++j) {
        x[j] = load<HINT>(a + k + j * BLOCK);
        if constexpr (OP != NOT) y[j] = load<HINT>(b + k + j * BLOCK);
      }
#pragma unroll
      for (int j = 0; j < UV; ++j)
        store<HINT>(out + k + j * BLOCK, apply<OP>(x[j], OP == NOT ? x[j] : y[j]));
    } else {  // the last, partial trip
      for (int j = 0; j < UV && k + j * BLOCK < n; ++j) {
        const T v = load<HINT>(a + k + j * BLOCK);
        store<HINT>(out + k + j * BLOCK,
                    apply<OP>(v, OP == NOT ? v : load<HINT>(b + k + j * BLOCK)));
      }
    }
  }
}

template <int OP, bool VEC, int UV, bool HINT>
__global__ void __launch_bounds__(BLOCK)
bitwise_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, long long n) {
  if constexpr (VEC) {
    const long long n4 = n / 4;
    run<OP, UV, HINT>(reinterpret_cast<const uint4*>(a),
                      reinterpret_cast<const uint4*>(b),
                      reinterpret_cast<uint4*>(out), n4);
    // Scalar tail: the last n % 4 words, one thread each.
    const long long i = n4 * 4 + (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (i < n) out[i] = apply<OP>(a[i], OP == NOT ? 0u : b[i]);
  } else {
    run<OP, UV, HINT>(a, b, out, n);
  }
}

using Kernel = void (*)(const uint32_t*, const uint32_t*, uint32_t*, long long);

// Blocks for `items` elements at UV per thread: one wave (resident blocks
// per SM x SMs) when `one_wave`, else one block per trip.
int launch(Kernel kern, int uv, bool one_wave, const void* a, const void* b,
           void* out, long long n, long long items, cudaStream_t s) {
  long long blocks = (items + (long long)BLOCK * uv - 1) / ((long long)BLOCK * uv);
  if (one_wave) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, BLOCK, 0);
    if (err != cudaSuccess) return (int)err;
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  }
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, BLOCK, 0, s>>>(static_cast<const uint32_t*>(a),
                                          static_cast<const uint32_t*>(b),
                                          static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

bool aligned16(const void* a, const void* b, const void* out) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(out)) % 16 == 0;
}

template <int OP>
int go(const void* a, const void* b, void* out, long long n, cudaStream_t s) {
  if (aligned16(a, b, out))
    return launch(bitwise_kernel<OP, true, 1, false>, 1, false, a, b, out, n, n / 4, s);
  return launch(bitwise_kernel<OP, false, 1, false>, 1, false, a, b, out, n, n, s);
}

}  // namespace

extern "C" {

// op: 0 NOT, 1 OR, 2 AND, 3 NAND, 4 NOR, 5 XOR (bitwise.py's OP_CODES).
int bitwise_launch(int op, const void* a, const void* b, void* out,
                   long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case NOT: return go<NOT>(a, b, out, n, s);
    case OR: return go<OR>(a, b, out, n, s);
    case AND: return go<AND>(a, b, out, n, s);
    case NAND: return go<NAND>(a, b, out, n, s);
    case NOR: return go<NOR>(a, b, out, n, s);
    case XOR: return go<XOR>(a, b, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// XOR of 16-byte-aligned operands with `vecs` (1, 2 or 4) vectors per
// thread per trip, streaming hints on or off, and a one-wave grid or one
// block per trip.  bitwise_launch is (1, 0, 0).
int bitwise_xor_variant(const void* a, const void* b, void* out, long long n,
                        int vecs, int hints, int one_wave, void* stream) {
  if (n <= 0 || !aligned16(a, b, out)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Kernel kern = nullptr;
  if (vecs == 1) kern = hints ? bitwise_kernel<XOR, true, 1, true> : bitwise_kernel<XOR, true, 1, false>;
  if (vecs == 2) kern = hints ? bitwise_kernel<XOR, true, 2, true> : bitwise_kernel<XOR, true, 2, false>;
  if (vecs == 4) kern = hints ? bitwise_kernel<XOR, true, 4, true> : bitwise_kernel<XOR, true, 4, false>;
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return launch(kern, vecs, one_wave != 0, a, b, out, n, n / 4, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
