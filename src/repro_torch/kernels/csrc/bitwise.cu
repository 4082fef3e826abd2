// Bulk bitwise ops for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bitwise_kernel` / `bitwise` of
// src/repro/kernels/bitwise.py: elementwise NOT, OR, AND, NAND, NOR or
// XOR over (N, W) uint32 operands (the CRAM-PM Fig. 11 gate analogue),
// the op fixed at compile time as there (a template parameter here).
// NOT reads one operand.
//
// What bounds it on this card: bytes (two words read and one written per
// one logic op).  Design: a grid-stride loop of 16-byte vector loads and
// stores when all three pointers are 16-byte aligned, then a scalar tail;
// the grid is capped so each thread walks several vectors.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op { NOT = 0, OR = 1, AND = 2, NAND = 3, NOR = 4, XOR = 5 };
constexpr int BLOCK = 256;
constexpr long long MAX_BLOCKS = 132 * 16;   // 16 blocks per SM

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
  if constexpr (OP == NOT) return ~a;
  if constexpr (OP == OR) return a | b;
  if constexpr (OP == AND) return a & b;
  if constexpr (OP == NAND) return ~(a & b);
  if constexpr (OP == NOR) return ~(a | b);
  return a ^ b;
}

template <int OP, bool VEC>
__global__ void __launch_bounds__(BLOCK)
bitwise_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * BLOCK;
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long head = 0;
  if constexpr (VEC) {
    const long long n4 = n / 4;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long k = i; k < n4; k += stride) {
      const uint4 x = a4[k];
      const uint4 y = OP == NOT ? x : b4[k];
      o4[k] = make_uint4(apply<OP>(x.x, y.x), apply<OP>(x.y, y.y),
                         apply<OP>(x.z, y.z), apply<OP>(x.w, y.w));
    }
    head = n4 * 4;
  }
  for (long long k = head + i; k < n; k += stride)
    out[k] = apply<OP>(a[k], OP == NOT ? 0u : b[k]);
}

template <int OP>
int go(const void* a, const void* b, void* out, long long n, cudaStream_t s) {
  const bool vec = (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long long work = vec ? n / 4 + n % 4 : n;
  long long blocks = (work + BLOCK - 1) / BLOCK;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  const uint32_t* ap = static_cast<const uint32_t*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(b);
  uint32_t* op = static_cast<uint32_t*>(out);
  if (vec)
    bitwise_kernel<OP, true><<<(unsigned)blocks, BLOCK, 0, s>>>(ap, bp, op, n);
  else
    bitwise_kernel<OP, false><<<(unsigned)blocks, BLOCK, 0, s>>>(ap, bp, op, n);
  return (int)cudaGetLastError();
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

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
