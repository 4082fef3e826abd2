// CRAM-PM array interpreter for Hopper (sm_90a).
//
// Replaces `execute` of src/repro/core/array.py (a `jax.lax.scan` of
// `_interp_step` under `jax.jit`, one XLA computation per program): it runs
// one encoded micro-program, op by op, on every row of a (rows, cols)
// uint8 state, in place.  Each op gathers its input columns, applies its
// gate and scatters its output column (gather before scatter, so an op may
// read its own output column).  Gates are computed in int32 and the result
// cast to uint8, as the reference does: a state that is not 0/1 gives INV
// 2 -> 255 and COPY 2 -> 2.
//
// What bounds it on this card: operations (the roofline), and in this
// design the latency of each op.  One alignment at chr1 layout is 3,254
// ops over 620,839 rows; it touches 505 of a row's 1,355 columns and
// writes 105.  It moves 379 MB (touched columns read once, written ones
// written once: 0.11 ms at 3.35 TB/s) and needs ~3,150 INT32 adds and
// compares a row (0.12 ms at 16.7 TOP/s).  The interpreter issues ~20
// instructions a row-op (decode, byte loads, the gate, a byte store) and
// sits far below either bound (~6 ms a launch on an H100 80GB HBM3 at
// 700 W).  What holds it there is shared memory: 505 staged bytes a row
// leave ~384 rows in flight an SM, and each op of a row is a dependent
// chain (load, gate, store) of ~180 cycles.  Bit-slicing 32 rows into a
// word is the redesign that would close the gap.
//
// What the design does about it:
//  * One thread per row; rows never depend on each other.  A block of B
//    rows (128, 64 or 32, the wrapper picks the largest that fits) stages
//    the columns the program touches in shared memory, column-major with a
//    pitch of B + 4 bytes: a warp's 32 rows of one column are 32
//    consecutive bytes (one access, no bank conflict), and consecutive
//    columns of one row land on distinct banks while staging (the pitch is
//    an odd number of words).  Eight staging loads are in flight a thread.
//  * The wrapper remaps the touched columns to local indices 0..T-1,
//    written columns first, so the block stages T columns in, runs the
//    whole program in shared memory, and writes back only the first
//    n_written.  Above 48 KB the launcher opts in to the larger dynamic
//    shared memory (227 KB a block).
//  * Each op is one 16-byte word (the gate's fields and the output, then
//    five 16-bit inputs).  The block stages the program in shared memory,
//    256 ops (4 KB) at a time, and each thread reads the next op while it
//    runs this one.  Read from device memory instead, a 3,254-op program
//    (52 KB) does not stay in the L1 left beside three blocks' staged
//    columns, and every op waited on L2 (11.2 ms a launch at chr1 layout,
//    6.9 ms with the program staged, same card).
//  * The gate is evaluated without a branch from fields the wrapper
//    encodes (inputs to sum, a threshold test, or c0 + c1 * a0), loading
//    only its arity's inputs (padded inputs are never read).  Against a
//    switch on the opcode (an indirect branch an op) it took the paper's
//    10,000-row array from 0.395 to 0.329 ms a launch and left chr1's
//    where it was (5.7-6.1 ms).
//  * A program whose touched columns do not fit even 32 rows' staging runs
//    unstaged: each thread reads and writes its row in device memory
//    through the same column map.  Slow (a warp's accesses are a row apart)
//    but correct for any shape.
// Offsets are 64-bit.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SMEM = 232448;        // 227 KB, dynamic, with opt-in
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr int MAX_LOCAL = 65536;        // local column indices are 16-bit
constexpr int OP_CHUNK = 256;           // ops staged at a time
constexpr int PROGRAM_BYTES = OP_CHUNK * 16;
constexpr int STAGE_UNROLL = 8;         // staging loads in flight a thread

template <bool STAGED>
__global__ void __launch_bounds__(128)
cram_kernel(uint8_t* __restrict__ state, long long R, long long C,
            const uint4* __restrict__ ops, int n_ops,
            const int* __restrict__ cols, int T, int n_written, int pitch) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* prog = reinterpret_cast<uint4*>(smem);   // OP_CHUNK ops
  uint8_t* sm = smem + PROGRAM_BYTES;             // T columns x pitch rows
  const int B = (int)blockDim.x;
  const int tid = (int)threadIdx.x;
  const long long row0 = (long long)blockIdx.x * B;
  const int rows = (int)min((long long)B, R - row0);
  uint8_t* base = state + row0 * C;

  if constexpr (STAGED) {
    // STAGE_UNROLL loads in flight before their stores: one at a time, the
    // staging waited a device-memory latency per cell.
    const int total = rows * T;
    for (int idx0 = tid; idx0 < total; idx0 += B * STAGE_UNROLL) {
      uint8_t v[STAGE_UNROLL];
      int dst[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int idx = idx0 + u * B;
        if (idx < total) {
          const int r = idx / T, j = idx - r * T;
          v[u] = base[(long long)r * C + __ldg(cols + j)];
          dst[u] = j * pitch + r;
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u)
        if (idx0 + u * B < total) sm[dst[u]] = v[u];
    }
    __syncthreads();
  }
  uint8_t* mine = STAGED ? sm + tid : base + (long long)tid * C;
  auto at = [&](uint32_t j) -> uint8_t& {
    if constexpr (STAGED) return mine[j * pitch];
    else return mine[__ldg(cols + j)];
  };
  for (int c0 = 0; c0 < n_ops; c0 += OP_CHUNK) {
    const int n = min(OP_CHUNK, n_ops - c0);
    if (c0) __syncthreads();          // every thread is done with the chunk
    for (int q = tid; q < n; q += B) prog[q] = __ldg(ops + c0 + q);
    __syncthreads();
    if (tid >= rows) continue;
    uint4 op = prog[0];
    for (int i = 0; i < n; ++i) {
      const uint4 nxt = prog[i + 1 < n ? i + 1 : i];
      // The gate, without a branch: the wrapper encodes each opcode as
      // fields of op.x (kernels/cram_array.py::GATE_FIELDS).  k inputs are
      // loaded and summed; a threshold gate is (s == t or s < t), negated
      // or not; PRESET, INV and COPY are c0 + c1 * a0.
      const uint32_t x = op.x;
      const int k = (int)((x >> 4) & 7u);
      const int a0 = k > 0 ? at(op.y & 0xffffu) : 0;
      const int s = a0 + (k > 1 ? at(op.y >> 16) : 0)
          + (k > 2 ? at(op.z & 0xffffu) : 0) + (k > 3 ? at(op.z >> 16) : 0)
          + (k > 4 ? at(op.w & 0xffffu) : 0);
      const int t = (int)((x >> 7) & 3u);
      const bool cmp =
          (((x >> 9) & 1u) ? s == t : s < t) != (bool)((x >> 10) & 1u);
      const uint32_t c1 = (x >> 13) & 3u;     // 0, 1, 2: times 0, 1, -1
      const int lin = (int)((x >> 12) & 1u) + (c1 == 2u ? -a0 : (int)c1 * a0);
      const int res = ((x >> 11) & 1u) ? lin : (int)cmp;
      at(op.x >> 16) = (uint8_t)res;
      op = nxt;
    }
  }
  if constexpr (STAGED) {
    __syncthreads();
    for (int idx = tid; idx < rows * n_written; idx += B) {
      const int r = idx / n_written, j = idx - r * n_written;
      base[(long long)r * C + __ldg(cols + j)] = sm[j * pitch + r];
    }
  }
}

}  // namespace

extern "C" {

// Runs n_ops packed ops (kernels/cram_array.py::pack_program) in place on
// an (R, C) uint8 state.  cols maps the T local columns to state columns,
// the n_written written ones first.  block_rows B in {32, 64, 128};
// staged: smem_bytes == PROGRAM_BYTES + T * pitch with pitch >= B + 4;
// unstaged: B = 128 and smem_bytes == PROGRAM_BYTES.
// kernels/cram_array.py::launch_geometry computes them.
int cram_execute_launch(void* state, long long R, long long C,
                        const void* ops, int n_ops, const void* cols, int T,
                        int n_written, int block_rows, int pitch,
                        int smem_bytes, int staged, void* stream) {
  const long long grid = (R + block_rows - 1) / block_rows;
  if (R < 1 || C < 1 || n_ops < 1 || T < 1 || T > MAX_LOCAL ||
      n_written < 1 || n_written > T ||
      (block_rows != 32 && block_rows != 64 && block_rows != 128) ||
      grid > INT_MAX || reinterpret_cast<uintptr_t>(ops) % 16)
    return (int)cudaErrorInvalidValue;
  auto* st = static_cast<uint8_t*>(state);
  const auto* op = static_cast<const uint4*>(ops);
  const auto* cl = static_cast<const int*>(cols);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grd((unsigned)grid), blk((unsigned)block_rows);
  if (staged) {
    if (pitch < block_rows + 4 ||
        PROGRAM_BYTES + (long long)T * pitch != smem_bytes ||
        smem_bytes > MAX_SMEM)
      return (int)cudaErrorInvalidValue;
    if (smem_bytes > DEFAULT_SMEM) {
      const cudaError_t e = cudaFuncSetAttribute(
          cram_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (e != cudaSuccess) return (int)e;
    }
    cram_kernel<true><<<grd, blk, smem_bytes, s>>>(st, R, C, op, n_ops, cl, T,
                                                   n_written, pitch);
  } else {
    if (smem_bytes != PROGRAM_BYTES || block_rows != 128)
      return (int)cudaErrorInvalidValue;
    cram_kernel<false><<<grd, blk, smem_bytes, s>>>(st, R, C, op, n_ops, cl, T,
                                           n_written, pitch);
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
