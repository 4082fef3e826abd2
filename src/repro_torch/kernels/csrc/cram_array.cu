// CRAM-PM array interpreter for Hopper (sm_90a), in two forms.
//
// Replaces `execute` of src/repro/core/array.py (a `jax.lax.scan` of
// `_interp_step` under `jax.jit`, one XLA computation per program): it runs
// one encoded micro-program, op by op, on every row of a (rows, cols)
// uint8 state, in place.  Each op gathers its input columns, applies its
// gate and scatters its output column (gather before scatter, so an op may
// read its own output column).  The wrapper (kernels/cram_array.py) remaps
// the touched columns to local indices 0..T-1, the n_written written ones
// first; a local whose column is -1 is the fill (an input out of range:
// 255) or the sink (an output out of range: dropped), never written back.
//
// What bounds it on this card: bytes.  One alignment at chr1 layout is
// 3,254 ops over 620,839 rows; it touches 505 of a row's 1,355 columns,
// writes 105 of them and reads the other 400 (every written column is
// written before it is read), so it moves 313 MB: 0.094 ms at 3.35 TB/s.
// Bit-sliced, its gates are 6 INT32 operations a 32-row word an op
// (3.8e8, ~0.02 ms at the INT32 peak).
//
// cram_bits_kernel, the form for states whose touched cells are 0/1:
//  * Every gate maps 0/1 inputs to a 0/1 output, so 32 rows fit one
//    32-bit word and a gate is a word formula.  Each op is MAJ5 (at least
//    3 of 5) of five staged words -- the gate's k inputs, then ONES and
//    ZERO words as the wrapper pads them -- xor a negation mask: [s >= t]
//    of k inputs is MAJ5 of them with 3 - t ONES (kernels/cram_array.py::
//    bits_fields derives each opcode from the byte form's fields).  MAJ5 =
//    (m & (s | d | e)) | (s & d & e) with m = MAJ3(a, b, c), s = a ^ b ^ c:
//    five LOP3s and an xor, the same for every opcode, no branch.
//  * A block of W words (64, 32, 16 or 8: 2,048 to 256 rows) stages the
//    touched columns and the ZERO and ONES words in shared memory,
//    column-major with a pitch of W + 1 words: W threads, one word each,
//    run the whole program there, a warp's 32 words of one column on 32
//    banks.  A byte a cell held 505 staged bytes a row and ~384 rows in
//    flight an SM, each row-op a ~180-cycle load-gate-store chain; 4 bytes
//    a column a word let 2,560 rows stay resident at chr1 layout (16-word
//    blocks, 5 an SM), and one thread's op does the work of 32 rows.  The
//    wrapper picks W for the fewest waves, the smallest on a tie.
//  * Staging is a transpose that stays coalesced: a warp takes 32 local
//    columns of one word, and for each of its 32 rows reads the row's 32
//    bytes (a run of the row: touched columns come in runs) and folds the
//    low bit into lane j's word, 32 loads in flight a lane.  Written
//    columns whose first access is a write (the wrapper puts them first)
//    are not staged.  Addresses are one 64-bit pointer an item plus 32-bit
//    row strides: 64-bit row arithmetic around each byte load made most of
//    the staging loop's instructions.
//    A staged byte above 1 is counted into a device counter (the caller
//    promised 0/1 cells; the count shows a broken promise).  Write-back
//    unpacks the n_written columns the same way, rows below R only.  All
//    128 threads stage and write back; only the W word threads compute.
//  * At chr1 layout a launch is ~0.65 ms (H100 80GB HBM3, 700 W): about
//    0.2 ms staging, 0.2 ms write-back (byte stores of 105 columns, far
//    below the card's write rate) and 2 waves of the op chain.
//
// cram_bytes_kernel, the form for any uint8 state:
//  * Gates are computed in int32 and the result cast to uint8, as the
//    reference does: INV 2 -> 255, COPY 2 -> 2.  One thread per row; a
//    block of B rows (128, 64 or 32) stages the touched columns a byte a
//    cell, pitch B + 4, or runs unstaged (each thread in its row in device
//    memory) where T columns do not fit 32 rows' staging.  The gate is
//    evaluated without a branch from fields the wrapper encodes (inputs
//    to sum, a threshold test, or c0 + c1 * a0).  ~6 ms a launch at chr1
//    layout: shared memory bounds its rows in flight, which is what the
//    bit-sliced form is for.
//
// Both forms stage the program in shared memory, 256 ops (4 KB) at a time,
// and each thread reads the next op while it runs this one: from device
// memory, a 3,254-op program (52 KB) did not stay in L1.  Offsets are
// 64-bit but for the bit-sliced form's row strides (rows of at most 2^26
// columns).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SMEM = 232448;        // 227 KB, dynamic, with opt-in
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr int MAX_LOCAL = 65536;        // local column indices are 16-bit
constexpr int OP_CHUNK = 256;           // ops staged at a time
constexpr int PROGRAM_BYTES = OP_CHUNK * 16;
constexpr int STAGE_UNROLL = 8;         // byte form: staging loads in flight
constexpr int BITS_THREADS = 128;
constexpr int BITS_WARPS = BITS_THREADS / 32;

// Stages chunk c0 of the program into shared memory (every thread).
__device__ __forceinline__ int stage_ops(uint4* prog, const uint4* ops,
                                         int c0, int n_ops) {
  const int n = min(OP_CHUNK, n_ops - c0);
  if (c0) __syncthreads();            // every thread is done with the chunk
  for (int q = (int)threadIdx.x; q < n; q += (int)blockDim.x)
    prog[q] = __ldg(ops + c0 + q);
  __syncthreads();
  return n;
}

// The five input words of op `op` (locals, pitch P) for the thread whose
// local-0 word is `mine`.
template <int P>
__device__ __forceinline__ void load_inputs(const uint32_t* mine, uint4 op,
                                            uint32_t (&v)[5]) {
  v[0] = mine[(op.x & 0xffffu) * P];
  v[1] = mine[(op.x >> 16) * P];
  v[2] = mine[(op.y & 0xffffu) * P];
  v[3] = mine[(op.y >> 16) * P];
  v[4] = mine[(op.z & 0xffffu) * P];
}

template <int W>
__global__ void __launch_bounds__(BITS_THREADS, 8)
cram_bits_kernel(uint8_t* __restrict__ state, long long R, long long C,
                 const uint4* __restrict__ ops, int n_ops,
                 const int* __restrict__ cols, int T, int n_written,
                 int n_fresh, unsigned int* __restrict__ over_one) {
  constexpr int P = W + 1;                        // odd: no bank conflict
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* prog = reinterpret_cast<uint4*>(smem);   // OP_CHUNK ops
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem + PROGRAM_BYTES);
  const int tid = (int)threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * (W * 32);
  const long long rows = min((long long)W * 32, R - row0);

  // Stage locals n_fresh..T-1 (the fresh ones are written before any
  // read): item (word w, 32 locals from n_fresh + 32 ch), lane j's word.
  // One 64-bit pointer an item and 32-bit row strides: 64-bit row
  // arithmetic around each byte load made most of the loop's instructions.
  const int Ci = (int)C;                          // < 2^26: the launcher
  unsigned int bad = 0;
  const int chunks = (T - n_fresh + 31) / 32;
  for (int w = chunks ? warp / chunks : W, ch = chunks ? warp % chunks : 0;
       w < W;) {
    const int j = n_fresh + ch * 32 + lane;
    const int c = j < T ? __ldg(cols + j) : -1;
    const int nr = c < 0 ? 0 : (int)max(0LL, min(32LL, rows - 32LL * w));
    const uint8_t* p = state + (row0 + 32LL * w) * C + max(c, 0);
    uint32_t word = 0, any = 0;
    if (nr == 32) {
      uint8_t v[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) v[r] = __ldg(p + r * Ci);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        word |= (uint32_t)(v[r] & 1u) << r;
        any |= v[r];
      }
    } else {
      for (int r = 0; r < nr; ++r) {
        const uint32_t v = __ldg(p + r * Ci);
        word |= (v & 1u) << r;
        any |= v;
      }
    }
    if (any > 1u)                       // a broken promise: count exactly
      for (int r = 0; r < nr; ++r) bad += __ldg(p + r * Ci) > 1u;
    if (j < T) sm[j * P + w] = word;
    for (ch += BITS_WARPS; ch >= chunks; ch -= chunks) ++w;
  }
  for (int w = tid; w < W; w += BITS_THREADS) {
    sm[T * P + w] = 0u;                           // ZERO
    sm[(T + 1) * P + w] = ~0u;                    // ONES
  }
  if (bad) atomicAdd(over_one, bad);
  __syncthreads();

  // The program: each op's five words, MAJ5, xor the negation mask.
  uint32_t* mine = sm + tid;                      // word tid of local 0
  for (int c0 = 0; c0 < n_ops; c0 += OP_CHUNK) {
    const int n = stage_ops(prog, ops, c0, n_ops);
    if (tid >= W) continue;
    uint4 op = prog[0];
    for (int i = 0; i < n; ++i) {
      const uint4 nxt = prog[i + 1 < n ? i + 1 : i];
      uint32_t v[5];
      load_inputs<P>(mine, op, v);
      const uint32_t m = (v[0] & v[1]) | (v[2] & (v[0] | v[1]));
      const uint32_t s = v[0] ^ v[1] ^ v[2];
      mine[(op.z >> 16) * P] =
          ((m & (s | v[3] | v[4])) | (s & v[3] & v[4])) ^ op.w;
      op = nxt;
    }
  }
  __syncthreads();

  // Write back: the n_written columns, rows below R.
  const int wchunks = (n_written + 31) / 32;
  if (wchunks == 0) return;
  for (int w = warp / wchunks, ch = warp % wchunks; w < W;) {
    const int j = ch * 32 + lane;
    const int nr = (int)max(0LL, min(32LL, rows - 32LL * w));
    if (j < n_written && nr > 0) {
      const uint32_t word = sm[j * P + w];
      uint8_t* p = state + (row0 + 32LL * w) * C + __ldg(cols + j);
      if (nr == 32) {
#pragma unroll
        for (int r = 0; r < 32; ++r) p[r * Ci] = (uint8_t)((word >> r) & 1u);
      } else {
        for (int r = 0; r < nr; ++r) p[r * Ci] = (uint8_t)((word >> r) & 1u);
      }
    }
    for (ch += BITS_WARPS; ch >= wchunks; ch -= wchunks) ++w;
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(128)
cram_bytes_kernel(uint8_t* __restrict__ state, long long R, long long C,
                  const uint4* __restrict__ ops, int n_ops,
                  const int* __restrict__ cols, int T, int n_written,
                  int n_fresh, int pitch) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* prog = reinterpret_cast<uint4*>(smem);   // OP_CHUNK ops
  uint8_t* sm = smem + PROGRAM_BYTES;             // T columns x pitch rows
  const int B = (int)blockDim.x;
  const int tid = (int)threadIdx.x;
  const long long row0 = (long long)blockIdx.x * B;
  const int rows = (int)min((long long)B, R - row0);
  uint8_t* base = state + row0 * C;

  if constexpr (STAGED) {
    // Locals n_fresh..T-1, STAGE_UNROLL loads in flight before their
    // stores: one at a time, the staging waited a device-memory latency
    // per cell.
    const int S = T - n_fresh, total = rows * S;
    for (int idx0 = tid; idx0 < total; idx0 += B * STAGE_UNROLL) {
      uint8_t v[STAGE_UNROLL];
      int dst[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int idx = idx0 + u * B;
        if (idx < total) {
          const int r = idx / S, j = n_fresh + idx - r * S;
          const int c = __ldg(cols + j);
          v[u] = c >= 0 ? base[(long long)r * C + c] : (uint8_t)255;
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
  auto load = [&](uint32_t j) -> int {
    if constexpr (STAGED) {
      return mine[j * pitch];
    } else {
      const int c = __ldg(cols + j);
      return c >= 0 ? mine[c] : 255;
    }
  };
  auto store = [&](uint32_t j, int v) {
    if constexpr (STAGED) {
      mine[j * pitch] = (uint8_t)v;
    } else {
      const int c = __ldg(cols + j);
      if (c >= 0) mine[c] = (uint8_t)v;
    }
  };
  for (int c0 = 0; c0 < n_ops; c0 += OP_CHUNK) {
    const int n = stage_ops(prog, ops, c0, n_ops);
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
      const int a0 = k > 0 ? load(op.y & 0xffffu) : 0;
      const int s = a0 + (k > 1 ? load(op.y >> 16) : 0)
          + (k > 2 ? load(op.z & 0xffffu) : 0)
          + (k > 3 ? load(op.z >> 16) : 0)
          + (k > 4 ? load(op.w & 0xffffu) : 0);
      const int t = (int)((x >> 7) & 3u);
      const bool cmp =
          (((x >> 9) & 1u) ? s == t : s < t) != (bool)((x >> 10) & 1u);
      const uint32_t c1 = (x >> 13) & 3u;     // 0, 1, 2: times 0, 1, -1
      const int lin = (int)((x >> 12) & 1u) + (c1 == 2u ? -a0 : (int)c1 * a0);
      store(op.x >> 16, ((x >> 11) & 1u) ? lin : (int)cmp);
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

template <typename K>
cudaError_t opt_in(K kernel, int smem_bytes) {
  if (smem_bytes <= DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <int W>
int bits_launch(uint8_t* st, long long R, long long C, const uint4* op,
                int n_ops, const int* cl, int T, int n_written, int n_fresh,
                int smem_bytes, unsigned int* over_one, cudaStream_t s) {
  const long long grid = (R + 32LL * W - 1) / (32LL * W);
  if (grid > INT_MAX || PROGRAM_BYTES + (T + 2LL) * (W + 1) * 4 != smem_bytes)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = opt_in(cram_bits_kernel<W>, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cram_bits_kernel<W><<<(unsigned)grid, BITS_THREADS, smem_bytes, s>>>(
      st, R, C, op, n_ops, cl, T, n_written, n_fresh, over_one);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Byte form: runs n_ops packed ops (kernels/cram_array.py::pack_program,
// `ops`) in place on an (R, C) uint8 state.  cols maps the T local columns
// to state columns (-1: fill or sink), the n_written written ones first.
// block_rows B in {32, 64, 128}; staged: smem_bytes == PROGRAM_BYTES + T *
// pitch with pitch >= B + 4; unstaged: B = 128 and smem_bytes ==
// PROGRAM_BYTES.  kernels/cram_array.py::launch_geometry computes them.
int cram_execute_launch(void* state, long long R, long long C,
                        const void* ops, int n_ops, const void* cols, int T,
                        int n_written, int n_fresh, int block_rows,
                        int pitch, int smem_bytes, int staged, void* stream) {
  const long long grid = (R + block_rows - 1) / block_rows;
  if (R < 1 || C < 1 || n_ops < 1 || T < 1 || T > MAX_LOCAL ||
      n_written < 0 || n_written > T || n_fresh < 0 || n_fresh > n_written ||
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
    const cudaError_t e = opt_in(cram_bytes_kernel<true>, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    cram_bytes_kernel<true><<<grd, blk, smem_bytes, s>>>(
        st, R, C, op, n_ops, cl, T, n_written, n_fresh, pitch);
  } else {
    if (smem_bytes != PROGRAM_BYTES || block_rows != 128)
      return (int)cudaErrorInvalidValue;
    cram_bytes_kernel<false><<<grd, blk, smem_bytes, s>>>(
        st, R, C, op, n_ops, cl, T, n_written, n_fresh, pitch);
  }
  return (int)cudaGetLastError();
}

// Bit-sliced form: runs n_ops packed ops (pack_program's `ops_bits`) in
// place on an (R, C) uint8 state whose touched cells are 0/1; staged bytes
// above 1 are added to *over_one.  words W in {64, 32, 16, 8} 32-row words
// a block; smem_bytes == PROGRAM_BYTES + (T + 2) * (W + 1) * 4 <= 227 KB
// (kernels/cram_array.py::bits_geometry).
int cram_bits_launch(void* state, long long R, long long C, const void* ops,
                     int n_ops, const void* cols, int T, int n_written,
                     int n_fresh, int words, int smem_bytes, void* over_one,
                     void* stream) {
  if (R < 1 || C < 1 || C > (INT_MAX >> 5) || n_ops < 1 || T < 1 ||
      T + 2 > MAX_LOCAL || n_written < 0 || n_written > T || n_fresh < 0 ||
      n_fresh > n_written || smem_bytes > MAX_SMEM ||
      reinterpret_cast<uintptr_t>(ops) % 16 || over_one == nullptr)
    return (int)cudaErrorInvalidValue;
  auto* st = static_cast<uint8_t*>(state);
  const auto* op = static_cast<const uint4*>(ops);
  const auto* cl = static_cast<const int*>(cols);
  auto* cnt = static_cast<unsigned int*>(over_one);
  auto s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 64: return bits_launch<64>(st, R, C, op, n_ops, cl, T, n_written,
                                    n_fresh, smem_bytes, cnt, s);
    case 32: return bits_launch<32>(st, R, C, op, n_ops, cl, T, n_written,
                                    n_fresh, smem_bytes, cnt, s);
    case 16: return bits_launch<16>(st, R, C, op, n_ops, cl, T, n_written,
                                    n_fresh, smem_bytes, cnt, s);
    case 8: return bits_launch<8>(st, R, C, op, n_ops, cl, T, n_written,
                                  n_fresh, smem_bytes, cnt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
