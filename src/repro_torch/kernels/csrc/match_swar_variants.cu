// Design variants of the exact SWAR kernel and the bank prefilter, for
// timing only (`python -m repro_torch.kernels.match_swar_variants`).
//
// This library instantiates the templates of swar_exact.cuh and
// bank_prefilter.cuh with each design choice undone; match_swar.cu and
// filter_qgram.cu, which the port runs, instantiate only the shipped
// design.  `match_swar_variants_shipped` reports that design from the
// same constants the shipped launches read, so the timing script labels
// it without a copy of its own.

#include <cstdint>
#include <cuda_runtime.h>

#include "bank_prefilter.cuh"
#include "swar_exact.cuh"

extern "C" {

// The shipped design: flags[0..3] = register window, word pairs, staged
// STORE rows (1 or 0), and the bank kernel's lanes per pattern.
void match_swar_variants_shipped(int* flags) {
  flags[0] = swar::SHIP_WINDOW;
  flags[1] = swar::SHIP_PAIR;
  flags[2] = swar::SHIP_STAGE;
  flags[3] = bank::BANK_LPG;
}

// The exact kernel with any of its design choices undone: best (BEST
// epilogue, else STORE), window (register window, else two shared loads
// per word and alignment), pair (one popcount per two pattern words),
// stage (STORE through shared memory, else each thread stores its 16
// scores; BEST ignores it), rows_per_block (a divisor of 256 whose shared
// memory fits; 0 picks as the shipped launch does).  Patterns of 5-8
// words (the WPT = 8 build).
int match_swar_exact_variant(const void* ref, long long R, int W,
                             const void* pat, long long pat_stride,
                             const void* valid, int wp, int n_locs,
                             int pattern_chars, void* out, void* best_loc,
                             void* best_score, int best, int window, int pair,
                             int stage, int rows_per_block, void* stream) {
  using namespace swar;
  const ExactArgs a{ref, R, W, pat, pat_stride, valid, wp, n_locs,
                    pattern_chars, out, best_loc, best_score};
  if (int e = exact_check(a)) return e;
  if (a.wp < 5 || a.wp > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = best ? SHIP_STAGE : stage != 0;
  int rb = pick_rb(W, wp, n_locs, false, best, staged);
  if (rows_per_block) {
    const size_t words =
        layout(rows_per_block, W, wp, n_locs, false, best, staged).words;
    if (NT % rows_per_block || words * 4 > MAX_SMEM)
      return (int)cudaErrorInvalidValue;
    rb = rows_per_block;
  }
  if (!rb) return (int)cudaErrorInvalidValue;
  const int code = (best ? 8 : 0) | (window ? 4 : 0) | (pair ? 2 : 0) |
                   (!best && stage ? 1 : 0);
  switch (code) {
#define REPRO_SWAR_VARIANT(C, E, WI, PA, ST) \
  case C: return exact_go<8, E, WI, PA, ST>(a, rb, s);
    REPRO_SWAR_VARIANT(0, STORE, false, false, false)
    REPRO_SWAR_VARIANT(1, STORE, false, false, true)
    REPRO_SWAR_VARIANT(2, STORE, false, true, false)
    REPRO_SWAR_VARIANT(3, STORE, false, true, true)
    REPRO_SWAR_VARIANT(4, STORE, true, false, false)
    REPRO_SWAR_VARIANT(5, STORE, true, false, true)
    REPRO_SWAR_VARIANT(6, STORE, true, true, false)
    REPRO_SWAR_VARIANT(7, STORE, true, true, true)
    REPRO_SWAR_VARIANT(8, BEST, false, false, SHIP_STAGE)
    REPRO_SWAR_VARIANT(10, BEST, false, true, SHIP_STAGE)
    REPRO_SWAR_VARIANT(12, BEST, true, false, SHIP_STAGE)
    REPRO_SWAR_VARIANT(14, BEST, true, true, SHIP_STAGE)
#undef REPRO_SWAR_VARIANT
  }
  return (int)cudaErrorInvalidValue;
}

// The bank kernel with LPG lanes per pattern (1, 4, 8, 16 or 32).
int bank_prefilter_variant(const void* psig, long long Q, int wb,
                           const void* dsig, int D, const void* slacks,
                           void* out, int lpg, void* stream) {
  using namespace bank;
  if (int e = bank_check(Q, wb, D)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lpg) {
    case 1: return bank_lpg<1>(psig, Q, wb, dsig, D, slacks, out, s);
    case 4: return bank_lpg<4>(psig, Q, wb, dsig, D, slacks, out, s);
    case 8: return bank_lpg<8>(psig, Q, wb, dsig, D, slacks, out, s);
    case 16: return bank_lpg<16>(psig, Q, wb, dsig, D, slacks, out, s);
    case 32: return bank_lpg<32>(psig, Q, wb, dsig, D, slacks, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
