#!/usr/bin/env python3
"""Drive the PyTorch port's match, LM serving, LM training and LM sharding
paths on one NVIDIA card and check them.

Run from the root of a checkout, on a machine with a CUDA device, the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``.  Phases, each
printing its wall time beside the card's name and power limit:

1. Environment: torch / CUDA versions, the card's name and power limit.
2. Build: the six CUDA sources (eleven kernels) with nvcc, in parallel; the
   ``-Xptxas -v`` resource summary.
3. Kernels against their plain versions at edge shapes, bit for bit
   (``match_swar_best`` also on a read planted at two alignments and an
   all-zero row; ``popcount_rows`` at ragged row counts, rows counted by
   several threads and rows streamed in chunks).
4. Main path at the size of GRCh38 chr1 (248,956,422 bp, seeded random
   DNA of that length folded into 500-char rows for 100-char reads):
   ``MatchEngine`` (q-gram index attached, the default) ->
   ``compile(MatchQuery)`` -> ``run()`` for (a) an exact read, best,
   SWAR with the best reduction in the kernel's epilogue
   (``match_swar_best``); (b) an IUPAC read, threshold 95, SWAR
   accept-set; (c) 128
   batched reads with 0-3 mismatches, top-10, tensor cores with the best
   reduction in the kernel's epilogue (``match_mxu_best``); (d) read (a)
   with the planner's own choice; (c') (c)'s reads at threshold 97 on the
   tensor cores over a 16,384-row subset holding the planted rows (the
   full-block ``match_mxu``); then (e) read (a) at threshold 99 with the
   filter forced (filter-then-verify, the survivors through the
   full-block ``match_swar``) and (f) the same with the planner's
   choice.  Launch counters are zeroed just before each query and read
   just after; (a) and (b) are held against the ``ref`` backend on the
   full corpus, (e) against the same query scanned.
4b. Standing bank: ``PatternBank(500, 100)`` with 4,096 patterns drawn
   from the reference, scanned against 4 batches of 256 seeded 500-char
   docs (32 planted hits each) with the prefilter forced on and off;
   both hit sets equal, every planted hit found, sampled patterns equal
   ad-hoc threshold queries.
4c. Bulk ops: ``ops.popcount`` over the resident SWAR form (its rows
   unpadded; its host-clock time, the least of 20 calls each ending in
   ``torch.cuda.synchronize()``) and ``ops.bitwise("XOR", ...)`` on a
   256 MiB pair.
5. Kernels at their paths' shapes: each kernel against its plain
   version at (or beyond) its launch shape with the path's own
   operands, bit for bit (``match_swar_best`` at (a)'s launch, the
   full-block ``match_swar`` at (e)'s verify launch, whose operands one
   run of (e) hands over, and at (a)'s chunk; ``popcount`` at the SWAR
   form padded to 256-row tiles, the launch earlier builds were timed
   at, and at its rows unpadded, the bulk path's own launch);
   ``match_mxu_best`` also
   against the full-block kernel plus ``argmax``/``amax`` on every
   corpus row, and (c)'s top-10 against the top-10 of those best scores;
   at the launch shape, the kernel's and the library call's device time
   with the L2 flushed before each launch (``torch.profiler`` through
   ``obs.device_time``, which retakes a reading with device events lost;
   kernel and library timed in turns), the kernel's time per call and
   the plain version's (CUDA events, back to back), beside the roofline
   bound (for the exact SWAR kernels, from the shipped mainloop's own
   operation counts).
6. Profile: one run each of (a), (c) and (e) under ``torch.profiler``
   (device time by kernel, device busy share) and one under the
   engine's own span tracer (host stage breakdown).
7. Service: ``MatchService`` over phase 4's engine with phase 4b's bank
   (its prefilter the planner's choice) and a window of the corpus's
   rows.  Tick 1 serves three tenants' groups (32 exact best reads with
   0-3 mismatches, 8 exact reads at threshold 99, the IUPAC read at 95):
   launches as ``plan_batch`` prices them, every result equal to a solo
   ``engine.match``, every planted read found, no ticket in error, the
   tick's wall time beside the 41 solo runs'.  Tick 2 serves them all
   from the cache with no launch.  Ticks 3-6 ingest phase 4b's batches:
   one bank verify launch each, hits equal to the standalone scans,
   ``n_live`` held at the window, one compaction (timed alone).  Then
   the newest row is found, an evicted row is not, and one traced tick
   shows the service spans.
8. Calibration: ``autotune`` on the full grid (every curve, its
   samples, the autotune's wall time; every key the planner prices
   fitted, every measured kernel launched), the table saved and loaded
   back with an equal digest and equal golden decisions, a second
   autotune whose decisions must be stable (scan backends, filter-then-
   verify and the bank's prefilter-or-scan); then a ``MatchEngine`` under
   the fitted table over phase 4's corpus runs (a)-(f) and (c') three
   times each, run by run its plan, price, wall time and feedback state
   beside the static planner's choice, every answer equal to the static
   engine's on the same corpus (phase 7 ingested into and compacted that
   corpus, so phase 4's own results no longer describe it); the bank's
   ``plan_bank`` under both sources; the fused ``match_swar_best`` and
   ``match_mxu_best`` beside the STORE curve at the grid's top shape;
   whether ``load_cost_source()`` finds the committed table; the
   provenance block, whose power limit is read for this card.
9. The CRAM-PM functional model (``repro_torch.core``), whose
   interpreter ``cram_execute`` has two forms: bit-sliced (32 rows a
   word, for 0/1 cells) and a byte a cell (any uint8 state).  (a) Both
   forms against ``execute_plain`` bit for bit at edge shapes (every
   opcode, row counts off the block, self-aliasing ops): random uint8
   states through ``execute`` (the byte form, every launch geometry up to
   a program whose touched columns exceed shared memory), random 0/1
   states through the bit-sliced kernel at every block size its staging
   fits (outputs out of range, dropped) and through ``execute``, a
   ``CRAMArray`` whose 0/1 state holds one 2 in a touched column (the
   byte form) beside the same array without it (the bit-sliced form), the
   empty program; the launches of each form counted; (b) the paper's
   array, ``Design()``'s 10,000 rows x 2,400 columns
   (``plan_layout(2400, 100, scratch_budget=128)``: 982-char fragments,
   883 alignments): one alignment's program under both schedules, kernel
   against plain on the whole state, then ``Matcher.run()`` over every
   alignment through the bit-sliced form, its scores equal to
   ``ops.match_scores(..., backend="swar")``, its wall time beside
   ``costmodel.pass_cost(Design())``'s (context only); (c) Algorithm 1
   over phase 4's 620,839 x 500 fragments (the host copy taken before
   phase 7 changes the corpus) with read (a): all 401 alignments on 841
   MB of state, one bit-sliced launch each and no byte launch, scores
   equal to the SWAR path's, the best alignment at (a)'s planted row and
   location; wall, kernel and host codegen/readout times apart, a
   launch's first op alone and its write-back alone, and the byte form
   timed on the same state.  The bit-sliced kernel's count of staged
   bytes above 1 must read 0.
10. LM serving through the port's entry points, seeded on the card at
   full width: llama3.2-1b, (l1) f32 weights and (l2) its serving
   deployment (bf16 weights, int8 KV cache, 16 KV heads); (m)
   olmoe-1b-7b's serving deployment (64 experts top-8, bf16 weights,
   int8 KV cache) and (r) recurrentgemma-9b's (RG-LRU and local
   attention, block-diagonal gates, f32 weights); (s) mamba2-130m (24 SSD
   layers, f32) and (w) whisper-tiny (4 encoder and 4 decoder layers,
   f32) as the registry holds them, and (p) pixtral-12b's serving
   deployment (40 layers, bf16 weights, int8 KV cache, 16 KV heads;
   prefill from seeded embeddings).  For each: the card
   against the CPU at the config's width and reduced depth,
   ``generate_greedy`` over 4 prompts of 128 tokens, the slot ``Engine``
   and the ``SpeculativeDecoder`` on a motif prompt, ``match_swar``
   launched by the speculator (one ``propose``'s launch held against its
   plain version and a numpy brute force); prefill and decode-step ms
   beside the step's bound, the profiled step's device-busy share and
   kernels, tokens/s, tokens per model call, ms a ``propose`` and peak
   memory.  Logits are held within 3e-2 as relative L2 error with argmax
   equal unless a near-tie, streams under the margin rule, each against
   what the reference's semantics make equal (``lm_serve_config``):
   (l1)/(l2) prefill + decode and the verify window against the full
   forward and token-by-token decode, every stream against
   ``generate_greedy``; (m) the same forward checks where no call dropped
   an MoE assignment (the drops printed), the Engine against a
   ``decode_step`` loop, the speculator against ``generate_greedy`` when
   its verifies dropped nothing, ``moe_route`` card against CPU integer
   for integer; (r) a 4,096-token block-local forward against the
   windowed prefill and decode past the window, the Engine against the
   same Engine on the CPU at 3 layers, the speculator up to its first
   rejecting verify; (s) (r)'s Engine and speculator checks at full
   depth, the dense forward checks, and a 2,048-token forward (8 chunks)
   against a prefill of its first half plus a continuation; (w)
   ``encode`` of 4 x 1,500 seeded frames, prefill and decode with the
   encoder output against the forward over the frames, the token path
   held as (l1)'s (the reference serves tokens only: each cross layer
   attends its own cache); (p) a prefill of seeded embeddings plus token
   decode against the forward over the joined embeddings, the token
   path as (l2)'s.
11. LM training through the port's entry points (no kernel of its own:
   the reference's LM and optimizer are plain ``jnp``), seeded, each
   config's memory freed before the next: (t1) llama3.2-1b at full width
   and depth (f32, 1,235,814,400 params) through
   ``repro_torch.launch.train``'s ``main`` at its defaults
   (``SyntheticLM``, batch 8 x seq 128, lr 3e-4, warmup 20) for 16 steps:
   every loss finite, the first within 15% of ln(vocab), the mean of the
   last 4 below the first 4's; ms a step (median after 2 warm-up steps),
   tokens/s and the step's bound (6 N T at the bf16 peak plus AdamW's 32
   B a parameter over HBM), then one more step of the same config timed
   in parts (``adamw.update``'s share) and one profiled (device-busy
   share, kernels), and the peak memory; (t2) olmoe-1b-7b at 2 layers,
   recurrentgemma-9b's training deployment at one unit of 3 layers
   (block-diagonal gates), mamba2-130m's (``ssd_bf16_intra``) at full
   depth on two chunks, whisper-tiny at full depth with 1,500 seeded
   frames and pixtral-12b at 2 layers on seeded embeddings with
   microbatch 4, 3 steps each at full width: every loss and gradient
   norm finite, ms a step and peak memory; (t3) one ``train_step`` a
   family (dense, MoE, hybrid, SSM, encoder-decoder, embeddings) at full
   width, 1-2 layers, batch 2 x seq 64, on the card and on the CPU from
   the same weights: the loss within 1e-3 relative, every gradient leaf
   and updated parameter within 3e-2 relative L2, the worst printed;
   (t4) llama3.2-1b at full width and 2 layers, 8 steps checkpointed
   every 4, then a restart from step 4: the resumed losses within 1e-3
   relative of the uninterrupted run's (whether bit-equal printed), the
   last save's snapshot ms, write s and bytes; the directory removed.
12. Row shards on one card: a ``MatchEngine`` on
   ``make_row_mesh(4, devices=["cuda:0"] * 4)`` (q-gram index attached)
   over phase 4's rows (its host copy) runs (a)-(f) and (c'), each result
   bit for bit phase 4's one-shard result (for (f), whose filter-or-scan
   verdict the per-shard prices may move, the hits at least); a 2-shard
   engine runs (a) and (c) the same.  A one-shard twin over the same rows
   times each query beside the 4-shard engine (host clock, the least of 3
   after a warm-up).  Resident chunks launch their kernel once a shard;
   launches, pulls and collective bytes a run, the plan's reason.  Then
   both engines take 1,024 seeded rows, tombstones on every 100th row
   and a compaction, with (a), (c) and (e) equal after the tombstones and
   after the compaction, the shards balanced to a row and the pack
   counters flat; peak memory above the phase's start.
13. Row shards across processes: phase 12's 4 shards held by 2 ranks
   of ``torch.distributed`` spawned through
   ``repro_torch.launch.cluster`` (``chip_smoke.py --procs-worker
   DIR``, fresh interpreters), 2 shards each: on one card both ranks on
   ``cuda:0`` under a gloo named here, with a card a rank rank ``r`` on
   ``cuda:r`` under NCCL.  Each rank reads phase 4's rows and phase 12's
   4-shard results from ``build/phase13`` and runs (a)-(f) and (c'),
   then phase 12's appends, tombstones and compaction with (a), (c), (e)
   after each, every result bit for bit phase 12's ((f) by phase 12's
   rule); the ranks agree, pack once a form and each launch half of
   phase 12's launches.  Per rank: backend, devices, torch version, ms a
   query (host clock, the least of 3 after a warm-up) beside phase
   12's, collectives and their bytes a run beside phase 12's, the host
   ms its collectives took, peak memory.  A failed rank fails the phase
   (the others are killed).
14. The LM's sharding (no kernel of its own: the reference shards its
   ``jnp`` LM through GSPMD, the port through DTensor): four ranks form
   ``make_debug_mesh(2, 2)``, a ``(data, model)`` mesh, as threads of
   this process under torch's ``"threaded"`` process group (one card:
   every rank's shards on ``cuda:0``; four or more: rank ``r`` on
   ``cuda:r``; the layout is printed), whose collectives are device
   copies.  (z1) llama3.2-1b at full width and depth, batch 8 x seq 128,
   (t1)'s optimizer: 3 one-device steps, then the same weights through
   ``convert.shard_params`` for the same 3 steps on the mesh under
   ``activation_sharding`` with the "2d" rules, then the optimized
   config's "fsdp" rules for 1 step: every loss within 1e-3 relative of
   the one-device loss, the gradient norm within 1e-2, every updated
   leaf (gathered whole) within 3e-2 relative L2; leaves sharded over
   data, model, both and neither; ms a step (median after 1 warm-up)
   beside the one-device step; the collectives of a step by kind and
   their bytes (``CommDebugMode``); peak memory on the card.  (z2) a
   mesh-less checkpoint at full width and 2 layers restored with
   ``restore(shardings=)``: every rank's local block of every leaf equal
   to its slice of the saved array, bit for bit; the directory removed.
   (z1)-(z2) fail past 150 s.  (z3) serving on the mesh: llama3.2-1b's
   serving config (bf16 weights, int8 KV, 16 KV heads) at full width
   and depth, 4 prompts of 128 tokens prefilled into a 256-position
   cache (``init_cache(mesh=)``), 2 decode steps at a scalar position
   and 1 at per-row positions through the steps, then mamba2-130m (one
   prefill, one decode): greedy tokens equal to one device's wherever
   its top-1/top-2 margin clears the rule ``lm_same_greedy`` uses, and
   every logit row within relative L2 2e-3 of one device's or twice the
   floor, if larger (one device against itself with its projections
   rounded once from f32, the mesh's row-parallel arithmetic); ms a
   prefill and a decode step beside one device's; a decode step's
   collectives by kind.  (z4) the dry run (``repro_torch.launch.dryrun
   .lower_cell``) of (z1)'s "2d" train step and (z3)'s decode step on a
   2x2 mesh under a ``fake`` group, in a subprocess (``chip_smoke.py
   --dryrun-worker IN OUT``): its collectives by kind equal those
   ``CommDebugMode`` counted on the card, its ``argument_bytes`` rank
   0's local shards.  (z3)-(z4) fail past 120 s.
15. Summary: a ``kernels`` line, the ``{"kernels": [...]}`` JSON line
   (``match_swar``'s launches count phase 10's; each row also carries
   phase 12's launches, ``launches_sharded``, and phase 13's over both
   ranks, ``launches_procs``), the script's wall time, the card's name
   and power limit, and ``{"ok": true, "device": {...}}`` as the last
   line.

Any mismatch raises and the script exits non-zero; no phase catches a
failure.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

CHR1_BP = 248_956_422        # GRCh38 chr1 length
FRAG, READ = 500, 100        # benchmarks/fig5_throughput.py MR_FRAG / MR_PAT
SEED = 0
N_BATCH = 128                # batched reads of query (c)
SUBSET_C2 = 16_384           # rows of query (c'), the planted rows among them
THRESHOLD_C2 = 97            # (c'): every read has at most 3 mismatches
SUBSET_ROWS = 65_536         # rows held kernel-against-plain in phase 5
TIMED_RUNS = 3
# Standing bank (phase 4b): live patterns, docs per batch, batches,
# planted hits per batch, patterns held against ad-hoc queries.
BANK_PATTERNS, BANK_DOCS, BANK_BATCHES, BANK_PLANTED = 4096, 256, 4, 32
BANK_SAMPLE = 24
# Service (phase 7): exact best reads of (c)'s with 0-3 mismatches, and
# exact reads at threshold READ - 1, each taken at a known row.
SVC_BEST, SVC_THR = 32, 8
XOR_BYTES = 256 * 2**20      # each operand of the bulk XOR (phase 4c)
L2_FLUSH_BYTES = 128 * 2**20  # written before each timed launch (50 MB L2)
# Peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W): bf16
# tensor cores, HBM bandwidth, and the CUDA-core INT32 rate (132 SMs x 64
# INT32 ops/clock x 1.98 GHz boost, Hopper white paper).
PEAK_BF16 = 989e12
PEAK_INT32 = 132 * 64 * 1.98e9
HBM_BW = 3.35e12
# Population counts: 16 per clock per SM on compute capability 9.0 (CUDA
# C++ Programming Guide, arithmetic instruction throughput).
PEAK_POPC = 132 * 16 * 1.98e9
# INT32 logic/shift operations per (row, alignment, pattern word) as the
# SWAR kernels' first sm_90a build issued them (cuobjdump): exact = funnel
# shift, xor, shift, fold-and-mask (LOP3); accept-set = 3 shifts, 8 LOP3.
# Each word also takes one popcount, and one add that the compiler issues
# on the FMA pipe (IMAD), not counted.  The accept-set kernel still runs
# that loop; for the exact kernels this count is printed as
# ``bound_ms_first_build``, so their rows compare across builds.
SWAR_INT_OPS_PER_WORD = {"match_swar": 4, "match_swar_best": 4,
                         "match_swar_masks": 11}
# INT32-pipe operations per (row, alignment) of the shipped exact
# mainloop, per pair of pattern words and per unpaired word, from its
# SASS (``python -m repro_torch.kernels.match_swar_variants --sass``): a
# pair issues 3 SHF (two funnel shifts, the second word's >> 1) and 4
# LOP3 (two xors, two fold-and-masks), an unpaired word 1 SHF and 2 LOP3;
# at shift 0 the funnel shifts fold away (2 fewer a pair, 1 fewer a
# word).  Each pair or unpaired word takes one popcount.  The << 1, the
# pair's add and the accumulate issue as IMADs on the FMA pipe, fewer
# than these at no lower a rate, so they never bind; BEST's fold and
# STORE's staging are not counted either.  The bound is the kernels'
# ``bound_ms``.
EXACT_INT_OPS = {"match_swar": (7, 3), "match_swar_best": (7, 3)}
SOURCES = {
    "match_swar": ("src/repro_torch/kernels/csrc/match_swar.cu",
                   "src/repro/kernels/match_swar.py:82"),
    "match_swar_best": ("src/repro_torch/kernels/csrc/match_swar.cu",
                        "src/repro/kernels/match_swar.py:82"),
    "match_swar_masks": ("src/repro_torch/kernels/csrc/match_swar.cu",
                         "src/repro/kernels/match_swar.py:146"),
    "match_mxu": ("src/repro_torch/kernels/csrc/match_mxu.cu",
                  "src/repro/kernels/match_mxu.py:54"),
    "match_mxu_best": ("src/repro_torch/kernels/csrc/match_mxu.cu",
                       "src/repro/kernels/match_mxu.py:54"),
    "filter_qgram": ("src/repro_torch/kernels/csrc/filter_qgram.cu",
                     "src/repro/kernels/filter_qgram.py:63"),
    "bank_prefilter": ("src/repro_torch/kernels/csrc/filter_qgram.cu",
                       "src/repro/kernels/filter_qgram.py:131"),
    "popcount": ("src/repro_torch/kernels/csrc/popcount.cu",
                 "src/repro/kernels/popcount.py:41"),
    "bitwise": ("src/repro_torch/kernels/csrc/bitwise.cu",
                "src/repro/kernels/bitwise.py:41"),
    "cram_execute": ("src/repro_torch/kernels/csrc/cram_array.cu",
                     "src/repro/core/array.py:144"),
    "cram_execute_bytes": ("src/repro_torch/kernels/csrc/cram_array.cu",
                           "src/repro/core/array.py:144"),
}
BUILD = ("match_swar", "match_mxu", "filter_qgram", "popcount", "bitwise",
         "cram_array")
# CRAM-PM functional model (phase 9): the paper's array (``Design()``:
# 10,000 rows x 2,400 columns, 100-char patterns, a 128-column scratch
# budget) and INT32 operations a row-op needs by opcode id (PRESET0,
# PRESET1, NOR, OR, NAND, AND, INV, COPY, MAJ3, MAJ5, TH): the adds of
# its inputs and one compare, INV one subtract, COPY and presets none.
PAPER_ROWS, PAPER_COLS, PAPER_SCRATCH = 10_000, 2_400, 128
CRAM_INT_OPS = (0, 0, 2, 2, 2, 2, 1, 0, 3, 5, 4)
# The bit-sliced form's INT32 operations a 32-row word an op: MAJ5 of five
# words (five LOP3s) and the negation xor; and the byte form's launches
# timed at (h), beside the bit-sliced form's every launch.
BITS_INT_OPS = 6
CRAM_BYTES_TIMED = 20
# Readings some kernel rows carry beside their own: the exact SWAR bound
# by the first build's count, STORE match_swar at (a)'s chunk, popcount
# over the SWAR form's rows unpadded and its bound there.
EXTRA_MS = ("bound_ms_first_build", "ms_a_chunk", "ms_unpadded",
            "bound_ms_unpadded", "ms_paper", "bound_ms_paper")
# LM serving (phase 10): llama3.2-1b at its published width as the registry
# holds it, (l1) f32 weights, and as the repo's serving deployment of it,
# (l2) bf16 weights, int8 KV cache, KV heads padded to 16.  Sizes:
# generate_greedy over LM_PROMPTS prompts of LM_PROMPT_LEN tokens; the
# slot Engine over LM_REQUESTS requests of LM_MIN_PROMPT..LM_PROMPT_LEN
# tokens in LM_SLOTS slots; the speculative decoder (k = LM_SPEC_K) on a
# prompt of an LM_MOTIF-token motif repeated to LM_PROMPT_LEN tokens.
LM_ARCH = "llama3.2-1b"
LM_PROMPTS, LM_PROMPT_LEN, LM_MAX_NEW, LM_MAX_SEQ = 4, 128, 32, 512
LM_REQUESTS, LM_SLOTS, LM_MIN_PROMPT = 8, 4, 16
LM_MOTIF, LM_SPEC_NEW, LM_SPEC_K = 16, 128, 4
LM_CHECK_STEPS = 4           # decode steps held against the full forward
LM_TIMED_STEPS = 16          # decode steps timed at LM_SLOTS slots
LM_RTOL = LM_ATOL = 3e-2     # the reference's bf16 logit tolerance
# (m) olmoe-1b-7b and (r) recurrentgemma-9b, each as the repo's serving
# deployment of it, at full width: the Engine serves LM_MR_REQUESTS
# requests of LM_MIN_PROMPT..2 * LM_MIN_PROMPT tokens, LM_MR_NEW new each
# (fewer than (l1)/(l2)'s: their streams are held against a decode loop or
# not at all, and their steps take more launches).  (r) also runs a
# cacheless forward of LM_LONG tokens (two local windows: the block-local
# path) held on its last LM_LONG_TAIL + 1 positions against the windowed
# scan and against decode past the window, and its Engine at reduced
# depth on the card and on the CPU: LM_CPU_REQUESTS requests of
# LM_CPU_PROMPT tokens (a range), LM_CPU_NEW new each, in LM_CPU_SLOTS
# slots, so that one is admitted beside a running one (a CPU decode call
# at that width takes ~1-2 s: most of it the 256,000-id tied embedding).
LM_MOE_ARCH, LM_HYBRID_ARCH = "olmoe-1b-7b", "recurrentgemma-9b"
LM_MR_REQUESTS, LM_MR_NEW = 6, 16
LM_LONG, LM_LONG_TAIL = 4096, 4
LM_CPU_REQUESTS, LM_CPU_PROMPT, LM_CPU_NEW, LM_CPU_SLOTS = 3, (2, 4), 3, 2
# (s) mamba2-130m, (w) whisper-tiny, both as the registry holds them, and
# (p) pixtral-12b's serving deployment, at full width: their Engines serve
# (m)/(r)'s LM_MR_REQUESTS requests.  (s) also runs a cacheless forward
# of LM_SSD_LONG tokens (8 chunks of 256) held against a prefill of its
# first half plus a continuation of the second; its Engine's twin, on the
# card and the CPU, is (r)'s (LM_CPU_* sizes) at full depth.
LM_SSD_ARCH, LM_ENCDEC_ARCH, LM_EMBEDS_ARCH = ("mamba2-130m",
                                               "whisper-tiny", "pixtral-12b")
LM_SSD_LONG = 2048
# LM training (phase 11): (t1) llama3.2-1b at full width and depth through
# the train launcher's ``main`` at its defaults (``SyntheticLM``, batch 8 x
# seq 128, lr 3e-4, warmup 20) for TRAIN_STEPS steps, ms a step the median
# after TRAIN_WARM; (t2) the other families at full width, TRAIN_T2_STEPS
# steps of batch TRAIN_B2 x seq TRAIN_S2 (mamba2: two chunks); (t3) one
# train step a family on the card and on the CPU, batch TRAIN_B3 x seq
# TRAIN_S3, the loss within TRAIN_LOSS_RTOL relative and every gradient
# leaf and updated parameter within TRAIN_LEAF_RTOL relative L2 (a leaf
# that starts at 0: under TRAIN_FLIP_SHARE of its entries stepped the
# other way); (t4)
# llama at TRAIN_T4_LAYERS layers, TRAIN_T4_STEPS steps checkpointed every
# TRAIN_T4_EVERY, resumed from that step.  A step's bound charges AdamW
# TRAIN_OPT_BYTES a parameter: f32 p, g, m and v read, p, m and v written,
# and the gradient's own write.
TRAIN_STEPS, TRAIN_WARM, TRAIN_T2_STEPS = 16, 2, 3
TRAIN_B2, TRAIN_S2, TRAIN_B3, TRAIN_S3 = 4, 128, 2, 64
TRAIN_T4_LAYERS, TRAIN_T4_STEPS, TRAIN_T4_EVERY = 2, 8, 4
TRAIN_LOSS_RTOL, TRAIN_LEAF_RTOL, TRAIN_FLIP_SHARE = 1e-3, 3e-2, 1e-2
TRAIN_OPT_BYTES = 32
# The LM's sharding (phase 14): llama3.2-1b at full width and depth on a
# MESH_DATA x MESH_MODEL (data, model) mesh of threaded ranks, batch
# SHARDED_B x seq SHARDED_S and (t1)'s optimizer; SHARDED_STEPS steps under
# the "2d" profile, ms a step the median after one warm-up, then
# SHARDED_FSDP_STEPS under the optimized config's "fsdp" profile, each
# against the one-device run of the same weights and batches: the loss
# within TRAIN_LOSS_RTOL relative, the gradient norm within
# SHARDED_NORM_RTOL, every leaf within TRAIN_LEAF_RTOL relative L2.  (z2)
# restores a mesh-less checkpoint at SHARDED_CKPT_LAYERS layers onto the
# mesh.  The phase must end within SHARDED_LIMIT_S.
MESH_DATA, MESH_MODEL = 2, 2
SHARDED_B, SHARDED_S, SHARDED_STEPS, SHARDED_FSDP_STEPS = 8, 128, 3, 1
SHARDED_NORM_RTOL, SHARDED_CKPT_LAYERS, SHARDED_LIMIT_S = 1e-2, 2, 150.0
# (z3) serving on that mesh: llama3.2-1b's serving config at full width
# and depth, SERVE_B prompts of SERVE_S tokens prefilled into a
# SERVE_MAX-position cache, then decode steps at scalar positions
# (SERVE_DECODES of them) and one at per-row positions; mamba2-130m, one
# prefill and one decode.  Greedy tokens equal to one device's wherever
# its top-1/top-2 margin clears the rule ``lm_same_greedy`` uses; every
# logit row within the larger of SERVE_RTOL and SERVE_FLOOR_X times the
# floor (relative L2): one device against itself with its projections
# rounded once from f32, the mesh's row-parallel arithmetic, which at full
# width moves bf16 logits by ~1.5e-2 through 16 layers of rounding.
# (z4) the dry run's
# record of (z1)'s "2d" step and (z3)'s decode step on a 2x2 mesh under a
# ``fake`` group, in a subprocess: its collectives by kind equal those
# ``CommDebugMode`` counted on the card, its argument bytes rank 0's
# shards.  (z3) and (z4) together fail past SERVE_LIMIT_S.
SERVE_B, SERVE_S, SERVE_MAX, SERVE_DECODES = 4, 128, 256, 2
SERVE_RTOL, SERVE_FLOOR_X, SERVE_LIMIT_S = 2e-3, 2.0, 120.0
# Row shards (phase 12): the sharded engine's shard count on one card, the
# second count held for (a) and (c), the seeded rows appended before the
# tombstones (1 in TOMBSTONE_EVERY live rows) and the compaction.
SHARDS, SHARDS_2 = 4, 2
SHARD_APPEND = 1024
TOMBSTONE_EVERY = 100
# Row shards across processes (phase 13): ranks (each holding SHARDS /
# PROCS shards), the phase's time limit, the process group's collective
# timeout, and the queries held after the tombstones and the compaction.
PROCS = 2
PROCS_TIMEOUT_S = 600
PROCS_GROUP_S = 300
PROCS_MUTATED = ("a", "c", "e")
# Blocks a rank of phase 13's gather probe (bytes): a reduced pull, (c)'s
# joins, the verify's and (c')'s score blocks.
PROBE_BYTES = (4096, 1 << 20, 64 << 20)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


class Phase:
    card = ""    # ``nvidia-smi`` name and power limit, set by phase 1

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: {time.perf_counter() - self.t0:.1f} s "
                  f"(card: {Phase.card})", flush=True)
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_runs(engine, queries) -> None:
    """Device time by kernel and host stage seconds for one run each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.device_time import device_us
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for key, q in queries.items():
        cm = engine.compile(q)
        with profile(activities=acts) as prof:
            t = time.perf_counter()
            cm.run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        by_kernel = {}
        for ev in prof.key_averages():
            # Device-side events only (kernels, copies): an operator's
            # host event carries its kernels' time again.
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = device_us(ev)
            if us > 0:
                by_kernel[ev.key] = (us / 1e3, ev.count)
        dev_ms = sum(ms for ms, _ in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
        print(f"  ({key}) profiled wall {wall_ms:.3f} ms, device busy "
              f"{dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%)")
        for name, (ms, n) in top:
            print(f"    {ms:10.3f} ms  x{n:<6d} {name[:90]}")
        engine.obs.tracer.enabled = True
        res = cm.run()
        engine.obs.tracer.enabled = False
        engine.obs.tracer.clear()
        print(f"  ({key}) span stages (s): " + json.dumps(
            {k: round(v, 6) for k, v in res.timings.items()}))


def device_ms_turns(fns, reps: int, flush, rounds: int = 2):
    """``device_ms`` of each function, timed in turns (a, b, a, b): the
    mean per function over ``rounds`` and every round's reading."""
    from repro_torch.obs.device_time import device_ms
    runs = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            runs[k].append(device_ms(fn, reps, flush))
    return {k: sum(v) / len(v) for k, v in runs.items()}, runs


def exact_swar_ops(name: str, R: int, n_locs: int, wp: int):
    """(INT32-pipe ops, popcounts) of the shipped exact SWAR mainloop over
    R rows x n_locs alignments of a wp-word pattern (``EXACT_INT_OPS``)."""
    per_pair, per_single = EXACT_INT_OPS[name]
    n_pairs, n_single = divmod(wp, 2)
    n_shift0 = -(-n_locs // 16)           # alignments at shift 0, per row
    int_ops = R * (n_locs * (per_pair * n_pairs + per_single * n_single)
                   - n_shift0 * (2 * n_pairs + n_single))
    return int_ops, R * n_locs * (n_pairs + n_single)


def bound(nbytes: float, ops: float, ops_rate: float):
    """(bound ms, what bounds it): the larger of bytes over HBM bandwidth
    and operations over their peak rate."""
    t_ops, t_bytes = ops / ops_rate, nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def plan_kernel(plan, reduction: str) -> str:
    """The kernel a SWAR or mxu plan launches for a reduction: best and
    top-k reduce in the exact kernels' epilogues (``*_best``)."""
    if plan.backend == "swar" and plan.predicate == "accept":
        return "match_swar_masks"
    fused = "_best" if reduction in ("best", "topk") else ""
    return {"swar": "match_swar", "mxu": "match_mxu"}[plan.backend] + fused


def same_as_solo(got, solo) -> bool:
    """A service result against a solo ``engine.match`` of the same query:
    hits equal, and the best arrays equal on the rows the solo run scanned.
    A filtered threshold query verifies only its survivor rows, and a
    coalesced one the union of its group's, so the best arrays compare on
    the solo run's rows (all rows when neither filtered)."""
    import numpy as np
    if (got.hits is None) != (solo.hits is None) or (
            got.hits is not None and not np.array_equal(got.hits,
                                                        solo.hits)):
        return False
    if got.survivor_rows is None and solo.survivor_rows is None:
        pos = slice(None)
    else:
        rg = (np.arange(len(got.best_locs)) if got.survivor_rows is None
              else got.survivor_rows)
        rs = (np.arange(len(solo.best_locs)) if solo.survivor_rows is None
              else solo.survivor_rows)
        pos = np.searchsorted(rg, rs)
        if np.any(pos >= len(rg)) or not np.array_equal(rg[pos], rs):
            return False
    return (np.array_equal(got.best_locs[pos], solo.best_locs)
            and np.array_equal(got.best_scores[pos], solo.best_scores))


def service_phase(engine, bank, *, best, thr, iupac, batches, bank_hits,
                  evicted_read, n_compactions, zero_counts, read_counts,
                  sync, compact_dead_frac=0.001):
    """Phase 7: ``MatchService`` over the engine's corpus with the bank.

    ``best`` is a list of (codes, row, loc, score) exact reads taken at
    known rows, ``thr`` of (codes, row, loc) exact reads for threshold
    READ - 1, ``iupac`` one (pattern, row, loc) IUPAC read for threshold
    95; ``batches`` are doc batches with ``bank_hits`` the bank's hits on
    each when scanned alone; ``evicted_read`` occurs only in row 0.  The
    window keeps the corpus's live rows; ``n_compactions`` is how many
    compactions the ingests must trigger.  Returns what the phase prints
    as its JSON line.
    """
    import numpy as np

    from repro_torch.match import MatchQuery, MatchService
    corpus, planner = engine.corpus, engine.planner
    F = corpus.fragment_chars
    window = corpus.n_live
    svc = MatchService(engine, bank=bank, window_rows=window,
                       compact_dead_frac=compact_dead_frac)
    stats = svc.stats
    tick_ms, tick_launches = {}, {}

    def timed_tick(label):
        zero_counts()
        t = time.perf_counter()
        n = svc.tick()
        sync()
        tick_ms[label] = (time.perf_counter() - t) * 1e3
        tick_launches[label] = {k: v for k, v in read_counts().items() if v}
        return n, read_counts()

    # -- tick 1: three tenants' groups ------------------------------------
    q_best = [MatchQuery.exact(c, reduction="best") for c, *_ in best]
    q_thr = [MatchQuery.exact(c, reduction="threshold", threshold=READ - 1)
             for c, *_ in thr]
    q_iu = MatchQuery.iupac(iupac[0], reduction="threshold", threshold=95)
    queries = q_best + q_thr + [q_iu]
    groups = [(q_best, "exact"), (q_thr, "exact"), ([q_iu], "accept")]
    want_launches = want_coalesced = want_fallback = 0
    for grp, pred in groups:
        bp = planner.plan_batch(
            n_rows=corpus.n_rows, fragment_chars=F,
            pattern_chars=grp[0].pattern_chars, n_queries=len(grp),
            predicate=pred)
        print(f"  plan_batch Q={len(grp)} {pred} "
              f"{grp[0].reduction}: {bp.reason}")
        want_coalesced += int(bp.coalesced)
        want_launches += 1 if bp.coalesced else len(grp)
        want_fallback += len(grp) if len(grp) > 1 and not bp.coalesced else 0
    tickets = [svc.submit(q) for q in queries]
    n_done, counts1 = timed_tick("1")
    print(f"  tick 1: {n_done} queries in {tick_ms['1']:.3f} ms, launches "
          f"{counts1}")
    check(n_done == len(queries) and all(t.done for t in tickets),
          "tick 1 completes every ticket")
    errors = [repr(t.error) for t in tickets if t.error is not None]
    check(not errors, f"no ticket ends with an error ({errors})")
    check((stats.n_launches, stats.n_coalesced_launches,
           stats.n_sequential_fallback)
          == (want_launches, want_coalesced, want_fallback),
          "tick 1's launches are plan_batch's")
    want_kernels = set()
    for t, q in zip(tickets, queries):
        p = t.result.plan
        if p.backend != "ref":
            want_kernels.add(plan_kernel(p, q.reduction))
        if p.strategy == "filter":
            want_kernels.add("filter_qgram")
    got_kernels = {k for k, n in counts1.items() if n}
    check(got_kernels == want_kernels, f"tick 1 launched {got_kernels}, its "
          f"plans name {want_kernels}")
    for t, (_, row, loc, score) in zip(tickets, best):
        check(int(t.result.best_scores[row]) == score
              and int(t.result.best_locs[row]) == loc,
              f"best read planted at row {row} found at loc {loc}")
    for t, (_, row, loc) in zip(tickets[len(best):], thr):
        check((row, loc, READ) in {tuple(h) for h in t.result.hits.tolist()},
              f"threshold read planted at row {row} reported")
    check(iupac[1:] + (READ,) in
          {tuple(h) for h in tickets[-1].result.hits.tolist()},
          "IUPAC read's planted hit reported")
    # The same 41 queries one by one: each result equals its scattered one.
    solo_ms = {"first": 0.0, "again": 0.0}
    for key in solo_ms:
        for t, q in zip(tickets, queries):
            sync()
            t0 = time.perf_counter()
            solo = engine.match(q)
            sync()
            solo_ms[key] += (time.perf_counter() - t0) * 1e3
            check(same_as_solo(t.result, solo),
                  f"service result equals a solo run ({q.reduction})")
    print(f"  tick 1 {tick_ms['1']:.3f} ms against {len(queries)} solo runs "
          f"{solo_ms['first']:.3f} ms (first) / {solo_ms['again']:.3f} ms "
          "(again); every scattered result equals its solo run")

    # -- tick 2: the same queries from the result cache --------------------
    hits0 = stats.n_cache_hits
    again = [svc.submit(q) for q in queries]
    n_done, counts2 = timed_tick("2")
    check(stats.n_cache_hits - hits0 == len(queries)
          and all(t.cached for t in again), "tick 2 served from the cache")
    check(stats.launches_last_tick == 0 and not any(counts2.values()),
          f"tick 2 launched nothing ({counts2})")
    print(f"  tick 2: {n_done} cache hits in {tick_ms['2']:.3f} ms")

    # -- ticks 3-6: ingest against the bank, past the window ----------------
    compact = corpus.compact
    compact_ms = []

    def timed_compact():
        sync()
        t0 = time.perf_counter()
        out = compact()
        sync()
        compact_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    corpus.compact = timed_compact
    ingest = []
    try:
        for i, (docs, hits) in enumerate(zip(batches, bank_hits)):
            base_row = corpus.n_rows
            tk = svc.ingest(docs)
            label = str(3 + i)
            _, counts = timed_tick(label)
            bt = tk.bank_ticket
            filtered = bt.plan.strategy == "filter"
            check(counts["match_swar_masks"] == 1
                  and counts["bank_prefilter"] == int(filtered),
                  f"tick {label}: one bank verify launch ({counts})")
            check(np.array_equal(bt.hits, hits),
                  f"tick {label}: bank hits equal the standalone scan's")
            check(tk.start == base_row and np.array_equal(
                bt.corpus_rows, base_row + bt.hits[:, 0]),
                f"tick {label}: hits anchored at the appended rows")
            check(corpus.n_live == window, f"tick {label}: n_live == window")
            check(stats.n_evicted_rows == len(docs) * (i + 1),
                  f"tick {label}: evicted {stats.n_evicted_rows}")
            ingest.append({"tick": label, "strategy": bt.plan.strategy,
                           "n_hits": int(bt.hits.shape[0]),
                           "survivor_frac": bt.survivor_frac,
                           "ms": tick_ms[label]})
            print(f"  tick {label}: ingest {len(docs)} docs, bank "
                  f"{bt.plan.strategy}, {bt.hits.shape[0]} hits, "
                  f"{tick_ms[label]:.3f} ms, live {corpus.n_live} of "
                  f"{corpus.n_rows} rows")
            if i == 0:
                # The generation moved: tick 1's first query runs again.
                t = svc.submit(q_best[0])
                timed_tick("3b")
                check(not t.cached and t.error is None,
                      "after an ingest the cache is dropped")
    finally:
        del corpus.compact
    check(stats.n_compactions == corpus.n_compactions == n_compactions
          and len(compact_ms) == n_compactions,
          f"{n_compactions} compaction(s) ({stats.n_compactions})")
    print(f"  compaction: {compact_ms} ms")

    # -- after the window: the newest row found, the evicted one gone -------
    newest = batches[-1][-1][:READ]
    res = svc.match(newest, reduction="threshold", threshold=READ)
    check((corpus.n_rows - 1, 0, READ) in {tuple(h) for h in
                                          res.hits.tolist()},
          "the newest ingested row is found")
    res = svc.match(evicted_read, reduction="threshold", threshold=READ)
    check(res.hits.shape[0] == 0, "the evicted row is gone")
    tracer = engine.obs.tracer
    bp = planner.plan_batch(n_rows=corpus.n_rows, fragment_chars=F,
                            pattern_chars=READ, n_queries=2)
    check(bp.coalesced, "two exact reads coalesce")
    tracer.enabled = True
    try:
        for q in q_best[:2]:
            svc.submit(q)
        timed_tick("traced")
        names = {sp.name for sp in tracer.iter_spans()}
    finally:
        tracer.enabled = False
        tracer.clear()
    want = {"service.tick", "service.coalesce", "service.enqueue"}
    check(want <= names, f"spans {sorted(want - names)} traced")
    snap = stats.snapshot()
    check(snap["n_failed"] == 0, "no ticket failed")
    print("service_stats " + json.dumps(snap))
    print(f"  latency p50 {snap['latency_p50_s'] * 1e3:.3f} ms, p95 "
          f"{snap['latency_p95_s'] * 1e3:.3f} ms, p99 "
          f"{snap['latency_p99_s'] * 1e3:.3f} ms, {snap['qps']} qps")
    return {"tick_ms": tick_ms, "tick_launches": tick_launches,
            "solo_ms": solo_ms, "compact_ms": compact_ms, "ingest": ingest,
            "n_queries": len(queries)}


def same_answer(a, b) -> bool:
    """Two plans' results of one query: top-k equal, and hits and best
    arrays as ``same_as_solo`` holds them (the filtered result, whose
    best arrays cover its survivors only, taken as the solo run)."""
    import numpy as np
    for f in ("topk_rows", "topk_scores"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (
                x is not None and not np.array_equal(x, y)):
            return False
    if b.survivor_rows is None:
        a, b = b, a
    return same_as_solo(a, b)


def calibration_phase(engine, bank, queries, *, zero_counts, read_counts,
                      sync, autotune_kw=None):
    """Phase 8: calibrate the card, then run ``queries`` (key -> query)
    under the fitted table over the engine's corpus.

    ``autotune_kw`` is passed to both autotunes (a rehearsal on the CPU
    passes ``device="cpu"``).  Every calibrated answer must equal the
    static engine's on the same corpus.  Returns what the phase prints
    as its JSON line.
    """
    import tempfile

    from repro_torch.core.tech import StaticCostSource
    from repro_torch.match import MatchEngine, Planner
    from repro_torch.match import calibrate as cal
    kw = dict(device=engine.device, **(autotune_kw or {}))
    kernel_of = {"swar": "match_swar", "swar_masks": "match_swar_masks",
                 "mxu": "match_mxu", "filter": "filter_qgram",
                 "bank_prefilter": "bank_prefilter"}

    # -- autotune ----------------------------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    table = cal.autotune(verbose=True, **kw)
    autotune_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"  autotune {autotune_s:.3f} s; launches {counts}")
    check(set(table.curves) == set(cal.KERNELS),
          f"every priced kernel fitted ({sorted(table.curves)})")
    for key, name in kernel_of.items():
        check(counts[name] > 0, f"autotune launched {name} for {key}")
    for key in cal.KERNELS:
        c = table.curves[key]
        print(f"  curve {key}: alpha {c.alpha:.6g} beta {c.beta:.6g} s "
              f"rel_err {c.rel_err} n {c.n_samples}")
    print(f"  table {table.device_kind} / {table.backend} / interpret "
          f"{table.interpret}, digest {table.digest}")
    src = table.cost_source()
    static = StaticCostSource()

    # -- round trip and stability -----------------------------------------
    with tempfile.TemporaryDirectory() as d:
        path = table.save(Path(d))
        loaded = cal.load_cost_source(directory=Path(d),
                                      device=engine.device)
        check(loaded is not None and loaded.digest == table.digest,
              f"{path.name} loads back with digest {table.digest[:8]}")
        check(cal.golden_decisions(loaded) == cal.golden_decisions(src),
              "the loaded table's golden decisions are the fitted table's")
    t0 = time.perf_counter()
    second = cal.autotune(**kw)
    second_s = time.perf_counter() - t0
    ok, rows = cal.decisions_stable(src, second.cost_source())
    golden_static = dict(cal.golden_decisions(static))
    golden_cal = dict(cal.golden_decisions(src))
    for r in rows:
        print(f"  golden {r['shape']}: static {golden_static[r['shape']]}, "
              f"calibrated {r['choice_a']}, second {r['choice_b']} "
              f"(stable {r['stable']}, neutral {r['cost_neutral']})")
    print(f"  second autotune {second_s:.3f} s, digest {second.digest[:8]}"
          f"; curves " + json.dumps({k: [c.alpha, c.beta] for k, c in
                                     sorted(second.curves.items())}))
    check(ok, "two autotunes make the same (or cost-neutral) decisions")

    # -- queries under the calibrated planner --------------------------------
    corpus = engine.corpus
    want = {}
    for key, q in queries.items():
        want[key] = engine.compile(q).run()
    calibrated = MatchEngine(corpus, cost_source=src)
    check(calibrated.record_runtimes, "a calibrated engine records runtimes")
    fb = calibrated.planner.feedback
    runs = {}
    zero_counts()
    for key, q in queries.items():
        cm = calibrated.compile(q)
        runs[key] = []
        for i in range(3):
            sync()
            t0 = time.perf_counter()
            res = cm.run()
            sync()
            wall = time.perf_counter() - t0
            check(same_answer(res, want[key]),
                  f"({key}) run {i}: calibrated answer equals the static "
                  "engine's")
            p, ps = res.plan, want[key].plan
            run = {"backend": p.backend, "strategy": p.strategy,
                   "chunk_rows": p.chunk_rows, "est_s": p.est_seconds,
                   "wall_s": wall, "n_observations": fb.n_observations,
                   "repriced": sorted("/".join(map(str, k))
                                      for k in fb.repriced()),
                   "static": [ps.backend, ps.strategy, ps.est_seconds]}
            runs[key].append(run)
            print(f"  ({key}) run {i}: {p.backend}/{p.strategy} chunks of "
                  f"{p.chunk_rows}, priced {p.est_seconds * 1e3:.4f} ms, "
                  f"took {wall * 1e3:.4f} ms "
                  f"(x{wall / max(p.est_seconds, 1e-12):.3g}); "
                  f"{fb.n_observations} observations, repriced "
                  f"{run['repriced']}; static {ps.backend}/{ps.strategy} "
                  f"priced {ps.est_seconds * 1e3:.4f} ms")
        flips = {(r["backend"], r["strategy"]) for r in runs[key]}
        if len(flips) > 1:
            print(f"  ({key}) feedback flipped its plan: "
                  f"{[(r['backend'], r['strategy']) for r in runs[key]]}")
    counts = read_counts()
    print(f"  launches on the calibrated path: {counts}")
    want_kernels = set()
    for key, q in queries.items():
        for r in runs[key]:
            if r["backend"] != "ref":
                want_kernels.add(plan_kernel(
                    dataclasses.replace(want[key].plan, backend=r["backend"]),
                    q.reduction))
            if r["strategy"] == "filter":
                want_kernels.add("filter_qgram")
    got_kernels = {k for k, n in counts.items() if n}
    check(want_kernels <= got_kernels, f"the calibrated plans' kernels "
          f"{sorted(want_kernels)} launched ({sorted(got_kernels)})")

    # (c) without its forced backend, and the bank, under both sources.
    qc = queries["c"]
    shape = dict(n_rows=corpus.n_rows, fragment_chars=corpus.fragment_chars,
                 pattern_chars=qc.pattern_chars, n_patterns=qc.n_patterns)
    free_c = {name: Planner(cost_source=s).plan(**shape)
              for name, s in (("static", static), ("calibrated", src))}
    for name, p in free_c.items():
        print(f"  (c) unforced, {name}: {p.backend}: {p.reason}")
    bank_kw = dict(n_docs=BANK_DOCS, fragment_chars=bank.fragment_chars,
                   pattern_chars=bank.pattern_chars, n_patterns=bank.n_live,
                   sig_words=bank.sig_words,
                   survivor_frac=bank.estimate_survivor_frac(),
                   prunable=bank.prunable)
    bank_plans = {name: Planner(cost_source=s).plan_bank(**bank_kw)
                  for name, s in (("static", static), ("calibrated", src))}
    for name, bp in bank_plans.items():
        print(f"  bank, {name}: {bp.strategy}: {bp.reason}")

    # -- the fused kernels beside the STORE curve ----------------------------
    fused = {}
    for name, key in cal.FUSED.items():
        top = cal.FULL_GRID[key][-1]
        analytic, fused_s = cal.measure(name, top, device=engine.device,
                                        repeats=10)
        store_s = table.samples[key][-1]["measured_s"]
        fused[name] = {"shape": top, "measured_s": fused_s,
                       "store_measured_s": store_s,
                       "store_curve_s": table.curves[key].seconds(analytic)}
        print(f"  {name} at {top}: {fused_s * 1e3:.4f} ms; STORE "
              f"{store_s * 1e3:.4f} ms measured, "
              f"{fused[name]['store_curve_s'] * 1e3:.4f} ms on the curve")

    # -- the committed table --------------------------------------------------
    committed = cal.load_cost_source(device=engine.device)
    print(f"  committed table for this card: "
          f"{committed.tag if committed is not None else 'none'} "
          f"({cal.calibration_dir()})")
    if committed is not None:
        dec = cal.golden_decisions(committed)
        print(f"  committed table's golden decisions equal this run's: "
              f"{dec == cal.golden_decisions(src)}")
    provenance = cal.bench_provenance(src, device=engine.device)
    print(f"  provenance {json.dumps(provenance)}")
    check(provenance["power_limit_w"] is not None,
          "the card's power limit read by its UUID")
    return {"autotune_s": autotune_s, "second_autotune_s": second_s,
            "table": table.to_json(), "second_table": second.to_json(),
            "stability": rows, "golden_static": golden_static,
            "golden_calibrated": golden_cal, "runs": runs,
            "c_unforced": {n: [p.backend, p.est_seconds]
                           for n, p in free_c.items()},
            "bank": {n: [bp.strategy, bp.est_seconds]
                     for n, bp in bank_plans.items()},
            "fused": fused,
            "committed": committed.tag if committed is not None else None,
            "provenance": provenance}


def cram_bound(n_rows: int, packed, bits: bool = True):
    """(bound ms, what bounds it) of one program over ``n_rows`` rows: the
    columns it must read (touched, less those written before any read)
    read once, the written ones written once, the program read once; and
    the operations at the INT32 peak: bit-sliced, ``BITS_INT_OPS`` a
    32-row word an op, a byte a cell, the gates' INT32 operations a row
    (``CRAM_INT_OPS``)."""
    import numpy as np
    read = int((packed.cols >= 0).sum()) - packed.n_fresh
    nbytes = (n_rows * (read + packed.n_written)
              + len(packed) * 16 + packed.n_touched * 4)
    if bits:
        ops = -(-n_rows // 32) * len(packed) * BITS_INT_OPS
    else:
        ops = n_rows * int(np.asarray(CRAM_INT_OPS)[packed.opc].sum())
    return bound(nbytes, ops, PEAK_INT32)


def cram_edge_programs():
    """Phase 9 (a): (rows, cols, ops) cases and the byte form's launch
    geometry each reaches, (rows a block, staged, above 48 KB of shared
    memory): one row; row counts off the 128-row block; staged within 48
    KB and above it (128 rows a block), 64 and 32 rows a block; and
    touched columns past what 32 rows' staging holds (unstaged).  The
    bit-sliced form runs each at every block size its staging fits (all
    four, down to 8 words only, and none at 9,000 columns)."""
    small, big = (128, True, False), (128, True, True)
    return [(1, 8, 60, small), (31, 16, 200, small), (33, 16, 200, small),
            (129, 40, 300, small), (1000, 64, 500, small),
            (257, 600, 400, big), (300, 3000, 2000, (64, True, True)),
            (100, 6000, 4000, (32, True, True)),
            (200, 9000, 6000, (128, False, False))]


def random_cram_program(rng, n_ops: int, n_cols: int):
    """Every opcode at least once, random columns, every fifth op reading
    its own output column, padded inputs random but in range (never
    read)."""
    import numpy as np
    opc = np.concatenate([np.arange(11), rng.integers(0, 11, n_ops - 11)])
    ins = rng.integers(0, n_cols, (n_ops, 5))
    out = rng.integers(0, n_cols, n_ops)
    out[::5] = ins[::5, 0]
    return opc, ins, out


def event_ms(fn):
    """(milliseconds, result) of one call of ``fn``, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), res


def cram_phase(frags_chr1, read, planted, *, zero_counts, read_counts,
               sync, device="cuda", paper=(PAPER_ROWS, PAPER_COLS)):
    """Phase 9: the CRAM-PM functional model on the card.

    (a) both forms of ``cram_execute`` against ``execute_plain`` at edge
    shapes, bit for bit: random uint8 states through ``execute`` (the
    byte form, every launch geometry), random 0/1 states through the
    bit-sliced kernel at every block size that fits (some outputs out of
    range, dropped) and through ``execute``, and a ``CRAMArray`` whose 0/1
    state holds one 2 in a touched column (the byte form) beside the same
    array without it (the bit-sliced form); (b) the paper's array
    (``Design()``'s 10,000 x 2,400): one alignment's program under both
    schedules, kernel against plain on the whole state, then
    ``Matcher.run()`` over all its alignments against the SWAR path's
    scores; (c) Algorithm 1 over ``frags_chr1`` with ``read``: every
    alignment, scores against the SWAR path's, the best alignment at
    ``planted`` (row, loc), and the byte form timed on the same state.
    The bit-sliced kernel's count of staged bytes above 1 must stay 0.
    Returns the two kernel rows, their path launches and what the phase
    prints.  ``device`` and ``paper`` (rows, columns) let the phase be
    rehearsed on the CPU at a small size, with ``cuda_ms`` and
    ``event_ms`` patched to a host clock, counting kernel entries and
    ``n_sms``."""
    import numpy as np
    import torch

    from repro_torch.core import costmodel
    from repro_torch.core.array import CRAMArray, execute, execute_plain
    from repro_torch.core.matcher import (Matcher, best_alignment,
                                          compile_alignment, plan_layout)
    from repro_torch.kernels import cram_array as kca
    from repro_torch.kernels import ops

    dev = torch.device(device)
    n_sms = (torch.cuda.get_device_properties(dev).multi_processor_count
             if dev.type == "cuda" else 132)
    rng = np.random.default_rng(SEED + 9)
    err = {"bits": 0, "bytes": 0}
    info = {}
    over = kca.over_one(dev)
    over.zero_()

    def held(got, want, what, form):
        e = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) \
            if got.numel() else 0
        err[form] = max(err[form], e)
        check(e == 0, f"cram_execute ({form}) equals execute_plain: {what}")

    def launched(n0, bits, nbytes, what):
        n = read_counts()
        check((n["cram_execute"] - n0["cram_execute"],
               n["cram_execute_bytes"] - n0["cram_execute_bytes"])
              == (bits, nbytes), f"{what}: {bits} bit-sliced and {nbytes} "
              f"byte launches, got {n}")

    # (a) edge shapes, the byte form's path first: uint8 states and the
    # one-2 array go through the entries a user calls.
    zero_counts()
    for R, C, n_ops, want_geo in cram_edge_programs():
        state = torch.from_numpy(rng.integers(0, 256, (R, C), np.uint8)).to(
            dev)
        before = state.clone()
        opc, ins, out = random_cram_program(rng, n_ops, C)
        packed = kca.pack_program(opc, ins, out, C, dev)
        geo = kca.launch_geometry(packed.n_touched)
        check((geo.block_rows, geo.staged, geo.smem_bytes > 48 * 1024)
              == want_geo, f"R={R} C={C} ops={n_ops} reaches {want_geo}, "
              f"got {geo}")
        n0 = read_counts()
        got = execute(state, opc, ins, out)
        held(got, execute_plain(state, opc, ins, out),
             f"R={R} C={C} ops={n_ops} T={packed.n_touched} ({want_geo})",
             "bytes")
        check(torch.equal(state, before), "execute leaves its input as it was")
        inplace = kca.cram_execute_(state.clone(), packed)
        held(inplace, got, f"in place, R={R} C={C}", "bytes")
        launched(n0, 0, 2, f"uint8 state R={R} C={C}")
    R, C = 3000, 600
    opc, ins, out = random_cram_program(rng, 800, C)
    cells = rng.integers(0, 2, (R, C), np.uint8)
    two = cells.copy()
    two[1234, int(ins[0, 0])] = 2
    prog = kca.pack_program(opc, ins, out, C, dev)
    for a, want_form in ((two, "bytes"), (cells, "bits")):
        arr = CRAMArray(R, C, device=dev)
        arr.write_column_rows(0, a)
        check(arr.binary == (want_form == "bits"), "the binary flag")
        n0 = read_counts()
        arr.run_packed(prog)
        launched(n0, int(want_form == "bits"), int(want_form == "bytes"),
                 f"CRAMArray, {want_form}")
        held(arr.state, execute_plain(
            torch.from_numpy(a).to(dev), opc, ins, out),
            f"CRAMArray {R} x {C}, 0/1{' but one 2' if a is two else ''}",
            want_form)
    launches_bytes = read_counts()["cram_execute_bytes"]
    # The bit-sliced form at every block size that fits, outputs dropped.
    reached = set()
    for R, C, n_ops, _ in cram_edge_programs():
        state = torch.from_numpy(rng.integers(0, 2, (R, C), np.uint8)).to(
            dev)
        opc, ins, out = random_cram_program(rng, n_ops, C)
        out[7::13] = C + 3
        packed = kca.pack_program(opc, ins, out, C, dev)
        want = execute_plain(state, opc, ins, out)
        for w in kca.BITS_WORDS:
            if kca.bits_geometry(packed.n_touched, R, n_sms, w) is None:
                continue
            n0 = read_counts()
            held(kca.cram_execute_bits(state.clone(), packed, words=w),
                 want, f"R={R} C={C} ops={n_ops} T={packed.n_touched}, "
                 f"{w} words a block", "bits")
            launched(n0, 1, 0, f"bit-sliced R={R} C={C} W={w}")
            reached.add(w)
        n0 = read_counts()
        held(execute(state, opc, ins, out), want,
             f"execute, 0/1 state R={R} C={C}", "bits")
        fits = kca.pick_form(packed, True, R, n_sms) == "bits"
        launched(n0, int(fits), int(not fits), f"execute, 0/1 R={R} C={C}")
    check(reached == set(kca.BITS_WORDS), f"block sizes reached {reached}")
    state = torch.from_numpy(rng.integers(0, 256, (70, 9), np.uint8)).to(dev)
    n0 = read_counts()
    empty = execute(state, np.zeros(0, np.int32), np.zeros((0, 5), np.int32),
                    np.zeros(0, np.int32))
    check(torch.equal(empty, state), "an empty program returns the state")
    launched(n0, 0, 0, "the empty program")
    pair = torch.tensor([[2], [5]], dtype=torch.uint8, device=dev).expand(
        2, 4).contiguous()
    inv_copy = execute(pair, np.array([6, 7]), np.zeros((2, 5)),
                       np.array([1, 2]))
    check(inv_copy[:, 1].tolist() == [255, 252]
          and inv_copy[:, 2].tolist() == [2, 5],
          "INV of 2, 5 is 255, 252 and COPY keeps them (int32, then uint8)")
    sync()
    check(int(over) == 0, "no staged byte above 1 in the bit-sliced form")
    print(f"  (a) {len(cram_edge_programs())} edge shapes bit-identical in "
          "both forms: uint8 states (bytes, every launch geometry), 0/1 "
          f"states (bits, blocks of {sorted(reached)} words, outputs out of "
          "range dropped), the one-2 array (bytes) beside the 0/1 one "
          "(bits), the empty program, INV/COPY of 2, 5; "
          f"{launches_bytes} byte launches on the byte form's path")

    # (b) the paper's array.
    t0 = time.perf_counter()
    n_paper, c_paper = paper
    layout = plan_layout(c_paper, READ, scratch_budget=PAPER_SCRATCH)
    if paper == (PAPER_ROWS, PAPER_COLS):
        check((layout.fragment_chars, layout.n_alignments) == (982, 883),
              f"paper layout {layout}")
    frags = rng.integers(0, 4, (n_paper, layout.fragment_chars), np.uint8)
    pat = rng.integers(0, 4, READ, np.uint8)
    p_row = int(rng.integers(0, n_paper))
    p_loc = int(rng.integers(0, layout.n_alignments))
    frags[p_row, p_loc:p_loc + READ] = pat
    m = Matcher(frags, READ, n_cols=c_paper, device=dev)
    m.load_pattern(pat)
    check(m.array.binary, "the Matcher's array is 0/1")
    b_kernel_ms, b_plain_ms = {}, {}
    for opt in (False, True):
        prog, _ = compile_alignment(layout, p_loc, opt=opt)
        enc = prog.encode()
        packed = kca.pack_program(*enc, c_paper, dev)
        st = m.array.state
        n0 = read_counts()
        held(execute(st, *enc), execute_plain(st, *enc),
             f"paper array, one alignment, opt={opt}", "bits")
        launched(n0, 1, 0, "paper array, execute")
        work = st.clone()
        b_kernel_ms[opt] = cuda_ms(lambda: kca.cram_execute_bits(work,
                                                                 packed), 5)
        del work
        b_plain_ms[opt] = cuda_ms(lambda: execute_plain(st, *enc), 1)
    work = m.array.state.clone()
    b_bytes_ms = cuda_ms(lambda: kca.cram_execute_bytes(work, packed), 5)
    held(work, execute_plain(m.array.state, *enc),
         "paper array, one alignment, opt=True", "bytes")
    del work
    bound_b = cram_bound(n_paper, packed)
    bound_b_bytes = cram_bound(n_paper, packed, bits=False)
    geo_b = kca.bits_geometry(packed.n_touched, n_paper, n_sms)
    t = time.perf_counter()
    for loc in range(layout.n_alignments):
        m._program_for(loc)
    codegen_b = time.perf_counter() - t
    sync()
    n0 = read_counts()
    t = time.perf_counter()
    scores = m.run()
    sync()
    run_b = time.perf_counter() - t
    launched(n0, layout.n_alignments, 0, "paper array, Matcher.run")
    swar = ops.match_scores(frags, pat, backend="swar", device=dev)
    check(np.array_equal(scores, swar),
          "paper array: Matcher scores equal the SWAR path's")
    locs_b, best_b = best_alignment(scores)
    check(int(best_b[p_row]) == READ and int(locs_b[p_row]) == p_loc,
          "paper array: the planted alignment scores 100")
    modeled = costmodel.pass_cost(costmodel.Design()).latency_s
    info["paper"] = {
        "rows": n_paper, "cols": c_paper,
        "alignments": layout.n_alignments, "codegen_s": codegen_b,
        "run_s": run_b, "kernel_ms": b_kernel_ms[True],
        "kernel_ms_naive_schedule": b_kernel_ms[False],
        "bytes_ms": b_bytes_ms, "plain_ms": b_plain_ms[True],
        "bound_ms": bound_b[0], "bound_by": bound_b[1],
        "bytes_bound_ms": bound_b_bytes[0], "geometry": geo_b._asdict(),
        "touched_cols": packed.n_touched, "model_pass_latency_s": modeled,
        "set_up_s": time.perf_counter() - t0 - run_b - codegen_b}
    print(f"  (b) {n_paper} x {c_paper}, {layout.n_alignments} "
          f"alignments: scores equal the SWAR path's; codegen "
          f"{codegen_b:.2f} s, Matcher.run {run_b:.3f} s a pass (the cost "
          f"model's Design() pass: {modeled:.4g} s, for context only); one "
          f"alignment, bit-sliced {b_kernel_ms[True]:.4f} ms (naive "
          f"schedule {b_kernel_ms[False]:.4f}; {geo_b.words} words a "
          f"block, {geo_b.blocks} blocks), byte form {b_bytes_ms:.4f} ms, "
          f"plain {b_plain_ms[True]:.1f} ms, bound {bound_b[0]:.4f} ms "
          f"({bound_b[1]}); card: {Phase.card}")

    # (c) Algorithm 1 at chr1 size.
    t0 = time.perf_counter()
    p_row, p_loc = planted
    m = Matcher(frags_chr1, READ, device=dev)
    m.load_pattern(read)
    check(m.array.binary, "the Matcher's array is 0/1")
    sync()
    set_up = time.perf_counter() - t0
    lay = m.layout
    t = time.perf_counter()
    progs = [m._program_for(loc)[0] for loc in range(lay.n_alignments)]
    codegen_c = time.perf_counter() - t
    st = m.array.state
    R = st.shape[0]
    enc = (progs[0].opc, progs[0].ins, progs[0].out)
    plain_c, want = event_ms(lambda: execute_plain(st, *enc))
    n0 = read_counts()
    held(execute(st, *enc), want, f"chr1 state, loc 0 ({R} rows)", "bits")
    launched(n0, 1, 0, "chr1, execute")
    work = st.clone()
    kca.cram_execute_bytes(work, progs[0])
    held(work, want, f"chr1 state, loc 0 ({R} rows)", "bytes")
    del want, work
    zero_counts()
    sync()
    t = time.perf_counter()
    scores = m.run()
    sync()
    run_c = time.perf_counter() - t
    launches = read_counts()
    check(launches["cram_execute"] == lay.n_alignments
          and launches["cram_execute_bytes"] == 0,
          "Matcher.run launches the bit-sliced cram_execute once an "
          f"alignment, the byte form never: {launches}")
    kernel_c, _ = event_ms(lambda: [kca.cram_execute_bits(st, pk)
                                     for pk in progs])
    # Where a launch's time goes: its first op alone (the staging and the
    # write-back), and presets of the written columns alone (the
    # write-back, nothing staged).
    first = dataclasses.replace(
        progs[0], opc=progs[0].opc[:1], ins=progs[0].ins[:1],
        out=progs[0].out[:1], ops=progs[0].ops[:1],
        ops_bits=progs[0].ops_bits[:1])
    written = kca.pack_program(
        np.zeros(progs[0].n_written, np.int64),
        np.zeros((progs[0].n_written, 5), np.int64),
        progs[0].cols[:progs[0].n_written].cpu().numpy(), lay.n_cols, dev)
    check(written.n_fresh == written.n_touched == progs[0].n_written,
          "the write-back program stages nothing")
    # The same launch staging every touched column, the written-before-read
    # ones too (the kernel skips those).
    staged_all = dataclasses.replace(progs[0], n_fresh=0)
    all_c = cuda_ms(lambda: kca.cram_execute_bits(st, staged_all), 5)
    stage_wb_c = cuda_ms(lambda: kca.cram_execute_bits(st, first), 5)
    wb_c = cuda_ms(lambda: kca.cram_execute_bits(st, written), 5)
    # Yardstick (never used by the port): PyTorch writing the same columns.
    w_idx = progs[0].cols[:progs[0].n_written].long()
    fill_c = cuda_ms(lambda: st.index_fill_(1, w_idx, 0), 5)
    n_bytes_timed = min(CRAM_BYTES_TIMED, len(progs))
    bytes_c, _ = event_ms(lambda: [kca.cram_execute_bytes(st, pk)
                                    for pk in progs[:n_bytes_timed]])
    bytes_c /= n_bytes_timed
    t = time.perf_counter()
    swar = ops.match_scores(frags_chr1, read, backend="swar", device=dev)
    swar_s = time.perf_counter() - t
    check(np.array_equal(scores, swar),
          f"chr1: Matcher scores equal the SWAR path's ({R} x "
          f"{lay.n_alignments})")
    locs_c, best_c = best_alignment(scores)
    check(int(best_c.max()) == READ and int(best_c.argmax()) == p_row
          and int(locs_c[p_row]) == p_loc
          and int(np.count_nonzero(scores == READ)) == 1,
          "chr1: the best alignment is the planted row and location")
    sync()
    check(int(over) == 0, "no staged byte above 1 in the bit-sliced form")
    bound_c = cram_bound(R, progs[0])
    bound_c_bytes = cram_bound(R, progs[0], bits=False)
    geo_c = kca.bits_geometry(progs[0].n_touched, R, n_sms)
    n_ops = len(progs[0])
    info["chr1"] = {
        "rows": R, "cols": lay.n_cols, "alignments": lay.n_alignments,
        "ops_per_alignment": n_ops, "touched_cols": progs[0].n_touched,
        "written_cols": progs[0].n_written, "set_up_s": set_up,
        "codegen_s": codegen_c, "run_s": run_c,
        "kernel_ms_total": kernel_c,
        "kernel_ms": kernel_c / lay.n_alignments, "bytes_ms": bytes_c,
        "first_op_ms": stage_wb_c, "write_back_ms": wb_c,
        "all_columns_staged_ms": all_c,
        "index_fill_ms": fill_c,
        "bytes_launches_timed": n_bytes_timed,
        "host_ms_in_run": run_c * 1e3 - kernel_c, "plain_ms": plain_c,
        "swar_s": swar_s, "launches": launches["cram_execute"],
        "row_alignments_per_s": R * lay.n_alignments / run_c,
        "row_ops_per_s": R * lay.n_alignments * n_ops / run_c,
        "bound_ms": bound_c[0], "bound_by": bound_c[1],
        "bytes_bound_ms": bound_c_bytes[0],
        "bytes_bound_by": bound_c_bytes[1], "geometry": geo_c._asdict(),
        "over_one": int(over)}
    print(f"  (c) {R} rows x {lay.n_cols} columns "
          f"({R * lay.n_cols / 1e6:.0f} MB of state), {lay.n_alignments} "
          f"alignments of {n_ops} ops ({progs[0].n_touched} columns "
          f"touched, {progs[0].n_written} written): Matcher.run "
          f"{run_c:.3f} s, {launches['cram_execute']} bit-sliced launches "
          f"({geo_c.words} words a block, {geo_c.blocks} blocks, "
          f"{geo_c.blocks_per_sm} an SM), kernels {kernel_c:.1f} ms "
          f"({kernel_c / lay.n_alignments:.4f} ms a launch, bound "
          f"{bound_c[0]:.4f} ms, {bound_c[1]}; staging all "
          f"{progs[0].n_touched} touched columns {all_c:.4f} ms; its first "
          f"op alone "
          f"{stage_wb_c:.4f} ms, the write-back alone {wb_c:.4f} ms, "
          f"torch index_fill_ of the written columns {fill_c:.4f} ms), "
          f"byte form "
          f"{bytes_c:.4f} ms a launch over {n_bytes_timed} (bound "
          f"{bound_c_bytes[0]:.4f} ms, {bound_c_bytes[1]}), host readout "
          f"{run_c * 1e3 - kernel_c:.1f} ms; codegen {codegen_c:.2f} s, "
          f"set-up {set_up:.2f} s; "
          f"{R * lay.n_alignments / run_c:.4g} row-alignments/s; plain "
          f"{plain_c:.1f} ms an alignment; scores equal the SWAR path's "
          f"({swar_s:.2f} s), best at the planted ({p_row}, {p_loc}); "
          f"staged bytes above 1: {int(over)}; card: {Phase.card}")
    rows = [dict(
        name="cram_execute", rows=R, ms=kernel_c / lay.n_alignments,
        event_ms=kernel_c / lay.n_alignments, plain_ms=plain_c,
        bound_ms=bound_c[0], bound_by=bound_c[1], library_ms=None,
        max_abs_err=err["bits"], ms_paper=b_kernel_ms[True],
        bound_ms_paper=bound_b[0]), dict(
        name="cram_execute_bytes", rows=R, ms=bytes_c, event_ms=bytes_c,
        plain_ms=plain_c, bound_ms=bound_c_bytes[0],
        bound_by=bound_c_bytes[1], library_ms=None,
        max_abs_err=err["bytes"], ms_paper=b_bytes_ms,
        bound_ms_paper=bound_b_bytes[0])]
    return rows, {"cram_execute": launches["cram_execute"],
                  "cram_execute_bytes": launches_bytes}, info


def lm_errors(got, want) -> dict:
    """``got`` against ``want`` (..., V) logits: max abs and relative L2
    error, the share of elements past 3e-2 elementwise, and the rows whose
    argmax differs (``differ``) and whose ``want`` top-1/top-2 margin is
    under the elementwise tolerance (``near``)."""
    got, want = got.float().cpu(), want.float().cpu()
    diff = got - want
    top2 = want.reshape(-1, want.shape[-1]).topk(2, -1).values
    near = (top2[:, 0] - top2[:, 1]) < LM_ATOL + LM_RTOL * top2[:, 0].abs()
    differ = (got.reshape(near.shape[0], -1).argmax(-1)
              != want.reshape(near.shape[0], -1).argmax(-1))
    return {"max_abs": float(diff.abs().max()),
            "rel_l2": float(diff.norm() / want.norm()),
            "frac_outside_elementwise": float(
                (diff.abs() > LM_ATOL + LM_RTOL * want.abs()).float().mean()),
            "argmax_near_ties": int(differ.sum()),
            "argmax_past_margin": int((differ & ~near).sum())}


def lm_close(got, want, what: str) -> dict:
    """``got`` against ``want`` (..., V) logits at the reference's bf16
    tolerance, 3e-2, taken over the whole tensor: the relative L2 error
    must be under it, and every row's argmax must agree unless ``want``'s
    top-1/top-2 margin is under the elementwise tolerance (a near-tie,
    counted).  Elementwise 3e-2 is reported, not required: at 128,256
    logits a row, two bf16 paths of the same function differ past it at
    a few elements (the reference's own paths do so on its smoke
    configs)."""
    out = lm_errors(got, want)
    check(out["rel_l2"] <= LM_RTOL, f"{what}: relative L2 error "
          f"{out['rel_l2']:.4f} past {LM_RTOL} ({out})")
    check(not out["argmax_past_margin"], f"{what}: argmax differs where "
          f"the margin is past the tolerance ({out})")
    return out


def lm_compare(out, key: str, got, want, what: str, dropped: int) -> None:
    """``out[key]`` = ``lm_close`` of the comparison when none of its calls
    dropped an MoE assignment (it is held: ``what`` joins ``out["held"]``);
    else the reference's capacity semantics make the two sides different
    functions, and the errors are recorded, not checked."""
    if dropped:
        out[key] = dict(lm_errors(got, want), held=False, dropped=dropped)
        print(f"  {what}: not held, {dropped} assignments dropped")
    else:
        out[key] = dict(lm_close(got, want, what), held=True)
        out["held"].append(what)


class MoEDrops:
    """While open, counts the assignments ``layers.moe_route`` drops (a
    wrapper over it, looked up by ``moe_apply`` at each call); ``dropped``
    holds the count once closed, 0 where no MoE layer ran.  With
    ``keep_gates`` it also keeps every call's gates."""

    def __init__(self, keep_gates: bool = False):
        self.keep_gates, self.gates, self._n = keep_gates, [], []
        self.dropped = None

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.route = layers, layers.moe_route

        def counting(cfg, gates):
            r = self.route(cfg, gates)
            self._n.append((~r.keep).sum())
            if self.keep_gates:
                self.gates.append(gates)
            return r
        layers.moe_route = counting
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.route
        self.dropped = sum(int(n) for n in self._n)
        return False


class Calls:
    """While open, counts the calls of ``module.name`` (a wrapper over it,
    looked up at each call): ``n``."""

    def __init__(self, module, name: str):
        self.module, self.name, self.n = module, name, 0

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def counting(*args, **kw):
            self.n += 1
            return self.fn(*args, **kw)
        setattr(self.module, self.name, counting)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def lm_top2(logits):
    """(top-1, top-2) values of one row of logits, as floats."""
    import torch
    t = torch.topk(logits.float().reshape(-1), 2).values.cpu()
    return float(t[0]), float(t[1])


def lm_same_greedy(lm, prompt, want, got, what: str, top2_at=None) -> bool:
    """Greedy streams equal token for token; where they differ, the
    margin rule: the top-1/top-2 logit margin behind ``want``'s token at
    the first differing step must be under the logit tolerance, and the
    tie is printed.  ``top2_at(i)`` gives that step's (top-1, top-2)
    logits as ``want``'s own run computed them; by default the full
    forward over ``want``'s context on the same card.  True when equal."""
    import numpy as np
    want, got = np.asarray(want).reshape(-1), np.asarray(got).reshape(-1)
    n = min(len(want), len(got))
    diff = np.flatnonzero(want[:n] != got[:n])
    if not len(diff):
        check(len(want) == len(got), f"{what}: stream lengths")
        return True
    i = int(diff[0])
    if top2_at is None:
        ctx = np.concatenate([np.asarray(prompt).reshape(-1), want[:i]])
        top1, top2 = lm_top2(lm.forward({"tokens": ctx[None]})[0][0, -1])
    else:
        top1, top2 = top2_at(i)
    margin = top1 - top2
    tol = LM_ATOL + LM_RTOL * abs(top1)
    check(margin < tol, f"{what}: streams differ at step {i} with a "
          f"top-1/top-2 margin of {margin:.4f} past {tol:.4f}")
    print(f"  {what}: near-tie at step {i} (margin {margin:.4f} < "
          f"{tol:.4f}): {want[i]} vs {got[i]}; rest not compared")
    return False


def lm_greedy_top2(lm, prompt, want, max_seq: int):
    """``top2_at`` for a stream of ``generate_greedy``: step i's logits
    recomputed by its own calls (prefill, then ``want``'s first i tokens
    decoded)."""
    import numpy as np

    def top2_at(i):
        caches = lm.init_cache(1, max_seq)
        logits, _ = lm.prefill({"tokens": np.asarray(prompt)[None]}, caches)
        for t in range(i):
            logits, _ = lm.decode_step(caches, np.array([[want[t]]]),
                                       len(prompt) + t)
        return lm_top2(logits[0])
    return top2_at


def lm_decode_greedy(lm, prompt, max_new: int, max_seq: int):
    """A greedy continuation of one prompt by ``decode_step`` alone (the
    prompt fed token by token, as the slot ``Engine`` admits it): (tokens,
    each step's (top-1, top-2) logits)."""
    import numpy as np
    import torch
    caches = lm.init_cache(1, max_seq)
    for t, tok in enumerate(prompt):
        logits, _ = lm.decode_step(caches, np.array([[tok]]), t)
    out, top2 = [], []
    for t in range(max_new):
        top2.append(lm_top2(logits[0]))
        out.append(int(torch.argmax(logits[0])))
        if t + 1 < max_new:
            logits, _ = lm.decode_step(caches, np.array([[out[-1]]]),
                                       len(prompt) + t)
    return out, top2


def lm_engine_run(lm, cfg, prompts, max_new: int, n_slots: int, sync,
                  record: bool = False):
    """The slot ``Engine`` over ``prompts``: (requests, decode calls, wall
    s, each request's (top-1, top-2) logits step by step when
    ``record``: the first token's from its admission, the rest from the
    sampler's rows of the slots active at that step)."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import Engine, Request
    reqs = [Request(prompt=p, max_new=max_new) for p in prompts]
    top2 = {}

    def sampler(logits):
        if record:
            t = torch.topk(logits.float(), 2, -1).values.cpu()
            for i, r in enumerate(eng.slot_req):
                if r is not None and not r.done:
                    top2.setdefault(id(r), []).append(
                        (float(t[i, 0]), float(t[i, 1])))
        return torch.argmax(logits, -1)
    eng = Engine(cfg, lm, max_seq=LM_MAX_SEQ, n_slots=n_slots,
                 sampler=sampler)
    decode, n_calls = eng._decode, [0]

    def counted(toks_):
        n_calls[0] += 1
        return decode(toks_)
    eng._decode = counted
    sync()
    t = time.perf_counter()
    eng.run(list(reqs))
    sync()
    wall = time.perf_counter() - t
    for r in reqs:
        check(len(r.out) == max_new and r.done, f"{cfg.name} request")
    steps = [[tuple(np.sort(np.asarray(r._last_logits, np.float32))[::-1][:2]
                    .tolist())] + top2.get(id(r), []) for r in reqs]
    return reqs, n_calls[0], wall, steps if record else None


def lm_forward_checks(lm, cfg, label, toks, out, extra=None) -> None:
    """Prefill + decode against the full forward (the int8 cache's own
    full forward where ``kv_quant`` is on), and the continuation (the
    speculative verify) against token-by-token decode.  MoE configs run
    the rows one at a time, so that B*S stays under the group size, and a
    comparison is held only where neither side dropped an assignment.
    ``extra``: an encoder-decoder's ``frames`` and ``enc_out`` (the
    prefill, decode and verify take the encoder output, the full forward
    encodes the frames), or an embeddings model's ``embeds`` (the prefill
    takes them, the decode steps take tokens, and the full forward takes
    the embeddings with the decoded tokens' embedding rows appended)."""
    import torch
    P, S = toks.shape[0], LM_PROMPT_LEN
    moe = cfg.family == "moe"
    extra = extra or {}
    enc, emb = extra.get("enc_out"), extra.get("embeds")
    rows = [toks[i:i + 1] for i in range(P)] if moe else [toks]
    got, want, plain = [], [], []
    drops = {"prefill": 0, "decode": 0, "forward": 0}
    for x in rows:
        pre, full_in = {"tokens": x[:, :S]}, {"tokens": x[:, :-1]}
        if enc is not None:
            pre["enc_out"] = enc
            full_in["frames"] = extra["frames"]
        if emb is not None:
            pre = {"embeds": emb}
            tail = lm.params["embed"][torch.as_tensor(x[:, S:-1]).long()
                                      .to(emb.device)]
            # bf16, as forward casts embeddings and decode's token rows.
            full_in = {"embeds": torch.cat([emb.bfloat16(),
                                            tail.bfloat16()], 1)}
        caches = lm.init_cache(x.shape[0], LM_MAX_SEQ)
        with MoEDrops(keep_gates=moe and not got) as d:
            last, caches = lm.prefill(pre, caches)
        drops["prefill"] += d.dropped
        if d.gates:
            out.update(lm_route_check(cfg, d.gates))
        steps = [last]
        with MoEDrops() as d:
            for t in range(S, S + LM_CHECK_STEPS - 1):
                logits, caches = lm.decode_step(caches, x[:, t:t + 1], t,
                                                enc_out=enc)
                steps.append(logits)
        drops["decode"] += d.dropped
        got.append(torch.stack(steps, 1))
        with MoEDrops() as d:
            if cfg.kv_quant:
                full, _, _ = lm.forward(full_in,
                                        caches=lm.init_cache(x.shape[0],
                                                             LM_MAX_SEQ),
                                        cache_index=0)
            else:
                full, _, _ = lm.forward(full_in)
        drops["forward"] += d.dropped
        want.append(full[:, S - 1:])
        if cfg.kv_quant:
            plain.append(lm.forward(full_in)[0][:, S - 1:])
        del full
    got, want = torch.cat(got), torch.cat(want)
    if plain:
        out["err_vs_bf16_forward"] = float(
            (got - torch.cat(plain)).abs().max())
    lm_compare(out, "err_prefill_decode", got, want,
               f"{label} prefill + decode vs forward",
               drops["prefill"] + drops["decode"] + drops["forward"])

    # -- the continuation (verify) against token-by-token decode -------
    window = toks[:1, S:S + LM_CHECK_STEPS]
    pre1 = {"tokens": toks[:1, :S]}
    enc1 = None if enc is None else enc[:1]
    if enc is not None:
        pre1["enc_out"] = enc1
    if emb is not None:
        pre1 = {"embeds": emb[:1]}
    win_in = {"tokens": window}
    if enc is not None:
        win_in["enc_out"] = enc1
    c1 = lm.init_cache(1, LM_MAX_SEQ)
    lm.prefill(pre1, c1)
    with MoEDrops() as d:
        win, _, _ = lm.forward(win_in, caches=c1, cache_index=S)
    drops["verify"] = d.dropped
    c2 = lm.init_cache(1, LM_MAX_SEQ)
    lm.prefill(pre1, c2)
    with MoEDrops() as d:
        steps = [lm.decode_step(c2, window[:, i:i + 1], S + i,
                                enc_out=enc1)[0]
                 for i in range(LM_CHECK_STEPS)]
    drops["verify_decode"] = d.dropped
    lm_compare(out, "err_verify", win[0], torch.cat(steps, 0),
               f"{label} verify vs decode",
               drops["verify"] + drops["verify_decode"])
    if moe:
        out["moe_drops"] = drops


def lm_ssd_long_checks(lm, cfg, label, rng, out) -> None:
    """SSD over LM_SSD_LONG tokens, many chunks: the cacheless forward
    (the chunked form, its inter-chunk recurrence in closed form) against
    a prefill of the first half plus a continuation of the second half at
    its offset, on the continuation's first LM_LONG_TAIL + 1 positions,
    where the state carried across the split weighs most (with the
    seeded ``A_log`` = 0 it decays by ~exp(-0.7) a token)."""
    import numpy as np

    from repro_torch.models import ssm
    n, tail, c = LM_SSD_LONG, LM_LONG_TAIL, cfg.ssm_chunk
    h = n // 2
    check(h % c == 0, f"{label}: {n} tokens split into halves of whole "
          f"chunks of {c}")
    x = rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
    with Calls(ssm, "_ssd_chunked") as chunked:
        full = lm.forward({"tokens": x})[0][:, h:h + tail + 1].clone()
    caches = lm.init_cache(1, LM_MAX_SEQ)
    lm.prefill({"tokens": x[:, :h]}, caches)
    cont = lm.forward({"tokens": x[:, h:]}, caches=caches,
                      cache_index=h)[0][:, :tail + 1]
    n_ssd = sum(k == "ssd" for k in cfg.layer_pattern)
    check(chunked.n == n_ssd, f"{label}: chunked SSD calls {chunked.n}, "
          f"SSD layers {n_ssd}")
    what = f"{label} {n}-token forward vs prefill + continuation"
    out["err_long_vs_continuation"] = lm_close(cont, full, what)
    out["held"].append(what)
    # How much the carried state moves those logits: the second half
    # alone, from a zero state.
    alone = lm.forward({"tokens": x[:, h:]})[0][:, :tail + 1]
    out["ssd_long"] = {"tokens": n, "chunks": n // c, "calls": chunked.n,
                       "state_moves_logits": float(
                           (alone - cont).abs().max())}


def lm_route_check(cfg, gates) -> dict:
    """``moe_route`` on the card against the same function on the CPU, on
    the same f32 gates (every layer's of one prefill): experts, capacity
    positions and the keep mask integer for integer, the renormalized
    gates within 1e-6; with the count of tokens whose top k + 1 gates
    hold a tie."""
    import torch

    from repro_torch.models import layers
    g = torch.cat(gates, 0)
    card, cpu = layers.moe_route(cfg, g), layers.moe_route(cfg, g.cpu())
    check(card.C == cpu.C and all(
        torch.equal(getattr(card, n).cpu(), getattr(cpu, n))
        for n in ("idx", "pos", "keep")),
        f"{cfg.name}: moe_route on the card equals the CPU's")
    err = float((card.probs.cpu() - cpu.probs).abs().max())
    check(err <= 1e-6, f"{cfg.name}: moe_route's gates, card vs CPU {err}")
    top = torch.sort(g, -1, descending=True).values[..., :cfg.top_k + 1]
    return {"route_assignments": int(cpu.idx.numel()), "route_C": cpu.C,
            "route_dropped": int((~cpu.keep).sum()),
            "route_ties": int((top[..., 1:] == top[..., :-1]).any(-1).sum()),
            "route_probs_err": err}


def lm_window_checks(lm, cfg, label, rng, out) -> None:
    """Local attention at a length of LM_LONG tokens: the cacheless
    forward (block-local: the window divides the length) against the same
    tokens through a cache (the windowed scan) on the last positions, and
    a prefill then decode steps past the window against the forward."""
    import numpy as np
    import torch

    from repro_torch.models import layers
    n, tail, w = LM_LONG, LM_LONG_TAIL, cfg.local_window
    check(n % w == 0 and n >= 2 * w, f"{label}: {n} tokens span whole "
          f"windows of {w}")
    x = rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)
    with Calls(layers, "_local_block_attention") as blocks:
        full = lm.forward({"tokens": x})[0][:, n - tail - 1:].clone()
    with Calls(layers, "_online_softmax_scan") as scans:
        scan = lm.forward({"tokens": x}, caches=lm.init_cache(1, n),
                          cache_index=0)[0][:, n - tail - 1:]
    n_local = sum(k == "local_attn" for k in cfg.layer_pattern)
    check(blocks.n == n_local and scans.n == n_local,
          f"{label}: block-local calls {blocks.n}, windowed scans "
          f"{scans.n}, local layers {n_local}")
    out["err_block_local_vs_scan"] = lm_close(
        scan, full, f"{label} block-local forward vs windowed prefill")
    caches = lm.init_cache(1, n)
    last, caches = lm.prefill({"tokens": x[:, :n - tail]}, caches)
    steps = [last] + [lm.decode_step(caches, x[:, t:t + 1], t)[0]
                      for t in range(n - tail, n)]
    out["err_decode_past_window"] = lm_close(
        torch.stack(steps, 1)[0], full[0],
        f"{label} decode past the window vs forward")
    out["held"] += [f"{label} block-local forward vs windowed prefill",
                    f"{label} decode past the window vs forward"]
    out["window_calls"] = {"block_local": blocks.n, "scan": scans.n}


def lm_phase(configs, *, zero_counts, read_counts, sync, device="cuda",
             profile_step=True):
    """Phase 10: LM serving through the port's entry points, for each
    ``(label, cfg)`` of ``configs``: seeded weights on ``device``, the
    checks of ``lm_serve_config``, and what it measured.  Returns
    (match_swar launches of the speculators' runs, info)."""
    spec_launches, info = 0, {}
    for label, cfg in configs:
        n, info[label] = lm_serve_config(
            label, cfg, zero_counts=zero_counts, read_counts=read_counts,
            sync=sync, device=device, profile_step=profile_step)
        spec_launches += n
    return spec_launches, info


def lm_serve_config(label, cfg, *, zero_counts, read_counts, sync, device,
                    profile_step):
    """Phase 10 for one config: (match_swar launches of its speculator,
    what it measured).  Everything it allocates is freed on return.

    Every config: prefill and decode-step time at LM_PROMPTS slots (and a
    profiled step), ``generate_greedy``, the slot ``Engine``, the
    ``SpeculativeDecoder`` on a motif prompt (one ``propose``'s
    ``match_swar`` launch against its plain version and its proposal
    against a numpy brute force; the ``match_swar`` counter above 0), and
    the card's logits against the same port code on the CPU at the
    config's width and reduced depth.  What each stream and each forward
    is held against follows the reference's semantics:

    * dense: prefill + decode against the full forward (the int8 cache's
      own full forward where ``kv_quant`` is on, since the int8 cache is
      lossy against a forward that keeps K/V in bf16), the continuation
      (the verify) against token-by-token decode, every Engine stream and
      the speculative stream against ``generate_greedy`` under the margin
      rule;
    * MoE: per-group capacity makes calls that dropped an assignment
      different functions, so a comparison is held only where none of
      its calls dropped one (drops counted by a wrapper over
      ``moe_route``, printed); the Engine (at most LM_SLOTS tokens a call:
      no drop) against a greedy loop of ``decode_step`` alone (no drop
      either); ``moe_route`` on the card against the CPU on one prefill's
      gates;
    * hybrid (local attention and RG-LRU): the block-local forward
      against the windowed prefill and decode past the window
      (``lm_window_checks``); the Engine driven and timed, its streams
      held on the card against the same Engine on the CPU at reduced
      depth, since the reference's Engine steps every slot's recurrent
      state on its neighbours' admissions; the speculative stream against
      ``generate_greedy`` up to the first verify that rejected a proposal
      (which leaves the rejected tokens in the recurrent state);
    * SSD (mamba2): the dense forward checks (lengths of at most one
      chunk), and an LM_SSD_LONG-token forward (many chunks) against a
      prefill plus a continuation (``lm_ssd_long_checks``); the Engine
      and the speculator as the hybrid's, the card against the CPU (its
      logits and the Engine's twin) at full depth (the model is small);
    * encoder-decoder (whisper): ``encode`` over LM_PROMPTS rows of
      seeded frames, the forward checks with the encoder output (prefill,
      decode and verify) against the full forward over the frames; the
      token path (Engine, ``generate_greedy``, the speculator) held as
      the dense one's: the reference serves tokens only, so each cross
      layer attends its own cache (ROADMAP Queue 3), an attention-only
      path for which the dense argument holds;
    * embeddings input (pixtral): the forward checks from seeded
      embeddings (``lm_forward_checks``' ``extra``), the token path as
      the dense one's."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import model as lmm
    from repro_torch.models.spec import leaves
    from repro_torch.serving.engine import generate_greedy
    from repro_torch.serving.speculative import SpeculativeDecoder

    moe, hybrid = cfg.family == "moe", cfg.family == "hybrid"
    ssd = "ssd" in cfg.layer_pattern
    recurrent = hybrid or ssd      # the Engine and verify leak their state
    new_family = ssd or cfg.is_encdec or cfg.input_mode == "embeddings"
    cuda = torch.device(device).type == "cuda"
    t_cfg = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    out = {"config": cfg.name, "family": cfg.family,
           "kv_quant": cfg.kv_quant, "param_dtype": cfg.param_dtype,
           "kv_heads": cfg.padded_kv_heads, "held": []}
    lm = lmm.init_params(cfg, SEED, device)
    sync()
    out["n_params"] = sum(p.numel() for p in lm.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    out["weight_bytes"] = w_bytes
    out["init_s"] = time.perf_counter() - t_cfg
    rng = np.random.default_rng(SEED)
    P, S = LM_PROMPTS, LM_PROMPT_LEN
    toks = rng.integers(0, cfg.vocab, (P, S + LM_CHECK_STEPS),
                        dtype=np.int32)
    prompts = toks[:, :S]
    extra, dec_kw = {}, {}
    gen = torch.Generator(device=device).manual_seed(SEED)
    if cfg.is_encdec:
        # Seeded stand-ins for the stub audio frontend's frame embeddings.
        extra["frames"] = torch.randn(P, cfg.n_audio_frames, cfg.d_model,
                                      generator=gen, device=device)
        times = []
        for _ in range(3):
            sync()
            t = time.perf_counter()
            enc = lm.encode(extra["frames"])
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        out["encode_ms"], out["encode_ms_runs"] = min(times), times
        check(enc.shape == extra["frames"].shape
              and bool(torch.isfinite(enc).all()), f"{label} encode")
        out["encode_shape"] = list(enc.shape)
        extra["enc_out"] = dec_kw["enc_out"] = enc
    if cfg.input_mode == "embeddings":
        # Seeded stand-ins for the stub vision frontend's embeddings, at
        # the token table's scale, bf16 as forward casts them.
        extra["embeds"] = (torch.randn(P, S, cfg.d_model, generator=gen,
                                       device=device)
                           / cfg.d_model ** 0.5).bfloat16()
    pre = {"tokens": prompts}
    if "enc_out" in extra:
        pre["enc_out"] = extra["enc_out"]
    if "embeds" in extra:
        pre = {"embeds": extra["embeds"]}

    # -- checks against the full forward ---------------------------------
    if hybrid:
        lm_window_checks(lm, cfg, label, rng, out)
    else:
        lm_forward_checks(lm, cfg, label, toks, out, extra)
    if ssd:
        lm_ssd_long_checks(lm, cfg, label, rng, out)

    # -- prefill and decode-step time at LM_SLOTS slots ------------------
    times = []
    for _ in range(3):
        c = lm.init_cache(P, LM_MAX_SEQ)
        sync()
        t = time.perf_counter()
        lm.prefill(pre, c)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    out["prefill_ms"] = min(times)
    out["prefill_ms_runs"] = times
    pos = np.full(P, S, np.int32)
    tok1 = toks[:, S:S + 1]
    lm.decode_step(c, tok1, pos, **dec_kw)
    sync()
    t = time.perf_counter()
    for _ in range(LM_TIMED_STEPS):
        lm.decode_step(c, tok1, pos, **dec_kw)
    sync()
    step_ms = (time.perf_counter() - t) * 1e3 / LM_TIMED_STEPS
    out["decode_step_ms"] = step_ms
    out["decode_tok_s"] = P / step_ms * 1e3
    kv_bytes = sum(x.numel() * x.element_size() for _, x in leaves(c))
    out["kv_bytes"] = kv_bytes
    out["step_bound_ms"] = (w_bytes + kv_bytes) / HBM_BW * 1e3
    if profile_step:
        wall, busy, n_kern, top = lm_step_profile(lm, c, tok1, pos, sync,
                                                  dec_kw)
        out.update(profiled_step_ms=wall, device_busy_ms=busy,
                   device_busy_share=busy / wall,
                   kernels_per_step=n_kern,
                   top_kernels=[[name[:60], round(ms, 4), n]
                                for name, (ms, n) in top])
    del c, extra, pre, dec_kw

    # -- generate_greedy --------------------------------------------------
    sync()
    t = time.perf_counter()
    gg = generate_greedy(cfg, lm, prompts, max_new=LM_MAX_NEW,
                         max_seq=LM_MAX_SEQ)
    out["generate_s"] = time.perf_counter() - t
    check(gg.shape == (P, LM_MAX_NEW) and (gg >= 0).all()
          and (gg < cfg.padded_vocab).all(), f"{label} generate_greedy")

    # -- the slot engine ------------------------------------------------
    if moe or hybrid or new_family:
        lens = rng.integers(LM_MIN_PROMPT, 2 * LM_MIN_PROMPT + 1,
                            LM_MR_REQUESTS)
        max_new = LM_MR_NEW
    else:
        lens = rng.integers(LM_MIN_PROMPT, S + 1, LM_REQUESTS)
        lens[:2] = (LM_MIN_PROMPT, S)
        max_new = LM_MAX_NEW
    eng_prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
                   for n in lens]
    with MoEDrops() as d:
        reqs, n_calls, out["engine_s"], _ = lm_engine_run(
            lm, cfg, eng_prompts, max_new, LM_SLOTS, sync)
    if cfg.is_encdec:
        print(f"  ({label}) the token path (Engine, generate_greedy, "
              "speculator) is the reference's: no encoder output, each "
              "cross layer attends its own cache")
    out["engine_tokens"] = sum(len(r.out) for r in reqs)
    out["engine_decode_calls"] = n_calls
    ties = 0
    if moe:
        with MoEDrops() as d_ref:
            for r in reqs:
                ref, top2 = lm_decode_greedy(lm, r.prompt, max_new,
                                             LM_MAX_SEQ)
                ties += not lm_same_greedy(lm, r.prompt, ref, r.out,
                                           f"{label} engine",
                                           top2_at=top2.__getitem__)
        out["moe_drops"].update(engine=d.dropped, decode_loop=d_ref.dropped)
        check(d.dropped == d_ref.dropped == 0, f"{label}: the Engine and "
              "the decode loop drop nothing")
        out["held"].append(f"{label} engine vs decode loop")
    elif not recurrent:
        for r in reqs:
            ref = generate_greedy(cfg, lm, r.prompt[None], max_new=max_new,
                                  max_seq=LM_MAX_SEQ)[0]
            ties += not lm_same_greedy(lm, r.prompt, ref, r.out,
                                       f"{label} engine")
        out["held"].append(f"{label} engine vs generate_greedy")
    out["engine_ties"] = ties

    # -- speculative decoding through match_swar ----------------------
    motif = rng.integers(0, cfg.vocab, LM_MOTIF, dtype=np.int32)
    prompt = np.tile(motif, S // LM_MOTIF)
    ref = generate_greedy(cfg, lm, prompt[None], max_new=LM_SPEC_NEW,
                          max_seq=LM_MAX_SEQ)[0]
    dec = SpeculativeDecoder(cfg, lm, max_seq=LM_MAX_SEQ, k=LM_SPEC_K)
    propose, propose_s = dec.spec.propose, []

    def timed_propose(*a, **kw):
        t0 = time.perf_counter()
        res = propose(*a, **kw)
        propose_s.append(time.perf_counter() - t0)
        return res
    dec.spec.propose = timed_propose
    verify, verifies = dec._verify, []

    def recorded_verify(caches, window, start):
        with MoEDrops() as d:
            greedy, caches = verify(caches, window, start)
        verifies.append((start, window[0], greedy[0], d.dropped))
        return greedy, caches
    dec._verify = recorded_verify
    sync()
    zero_counts()
    t = time.perf_counter()
    spec_out, stats = dec.generate(prompt, max_new=LM_SPEC_NEW)
    sync()
    out["spec_s"] = time.perf_counter() - t
    counts = read_counts()
    check(counts["match_swar"] > 0, f"{label} speculator launched "
          "match_swar")
    out["spec_launches"] = {k: v for k, v in counts.items() if v}
    n_held, spec_what = len(spec_out), f"{label} speculative"
    if recurrent:
        out["spec_first_rejecting_verify"] = None
        for i, (start, window, greedy, _) in enumerate(verifies):
            n_acc = next((j for j in range(LM_SPEC_K)
                          if window[j + 1] != greedy[j]), LM_SPEC_K)
            if n_acc < LM_SPEC_K:
                # The tokens out after this call are right; the next calls
                # start from a state with the rejected tokens in it.
                n_held = start - len(prompt) + n_acc + 2
                out["spec_first_rejecting_verify"] = i
                break
        spec_what += (f" up to its verify #{i} (the first to reject)"
                      if out["spec_first_rejecting_verify"] is not None
                      else " (no verify rejected)")
    verify_dropped = sum(v[3] for v in verifies)
    if moe:
        out["moe_drops"]["verify"] = verify_dropped
        out["spec_verifies_dropping"] = sum(1 for v in verifies if v[3])
    out["spec_held_tokens"] = 0 if verify_dropped else n_held
    if verify_dropped:
        out["spec_tie"] = None
        print(f"  {spec_what}: not held, {verify_dropped} assignments "
              f"dropped in {out['spec_verifies_dropping']} of its "
              f"{len(verifies)} verify calls")
    else:
        out["spec_tie"] = not lm_same_greedy(
            lm, prompt, ref[:n_held], spec_out[:n_held], spec_what,
            top2_at=lm_greedy_top2(lm, prompt, ref, LM_MAX_SEQ)
            if moe else None)
        out["held"].append(spec_what)
    out.update(spec_calls=stats.model_calls,
               spec_tokens=stats.tokens_out,
               spec_tokens_per_call=stats.tokens_per_call,
               spec_acceptance=stats.acceptance,
               spec_verifies=len(verifies),
               proposes=len(propose_s),
               propose_ms=1e3 * sum(propose_s) / max(len(propose_s), 1))
    dec.spec.propose = propose
    out["propose_launch"] = lm_propose_held(
        dec.spec, list(prompt) + list(spec_out), LM_SPEC_K)
    del dec, lm

    # -- the card against the CPU, the config's width, reduced depth ----
    # Hybrid: one whole unit (rglru, rglru, local_attn), local attention
    # included; SSD: the whole depth (the model is small); the rest, 2
    # layers (whisper's encoder keeps its depth).
    n_small = (len(cfg.block_pattern) if hybrid else cfg.n_layers if ssd
               else 2)
    out["cpu_layers"] = n_small
    cfg2 = dataclasses.replace(cfg, n_layers=n_small)
    if cuda or recurrent:
        card = lmm.init_params(cfg2, SEED, device)
        cpu = copy.deepcopy(card).cpu()
    if cuda:
        x = {"tokens": toks[:1, :16]}
        if cfg.is_encdec:
            x["frames"] = torch.randn(1, cfg.n_audio_frames, cfg.d_model,
                                      generator=gen, device=device)
        if cfg.input_mode == "embeddings":
            x = {"embeds": torch.randn(1, 16, cfg.d_model, generator=gen,
                                       device=device) / cfg.d_model ** 0.5}
        want, _, _ = cpu.forward(x)
        got, _, _ = card.forward(x)
        out["err_card_vs_cpu"] = lm_close(
            got, want, f"{label} card vs CPU at {n_small} layers")
        out["held"].append(f"{label} card vs CPU at {n_small} layers")
    if recurrent:
        twin = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
                for n in rng.integers(LM_CPU_PROMPT[0], LM_CPU_PROMPT[1] + 1,
                                      LM_CPU_REQUESTS)]
        want, _, out["engine_twin_cpu_s"], top2 = lm_engine_run(
            cpu, cfg2, twin, LM_CPU_NEW, LM_CPU_SLOTS, lambda: None,
            record=True)
        got, _, _, _ = lm_engine_run(card, cfg2, twin, LM_CPU_NEW,
                                     LM_CPU_SLOTS, sync)
        what = f"{label} engine, card vs CPU at {n_small} layers"
        out["engine_twin_ties"] = sum(
            not lm_same_greedy(cpu, w.prompt, w.out, g.out, what,
                               top2_at=steps.__getitem__)
            for w, g, steps in zip(want, got, top2))
        out["held"].append(what)
    if cuda or recurrent:
        del card, cpu
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["wall_s"] = time.perf_counter() - t_cfg
    lm_print(label, cfg, out, counts, profile_step, cuda)
    return counts["match_swar"], out


def lm_print(label, cfg, out, counts, profile_step, cuda) -> None:
    """Phase 10's lines for one config."""
    print(f"  ({label}) {cfg.name}: {out['n_params']:,} params "
          f"({out['weight_bytes'] / 1e9:.3f} GB {cfg.param_dtype}), "
          f"kv_quant {cfg.kv_quant}, {cfg.padded_kv_heads} KV heads")
    print(f"  ({label}) prefill {LM_PROMPTS}x{LM_PROMPT_LEN} "
          f"{out['prefill_ms']:.2f} ms; decode step at {LM_PROMPTS} slots "
          f"{out['decode_step_ms']:.3f} ms (bound "
          f"{out['step_bound_ms']:.3f} ms: weights + KV over "
          f"{HBM_BW / 1e12:.2f} TB/s), {out['decode_tok_s']:.1f} tok/s"
          + (f"; device busy {100 * out['device_busy_share']:.1f}% of "
             f"one profiled step ({out['kernels_per_step']} kernels)"
             if profile_step else ""))
    print(f"  ({label}) engine: {out['engine_tokens']} tokens in "
          f"{out['engine_decode_calls']} decode calls, "
          f"{out['engine_s']:.2f} s")
    print(f"  ({label}) speculative: {out['spec_tokens']} tokens in "
          f"{out['spec_calls']} calls ({out['spec_tokens_per_call']:.2f} a "
          f"call), acceptance {out['spec_acceptance']:.3f}, "
          f"{out['proposes']} proposes at {out['propose_ms']:.2f} ms; "
          f"match_swar launches {counts['match_swar']}")
    if "moe_drops" in out:
        print(f"  ({label}) MoE assignments dropped: {out['moe_drops']}; "
              f"moe_route card vs CPU equal on {out['route_assignments']} "
              f"assignments ({out['route_ties']} tokens with tied gates in "
              f"their top {cfg.top_k + 1}, {out['route_dropped']} dropped "
              f"at C = {out['route_C']})")
    if "ssd_long" in out:
        print(f"  ({label}) SSD: {out['ssd_long']['tokens']}-token forward "
              f"in {out['ssd_long']['chunks']} chunks "
              f"({out['ssd_long']['calls']} chunked calls; the carried "
              f"state moves the logits held by up to "
              f"{out['ssd_long']['state_moves_logits']:.4f}); speculative "
              f"stream held for {out['spec_held_tokens']} tokens (first "
              f"rejecting verify: {out['spec_first_rejecting_verify']}); "
              f"the Engine on the CPU at {out['cpu_layers']} layers "
              f"{out['engine_twin_cpu_s']:.1f} s")
    if "encode_ms" in out:
        print(f"  ({label}) encode {out['encode_shape']}: "
              f"{out['encode_ms']:.2f} ms")
    if "window_calls" in out:
        print(f"  ({label}) local attention: {out['window_calls']}; "
              f"speculative stream held for {out['spec_held_tokens']} "
              f"tokens (first rejecting verify: "
              f"{out['spec_first_rejecting_verify']}); the Engine at "
              f"{out['cpu_layers']} layers on the CPU "
              f"{out['engine_twin_cpu_s']:.1f} s")
    for key, e in out.items():
        if key.startswith("err_") and isinstance(e, dict):
            print(f"  ({label}) {key[4:]}: max abs {e['max_abs']:.4f}, "
                  f"relative L2 {e['rel_l2']:.5f}, "
                  f"{100 * e['frac_outside_elementwise']:.4f}% of "
                  f"elements past 3e-2 elementwise, "
                  f"{e['argmax_near_ties']} argmax near-ties"
                  + ("" if e.get("held", True) else " (not held)"))
    print(f"  ({label}) held: {'; '.join(out['held'])}")
    print(f"  ({label}) "
          + (f"peak {out['peak_bytes'] / 2**30:.2f} GiB above the "
             f"phase's start; " if cuda
             else "") + f"{out['wall_s']:.1f} s; card: {Phase.card}")


def lm_propose_held(spec, suffix, k: int):
    """One ``propose`` with its ``match_swar`` launch captured: the launch
    against ``match_swar_plain`` on the same operands, bit for bit, and
    the proposal against a numpy brute-force match of the crumbs.  The
    launch made here is a comparison launch: callers read the path's
    counters before it."""
    import numpy as np
    import torch

    from repro_torch.kernels import match_swar as ksw
    from repro_torch.serving.ngram_cache import (CRUMBS_PER_TOKEN,
                                                 tokens_to_crumbs)
    seen = []
    kernel = ksw.match_swar

    def capture(*args, **kw):
        out = kernel(*args, **kw)
        seen.append((args, kw, out))
        return out
    capture.n_launches = 0      # the kernel's own count lands here
    ksw.match_swar = capture
    try:
        prop, conf = spec.propose(suffix, k=k)
    finally:
        ksw.match_swar = kernel
    check(len(seen) == 1, f"one match_swar launch a propose ({len(seen)})")
    args, kw, out = seen[0]
    plain = ksw.match_swar_plain(*args, **kw)
    check(torch.equal(out, plain), "propose's match_swar equals its plain "
          "version")
    # Brute force over the history's crumbs, zero-padded to the folded
    # rows' alignments (each row holds `step` alignments, no overlap).
    hist = np.asarray(spec.history, np.int64)
    sfx = np.asarray(suffix, np.int64).reshape(-1)[-spec.suffix_tokens:]
    crumbs, pat = tokens_to_crumbs(hist), tokens_to_crumbs(sfx)
    P = len(pat)
    frag = min(spec.fragment_tokens * CRUMBS_PER_TOKEN, len(crumbs))
    step = frag - (P - 1)
    n_rows = max(1, -(-max(len(crumbs) - (P - 1), 1) // step))
    padded = np.zeros(n_rows * step + P - 1, np.uint8)
    padded[:len(crumbs)] = crumbs
    windows = np.lib.stride_tricks.sliding_window_view(padded, P)
    scores = (windows[:n_rows * step] == pat).sum(1)
    p = int(scores.argmax())
    cp = p + P
    tok = cp // CRUMBS_PER_TOKEN + (1 if cp % CRUMBS_PER_TOKEN else 0)
    check(np.array_equal(prop, hist[tok:tok + k])
          and conf == scores[p] / P,
          "proposal equals a numpy brute-force match of the crumbs")
    shape = {"rows": int(args[0].shape[0]), "words": int(args[0].shape[1]),
             "n_locs": int(kw["n_locs"]),
             "pattern_chars": int(kw["pattern_chars"])}
    if out.is_cuda:
        shape["kernel_ms"] = cuda_ms(lambda: kernel(*args, **kw), 200)
        shape["plain_ms"] = cuda_ms(lambda: ksw.match_swar_plain(*args, **kw),
                                    20)
    return shape


def lm_step_profile(lm, caches, toks, pos, sync, dec_kw):
    """One decode step (``dec_kw``: ``decode_step``'s keywords) under
    ``torch.profiler``, as ``profile_call`` reads it."""
    return profile_call(lambda: lm.decode_step(caches, toks, pos, **dec_kw),
                        sync)


def profile_call(run, sync):
    """One call of ``run`` under ``torch.profiler``: wall ms, device-busy
    ms, the kernels launched and the five with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.device_time import device_us
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        sync()
        wall = (time.perf_counter() - t) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = device_us(ev)
        if us > 0:
            by_kernel[ev.key] = (us / 1e3, ev.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:5]
    return wall, busy, sum(n for _, n in by_kernel.values()), top


def train_configs(smoke: bool):
    """Phase 11's configs: (t1)'s arch; (t2)'s (label, config, batch,
    seq) at full width; (t3)'s (label, config) families at 1-2 layers.
    ``smoke``: the same cuts of the smoke configs (a CPU rehearsal)."""
    from repro_torch.configs import get_config

    def cut(arch, optimized=False, **kw):
        cfg = get_config(arch, smoke=smoke, optimized=optimized)
        if "n_layers" in kw:
            kw["n_layers"] = min(kw["n_layers"], cfg.n_layers)
        return dataclasses.replace(cfg, **kw)
    ssd = cut(LM_SSD_ARCH, optimized=True)
    t2 = [("olmoe", cut(LM_MOE_ARCH, n_layers=2), TRAIN_B2, TRAIN_S2),
          ("rgemma", cut(LM_HYBRID_ARCH, optimized=True, n_layers=3),
           TRAIN_B2, TRAIN_S2),
          ("mamba2", ssd, TRAIN_B2, 2 * ssd.ssm_chunk),
          ("whisper", cut(LM_ENCDEC_ARCH), TRAIN_B2, TRAIN_S2),
          ("pixtral", cut(LM_EMBEDS_ARCH, n_layers=2), TRAIN_B2, TRAIN_S2)]
    t3 = [("dense", cut(LM_ARCH, n_layers=1)),
          ("moe", cut(LM_MOE_ARCH, n_layers=1)),
          ("hybrid", cut(LM_HYBRID_ARCH, optimized=True, n_layers=2)),
          ("ssm", cut(LM_SSD_ARCH, optimized=True, n_layers=2)),
          ("encdec", cut(LM_ENCDEC_ARCH, n_layers=1, n_enc_layers=1)),
          ("embeds", cut(LM_EMBEDS_ARCH, n_layers=1, microbatch=2))]
    return t2, t3


def train_batch(cfg, B: int, S: int, step: int, device):
    """A seeded batch on ``device``: ``SyntheticLM``'s tokens and labels;
    whisper's frames and pixtral's embeddings (seeded stand-ins for the
    stub frontends, bf16 as ``forward`` casts them) beside them."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    b = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B,
                    seed=SEED).batch_at(step)
    batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
    gen = torch.Generator(device=device).manual_seed(SEED + step)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(B, cfg.n_audio_frames, cfg.d_model,
                                      generator=gen, device=device
                                      ).bfloat16()
    if cfg.input_mode == "embeddings":
        batch["embeds"] = (torch.randn(B, S, cfg.d_model, generator=gen,
                                       device=device)
                           / cfg.d_model ** 0.5).bfloat16()
        del batch["tokens"]
    return batch


def train_step_bound_ms(n_params: int, tokens: int) -> float:
    """The least time of a train step on the card: 6 N T FLOPs at the
    bf16 peak plus AdamW's TRAIN_OPT_BYTES a parameter over HBM."""
    from repro_torch.core.tech import H100
    return 1e3 * (6 * n_params * tokens / H100.peak_bf16_flops
                  + TRAIN_OPT_BYTES * n_params / H100.hbm_bw)


def train_free(cuda: bool) -> None:
    import gc

    import torch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def train_phase(*, device="cuda", sync, smoke=False, profile=True):
    """Phase 11: LM training through the port's entry points, (t1)-(t4);
    returns what it measured.  ``smoke`` cuts every config to its smoke
    variant and ``profile`` turns the profiled step on, so that the phase
    rehearses on the CPU."""
    import torch
    cuda = torch.device(device).type == "cuda"
    t2, t3 = train_configs(smoke)
    info = {"t1": train_t1(device=device, sync=sync, smoke=smoke,
                           profile=profile)}
    train_free(cuda)
    info["t2"] = {}
    for label, cfg, B, S in t2:
        info["t2"][label] = train_t2(label, cfg, B, S, device=device,
                                     sync=sync)
        train_free(cuda)
    info["t3"] = {}
    for label, cfg in t3:
        info["t3"][label] = train_t3(label, cfg, device=device)
        train_free(cuda)
    info["t4"] = train_t4(device=device, smoke=smoke)
    train_free(cuda)
    return info


def train_t1(*, device, sync, smoke, profile):
    """(t1) llama3.2-1b at full width and depth through the train
    launcher's ``main`` at its defaults, then one profiled step of the
    same config: its device-busy share and kernels, and the optimizer's
    share of an unprofiled step (CUDA events around ``adamw.update``)."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as lmm
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as rsteps
    cuda = torch.device(device).type == "cuda"
    cfg = get_config(LM_ARCH, smoke=smoke)
    if cuda:
        # Earlier phases' buffers stay allocated: peaks are read above
        # what is allocated here.
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    res = launch_train.main(["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS),
                             "--device", str(device)]
                            + (["--smoke"] if smoke else []))
    out = {"config": cfg.name, "steps": len(res.losses),
           "losses": res.losses, "wall_s": time.perf_counter() - t,
           "remat": cfg.remat}
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    B, S = 8, 128                     # the launcher's defaults
    n = cfg.n_params()
    steady = res.step_times[TRAIN_WARM:]
    out.update(n_params=n, tokens=B * S,
               step_ms=1e3 * float(np.median(steady)),
               step_ms_runs=[1e3 * x for x in res.step_times],
               bound_ms=train_step_bound_ms(n, B * S))
    out["tokens_s"] = B * S / (out["step_ms"] / 1e3)
    losses = res.losses
    check(all(math.isfinite(x) for x in losses), "(t1) every loss finite")
    first = abs(losses[0] - math.log(cfg.vocab)) / math.log(cfg.vocab)
    out["first_vs_ln_vocab"] = first
    check(first < 0.15, f"(t1) first loss {losses[0]:.4f} within 15% of "
          f"ln(vocab) {math.log(cfg.vocab):.4f}")
    check(np.mean(losses[-4:]) < np.mean(losses[:4]),
          "(t1) the mean of the last 4 losses below the first 4's")

    # One step of the same config, timed in parts and profiled.
    lm = lmm.init_params(cfg, SEED, device, trainable=True)
    state = adamw.init(lm)
    step = rsteps.make_train_step(cfg, adamw.OptConfig(
        peak_lr=3e-4, warmup_steps=20, decay_steps=100))
    batch = train_batch(cfg, B, S, 0, device)
    for _ in range(TRAIN_WARM):
        step(lm, state, batch)
    update, opt_ms = adamw.update, []

    def timed_update(*args, **kw):
        sync()
        t0 = time.perf_counter()
        r = update(*args, **kw)
        sync()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        return r
    adamw.update = timed_update
    try:
        walls = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            step(lm, state, batch)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        adamw.update = update
    out["timed_step_ms"] = float(np.median(walls))
    out["optimizer_ms"] = float(np.median(opt_ms))
    out["optimizer_share"] = out["optimizer_ms"] / out["timed_step_ms"]
    if profile:
        wall, busy, kernels, top = profile_call(
            lambda: step(lm, state, batch), sync)
        out.update(profiled_step_ms=wall, device_busy_ms=busy,
                   device_busy_share=busy / wall, kernels_per_step=kernels,
                   top_kernels=[(k, ms, c) for k, (ms, c) in top])
    del lm, state
    print(f"  (t1) {cfg.name}: {n:,} params f32, batch {B} x seq {S}, "
          f"remat {cfg.remat}; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {len(losses)} steps (first within "
          f"{100 * first:.1f}% of ln(vocab)); ms a step "
          f"{out['step_ms']:.2f} (median after {TRAIN_WARM} warm-up "
          f"steps), {out['tokens_s']:.0f} tokens/s, bound "
          f"{out['bound_ms']:.2f} ms (6 N T at "
          f"{989:.0f} TFLOP/s + {TRAIN_OPT_BYTES} B a param at 3.35 TB/s)")
    print(f"  (t1) timed step {out['timed_step_ms']:.2f} ms, adamw.update "
          f"{out['optimizer_ms']:.2f} ms ({100 * out['optimizer_share']:.1f}"
          f"% of the step)"
          + (f"; device busy {100 * out['device_busy_share']:.1f}% of a "
             f"profiled step of {out['profiled_step_ms']:.2f} ms "
             f"({out['kernels_per_step']} kernels; top "
             + ", ".join(f"{k[:40]} {ms:.2f} ms x{c}"
                         for k, ms, c in out["top_kernels"]) + ")"
             if profile else "")
          + (f"; peak {out['peak_bytes'] / 2**30:.2f} GiB above the start"
             if cuda else "")
          + f"; {out['wall_s']:.1f} s; card: {Phase.card}")
    return out


def train_t2(label, cfg, B, S, *, device, sync):
    """(t2) one family at full width, TRAIN_T2_STEPS steps of
    ``make_train_step``: every loss and gradient norm finite (the norm
    sums every leaf's squares, so a NaN or inf anywhere shows in it)."""
    import math

    import numpy as np
    import torch

    from repro_torch.models import model as lmm
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as rsteps
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    lm = lmm.init_params(cfg, SEED, device, trainable=True)
    state = adamw.init(lm)
    step = rsteps.make_train_step(cfg, adamw.OptConfig(
        peak_lr=3e-4, warmup_steps=20, decay_steps=100))
    out = {"config": cfg.name, "n_layers": cfg.n_layers,
           "n_params": sum(p.numel() for p in lm.parameters()),
           "batch": B, "seq": S, "microbatch": cfg.microbatch,
           "losses": [], "grad_norms": [], "step_ms_runs": []}
    for i in range(TRAIN_T2_STEPS):
        batch = train_batch(cfg, B, S, i, device)
        sync()
        t0 = time.perf_counter()
        _, _, m = step(lm, state, batch)
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        out["step_ms_runs"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss)
        out["grad_norms"].append(norm)
        check(math.isfinite(loss) and math.isfinite(norm),
              f"(t2) {label} step {i}: loss {loss} and gradient norm "
              f"{norm} finite")
    out["step_ms"] = float(np.median(out["step_ms_runs"][1:]))
    del lm, state
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["wall_s"] = time.perf_counter() - t
    print(f"  (t2) {label} {cfg.name}: {cfg.n_layers} layers, "
          f"{out['n_params']:,} params {cfg.param_dtype}, batch {B} x "
          f"seq {S}, microbatch {cfg.microbatch}; losses "
          + ", ".join(f"{x:.4f}" for x in out["losses"])
          + f"; gradient norms "
          + ", ".join(f"{x:.3f}" for x in out["grad_norms"])
          + f"; {out['step_ms']:.1f} ms a step (median after the first)"
          + (f"; peak {out['peak_bytes'] / 2**30:.2f} GiB above the start"
             if cuda else "")
          + f"; {out['wall_s']:.1f} s; card: {Phase.card}")
    return out


def train_t3(label, cfg, *, device):
    """(t3) one ``train_step`` of the same port code on ``device`` and on
    the CPU from the same weights and batch: the loss within
    TRAIN_LOSS_RTOL relative, every gradient leaf (captured at
    ``adamw.update``) and every updated parameter within TRAIN_LEAF_RTOL
    relative L2."""
    import torch

    from repro_torch import convert
    from repro_torch.models import model as lmm
    from repro_torch.models.spec import leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as rsteps
    t = time.perf_counter()
    card = lmm.init_params(cfg, SEED, device, trainable=True)
    host = convert.to_numpy(card)
    cpu = convert.params_from_numpy(cfg, host, device="cpu")
    cpu.requires_grad_(True)
    runs = {}
    update = adamw.update
    for name, lm, dev in (("card", card, device), ("cpu", cpu, "cpu")):
        seen = []

        def capture(opt, grads, state, params):
            seen.append({p: g.detach().float().cpu()
                         for p, g in leaves(grads)})
            return update(opt, grads, state, params)
        adamw.update = capture
        try:
            step = rsteps.make_train_step(cfg, adamw.OptConfig())
            # The card's batch, copied: both runs see the same inputs.
            batch = train_batch(cfg, TRAIN_B3, TRAIN_S3, 0, device)
            batch = {k: v.to(dev) for k, v in batch.items()}
            _, _, m = step(lm, adamw.init(lm), batch)
        finally:
            adamw.update = update
        runs[name] = (m["loss"].item(), seen[0],
                      {p: v.detach().float().cpu()
                       for p, v in leaves(lm.params)})
        del lm
    del card, cpu
    (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = runs["card"], runs["cpu"]

    def rel(a, b):
        return float(torch.linalg.norm(a - b)
                     / torch.clamp_min(torch.linalg.norm(b), 1e-30))
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    check(loss_err < TRAIN_LOSS_RTOL, f"(t3) {label} loss card {l_card} vs "
          f"CPU {l_cpu}")
    # Without RoPE a key bias's exact gradient is 0 (a softmax ignores a
    # constant added to every score of a query): both devices' are
    # rounding noise, held under 1e-3 of the gradient's global norm, and
    # AdamW's first step moves each of its entries by +-lr, whatever the
    # noise's sign, so its parameters are held within 2 lr.
    noise = {p for p in g_cpu if cfg.rope_theta <= 0 and p.endswith("/bk")}
    norm = float(sum(torch.sum(g.double() ** 2) for g in g_cpu.values())
                 ** 0.5)
    lr = float(adamw.schedule(adamw.OptConfig(), torch.tensor(1.0)))
    for p in noise:
        check(max(float(torch.linalg.norm(g_card[p])),
                  float(torch.linalg.norm(g_cpu[p]))) < 1e-3 * norm
              and float((p_card[p] - p_cpu[p]).abs().max()) <= 2.02 * lr,
              f"(t3) {label} {p}: a gradient of rounding noise only")
    # A leaf that starts at 0 (a bias, ``A_log``) is, after AdamW's first
    # step, -lr times the sign of its gradient in each entry (m / sqrt(v)
    # is +-1 then): its relative L2 counts the entries whose gradient is
    # so small that the devices' rounding flips its sign.  Those leaves
    # are held by the share of flipped entries, under TRAIN_FLIP_SHARE.
    zero = {p for p, h in leaves(host) if not h.any()} - noise
    flips = {p: float((torch.sign(p_card[p]) != torch.sign(p_cpu[p]))
                      .float().mean()) for p in zero}
    g_err = {p: rel(g_card[p], g) for p, g in g_cpu.items()
             if p not in noise}
    p_err = {p: rel(p_card[p], w) for p, w in p_cpu.items()
             if p not in noise | zero}
    worst_f = max(flips.items(), key=lambda kv: kv[1], default=("", 0.0))
    check(worst_f[1] < TRAIN_FLIP_SHARE, f"(t3) {label} first-step signs "
          f"{worst_f}")
    d_err = {p: rel(p_card[p] - torch.from_numpy(host_leaf),
                    p_cpu[p] - torch.from_numpy(host_leaf))
             for p, host_leaf in leaves(host) if p not in noise}
    worst_g = max(g_err.items(), key=lambda kv: kv[1])
    worst_p = max(p_err.items(), key=lambda kv: kv[1])
    worst_d = max(d_err.items(), key=lambda kv: kv[1])
    check(worst_g[1] < TRAIN_LEAF_RTOL, f"(t3) {label} gradient {worst_g}")
    check(worst_p[1] < TRAIN_LEAF_RTOL, f"(t3) {label} params {worst_p}")
    out = {"config": cfg.name, "n_layers": cfg.n_layers,
           "noise_leaves": sorted(noise),
           "loss_rel_err": loss_err, "worst_grad": worst_g,
           "worst_param": worst_p, "worst_update_not_held": worst_d,
           "worst_zero_init_flips": worst_f,
           "wall_s": time.perf_counter() - t}
    print(f"  (t3) {label} {cfg.name} at {cfg.n_layers} layers, batch "
          f"{TRAIN_B3} x seq {TRAIN_S3}: loss card {l_card:.6f} vs CPU "
          f"{l_cpu:.6f} (relative {loss_err:.2e}); worst gradient leaf "
          f"{worst_g[0]} {worst_g[1]:.5f}, worst parameter {worst_p[0]} "
          f"{worst_p[1]:.2e} (relative L2); zero-initialised leaves' "
          f"first-step signs flipped at most in {worst_f[0]} "
          f"{100 * worst_f[1]:.3f}%; the update itself (not held) "
          f"{worst_d[0]} {worst_d[1]:.4f}; {out['wall_s']:.1f} s; card: "
          f"{Phase.card}")
    return out


def train_t4(*, device, smoke):
    """(t4) llama3.2-1b at full width and TRAIN_T4_LAYERS layers: an
    uninterrupted run of TRAIN_T4_STEPS steps checkpointing every
    TRAIN_T4_EVERY, then a restart from step TRAIN_T4_EVERY (the later
    checkpoints removed): the resumed steps' losses equal the
    uninterrupted run's within TRAIN_LOSS_RTOL relative.  The directory
    is under ``build/`` and removed afterwards."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.runtime import loop
    cfg = dataclasses.replace(get_config(LM_ARCH, smoke=smoke),
                              n_layers=TRAIN_T4_LAYERS)
    opt = adamw.OptConfig(peak_lr=3e-4, warmup_steps=20, decay_steps=100)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=128, global_batch=8,
                       seed=SEED)
    d = ROOT / "build" / "train_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    t = time.perf_counter()
    try:
        mgr = CheckpointManager(d)
        kw = dict(log_every=0, log=lambda *_: None, device=device)
        whole = loop.train(cfg, opt, data, TRAIN_T4_STEPS, ckpt=mgr,
                           ckpt_every=TRAIN_T4_EVERY, **kw)
        saved = dict(mgr.last_save)
        steps_saved = mgr.all_steps()
        for s in steps_saved:
            if s > TRAIN_T4_EVERY:
                shutil.rmtree(d / f"step_{s:09d}")
        check(mgr.latest_step() == TRAIN_T4_EVERY,
              f"(t4) checkpoint at step {TRAIN_T4_EVERY} kept")
        resumed = loop.train(cfg, opt, data, TRAIN_T4_STEPS,
                             ckpt=CheckpointManager(d), **kw)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    want = whole.losses[TRAIN_T4_EVERY:]
    check(len(resumed.losses) == len(want), "(t4) resumed steps")
    errs = [abs(a - b) / abs(b) for a, b in zip(resumed.losses, want)]
    check(max(errs) < TRAIN_LOSS_RTOL, f"(t4) resumed losses "
          f"{resumed.losses} vs {want}")
    out = {"config": cfg.name, "n_layers": cfg.n_layers,
           "losses_whole": whole.losses, "losses_resumed": resumed.losses,
           "max_rel_err": max(errs),
           "bit_equal": resumed.losses == want,
           "checkpoints": steps_saved, "save": saved,
           "wall_s": time.perf_counter() - t}
    print(f"  (t4) {cfg.name} at {cfg.n_layers} layers: checkpoints at "
          f"{steps_saved}; resumed from step {TRAIN_T4_EVERY}: losses "
          + ", ".join(f"{x:.6f}" for x in resumed.losses) + " vs "
          + ", ".join(f"{x:.6f}" for x in want)
          + f" (max relative {max(errs):.2e}, bit-equal "
          f"{out['bit_equal']}); last save: snapshot "
          f"{1e3 * saved['snapshot_s']:.1f} ms, write "
          f"{saved['write_s']:.2f} s, {saved['bytes'] / 1e9:.3f} GB; "
          f"{out['wall_s']:.1f} s; card: {Phase.card}")
    return out

def sharded_opt():
    """(t1)'s optimizer: the train launcher's defaults."""
    from repro_torch.optim import adamw
    return adamw.OptConfig(peak_lr=3e-4, warmup_steps=20, decay_steps=100)


def sharded_layout(device) -> str:
    """Where phase 14's ranks put their shards."""
    import torch
    ranks = MESH_DATA * MESH_MODEL
    if torch.device(device).type != "cuda":
        return f"{ranks} threaded ranks on the CPU"
    if torch.cuda.device_count() >= ranks:
        return f"{ranks} threaded ranks, rank r on cuda:r"
    return f"{ranks} threaded ranks, every rank's shards on cuda:0"


COLLECTIVES = ("all_gather_into_tensor", "all_reduce",
               "reduce_scatter_tensor", "all_to_all_single",
               "shard_dim_alltoall", "broadcast")


class CommBytes:
    """``CommDebugMode`` plus the bytes of each collective's input."""

    def __new__(cls):
        from torch.distributed.tensor.debug import CommDebugMode

        class Mode(CommDebugMode):
            def __init__(self):
                super().__init__()
                self.nbytes = {}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                import torch
                name = func.__name__.split(".")[0]
                if name in COLLECTIVES:
                    n = sum(t.numel() * t.element_size()
                            for t in args if isinstance(t, torch.Tensor))
                    self.nbytes[name] = self.nbytes.get(name, 0) + n
                return super().__torch_dispatch__(func, types, args,
                                                  kwargs)
        return Mode()


def sharded_leaf_counts(lm) -> dict:
    """How many parameter leaves shard over data only, model only, both,
    or neither."""
    from repro_torch.models.spec import leaves
    out = {"data": 0, "model": 0, "both": 0, "neither": 0}
    for _, t in leaves(lm.params):
        d, m = (not p.is_replicate() for p in t.placements)
        out["both" if d and m else "data" if d else "model" if m
            else "neither"] += 1
    return out


def sharded_steps(init, cfg, n_steps, want, *, device, sync):
    """``n_steps`` train steps of ``cfg`` on the mesh, from the one-device
    weights ``init`` (a ``CausalLM``), each rank a thread: per rank,
    (loss, grad norm, ms) a step, the collectives of the first step, the
    leaf counts; rank 0 also returns each leaf's relative L2 error after
    the last step (gathered whole) against ``want``'s (one device's)."""
    import torch

    from repro_torch import convert
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import activation_sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models.spec import leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as rsteps
    kind = torch.device(device).type
    rules = sharding.RULE_PROFILES[cfg.sharding_profile]

    def rank(r):
        mesh = lmesh.make_debug_mesh(MESH_DATA, MESH_MODEL,
                                     device_type=kind)
        lm = convert.shard_params(init, mesh, rules)
        st = adamw.init(lm)
        step = rsteps.make_train_step(cfg, sharded_opt())
        hist, comm, arg_bytes = [], None, None
        with activation_sharding(mesh, rules):
            for i in range(n_steps):
                batch = train_batch(cfg, SHARDED_B, SHARDED_S, i, "cpu")
                mode = CommBytes() if i == 0 and r == 0 else None
                if mode is not None:
                    arg_bytes = dryrun.argument_bytes(
                        (lm, st, rsteps._place_batch(batch, mesh, None)))
                sync()
                t = time.perf_counter()
                if mode is not None:
                    with mode:
                        lm, st, m = step(lm, st, batch)
                    comm = {"counts": {str(k).split(".")[-1]: v for k, v in
                                       mode.get_comm_counts().items()},
                            "bytes": mode.nbytes}
                else:
                    lm, st, m = step(lm, st, batch)
                sync()
                hist.append((m["loss"].item(), m["grad_norm"].item(),
                             1e3 * (time.perf_counter() - t)))
        out = {"hist": hist, "comm": comm, "arg_bytes": arg_bytes,
               "leaves": sharded_leaf_counts(lm),
               "devices": sorted({str(t.to_local().device)
                                  for _, t in leaves(lm.params)})}
        errs = {}
        with torch.no_grad():
            for path, t in leaves(lm.params):
                whole = t.full_tensor()
                if r == 0:
                    w = want[path]
                    errs[path] = float(torch.linalg.norm(whole.to(w.device)
                                                         - w)
                                       / torch.linalg.norm(w))
                del whole
        out["leaf_errs"] = errs
        del lm, st
        return out
    return lmesh.run_threaded(MESH_DATA * MESH_MODEL, rank)


def sharded_hold(label, ranks, want_hist) -> dict:
    """Every rank's losses and norms against the one-device run's, rank
    0's leaf errors; the worst of each."""
    worst = {"loss": 0.0, "norm": 0.0}
    for res in ranks:
        for (gl, gn, _), (wl, wn) in zip(res["hist"], want_hist):
            worst["loss"] = max(worst["loss"], abs(gl - wl) / abs(wl))
            worst["norm"] = max(worst["norm"], abs(gn - wn) / abs(wn))
    check(worst["loss"] < TRAIN_LOSS_RTOL, f"(z1) {label} losses "
          f"{[r['hist'] for r in ranks]} vs {want_hist}")
    check(worst["norm"] < SHARDED_NORM_RTOL, f"(z1) {label} gradient "
          f"norms {[r['hist'] for r in ranks]} vs {want_hist}")
    leaf = max(ranks[0]["leaf_errs"].items(), key=lambda kv: kv[1])
    check(leaf[1] < TRAIN_LEAF_RTOL, f"(z1) {label} worst leaf {leaf}")
    worst["leaf"] = leaf
    return worst


def lm_sharding_phase(*, device="cuda", smoke=False,
                      profiles=("2d", "fsdp")) -> dict:
    """Phase 14: (z1) llama3.2-1b's train steps on the (data, model) mesh
    under the rule ``profiles`` against the one-device steps, (z2) a
    mesh-less checkpoint restored onto the mesh.  ``smoke`` runs the
    smoke config (a CPU rehearsal with ``device="cpu"``)."""
    import torch
    t_phase = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    layout = sharded_layout(device)
    info = {"layout": layout, "z1": sharded_z1(
        device=device, sync=sync, smoke=smoke, layout=layout,
        profiles=profiles)}
    train_free(cuda)
    info["z2"] = sharded_z2(device=device, smoke=smoke)
    train_free(cuda)
    info["wall_s"] = time.perf_counter() - t_phase
    check(smoke or info["wall_s"] < SHARDED_LIMIT_S,
          f"phase 14 (z1)-(z2) within {SHARDED_LIMIT_S} s: "
          f"{info['wall_s']:.1f} s")
    t_serve = time.perf_counter()
    info["z3"] = sharded_z3(device=device, sync=sync, smoke=smoke)
    train_free(cuda)
    cells = [dryrun_cell("z3 decode", info["z3"]["llama"]["cfg"], "decode",
                         SERVE_MAX, SERVE_B, info["z3"]["llama"]["comm"],
                         info["z3"]["llama"]["arg_bytes"])]
    if "2d" in info["z1"]:
        cells.insert(0, dryrun_cell(
            "z1 2d train", {"arch": LM_ARCH, "smoke": smoke}, "train",
            SHARDED_S, SHARDED_B, info["z1"]["2d"]["comm"],
            info["z1"]["2d"]["arg_bytes"]))
    info["z4"] = sharded_z4(cells, device=device)
    info["serve_wall_s"] = time.perf_counter() - t_serve
    check(smoke or info["serve_wall_s"] < SERVE_LIMIT_S,
          f"phase 14 (z3)-(z4) within {SERVE_LIMIT_S} s: "
          f"{info['serve_wall_s']:.1f} s")
    info["wall_s"] = time.perf_counter() - t_phase
    return info


def serve_config(arch: str, smoke: bool):
    """The registry's serving deployment of ``arch`` (at smoke size, where
    the registry's overrides do not apply, the same fields set)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=smoke, optimized=True, kind="serve")
    if smoke and arch == LM_ARCH:
        cfg = dataclasses.replace(cfg, kv_quant=True, param_dtype="bf16")
    return cfg


def serve_inputs(cfg, n_decodes: int):
    """Seeded prompts (SERVE_B x SERVE_S) and decode calls: (tokens (B,
    1), cache index) for ``n_decodes`` scalar positions after the
    prompt, then one call at per-row positions when ``n_decodes`` > 1."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab, (SERVE_B, SERVE_S)).astype(np.int32)
    idx = [SERVE_S + i for i in range(n_decodes)]
    if n_decodes > 1:
        idx.append(np.array([SERVE_S + n_decodes + 2 * (b % 2) + b // 2
                             for b in range(SERVE_B)]))
    return prompt, [(rng.integers(0, cfg.vocab, (SERVE_B, 1)).astype(
        np.int32), ci) for ci in idx]


def sharded_serve(cfg, n_decodes: int, *, device, sync, comm_call=None):
    """``cfg`` served on one device, then on the MESH_DATA x MESH_MODEL
    mesh of threaded ranks (the same weights, ``init_cache(mesh=)``, the
    steps): (one device's logits a call (on the host), its ms a call, each
    rank's results: rank 0's logits, ms a call, collectives of call
    ``comm_call`` (``CommBytes``) and the local bytes of that call's
    arguments; one device's logits with every projection formed in f32
    and rounded once)."""
    import torch

    from repro_torch import convert
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import activation_sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import layers
    from repro_torch.models import model as lmm
    from repro_torch.runtime import steps as rsteps
    kind = torch.device(device).type
    rules = sharding.RULE_PROFILES[cfg.sharding_profile]
    prompt, decodes = serve_inputs(cfg, n_decodes)
    lm = lmm.init_params(cfg, SEED, device)

    def calls(lm_, caches, comm=None):
        """The prefill and the decodes through the steps; ([logits on the
        host], [ms]), ``comm`` filled at call ``comm_call``."""
        prefill = rsteps.make_prefill_step(cfg)
        decode = rsteps.make_decode_step(cfg)
        logits, ms = [], []
        batches = [dict(tokens=prompt)] + [dict(tokens=t, cache_index=ci)
                                            for t, ci in decodes]
        for i, b in enumerate(batches):
            b["caches"] = caches
            step = prefill if i == 0 else decode
            sync()
            t = time.perf_counter()
            if comm is not None and i == comm_call:
                comm["arg_bytes"] = dryrun.argument_bytes(
                    (lm_, rsteps._place_serving(cfg, lm_, b)))
                mode = CommBytes()
                with mode:
                    lg, caches = step(lm_, b)
                comm["counts"] = {str(k).split(".")[-1]: v for k, v in
                                  mode.get_comm_counts().items()}
                comm["bytes"] = mode.nbytes
            else:
                lg, caches = step(lm_, b)
            sync()
            ms.append(1e3 * (time.perf_counter() - t))
            whole = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
            logits.append(whole.float().cpu())
        return logits, ms

    one, one_ms = calls(lm, lmm.init_cache(cfg, SERVE_B, SERVE_MAX,
                                           device=device))
    # One device again, its projections formed in f32 and rounded once
    # (the arithmetic of the mesh's row-parallel projections): how far
    # another summation order alone moves the logits.
    inner = layers.project

    def project_f32(a, w, eq=None):
        x, y = a.float(), layers.weight(w, a).float()
        return (x @ y if eq is None else torch.einsum(eq, x, y)).to(a.dtype)
    layers.project = project_f32
    try:
        floor = calls(lm, lmm.init_cache(cfg, SERVE_B, SERVE_MAX,
                                         device=device))[0]
    finally:
        layers.project = inner

    def rank(r):
        mesh = lmesh.make_debug_mesh(MESH_DATA, MESH_MODEL,
                                     device_type=kind)
        sharded = convert.shard_params(lm, mesh, rules)
        caches = lmm.init_cache(cfg, SERVE_B, SERVE_MAX, mesh=mesh)
        comm = {} if r == 0 and comm_call is not None else None
        with activation_sharding(mesh, rules):
            logits, ms = calls(sharded, caches, comm)
        return {"logits": logits if r == 0 else None, "ms": ms,
                "comm": comm}
    ranks = lmesh.run_threaded(MESH_DATA * MESH_MODEL, rank)
    del lm
    return one, one_ms, ranks, floor


def row_errors(got, want):
    """Relative L2 error of each logit row of each call."""
    import torch
    return [[float(torch.linalg.norm(g[b] - w[b]) / torch.linalg.norm(w[b]))
             for b in range(w.shape[0])] for g, w in zip(got, want)]


def serve_hold(label, one, got, floor) -> dict:
    """Argmax equal to one device's wherever one device's top-1/top-2
    margin is past LM_ATOL + LM_RTOL |top-1|, and every logit row of every
    call within max(SERVE_RTOL, SERVE_FLOOR_X x the floor) relative L2 of
    one device's.  The floor is ``floor``'s worst row: one device against
    itself with its projections rounded once from f32, as the mesh's
    row-parallel ones are (another summation order and nothing else).
    The worst row, the near-ties and the floor."""
    import torch
    worst, ties, n_rows = 0.0, 0, 0
    errs = row_errors(got, one)
    for c, (w, g) in enumerate(zip(one, got)):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"(z3) {label} call {c}: finite logits of shape {w.shape}")
        for b in range(w.shape[0]):
            err = errs[c][b]
            worst = max(worst, err)
            top1, top2 = lm_top2(w[b])
            n_rows += 1
            if top1 - top2 < LM_ATOL + LM_RTOL * abs(top1):
                ties += 1
                continue
            check(int(torch.argmax(g[b])) == int(torch.argmax(w[b])),
                  f"(z3) {label} call {c} row {b}: greedy token "
                  f"{int(torch.argmax(g[b]))} vs one device's "
                  f"{int(torch.argmax(w[b]))} past the margin rule")
    floor_errs = row_errors(floor, one)
    floor_worst = max(max(e) for e in floor_errs)
    gate = max(SERVE_RTOL, SERVE_FLOOR_X * floor_worst)
    check(worst <= gate, f"(z3) {label}: worst logit row {worst:.2e} "
          f"relative L2 past {gate:.2e} (the floor, one device's "
          f"projections rounded once from f32: {floor_worst:.2e}); rows by "
          f"call {[[round(e, 6) for e in c] for c in errs]}, floor "
          f"{[[round(e, 6) for e in c] for c in floor_errs]}")
    return {"worst_rel": worst, "near_ties": ties, "rows": n_rows,
            "floor_rel": floor_worst, "gate": gate,
            "rows_rel": errs, "floor_rows_rel": floor_errs}


def sharded_z3(*, device, sync, smoke) -> dict:
    """(z3) llama3.2-1b's serving config and mamba2-130m served on the
    mesh against one device."""
    import statistics

    from repro_torch.configs import get_config
    out = {}
    for label, arch, n_dec in (("llama", LM_ARCH, SERVE_DECODES),
                               ("mamba2", "mamba2-130m", 1)):
        # llama as its serving deployment, mamba2 as the registry holds it.
        cfg = (serve_config(arch, smoke) if label == "llama"
               else get_config(arch, smoke=smoke))
        t = time.perf_counter()
        # Call 2, the second scalar decode (the first after the one whose
        # sharding DTensor propagates first), is the step (z4) lowers.
        one, one_ms, ranks, floor = sharded_serve(
            cfg, n_dec, device=device, sync=sync,
            comm_call=2 if label == "llama" else None)
        res = serve_hold(f"{cfg.name}", one, ranks[0]["logits"], floor)
        ms = ranks[0]["ms"]
        res.update({
            "calls": len(ms), "ms_prefill": ms[0],
            "ms_decode": statistics.median(ms[2:]) if len(ms) > 2 else ms[1],
            "ms_first_decode": ms[1], "one_ms_prefill": one_ms[0],
            "one_ms_decode": (statistics.median(one_ms[2:])
                              if len(one_ms) > 2 else one_ms[1]),
            "wall_s": time.perf_counter() - t})
        if label == "llama":
            comm = ranks[0]["comm"]
            res.update({"comm": {"counts": comm["counts"],
                                 "bytes": comm["bytes"]},
                        "arg_bytes": comm["arg_bytes"],
                        "cfg": {"arch": arch, "smoke": smoke,
                                "optimized": True, "kind": "serve",
                                "fields": ({"kv_quant": True,
                                            "param_dtype": "bf16"}
                                           if smoke else {})}})
        out[label] = res
        comm = res.get("comm", {"counts": {}, "bytes": {}})
        print(f"  (z3) {cfg.name} (kv_quant {cfg.kv_quant}, params "
              f"{cfg.param_dtype}) served on the {MESH_DATA}x{MESH_MODEL} "
              f"mesh, {SERVE_B} prompts of {SERVE_S} into {SERVE_MAX} "
              f"positions, {len(ms) - 1} decode calls: worst logit row "
              f"{res['worst_rel']:.2e} relative L2 against one device "
              f"(gate {res['gate']:.2e}: the larger of {SERVE_RTOL} and "
              f"{SERVE_FLOOR_X:g} x the floor, one device against itself "
              f"with its projections rounded once from f32, "
              f"{res['floor_rel']:.2e}); rows by "
              f"call {[[round(e, 5) for e in c] for c in res['rows_rel']]}"
              f"; greedy tokens equal in "
              f"{res['rows'] - res['near_ties']} of {res['rows']} rows "
              f"(the rest near-ties); prefill {res['ms_prefill']:.1f} ms "
              f"(first call) against one device {res['one_ms_prefill']:.1f};"
              f" a decode step {res['ms_decode']:.1f} ms (first "
              f"{res['ms_first_decode']:.1f}) against one device "
              f"{res['one_ms_decode']:.1f}" + (
                  "; a decode step's collectives: " + ", ".join(
                      f"{k} {v} ({comm['bytes'].get(k, 0) / 1e6:.3f} MB)"
                      for k, v in sorted(comm["counts"].items()))
                  if comm["counts"] else "")
              + f"; {res['wall_s']:.1f} s; card: {Phase.card}")
    return out


def dryrun_cell(label, cfg_spec, kind, seq, batch, comm, arg_bytes) -> dict:
    """One cell for (z4): the config (arch, smoke, registry deployment,
    fields), the step's shape, and what the card counted."""
    return {"label": label, "cfg": dict(cfg_spec), "kind": kind,
            "seq": seq, "batch": batch, "comm": comm["counts"],
            "arg_bytes": arg_bytes}


def dryrun_worker(path_in: str, path_out: str) -> int:
    """``chip_smoke.py --dryrun-worker IN OUT``: the dry run's record of
    each cell of IN on a MESH_DATA x MESH_MODEL mesh under a ``fake``
    group (meta shards: nothing runs on the card), written to OUT."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models.config import InputShape
    job = json.loads(Path(path_in).read_text())
    dryrun.fake_group(MESH_DATA * MESH_MODEL)
    try:
        mesh = lmesh.make_debug_mesh(MESH_DATA, MESH_MODEL,
                                     device_type=job["device_type"])
        recs = []
        for cell in job["cells"]:
            c = cell["cfg"]
            cfg = get_config(c["arch"], smoke=c["smoke"],
                             optimized=c.get("optimized", False),
                             kind=c.get("kind", "train"))
            cfg = dataclasses.replace(cfg, **c.get("fields", {}))
            shape = InputShape(cell["label"], cell["kind"], cell["seq"],
                               cell["batch"])
            recs.append(dryrun.lower_cell(c["arch"], shape, cfg=cfg,
                                          mesh=mesh))
        Path(path_out).write_text(json.dumps(recs))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def sharded_z4(cells, *, device) -> dict:
    """(z4) the dry run of ``cells`` in a subprocess (its fake group must
    not meet the threaded one): each record ``ok``, its collectives by
    kind equal to what ``CommDebugMode`` counted on the card for the same
    step, its ``argument_bytes`` rank 0's shards."""
    import tempfile

    import torch

    from repro_torch.distributed import op_analysis
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        path_in, path_out = Path(tmp) / "in.json", Path(tmp) / "out.json"
        path_in.write_text(json.dumps({
            "cells": cells, "device_type": torch.device(device).type}))
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT / "src") + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--dryrun-worker", str(path_in),
                              str(path_out)], env=env, capture_output=True,
                             text=True, timeout=SERVE_LIMIT_S)
        check(run.returncode == 0, f"(z4) the dry run: {run.stderr[-3000:]}")
        recs = json.loads(path_out.read_text())
    out = {}
    for cell, rec in zip(cells, recs):
        label = cell["label"]
        check(rec.get("status") == "ok", f"(z4) {label}: {rec}")
        card = {k: 0 for k in op_analysis.COLLECTIVES}
        for name, n in cell["comm"].items():
            card[op_analysis.COLLECTIVE_KIND[name]] += n
        dry = {k: int(v) for k, v in rec["collective_counts"].items()}
        check(dry == card, f"(z4) {label}: the dry run's collectives {dry} "
              f"vs the card's {card}")
        check(rec["memory"]["argument_bytes"] == cell["arg_bytes"],
              f"(z4) {label}: argument bytes {rec['memory']} vs rank 0's "
              f"{cell['arg_bytes']}")
        out[label] = {k: rec[k] for k in (
            "hlo_flops_per_dev", "hlo_bytes_per_dev",
            "hlo_bytes_strict_per_dev", "collective_bytes_per_dev",
            "dominant", "lower_s", "memory", "collective_counts",
            "compute_s", "memory_s", "collective_s")}
        print(f"  (z4) {label}: the dry run (meta shards, a fake group of "
              f"{MESH_DATA * MESH_MODEL}) counts "
              + ", ".join(f"{k} {v}" for k, v in dry.items() if v)
              + f", as CommDebugMode did on the card; argument bytes "
              f"{cell['arg_bytes']:,} as rank 0 holds; flops a device "
              f"{rec['hlo_flops_per_dev']:.4g}, bytes "
              f"{rec['hlo_bytes_per_dev']:.4g} (strict "
              f"{rec['hlo_bytes_strict_per_dev']:.4g}), collective bytes "
              f"{rec['collective_bytes_per_dev']:.4g}, temp "
              f"{rec['memory']['temp_bytes']:,}, {rec['dominant']}-bound at "
              f"the card's rates; traced in {rec['lower_s']} s")
    out["wall_s"] = time.perf_counter() - t
    return out


def sharded_z1(*, device, sync, smoke, layout, profiles) -> dict:
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as lmm
    from repro_torch.models.spec import leaves, map_tree
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as rsteps
    cuda = torch.device(device).type == "cuda"
    cfg = get_config(LM_ARCH, smoke=smoke)
    fsdp = get_config(LM_ARCH, smoke=smoke, optimized=True)
    if smoke:       # the registry's overrides apply at full width only
        fsdp = dataclasses.replace(fsdp, sharding_profile="fsdp")
    check(cfg.sharding_profile == "2d" and fsdp.sharding_profile == "fsdp",
          "(z1) the default config shards 2d, the optimized one fsdp")
    # One device: the same weights and batches; copies (on the device)
    # of the weights before the first step and after the first and the
    # last.
    lm = lmm.init_params(cfg, SEED, device, trainable=True)
    with torch.no_grad():
        init = lmm.CausalLM(cfg, map_tree(torch.clone, lm.params),
                            trainable=True)
    step = rsteps.make_train_step(cfg, sharded_opt())
    st = adamw.init(lm)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    one, after = [], {}
    for i in range(SHARDED_STEPS):
        batch = train_batch(cfg, SHARDED_B, SHARDED_S, i, device)
        sync()
        t = time.perf_counter()
        lm, st, m = step(lm, st, batch)
        sync()
        one.append((m["loss"].item(), m["grad_norm"].item(),
                    1e3 * (time.perf_counter() - t)))
        if i + 1 in (SHARDED_FSDP_STEPS, SHARDED_STEPS):
            after[i + 1] = {p: t.detach().clone()
                            for p, t in leaves(lm.params)}
    one_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del lm, st, m
    train_free(cuda)
    out = {"n_params": cfg.n_params(), "one_device": {
        "hist": one, "ms_step": statistics.median(h[2] for h in one[1:]),
        "peak_gb": one_peak / 1e9}}
    for label, c, n in (("2d", cfg, SHARDED_STEPS),
                        ("fsdp", fsdp, SHARDED_FSDP_STEPS)):
        if label not in profiles:
            continue
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        t = time.perf_counter()
        ranks = sharded_steps(init, c, n, after[n], device=device,
                              sync=sync)
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        worst = sharded_hold(label, ranks, [h[:2] for h in one[:n]])
        ms = [h[2] for h in ranks[0]["hist"]]
        res = {"steps": n, "hist": [r["hist"] for r in ranks],
               "ms_first": ms[0],
               "ms_step": statistics.median(ms[1:]) if n > 1 else None,
               "ms_step_ranks_max": (max(statistics.median(
                   h[2] for h in r["hist"][1:]) for r in ranks)
                   if n > 1 else None),
               "comm": ranks[0]["comm"], "arg_bytes": ranks[0]["arg_bytes"],
               "leaves": ranks[0]["leaves"],
               "devices": sorted({d for r in ranks for d in r["devices"]}),
               "peak_gb": (peak - base) / 1e9, "kept_gb": base / 1e9,
               "wall_s": wall,
               "worst_loss": worst["loss"], "worst_norm": worst["norm"],
               "worst_leaf": worst["leaf"]}
        del ranks
        train_free(cuda)
        out[label] = res
        comm = res["comm"] or {"counts": {}, "bytes": {}}
        steady = (f"{res['ms_step']:.1f} ms a step (median after 1 "
                  f"warm-up; slowest rank {res['ms_step_ranks_max']:.1f})"
                  if n > 1 else f"{res['ms_first']:.1f} ms (its first "
                  "step, with DTensor's sharding propagation)")
        print(f"  (z1) {c.name} {label} on the {MESH_DATA}x{MESH_MODEL} "
              f"(data, model) mesh, {layout}, batch {SHARDED_B} x seq "
              f"{SHARDED_S}: losses "
              + ", ".join(f"{h[0]:.6f}" for h in res["hist"][0])
              + " vs one device "
              + ", ".join(f"{h[0]:.6f}" for h in one[:n])
              + f" (worst relative {res['worst_loss']:.2e}; grad norm "
              f"{res['worst_norm']:.2e}); worst leaf {res['worst_leaf'][0]}"
              f" {res['worst_leaf'][1]:.2e} (relative L2); leaves sharded "
              f"over data only {res['leaves']['data']}, model only "
              f"{res['leaves']['model']}, both {res['leaves']['both']}, "
              f"neither {res['leaves']['neither']}; {steady}, first step "
              f"{res['ms_first']:.1f} ms, one device "
              f"{out['one_device']['ms_step']:.1f} ms; collectives a "
              "step: " + ", ".join(
                  f"{k} {v} ({comm['bytes'].get(k, 0) / 1e6:.1f} MB)"
                  for k, v in sorted(comm["counts"].items()))
              + f"; peak {res['peak_gb']:.2f} GB on the card (every "
              f"rank's, above the {res['kept_gb']:.2f} GB of one-device "
              f"copies kept for the comparison), one device "
              f"{out['one_device']['peak_gb']:.2f} GB;"
              f" {wall:.1f} s; card: {Phase.card}")
    return out


def sharded_z2(*, device, smoke) -> dict:
    """(z2) a mesh-less checkpoint of llama3.2-1b at full width and
    SHARDED_CKPT_LAYERS layers restored onto the mesh with
    ``shardings=``: every rank's local block of every leaf equals its
    slice of the saved array, bit for bit.  The directory is removed."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import model as lmm
    from repro_torch.models.spec import leaves
    cfg = dataclasses.replace(get_config(LM_ARCH, smoke=smoke),
                              n_layers=SHARDED_CKPT_LAYERS)
    like = lmm.init_params(cfg, SEED, "cpu")
    d = ROOT / "build" / "sharded_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    kind = torch.device(device).type
    t = time.perf_counter()
    try:
        CheckpointManager(d, async_write=False).save(0, like, blocking=True)
        rules = sharding.RULE_PROFILES[cfg.sharding_profile]

        def rank(r):
            mesh = lmesh.make_debug_mesh(MESH_DATA, MESH_MODEL,
                                         device_type=kind)
            placed = sharding.shardings_for(lmm.param_axes(cfg),
                                            lmm.abstract_params(cfg), mesh,
                                            rules)
            got, step = CheckpointManager(d).restore(like, shardings=placed)
            manifest = json.loads((d / "step_000000000" /
                                   "manifest.json").read_text())["arrays"]
            by_path = dict(leaves(placed))
            n_equal = n_leaves = 0
            for path, t_ in leaves(got.params):
                saved = np.load(d / "step_000000000"
                                / manifest[path]["file"], mmap_mode="r")
                block = saved[sharding.local_slices(saved.shape,
                                                    by_path[path])]
                local = t_.to_local()
                n_leaves += 1
                n_equal += (local.device.type == kind and torch.equal(
                    local.cpu(), torch.from_numpy(np.array(block))))
            return step, n_leaves, n_equal
        ranks = lmesh.run_threaded(MESH_DATA * MESH_MODEL, rank)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for step, n_leaves, n_equal in ranks:
        check(step == 0 and n_equal == n_leaves, f"(z2) rank blocks equal "
              f"the saved slices: {ranks}")
    out = {"leaves": ranks[0][1], "ranks": len(ranks),
           "bytes": sum(t_.numel() * t_.element_size()
                        for _, t_ in leaves(like.params)),
           "wall_s": time.perf_counter() - t}
    print(f"  (z2) {cfg.name} at {cfg.n_layers} layers "
          f"({out['bytes'] / 1e9:.2f} GB): a mesh-less checkpoint restored "
          f"onto the mesh with shardings=: every rank's block of each of "
          f"{out['leaves']} leaves equal to its slice of the saved array; "
          f"{out['wall_s']:.1f} s; card: {Phase.card}")
    return out


SHARD_FIELDS = ("scores", "best_locs", "best_scores", "topk_rows",
                "topk_scores", "hits", "survivor_rows")


def same_result(a, b) -> bool:
    """Bit for bit: every result array of two runs of one query."""
    import numpy as np
    for f in SHARD_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (
                x is not None and not np.array_equal(x, y)):
            return False
    return True


def timed_runs(engine, q, sync, reps=None):
    """A warm-up run, then ``reps`` (default ``TIMED_RUNS``) timed runs
    (host clock, each ending in ``sync()``): the last result and the run
    times in seconds."""
    cm = engine.compile(q)
    cm.run()
    times = []
    for _ in range(TIMED_RUNS if reps is None else reps):
        t = time.perf_counter()
        res = cm.run()
        sync()
        times.append(time.perf_counter() - t)
    return res, times


def shard_phase(frags, queries, want, *, zero_counts, read_counts, sync,
                device="cuda:0", shards=SHARDS, shards_2=SHARDS_2,
                n_append=SHARD_APPEND, keep=None):
    """Phase 12: the row-sharded main path on one card.

    ``frags`` are phase 4's rows (its host copy), ``queries`` phase 4's
    (a)-(f) and (c') by key and ``want`` phase 4's one-shard results of
    them.  An engine on ``make_row_mesh(shards, devices=[device] *
    shards)`` (q-gram index attached) runs every query, each result bit
    for bit ``want``'s; one on ``shards_2`` shards runs (a) and (c).  A
    one-shard twin over the same rows times each query beside it.  Then
    both take ``n_append`` seeded rows, tombstones on 1 in
    ``TOMBSTONE_EVERY`` rows and a compaction, with (a), (c) and (e) held
    equal after the tombstones and after the compaction, the shards
    balanced and the pack counters flat.  Returns what the phase prints.
    ``keep`` (a dict) receives the ``shards``-shard results phase 13
    holds its ranks to: by query key, and ``"{key}@{stage}"`` after the
    tombstones and the compaction.  ``device="cpu"`` rehearses it at a
    small size.
    """
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_row_mesh
    from repro_torch.match import MatchEngine

    cuda = device != "cpu"
    t_phase = time.perf_counter()
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    out = {"shards": shards, "card": Phase.card, "queries": {}}
    es = MatchEngine(frags, mesh=make_row_mesh(shards,
                                               devices=[device] * shards))
    e1 = MatchEngine(frags, device=device)
    check(es.n_shards == shards and es.merger.merge_path == "device",
          f"{shards}-shard engine")
    check(e1.n_shards == 1, "one-shard twin")
    for key, q in queries.items():
        zero_counts()
        m = es.merger
        pulls0, coll0, ncoll0 = (m.n_pulls, m.collective_bytes,
                                 m.n_collectives)
        res, ts = timed_runs(es, q, sync)
        counts = {n: c for n, c in read_counts().items() if c}
        runs = TIMED_RUNS + 1
        pulls = (m.n_pulls - pulls0) / runs
        coll = (m.collective_bytes - coll0) / runs
        if keep is not None:
            keep[key] = res
        res1, ts1 = timed_runs(e1, q, sync)
        ref = want[key]
        if res.plan.strategy == ref.plan.strategy:
            check(same_result(ref, res),
                  f"({key}) {shards} shards equal one shard")
        else:
            # The planner's filter-or-scan verdict moved with per-shard
            # pricing: the hits are the deliverable both must equal.
            check(np.array_equal(ref.hits, res.hits),
                  f"({key}) {shards} shards' hits equal one shard's")
        check(same_result(res1, ref), f"({key}) one-shard twin")
        check(res.n_shards == shards and res.merge_path == "device",
              f"({key}) result reports {shards} shards")
        launches = sum(counts.values()) / runs
        info = {
            "backend": res.plan.backend, "strategy": res.plan.strategy,
            "strategy_1": res1.plan.strategy,
            "n_chunks": res.n_chunks, "chunk_rows": res.plan.chunk_rows,
            "n_chunks_1": res1.n_chunks,
            "chunk_rows_1": res1.plan.chunk_rows,
            "ms": [t * 1e3 for t in ts], "ms_1": [t * 1e3 for t in ts1],
            "best_ms": min(ts) * 1e3, "best_ms_1": min(ts1) * 1e3,
            "launches": counts, "launches_per_run": launches,
            "launches_per_shard_chunk": launches / shards / res.n_chunks,
            "pulls": pulls, "collective_bytes": coll,
            "n_collectives": (m.n_collectives - ncoll0) / runs,
            "est_collective_bytes": res.plan.est_collective_bytes,
            "reason": res.plan.reason}
        out["queries"][key] = info
        print(f"  ({key}) S={shards} {res.plan.backend}/"
              f"{res.plan.strategy}: {info['best_ms']:.3f} ms (runs "
              f"{[round(t, 3) for t in info['ms']]}), S=1 "
              f"{info['best_ms_1']:.3f} ms (runs "
              f"{[round(t, 3) for t in info['ms_1']]}); {res.n_chunks} "
              f"chunks of {res.plan.chunk_rows} (S=1: {res1.n_chunks}); "
              f"{launches:g} launches a run ({info['launches_per_shard_chunk']:.3g}"
              f" a shard a chunk) {counts}; {pulls:g} pulls a run; "
              f"{coll:.0f} collective bytes a run; card: {Phase.card}")
        print(f"      reason: {res.plan.reason}")
    runs = TIMED_RUNS + 1
    for key, kern in (("a", "match_swar_best"), ("c", "match_mxu_best"),
                      ("d", "match_swar_best"), ("c2", "match_mxu")):
        n = out["queries"][key]["launches"].get(kern, 0)
        chunks = out["queries"][key]["n_chunks"]
        # Resident chunks launch once a shard; a row subset's chunk once a
        # shard that holds some of its rows.
        check(n == runs * shards * chunks if key != "c2"
              else runs * chunks <= n <= runs * shards * chunks,
              f"({key}) launches {kern} once a shard a chunk ({n})")
    check(out["queries"]["b"]["launches"].get("match_swar_masks", 0) > 0,
          "(b) launches match_swar_masks")
    e_info = out["queries"]["e"]["launches"]
    check(e_info.get("filter_qgram", 0) > 0 and e_info.get("match_swar", 0)
          > 0, "(e) launches filter_qgram and the verify's match_swar")

    # Two shards: (a) and (c).
    e2 = MatchEngine(frags, mesh=make_row_mesh(shards_2,
                                               devices=[device] * shards_2))
    for key in ("a", "c"):
        res = e2.compile(queries[key]).run()
        check(same_result(want[key], res) and res.n_shards == shards_2,
              f"({key}) {shards_2} shards equal one shard")
    del e2
    print(f"  ({shards_2} shards) (a), (c) equal one shard")

    # Growth, tombstones, compaction on the sharded engine and its twin.
    rng = np.random.default_rng(SEED + 12)
    more = rng.integers(0, 4, (n_append, frags.shape[1]), np.uint8)
    packs = [(e.corpus.host_pack_count, e.index.sig_pack_count)
             for e in (es, e1)]
    t = time.perf_counter()
    for e in (es, e1):
        e.corpus.append_rows(more)
    sync()
    append_s = time.perf_counter() - t
    n_now = es.corpus.n_rows
    dead = np.arange(0, n_now, TOMBSTONE_EVERY)
    for e in (es, e1):
        check(e.corpus.tombstone(dead) == dead.size, "tombstones")
    stages = {}
    for stage in ("tombstoned", "compacted"):
        if stage == "compacted":
            t = time.perf_counter()
            check(es.corpus.compact() == dead.size, "compaction")
            sync()
            stages["compact_s"] = time.perf_counter() - t
            t = time.perf_counter()
            e1.corpus.compact()
            sync()
            stages["compact_s_1"] = time.perf_counter() - t
        for key in ("a", "c", "e"):
            r4 = es.compile(queries[key]).run()
            r1 = e1.compile(queries[key]).run()
            check(same_result(r1, r4),
                  f"({key}) {stage}: {shards} shards equal one shard")
            if keep is not None:
                keep[f"{key}@{stage}"] = r4
    live = es.shard_live_rows()
    check(int(live.sum()) == es.corpus.n_rows == n_now - dead.size
          and int(live.max() - live.min()) <= 1,
          f"shards balanced after compaction ({live.tolist()})")
    check([(e.corpus.host_pack_count, e.index.sig_pack_count)
           for e in (es, e1)] == packs, "pack counters flat")
    out.update(append_rows=n_append, append_s=append_s,
               tombstoned=int(dead.size), shard_live_rows=live.tolist(),
               packs=packs[0], **stages)
    if cuda:
        sync()
        out["peak_bytes_above_start"] = (torch.cuda.max_memory_allocated()
                                         - mem0)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  grown by {n_append} rows ({append_s:.3f} s), "
          f"{dead.size} tombstoned, compacted ({stages['compact_s']:.3f} s;"
          f" S=1 {stages['compact_s_1']:.3f} s): (a), (c), (e) equal one "
          f"shard after each; shards {live.tolist()}; packs flat {packs[0]}"
          + (f"; peak {out['peak_bytes_above_start'] / 2**30:.3f} GiB above "
             "the phase's start" if cuda else "")
          + f"; {out['wall_s']:.1f} s; card: {Phase.card}")
    del es, e1
    train_free(cuda)
    return out


def result_digest(res) -> dict:
    """sha256 of each result array (dtype and shape included): what the
    ranks of phase 13 compare."""
    import hashlib

    import numpy as np
    out = {}
    for f in SHARD_FIELDS:
        x = getattr(res, f)
        if x is not None:
            x = np.ascontiguousarray(x)
            x = hashlib.sha256(f"{x.dtype}{x.shape}".encode()
                               + x.tobytes()).hexdigest()
        out[f] = x
    return out


def same_as_sharded(want, res) -> bool:
    """Phase 12's rule: bit for bit where the filter-or-scan verdict is
    the same, else the hits (the deliverable both must equal)."""
    import numpy as np
    if res.plan.strategy == want.plan.strategy:
        return same_result(want, res)
    return np.array_equal(want.hits, res.hits)


def match_kernels() -> dict:
    """The match path's kernel wrappers by name; each counts its launches
    in ``n_launches``."""
    from repro_torch.kernels import filter_qgram as kfq
    from repro_torch.kernels import match_mxu as kmx
    from repro_torch.kernels import match_swar as ksw
    return {"match_swar": ksw.match_swar,
            "match_swar_best": ksw.match_swar_best,
            "match_swar_masks": ksw.match_swar_masks,
            "match_mxu": kmx.match_mxu,
            "match_mxu_best": kmx.match_mxu_best,
            "filter_qgram": kfq.filter_qgram}


def gather_probe(mesh, sync, reps: int = 5) -> dict:
    """The host ms of one ``RowMesh.all_gather`` of an int32 block a rank
    (``PROBE_BYTES``) on an idle card, and of its steps under gloo: the
    copy to the host, the group's all-gather of host tensors, the join
    and copy back; the least of ``reps`` each, the ranks lined up by a
    barrier before every reading."""
    import torch
    dist = torch.distributed
    out = {}
    for nbytes in PROBE_BYTES:
        t = torch.zeros(nbytes // 4, dtype=torch.int32, device=mesh.device)
        rows = [t.shape[0]] * mesh.world
        ms = {"total": [], "d2h": [], "gather": [], "h2d": []}
        for _ in range(reps):
            sync()
            dist.barrier()
            a = time.perf_counter()
            mesh.all_gather(t, rows)
            sync()
            ms["total"].append(time.perf_counter() - a)
            dist.barrier()
            a = time.perf_counter()
            h = t.cpu()
            ms["d2h"].append(time.perf_counter() - a)
            outs = [torch.empty_like(h) for _ in range(mesh.world)]
            dist.barrier()
            a = time.perf_counter()
            dist.all_gather(outs, h)
            ms["gather"].append(time.perf_counter() - a)
            a = time.perf_counter()
            torch.cat(outs).to(mesh.device)
            sync()
            ms["h2d"].append(time.perf_counter() - a)
        out[str(nbytes)] = {k: min(v) * 1e3 for k, v in ms.items()}
    return out


def procs_rank(work: Path, devices, info) -> dict:
    """Phase 13's work on one rank: phase 12's engine and queries over
    this rank's shards, every result held to phase 12's; then phase 12's
    appends, tombstones and compaction with (a), (c), (e) held after
    each.  Returns what the rank reports."""
    import pickle

    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_row_mesh
    from repro_torch.match import MatchEngine

    cuda = devices[0] != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rank = info.process_id
    frags = np.load(work / "rows.npy")
    with open(work / "inputs.pkl", "rb") as fh:
        inp = pickle.load(fh)       # written by this script's parent
    queries, want, reps = inp["queries"], inp["want"], inp["timed_runs"]
    kernels = match_kernels()
    if cuda:
        torch.cuda.set_device(torch.device(devices[0]))
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
    mesh = make_row_mesh(inp["shards"], devices=devices)
    es = MatchEngine(frags, mesh=mesh)
    m = es.merger
    check(es.n_shards == inp["shards"] and m.multiprocess,
          f"rank {rank}: a {inp['shards']}-shard engine across processes")
    out = {"rank": rank, "world": info.process_count, "devices": devices,
           "local_shards": list(mesh.local_shards), "backend": mesh.backend,
           "torch": torch.__version__, "queries": {}}
    runs = reps + 1
    for key, q in queries.items():
        for k in kernels.values():
            k.n_launches = 0
        before = (m.n_pulls, m.collective_bytes, m.n_collectives,
                  m.collective_seconds)
        res, ts = timed_runs(es, q, sync, reps)
        check(same_as_sharded(want[key], res),
              f"rank {rank}: ({key}) equals phase 12's result")
        pulls, coll, ncoll, coll_s = (
            (a - b) / runs for a, b in zip(
                (m.n_pulls, m.collective_bytes, m.n_collectives,
                 m.collective_seconds), before))
        out["queries"][key] = {
            "strategy": res.plan.strategy, "n_chunks": res.n_chunks,
            "ms": [t * 1e3 for t in ts], "best_ms": min(ts) * 1e3,
            "launches": {n: k.n_launches for n, k in kernels.items()
                         if k.n_launches},
            "pulls": pulls, "collective_bytes": coll,
            "n_collectives": ncoll, "collective_ms": coll_s * 1e3,
            "digest": result_digest(res)}
    if mesh.backend == "gloo":
        out["gather_probe"] = gather_probe(mesh, sync)

    # Phase 12's growth, tombstones and compaction.
    more = np.random.default_rng(SEED + 12).integers(
        0, 4, (inp["n_append"], frags.shape[1]), np.uint8)
    t = time.perf_counter()
    es.corpus.append_rows(more)
    sync()
    out["append_s"] = time.perf_counter() - t
    dead = np.arange(0, es.corpus.n_rows, TOMBSTONE_EVERY)
    check(es.corpus.tombstone(dead) == dead.size, "tombstones")
    for stage in ("tombstoned", "compacted"):
        if stage == "compacted":
            t = time.perf_counter()
            check(es.corpus.compact() == dead.size, "compaction")
            sync()
            out["compact_s"] = time.perf_counter() - t
        for key in PROCS_MUTATED:
            res = es.compile(queries[key]).run()
            check(same_result(want[f"{key}@{stage}"], res),
                  f"rank {rank}: ({key}) {stage}: equals phase 12's result")
            out["queries"][f"{key}@{stage}"] = {"digest": result_digest(res)}
    c = es.corpus
    out["packs"] = {"swar": c.swar_pack_count, "onehot": c.onehot_pack_count,
                    "host_total": c.host_pack_count,
                    "signatures": es.index.sig_pack_count}
    out["shard_live_rows"] = es.shard_live_rows().tolist()
    if cuda:
        sync()
        out["peak_bytes_above_start"] = (torch.cuda.max_memory_allocated()
                                         - mem0)
    return out


def procs_worker(work: str) -> int:
    """One rank of phase 13, spawned by ``procs_phase`` as ``chip_smoke.py
    --procs-worker DIR``: joins the group its environment names, runs
    ``procs_rank`` and writes its report to ``DIR/rank{r}.json``."""
    from repro_torch.launch import cluster
    devices = os.environ["REPRO_SHARD_DEVICES"].split(",")
    info = cluster.initialize(backend=os.environ["REPRO_BACKEND"],
                              device=devices[0], timeout_s=PROCS_GROUP_S)
    try:
        out = procs_rank(Path(work), devices, info)
    finally:
        cluster.shutdown()
    with open(Path(work) / f"rank{info.process_id}.json", "w") as fh:
        json.dump(out, fh)
    return 0


def procs_phase(frags, queries, want, sharded, *, device="cuda",
                procs=PROCS, shards=SHARDS, n_append=SHARD_APPEND):
    """Phase 13: the row-sharded main path across processes.

    ``frags``, ``queries`` as phase 12 takes them, ``want`` phase 12's
    ``shards``-shard results (``shard_phase``'s ``keep``) and ``sharded``
    what phase 12 printed.  ``procs`` ranks spawned through
    ``repro_torch.launch.cluster``, each holding ``shards / procs``
    shards: on one card every rank on ``cuda:0`` under a gloo named
    here, with a card a rank rank ``r`` on ``cuda:r`` under NCCL.  Each
    rank holds every result to phase 12's; here the ranks must agree,
    pack once a form and launch half of phase 12's launches each.  A
    failed rank fails the phase (the others are killed).  Returns what
    the phase prints; ``device="cpu"`` rehearses it on gloo CPU ranks.
    """
    import pickle

    import numpy as np
    import torch
    from repro_torch.launch import cluster

    cuda = device != "cpu"
    t_phase = time.perf_counter()
    work = ROOT / "build" / "phase13"
    work.mkdir(parents=True, exist_ok=True)
    for old in work.glob("rank*"):
        old.unlink()
    np.save(work / "rows.npy", frags)
    with open(work / "inputs.pkl", "wb") as fh:
        pickle.dump({"queries": queries, "want": want, "shards": shards,
                     "n_append": n_append, "timed_runs": TIMED_RUNS}, fh)
    cards = torch.cuda.device_count() if cuda else 0
    backend, ranks, _ = cluster.demo_layout(
        procs, shards // procs, device,
        None if not cuda or cards >= procs else "gloo")
    coord = f"127.0.0.1:{cluster.free_port()}"
    envs = [cluster.process_env(r, procs, coord, ranks[r], backend)
            for r in range(procs)]
    tags = [f"rank{r}" for r in range(procs)]
    print(f"  {procs} ranks of {shards // procs} shards ({shards} in all), "
          f"backend {backend}, {cards} card(s): "
          + "; ".join(f"rank {r} on {ranks[r]}" for r in range(procs)))
    t = time.perf_counter()
    cluster.run_workers([sys.executable, str(Path(__file__).resolve()),
                         "--procs-worker", str(work)], envs, tags,
                        PROCS_TIMEOUT_S, log_dir=str(work))
    workers_s = time.perf_counter() - t
    for name in ("rows.npy", "inputs.pkl"):
        (work / name).unlink()
    outs = []
    for tag in tags:
        with open(work / f"{tag}.json") as fh:
            outs.append(json.load(fh))
    out = {"procs": procs, "shards": shards, "backend": backend,
           "card": Phase.card, "workers_s": workers_s,
           "ranks": [{k: o.get(k) for k in (
               "rank", "devices", "local_shards", "backend", "torch",
               "packs", "shard_live_rows", "gather_probe")}
               for o in outs], "queries": {}}
    for o in outs:
        check(o["backend"] == backend and o["world"] == procs,
              f"rank {o['rank']} in a {procs}-rank {backend} group")
        check(o["packs"]["swar"] == o["packs"]["onehot"]
              == o["packs"]["signatures"] == 1
              and o["packs"]["host_total"] == sharded["packs"][0],
              f"rank {o['rank']} packs once a form ({o['packs']})")
        print(f"  rank {o['rank']}: devices {o['devices']}, shards "
              f"{o['local_shards']}, torch {o['torch']}, packs "
              f"{o['packs']}" + (
                  f", peak {o['peak_bytes_above_start'] / 2**30:.3f} GiB "
                  "above its start" if cuda else ""))
        for nbytes, ms in o.get("gather_probe", {}).items():
            print(f"    gather of {int(nbytes):,} bytes a rank: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
                  + f" ms (least of 5); card: {Phase.card}")
    launches = {}
    for key, per in outs[0]["queries"].items():
        check(all(o["queries"][key]["digest"] == per["digest"]
                  for o in outs), f"({key}) ranks agree")
        if "@" in key:
            continue
        ref = sharded["queries"][key]
        rows = [o["queries"][key] for o in outs]
        if cuda:
            for name, n in ref["launches"].items():
                got = [r["launches"].get(name, 0) for r in rows]
                check(all(g * procs == n for g in got),
                      f"({key}) {name}: each rank launches 1/{procs} of "
                      f"phase 12's {n} ({got})")
        for r in rows:
            for name, n in r["launches"].items():
                launches[name] = launches.get(name, 0) + n
        out["queries"][key] = {
            "best_ms": [r["best_ms"] for r in rows],
            "ms": [r["ms"] for r in rows],
            "best_ms_sharded": ref["best_ms"],
            "launches": [r["launches"] for r in rows],
            "launches_sharded": ref["launches"],
            "n_collectives": rows[0]["n_collectives"],
            "n_collectives_sharded": ref["n_collectives"],
            "collective_bytes": rows[0]["collective_bytes"],
            "collective_bytes_sharded": ref["collective_bytes"],
            "collective_ms": [r["collective_ms"] for r in rows],
            "pulls": rows[0]["pulls"], "strategy": rows[0]["strategy"]}
        info = out["queries"][key]
        print(f"  ({key}) {info['strategy']}: "
              + ", ".join(f"rank {i} {ms:.3f} ms" for i, ms in
                          enumerate(info["best_ms"]))
              + f" (phase 12, one process: {ref['best_ms']:.3f} ms); "
              f"{info['n_collectives']:g} collectives, "
              f"{info['collective_bytes']:.0f} bytes a run (phase 12: "
              f"{ref['n_collectives']:g}, {ref['collective_bytes']:.0f}); "
              "collectives " + ", ".join(f"{c:.3f}" for c in
                                         info["collective_ms"])
              + f" ms a run by rank; launches {info['launches']}; card: "
              f"{Phase.card}")
    out["launches"] = launches
    out["mutated"] = [k for k in outs[0]["queries"] if "@" in k]
    out["append_s"] = [o["append_s"] for o in outs]
    out["compact_s"] = [o["compact_s"] for o in outs]
    if cuda:
        out["peak_bytes_above_start"] = [o["peak_bytes_above_start"]
                                         for o in outs]
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  appended {n_append} rows, tombstoned, compacted: "
          f"{', '.join(PROCS_MUTATED)} equal phase 12's after each on "
          f"every rank; ranks ran {workers_s:.1f} s; phase "
          f"{out['wall_s']:.1f} s; card: {Phase.card}")
    return out


def main_path_queries(ref, n_rows: int, rng):
    """Phase 4's reads at known (row, loc) and its queries, drawn from
    ``rng`` in phase 4's order: ``(queries, reads)``, the queries (a)-(f)
    and (c') by key, the reads' rows, locs, (a)'s read, (b)'s IUPAC
    string, (c)'s reads and mismatched queries and (c')'s rows."""
    import numpy as np
    from repro_torch.core import encoding
    from repro_torch.match import MatchQuery
    step = FRAG - READ + 1
    # Reads at known (row, loc): distinct rows, every read wholly inside
    # its row (loc <= FRAG - READ), so it occurs in that row only.
    rows = rng.choice(n_rows - 1, N_BATCH + 2, replace=False)
    locs = rng.integers(0, FRAG - READ + 1, N_BATCH + 2)

    def read_at(i):
        pos = int(rows[i]) * step + int(locs[i])
        return ref[pos:pos + READ].copy()

    read_a = read_at(0)
    read_b = read_at(1)
    iupac = list(encoding.decode_dna(read_b))
    for i in rng.choice(READ, 16, replace=False)[:10]:
        iupac[i] = "N"
    for i in range(0, READ, 17):
        if iupac[i] in "AG":
            iupac[i] = "R"
        elif iupac[i] in "CT":
            iupac[i] = "Y"
    iupac = "".join(iupac)
    reads_c = np.stack([read_at(2 + q) for q in range(N_BATCH)])
    n_mism = np.arange(N_BATCH) % 4
    queries_c = reads_c.copy()
    for q in range(N_BATCH):
        for i in rng.choice(READ, n_mism[q], replace=False):
            queries_c[q, i] = (queries_c[q, i] + 1) % 4
    qe = MatchQuery.exact(read_a, reduction="threshold", threshold=99,
                          filter=True)
    # (c'): a row subset that holds (c)'s planted rows.
    planted_c = rows[2:2 + N_BATCH]
    others = rng.choice(n_rows, 2 * SUBSET_C2, replace=False)
    others = others[~np.isin(others, planted_c)][:SUBSET_C2 - N_BATCH]
    rows_c2 = np.sort(np.concatenate([planted_c, others]))
    queries = {
        "a": MatchQuery.exact(read_a, reduction="best", backend="swar"),
        "b": MatchQuery.iupac(iupac, reduction="threshold", threshold=95,
                              backend="swar"),
        "c": MatchQuery.exact(queries_c, mode="batched", reduction="topk",
                              k=10, backend="mxu"),
        "d": MatchQuery.exact(read_a, reduction="best"),
        "c2": MatchQuery.exact(queries_c, mode="batched",
                               reduction="threshold", threshold=THRESHOLD_C2,
                               backend="mxu", rows=rows_c2, filter=False),
        "e": qe,
        "f": dataclasses.replace(qe, filter=None)}
    return queries, {"rows": rows, "locs": locs, "n_mism": n_mism,
                     "a": read_a, "iupac": iupac, "c": reads_c,
                     "queries_c": queries_c, "rows_c2": rows_c2}


def main() -> int:
    t_script = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on an "
              "NVIDIA card", file=sys.stderr)
        return 2

    from repro_torch.convert import swar_words_from_numpy
    from repro_torch.core import encoding
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitwise as kbw
    from repro_torch.kernels import cram_array as kca
    from repro_torch.kernels import filter_qgram as kfq
    from repro_torch.kernels import match_mxu as kmx
    from repro_torch.kernels import match_swar as ksw
    from repro_torch.kernels import ops
    from repro_torch.kernels import popcount as kpc
    from repro_torch.kernels.ref import as_u32, popcount_words
    from repro_torch.match import (MatchEngine, MatchQuery, PackedCorpus,
                                   PatternBank)
    from repro_torch.match.corpus import one_hot_flat
    from repro_torch.match.engine import _valid_mask
    from repro_torch.match.index import signature_words
    from repro_torch.obs.device_time import device_ms

    dev = torch.device("cuda")
    wrappers = {"match_swar": ksw.match_swar,
                "match_swar_best": ksw.match_swar_best,
                "match_swar_masks": ksw.match_swar_masks,
                "match_mxu": kmx.match_mxu,
                "match_mxu_best": kmx.match_mxu_best,
                "filter_qgram": kfq.filter_qgram,
                "bank_prefilter": kfq.bank_prefilter,
                "popcount": kpc.popcount,
                "bitwise": kbw.bitwise,
                "cram_execute": kca.cram_execute_bits,
                "cram_execute_bytes": kca.cram_execute_bytes}
    plains = {"match_swar": ksw.match_swar_plain,
              "match_swar_best": ksw.match_swar_best_plain,
              "match_swar_masks": ksw.match_swar_masks_plain,
              "match_mxu": kmx.match_mxu_plain,
              "match_mxu_best": kmx.match_mxu_best_plain}

    def zero_counts():
        for w in wrappers.values():
            w.n_launches = 0

    def read_counts():
        return {n: w.n_launches for n, w in wrappers.items()}

    # -- 1. environment ---------------------------------------------------
    with Phase("phase 1: environment"):
        print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
              f"cuda {torch.version.cuda}  device "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        smi = card_name()
        print(f"card: {smi}")
        Phase.card = smi

    # -- 2. build ---------------------------------------------------------
    with Phase("phase 2: build (nvcc, sm_90a)"):
        _build.build(BUILD)
        for name in BUILD:
            for line in _build.build_log(name).splitlines():
                if "Used" in line or "spill" in line or "entry" in line:
                    print(f"  {name}: {line.strip()}")

    # -- 3. edge shapes -----------------------------------------------------
    def words(a):
        return swar_words_from_numpy(a, dev)

    def u32(rng, shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint32)

    def same(got, want):
        if isinstance(got, tuple):
            return all(torch.equal(x, y) for x, y in zip(got, want))
        return torch.equal(got, want)

    with Phase("phase 3: kernels vs plain versions, edge shapes"):
        rng = np.random.default_rng(SEED)
        # sh == 0 only; P % 16 != 0; Wp 1-3; R exactly 8; P = 100; P > 256.
        for R, P, L in [(8, 16, 1), (8, 7, 40), (16, 23, 33), (8, 40, 17),
                        (24, 100, 50), (8, 300, 20), (64, 100, 401)]:
            wp = -(-P // 16)
            W = (L - 1) // 16 + wp + 2
            ref = words(u32(rng, (R, W)))
            val = words(_valid_mask(P, wp))
            for name, planes in (("match_swar", 1), ("match_swar_best", 1),
                                 ("match_swar_masks", 4)):
                pat = words(u32(rng, (R, planes * wp)))
                for p in (pat, pat[:1].expand(R, -1)):
                    got = wrappers[name](ref, p, val, n_locs=L,
                                         pattern_chars=P)
                    want = plains[name](ref, p, val, n_locs=L,
                                        pattern_chars=P)
                    check(same(got, want), f"{name} R={R} P={P} L={L}")
        # match_swar_best: a read planted at two alignments of row 0 (the
        # first wins) and an all-zero padding row (every alignment ties).
        R, P, L = 16, READ, 401
        wp = -(-P // 16)
        W = (L - 1) // 16 + wp + 2
        codes = rng.integers(0, 4, (R, 16 * W), np.uint8)
        pcodes = np.zeros(16 * wp, np.uint8)
        pcodes[:P] = rng.integers(0, 4, P)
        for loc in (17, 130):
            codes[0, loc:loc + P] = pcodes[:P]
        codes[:, -16:] = 0
        codes[-1] = 0

        def pack(c):
            lanes = c.reshape(c.shape[0], -1, 16).astype(np.uint32)
            return (lanes << (2 * np.arange(16, dtype=np.uint32))).sum(
                -1, dtype=np.uint32)
        ref, val = words(pack(codes)), words(_valid_mask(P, wp))
        pat = words(pack(pcodes[None])).expand(R, -1)
        got = ksw.match_swar_best(ref, pat, val, n_locs=L, pattern_chars=P)
        check(same(got, ksw.match_swar_best_plain(ref, pat, val, n_locs=L,
                                                   pattern_chars=P))
              and (int(got[0][0]), int(got[1][0])) == (17, P)
              and int(got[0][-1]) == 0,
              "match_swar_best planted tie and zero row")
        for R, P, Q in [(3, 20, 5), (2, 40, 1), (5, 100, 128), (2, 33, 256),
                        (8, 100, 130)]:
            p_chars = -(-P // kmx.CHARS_PER_CHUNK) * kmx.CHARS_PER_CHUNK
            l_pad = 2 * kmx.L_TILE
            f_chars = l_pad + p_chars
            flat = one_hot_flat(torch.from_numpy(rng.integers(
                0, 4, (R, f_chars), np.uint8)).to(dev), 4 * f_chars)
            q_pad = -(-Q // 128) * 128
            pat = torch.zeros((p_chars * 4, q_pad), dtype=torch.bfloat16,
                              device=dev)
            pat[:P * 4, :Q] = torch.from_numpy(
                rng.integers(0, 2, (P * 4, Q))).to(dev, torch.bfloat16)
            got = kmx.match_mxu(flat, pat, l_pad=l_pad)
            want = kmx.match_mxu_plain(flat, pat, l_pad=l_pad)
            check(torch.equal(torch.round(got).to(torch.int32),
                              torch.round(want).to(torch.int32)),
                  f"match_mxu R={R} P={P} Q={Q}")
        # match_mxu_best: n_locs off the 64 grid, an odd char count (rows
        # alternately 16- and 8-byte aligned), Q = 1 in a 128 pad, P4 =
        # 1,024 (the halved pattern tile), Q = 256.
        for R, P, Q, n_locs, extra in [(3, 20, 5, 201, 0),
                                       (4, 40, 128, 150, 1),
                                       (2, 33, 1, 77, 0),
                                       (2, 256, 130, 300, 0),
                                       (9, 100, 130, 401, 1)]:
            p_chars = -(-P // kmx.CHARS_PER_CHUNK) * kmx.CHARS_PER_CHUNK
            f_chars = kmx.best_l_pad(n_locs) + p_chars + extra
            flat = one_hot_flat(torch.from_numpy(rng.integers(
                0, 4, (R, f_chars), np.uint8)).to(dev), 4 * f_chars)
            q_pad = -(-Q // 128) * 128
            pat = torch.zeros((p_chars * 4, q_pad), dtype=torch.bfloat16,
                              device=dev)
            pat[:P * 4, :Q] = torch.from_numpy(
                rng.integers(0, 2, (P * 4, Q))).to(dev, torch.bfloat16)
            got = kmx.match_mxu_best(flat, pat, n_locs=n_locs, n_k=4 * P)
            want = kmx.match_mxu_best_plain(flat, pat, n_locs=n_locs,
                                            n_k=4 * P)
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"match_mxu_best R={R} P={P} Q={Q} n_locs={n_locs} "
                  f"F4={4 * f_chars}")
        # filter_qgram: dense rows (few absent bits) beside random ones.
        for wb in (1, 8, 16):
            sigs = u32(rng, (128, wb))
            sigs[64:] |= u32(rng, (64, wb)) | u32(rng, (64, wb))
            ts, tq = words(sigs), words(u32(rng, (1, wb)))
            for slack in (-1, 0, 3, wb * 32):
                check(torch.equal(
                    kfq.filter_qgram(ts, tq, slack=slack),
                    kfq.filter_qgram_plain(ts, tq, slack=slack)),
                    f"filter_qgram Wb={wb} slack={slack}")
        # bank_prefilter: D of one doc, a few, and three shared-memory
        # tiles; -1 pad rows; an all-zero doc; Wb beyond the register path.
        for wb, D in ((8, 1), (8, 8), (8, 700), (40, 50)):
            ps = words(u32(rng, (256, wb)) & u32(rng, (256, wb)))
            docs = u32(rng, (D, wb)) | u32(rng, (D, wb))
            if D > 1:
                docs[D // 2] = 0
            sl = rng.integers(-1, 30, (256, 1)).astype(np.int32)
            sl[-64:] = -1
            ds, tsl = words(docs), torch.from_numpy(sl).to(dev)
            got = kfq.bank_prefilter(ps, ds, tsl)
            check(torch.equal(got, kfq.bank_prefilter_plain(ps, ds, tsl))
                  and int(got[-64:].sum()) == 0,
                  f"bank_prefilter Wb={wb} D={D}")
        for w in (1, 33):
            x = words(u32(rng, (512, w)))
            check(torch.equal(kpc.popcount(x), kpc.popcount_plain(x)),
                  f"popcount W={w}")
        # popcount_rows: a ragged last tile with 1-3 words past its last 16
        # bytes, G > 1 threads a row (W = 257, 1024), chunked rows (W =
        # 2500), and one row.
        for n, w in ((1, 1), (5, 3), (129, 33), (4099, 33), (127, 257),
                     (9, 1024), (5, 2500)):
            x = words(u32(rng, (n, w)))
            check(torch.equal(kpc.popcount_rows(x), kpc.popcount_plain(x)),
                  f"popcount_rows N={n} W={w}")
        a, b = words(u32(rng, (256, 37))), words(u32(rng, (256, 37)))
        for op in kbw.OPS:
            for x, y in ((a, b), (a.view(-1)[1:1 + 256 * 36].view(256, 36),
                                  b.view(-1)[:256 * 36].view(256, 36))):
                check(torch.equal(kbw.bitwise(op, x, y),
                                  kbw.bitwise_plain(op, x, y)),
                      f"bitwise {op}")
        torch.cuda.synchronize()
        print("  all edge shapes bit-identical")

    # -- 4. main path at chr1 scale ----------------------------------------
    def drive(engine, q, reps=TIMED_RUNS):
        cm = engine.compile(q)
        cm.run()                                  # warm-up
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            res = cm.run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return res, times

    with Phase("phase 4: main path, chr1-sized reference"):
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        ref = encoding.random_dna(rng, CHR1_BP)
        corpus = PackedCorpus.from_reference(ref, FRAG, READ, device="cuda")
        engine = MatchEngine(corpus)
        n_rows = corpus.n_rows
        frags_chr1 = corpus.fragments.copy()   # phases 7-8 change the corpus
        print(f"  reference {CHR1_BP} bp -> {n_rows} rows x {FRAG} chars "
              f"(set-up {time.perf_counter() - t0:.1f} s)")

        queries, reads = main_path_queries(ref, n_rows, rng)
        qa, qb, qc, qd, qc2, qe, qf = (queries[k] for k in
                                       ("a", "b", "c", "d", "c2", "e", "f"))
        qe_scan = dataclasses.replace(qe, filter=False)
        rows, locs, n_mism = reads["rows"], reads["locs"], reads["n_mism"]
        read_a, iupac, rows_c2 = reads["a"], reads["iupac"], reads["rows_c2"]
        reads_c, queries_c = reads["c"], reads["queries_c"]
        runs = TIMED_RUNS + 1                     # warm-up + timed runs

        torch.cuda.reset_peak_memory_stats()
        results, timings, per_query = {}, {}, {}
        for key, q in (("a", qa), ("b", qb), ("c", qc), ("d", qd)):
            zero_counts()
            results[key], timings[key] = drive(engine, q)
            per_query[key] = read_counts()
        launches = {n: sum(c[n] for c in per_query.values())
                    for n in wrappers}
        peak_mem = torch.cuda.max_memory_allocated()
        print(f"  launches on the (a)-(d) path: {launches}")

        ra, rb, rc, rd = (results[k] for k in "abcd")
        check(int(ra.best_scores[rows[0]]) == READ
              and int(ra.best_locs[rows[0]]) == int(locs[0]),
              "(a) planted read scores 100 at its loc")
        check(int(np.count_nonzero(ra.best_scores == READ)) == 1,
              "(a) planted row is the only exact hit")
        hits_b = {tuple(h) for h in rb.hits.tolist()}
        check((int(rows[1]), int(locs[1]), READ) in hits_b,
              "(b) planted IUPAC hit reported")
        check(rb.plan.predicate == "accept", "(b) ran the accept predicate")
        print(f"  (b) strategy {rb.plan.strategy}: {rb.plan.reason}")
        check(np.array_equal(rc.topk_rows[0], rows[2:2 + N_BATCH])
              and np.array_equal(rc.topk_scores[0], READ - n_mism),
              "(c) every query's top row is its planted row")
        check(per_query["c"]["match_mxu_best"] == runs * rc.n_chunks
              and per_query["c"]["match_mxu"] == 0,
              "(c) launches match_mxu_best once per chunk, match_mxu never")
        print(f"  (d) planner chose {rd.plan.backend}: {rd.plan.reason}")
        check(rd.plan.backend == "swar", "(d) planner chose SWAR")
        check(np.array_equal(rd.best_scores, ra.best_scores)
              and np.array_equal(rd.best_locs, ra.best_locs),
              "(d) agrees with (a)")
        for key, res in (("a", ra), ("d", rd)):
            check(per_query[key]["match_swar_best"] == runs * res.n_chunks
                  and per_query[key]["match_swar"] == 0,
                  f"({key}) launches match_swar_best once per chunk, "
                  "match_swar never")
        for name in ("match_swar_best", "match_swar_masks",
                     "match_mxu_best"):
            check(launches[name] > 0, f"{name} launched on the main path")

        # (c'): the full-block kernel and the threshold reduction.
        zero_counts()
        results["c2"], timings["c2"] = drive(engine, qc2)
        launches_c2 = read_counts()
        rc2 = results["c2"]
        print(f"  launches on the (c') path: {launches_c2}")
        check(launches_c2["match_mxu"] == runs * rc2.n_chunks
              and launches_c2["match_mxu_best"] == 0,
              "(c') launches match_mxu once per chunk")
        hits_c2 = {tuple(h) for h in rc2.hits.tolist()}
        missing = [q for q in range(N_BATCH)
                   if (int(rows[2 + q]), int(locs[2 + q]), q,
                       READ - int(n_mism[q])) not in hits_c2]
        check(not missing, f"(c') every planted hit reported "
              f"(missing reads {missing})")
        print(f"  (c') {rc2.hits.shape[0]} hits at >= {THRESHOLD_C2} over "
              f"{len(rows_c2)} rows, all {N_BATCH} planted hits among them")

        # (e), (f): filter-then-verify through the q-gram index.
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.index.signatures()
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t
        print(f"  q-gram index built on the card in {index_s:.3f} s "
              f"({engine.index.stats()})")
        zero_counts()
        for key, q in (("e", qe), ("f", qf)):
            results[key], timings[key] = drive(engine, q)
        launches_ef = read_counts()
        print(f"  launches on the (e)-(f) path: {launches_ef}")
        results["e_scan"], timings["e_scan"] = drive(engine, qe_scan)
        re_, rf, rs = results["e"], results["f"], results["e_scan"]
        check(re_.plan.strategy == "filter", "(e) ran filter-then-verify")
        check(rs.plan.strategy == "scan", "(e) scanned with filter=False")
        check(np.array_equal(re_.hits, rs.hits)
              and np.array_equal(rf.hits, rs.hits),
              "(e), (f) hits equal the scan's")
        check((int(rows[0]), int(locs[0]), READ) in
              {tuple(h) for h in re_.hits.tolist()},
              "(e) planted hit reported")
        check(int(rows[0]) in set(re_.survivor_rows.tolist()),
              "(e) planted row survived the filter")
        check(engine.index.sig_pack_count == 1, "(e) one signature pack")
        check(launches_ef["filter_qgram"] > 0,
              "filter_qgram launched on the (e)-(f) path")
        check(launches_ef["match_swar"] > 0,
              "match_swar launched on the (e)-(f) path (verify)")
        print(f"  (e) survivors {len(re_.survivor_rows)} rows "
              f"({re_.survivor_frac:.6f} of {n_rows}), "
              f"{re_.hits.shape[0]} hits; (f) planner chose "
              f"{rf.plan.strategy}: {rf.plan.reason}")

        main_path = {}
        for key, q in (("a", qa), ("b", qb), ("c", qc), ("d", qd),
                       ("c2", qc2), ("e", qe), ("f", qf),
                       ("e_scan", qe_scan)):
            res, ts = results[key], timings[key]
            best = min(ts)
            scanned = len(rows_c2) if key == "c2" else n_rows
            main_path[key] = {
                "backend": res.plan.backend, "predicate": res.plan.predicate,
                "strategy": res.plan.strategy,
                "reduction": q.reduction, "n_patterns": res.plan.n_patterns,
                "chunk_rows": res.plan.chunk_rows, "n_chunks": res.n_chunks,
                "survivor_frac": res.survivor_frac,
                "ms": [t * 1e3 for t in ts], "best_ms": best * 1e3,
                "rows": scanned, "rows_per_s": scanned / best,
                "row_patterns_per_s": scanned * res.plan.n_patterns / best}
            print(f"  ({key}) {res.plan.backend}/{res.plan.predicate} "
                  f"{q.reduction} {res.plan.strategy}: runs "
                  f"{[round(t * 1e3, 3) for t in ts]} ms, "
                  f"{scanned / best:.4g} rows/s, "
                  f"{res.n_chunks} chunks of {res.plan.chunk_rows}")
        main_path["index_build_s"] = index_s
        print(f"  peak device memory over (a)-(d) {peak_mem / 2**30:.3f} GiB")

        # (a) and (b) against the ref backend on the full corpus (the same
        # strategy as the kernel run, so the best arrays cover the same
        # rows).
        for key, q in (("a", qa), ("b", qb)):
            res = results[key]
            qr = dataclasses.replace(
                q, backend="ref", filter=(res.plan.strategy == "filter"))
            t = time.perf_counter()
            rr = engine.compile(qr).run()
            torch.cuda.synchronize()
            main_path[key]["ref_ms"] = (time.perf_counter() - t) * 1e3
            check(np.array_equal(rr.best_locs, res.best_locs)
                  and np.array_equal(rr.best_scores, res.best_scores),
                  f"({key}) best arrays equal the ref backend's")
            if q.reduction == "threshold":
                check(np.array_equal(rr.hits, res.hits),
                      f"({key}) hits equal the ref backend's")
        print(f"  (a), (b) identical to the ref backend on all {n_rows} "
              "rows")
        print("main_path " + json.dumps(main_path))

    # -- 4b. standing bank ----------------------------------------------------
    with Phase("phase 4b: standing bank, 4,096 patterns x 256-doc batches"):
        t0 = time.perf_counter()
        brng = np.random.default_rng(SEED + 1)
        starts = rng.integers(0, CHR1_BP - READ, BANK_PATTERNS)
        bank_pats = np.stack([ref[s:s + READ] for s in starts])
        thresholds = np.where(np.arange(BANK_PATTERNS) % 4 == 3, READ - 1,
                              READ)
        bank = PatternBank(FRAG, READ)
        pids = np.array([bank.register(p, threshold=float(t))
                         for p, t in zip(bank_pats, thresholds)])
        batches, planted = [], []
        for _ in range(BANK_BATCHES):
            docs = brng.integers(0, 4, (BANK_DOCS, FRAG), np.uint8)
            d_sel = brng.choice(BANK_DOCS, BANK_PLANTED, replace=False)
            p_sel = brng.choice(BANK_PATTERNS, BANK_PLANTED, replace=False)
            l_sel = brng.integers(0, FRAG - READ + 1, BANK_PLANTED)
            for d, p, lo in zip(d_sel, p_sel, l_sel):
                docs[d, lo:lo + READ] = bank_pats[p]
            batches.append(docs)
            planted.append({(int(d), int(lo), int(pids[p]), READ)
                            for d, p, lo in zip(d_sel, p_sel, l_sel)})
        print(f"  {bank.n_live} patterns registered, "
              f"{BANK_BATCHES} batches made "
              f"(set-up {time.perf_counter() - t0:.1f} s)")
        for docs in batches[:1]:                  # warm-up, both modes
            for mode in (True, False):
                bank.filter = mode
                bank.scan(docs)
        torch.cuda.synchronize()
        n0_scans, n0_bank = bank.n_scans, bank.n_bank_launches
        zero_counts()
        tickets = {True: [], False: []}
        bank_ms = {True: [], False: []}
        verify_peak = 0
        for docs in batches:
            for mode in (True, False):
                bank.filter = mode
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t = time.perf_counter()
                tk = bank.scan(docs)
                torch.cuda.synchronize()
                bank_ms[mode].append((time.perf_counter() - t) * 1e3)
                if not mode:
                    verify_peak = max(verify_peak,
                                      torch.cuda.max_memory_allocated()
                                      - base)
                tickets[mode].append(tk)
        launches_bank = read_counts()
        n_scans = bank.n_scans - n0_scans
        print(f"  launches on the bank path: {launches_bank}")
        check(bank.n_bank_launches - n0_bank == n_scans
              == 2 * BANK_BATCHES, "one verify launch per scan")
        check(launches_bank["bank_prefilter"] == BANK_BATCHES,
              "bank_prefilter launched once per filtered scan")
        check(launches_bank["match_swar_masks"] == n_scans,
              "one match_swar_masks launch per scan")
        for i, docs in enumerate(batches):
            tf, ts = tickets[True][i], tickets[False][i]
            check(np.array_equal(tf.hits, ts.hits),
                  f"bank batch {i}: filtered hits equal the full scan's")
            check(planted[i] <= {tuple(h) for h in tf.hits.tolist()},
                  f"bank batch {i}: every planted hit found")
        # Per pattern, the bank's hits equal an ad-hoc threshold query
        # over the batch (index-free engine), on a sample that includes
        # planted patterns.
        docs, tk = batches[0], tickets[True][0]
        adhoc = MatchEngine(docs, index=False)
        sample = sorted({h[2] for h in planted[0]})[:BANK_SAMPLE // 2]
        sample += [int(p) for p in brng.choice(pids, BANK_SAMPLE // 2,
                                                replace=False)]
        for pid in sample:
            want = adhoc.match(bank.pattern(pid).query).hits
            mine = tk.hits[tk.hits[:, 2] == pid][:, [0, 1, 3]]
            check(np.array_equal(mine, want),
                  f"bank pattern {pid} equals its ad-hoc query")
        surv = [t.survivor_frac for t in tickets[True]]
        bank_info = {
            "n_patterns": bank.n_live, "n_docs": BANK_DOCS,
            "filter_ms": bank_ms[True], "scan_ms": bank_ms[False],
            "survivor_frac": surv,
            "n_hits": [int(t.hits.shape[0]) for t in tickets[True]],
            "verify_peak_bytes": verify_peak,
            "plan": tickets[True][0].plan.reason}
        print(f"  filtered scans {[round(m, 3) for m in bank_ms[True]]} ms, "
              f"full scans {[round(m, 3) for m in bank_ms[False]]} ms; "
              f"survivor fractions {[round(f, 4) for f in surv]}; "
              f"verify peak {verify_peak / 2**30:.3f} GiB above the "
              f"resident forms; {len(sample)} sampled patterns equal "
              "their ad-hoc queries")
        print("bank " + json.dumps(bank_info))

    # -- 4c. bulk ops ---------------------------------------------------------
    with Phase("phase 4c: bulk popcount and XOR"):
        swar = corpus.swar_words(1)
        n_xor = XOR_BYTES // 4 // 256
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        xa, xb = (torch.randint(-2**31, 2**31, (n_xor, 256),
                                dtype=torch.int32, device=dev,
                                generator=gen) for _ in range(2))
        zero_counts()
        pc = ops.popcount(swar)
        xo = ops.bitwise("XOR", xa, xb)
        torch.cuda.synchronize()
        launches_bulk = read_counts()
        print(f"  launches on the bulk path: {launches_bulk}")
        want_pc = popcount_words(as_u32(swar)).sum(-1).to(torch.int32)
        check(torch.equal(pc, want_pc), "ops.popcount equals its plain "
              f"version over the SWAR form {tuple(swar.shape)}")
        check(torch.equal(xo, torch.bitwise_xor(xa, xb)),
              f"ops.bitwise XOR equals torch.bitwise_xor on {n_xor} x 256")
        check(launches_bulk["popcount"] == 1
              and launches_bulk["bitwise"] == 1, "bulk kernels launched")
        print(f"  popcount of {tuple(swar.shape)} words: "
              f"{int(pc.sum())} bits set; XOR of two {XOR_BYTES >> 20} MiB "
              "operands bit-identical")
        # ops.popcount end to end: host clock around a call that ends in a
        # synchronize, the least of 20 after a warm-up.
        for _ in range(3):
            ops.popcount(swar)
        torch.cuda.synchronize()
        pc_host = []
        for _ in range(20):
            t0 = time.perf_counter()
            ops.popcount(swar)
            torch.cuda.synchronize()
            pc_host.append((time.perf_counter() - t0) * 1e3)
        print(f"  ops.popcount host clock over {tuple(swar.shape)}: min "
              f"{min(pc_host):.4f} ms, median "
              f"{sorted(pc_host)[len(pc_host) // 2]:.4f} ms (20 calls)")

    # -- 5. kernels at their paths' shapes ----------------------------------
    with Phase("phase 5: kernels at their paths' shapes"):
        kernels = []
        l2 = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

        def flush():
            l2.zero_()
        # The SWAR kernels at their paths' launches: match_swar_best at
        # (a)'s (one chunk of rows against the read, broadcast), STORE
        # match_swar at (e)'s verify (the operands of that launch, taken
        # from one run: the gathered survivor rows and the read broadcast
        # to them; also timed at (a)'s chunk, the shape earlier builds
        # were timed at), match_swar_masks at (b)'s.  Each is held
        # against its plain version on max(chunk, SUBSET_ROWS) rows of
        # (a)'s or (b)'s operands, STORE also on the verify's.  Bytes:
        # the rows read once, and the (R, L) block or BEST's (R,) pairs
        # written.
        verify_ops = []
        swar_operands = engine._swar_operands

        def spy(*a, **kw):
            verify_ops.append(swar_operands(*a, **kw))
            return verify_ops[-1]
        engine._swar_operands = spy
        try:
            zero_counts()
            cm = engine.compile(qe)
            cm.run()
            plan_e = cm.plan
            check(len(verify_ops) == ksw.match_swar.n_launches > 0,
                  "(e) verifies through match_swar")
        finally:
            del engine._swar_operands
        for name, key in (("match_swar_best", "a"), ("match_swar", "a"),
                          ("match_swar_masks", "b")):
            cm = engine.compile(qa if key == "a" else qb)
            plan = cm.plan
            base = corpus.swar_words(plan.need_words)
            pat_rows, val = cm._packed
            kern, plain = wrappers[name], plains[name]

            def args(r):
                return (base[:r], pat_rows[:1].expand(r, -1), val)
            kw = dict(n_locs=plan.n_locs, pattern_chars=plan.pattern_chars)
            n_cmp = max(plan.chunk_rows, SUBSET_ROWS)
            cmp_sets = [args(n_cmp)]
            if name == "match_swar":
                check((plan_e.n_locs, plan_e.pattern_chars, plan_e.wp)
                      == (plan.n_locs, plan.pattern_chars, plan.wp),
                      "(e)'s verify launch has (a)'s geometry")
                cmp_sets.append(verify_ops[0])
            err = 0
            for ops_ in cmp_sets:
                got = kern(*ops_, **kw)
                want = plain(*ops_, **kw)
                err = max([err] + [int((x - y).abs().max()) for x, y in (
                    zip(got, want) if isinstance(got, tuple)
                    else [(got, want)])])
                del got, want
            check(err == 0, f"{name} equals its plain version on "
                  + " and ".join(str(o[0].shape[0]) for o in cmp_sets)
                  + " rows")
            a = cmp_sets[-1] if name == "match_swar" else args(plan.chunk_rows)
            R = a[0].shape[0]             # the path's launch shape
            ms = device_ms(lambda: kern(*a, **kw), 20, flush)
            event_ms = cuda_ms(lambda: kern(*a, **kw), 20)
            plain_ms = cuda_ms(lambda: plain(*a, **kw), 2)
            extra = {}
            if name == "match_swar":
                a_chunk = args(plan.chunk_rows)
                extra["ms_a_chunk"] = device_ms(
                    lambda: kern(*a_chunk, **kw), 20, flush)
            W = a[0].shape[1]
            n_planes = pat_rows.shape[1]
            n_words = R * plan.n_locs * plan.wp
            out_bytes = R * 8 if name == "match_swar_best" \
                else R * plan.n_locs * 4
            nbytes = R * W * 4 + n_planes * 4 + plan.wp * 4 + out_bytes
            t_word = max(n_words * SWAR_INT_OPS_PER_WORD[name] / PEAK_INT32,
                         n_words / PEAK_POPC)
            if name in EXACT_INT_OPS:
                int_ops, n_popc = exact_swar_ops(name, R, plan.n_locs,
                                                 plan.wp)
                t_ops = max(int_ops / PEAK_INT32, n_popc / PEAK_POPC)
                extra["bound_ms_first_build"] = max(
                    t_word, nbytes / HBM_BW) * 1e3
            else:
                t_ops = t_word
            t_bytes = nbytes / HBM_BW
            kernels.append(dict(
                name=name, rows=R, ms=ms, event_ms=event_ms,
                plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, max_abs_err=err, **extra))

        cm = engine.compile(qc)
        plan = cm.plan
        base = corpus.onehot_flat(plan.f_chars)
        pat = cm._packed
        R = plan.chunk_rows
        Qn = plan.n_patterns
        bkw = dict(n_locs=plan.n_locs, n_k=4 * plan.pattern_chars)
        err = err_best = 0
        for r0 in range(0, SUBSET_ROWS, R):
            rows_ = base[r0:min(r0 + R, SUBSET_ROWS)]
            got = torch.round(kmx.match_mxu(rows_, pat, l_pad=plan.l_pad))
            want = torch.round(kmx.match_mxu_plain(rows_, pat,
                                                   l_pad=plan.l_pad))
            err = max(err, int((got - want).abs().max()))
            for x, y in zip(kmx.match_mxu_best(rows_, pat, **bkw),
                            kmx.match_mxu_best_plain(rows_, pat, **bkw)):
                err_best = max(err_best, int((x - y).abs().max()))
        check(err == 0, f"match_mxu equals its plain version on "
              f"{SUBSET_ROWS} rows")
        check(err_best == 0, f"match_mxu_best equals its plain version on "
              f"{SUBSET_ROWS} rows")
        # Every corpus row: the fused best against the full block +
        # argmax/amax (the engine's epilogue before the fusion), and (c)'s
        # top-10 against the top-10 of those best scores under (score
        # desc, row asc).
        n_pad = corpus.n_rows_padded
        store_bs = torch.empty((n_pad, Qn), dtype=torch.int32, device=dev)
        n_diff = 0
        for r0 in range(0, n_pad, R):
            rows_ = base[r0:min(r0 + R, n_pad)]
            sc = torch.round(kmx.match_mxu(rows_, pat, l_pad=plan.l_pad)[
                :, :plan.n_locs, :Qn]).to(torch.int32)
            fl, fs = kmx.match_mxu_best(rows_, pat, **bkw)
            n_diff += int((fl[:, :Qn] != sc.argmax(1)).sum()
                          + (fs[:, :Qn] != sc.amax(1)).sum())
            store_bs[r0:r0 + rows_.shape[0]] = sc.amax(1)
        check(n_diff == 0, "match_mxu_best equals match_mxu + argmax/amax "
              f"on all {n_pad} rows")
        ids = torch.arange(n_rows, dtype=torch.int64, device=dev)[:, None]
        key = torch.sort((-store_bs[:n_rows].to(torch.int64) << 32) | ids,
                         dim=0).values[:rc.topk_rows.shape[0]]
        check(np.array_equal(rc.topk_rows, (key & 0xFFFFFFFF).cpu().numpy())
              and np.array_equal(rc.topk_scores,
                                 (-(key >> 32)).cpu().numpy()),
              "(c)'s top-10 equals the full-block kernel's")
        print(f"  match_mxu_best equals match_mxu + argmax/amax on all "
              f"{n_pad} rows; (c)'s top-10 rows and scores equal theirs")

        chunk = base[:R]
        # Library yardstick (never used by the port): cuDNN conv1d of the
        # one-hot rows against the patterns, TF32 off.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        f_chars = chunk.shape[1] // 4
        x = chunk.view(R, f_chars, 4).permute(0, 2, 1).contiguous()
        w = pat.view(plan.p_chars_pad, 4, plan.q_pad).permute(2, 1, 0
                                                              ).contiguous()
        conv = torch.nn.functional.conv1d(x, w)
        out = kmx.match_mxu(chunk, pat, l_pad=plan.l_pad)
        check(torch.equal(
            torch.round(conv[:, :, :plan.l_pad].float()).permute(0, 2, 1),
            torch.round(out)), "conv1d yardstick agrees with match_mxu")
        del conv, out
        times, turns = device_ms_turns(
            {"kernel": lambda: kmx.match_mxu(chunk, pat, l_pad=plan.l_pad),
             "library": lambda: torch.nn.functional.conv1d(x, w)}, 10, flush)
        event_ms = cuda_ms(lambda: kmx.match_mxu(chunk, pat,
                                                 l_pad=plan.l_pad), 10)
        plain_ms = cuda_ms(
            lambda: kmx.match_mxu_plain(chunk, pat, l_pad=plan.l_pad), 2)
        F4, P4, Q = chunk.shape[1], pat.shape[0], pat.shape[1]
        flops = R * plan.l_pad * P4 * 2 * Q
        nbytes = R * F4 * 2 + P4 * Q * 2 + R * plan.l_pad * Q * 4
        bms, bby = bound(nbytes, flops, PEAK_BF16)
        kernels.append(dict(
            name="match_mxu", rows=R, ms=times["kernel"], event_ms=event_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
            library_ms=times["library"], max_abs_err=err, turns=turns))

        # match_mxu_best at (c)'s launch.  No one PyTorch call computes the
        # best alignment; the bound counts the unpadded work (n_locs
        # alignments, 4P rows, the query's patterns).
        ms = device_ms(lambda: kmx.match_mxu_best(chunk, pat, **bkw), 20,
                       flush)
        event_ms = cuda_ms(lambda: kmx.match_mxu_best(chunk, pat, **bkw), 20)
        plain_ms = cuda_ms(
            lambda: kmx.match_mxu_best_plain(chunk, pat, **bkw), 2)
        flops = R * plan.n_locs * bkw["n_k"] * 2 * Qn
        nbytes = R * F4 * 2 + P4 * Q * 2 + 2 * R * Q * 4
        bms, bby = bound(nbytes, flops, PEAK_BF16)
        kernels.append(dict(
            name="match_mxu_best", rows=R, ms=ms, event_ms=event_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None,
            max_abs_err=err_best))

        # filter_qgram at (e)'s launch: every live row's signature.
        cm = engine.compile(qe)
        sigs = engine.index.signatures()
        tile = kfq.FILTER_ROW_TILE
        rows_f = sigs[:-(-n_rows // tile) * tile]
        qsig, slack = cm._filter_dev[0:1], cm._filter_ops.slacks[0]
        got = kfq.filter_qgram(rows_f, qsig, slack=slack)
        want = kfq.filter_qgram_plain(rows_f, qsig, slack=slack)
        err = int((got - want).abs().max())
        check(err == 0, f"filter_qgram equals its plain version on "
              f"{rows_f.shape[0]} rows")
        ms = device_ms(lambda: kfq.filter_qgram(rows_f, qsig, slack=slack),
                       50, flush)
        event_ms = cuda_ms(lambda: kfq.filter_qgram(rows_f, qsig,
                                                    slack=slack), 50)
        plain_ms = cuda_ms(lambda: kfq.filter_qgram_plain(rows_f, qsig,
                                                          slack=slack), 3)
        Rf, Wb = rows_f.shape
        # Per word: one and-not (INT32 issue) and one popcount.
        t_ops = max(Rf * Wb / PEAK_POPC, 2 * Rf * Wb / PEAK_INT32)
        nbytes = Rf * Wb * 4 + Wb * 4 + Rf * 4
        kernels.append(dict(
            name="filter_qgram", rows=Rf, ms=ms, event_ms=event_ms,
            plain_ms=plain_ms,
            bound_ms=max(t_ops, nbytes / HBM_BW) * 1e3,
            bound_by="operations" if t_ops >= nbytes / HBM_BW else "bytes",
            library_ms=None, max_abs_err=err))

        # bank_prefilter at the bank's launch: all pattern slots against
        # one batch's doc signatures.  Its work depends on the data: a
        # pattern stops at its first admitting doc, and slack -1 rows test
        # none, so the bound counts the (pattern, doc) tests this batch
        # needs.
        psigs, pslacks = bank.filter_operands()
        dsigs, _ = signature_words(
            torch.from_numpy(batches[0]).to(dev), bank.q, bank.n_bits)
        got = kfq.bank_prefilter(psigs, dsigs, pslacks)
        want = kfq.bank_prefilter_plain(psigs, dsigs, pslacks)
        err = int((got - want).abs().max())
        check(err == 0, "bank_prefilter equals its plain version")
        ms = device_ms(lambda: kfq.bank_prefilter(psigs, dsigs, pslacks),
                       50, flush)
        event_ms = cuda_ms(lambda: kfq.bank_prefilter(psigs, dsigs,
                                                      pslacks), 50)
        plain_ms = cuda_ms(
            lambda: kfq.bank_prefilter_plain(psigs, dsigs, pslacks), 3)
        absent = popcount_words(as_u32(psigs)[:, None, :]
                                & ~as_u32(dsigs)[None]).sum(-1)
        fits = absent <= pslacks.to(torch.int64)
        D = dsigs.shape[0]
        tested = torch.where(fits.any(1), fits.int().argmax(1) + 1, D)
        tested = torch.where(pslacks[:, 0] < 0, 0, tested)
        n_tests = int(tested.sum())
        Qb, Wb = psigs.shape
        t_ops = max(n_tests * Wb / PEAK_POPC, 2 * n_tests * Wb / PEAK_INT32)
        nbytes = (Qb + D) * Wb * 4 + Qb * 8
        kernels.append(dict(
            name="bank_prefilter", rows=Qb, ms=ms, event_ms=event_ms,
            plain_ms=plain_ms,
            bound_ms=max(t_ops, nbytes / HBM_BW) * 1e3,
            bound_by="operations" if t_ops >= nbytes / HBM_BW else "bytes",
            library_ms=None, max_abs_err=err, pair_tests=n_tests))

        # popcount at the SWAR form padded to 256-row tiles (the launch
        # earlier builds were timed at), and at the bulk path's own launch
        # since the pad went: the form's rows as they are.
        pcin = swar if swar.shape[0] % kpc.N_TILE == 0 else torch.cat(
            [swar, swar.new_zeros((-swar.shape[0] % kpc.N_TILE,
                                   swar.shape[1]))])
        got = kpc.popcount(pcin)
        err = int((got - kpc.popcount_plain(pcin)).abs().max())
        got = kpc.popcount_rows(swar)
        err = max(err, int((got - kpc.popcount_plain(swar)).abs().max()))
        check(err == 0, "popcount equals its plain version, padded and not")
        ms = device_ms(lambda: kpc.popcount(pcin), 50, flush)
        ms_unpadded = device_ms(lambda: kpc.popcount_rows(swar), 50, flush)
        event_ms = cuda_ms(lambda: kpc.popcount(pcin), 50)
        plain_ms = cuda_ms(lambda: kpc.popcount_plain(pcin), 3)
        Np, Wp_ = pcin.shape
        bms, bby = bound(Np * Wp_ * 4 + Np * 4, Np * Wp_, PEAK_POPC)
        Nu = swar.shape[0]
        bms_u, _ = bound(Nu * Wp_ * 4 + Nu * 4, Nu * Wp_, PEAK_POPC)
        kernels.append(dict(
            name="popcount", rows=Np, ms=ms, event_ms=event_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None,
            max_abs_err=err, ms_unpadded=ms_unpadded,
            bound_ms_unpadded=bms_u, rows_unpadded=Nu))

        # bitwise at the bulk path's launch: XOR of the 256 MiB pair.
        got = kbw.bitwise("XOR", xa, xb)
        err = int((got != kbw.bitwise_plain("XOR", xa, xb)).sum())
        check(err == 0, "bitwise equals its plain version")
        times, turns = device_ms_turns(
            {"kernel": lambda: kbw.bitwise("XOR", xa, xb),
             "library": lambda: torch.bitwise_xor(xa, xb)}, 20, flush)
        event_ms = cuda_ms(lambda: kbw.bitwise("XOR", xa, xb), 20)
        plain_ms = cuda_ms(lambda: kbw.bitwise_plain("XOR", xa, xb), 20)
        bms, bby = bound(3 * xa.numel() * 4, xa.numel(), PEAK_INT32)
        kernels.append(dict(
            name="bitwise", rows=xa.shape[0], ms=times["kernel"],
            event_ms=event_ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=bby, library_ms=times["library"],
            max_abs_err=err, turns=turns))
        for k in kernels:
            print(f"  {k['name']}: {k['rows']} rows, kernel {k['ms']:.4f} ms "
                  f"on the device ({k['event_ms']:.4f} ms per call by "
                  f"events), plain {k['plain_ms']:.4f} ms, bound "
                  f"{k['bound_ms']:.4f} ms ({k['bound_by']}), library "
                  f"{k['library_ms']}"
                  + (f", in turns {k['turns']}" if "turns" in k else "")
                  + "".join(f", {x} {k[x]:.4f}" for x in EXTRA_MS
                            if x in k)
                  + (f" at {k['rows_unpadded']} rows"
                     if "rows_unpadded" in k else ""))

    with Phase("phase 6: profile of one run of (a), (c) and (e)"):
        profile_runs(engine, {"a": qa, "c": qc, "e": qe})

    # -- 7. the service -------------------------------------------------------
    with Phase("phase 7: MatchService, coalesced ticks, cache, ingest into "
               "the window"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bank.filter = None                        # the planner's choice
        svc_best = [(queries_c[q], int(rows[2 + q]), int(locs[2 + q]),
                     READ - int(n_mism[q])) for q in range(SVC_BEST)]
        svc_thr = [(reads_c[q], int(rows[2 + q]), int(locs[2 + q]))
                   for q in range(SVC_BEST, SVC_BEST + SVC_THR)]
        service = service_phase(
            engine, bank, best=svc_best, thr=svc_thr,
            iupac=(iupac, int(rows[1]), int(locs[1])), batches=batches,
            bank_hits=[t.hits for t in tickets[False]],
            evicted_read=ref[:READ].copy(), n_compactions=1,
            zero_counts=zero_counts, read_counts=read_counts,
            sync=torch.cuda.synchronize)
        service["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(f"  peak device memory over the phase "
              f"{service['peak_bytes'] / 2**30:.3f} GiB; card: {smi}")
        print("service " + json.dumps(service))

    # -- 8. calibration ------------------------------------------------------
    with Phase("phase 8: calibration"):
        calibration = calibration_phase(
            engine, bank, {"a": qa, "b": qb, "c": qc, "d": qd, "c2": qc2,
                           "e": qe, "f": qf},
            zero_counts=zero_counts, read_counts=read_counts,
            sync=torch.cuda.synchronize)
        print(f"  card: {smi}")
        print("calibration " + json.dumps(calibration))

    # -- 9. the CRAM-PM functional model ----------------------------------
    with Phase("phase 9: CRAM-PM functional model"):
        cram_rows, cram_launches, cram_info = cram_phase(
            frags_chr1, read_a, (int(rows[0]), int(locs[0])),
            zero_counts=zero_counts, read_counts=read_counts,
            sync=torch.cuda.synchronize)
        kernels.extend(cram_rows)
        print("cram " + json.dumps(cram_info))

    # -- 10. LM serving -------------------------------------------------------
    with Phase("phase 10: LM serving at full width: llama3.2-1b, "
               "olmoe-1b-7b, recurrentgemma-9b, mamba2-130m, whisper-tiny, "
               "pixtral-12b"):
        from repro_torch.configs import get_config
        serve = dict(optimized=True, kind="serve")
        lm_launches, lm_info = lm_phase(
            [("l1", get_config(LM_ARCH)),
             ("l2", get_config(LM_ARCH, **serve)),
             ("m", get_config(LM_MOE_ARCH, **serve)),
             ("r", get_config(LM_HYBRID_ARCH, **serve)),
             ("s", get_config(LM_SSD_ARCH)),
             ("w", get_config(LM_ENCDEC_ARCH)),
             ("p", get_config(LM_EMBEDS_ARCH, **serve))],
            zero_counts=zero_counts, read_counts=read_counts,
            sync=torch.cuda.synchronize)
        print("lm " + json.dumps(lm_info))

    # -- 11. LM training ------------------------------------------------------
    with Phase("phase 11: LM training at full width: llama3.2-1b through "
               "the train launcher, the other families, card against CPU, "
               "checkpoint and resume"):
        train_info = train_phase(sync=torch.cuda.synchronize)
        print("train " + json.dumps(train_info))

    # -- 12. row shards -------------------------------------------------------
    with Phase(f"phase 12: row-sharded main path, {SHARDS} and {SHARDS_2} "
               "shards on one card"):
        sharded = {}
        shard_info = shard_phase(
            frags_chr1, queries, results,
            zero_counts=zero_counts, read_counts=read_counts,
            sync=torch.cuda.synchronize, keep=sharded)
        print("shard " + json.dumps(shard_info))
    shard_launches = {}
    for info in shard_info["queries"].values():
        for name, n in info["launches"].items():
            shard_launches[name] = shard_launches.get(name, 0) + n

    # -- 13. row shards across processes --------------------------------------
    with Phase(f"phase 13: row shards across processes, {PROCS} ranks of "
               f"{SHARDS // PROCS} shards"):
        procs_info = procs_phase(frags_chr1, queries, sharded,
                                 shard_info)
        del sharded
        print("procs " + json.dumps(procs_info))

    # -- 14. the LM's sharding ------------------------------------------------
    with Phase(f"phase 14: the LM's sharding on the card: {LM_ARCH} on a "
               f"{MESH_DATA}x{MESH_MODEL} (data, model) mesh, both rule "
               "profiles, restore onto the mesh"):
        sharding_info = lm_sharding_phase()
        print("lm_sharding " + json.dumps(sharding_info))

    # -- 15. summary ---------------------------------------------------------
    # Each kernel's launches come from its own path's run; match_swar's
    # path is (e)-(f)'s verify and phase 10's speculators.  Phases 12 and
    # 13's launches of the same kernels on the sharded paths stand beside
    # them.
    path_launches = dict(launches)
    path_launches["match_mxu"] = launches_c2["match_mxu"]
    path_launches["match_swar"] = launches_ef["match_swar"] + lm_launches
    path_launches["filter_qgram"] = launches_ef["filter_qgram"]
    path_launches["bank_prefilter"] = launches_bank["bank_prefilter"]
    path_launches["popcount"] = launches_bulk["popcount"]
    path_launches["bitwise"] = launches_bulk["bitwise"]
    path_launches.update(cram_launches)
    rows_out = []
    for k in kernels:
        src, replaces = SOURCES[k["name"]]
        n = path_launches[k["name"]]
        check(n > 0, f"{k['name']} launched on its path")
        rows_out.append({
            "name": k["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": n,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "event_ms": k["event_ms"], "turns_ms": k.get("turns"),
            "shape_rows": k["rows"], "n_launches": n,
            "matches_plain": k["max_abs_err"] == 0,
            "launches_sharded": shard_launches.get(k["name"], 0),
            "launches_procs": procs_info["launches"].get(k["name"], 0),
            **{x: k[x] for x in EXTRA_MS + ("rows_unpadded",) if x in k}})
    check(len(rows_out) == len(SOURCES), "every kernel measured")
    print("kernels " + json.dumps([
        {"name": r["name"], "n_launches": r["n_launches"],
         "matches_plain": r["matches_plain"]} for r in rows_out]))
    print(json.dumps({"kernels": rows_out}))
    print(f"chip_smoke: total {time.perf_counter() - t_script:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--procs-worker"]:
        sys.exit(procs_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--dryrun-worker"]:
        sys.exit(dryrun_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
