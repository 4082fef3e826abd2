#!/usr/bin/env python3
"""Drive the PyTorch port's match path on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA device, the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``.  Phases, each
printing its wall time:

1. Environment: torch / CUDA versions, the card's name and power limit.
2. Build: both CUDA sources with nvcc, in parallel; the ``-Xptxas -v``
   resource summary.
3. Kernels against their plain versions at edge shapes, bit for bit.
4. Main path at the size of GRCh38 chr1 (248,956,422 bp, seeded random
   DNA of that length folded into 500-char rows for 100-char reads):
   ``MatchEngine`` -> ``compile(MatchQuery)`` -> ``run()`` for
   (a) an exact read, best, SWAR; (b) an IUPAC read, threshold 95, SWAR
   accept-set; (c) 128 batched reads with 0-3 mismatches, top-10, tensor
   cores; (d) read (a) with the planner's own choice.  Launch counters
   are zeroed just before and read just after; (a) and (b) are held
   against the ``ref`` backend on the full corpus.
5. Kernels at the main path's shapes: each kernel against its plain
   version on >= 65,536 rows of the resident forms (its main-path
   launch shape or more) with the compiled queries' own operands, bit
   for bit; kernel, plain-version and library-call times (CUDA events)
   at the launch shape beside the roofline bound.
6. Profile: one run each of (a) and (c) under ``torch.profiler``
   (device time by kernel, device busy share) and one under the
   engine's own span tracer (host stage breakdown).
7. Summary: a ``kernels`` line, the ``{"kernels": [...]}`` JSON line, the
   card's name and power limit, and ``{"ok": true, "device": {...}}``
   as the last line.

Any mismatch raises and the script exits non-zero; no phase catches a
failure.
"""

from __future__ import annotations

import dataclasses
import json
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
SUBSET_ROWS = 65_536         # rows held kernel-against-plain in phase 5
TIMED_RUNS = 3
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
# SWAR kernels' SASS issues them (cuobjdump of the sm_90a build): exact =
# funnel shift, xor, shift, fold-and-mask (LOP3); accept-set = 3 shifts,
# 8 LOP3.  Each word also takes one popcount, and one add that the
# compiler issues on the FMA pipe (IMAD), not counted.
SWAR_INT_OPS_PER_WORD = {"match_swar": 4, "match_swar_masks": 11}
SOURCES = {
    "match_swar": ("src/repro_torch/kernels/csrc/match_swar.cu",
                   "src/repro/kernels/match_swar.py:82"),
    "match_swar_masks": ("src/repro_torch/kernels/csrc/match_swar.cu",
                         "src/repro/kernels/match_swar.py:146"),
    "match_mxu": ("src/repro_torch/kernels/csrc/match_mxu.cu",
                  "src/repro/kernels/match_mxu.py:54"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)
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
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            if us > 0:
                by_kernel[ev.key] = (us / 1e3, ev.count)
        dev_ms = sum(ms for ms, _ in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
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


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on an "
              "NVIDIA card", file=sys.stderr)
        return 2

    from repro_torch.convert import swar_words_from_numpy
    from repro_torch.core import encoding
    from repro_torch.kernels import _build
    from repro_torch.kernels import match_mxu as kmx
    from repro_torch.kernels import match_swar as ksw
    from repro_torch.match import MatchEngine, MatchQuery, PackedCorpus
    from repro_torch.match.corpus import one_hot_flat
    from repro_torch.match.engine import _valid_mask

    dev = torch.device("cuda")
    wrappers = {"match_swar": ksw.match_swar,
                "match_swar_masks": ksw.match_swar_masks,
                "match_mxu": kmx.match_mxu}
    plains = {"match_swar": ksw.match_swar_plain,
              "match_swar_masks": ksw.match_swar_masks_plain,
              "match_mxu": kmx.match_mxu_plain}

    # -- 1. environment ---------------------------------------------------
    with Phase("phase 1: environment"):
        print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
              f"cuda {torch.version.cuda}  device "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"card: {smi}")

    # -- 2. build ---------------------------------------------------------
    with Phase("phase 2: build (nvcc, sm_90a)"):
        _build.build(["match_swar", "match_mxu"])
        for name in ("match_swar", "match_mxu"):
            for line in _build.build_log(name).splitlines():
                if "Used" in line or "spill" in line or "entry" in line:
                    print(f"  {name}: {line.strip()}")

    # -- 3. edge shapes -----------------------------------------------------
    def words(a):
        return swar_words_from_numpy(a, dev)

    with Phase("phase 3: kernels vs plain versions, edge shapes"):
        rng = np.random.default_rng(SEED)
        # sh == 0 only; P % 16 != 0; Wp 1-3; R exactly 8; P = 100; P > 256.
        for R, P, L in [(8, 16, 1), (8, 7, 40), (16, 23, 33), (8, 40, 17),
                        (24, 100, 50), (8, 300, 20), (64, 100, 401)]:
            wp = -(-P // 16)
            W = (L - 1) // 16 + wp + 2
            ref = words(rng.integers(0, 2**32, (R, W), dtype=np.uint32))
            val = words(_valid_mask(P, wp))
            for name, planes in (("match_swar", 1), ("match_swar_masks", 4)):
                pat = words(rng.integers(0, 2**32, (R, planes * wp),
                                         dtype=np.uint32))
                for p in (pat, pat[:1].expand(R, -1)):
                    got = wrappers[name](ref, p, val, n_locs=L,
                                         pattern_chars=P)
                    want = plains[name](ref, p, val, n_locs=L,
                                        pattern_chars=P)
                    check(torch.equal(got, want),
                          f"{name} R={R} P={P} L={L}")
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
        torch.cuda.synchronize()
        print("  all edge shapes bit-identical")

    # -- 4. main path at chr1 scale ----------------------------------------
    with Phase("phase 4: main path, chr1-sized reference"):
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        ref = encoding.random_dna(rng, CHR1_BP)
        corpus = PackedCorpus.from_reference(ref, FRAG, READ, device="cuda")
        engine = MatchEngine(corpus)
        n_rows = corpus.n_rows
        step = FRAG - READ + 1
        print(f"  reference {CHR1_BP} bp -> {n_rows} rows x {FRAG} chars "
              f"(set-up {time.perf_counter() - t0:.1f} s)")

        # Reads at known (row, loc): distinct rows, every read wholly
        # inside its row (loc <= FRAG - READ), so it occurs in that row
        # only.
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

        qa = MatchQuery.exact(read_a, reduction="best", backend="swar")
        qb = MatchQuery.iupac(iupac, reduction="threshold", threshold=95,
                              backend="swar")
        qc = MatchQuery.exact(queries_c, mode="batched", reduction="topk",
                              k=10, backend="mxu")
        qd = MatchQuery.exact(read_a, reduction="best")

        def drive(q):
            cm = engine.compile(q)
            cm.run()                                  # warm-up
            times = []
            for _ in range(TIMED_RUNS):
                t = time.perf_counter()
                res = cm.run()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            return res, times

        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.n_launches = 0
        results, timings = {}, {}
        for key, q in (("a", qa), ("b", qb), ("c", qc), ("d", qd)):
            results[key], timings[key] = drive(q)
        launches = {n: w.n_launches for n, w in wrappers.items()}
        peak_mem = torch.cuda.max_memory_allocated()
        print(f"  launches on the main path: {launches}")

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
        check(np.array_equal(rc.topk_rows[0], rows[2:2 + N_BATCH])
              and np.array_equal(rc.topk_scores[0], READ - n_mism),
              "(c) every query's top row is its planted row")
        print(f"  (d) planner chose {rd.plan.backend}: {rd.plan.reason}")
        check(np.array_equal(rd.best_scores, ra.best_scores),
              "(d) agrees with (a)")
        for name, n in launches.items():
            check(n > 0, f"{name} launched on the main path")

        main_path = {}
        for key, q in (("a", qa), ("b", qb), ("c", qc), ("d", qd)):
            res, ts = results[key], timings[key]
            best = min(ts)
            main_path[key] = {
                "backend": res.plan.backend, "predicate": res.plan.predicate,
                "reduction": q.reduction, "n_patterns": res.plan.n_patterns,
                "chunk_rows": res.plan.chunk_rows, "n_chunks": res.n_chunks,
                "ms": [t * 1e3 for t in ts], "best_ms": best * 1e3,
                "rows_per_s": n_rows / best,
                "row_patterns_per_s": n_rows * res.plan.n_patterns / best}
            print(f"  ({key}) {res.plan.backend}/{res.plan.predicate} "
                  f"{q.reduction}: runs {[round(t * 1e3, 3) for t in ts]} "
                  f"ms, {n_rows / best:.4g} rows/s, "
                  f"{res.n_chunks} chunks of {res.plan.chunk_rows}")
        print(f"  peak device memory {peak_mem / 2**30:.3f} GiB")

        # (a) and (b) against the ref backend on the full corpus.
        for key, q in (("a", qa), ("b", qb)):
            qr = dataclasses.replace(q, backend="ref")
            t = time.perf_counter()
            rr = engine.compile(qr).run()
            torch.cuda.synchronize()
            main_path[key]["ref_ms"] = (time.perf_counter() - t) * 1e3
            res = results[key]
            check(np.array_equal(rr.best_locs, res.best_locs)
                  and np.array_equal(rr.best_scores, res.best_scores),
                  f"({key}) best arrays equal the ref backend's")
            if q.reduction == "threshold":
                check(np.array_equal(rr.hits, res.hits),
                      f"({key}) hits equal the ref backend's")
        print(f"  (a), (b) identical to the ref backend on all {n_rows} "
              "rows")
        print("main_path " + json.dumps(main_path))

    # -- 5. kernels at the main path's shapes -------------------------------
    with Phase("phase 5: kernels at the main path's shapes"):
        kernels = []
        for name, key in (("match_swar", "a"), ("match_swar_masks", "b")):
            cm = engine.compile(qa if key == "a" else qb)
            plan = cm.plan
            base = corpus.swar_words(plan.need_words)
            pat_rows, val = cm._packed
            kern, plain = wrappers[name], plains[name]

            def args(r):
                return (base[:r], pat_rows[:1].expand(r, -1), val)
            kw = dict(n_locs=plan.n_locs, pattern_chars=plan.pattern_chars)
            n_cmp = max(plan.chunk_rows, SUBSET_ROWS)
            got = kern(*args(n_cmp), **kw)
            want = plain(*args(n_cmp), **kw)
            err = int((got - want).abs().max())
            check(err == 0, f"{name} equals its plain version on {n_cmp} "
                  "rows")
            R = plan.chunk_rows           # the main path's launch shape
            a = args(R)
            ms = cuda_ms(lambda: kern(*a, **kw), 20)
            plain_ms = cuda_ms(lambda: plain(*a, **kw), 2)
            W = base.shape[1]
            n_planes = pat_rows.shape[1]
            words = R * plan.n_locs * plan.wp
            nbytes = (R * W * 4 + n_planes * 4 + plan.wp * 4
                      + R * plan.n_locs * 4)
            t_ops = max(words * SWAR_INT_OPS_PER_WORD[name] / PEAK_INT32,
                        words / PEAK_POPC)
            t_bytes = nbytes / HBM_BW
            kernels.append(dict(
                name=name, rows=R, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, max_abs_err=err))

        cm = engine.compile(qc)
        plan = cm.plan
        base = corpus.onehot_flat(plan.f_chars)
        pat = cm._packed
        R = plan.chunk_rows
        err = 0
        for r0 in range(0, SUBSET_ROWS, R):
            rows_ = base[r0:min(r0 + R, SUBSET_ROWS)]
            got = torch.round(kmx.match_mxu(rows_, pat, l_pad=plan.l_pad))
            want = torch.round(kmx.match_mxu_plain(rows_, pat,
                                                   l_pad=plan.l_pad))
            err = max(err, int((got - want).abs().max()))
        check(err == 0, f"match_mxu equals its plain version on "
              f"{SUBSET_ROWS} rows")
        chunk = base[:R]
        ms = cuda_ms(lambda: kmx.match_mxu(chunk, pat, l_pad=plan.l_pad), 10)
        plain_ms = cuda_ms(
            lambda: kmx.match_mxu_plain(chunk, pat, l_pad=plan.l_pad), 2)
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
        library_ms = cuda_ms(lambda: torch.nn.functional.conv1d(x, w), 10)
        F4, P4, Q = chunk.shape[1], pat.shape[0], pat.shape[1]
        flops = R * plan.l_pad * P4 * 2 * Q
        nbytes = R * F4 * 2 + P4 * Q * 2 + R * plan.l_pad * Q * 4
        t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BW
        kernels.append(dict(
            name="match_mxu", rows=R, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=library_ms, max_abs_err=err))
        for k in kernels:
            print(f"  {k['name']}: {k['rows']} rows, kernel {k['ms']:.4f} ms,"
                  f" plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} "
                  f"ms ({k['bound_by']}), library {k['library_ms']}")

    with Phase("phase 6: profile of one run of (a) and (c)"):
        profile_runs(engine, {"a": qa, "c": qc})

    # -- 7. summary ---------------------------------------------------------
    rows_out = []
    for k in kernels:
        src, replaces = SOURCES[k["name"]]
        rows_out.append({
            "name": k["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[k["name"]],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "shape_rows": k["rows"], "n_launches": launches[k["name"]],
            "matches_plain": k["max_abs_err"] == 0})
    print("kernels " + json.dumps([
        {"name": r["name"], "n_launches": r["n_launches"],
         "matches_plain": r["matches_plain"]} for r in rows_out]))
    print(json.dumps({"kernels": rows_out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
