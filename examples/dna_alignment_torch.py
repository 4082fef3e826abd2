"""End-to-end DNA sequence alignment on the PyTorch/CUDA port (the paper's
running case study).

Builds a synthetic genome slice, folds it across rows into a device-
resident packed corpus (Fig. 3), then exercises the declarative query IR
two ways:

* a **primer scan**: an N-wildcard primer (degenerate positions encoded as
  IUPAC accept masks) is compiled *once* (``MatchEngine.compile``) and the
  resulting ``CompiledMatch`` re-run against successive corpus
  generations (the ``match_swar_masks`` kernel on the card);
* **read alignment** with Oracular k-mer scheduling, where reads carry
  sequencing no-calls (``N`` positions that must match anything) on top of
  SNPs, so every pass is an accept-mask ``MatchQuery`` streamed through
  the engine (per-row SWAR ``best``).

Finally the paper-scale run is projected with the calibrated cost model
(Fig. 5 numbers).  The twin of ``dna_alignment.py``: the same seeds,
sizes, printed lines and asserts, on ``repro_torch``; ``main(device=
"cpu")`` runs the plain versions on the CPU.

Run:  PYTHONPATH=src python examples/dna_alignment_torch.py
"""

import time

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core import encoding
from repro_torch.core.scheduler import schedule_oracular
from repro_torch.core.tech import LONG_TERM, NEAR_TERM
from repro_torch.device import resolve_device
from repro_torch.match import MatchEngine, MatchQuery, PackedCorpus


def main(device=None) -> None:
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    genome = encoding.random_dna(rng, 200_000)
    frag_len, pat_len = 1000, 100
    corpus = PackedCorpus.from_reference(genome, frag_len, pat_len,
                                         device=dev)
    engine = MatchEngine(corpus)
    frags = corpus.fragments
    print(f"reference {len(genome)} chars folded into {frags.shape[0]} rows "
          f"of {frag_len} (overlap {pat_len - 1})")

    # -- 1. compiled N-wildcard primer scan -----------------------------------
    # A 24-mer primer whose four degenerate positions are written as IUPAC
    # codes: N matches anything, R = A|G.  Compile once, reuse every scan.
    site = 31_337
    primer_codes = genome[site:site + 24].copy()
    primer = encoding.decode_dna(primer_codes)
    primer = primer[:6] + "N" + primer[7:12] + "RN" + primer[14:22] + "NN"
    query = MatchQuery.iupac(primer, reduction="threshold", threshold=24)
    scan = engine.compile(query)                   # plan + pack, once
    hits = scan().hits
    step = frag_len - (pat_len - 1)
    glob = [int(r * step + loc) for r, loc, _ in hits]
    print(f"primer {primer} compiled once ({scan.plan.backend}/"
          f"{scan.plan.predicate}); full-score sites at {glob} "
          f"(planted at {site})")
    # A corpus row write bumps the generation; the same CompiledMatch
    # serves the new contents -- no re-plan, no re-pack.
    row = site // step
    orig = frags[row].copy()                       # set_rows mutates frags
    edited = orig.copy()
    edited[site - row * step] ^= 1                 # break the primer site
    corpus.set_rows(row, edited)
    print(f"after a row write (generation {corpus.generation}): "
          f"{scan().hits.shape[0]} full-score sites, "
          f"{corpus.host_pack_count} host pack event(s)")
    corpus.set_rows(row, orig)                     # restore

    # -- 2. read alignment with no-calls --------------------------------------
    # Reads get 2 SNPs (real mismatches) plus 3 sequencing no-calls that
    # must not count against the alignment: the no-call positions become
    # full-wildcard accept masks (the predicate API), so a perfect
    # placement scores pat_len minus the SNPs only.
    n_reads = 64
    starts = rng.integers(0, len(genome) - pat_len, n_reads)
    reads = np.stack([genome[s:s + pat_len].copy() for s in starts])
    read_masks = (np.uint8(1) << reads).astype(np.uint8)
    for r in range(n_reads):
        snps = rng.integers(0, pat_len, 2)
        reads[r, snps] = rng.integers(0, 4, 2)
        read_masks[r, snps] = (np.uint8(1) << reads[r, snps])
        nocalls = rng.integers(0, pat_len, 3)
        read_masks[r, nocalls] = 0b1111            # N: matches anything

    sched = schedule_oracular(frags, reads, k=12)
    print(f"oracular schedule: {sched.n_passes} passes, "
          f"avg {sched.replication:.1f} candidate rows/read (naive: "
          f"{n_reads} passes x all rows)")

    # Every pass streams only its candidate rows (the Oracular assignment)
    # through the same resident corpus -- a device gather from the packed
    # forms, so the corpus packs on the first pass and is reused untouched
    # afterwards.
    t0 = time.perf_counter()
    recovered = 0
    for assign in sched.passes:
        rows = sorted(assign)
        masks = read_masks[[assign[r] for r in rows]]
        res = engine.match(MatchQuery.from_masks(
            masks, mode="per_row", rows=rows, backend="swar",
            reduction="best"))
        for i, row in enumerate(rows):
            if res.best_scores[i] >= pat_len - 2:     # allow the 2 SNPs
                glob = row * step + res.best_locs[i]
                if abs(int(glob) - int(starts[assign[row]])) == 0:
                    recovered += 1
    dt = time.perf_counter() - t0
    print(f"recovered {recovered}/{n_reads} exact alignments in {dt:.2f}s "
          f"(on {dev.type}; {len(sched.passes)} engine passes, "
          f"{corpus.host_pack_count} corpus pack event(s))")

    print("\npaper-scale projection (3G reference, 3M reads, 300 arrays):")
    for tech in (NEAR_TERM, LONG_TERM):
        for opt in (False, True):
            d = cm.Design(tech=tech, opt=opt)
            r = cm.run_workload(d, 3_000_000, "oracular")
            print(f"  {tech.name:9s} {'Opt' if opt else '   '} "
                  f"{r.total_time_s/3600:10.2f} h  "
                  f"{r.match_rate:12.4g} reads/s  "
                  f"{r.efficiency:8.3g} reads/s/mW")


if __name__ == "__main__":
    main()
