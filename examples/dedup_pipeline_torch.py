"""Training-data near-dup filtering with the CRAM-PM match engine, on the
PyTorch/CUDA port.

The paper's row-parallel string matcher doing production data-plane work:
documents are fingerprinted into the 2-bit alphabet and matched against a
device-resident store through the match engine; near-duplicates (including
shifted copies) are dropped before they reach the tokenizer.  Each add is
an in-place packed-row append into a growable corpus: capacity doubles on
device, the engine survives growth, and the resident rows are never
repacked -- the store ingests while it serves.

The twin of ``dedup_pipeline.py``: the same seeds, sizes, printed lines
and asserts, on ``repro_torch`` (the engine plans each probe as the
per-row best reduction, the ``match_swar_best`` kernel on the card);
``main(device="cpu")`` runs the plain versions on the CPU.

Run:  PYTHONPATH=src python examples/dedup_pipeline_torch.py
"""

import numpy as np

from repro_torch.data.dedup import CRAMDedup


def main(device=None) -> None:
    rng = np.random.default_rng(0)
    base_docs = [rng.bytes(300) for _ in range(20)]
    corpus = []
    for d in base_docs:
        corpus.append(d)
        if rng.random() < 0.5:
            corpus.append(d)                       # exact dup
        if rng.random() < 0.3:
            corpus.append(d[3:] + rng.bytes(3))    # shifted near-dup
        if rng.random() < 0.3:
            mutated = bytearray(d)
            for i in rng.integers(0, len(d), 4):
                mutated[i] ^= 0xFF
            corpus.append(bytes(mutated))          # lightly mutated dup
    rng.shuffle(corpus)

    dedup = CRAMDedup(threshold=0.85, device=device)
    engine_before = dedup.engine                   # held for the lifetime
    kept = dedup.filter(corpus)
    assert dedup.engine is engine_before           # growth never rebuilds it
    print(f"corpus {len(corpus)} docs -> kept {len(kept)} "
          f"({len(corpus) - len(kept)} near-dups dropped)")
    # every base doc survives; the large majority of injected dups drop
    assert len(base_docs) <= len(kept) <= len(base_docs) + 5
    print("store rows (one fingerprint per CRAM row):", len(dedup))
    print(f"engine store: capacity {dedup.capacity} rows, "
          f"{dedup.total_host_packs} full pack(s), "
          f"{dedup.total_row_writes} incremental row writes, "
          f"planner backend for queries: "
          f"{dedup.engine.plan(np.zeros(dedup.pattern_len, np.uint8)).backend}")


if __name__ == "__main__":
    main()
