"""Serving example on the PyTorch/CUDA port: continuous-batching engine +
CRAM-PM n-gram speculator.

Boots a reduced model, serves a wave of requests through slot-based
batched decode, then demonstrates the paper's matcher as a prompt-cache /
n-gram speculative proposer over the generated streams (each ``propose``
launches the ``match_swar`` kernel on the card).

The twin of ``serve_lm.py``: the same seeds, sizes, printed lines and
asserts, on ``repro_torch``.  The parameters come from the port's own
seeded ``init_params`` (``params=`` takes another tree, such as the
reference's carried across with ``convert.params_from_numpy``);
``main(device="cpu")`` runs on the CPU.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py
"""

import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.serving.engine import Engine, Request, generate_greedy
from repro_torch.serving.ngram_cache import NgramSpeculator, verify


def main(device=None, params=None) -> None:
    dev = resolve_device(device)
    cfg = get_config("llama3.2-1b", smoke=True)
    if params is None:
        params = model.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)

    print("== batched greedy generation ==")
    prompts = rng.integers(0, cfg.vocab, (4, 8), dtype=np.int32)
    t0 = time.perf_counter()
    out = generate_greedy(cfg, params, prompts, max_new=24, max_seq=64)
    dt = time.perf_counter() - t0
    print(f"generated {out.size} tokens in {dt:.2f}s "
          f"({out.size/dt:.0f} tok/s); first row: {out[0][:10].tolist()}...")

    print("\n== continuous-batching engine ==")
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, 6, dtype=np.int32),
                    max_new=16) for _ in range(6)]
    eng = Engine(cfg, params, max_seq=64, n_slots=3)
    t0 = time.perf_counter()
    eng.run(list(reqs))
    dt = time.perf_counter() - t0
    done = sum(len(r.out) for r in reqs)
    print(f"6 requests through 3 slots: {done} tokens in {dt:.2f}s")

    print("\n== n-gram speculation over generated history ==")
    spec = NgramSpeculator(suffix_tokens=4, device=params.device)
    for r in reqs:
        spec.feed(r.out)
    hits = total = 0
    for r in reqs:
        for t in range(4, len(r.out) - 4, 4):
            prop, conf = spec.propose(r.out[t - 4:t], k=4)
            if conf == 1.0:
                hits += verify(prop, np.asarray(r.out[t:t + 4]))
                total += 4
    if total:
        print(f"speculative acceptance on replayed streams: {hits}/{total} "
              f"({hits/total:.0%})")


if __name__ == "__main__":
    main()
