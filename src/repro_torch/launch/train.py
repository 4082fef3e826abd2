"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [...]``.

Runs the end-to-end loop (``SyntheticLM`` data -> train step ->
checkpoint) on the card, or on the CPU with ``--device cpu`` (with
``--smoke``, the reduced config).  The flags are the reference's
(``repro.launch.train``) plus ``--device``, and it prints the
reference's ``done: ...`` line.  ``main`` returns the ``TrainResult``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim import adamw
from repro_torch.runtime import loop


def main(argv: Optional[Sequence[str]] = None) -> loop.TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = adamw.OptConfig(peak_lr=args.lr, warmup_steps=20,
                              decay_steps=max(args.steps, 100))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    res = loop.train(cfg, opt_cfg, data, args.steps, ckpt=ckpt,
                     ckpt_every=args.ckpt_every, device=args.device)
    median = sorted(res.step_times)[len(res.step_times) // 2]
    print(f"done: {res.final_step} steps, "
          f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}, "
          f"median step {median * 1e3:.1f} ms, "
          f"stragglers {len(res.straggler_events)}")
    return res


if __name__ == "__main__":
    main()
