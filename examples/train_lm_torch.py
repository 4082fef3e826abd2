"""End-to-end training driver on the PyTorch/CUDA port: a ~100M-parameter
LM for a few hundred steps.

Exercises the full substrate: synthetic data pipeline -> microbatched
train_step (AdamW, clipping, schedule) -> watchdog -> atomic checkpoints ->
auto-resume, on one card (plain PyTorch ops, as the reference's are
``jnp``).  The twin of ``train_lm.py``: the same config, seeds, flags and
printed lines, on ``repro_torch``; the weights are seeded by the port's
generator, so the losses are not the reference's.  ``main(device="cpu")``
trains on the CPU.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 300
"""

import argparse
import os
import tempfile

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime import loop

# ~100M parameters: 10L x d640 x ff2560, tied 50k vocab.
CONFIG_100M = ModelConfig(
    name="repro-100m", family="dense",
    n_layers=10, d_model=640, n_heads=10, n_kv_heads=10, head_dim=64,
    d_ff=2560, vocab=50_304,
    rope_theta=1e4, tie_embeddings=True,
    tp_pad=1, vocab_pad=1, remat=False,
    attn_block_q=128, attn_block_kv=128,
)


def main(device=None, argv=None) -> loop.TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_100m_ckpt"))
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    cfg = CONFIG_100M
    n_params = cfg.n_params()
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params)")
    opt = adamw.OptConfig(peak_lr=6e-4, warmup_steps=30,
                          decay_steps=args.steps)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=1)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    res = loop.train(cfg, opt, data, args.steps, ckpt=ckpt, ckpt_every=100,
                     log_every=20, device=dev)
    first = sum(res.losses[:10]) / min(len(res.losses), 10)
    last = sum(res.losses[-10:]) / min(len(res.losses), 10)
    med = sorted(res.step_times)[len(res.step_times) // 2]
    tok_s = args.batch * args.seq / med
    print(f"\nloss {first:.3f} -> {last:.3f} over {res.final_step} steps")
    print(f"median step {med*1e3:.0f} ms ({tok_s:,.0f} tok/s on "
          f"{dev.type})")
    print(f"checkpoints: {ckpt.all_steps()}")
    return res


if __name__ == "__main__":
    main()
