"""internlm2-20b [dense]: GQA kv=8.

[arXiv:2403.17297; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544, head_dim=128.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92_544,
    rope_theta=1e6, act="silu", norm="rms",
    microbatch=4,
)

SMOKE = ModelConfig(
    name="internlm2-20b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    rope_theta=1e4,
    tp_pad=1, vocab_pad=1, remat=False, attn_block_q=32, attn_block_kv=32,
)
