"""olmoe-1b-7b [moe]: 64 experts top-8.

[arXiv:2409.02060; hf]  16L d_model=2048 16H (kv=16) expert d_ff=1024
vocab=50304, MoE 64e top-8, head_dim=128.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab=50_304,
    block_pattern=("moe",),
    n_experts=64, top_k=8, moe_d_ff=1024, capacity_factor=1.25,
    moe_group_size=256,
    rope_theta=1e4, act="silu", norm="rms",
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab=256,
    block_pattern=("moe",),
    n_experts=8, top_k=2, moe_d_ff=32, moe_group_size=32,
    capacity_factor=4.0,   # E/top_k: no token drops -> exact equivalences
    rope_theta=1e4,
    tp_pad=1, vocab_pad=1, remat=False, attn_block_q=32, attn_block_kv=32,
)
