"""moonshot-v1-16b-a3b [moe]: Moonlight-style 64-expert top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (kv=16)
expert d_ff=1408 vocab=163840, MoE 64e top-6, head_dim=128.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab=163_840,
    block_pattern=("moe",),
    n_experts=64, top_k=6, moe_d_ff=1408, capacity_factor=1.25,
    moe_group_size=256,
    rope_theta=1e6, act="silu", norm="rms",
    microbatch=4,
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab=256,
    block_pattern=("moe",),
    n_experts=8, top_k=2, moe_d_ff=32, moe_group_size=32,
    capacity_factor=4.0,   # E/top_k: no token drops -> exact equivalences
    rope_theta=1e4,
    tp_pad=1, vocab_pad=1, remat=False, attn_block_q=32, attn_block_kv=32,
)
