"""stablelm-3b [dense]: full-head GQA (kv=32), LayerNorm.

[hf:stabilityai/stablelm-2-1_6b; unverified]  32L d_model=2560 32H (kv=32)
d_ff=6912 vocab=50304, head_dim=80, LayerNorm + GELU MLP.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50_304,
    rope_theta=1e4, act="gelu", norm="layer",
)

SMOKE = ModelConfig(
    name="stablelm-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    rope_theta=1e4, act="gelu", norm="layer",
    tp_pad=1, vocab_pad=1, remat=False, attn_block_q=32, attn_block_kv=32,
)
