"""llama3.2-1b [dense]: small Llama-3 (GQA kv=8).

[hf:meta-llama/Llama-3.2-1B; unverified]  16L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=128256, head_dim=64, rope theta 500k, tied embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128_256,
    rope_theta=500_000.0, act="silu", norm="rms", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    rope_theta=1e4, tie_embeddings=True,
    tp_pad=1, vocab_pad=1, remat=False, attn_block_q=32, attn_block_kv=32,
)
