"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 pattern.

[arXiv:2402.19427; unverified]  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000.  Pattern (rglru, rglru, local_attn) x 12 + (rglru, rglru);
local window 2048; tied embeddings.  Sub-quadratic -> runs long_500k.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256_000,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048, rnn_width=4096,
    rope_theta=1e4, act="gelu", norm="rms", tie_embeddings=True,
    microbatch=4,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=16, rnn_width=64,
    rope_theta=1e4, act="gelu", tie_embeddings=True,
    tp_pad=1, vocab_pad=1, remat=False, attn_block_q=16, attn_block_kv=16,
)
