"""qwen1.5-32b [dense]: MHA with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]  64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064, head_dim=128, QKV bias.  40 heads pad to 48 for TP=16
(Megatron-style head padding; DESIGN.md sharding map).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=27392, vocab=152_064,
    qkv_bias=True, rope_theta=1e6, act="silu", norm="rms",
    microbatch=4,
)

SMOKE = ModelConfig(
    name="qwen1.5-32b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    qkv_bias=True, rope_theta=1e4,
    tp_pad=1, vocab_pad=1, remat=False, attn_block_q=32, attn_block_kv=32,
)
