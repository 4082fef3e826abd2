"""pixtral-12b [vlm]: Pixtral-ViT frontend (STUB) + Mistral-Nemo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072, head_dim=128.  The vision frontend is a stub:
``input_specs`` supplies precomputed patch/text embeddings (DESIGN.md
Arch-applicability).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072,
    rope_theta=1e6, act="silu", norm="rms",
    input_mode="embeddings",
    microbatch=4,
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, rope_theta=1e4, input_mode="embeddings",
    tp_pad=1, vocab_pad=1, remat=False, attn_block_q=32, attn_block_kv=32,
)
