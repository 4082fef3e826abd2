"""mamba2-130m [ssm]: SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  24L d_model=768 d_ff=0 vocab=50280,
ssm_state=128, expand=2, head_dim=64 (24 SSD heads).  tp_pad=1: the inner
width (1536) shards 16-way on the model axis; tiny per-head vectors
replicate.  Sub-quadratic -> runs long_500k.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, head_dim=32,
    d_ff=0, vocab=50_280,
    block_pattern=("ssd",),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True,
    tp_pad=1,
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab=256,
    block_pattern=("ssd",),
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
    tie_embeddings=True,
    tp_pad=1, vocab_pad=1, remat=False,
)
