"""whisper-tiny [audio]: encoder-decoder, conv frontend STUB.

[arXiv:2212.04356; unverified]  4L enc + 4L dec, d_model=384 6H (kv=6)
d_ff=1536 vocab=51865 (padded to 51872 for TP), head_dim=64, sinusoidal
positions (rope disabled), GELU, LayerNorm, QKV bias.  ``input_specs``
supplies precomputed mel-frame embeddings (1500 frames).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab=51_865,
    n_enc_layers=4, n_audio_frames=1500,
    rope_theta=0.0, act="gelu", norm="layer", qkv_bias=True,
    tie_embeddings=True,
    tp_pad=1,
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    n_enc_layers=2, n_audio_frames=32,
    rope_theta=0.0, act="gelu", norm="layer", qkv_bias=True,
    tie_embeddings=True,
    tp_pad=1, vocab_pad=1, remat=False, attn_block_q=32, attn_block_kv=32,
)
