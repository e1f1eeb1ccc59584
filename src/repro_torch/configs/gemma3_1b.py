"""gemma3-1b [dense] — 5:1 local:global sliding attention, 262k vocab.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    attn_pattern="local_global",
    window=512,
    global_every=6,          # layers 5, 11, 17, 23 are global
    qk_norm=True,
    rope_theta=1e4,          # local layers
    rope_theta_global=1e6,   # global layers
    tie_embeddings=True,
    norm="rmsnorm_zero",
    act="gelu_glu",
    embed_scale=True,
    post_norms=True,
    supports_long_context=True,  # sliding window bounds KV for 5/6 layers
    source="hf:google/gemma-3-1b-pt; unverified",
)
