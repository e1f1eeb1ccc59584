"""granite-moe-1b-a400m [moe] — 32 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    rope_theta=1e4,
    tie_embeddings=True,
    n_experts=32,
    top_k=8,
    moe_ff=512,
    norm_topk=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
