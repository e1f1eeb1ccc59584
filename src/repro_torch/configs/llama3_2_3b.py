"""llama3.2-3b [dense] — small llama3, GQA kv=8. [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=5e5,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)
