"""whisper-large-v3 [audio] — encoder-decoder; conv/mel frontend is a STUB:
input_specs() provides precomputed 1280-d frame embeddings (1500 frames).
Assigned decoder seq lens are stress shapes beyond the 448-token production
max (documented in README.md, Design notes). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,            # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    encoder_layers=32,
    encoder_seq=1500,
    cross_attention=True,
    source="arXiv:2212.04356; unverified",
)
