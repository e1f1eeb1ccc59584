"""chameleon-34b [vlm] — early-fusion VQ image tokens in a 65536 vocab
(frontend stub: image patches arrive pre-quantized as token ids), qk-norm.
[arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    rope_theta=1e4,
    source="arXiv:2405.09818; unverified",
)
