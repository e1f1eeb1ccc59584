"""zamba2-2.7b [hybrid] — 54 Mamba2 layers + one shared GQA attention block
applied every 6 layers (weight reuse), ssm_state=64. [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,           # shared attention block MLP hidden
    vocab=32000,
    block_kind="mamba_hybrid",
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    conv_width=4,
    shared_attn_every=6,
    rope_theta=1e4,
    supports_long_context=True,
    source="arXiv:2411.15242; hf",
)
