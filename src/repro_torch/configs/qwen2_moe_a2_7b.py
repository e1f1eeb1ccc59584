"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared-expert mlp,
per-expert d_ff=1408. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,            # per assigned table (= per-expert hidden)
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    n_experts=60,
    top_k=4,
    moe_ff=1408,
    n_shared_experts=4,
    shared_ff=5632,       # 4 shared experts fused: 4*1408
    norm_topk=True,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
