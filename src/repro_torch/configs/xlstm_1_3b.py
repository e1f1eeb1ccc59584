"""xlstm-1.3b [ssm] — 48 blocks, mLSTM (matrix memory, chunkwise-parallel)
: sLSTM (recurrent) at 7:1, d_ff=0 (gated projections inside blocks).
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_kind="xlstm",
    mlstm_per_slstm=7,    # 6 groups of (7 mLSTM + 1 sLSTM)
    proj_factor=2.0,
    conv_width=4,
    supports_long_context=True,
    source="arXiv:2405.04517; unverified",
)
