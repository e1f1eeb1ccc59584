"""Architecture + shape configuration system (``--arch <id> --shape <name>``)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- attention flavour ---
    attn_pattern: str = "full"  # full | local_global
    window: int = 0  # sliding window for local layers
    global_every: int = 0  # e.g. 6 -> layers 5, 11, ... are global
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0  # gemma3 global layers; 0 -> use rope_theta
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | rmsnorm_zero | layernorm
    act: str = "silu_glu"  # silu_glu | gelu
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    post_norms: bool = False  # gemma3 post-block norms
    logit_softcap: float = 0.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_ff: int = 0  # per-expert hidden
    n_shared_experts: int = 0
    shared_ff: int = 0
    norm_topk: bool = False
    capacity_factor: float = 1.25
    # sharding constraint axes for the [E, C, d] dispatch/combine tensors
    # (capacity dim). None = let GSPMD choose (CPU tests / single device).
    moe_dispatch_axes: tuple | None = None
    moe_scan_chunks: int = 0  # >0: scan tokens through MoE in chunks
    xlstm_gather_qkv: bool = False  # replicate conv output before q/k/v
    # --- SSM / hybrid / xlstm ---
    block_kind: str = "attn"  # attn | mamba_hybrid | xlstm
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    shared_attn_every: int = 0  # zamba2: shared attention block cadence
    mlstm_per_slstm: int = 0  # xlstm group layout, e.g. 7
    proj_factor: float = 2.0  # xlstm up-projection
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # precomputed frame embeddings (frontend stub)
    cross_attention: bool = False
    # --- tensor parallelism (set by distributed/tp.py local configs) ---
    # Mesh axis the forward pass reduces partial results over.  Empty =
    # single-device semantics (no collectives anywhere in the model).
    tp_axis: str = ""
    # Which components this *local* config holds a 1/tp shard of:
    # subset of {"heads", "kv_heads", "mlp", "experts", "expert_ff",
    # "shared_ff"}.  Drives where the model inserts all-gathers
    # (output-column-parallel wo / down projections, expert parallelism)
    # when running inside a shard_map body.  All collectives are pure
    # data movement, so sharded results are bit-identical to unsharded.
    tp_shards: Tuple[str, ...] = ()
    # --- numerics / tiling ---
    act_dtype: str = "bfloat16"  # activation dtype (norms/softmax in fp32)
    scan_chunk: int = 256  # SSD / mLSTM chunkwise block length
    decode_repeat_kv: bool = False  # legacy GQA decode (perf baseline only)
    # --- capabilities ---
    supports_long_context: bool = False  # run long_500k?
    max_seq: int = 32768  # rope table length; raised per shape when needed
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return int(self.ssm_expand * self.d_model)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) — long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "pure full-attention arch: 500k context assumes sub-quadratic "
            "attention/SSM (see README.md, Design notes)"
        )
    return True, ""


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        head_dim=16 if cfg.head_dim else 0,
        max_seq=256,
    )
    if cfg.block_kind == "mamba_hybrid":
        base.update(n_layers=4, shared_attn_every=2, ssm_headdim=16, ssm_state=16)
    if cfg.block_kind == "xlstm":
        base.update(n_layers=4, mlstm_per_slstm=3 if cfg.mlstm_per_slstm else 0)
    if cfg.n_experts:
        base.update(n_experts=8, top_k=min(cfg.top_k, 4), moe_ff=32,
                    shared_ff=64 if cfg.shared_ff else 0)
    if cfg.encoder_layers:
        base.update(encoder_layers=2, encoder_seq=32)
    if cfg.attn_pattern == "local_global":
        base.update(window=32, global_every=2)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **base)
