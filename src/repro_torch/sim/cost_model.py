"""Analytic latency + quality response model (QUARANTINED SIMULATION GATE).

The real MIOBench records wall-clock latencies and answer correctness
measured on RTX5090 / RTX3090Ti / Jetson-Orin hardware running Qwen3-VL
{30B, 8B, 2B} under Ollama.  None of that hardware (or weights) exists in
this container, so this module replaces measurement with a roofline latency
model + a calibrated capability-difficulty response model:

  latency  = prefill(prompt_tok)      2*N_active*T / FLOPS_eff
           + decode(out_tok)          out_tok * bytes_active / MEM_BW_eff
           + transmission             payload / bandwidth + RTT
  out_tok  ~ CoT inflation: smaller capability & harder tasks => longer
             chains of thought (the paper's Sec. I observation)
  success  ~ Bernoulli(sigmoid(a * (capability - difficulty + affinity)))
  timeout  : latency > 60 s  =>  score -1 (counts as failure)

Constants are calibrated so Fig. 1 aggregates match the paper:
Jetson ~66.7% acc / ~26.3% timeouts; RTX5090 ~90% acc, 0 timeouts, <10 s.

A copy of ``repro/sim/cost_model.py`` (numpy only), so that the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    flops: float  # effective FLOP/s for prefill
    mem_bw: float  # effective B/s for decode
    net_bw: float  # B/s to the user (LAN for edge, WAN for cloud)
    rtt: float  # s
    hbm_bytes: float = 16e9  # accelerator memory (caps resident KV)
    # device-to-device interconnect B/s *within* a tensor-parallel group
    # (NVLink / ICI / PCIe) — what the per-layer all-gathers of sharded
    # serving ride on; irrelevant at tp=1
    ici_bw: float = 1e11


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    name: str
    n_active: float  # active params
    bytes_per_param: float  # quantization
    capability: float  # cognitive capability score
    # KV-cache geometry (n_layers, kv_heads, head_dim): rough dims of the
    # profiled checkpoints, enough for per-token KV byte rooflines
    kv_layout: "tuple[int, int, int]" = (28, 4, 128)
    # residual width — sizes the per-layer activation all-gathers of
    # tensor-parallel serving (tp_collective_s)
    d_model: float = 2048.0


DEVICES = {
    "jetson_orin_nano": DeviceProfile("jetson_orin_nano", 20e12, 48e9,
                                      12.5e6, 0.004, hbm_bytes=8e9,
                                      ici_bw=8e9),  # no NVLink: PCIe-class
    "rtx3090ti": DeviceProfile("rtx3090ti", 120e12, 800e9, 12.5e6, 0.004,
                               hbm_bytes=24e9, ici_bw=16e9),
    "rtx5090": DeviceProfile("rtx5090", 300e12, 1.5e12, 3e6, 0.030,
                             hbm_bytes=32e9, ici_bw=32e9),
    # TPU-native serving classes (hardware adaptation; README.md, Design notes)
    "tpu_v5e_1": DeviceProfile("tpu_v5e_1", 197e12, 819e9, 12.5e6, 0.004,
                               hbm_bytes=16e9, ici_bw=180e9),
    "tpu_v5e_4": DeviceProfile("tpu_v5e_4", 4 * 197e12, 4 * 819e9,
                               12.5e6, 0.004, hbm_bytes=4 * 16e9,
                               ici_bw=180e9),
    "tpu_v5e_pod": DeviceProfile("tpu_v5e_pod", 256 * 197e12, 256 * 819e9,
                                 3e6, 0.030, hbm_bytes=256 * 16e9,
                                 ici_bw=180e9),
}

MODELS = {
    "qwen3vl-2b": ModelProfile("qwen3vl-2b", 2e9, 1.0, 0.94,
                               kv_layout=(28, 2, 128), d_model=2048.0),
    "qwen3vl-8b": ModelProfile("qwen3vl-8b", 8e9, 1.0, 0.88,
                               kv_layout=(36, 4, 128), d_model=4096.0),
    "qwen3vl-30b": ModelProfile("qwen3vl-30b", 3e9, 2.0, 1.02,  # MoE A3B
                                kv_layout=(48, 4, 128), d_model=2048.0),
}

MODEL_IDS = list(MODELS)
DEVICE_IDS = list(DEVICES)

# calibration knobs
_QUALITY_SLOPE = 5.5
_COT_BASE = 90.0  # base answer tokens
_COT_SCALE = 2800.0  # extra CoT tokens at (difficulty - capability) = 1
_EFF = 0.35  # achieved fraction of peak

# per-modality raw uplink payloads (bytes).  text + image reproduce the
# historical single 300 KB constant, so every calibrated Fig. 1 aggregate
# is unchanged; audio ~ 15 s of 16 kHz 16-bit PCM.
PAYLOAD_BYTES = {"text": 2e3, "image": 298e3, "audio": 480e3}


def payload_bytes(modalities=("text", "image")) -> float:
    """Total raw uplink bytes for a request carrying ``modalities``."""
    return float(sum(PAYLOAD_BYTES[m] for m in modalities))


_PAYLOAD = payload_bytes()  # legacy default: text prompt + one image


def uplink_s(nbytes, device: DeviceProfile):
    """One-way user->server link delay for ``nbytes`` of payload.  The
    single link-delay formula shared by the analytic latency model and the
    live continuum harness (serving/cluster.EngineHandle) — previously
    each computed its own."""
    return np.asarray(nbytes, float) / device.net_bw + device.rtt / 2


def downlink_s(nbytes, device: DeviceProfile):
    """One-way server->user link delay (same roofline, response bytes)."""
    return uplink_s(nbytes, device)


# one streamed token chunk on the wire: a few bytes of token id plus the
# SSE/frame framing overhead every streaming protocol pays per event
STREAM_CHUNK_BYTES = 256.0


def stream_chunk_s(device: DeviceProfile,
                   nbytes: float = STREAM_CHUNK_BYTES):
    """Server->user link delay of ONE streamed token chunk.

    Streaming replaces the single end-of-request response transfer with a
    per-token trickle: each decoded token reaches the user
    ``stream_chunk_s`` after it was sampled, so TTFT is measured at the
    first *emitted* token + one chunk, not at drain + the full payload.
    Chunks pipeline (the link is not serialized per chunk at these
    sizes), so e2e pays this once — the last chunk's latency — rather
    than ``n_tokens`` times."""
    return downlink_s(nbytes, device)


_PREFILL_MIN_BUCKET = 16  # mirrors ServingEngine's min_bucket default

# ------------------------------------------------------- KV-cache roofline
#
# The bytes/token -> decode_s -> router-score chain: decode is memory-
# bandwidth-bound, and what streams through HBM every generated token is
# (a) the active weights and (b) the resident KV context.  Quantizing KV
# to int8 (ServingEngine kv_dtype="int8") halves (b) — kv_bytes_per_token
# drops ~2x — which lowers decode_s and, through EngineHandle's tick cost
# and backlog probe, the router's effective-latency score for that server;
# the same bytes/token figure divides the device's HBM budget, so it also
# sets how many sequences can be resident at once (kv_concurrency).  The
# per-element byte costs mirror repro_torch/serving/kv_cache.KV_DTYPE_BYTES.

KV_DTYPE_BYTES = {"bf16": 2.0, "int8": 1.0}
_KV_SCALE_BYTES = 4.0  # fp32 scale per (token, kv head) row, int8 only


def kv_bytes_per_token(model: ModelProfile, kv_dtype: str = "bf16") -> float:
    """HBM bytes one token's K+V occupy across all layers of ``model``."""
    L, hkv, dh = model.kv_layout
    per_head = dh * KV_DTYPE_BYTES[kv_dtype]
    if kv_dtype == "int8":
        per_head += _KV_SCALE_BYTES
    return 2.0 * L * hkv * per_head


def kv_migrate_bytes(model: ModelProfile, n_tokens,
                     kv_dtype: str = "bf16") -> float:
    """Bytes a KV snapshot of ``n_tokens`` context costs on the wire.

    Priced at the **destination** engine's ``kv_dtype``: the importer
    converts pages to its own pool precision on adoption
    (serving/engine._admit_imported), so an int8 edge tier receives ~half
    the bytes a bf16 tier would for the same context — the PR 5 byte
    saving extended to migration traffic."""
    return float(np.asarray(n_tokens, float)
                 * kv_bytes_per_token(model, kv_dtype))


def migrate_link_s(nbytes, src: DeviceProfile, dst: DeviceProfile):
    """Server->server transfer seconds for a KV snapshot: serialization
    on the narrower of the two links plus one half-RTT on each side."""
    bw = min(src.net_bw, dst.net_bw)
    return np.asarray(nbytes, float) / bw + (src.rtt + dst.rtt) / 2


def migrate_s(model: ModelProfile, n_tokens, src: DeviceProfile,
              dst: DeviceProfile, kv_dtype: str = "bf16"):
    """Seconds to move ``n_tokens`` of KV context from ``src`` to ``dst``
    at the destination's ``kv_dtype`` — the cost-model view of the live
    migration the continuum harness charges (serving/cluster.migrate)."""
    return migrate_link_s(kv_migrate_bytes(model, n_tokens, kv_dtype),
                          src, dst)


# ------------------------------------------------- tensor-parallel terms
#
# A tp-wide mesh (distributed/tp.py) divides the weight + KV bytes each
# token streams and the prefill FLOPs across the ``model`` axis, but pays
# ring all-gathers of the residual activations every layer.  The tp terms
# are guarded with an exact early return at tp<=1 so every calibrated
# single-device aggregate (Fig. 1/10/12/13/14) stays bitwise unchanged.

_TP_GATHERS_PER_LAYER = 2.0  # attention-out + mlp-down gather pairs


def tp_collective_s(device: DeviceProfile, model: ModelProfile, tokens,
                    tp: int) -> np.ndarray:
    """Seconds the per-layer activation all-gathers cost for ``tokens``
    token-positions at mesh width ``tp``: each gather pair moves
    ``2 * (tp-1)/tp`` of a bf16 ``d_model`` row per token over the
    device's ``ici_bw`` ring.  0 at ``tp <= 1`` (no collectives)."""
    if tp <= 1:
        return np.asarray(tokens, float) * 0.0
    L = model.kv_layout[0]
    bytes_per_tok = (_TP_GATHERS_PER_LAYER * L
                     * 2.0 * (tp - 1) / tp * model.d_model * 2.0)
    return np.asarray(tokens, float) * bytes_per_tok / device.ici_bw


def decode_s(device: DeviceProfile, model: ModelProfile, out_tokens,
             context_tokens=0.0, kv_dtype: str = "bf16",
             tp: int = 1) -> np.ndarray:
    """Decode roofline: every generated token streams the active weights
    plus the resident KV context (``context_tokens`` positions) through
    HBM.  ``context_tokens=0`` recovers the legacy weights-only decode
    term used by ``latency_s``'s calibrated aggregates.  ``tp > 1``
    divides the streamed bytes across the mesh and adds the per-layer
    collective term."""
    bytes_per_tok = (model.n_active * model.bytes_per_param
                     + kv_bytes_per_token(model, kv_dtype)
                     * np.asarray(context_tokens, float))
    base = np.asarray(out_tokens, float) * bytes_per_tok / (
        device.mem_bw * _EFF)
    if tp <= 1:
        return base
    return base / tp + tp_collective_s(device, model, out_tokens, tp)


def kv_concurrency(device: DeviceProfile, model: ModelProfile,
                   seq_len: int, kv_dtype: str = "bf16",
                   hbm_frac: float = 0.3) -> int:
    """Sequences of ``seq_len`` whose KV fits the device's cache budget
    (``hbm_frac`` of the HBM left after the resident weights) — the
    per-device concurrency cap int8 roughly doubles, which is what lets
    edge tiers admit more requests at the same memory.  0 when the
    weights alone do not fit the device."""
    free = device.hbm_bytes - model.n_active * model.bytes_per_param
    if free <= 0:
        return 0
    per_seq = seq_len * kv_bytes_per_token(model, kv_dtype)
    return int(hbm_frac * free / per_seq)


# ---------------------------------------------------- speculative decoding
#
# Speculative serving replaces one target decode step per token with
# ``k`` draft-model decode steps plus ONE multi-token verify pass of the
# target (kernels/paged_verify): the verify streams the target weights and
# the KV context once — like a single decode step — while scoring k+1
# positions, so its extra cost over plain decode is almost pure FLOPs.
# At acceptance rate ``a`` each tick emits 1..k+1 tokens (expected
# ``(1 - a^(k+1)) / (1 - a)``), which is what discounts the effective ITL.


def draft_s(device: DeviceProfile, draft_model: ModelProfile,
            tokens=1.0, context_tokens=0.0) -> np.ndarray:
    """Seconds the draft model spends proposing ``tokens`` tokens — plain
    decode roofline of the (small) draft profile; the draft cache is
    dense bf16 regardless of the target pool's precision."""
    return decode_s(device, draft_model, tokens,
                    context_tokens=context_tokens, kv_dtype="bf16")


def verify_s(device: DeviceProfile, model: ModelProfile, k,
             context_tokens=0.0, kv_dtype: str = "bf16",
             tp: int = 1) -> np.ndarray:
    """One multi-token verify pass scoring ``k`` positions: the active
    weights and the resident KV context stream through HBM **once**
    (the paged-verify kernel reads each page a single time for all query
    rows), plus ``2 * n_active * k`` FLOPs of batched scoring.  ``tp > 1``
    divides both across the mesh, plus one collective term for the pass
    (all k rows share each layer's gathers)."""
    weights = model.n_active * model.bytes_per_param
    kv = kv_bytes_per_token(model, kv_dtype) * np.asarray(
        context_tokens, float)
    mem = (weights + kv) / (device.mem_bw * _EFF)
    flop = 2.0 * model.n_active * np.asarray(k, float) / (
        device.flops * _EFF)
    if tp <= 1:
        return mem + flop
    return (mem + flop) / tp + tp_collective_s(device, model, k, tp)


def expected_accepted(k, acceptance) -> np.ndarray:
    """Expected tokens emitted per speculative tick with ``k`` drafts at
    per-token acceptance rate ``a``: the accepted prefix plus the
    target's correction/bonus token, ``1 + a + ... + a^k``."""
    a = np.clip(np.asarray(acceptance, float), 0.0, 0.9999)
    return (1.0 - a ** (np.asarray(k, float) + 1.0)) / (1.0 - a)


def speculative_tick_s(device: DeviceProfile, model: ModelProfile,
                       draft_model: ModelProfile, k, context_tokens=0.0,
                       kv_dtype: str = "bf16",
                       draft_device: DeviceProfile | None = None,
                       tp: int = 1):
    """Seconds one speculative tick costs: ``k`` draft decode steps (on
    ``draft_device`` — None = colocated with the target; the edge-drafts/
    cloud-verifies shape prices drafting on the edge device) plus one
    ``k+1``-position verify pass of the target.  ``tp`` shards only the
    target's verify — the draft model stays unsharded (distributed/tp.py
    leaves it replicated)."""
    dd = draft_device if draft_device is not None else device
    return (np.asarray(k, float)
            * draft_s(dd, draft_model, 1.0, context_tokens)
            + verify_s(device, model, np.asarray(k, float) + 1.0,
                       context_tokens, kv_dtype, tp=tp))


def speculative_itl_s(device: DeviceProfile, model: ModelProfile,
                      draft_model: ModelProfile, k, acceptance,
                      context_tokens=0.0, kv_dtype: str = "bf16",
                      draft_device: DeviceProfile | None = None):
    """Acceptance-discounted effective inter-token latency of speculative
    decoding: one tick's cost amortized over the expected emitted tokens.
    Below-breakeven acceptance makes this *worse* than plain decode —
    exactly the signal the router needs to fall back."""
    tick = speculative_tick_s(device, model, draft_model, k,
                              context_tokens, kv_dtype,
                              draft_device=draft_device)
    return tick / expected_accepted(k, acceptance)


def expected_out_tokens(model: ModelProfile, difficulty) -> np.ndarray:
    gap = np.maximum(0.15, 0.75 + difficulty - model.capability)
    return _COT_BASE + _COT_SCALE * gap ** 2


def bucketed_tokens(n, minimum: int = _PREFILL_MIN_BUCKET) -> np.ndarray:
    """Power-of-two shape bucket a prompt of ``n`` tokens is padded to by
    the serving engine's anti-recompile-storm prefill path."""
    n = np.maximum(np.asarray(n, float), 1.0)
    return np.maximum(2.0 ** np.ceil(np.log2(n)), float(minimum))


def chunked_prefill_tokens(prompt_tokens, prefill_chunk: int,
                           minimum: int = _PREFILL_MIN_BUCKET) -> np.ndarray:
    """Token positions the engine's bucketed + chunked prefill actually
    computes for a prompt: full ``prefill_chunk``-sized chunks plus the
    remainder padded up to its power-of-two bucket.  With chunking off
    (``prefill_chunk == 0``) the whole prompt is one bucket.  This is the
    term the router's latency estimates use so they track the real engine
    (ServingEngine ``prefill_chunk`` / ``bucket_prompts`` knobs).
    """
    t = np.asarray(prompt_tokens, float)
    if not prefill_chunk:
        return bucketed_tokens(t, minimum)
    full = np.floor(t / prefill_chunk) * prefill_chunk
    rem = t - full
    return full + np.where(rem > 0,
                           bucketed_tokens(np.maximum(rem, 1.0), minimum),
                           0.0)


def prefill_s(device: DeviceProfile, model: ModelProfile, prompt_tokens,
              prefill_chunk: int | None = None, tp: int = 1):
    """Prefill-only roofline term (the part a prefix-cache hit elides).

    ``prefill_chunk`` (None = legacy smooth model) switches to the serving
    engine's bucketed/chunked token count, whose padding makes prefill a
    step function of prompt length rather than a straight line.  ``tp > 1``
    divides the FLOPs across the mesh plus the per-position collectives.
    """
    tokens = (np.asarray(prompt_tokens)
              if prefill_chunk is None
              else chunked_prefill_tokens(prompt_tokens, prefill_chunk))
    base = 2.0 * model.n_active * tokens / (device.flops * _EFF)
    if tp <= 1:
        return base
    return base / tp + tp_collective_s(device, model, tokens, tp)


def latency_terms(device: DeviceProfile, model: ModelProfile, prompt_tokens,
                  difficulty, rng: np.random.Generator | None = None,
                  prefix_hit_rate=0.0, prefill_chunk: int | None = None,
                  kv_dtype: str | None = None,
                  prefill_device: DeviceProfile | None = None,
                  migrate_kv_dtype: str | None = None) -> dict:
    """Per-term decomposition of the roofline latency — the breakdown the
    telemetry dispatch audit records per routed request
    (repro_torch/serving/telemetry.DispatchRecord).  ``latency_s`` is the
    summed view; the op order here is identical, so ``total_s`` matches it
    bit-for-bit under every knob combination.

    ``prefill_device`` (None = same device) prices the disaggregated
    dispatch shape: prefill runs there, the prompt's KV migrates to
    ``device`` for decode, and a ``migrate_s`` term (priced at the
    *decode* side's KV precision — ``migrate_kv_dtype`` overrides, else
    ``kv_dtype``, else bf16) charges the transfer.  ``migrate_s`` is 0.0
    whenever both phases share a device.
    """
    hit = np.clip(np.asarray(prefix_hit_rate, float), 0.0, 1.0)
    pf_dev = prefill_device if prefill_device is not None else device
    prefill = prefill_s(pf_dev, model, prompt_tokens,
                        prefill_chunk=prefill_chunk) * (1.0 - hit)
    out_tok = expected_out_tokens(model, np.asarray(difficulty))
    if rng is not None:
        out_tok = out_tok * rng.lognormal(0.0, 0.35, np.shape(out_tok))
    if kv_dtype is None:
        decode = decode_s(device, model, out_tok)
    else:
        ctx = np.asarray(prompt_tokens, float) + out_tok / 2.0
        decode = decode_s(device, model, out_tok, context_tokens=ctx,
                          kv_dtype=kv_dtype)
    migrate = 0.0
    if prefill_device is not None and prefill_device.name != device.name:
        migrate = migrate_s(model, prompt_tokens, prefill_device, device,
                            kv_dtype=migrate_kv_dtype or kv_dtype or "bf16")
    # request up + (byte-free) response down == payload/bw + rtt, the
    # historical transmission term
    trans = uplink_s(_PAYLOAD, device) + downlink_s(0.0, device)
    return {"prefill_s": prefill, "decode_s": decode, "link_s": trans,
            "migrate_s": migrate,
            "total_s": prefill + decode + trans + migrate}


def latency_s(device: DeviceProfile, model: ModelProfile, prompt_tokens,
              difficulty, rng: np.random.Generator | None = None,
              prefix_hit_rate=0.0, prefill_chunk: int | None = None,
              kv_dtype: str | None = None,
              prefill_device: DeviceProfile | None = None,
              migrate_kv_dtype: str | None = None):
    """Roofline latency; lognormal noise if rng given.

    ``prefix_hit_rate`` is the expected fraction of prompt tokens already
    resident in the server's paged KV prefix cache
    (repro_torch/serving/kv_cache):
    hit tokens skip prefill compute entirely, so the prefill term scales by
    ``1 - hit_rate``.  Decode and transmission are unaffected.

    ``prefill_chunk`` (None = legacy smooth model) models the serving
    engine's bucketed + chunked prefill instead: compute covers the padded
    bucket shapes, so the estimate tracks what the engine actually runs.

    ``kv_dtype`` (None = legacy weights-only decode, keeping the
    calibrated Fig. 1 aggregates untouched) adds the KV-streaming term to
    decode: each generated token also reads the resident context
    (prompt + the mean half of the answer so far) at
    ``kv_bytes_per_token(model, kv_dtype)`` — the bytes/token → decode_s
    → router-score chain int8 KV compresses.

    See ``latency_terms`` for the per-term decomposition the telemetry
    dispatch audit records.
    """
    return latency_terms(device, model, prompt_tokens, difficulty, rng=rng,
                         prefix_hit_rate=prefix_hit_rate,
                         prefill_chunk=prefill_chunk,
                         kv_dtype=kv_dtype,
                         prefill_device=prefill_device,
                         migrate_kv_dtype=migrate_kv_dtype)["total_s"]


def success_prob(model: ModelProfile, difficulty, affinity=0.0) -> np.ndarray:
    z = _QUALITY_SLOPE * (model.capability - np.asarray(difficulty)
                          + affinity) - 0.5
    return 1.0 / (1.0 + np.exp(-z))


# --------------------------------------------------- split-point offloading
#
# A multimodal request can cross the cloud-edge boundary at two points
# (MoA-Off / CE-CoLLM): ship the *raw* media over the uplink and encode at
# the destination server, or run the modality encoder on the source edge
# device and ship the (keep-top-k compressed) *features*.  Everything the
# decision needs is a roofline: encoder FLOPs on either device plus the
# per-modality uplink bytes of whichever representation travels.


@dataclasses.dataclass(frozen=True)
class MediaSpec:
    """Cost-model view of one media input (paper-scale encoder dims, so
    the decision operates at profiled-hardware magnitudes regardless of
    the reduced live encoder actually producing the features)."""

    modality: str  # key into PAYLOAD_BYTES
    raw_bytes: float  # raw media over the uplink
    feature_bytes: float  # encoded (compressed) features over the uplink
    encode_tokens: int  # patches / frames through the encoder
    encode_dim: int = 768  # ViT-B-ish trunk
    encode_layers: int = 12
    encode_ff: int = 3072


def media_spec(modality: str, keep_ratio: float = 1.0) -> MediaSpec:
    """Paper-scale spec per modality; ``keep_ratio`` is the keep-top-k
    pooling knob (models/mm_encoder.py) scaling the kept span and with it
    the feature-uplink bytes (bf16 features)."""
    tokens = {"image": 197, "audio": 1500}[modality]  # ViT-B/16, whisper
    kept = max(1, int(np.ceil(keep_ratio * tokens)))
    return MediaSpec(modality, raw_bytes=PAYLOAD_BYTES[modality],
                     feature_bytes=kept * 768 * 2, encode_tokens=tokens)


def mm_encode_s(device: DeviceProfile, spec: MediaSpec):
    """Roofline seconds to run the modality encoder on ``device``."""
    d, ff = spec.encode_dim, spec.encode_ff
    flops = spec.encode_tokens * spec.encode_layers * (8 * d * d
                                                       + 4 * d * ff)
    return flops / (device.flops * _EFF)


def split_point_s(spec: MediaSpec, src: DeviceProfile,
                  dst: DeviceProfile) -> dict:
    """Extra seconds (beyond the text payload) each split choice costs:
    ``raw`` ships the media and encodes at the destination, ``edge``
    encodes at the source and ships compressed features over the
    destination's link.  Pure serialization + encode: the link RTT is
    already paid once by the request itself, whichever form the media
    rides along in."""
    return {
        "raw": float(spec.raw_bytes / dst.net_bw + mm_encode_s(dst, spec)),
        "edge": float(mm_encode_s(src, spec)
                      + spec.feature_bytes / dst.net_bw),
    }


def best_split(spec: MediaSpec, src: DeviceProfile,
               dst: DeviceProfile) -> "tuple[str, float]":
    """(choice, extra_s): the cheaper of raw-ship vs edge-encode.  Slow
    uplinks favor edge encoding (features are smaller than media); fast
    uplinks with a weak source device favor shipping raw."""
    costs = split_point_s(spec, src, dst)
    choice = min(costs, key=costs.get)
    return choice, costs[choice]


def category_affinity(n_categories: int, n_models: int, seed: int = 7):
    """Per-(category, model) quality offsets — some models are better at
    some task families."""
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 0.08, (n_categories, n_models))
